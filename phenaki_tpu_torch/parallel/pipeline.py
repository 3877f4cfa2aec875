"""Pipeline parallelism of the transformer trunks, on GPipe's schedule
(counterpart of phenaki_tpu/parallel/pipeline.py).

The trunk's layers are split over the 'pp' axis of a mesh: stage s holds
layers [s * depth / pp, (s + 1) * depth / pp) and nothing else of the trunk
(`pipeline_stage_module` builds a rank's stage-local clone, its layers keyed
by their global index, so its parameter names are the whole model's). The
batch is cut into m microbatches; each data-parallel row of the mesh
pipelines its own m / dp of them. On tick t of T = m / dp + pp - 1, stage 0
takes microbatch t, every stage s runs its layers on microbatch t - s, and
the activation moves on to stage s + 1 (`ring_attention._Rotate`, one
send and one receive a rank, the backward sending the gradient the other
way). A warm-up or drain tick, where a stage holds no microbatch, runs no
layer: the stage idles, which is GPipe's bubble, (pp - 1) / T of the
ticks. Every rank rotates on every tick, idle or not, so that every rank
issues its sends and receives in one order, in the backward too: the
rotations of a rank lie on one chain of its autograd graph. The last
stage's outputs go to every stage (a sum over 'pp' of the last stage's
outputs and zeros), and the final norm runs on every rank.

Gradients: a stage's layers get theirs from their own stage alone. What
enters the pipeline from upstream, the activations and the attention bias
(the token and position embeddings and the position-bias MLP lie behind
them), passes `_EnterPipeline`, whose backward sums the stages' partial
gradients over 'pp' in one collective, so every rank holds the whole
gradient of everything upstream. The replication of the outputs passes back
only the last stage's own gradient, unscaled, since every rank computes the
same loss from the same outputs: the norm, the head and the loss downstream
get the whole gradient on every rank, counted once.

Dropout: with `training` and a layer whose dropout is on, the layer that
runs microbatch j of the global batch draws from a stream seeded by (a
seed drawn once a call, the global microbatch, the global layer), so the
masks do not depend on the stage count: pp = 1 and pp = 2 draw the same.

Tensor parallelism composes: each stage's layers are the rank's tp-local
clones (`tp_local_module`), and a bias of every head is cut to the rank's.
Causal stacks with tp > 1 are refused, as in the JAX package. The
transport is the group's (`ring_attention._host_transport`): NCCL moves
device tensors; gloo stages them through host memory, so several ranks may
share one GPU.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh, make_mesh, stage_layers
from phenaki_tpu_torch.parallel.ring_attention import _Rotate
from phenaki_tpu_torch.parallel.tp_inference import clone_module, tp_local_module


def make_pipeline_mesh(pp: int, dp: Optional[int] = None) -> Mesh:
    """The JAX package's name for `make_mesh(dp=dp, pp=pp)`: the batch over
    'dp', the trunk's layers over 'pp'."""
    return make_mesh(dp=dp, pp=pp)


def _trunk(module: nn.Module) -> nn.Module:
    """The `models.transformer.Transformer` of a MaskGit or TokenCritic, or
    the module itself when it is one."""
    return module if hasattr(module, "norm_out") else module.transformer


def pipeline_stage_module(module: nn.Module, mesh: Mesh, shard_head: bool = False) -> nn.Module:
    """This rank's stage-local clone of `module` (a MaskGit, a TokenCritic
    or a `Transformer`): copies of its own stage's trunk layers (a
    ModuleDict keyed by their global index, so the names are the whole
    model's) and of everything outside the trunk's layers; the rank's
    tp-local clone (`tp_local_module`, with `shard_head`) when the mesh has
    tp > 1. The other stages' layers are never copied."""
    trunk = _trunk(module)
    own = stage_layers(trunk.depth, mesh.pp, mesh.pp_index)
    whole = trunk.layers
    # the clone is taken while the trunk shows only this stage's layers
    trunk.layers = nn.ModuleDict({str(i): whole[i] for i in own})
    try:
        local = (tp_local_module(module, mesh.tp, mesh.tp_group, shard_head=shard_head) if mesh.tp > 1
                 else clone_module(module))
    finally:
        trunk.layers = whole
    _trunk(local).stage = own
    return local


def _layer_list(transformer: nn.Module, own: range) -> List[nn.Module]:
    """The stage's layers in order; the trunk must hold exactly them (a
    whole trunk only when it is the one stage)."""
    if transformer.stage is None:
        if len(own) != transformer.depth:
            raise ValueError("give each rank its stage-local trunk (pipeline_stage_module), "
                             "not the whole trunk")
        return list(transformer.layers)
    if transformer.stage != own:
        raise ValueError(f"this rank's stage runs layers {list(own)}, the trunk holds {list(transformer.stage)}")
    return [transformer.layers[str(i)] for i in own]


class _EnterPipeline(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the stages
    (one collective a dtype), so every stage holds the whole gradient of
    what lies upstream."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous().clone() for g in grads]
        collectives.all_reduce_(grads, ctx.group)
        return (None, *grads)


class _FromLastStage(torch.autograd.Function):
    """The last stage's tensor on every stage (a sum of it and the other
    stages' zeros); the backward passes the last stage its own gradient,
    unscaled, and the others zeros."""

    @staticmethod
    def forward(ctx, x, group, is_last):
        ctx.is_last = is_last
        return collectives.all_reduce(x if is_last else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None


def _dropout_active(layers: List[nn.Module]) -> bool:
    for layer in layers:
        for m in layer.modules():
            if getattr(m, "dropout", 0.0) and m.training:
                return True
    return False


def _layer_seed(seed: int, microbatch: int, layer: int) -> int:
    """The dropout stream's seed of global `layer` on global `microbatch`."""
    return int(np.random.SeedSequence([seed, microbatch, layer]).generate_state(1, np.uint64)[0] % 2**63)


@contextlib.contextmanager
def _stream(device: torch.device, seed: Optional[int]):
    """Run the body with the device's default generator seeded by `seed`,
    restored after it (nothing when seed is None)."""
    if seed is None:
        yield
        return
    cuda = device.type == "cuda"
    index = device.index if device.index is not None else (torch.cuda.current_device() if cuda else None)
    with torch.random.fork_rng(devices=[index] if cuda else []):
        (torch.cuda.default_generators[index] if cuda else torch.default_generator).manual_seed(seed)
        yield


def _microbatched(t: Optional[torch.Tensor], m: int) -> Optional[Tuple[torch.Tensor, ...]]:
    return None if t is None else t.reshape(m, t.shape[0] // m, *t.shape[1:]).unbind(0)


def pipeline_transformer_apply(
    transformer: nn.Module,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    num_microbatches: Optional[int] = None,
    video_shape: Optional[Tuple[int, int, int, int]] = None,
    attn_bias: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    self_attn_mask: Optional[torch.Tensor] = None,
    cross_attn_context_mask: Optional[torch.Tensor] = None,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The pipelined `transformer(x, ...)`: the same layers in the same order
    on every row, on GPipe's schedule (module docstring). Every rank of the
    mesh calls it with its stage-local trunk (`pipeline_stage_module`) and
    its data-parallel rows of the batch, x (b / dp, n, dim); every rank gets
    the rows' final-normed output.

    `num_microbatches` m counts the global batch's microbatches (default
    min(b, dp * pp)): b % m == 0 and m % dp == 0. `video_shape` is the
    global (b, t, h, w) (PEG sees each microbatch's (b / m, t, h, w)); the
    context and the masks are cut into microbatches with x, the bias is
    shared. `training` runs the layers in training mode, dropout drawn as
    the module docstring says, seeded from `generator`."""
    pp, stage = mesh.pp, mesh.pp_index
    own = stage_layers(transformer.depth, pp, stage)
    layers = _layer_list(transformer, own)
    dp = mesh.data_size
    b_local = x.shape[0]
    b = b_local * dp
    m = num_microbatches if num_microbatches is not None else min(b, dp * pp)
    if m < 1 or b % m:
        raise ValueError(f"the batch ({b}) does not divide into {m} microbatches")
    if m % dp:
        raise ValueError(f"the microbatches ({m}) must divide by the data axis ({dp}): each data-parallel "
                         "row pipelines m / dp of them")
    m_local = m // dp
    mb = b_local // m_local
    if mesh.tp > 1:
        attn = layers[0].self_attn
        if attn.tp_group is None:
            raise ValueError("a tp > 1 mesh runs the rank's tp-local stage (pipeline_stage_module)")
        if transformer.causal:
            raise ValueError("causal stacks with tp > 1 are not pipelined (as in the JAX package)")
        if attn_bias is not None and attn_bias.shape[0] == attn.total_heads != attn.heads:
            attn_bias = attn_bias.narrow(0, attn.head_offset, attn.heads)  # the rank's heads

    group = mesh.pp_group
    if torch.is_grad_enabled() and group is not None:
        upstream = [i for i, t in enumerate((x, attn_bias, context)) if t is not None and t.requires_grad]
        if upstream:
            entered = list((x, attn_bias, context))
            for i, t in zip(upstream, _EnterPipeline.apply(group, *(entered[i] for i in upstream))):
                entered[i] = t
            x, attn_bias, context = entered

    transformer.train(training)
    seed = collectives.shared_seed(generator, mesh.world_group) if training and _dropout_active(layers) else None
    x_mb = _microbatched(x, m_local)
    ctx_mb, sam_mb, ccm_mb = (_microbatched(t, m_local) for t in (context, self_attn_mask, cross_attn_context_mask))
    mb_video_shape = (mb, *video_shape[1:]) if video_shape is not None else None
    first = torch.tensor(stage == 0, device=x.device)

    def pick(parts, j):
        return None if parts is None else parts[j]

    act = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(m_local + pp - 1):
        # stage 0 takes microbatch t (the rotated activation is kept in the
        # graph, with a zero gradient, so every rank's rotations stay one chain)
        act = torch.where(first, x_mb[min(t, m_local - 1)], act) if pp > 1 else x_mb[t]
        j = t - stage
        if 0 <= j < m_local:
            global_mb = mesh.data_index * m_local + j
            for i, layer in zip(own, layers):
                with _stream(x.device, None if seed is None else _layer_seed(seed, global_mb, i)):
                    act = layer(act, attn_bias, pick(ctx_mb, j), pick(sam_mb, j), pick(ccm_mb, j), mb_video_shape)
        if t >= pp - 1:
            outs.append(act)  # the last stage's microbatch t - (pp - 1)
        if pp > 1 and t < m_local + pp - 2:
            act = _Rotate.apply(act, group)
    out = torch.stack(outs)
    if pp > 1:
        out = _FromLastStage.apply(out, group, stage == pp - 1)
    return transformer.norm_out(out.reshape(b_local, *x.shape[1:]))
