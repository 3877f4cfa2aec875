"""Manual (Megatron) tensor parallelism of the transformer trunks
(counterpart of phenaki_tpu/parallel/tp_inference.py).

Each of the tp ranks of a group holds a rank-local clone of a MaskGit,
TokenCritic or C-ViViT: heads / tp of every attention block's heads, a
GEGLU width of ceil(inner / tp), and the group, so that each attention and
FF block completes its row-parallel output with one all-reduce
(`ops.attention.Attention`, `ops.feedforward.FeedForward`). The embeddings,
norms, PEGs, the vocab head and the C-ViViT's pixel heads stay replicated,
as JAX's sampling keeps them: the fused projection sampler streams the
whole 65,536-wide vocab on every rank with the same seed, so every rank
draws the same ids. In training (`tp_local_module(shard_head=True)`, which
the trainer asks for) the MaskGit's vocab head is cut as JAX's rules cut it
(`mesh.TP_RULES`, "vocab-parallel head"): rank r keeps rows [r * V / tp,
(r + 1) * V / tp) of the weight and the bias (`VocabShardedHead`), and the
loss gathers the whole head over the tp group once a call, the copy in the
compute dtype that the fused CE reads, as GSPMD hands JAX's Pallas CE the
gathered weight.

* `pack_tp_params(state, tp)` reorders a global state_dict so that a
  contiguous 1/tp slice of each sharded tensor is rank r's share, with JAX's
  rules: `to_kv` [K | V] rows become rank-major [k_r | v_r], the GEGLU
  `proj_in` [a | g] rows rank-major [a_r | g_r] with each half zero-padded
  to ceil(inner / tp) rows a rank (gelu(0) * 0 = 0 meets zero columns of
  `proj_out`, so the padding is exact, in training too: the padded rows'
  gradients are zero), the columns of `proj_out` zero-padded to match;
  `to_q`, `to_out`, `null_kv` and the position bias's `net_out` are already
  contiguous by head. `unpack_tp_params` inverts it.
* `tp_state_dict(state, tp, rank)` is rank r's share of a global state;
  `tp_local_module(module, tp, group)` builds the rank's clone from the
  module's own weights (copies: the clone trains without touching the
  module).
* `global_value` and `local_value` move one tensor between the global
  layout and a rank's (tp slice, then FSDP shard): checkpoints hold the
  global layout, so they load on any mesh. A vocab head is cut over tp
  where the rank's tensor holds fewer rows than the global one.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from phenaki_tpu_torch.parallel import collectives


def _kv_pack(w: torch.Tensor, tp: int) -> torch.Tensor:
    """[K | V] rows -> rank-major [k_0 | v_0 | k_1 | v_1 | ...]."""
    tot, din = w.shape
    if (tot // 2) % tp:
        raise ValueError(f"kv inner width {tot // 2} does not divide by tp {tp}")
    return w.reshape(2, tp, tot // 2 // tp, din).transpose(0, 1).reshape(tot, din)


def _kv_unpack(w: torch.Tensor, tp: int, shape) -> torch.Tensor:
    tot, din = w.shape
    return w.reshape(tp, 2, tot // 2 // tp, din).transpose(0, 1).reshape(tot, din)


def _local_inner(inner: int, tp: int) -> int:
    return -(-inner // tp)


def _geglu_in_pack(w: torch.Tensor, tp: int) -> torch.Tensor:
    """GEGLU [a | g] rows -> rank-major [a_r | g_r], each half zero-padded to
    ceil(inner / tp) rows a rank."""
    tot, din = w.shape
    il = _local_inner(tot // 2, tp)
    halves = [torch.cat([h, h.new_zeros(tp * il - tot // 2, din)]).reshape(tp, il, din)
              for h in w.chunk(2)]
    return torch.cat(halves, dim=1).reshape(2 * tp * il, din)


def _geglu_in_unpack(w: torch.Tensor, tp: int, shape) -> torch.Tensor:
    inner = shape[0] // 2
    halves = w.reshape(tp, 2, -1, w.shape[1])
    return torch.cat([halves[:, i].reshape(-1, w.shape[1])[:inner] for i in range(2)])


def _geglu_out_pack(w: torch.Tensor, tp: int) -> torch.Tensor:
    """proj_out's columns zero-padded to tp * ceil(inner / tp)."""
    dout, inner = w.shape
    pad = tp * _local_inner(inner, tp) - inner
    return torch.cat([w, w.new_zeros(dout, pad)], dim=1) if pad else w


def _geglu_out_unpack(w: torch.Tensor, tp: int, shape) -> torch.Tensor:
    return w[:, : shape[1]]


# (regex over the port's name, (packer, unpacker) or None, the sharded dim);
# `pos_bias` names both the MaskGit's and the C-ViViT's position bias
TP_PACK_RULES = (
    (r".*to_q\.weight$", None, 0),
    (r".*to_kv\.weight$", (_kv_pack, _kv_unpack), 0),
    (r".*proj_in\.weight$", (_geglu_in_pack, _geglu_in_unpack), 0),
    (r".*to_out\.weight$", None, 1),
    (r".*proj_out\.weight$", (_geglu_out_pack, _geglu_out_unpack), 1),
    (r".*null_kv$", None, 0),
    (r".*pos_bias\.net_out\.(weight|bias)$", None, 0),
)


def tp_rule(name: str):
    """(packers, sharded dim) of a parameter name, or None: replicated."""
    for pattern, packers, dim in TP_PACK_RULES:
        if re.match(pattern, name):
            return packers, dim
    return None


# the MaskGit's vocab head, by its name in the MaskGit or in a trainer's tree;
# its rows are cut over tp in training only (`VocabShardedHead`)
VOCAB_HEAD = re.compile(r"^(?:maskgit\.)?to_logits\.(weight|bias)$")


def _head_rows_cut(name: str, local_rows: int, global_rows: int, tp: int) -> bool:
    """Whether a tensor of `name` with `local_rows` rows is a tp rank's rows
    of a vocab head of `global_rows`."""
    return tp > 1 and VOCAB_HEAD.match(name) is not None and local_rows * tp == global_rows


class _GatherRows(torch.autograd.Function):
    """The ranks' rows concatenated in group order; the backward keeps this
    rank's rows of the gradient, which every rank of the group holds whole
    and alike (no collective)."""

    @staticmethod
    def forward(ctx, rows, group, offset):
        ctx.offset, ctx.rows = offset, rows.shape[0]
        return collectives.all_gather(rows.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.offset, ctx.rows).clone(), None, None  # a view would keep g alive


class VocabShardedHead(nn.Module):
    """A tensor-parallel rank's rows of a vocab head nn.Linear(d, V): rows
    [offset, offset + V / tp) of the weight (V, d) and of the bias, in
    training (JAX's `_TP_RULES` shard `to_logits` over 'tp'). `in_features`
    and `out_features` are the whole head's. The ranks of the group see one
    batch and one trunk output, so the whole head's gradient is the same on
    each of them: each keeps its rows of it, and its Adam moments follow
    those rows."""

    def __init__(self, head: nn.Linear, tp: int, rank: int, group):
        super().__init__()
        if head.out_features % tp:
            raise ValueError(f"the vocab ({head.out_features}) does not divide by tp ({tp})")
        rows = head.out_features // tp
        self.in_features, self.out_features = head.in_features, head.out_features
        self.tp_group, self.row_offset = group, rank * rows
        cut = slice(self.row_offset, self.row_offset + rows)
        self.weight = nn.Parameter(head.weight.detach()[cut].clone(), requires_grad=head.weight.requires_grad)
        self.bias = (nn.Parameter(head.bias.detach()[cut].clone(), requires_grad=head.bias.requires_grad)
                     if head.bias is not None else None)

    def gather(self, dtype: torch.dtype):
        """The whole head without a gradient, for the fused CE and the
        projection sampler: the weight's rows cast to `dtype` and gathered
        over the group, the bias in its own dtype."""
        with torch.no_grad():
            weight = collectives.all_gather(self.weight.detach().to(dtype).contiguous(), self.tp_group)
            bias = (collectives.all_gather(self.bias.detach().contiguous(), self.tp_group)
                    if self.bias is not None else None)
        return weight, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The whole vocab's logits in x's dtype (the materialised-logits path),
        the gradient reaching this rank's rows."""
        weight = _GatherRows.apply(self.weight.to(x.dtype), self.tp_group, self.row_offset)
        bias = (_GatherRows.apply(self.bias.to(x.dtype), self.tp_group, self.row_offset)
                if self.bias is not None else None)
        return torch.nn.functional.linear(x, weight, bias)


def pack_tensor(name: str, value: torch.Tensor, tp: int) -> torch.Tensor:
    rule = tp_rule(name)
    if tp == 1 or rule is None or rule[0] is None:
        return value
    return rule[0][0](value, tp)


def pack_tp_params(state: Dict[str, torch.Tensor], tp: int) -> Dict[str, torch.Tensor]:
    """A global state_dict reordered (and GEGLU-padded) so that a contiguous
    1/tp slice of each sharded tensor is one rank's; tp == 1 is the
    identity."""
    return {k: pack_tensor(k, v, tp) for k, v in state.items()}


def unpack_tp_params(packed: Dict[str, torch.Tensor], tp: int,
                     shapes: Dict[str, Sequence[int]]) -> Dict[str, torch.Tensor]:
    """The inverse of `pack_tp_params`; `shapes` are the global shapes (the
    GEGLU's unpadded width)."""
    out = {}
    for k, v in packed.items():
        rule = tp_rule(k)
        out[k] = v if tp == 1 or rule is None or rule[0] is None else rule[0][1](v, tp, tuple(shapes[k]))
    return out


def shard_packed(packed: Dict[str, torch.Tensor], tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """Rank r's contiguous slice of each sharded tensor of a packed state."""
    out = {}
    for k, v in packed.items():
        rule = tp_rule(k)
        out[k] = v if tp == 1 or rule is None else v.chunk(tp, dim=rule[1])[rank]
    return out


def tp_state_dict(state: Dict[str, torch.Tensor], tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s share of a global state_dict."""
    return shard_packed(pack_tp_params(state, tp), tp, rank)


def _process_groups(module: nn.Module) -> list:
    out = []
    for m in module.modules():
        for attr in ("seq_group", "tp_group", "batch_group"):
            g = getattr(m, attr, None)
            if g is not None:
                out.append(g)
    return out


def clone_module(module: nn.Module) -> nn.Module:
    """A deep copy of `module` that shares its process groups."""
    return copy.deepcopy(module, {id(g): g for g in _process_groups(module)})


def tp_local_module(module: nn.Module, tp: int, group=None, rank: Optional[int] = None,
                    shard_head: bool = False) -> nn.Module:
    """The rank-local clone of `module` (a MaskGit, TokenCritic, C-ViViT or
    anything built of the port's `Attention`, `FeedForward` and
    `ContinuousPositionBias`): heads / tp heads a block, the GEGLU's
    ceil(inner / tp) columns, and `group`, the tp process group (its rank
    is `rank` unless given). Its tensors are copies of the rank's share of
    the module's, on the module's device. `shard_head` (a MaskGit, in
    training) keeps the rank's rows of the vocab head `to_logits` alone
    (`VocabShardedHead`). tp == 1 returns the module."""
    if tp == 1:
        return module
    from phenaki_tpu_torch.ops.attention import Attention
    from phenaki_tpu_torch.ops.feedforward import FeedForward
    from phenaki_tpu_torch.ops.positional import ContinuousPositionBias

    rank = collectives.group_rank(group) if rank is None else rank
    if group is not None and collectives.group_size(group) != tp:
        raise ValueError(f"tp {tp} != the group's size {collectives.group_size(group)}")
    # the clone's tensors are placeholders until the rank's share is assigned
    memo = {id(g): g for g in _process_groups(module)}
    for p in module.parameters():
        memo[id(p)] = nn.Parameter(torch.empty(0, device="meta"), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty(0, device="meta")
    local = copy.deepcopy(module, memo)
    for name, m in local.named_modules():
        if isinstance(m, Attention):
            if m.heads % tp:
                raise ValueError(f"{name}: heads ({m.heads}) do not divide by tp ({tp})")
            if m.seq_group is not None:
                raise ValueError(f"{name}: sequence and tensor parallelism do not combine")
            m.total_heads, m.heads = m.heads, m.heads // tp
            m.head_offset = rank * m.heads
            m.tp_group = group
        elif isinstance(m, FeedForward):
            m.inner_dim = _local_inner(m.inner_dim, tp)
            m.tp_group = group
        elif isinstance(m, ContinuousPositionBias) and name.endswith("pos_bias"):
            m.heads //= tp
            m.tp_group = group
    state = tp_state_dict(module.state_dict(), tp, rank)
    with torch.no_grad():
        for name, value in state.items():
            parent, _, attr = name.rpartition(".")
            owner = local.get_submodule(parent)
            if attr in owner._parameters:
                old = owner._parameters[attr]
                owner._parameters[attr] = nn.Parameter(value.clone(), requires_grad=old.requires_grad)
            else:
                owner._buffers[attr] = value.clone()
        # buffers that are not in the state_dict (non-persistent ones)
        for (name, b), (_, orig) in zip(local.named_buffers(), module.named_buffers()):
            if b.is_meta:
                parent, _, attr = name.rpartition(".")
                local.get_submodule(parent)._buffers[attr] = orig.clone()
    for m in local.modules():
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
    if shard_head:
        local.to_logits = VocabShardedHead(module.to_logits, tp, rank, group)
    return local


# one tensor between the global layout and a rank's


def _fsdp_dim(t: torch.Tensor) -> Optional[int]:
    """The dim an FSDP DTensor is sharded on, or None for a plain tensor."""
    placements = getattr(t, "placements", None)
    if not placements:
        return None
    return next((p.dim for p in placements if hasattr(p, "dim")), None)


def local_value(name: str, value: torch.Tensor, template: torch.Tensor, mesh) -> torch.Tensor:
    """The global tensor `value` of parameter (or state) `name` as this rank
    holds it where `template` is its tensor: packed and sliced for the
    rank's tp shard, then, where `template` is an FSDP DTensor, its shard as
    a DTensor; on the template's device and dtype."""
    tp = mesh.tp if mesh is not None else 1
    if tp > 1 and tp_rule(name) is not None and value.ndim:
        value = pack_tensor(name, value, tp).chunk(tp, dim=tp_rule(name)[1])[mesh.tp_index]
    elif value.ndim and _head_rows_cut(name, template.shape[0], value.shape[0], tp):
        value = value.chunk(tp)[mesh.tp_index]
    dim = _fsdp_dim(template)
    if dim is None:
        return value.to(device=template.device, dtype=template.dtype)
    from torch.distributed.tensor import DTensor

    chunk = value.chunk(mesh.data_size, dim=dim)[mesh.data_index]
    local = chunk.to(device=template.device, dtype=template.dtype).contiguous()
    return DTensor.from_local(local, template.device_mesh, template.placements, run_check=False,
                              shape=template.shape, stride=template.stride())


def global_value(name: str, local: torch.Tensor, mesh, shape: Sequence[int]) -> torch.Tensor:
    """The inverse of `local_value` (collective over the mesh): the FSDP
    shards gathered over the data group, then the tp shards over the tp
    group, unpacked to the global `shape`."""
    dim = _fsdp_dim(local)
    if dim is not None:
        local = collectives.all_gather(local.to_local().contiguous(), mesh.data_group, dim)
    tp = mesh.tp if mesh is not None else 1
    rule = tp_rule(name)
    if tp > 1 and rule is not None and local.ndim:
        local = collectives.all_gather(local.contiguous(), mesh.tp_group, rule[1])
        if rule[0] is not None:
            local = rule[0][1](local, tp, tuple(shape))
    elif local.ndim and _head_rows_cut(name, local.shape[0], shape[0], tp):
        local = collectives.all_gather(local.contiguous(), mesh.tp_group)
    return local.detach()


def is_tp_sharded(name: str) -> bool:
    return tp_rule(name) is not None
