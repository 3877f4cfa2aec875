"""Fully sharded data parallelism of the trunks (counterpart of the JAX
package's `shard_params(..., fsdp=True)`, `parallel/mesh.py:137-202`).

`apply_fsdp(module, mesh, layer_types)` runs `torch.distributed.fsdp.
fully_shard` on each layer of `layer_types` (the port's `TransformerLayer`)
and on the module itself, over the mesh's data group. Each parameter is
sharded on the dim JAX's rules give (`mesh.param_partition_spec`: the
largest dim that divides by the data axes and is not the tp dim, ties to
the first in JAX's layout), read on the rank's tp-local tensor; a parameter
of fewer than 2**16 elements in its global form, or with no such dim, stays
replicated as JAX keeps it: FSDP ignores it, and the trainer averages its
gradient over the data group itself (`ignored` below). FSDP averages the
others' gradients, gathers each layer's parameters before its forward and
backward, and frees them after.

On a pipeline mesh (pp > 1) the module is a stage-local clone
(`parallel.pipeline.pipeline_stage_module`), and JAX's rule reads a trunk
layer's parameter as a slice of its stacked leaf (scan over layers, which
JAX's pipeline needs): its depth over 'pp', then the largest other dim
over 'dp', the size threshold counting the whole stack (depth x the
layer's size). A stage runs each of its layers once a microbatch, and JAX's
stage receives its parameters gathered once, at the pipelined trunk's
entry: so a stage's layers are gathered at their first forward and kept
through the backward (`reshard_after_forward=False`, and no reshard after
each microbatch's backward), until the trainer frees them with `reshard`
after the step's backward. Every rank of a stage's data group runs the same
schedule, so they issue FSDP's gathers and reduce-scatters and the
pipeline's rotations in one order.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch
from torch import nn

from phenaki_tpu_torch.parallel import mesh as rules
from phenaki_tpu_torch.parallel.mesh import DATA_AXIS, TRUNK_LAYER, jax_dim_order
from phenaki_tpu_torch.parallel.tp_inference import VocabShardedHead, tp_rule


def fsdp_shard_dim(name: str, local_shape, tp_dim: Optional[int], tp: int, fsdp_size: int,
                   stacked_depth: int = 1) -> Optional[int]:
    """The dim FSDP shards parameter `name` on (its tp-local shape, whose dim
    `tp_dim` the tp rules cut), or None for a replicated one; a trunk
    layer's parameter of a pipelined model counts `stacked_depth` layers'
    elements against the size threshold (JAX's stacked leaf)."""
    numel = int(torch.Size(local_shape).numel()) * (tp if tp_dim is not None else 1) * stacked_depth
    if fsdp_size <= 1 or not len(local_shape) or numel < rules.FSDP_MIN_SIZE:
        return None
    cands = [i for i in jax_dim_order(name, len(local_shape))
             if i != tp_dim and local_shape[i] % fsdp_size == 0]
    return max(cands, key=lambda i: local_shape[i]) if cands else None


def _tp_dim(module: nn.Module, name: str, tp: int) -> Optional[int]:
    """The dim of parameter `name` of `module` that tensor parallelism cuts."""
    if tp == 1:
        return None
    owner = module.get_submodule(name.rpartition(".")[0])
    if isinstance(owner, VocabShardedHead):
        return 0
    rule = tp_rule(name)
    return rule[1] if rule is not None else None


def apply_fsdp(module: nn.Module, mesh, layer_types: Tuple[Type[nn.Module], ...],
               keep_replicated: Sequence[nn.Parameter] = (),
               forward_methods: Sequence[str] = ()) -> List[nn.Parameter]:
    """Shard `module` over the mesh's data group; returns the parameters FSDP
    ignores (replicated: the rules' and `keep_replicated`), whose gradients
    the caller averages. `forward_methods` are methods of `module` that run
    it as `forward` does (FSDP gathers around them too). On a pipeline mesh
    the layers keep their gathered parameters until `reshard` (module
    docstring)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    # the port's modules return views (a TokenCritic's [..., 0]); nothing
    # changes their outputs in place, which is what the warning is about
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view tensor")
    from torch.distributed.tensor import Shard

    pipelined = mesh.pp > 1
    depth = getattr(getattr(module, "transformer", None), "depth", 1) if pipelined else 1
    dims: Dict[int, Optional[int]] = {
        id(p): fsdp_shard_dim(name, p.shape, _tp_dim(module, name, mesh.tp), mesh.tp, mesh.data_size,
                              depth if TRUNK_LAYER.match(name) else 1)
        for name, p in module.named_parameters()}
    ignored = {p for p in module.parameters() if dims[id(p)] is None} | set(keep_replicated)
    device_type = next(module.parameters()).device.type
    device_mesh = mesh.device_mesh(mesh.data_axes or (DATA_AXIS,), device_type)

    def placement(p):
        return Shard(dims[id(p)])

    for sub in module.modules():
        if isinstance(sub, layer_types):
            fully_shard(sub, mesh=device_mesh, shard_placement_fn=placement,
                        ignored_params=ignored & set(sub.parameters()), reshard_after_forward=not pipelined)
            if pipelined:
                sub.set_reshard_after_backward(False)
    fully_shard(module, mesh=device_mesh, shard_placement_fn=placement, ignored_params=ignored)
    for method in forward_methods:
        register_fsdp_forward_method(module, method)
    return [p for p in module.parameters() if p in ignored]


def reshard(module: nn.Module, layer_types: Tuple[Type[nn.Module], ...]) -> None:
    """Free the gathered parameters that the FSDP layers of `module` keep
    through a pipelined step (`apply_fsdp` on a pipeline mesh)."""
    for sub in module.modules():
        if isinstance(sub, layer_types) and hasattr(sub, "reshard"):
            sub.reshard()
