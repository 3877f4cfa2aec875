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
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch
from torch import nn

from phenaki_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_MIN_SIZE, jax_dim_order
from phenaki_tpu_torch.parallel.tp_inference import tp_rule


def fsdp_shard_dim(name: str, local_shape, tp: int, fsdp_size: int) -> Optional[int]:
    """The dim FSDP shards parameter `name` on (its tp-local shape), or None
    for a replicated one."""
    rule = tp_rule(name) if tp > 1 else None
    tp_dim = rule[1] if rule is not None else None
    numel = int(torch.Size(local_shape).numel()) * (tp if tp_dim is not None else 1)
    if fsdp_size <= 1 or not len(local_shape) or numel < FSDP_MIN_SIZE:
        return None
    cands = [i for i in jax_dim_order(name, len(local_shape))
             if i != tp_dim and local_shape[i] % fsdp_size == 0]
    return max(cands, key=lambda i: local_shape[i]) if cands else None


def apply_fsdp(module: nn.Module, mesh, layer_types: Tuple[Type[nn.Module], ...],
               keep_replicated: Sequence[nn.Parameter] = (),
               forward_methods: Sequence[str] = ()) -> List[nn.Parameter]:
    """Shard `module` over the mesh's data group; returns the parameters FSDP
    ignores (replicated: the rules' and `keep_replicated`), whose gradients
    the caller averages. `forward_methods` are methods of `module` that run
    it as `forward` does (FSDP gathers around them too)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    # the port's modules return views (a TokenCritic's [..., 0]); nothing
    # changes their outputs in place, which is what the warning is about
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view tensor")
    from torch.distributed.tensor import Shard

    dims: Dict[int, Optional[int]] = {
        id(p): fsdp_shard_dim(name, p.shape, mesh.tp, mesh.data_size)
        for name, p in module.named_parameters()}
    ignored = {p for p in module.parameters() if dims[id(p)] is None} | set(keep_replicated)
    device_type = next(module.parameters()).device.type
    device_mesh = mesh.device_mesh(mesh.data_axes or (DATA_AXIS,), device_type)

    def placement(p):
        return Shard(dims[id(p)])

    for sub in module.modules():
        if isinstance(sub, layer_types):
            fully_shard(sub, mesh=device_mesh, shard_placement_fn=placement,
                        ignored_params=ignored & set(sub.parameters()))
    fully_shard(module, mesh=device_mesh, shard_placement_fn=placement, ignored_params=ignored)
    for method in forward_methods:
        register_fsdp_forward_method(module, method)
    return [p for p in module.parameters() if p in ignored]
