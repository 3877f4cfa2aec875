"""Collectives over a process group for tensor and data parallelism.

The transport follows the group's backend, as the ring's does
(`ring_attention._host_transport`): NCCL reduces device tensors in place;
any other backend (gloo) reduces a host copy in the tensor's own dtype,
which is copied back to the tensor's device, so that several ranks may share
one GPU. A byte view serves moves only (`ring_attention._to_wire`): a sum
must see the dtype (gloo sums bf16 on the host). A group of None is a
group of one: every function is then the identity.

Megatron's two conjugate autograd Functions make a module with sharded
heads or columns train as well as sample:

* `copy_to_group`, identity forward and all-reduce backward, at the input
  of a column-parallel product (and on a replicated parameter that only
  this rank's heads use, such as the q/k scales): each rank's backward
  holds the gradient of its own columns, and the sum is the whole;
* `reduce_from_group`, all-reduce forward and identity backward, at the
  output of a row-parallel product (`to_out`, `proj_out`), as JAX's `psum`.

`sum_over_group` sums a batch statistic over the data-parallel ranks with a
backward scaled by the group size, which is right when the ranks' parameter
gradients are then averaged (`all_reduce_grads`): the LFQ's codebook usage
and a masked loss's token count are such statistics.
"""

from __future__ import annotations

from typing import Any, Iterable, List

import torch
import torch.distributed as dist

from phenaki_tpu_torch.parallel.ring_attention import _host_transport
from phenaki_tpu_torch.utils.logging import span

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The element-wise reduction of x over the group, as a new tensor on
    x's device and in x's dtype (x itself for a group of one). A profiler
    sees it as the range "collectives.all_reduce"."""
    if group_size(group) == 1:
        return x
    with span("collectives.all_reduce"):
        return _all_reduce(x.detach(), group, op)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if not _host_transport(group):
        buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=op, group=group)
        return buf
    buf = x.cpu().contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def all_reduce_(tensors: List[torch.Tensor], group, op=dist.ReduceOp.SUM) -> None:
    """Reduce a list of tensors in place over the group, flattened into one
    buffer a dtype (one collective instead of one a tensor)."""
    if group_size(group) == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = all_reduce(torch.cat([t.detach().reshape(-1) for t in same]), group, op)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in group-rank order (the
    tensors must have one shape on every rank)."""
    if group_size(group) == 1:
        return x
    from phenaki_tpu_torch.parallel.ring_attention import _all_gather

    return _all_gather(x, group, dim)


def shared_seed(generator, group) -> int:
    """A seed every rank of `group` holds alike: drawn from `generator`
    (every rank holds the same one), or without one rank 0's draw from
    numpy's global generator, broadcast over `group`."""
    if generator is not None:
        return int(torch.randint(0, 2**62, (), generator=generator))
    import numpy as np

    return broadcast_object(int(np.random.randint(0, 2**62, dtype=np.int64)), group)


def broadcast_object(obj: Any, group, src_group_rank: int = 0) -> Any:
    """`obj` of the group's rank `src_group_rank`, on every rank (pickled;
    tensors travel by value on the CPU)."""
    if group_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src_group_rank), group=group)
    return box[0]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.scale = group_size(group)
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group forward; identity backward."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group forward; the backward multiplies by the group
    size (for gradients that are then averaged over the group)."""
    return x if group_size(group) == 1 else _SumOverGroup.apply(x, group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Average the parameters' gradients over the group, in one collective
    a dtype; a parameter without a gradient is skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if group_size(group) == 1 or not grads:
        return
    all_reduce_(grads, group)
    torch._foreach_div_(grads, float(group_size(group)))


def batch_rows(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rows index, index + count, ... of a tensor drawn for the global batch:
    the rows of data-parallel rank `index` of `count`, whose loader shard
    interleaves the global batch so (`DataLoader(num_shards=, shard_id=)`)."""
    return t if count == 1 else t[index::count]
