"""Optimizer factory (counterpart of phenaki_tpu/training/optimizer.py).

Adam when wd == 0, else AdamW with the weight-decay split
(`group_wd_params`, the default): parameters with ndim < 2 (biases, norm
gains, per-dim scales) get no weight decay; without the split every
parameter decays. `eps` (default 1e-8) and `group_wd_params` are the TPU
package's arguments of the same names. With `max_grad_norm` the gradients are
clipped to that global norm before every step, as the TPU package's
`optax.clip_by_global_norm` does (torch's clip divides by norm + 1e-6,
optax by the norm). `grad_norm` replaces the norm's computation (a
trainer on a mesh passes one that sums the shards of sharded gradients
over their groups, `global_grad_norm`); the clip is then torch's formula.
`param_groups` is the grouping, which a checkpoint's optimizer state
follows.
"""

from __future__ import annotations

from typing import Callable, Collection, Iterable, List, Optional, Sequence, Tuple, TypeVar

import torch

T = TypeVar("T")


def global_grad_norm(named_params: List[Tuple[str, torch.nn.Parameter]], mesh,
                     stage_owned: Collection[str] = (),
                     tp_sharded: Optional[Collection[str]] = None) -> torch.Tensor:
    """The L2 norm of the whole gradient of a model sharded over `mesh`:
    the squares of FSDP shards (DTensors) summed over the data group, those
    of tensor-parallel shards (`tp_sharded`, by name; the tp rules' when
    None) over the tp group, those of the pipeline stage's own layers
    (`stage_owned`, by name) over the pp group; replicated ones counted
    once."""
    from phenaki_tpu_torch.parallel.collectives import all_reduce
    from phenaki_tpu_torch.parallel.tp_inference import is_tp_sharded

    if tp_sharded is None:
        tp_sharded = {name for name, _ in named_params if is_tp_sharded(name)}
    sums = None
    for name, p in named_params:
        if p.grad is None:
            continue
        g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
        part = torch.zeros(8, device=g.device)
        part[4 * (name in stage_owned) + 2 * (name in tp_sharded) + hasattr(p.grad, "to_local")] = \
            g.float().pow(2).sum()
        sums = part if sums is None else sums + part
    if sums is None:
        return torch.zeros(())
    # bit 1: FSDP parts over dp; bit 2: tp parts over tp; bit 4: stage parts over pp
    for bit, group in ((1, mesh.data_group), (2, mesh.tp_group), (4, mesh.pp_group)):
        idx = torch.tensor([i for i in range(8) if i & bit], device=sums.device)
        sums = sums.index_copy(0, idx, all_reduce(sums[idx], group))
    return sums.sum().sqrt()


def param_groups(params: Sequence[T], wd: float, group_wd_params: bool = True) -> List[List[T]]:
    """The optimizer's parameter groups (`params` are parameters, or any
    items with an `ndim`): one, or with weight decay split by
    `group_wd_params` the matrices and then the rest (no decay on biases,
    norm gains and per-dim scales)."""
    if wd == 0 or not group_wd_params:
        return [list(params)]
    return [[p for p in params if p.ndim >= 2], [p for p in params if p.ndim < 2]]


def get_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, wd: float = 1e-2,
                  betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8,
                  group_wd_params: bool = True, max_grad_norm: Optional[float] = None,
                  grad_norm: Optional[Callable[[], torch.Tensor]] = None) -> torch.optim.Optimizer:
    params = [p for p in params if p.requires_grad]
    # the multi-tensor kernels take a group of FSDP DTensors or of plain
    # tensors, not both (FSDP keeps its small parameters plain)
    foreach = False if len({hasattr(p, "placements") for p in params}) > 1 else None
    if wd == 0:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, foreach=foreach)
    else:
        groups = [{"params": g} for g in param_groups(params, wd, group_wd_params)]
        if len(groups) > 1:
            groups[1]["weight_decay"] = 0.0
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps, weight_decay=wd, foreach=foreach)

    if max_grad_norm is not None:
        def clip(*_):
            if grad_norm is None:
                torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
                return
            coef = torch.clamp(max_grad_norm / (grad_norm() + 1e-6), max=1.0)
            for p in params:
                if p.grad is not None:
                    g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
                    g.mul_(coef.to(g.device))

        opt.register_step_pre_hook(clip)
    return opt
