"""Optimizer factory (counterpart of phenaki_tpu/training/optimizer.py).

Adam when wd == 0, else AdamW with the weight-decay split: parameters with
ndim < 2 (biases, norm gains, per-dim scales) get no weight decay. eps is
1e-8, the TPU package's default. With `max_grad_norm` the gradients are
clipped to that global norm before every step, as the TPU package's
`optax.clip_by_global_norm` does (torch's clip divides by norm + 1e-6,
optax by the norm). `grad_norm` replaces the norm's computation (a
trainer on a mesh passes one that sums the shards of sharded gradients
over their groups, `global_grad_norm`); the clip is then torch's formula.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch


def global_grad_norm(named_params: List[Tuple[str, torch.nn.Parameter]], mesh) -> torch.Tensor:
    """The L2 norm of the whole gradient of a model sharded over `mesh`:
    the squares of FSDP shards (DTensors) summed over the data group, those
    of tensor-parallel shards over the tp group, replicated ones counted
    once."""
    from phenaki_tpu_torch.parallel.collectives import all_reduce
    from phenaki_tpu_torch.parallel.tp_inference import is_tp_sharded

    sums = None
    for name, p in named_params:
        if p.grad is None:
            continue
        g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
        part = torch.zeros(4, device=g.device)
        part[2 * is_tp_sharded(name) + hasattr(p.grad, "to_local")] = g.float().pow(2).sum()
        sums = part if sums is None else sums + part
    if sums is None:
        return torch.zeros(())
    sums = torch.cat([sums[::2], all_reduce(sums[1::2], mesh.data_group)])  # FSDP parts over dp
    sums = torch.stack([sums[0] + sums[2], all_reduce(sums[1] + sums[3], mesh.tp_group)])
    return sums.sum().sqrt()


def get_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, wd: float = 1e-2,
                  betas: Tuple[float, float] = (0.9, 0.99),
                  max_grad_norm: Optional[float] = None,
                  grad_norm: Optional[Callable[[], torch.Tensor]] = None) -> torch.optim.Optimizer:
    params = [p for p in params if p.requires_grad]
    # the multi-tensor kernels take a group of FSDP DTensors or of plain
    # tensors, not both (FSDP keeps its small parameters plain)
    foreach = False if len({hasattr(p, "placements") for p in params}) > 1 else None
    if wd == 0:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8, foreach=foreach)
    else:
        groups = [{"params": [p for p in params if p.ndim >= 2]},
                  {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}]
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd, foreach=foreach)

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
