"""Optimizer factory (counterpart of phenaki_tpu/training/optimizer.py).

Adam when wd == 0, else AdamW with the weight-decay split: parameters with
ndim < 2 (biases, norm gains, per-dim scales) get no weight decay. eps is
1e-8, the TPU package's default. With `max_grad_norm` the gradients are
clipped to that global norm before every step, as the TPU package's
`optax.clip_by_global_norm` does (torch's clip divides by norm + 1e-6,
optax by the norm).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def get_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, wd: float = 1e-2,
                  betas: Tuple[float, float] = (0.9, 0.99),
                  max_grad_norm: Optional[float] = None) -> torch.optim.Optimizer:
    params = [p for p in params if p.requires_grad]
    if wd == 0:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    else:
        groups = [{"params": [p for p in params if p.ndim >= 2]},
                  {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}]
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)

    if max_grad_norm is not None:
        def clip(*_):
            torch.nn.utils.clip_grad_norm_(params, max_grad_norm)

        opt.register_step_pre_hook(clip)
    return opt
