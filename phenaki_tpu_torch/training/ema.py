"""Exponential moving average of a set of parameters (counterpart of
phenaki_tpu/training/ema.py).

`EMAState(params, step)`: the averaged tensors by name and the count of
applied updates. `ema_update` advances it: the count moves when `apply` is
true; while the count is at most `update_after_step` the average copies the
parameters (warm-up); after that it blends `e * decay + p * (1 - decay)` on
every `update_every`-th count. `apply=False` leaves the state as it is: a
trainer passes whether the optimizer stepped, so that under gradient
accumulation the average moves once an optimizer step. The average's tensors
are updated in place and the count on the host, so an update reads nothing
back from the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class EMAState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the averages, by parameter name
    step: int  # applied updates


@torch.no_grad()
def ema_init(params: Dict[str, torch.Tensor]) -> EMAState:
    """An average that starts as a copy of `params` (name -> tensor)."""
    return EMAState(params={k: v.detach().clone() for k, v in params.items()}, step=0)


@torch.no_grad()
def ema_update(state: EMAState, new_params: Dict[str, torch.Tensor], decay: float = 0.995,
               update_after_step: int = 0, update_every: int = 1,
               apply: Optional[bool] = None) -> EMAState:
    """One (conditional) EMA step; `state.params` change in place."""
    if apply is not None and not apply:
        return state
    step = state.step + 1
    names = list(state.params)
    ema = [state.params[k] for k in names]
    new = [new_params[k].detach() for k in names]
    if step <= update_after_step:  # warm-up: copy the parameters
        torch._foreach_copy_(ema, new)
    elif step % update_every == 0:
        # e * decay + p * (1 - decay), each product rounded as the TPU package's
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - decay))
    return EMAState(params=state.params, step=step)
