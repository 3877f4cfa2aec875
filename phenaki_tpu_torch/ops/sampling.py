"""Masking / sampling math (counterpart of phenaki_tpu/ops/sampling.py)."""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1): -log(-log(u + 1e-10) + 1e-10), f32."""
    return -torch.log(-torch.log(u.float() + 1e-10) + 1e-10)


def uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) f32 drawn on the generator's device (the port's generators are
    CPU generators, so one seed gives the same numbers on every machine),
    then moved to `device`."""
    gen_device = generator.device if generator is not None else device
    return torch.rand(shape, generator=generator, device=gen_device).to(device)


def gumbel_sample(logits: torch.Tensor, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature-annealed gumbel-max sample over the last axis; `noise`
    (the logits' shape) replaces the uniforms drawn from `generator`."""
    logits = logits.float()
    u = uniform(logits.shape, generator, logits.device) if noise is None else noise.to(logits.device)
    return (logits / max(float(temperature), 1e-10) + gumbel(u)).argmax(dim=-1)


def topk_mask(scores: torch.Tensor, k: Union[int, torch.Tensor]) -> torch.Tensor:
    """Boolean mask of the k largest entries per row; ties go to the lower
    index (the rank of a stable descending sort)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(scores.shape[-1], device=scores.device).expand_as(order))
    if isinstance(k, torch.Tensor) and k.ndim == 1:
        k = k[:, None]
    return ranks < k


def cosine_schedule(t: np.float32) -> np.float32:
    """Mask fraction at progress t in [0, 1]: cos(t * pi/2), in f32 as the
    TPU package computes it."""
    return np.cos(np.float32(t) * np.float32(math.pi) * np.float32(0.5))


def get_mask_subset_with_prob(mask: torch.Tensor, prob, generator: Optional[torch.Generator] = None,
                              *, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pick exactly max(1, round(prob * n_valid)) positions a row to mask,
    uniformly among the positions where `mask` (b, n) is True; pads are never
    chosen. `prob` is a number or (b,). The positions are the row's smallest
    uniforms `noise` (b, n), drawn from `generator` when not given."""
    b, n = mask.shape
    if noise is None:
        noise = uniform((b, n), generator, mask.device)
    num_tokens = mask.sum(-1).float()
    prob = torch.as_tensor(prob, dtype=torch.float32, device=mask.device).expand(b)
    num_masked = torch.round(prob * num_tokens).clamp_min(1.0)
    r = torch.where(mask, noise.float(), 2.0)  # pads rank last
    return topk_mask(-r, num_masked.long())


def prob_mask_like(shape, prob: float, generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """Bernoulli(prob) boolean mask."""
    if prob == 1:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return uniform(shape, generator, device) < prob
