"""Masking / sampling math (counterpart of phenaki_tpu/ops/sampling.py)."""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1): -log(-log(u + 1e-10) + 1e-10), f32."""
    return -torch.log(-torch.log(u.float() + 1e-10) + 1e-10)


def gumbel_sample(logits: torch.Tensor, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Temperature-annealed gumbel-max sample over the last axis."""
    logits = logits.float()
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
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
