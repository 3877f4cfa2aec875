"""Normalization primitives (counterpart of phenaki_tpu/ops/norms.py).

Statistics are kept in float32 whatever the compute dtype; the result is
cast back to the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis: t * rsqrt(max(sum t^2, eps^2)) in f32."""
    t32 = t.float()
    ss = (t32 * t32).sum(-1, keepdim=True)
    return (t32 * torch.rsqrt(ss.clamp_min(eps * eps))).to(t.dtype)


def l2norm_scaled(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """l2norm(t) * scale (the learned per-dim q/k scales)."""
    return l2norm(t) * scale.to(t.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with a learned gamma and beta frozen at zero; eps 1e-5,
    biased variance."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        out = (x32 - mean) * torch.rsqrt(var + EPS) * self.gamma.float()
        return out.to(x.dtype)


class StandardLayerNorm(nn.Module):
    """LayerNorm with learned gamma and beta."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        out = (x32 - mean) * torch.rsqrt(var + EPS) * self.gamma.float()
        return (out + self.beta.float()).to(x.dtype)
