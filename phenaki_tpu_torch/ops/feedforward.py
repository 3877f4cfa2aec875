"""GEGLU feedforward block (counterpart of phenaki_tpu/ops/feedforward.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.ops.norms import StandardLayerNorm


def ff_inner_dim(dim: int, mult: int = 4) -> int:
    """Inner width `int(mult * 2/3 * dim)`: 1365 at dim 512."""
    return int(mult * (2 / 3) * dim)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """Split the last axis in two halves (a, gate): gelu_exact(gate) * a."""
    a, gate = x.chunk(2, dim=-1)
    return F.gelu(gate) * a


class FeedForward(nn.Module):
    """LN (with beta) -> Linear(2*inner, no bias) -> GEGLU -> Linear(dim, no bias)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = ff_inner_dim(dim, mult)
        self.norm = StandardLayerNorm(dim)
        self.proj_in = nn.Linear(dim, inner * 2, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(geglu(self.proj_in(self.norm(x))))
