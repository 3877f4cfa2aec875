"""GEGLU feedforward block (counterpart of phenaki_tpu/ops/feedforward.py).

The TPU package gives `geglu` a hand-written VJP to save memory under
`nn.scan`; here autograd differentiates the same math (the tests hold the
gradients to the JAX VJP)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.ops.norms import StandardLayerNorm
from phenaki_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group


def ff_inner_dim(dim: int, mult: int = 4) -> int:
    """Inner width `int(mult * 2/3 * dim)`: 1365 at dim 512."""
    return int(mult * (2 / 3) * dim)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` computed in x's dtype: the weights are cast at use, as a
    flax module's `dtype` does (no copy when the dtypes already match). A
    layer that is not an nn.Linear (a tensor-parallel rank's rows of a vocab
    head, `parallel.tp_inference.VocabShardedHead`) computes itself."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """Split the last axis in two halves (a, gate): gelu_exact(gate) * a."""
    a, gate = x.chunk(2, dim=-1)
    return F.gelu(gate) * a


class FeedForward(nn.Module):
    """LN (with beta) -> Linear(2*inner, no bias) -> GEGLU -> dropout ->
    Linear(dim, no bias).

    `inner_dim` overrides the width `int(mult * 2/3 * dim)` (the TPU
    package's field; a tensor-parallel rank's columns);
    `tp_group` makes the block tensor-parallel as `ops.attention.Attention`
    is: the normed input enters `proj_in` through `copy_to_group` and
    `proj_out`'s partial product is completed by one all-reduce."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 inner_dim: Optional[int] = None, tp_group=None):
        super().__init__()
        inner = inner_dim if inner_dim is not None else ff_inner_dim(dim, mult)
        self.inner_dim = inner
        self.tp_group = tp_group
        self.norm = StandardLayerNorm(dim)
        self.proj_in = nn.Linear(dim, inner * 2, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = geglu(linear(copy_to_group(self.norm(x), self.tp_group), self.proj_in))
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, self.training)
        return reduce_from_group(linear(h, self.proj_out), self.tp_group)
