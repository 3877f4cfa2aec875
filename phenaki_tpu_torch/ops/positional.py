"""Positional machinery: ALiBi, continuous position bias, PEG
(counterpart of phenaki_tpu/ops/positional.py)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.parallel.collectives import copy_to_group


def alibi_slopes(heads: int) -> np.ndarray:
    """Per-head ALiBi slopes."""

    def slopes_power_of_2(n: int):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(heads).is_integer():
        return np.asarray(slopes_power_of_2(heads), dtype=np.float32)
    closest = 2 ** math.floor(math.log2(heads))
    base = slopes_power_of_2(closest)
    extra = slopes_power_of_2(2 * closest)[0::2][: heads - closest]
    return np.asarray(base + extra, dtype=np.float32)


def alibi_bias(heads: int, i: int, j: int, device=None) -> torch.Tensor:
    """(heads, i, j) f32 bias -slope_h * |col - row|, with the queries at the
    last i of the j positions."""
    slopes = torch.as_tensor(alibi_slopes(heads), device=device).view(heads, 1, 1)
    i_pos = torch.arange(j - i, j, dtype=torch.float32, device=device).view(1, i, 1)
    j_pos = torch.arange(j, dtype=torch.float32, device=device).view(1, 1, j)
    return -(j_pos - i_pos).abs() * slopes


class ContinuousPositionBias(nn.Module):
    """SwinV2 continuous relative position bias over an N-D token grid.

    The MLP (leaky_relu 0.1) runs over the table of unique displacements,
    prod(2*D_k - 1) rows, on signed-log coordinates; the (heads, N, N) bias
    is then expanded from that table by an index gather:
    bias[h, p, q] = table[p - q (per grid axis), h].

    With `tp_group` (a tensor-parallel rank's clone, whose `net_out` gives
    its heads alone) the hidden activations enter `net_out` through
    `copy_to_group`, so the replicated MLP below it gets the whole gradient.
    """

    def __init__(self, dim: int, heads: int, num_dims: int = 2, tp_group=None):
        super().__init__()
        self.num_dims = num_dims
        self.heads = heads
        self.tp_group = tp_group
        self.net_in = nn.Linear(num_dims, dim)
        self.net_hidden = nn.ModuleList([nn.Linear(dim, dim)])  # two layers in all
        self.net_out = nn.Linear(dim, heads)

    def forward(self, *dimensions: int) -> torch.Tensor:
        if len(dimensions) != self.num_dims:
            raise ValueError(f"expected {self.num_dims} grid sizes, got {dimensions}")
        w = self.net_in.weight
        axes = [torch.arange(-(d - 1), d, dtype=torch.float32, device=w.device) for d in dimensions]
        disp = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(len(dimensions), -1).T
        disp = torch.sign(disp) * torch.log(disp.abs() + 1.0)

        x = F.leaky_relu(self.net_in(disp.to(w.dtype)), 0.1)
        for layer in self.net_hidden:
            x = F.leaky_relu(layer(x), 0.1)
        table = self.net_out(copy_to_group(x, self.tp_group))  # (prod(2D-1), heads)

        # flat table index of the displacement between every pair of points
        coords = torch.stack(
            torch.meshgrid(*[torch.arange(d, device=w.device) for d in dimensions], indexing="ij")
        ).reshape(len(dimensions), -1)  # (c, N)
        idx = torch.zeros(coords.shape[1], coords.shape[1], dtype=torch.long, device=w.device)
        for axis, d in enumerate(dimensions):
            c = coords[axis]
            idx = idx * (2 * d - 1) + (c[:, None] - c[None, :] + d - 1)
        return table[idx].permute(2, 0, 1)  # (heads, N, N)


def _windows(xp: torch.Tensor, grid) -> torch.Tensor:
    """The 3 x 3 x 3 windows of a padded (b, t+2, h+2, w+2, d) tensor as an
    overlapping strided view (b, t, h, w, 3, 3, 3, d)."""
    s = xp.stride()
    return xp.as_strided((*grid, 3, 3, 3, xp.shape[-1]), (*s[:4], *s[1:4], s[4]))


def _stencil(xp: torch.Tensor, taps: torch.Tensor, grid) -> torch.Tensor:
    """sum over the 27 taps (3, 3, 3, d) of the windows of xp times the tap:
    one windowed multiply-and-sum (a grouped F.conv3d ran as one cuDNN
    launch per channel on the H100)."""
    return (_windows(xp, grid) * taps).sum(dim=(4, 5, 6))


def _pad(x: torch.Tensor, frame_pad) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1, *frame_pad))


class _Depthwise3x3x3(torch.autograd.Function):
    """PEG's stencil with an explicit backward, as the TPU package's
    `depthwise3x3x3` VJP: autograd of the overlapping strided view takes
    PyTorch's generic `as_strided` backward, which scatters the (27 x larger)
    window gradient back with index_add. Here dx is the same stencil over the
    cotangent with the taps flipped (frame padding swapped), and the tap and
    bias gradients are f32 reductions."""

    @staticmethod
    def forward(ctx, x, weight, bias, causal):
        frame_pad = (2, 0) if causal else (1, 1)
        taps = weight.to(x.dtype)[:, 0].permute(1, 2, 3, 0)  # (3, 3, 3, d)
        ctx.save_for_backward(x, weight, bias)
        ctx.frame_pad = frame_pad
        return _stencil(_pad(x, frame_pad), taps, x.shape[:4]) + bias.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        lo, hi = ctx.frame_pad
        grid = x.shape[:4]
        taps = weight.to(x.dtype)[:, 0].permute(1, 2, 3, 0)
        # dx[t] = sum_dt dy[t + lo - dt] * k[dt]
        dx = _stencil(_pad(dy, (hi, lo)), taps.flip(0, 1, 2), grid)
        dy32 = dy.float()[:, :, :, :, None, None, None, :]
        dtaps = (_windows(_pad(x, (lo, hi)), grid).float() * dy32).sum(dim=(0, 1, 2, 3))
        dweight = dtaps.permute(3, 0, 1, 2)[:, None].to(weight.dtype)
        dbias = dy.float().sum(dim=(0, 1, 2, 3)).to(bias.dtype)
        return dx, dweight, dbias, None


class PEG(nn.Module):
    """Positional encoding generator: depthwise 3x3x3 conv over the token grid.

    Causal mode pads (2, 0) on the frame axis, otherwise (1, 1); the spatial
    axes pad (1, 1). `layout` maps a flat (rows, seq, d) input on the grid:
    'thw' (rows = b, seq = t*h*w) or 'bhw_t' (rows = b*h*w, seq = t).
    """

    def __init__(self, dim: int, causal: bool = False, layout: str = "thw"):
        super().__init__()
        if layout not in ("thw", "bhw_t"):
            raise ValueError(f"unknown PEG layout {layout!r}")
        self.causal = causal
        self.layout = layout
        self.weight = nn.Parameter(torch.empty(dim, 1, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, shape: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
        """x: (b, t, h, w, d), or flat (rows, seq, d) with `shape` = (b, t, h, w)."""
        orig_shape = x.shape
        d = x.shape[-1]
        if x.ndim == 3:
            if shape is None:
                raise ValueError("PEG on a flat sequence requires the video shape")
            b, t, h, w = shape
            if self.layout == "thw":
                x = x.reshape(b, t, h, w, d)
            else:
                x = x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)
        out = _Depthwise3x3x3.apply(x, self.weight, self.bias, self.causal)
        if len(orig_shape) == 3 and self.layout == "bhw_t":
            out = out.permute(0, 2, 3, 1, 4)
        return out.reshape(orig_shape)
