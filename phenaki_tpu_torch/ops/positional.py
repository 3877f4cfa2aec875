"""Positional machinery: ALiBi, continuous position bias, PEG
(counterpart of phenaki_tpu/ops/positional.py)."""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch import _build
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


def _taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The depthwise weight (d, 1, 3, 3, 3) as taps (3, 3, 3, d) of `dtype`."""
    return weight.to(dtype)[:, 0].permute(1, 2, 3, 0)


def peg_stencil_plain(x, weight, bias, causal: bool) -> torch.Tensor:
    """Plain version of `peg_stencil`: x + (the stencil + bias), in x's dtype."""
    frame_pad = (2, 0) if causal else (1, 1)
    return _stencil(_pad(x, frame_pad), _taps(weight, x.dtype), x.shape[:4]) + bias.to(x.dtype) + x


_on_card = functools.partial(_build.on_card, "PEG kernel")


def peg_stencil(x, weight, bias, causal: bool) -> torch.Tensor:
    """PEG with the layer's residual in one pass: x + bias + the depthwise
    3x3x3 stencil of x over its (t, h, w) grid, with zero padding (frames
    (2, 0) if causal, else (1, 1); rows and columns (1, 1)).

    x (b, t, h, w, d) in f32 or bf16, with d and the strides of (b, t, h, w)
    multiples of 16 bytes (every model's d is a multiple of 8); weight
    (d, 1, 3, 3, 3) and bias (d,), f32 or bf16, of one dtype, rounded to x's
    as the plain version casts them. The output has x's layout. A CPU tensor
    takes the plain version; a CUDA tensor launches csrc/peg_stencil.cu's
    kernel (f32 sums, one rounding) or raises."""
    if not _on_card(x, weight, bias):
        return peg_stencil_plain(x, weight, bias, causal)
    if x.ndim != 5 or weight.shape != (x.shape[-1], 1, 3, 3, 3) or bias.shape != (x.shape[-1],):
        raise ValueError(f"PEG kernel: x (b, t, h, w, d) {tuple(x.shape)}, weight (d, 1, 3, 3, 3) "
                         f"{tuple(weight.shape)} and bias (d,) {tuple(bias.shape)} disagree")
    if x.dtype not in _build.DTYPES or weight.dtype not in _build.DTYPES or bias.dtype != weight.dtype:
        raise ValueError(f"PEG kernel takes x in {list(_build.DTYPES)} and weight and bias of one such "
                         f"dtype, not {x.dtype}, {weight.dtype}, {bias.dtype}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    vec = 16 // x.element_size()  # the kernel copies 16 bytes at a time
    if x.shape[-1] % vec or any(s % vec for s in x.stride()[:4]) or x.data_ptr() % 16:
        raise ValueError(f"PEG kernel: d ({x.shape[-1]}), x's strides {x.stride()[:4]} and its address "
                         f"must be multiples of 16 bytes ({vec} {x.dtype} values)")
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x)  # x's layout where x is dense, else contiguous
    b, t, h, w, d = x.shape
    p = _build.ptr
    err = _build.load_library().peg_stencil(
        p(x), p(weight), p(bias), p(out), b, t, h, w, d, *x.stride()[:4],
        *out.stride()[:4], int(causal), _build.DTYPES[x.dtype], _build.DTYPES[weight.dtype],
        _build.stream(x.device))
    _build.check(err, "peg_stencil")
    peg_stencil.launches += 1
    return out


peg_stencil.launches = 0


class _Depthwise3x3x3(torch.autograd.Function):
    """`peg_stencil` with an explicit backward, as the TPU package's
    `depthwise3x3x3` VJP: autograd of the overlapping strided view takes
    PyTorch's generic `as_strided` backward, which scatters the (27 x larger)
    window gradient back with index_add. Here dx is dy (the residual) plus the
    same stencil over dy with the taps flipped (frame padding swapped), and
    the tap and bias gradients are f32 reductions."""

    @staticmethod
    def forward(ctx, x, weight, bias, causal):
        ctx.save_for_backward(x, weight, bias)
        ctx.frame_pad = (2, 0) if causal else (1, 1)
        return peg_stencil(x, weight, bias, causal)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        lo, hi = ctx.frame_pad
        grid = x.shape[:4]
        # dx[t] = dy[t] + sum_dt dy[t + lo - dt] * k[dt]
        dx = _stencil(_pad(dy, (hi, lo)), _taps(weight, x.dtype).flip(0, 1, 2), grid) + dy
        dy32 = dy.float()[:, :, :, :, None, None, None, :]
        dtaps = (_windows(_pad(x, (lo, hi)), grid).float() * dy32).sum(dim=(0, 1, 2, 3))
        dweight = dtaps.permute(3, 0, 1, 2)[:, None].to(weight.dtype)
        dbias = dy.float().sum(dim=(0, 1, 2, 3)).to(bias.dtype)
        return dx, dweight, dbias, None


class PEG(nn.Module):
    """Positional encoding generator with the layer's residual: x + a
    depthwise 3x3x3 conv of x over the token grid (`peg_stencil`).

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
        """x: (b, t, h, w, d), or flat (rows, seq, d) with `shape` = (b, t, h, w).
        Returns x + PEG(x) in x's shape."""
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
