"""GEGLU feedforward block (counterpart of phenaki_tpu/ops/feedforward.py).

On a card the block's first product runs csrc/geglu_gemm.cu's
`geglu_gemm_kernel` with the gate in its epilogue (`geglu_gemm`): proj_in's
weight is packed (`pack_proj_in`: each half zero-padded to a multiple of 64
rows and their 64-row tiles interleaved, a then gate), the kernel writes h
= gelu(gate) * a at the padded width Ip, whose extra columns are exactly 0,
and proj_out is a plain product against its weight zero-padded to Ip
columns: every row 16-byte aligned, so cuBLAS takes its Hopper kernels. A CPU
tensor takes the plain version, `geglu(linear(...))`. Under autograd the
kernel still runs the forward and also writes the packed pre-activation;
`_GegluGemm`'s backward is the TPU package's `geglu` VJP (only the projection
is saved, the gate's math redone in f32) on the packed layout, then plain
products (the tests hold it to plain autograd and to the JAX VJP)."""

from __future__ import annotations

import functools
import math
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.fused_sampling import _sm_count
from phenaki_tpu_torch.ops.norms import StandardLayerNorm, records
from phenaki_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group
from phenaki_tpu_torch.utils.logging import span

# columns of h a 128-row tile of the packed proj_in weight holds: its first 64
# rows are a's, its last 64 gate's (csrc/geglu_gemm.cu GG_COLS)
PACK_COLS = 64
PACK_TILE = 2 * PACK_COLS
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def ff_inner_dim(dim: int, mult: int = 4) -> int:
    """Inner width `int(mult * 2/3 * dim)`: 1365 at dim 512."""
    return int(mult * (2 / 3) * dim)


def padded_inner(inner: int) -> int:
    """The kernel's width of h: inner rounded up to a multiple of 64 (1408
    at 1365, 22 packed tiles)."""
    return -(-inner // PACK_COLS) * PACK_COLS


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


def pack_proj_in(w: torch.Tensor) -> torch.Tensor:
    """proj_in's (2 * inner, d) weight [a | gate] -> (2 * Ip, d): each half
    zero-padded to Ip rows, then tile t = rows 64 t .. 64 t + 63 of a, then
    the same rows of gate. Differentiable."""
    inner, d = w.shape[0] // 2, w.shape[1]
    ip = padded_inner(inner)
    halves = [F.pad(h, (0, 0, 0, ip - inner)).reshape(ip // PACK_COLS, PACK_COLS, d) for h in w.chunk(2)]
    return torch.stack(halves, dim=1).reshape(2 * ip, d)


def unpack_proj_in(wp: torch.Tensor, inner: int) -> torch.Tensor:
    """The inverse of `pack_proj_in`: (2 * Ip, d) -> (2 * inner, d)."""
    d = wp.shape[1]
    tiles = wp.reshape(-1, 2, PACK_COLS, d)
    return torch.cat([tiles[:, i].reshape(-1, d)[:inner] for i in range(2)])


def pad_proj_out(w: torch.Tensor) -> torch.Tensor:
    """proj_out's (dim, inner) weight with zero columns up to Ip."""
    return F.pad(w, (0, padded_inner(w.shape[1]) - w.shape[1]))


def geglu_packed(pre: torch.Tensor) -> torch.Tensor:
    """GEGLU on the packed pre-activation (..., 2 * Ip): each 128-column tile
    pairs its first 64 columns (a) with its last 64 (gate)."""
    tiles = pre.reshape(*pre.shape[:-1], -1, 2, PACK_COLS)
    return (F.gelu(tiles[..., 1, :]) * tiles[..., 0, :]).reshape(*pre.shape[:-1], -1)


def geglu_gemm_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain version of `geglu_gemm` on the packed weight: (..., d) x (2 * Ip,
    d) -> h (..., Ip), in x's dtype."""
    return geglu_packed(torch.matmul(x, wp.to(x.dtype).t()))


@functools.lru_cache(maxsize=None)
def geglu_splits(rows: int, tiles: int, sms: int) -> int:
    """Splits S of the packed weight's tiles (a grid of (row tiles, S)
    blocks, one block an SM): the S that takes the fewest tile-times, waves
    x (passes a block + 1 for its load of x), ties to the smaller S. A block
    of nt tiles runs (nt + 2) & ~1 passes (csrc/vocab_gemm.cuh: the last
    tile's epilogue needs one more, and a trip is two). 2 at the MaskGit's
    36,864 rows and 22 tiles (576 blocks, 11 tiles each) and at the decoder's
    18,432."""
    row_tiles = -(-rows // PACK_TILE)

    def cost(s):
        nt = -(-tiles // s)
        return -(-row_tiles * s // sms) * (((nt + 2) & ~1) + 1)

    return min(range(1, tiles + 1), key=lambda s: (cost(s), s))


_on_card = functools.partial(_build.on_card, "GEGLU GEMM")


def geglu_gemm(x: torch.Tensor, wp: torch.Tensor, pre: bool = False):
    """h = GEGLU(x . proj_in^T) on the packed weight, (..., d) -> (..., Ip),
    in x's dtype: csrc/geglu_gemm.cu's `geglu_gemm_kernel` (bf16 on wgmma, d
    a multiple of 128) or its f32 kernel (any d); other dtypes and widths
    raise. x is read in place where it is contiguous and on 16 bytes, else
    copied; rows need no padding. With `pre`, also returns the packed pre-activation
    (..., 2 * Ip) that the backward reads. A CPU tensor takes
    `geglu_gemm_plain`."""
    if not _on_card(x, wp):
        p = torch.matmul(x, wp.to(x.dtype).t())
        return (geglu_packed(p), p) if pre else geglu_packed(p)
    d = x.shape[-1]
    if x.dtype not in _build.DTYPES or wp.dtype != x.dtype:
        raise ValueError(f"GEGLU GEMM takes x and the packed weight in one of {list(_build.DTYPES)}, not "
                         f"{x.dtype} and {wp.dtype}")
    if wp.shape[1] != d or wp.shape[0] % PACK_TILE:
        raise ValueError(f"GEGLU GEMM: packed weight {tuple(wp.shape)} for x of width {d}")
    if x.dtype == torch.bfloat16 and d % 128:
        raise ValueError(f"GEGLU GEMM takes bf16 rows of a multiple of 128 values, not {d}")
    ip = wp.shape[0] // 2
    rows = x.reshape(-1, d)
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        rows = rows.clone(memory_format=torch.contiguous_format)
    n = rows.shape[0]
    h = torch.empty(*x.shape[:-1], ip, dtype=x.dtype, device=x.device)
    p = torch.empty(*x.shape[:-1], 2 * ip, dtype=x.dtype, device=x.device) if pre else None
    if n:
        wp = wp.contiguous()
        splits = geglu_splits(n, 2 * ip // PACK_TILE, _sm_count(x.device))
        err = _build.load_library().geglu_gemm(
            _build.ptr(rows), _build.ptr(wp), _build.ptr(h), _build.ptr(p), n, d, ip, splits,
            _build.DTYPES[x.dtype], _build.stream(x.device))
        _build.check(err, "geglu_gemm")
        geglu_gemm.launches += 1
    return (h, p) if pre else h


geglu_gemm.launches = 0


def _geglu_packed_bwd(pre: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
    """The TPU package's `_geglu_bwd` on the packed layout: d pre from the
    saved projection, the gate's math in f32, in pre's dtype."""
    tiles = pre.reshape(*pre.shape[:-1], -1, 2, PACK_COLS).float()
    a, g = tiles[..., 0, :], tiles[..., 1, :]
    dy = dh.reshape(a.shape).float()
    cdf = 0.5 * (1.0 + torch.erf(g * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * g * g)
    d_pre = torch.stack([dy * (g * cdf), dy * a * (cdf + g * pdf)], dim=-2)
    return d_pre.reshape(pre.shape).to(pre.dtype)


class _GegluGemm(torch.autograd.Function):
    """`geglu_gemm`'s forward (the kernel, which also writes the packed
    pre-activation) with the TPU package's VJP: d pre (`_geglu_packed_bwd`),
    then dx = d pre . Wp and d Wp = d pre^T . x as plain products, unpacked to
    proj_in's shape. Differentiable again: under create_graph the backward
    recomputes the projection from x and the weight with plain operations."""

    @staticmethod
    def forward(ctx, x, weight, wp):
        h, pre = geglu_gemm(x, wp, pre=True)
        ctx.save_for_backward(x, weight, wp, pre)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, weight, wp, pre = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: a graph that reaches x and the weight
            wp = pack_proj_in(weight.to(x.dtype))
            pre = torch.matmul(x, wp.t())
        d_pre = _geglu_packed_bwd(pre, dh)
        d = x.shape[-1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(d_pre, wp)
        if ctx.needs_input_grad[1]:
            dwp = torch.matmul(d_pre.reshape(-1, d_pre.shape[-1]).t(), x.reshape(-1, d))
            dw = unpack_proj_in(dwp, weight.shape[0] // 2).to(weight.dtype)
        return dx, dw, None


class _Packed:
    """A weight's packed (or padded) copy in one dtype for the forwards that
    autograd does not record, rebuilt when the weight's tensor, storage or
    version changes (an optimizer step updates it in place)."""

    def __init__(self, build):
        self.build, self.key, self.value = build, None, None

    # a copy of the module (a tensor-parallel rank's clone) or its pickle
    # starts empty: the copy's weights are other tensors
    def __deepcopy__(self, memo):
        return _Packed(self.build)

    def __getstate__(self):
        return {"build": self.build}

    def __setstate__(self, state):
        self.__init__(state["build"])

    def get(self, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # an inference tensor (a tensor-parallel rank's clone made under
        # inference_mode) has no version: it is not updated in place
        key = (weight.data_ptr(), None if weight.is_inference() else weight._version, dtype)
        if self.key is None or self.key[0]() is not weight or self.key[1:] != key:
            with torch.no_grad():
                self.value = self.build(weight.to(dtype))
            self.key = (weakref.ref(weight), *key)
        return self.value


class FeedForward(nn.Module):
    """LN (with beta) -> Linear(2*inner, no bias) -> GEGLU -> dropout ->
    Linear(dim, no bias).

    `inner_dim` overrides the width `int(mult * 2/3 * dim)` (the TPU
    package's field; a tensor-parallel rank's columns);
    `tp_group` makes the block tensor-parallel as `ops.attention.Attention`
    is: the normed input enters `proj_in` through `copy_to_group` and
    `proj_out`'s partial product is completed by one all-reduce. On a card
    the products and the GEGLU run as the module docstring says, at the
    padded width; dropout then acts on the padded h (its extra columns stay
    0)."""

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
        self._packed_in = _Packed(pack_proj_in)
        self._padded_out = _Packed(pad_proj_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(self.norm(x), self.tp_group)
        with span("phenaki.feedforward"):
            if _on_card(x, self.proj_in.weight):
                w_in, w_out = self.proj_in.weight, self.proj_out.weight
                if records(x, w_in, w_out):  # packed afresh: a cached copy may be an inference tensor
                    h = _GegluGemm.apply(x, w_in, pack_proj_in(w_in.detach().to(x.dtype)))
                    w_out = pad_proj_out(w_out.to(x.dtype))
                else:
                    h = geglu_gemm(x, self._packed_in.get(w_in, x.dtype))
                    w_out = self._padded_out.get(w_out, x.dtype)
                if self.dropout > 0:
                    h = F.dropout(h, self.dropout, self.training)
                out = torch.matmul(h, w_out.t())
            else:
                h = geglu(linear(x, self.proj_in))
                if self.dropout > 0:
                    h = F.dropout(h, self.dropout, self.training)
                out = linear(h, self.proj_out)
        return reduce_from_group(out, self.tp_group)
