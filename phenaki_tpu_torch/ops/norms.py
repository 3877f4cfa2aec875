"""Normalization primitives (counterpart of phenaki_tpu/ops/norms.py).

Statistics are kept in float32 whatever the compute dtype; the result is
cast back to the input's dtype.

On a card, `layer_norm` (the LayerNorms' forward) launches csrc/norms.cu's
`layernorm_kernel`, one pass; a CPU tensor takes the plain version. Where
autograd records the call (training, the R1 penalty) the kernel still runs
the forward, and `_LayerNorm`'s backward is the plain version's derivative
in PyTorch (the kernels have no backward). ops/attention.py's
`qk_norm_split` launches the file's other kernel through the helpers here.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from phenaki_tpu_torch import _build

EPS = 1e-5

# dtype codes of the norm kernels' C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the widest rows layernorm_kernel takes, in bytes: a block of 256 threads
# holds a row in registers, 8 16-byte vectors a thread
LN_MAX_ROW_BYTES = 256 * 8 * 16


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis: t * rsqrt(max(sum t^2, eps^2)) in f32."""
    t32 = t.float()
    ss = (t32 * t32).sum(-1, keepdim=True)
    return (t32 * torch.rsqrt(ss.clamp_min(eps * eps))).to(t.dtype)


def l2norm_scaled(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """l2norm(t) * scale (the learned per-dim q/k scales)."""
    return l2norm(t) * scale.to(t.dtype)


_on_card = functools.partial(_build.on_card, "norm kernel")


def records(*tensors) -> bool:
    """True where autograd records a call on these operands."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes(x: torch.Tensor, width: int, max_bytes: int) -> bool:
    """Whether a kernel takes rows of `width` values of x's dtype: whole
    16-byte vectors, at most `max_bytes`."""
    nbytes = width * x.element_size()
    return nbytes % 16 == 0 and nbytes <= max_bytes


def rows16(t: torch.Tensor) -> torch.Tensor:
    """t itself where its last axis is contiguous and its address and other
    strides lie on 16 bytes (the kernels copy 16 bytes at a time), else a
    contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def check_dtypes(what: str, x: torch.Tensor, *params) -> None:
    params = [p for p in params if p is not None]
    if x.dtype not in DTYPES or any(p.dtype not in DTYPES or p.dtype != params[0].dtype for p in params):
        raise ValueError(f"{what} takes x in {list(DTYPES)} and parameters of one such dtype, not "
                         f"{x.dtype}, {[p.dtype for p in params]}")


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `layer_norm`: f32 statistics, biased variance."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + EPS) * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis: (x - mean) * rsqrt(var + 1e-5) * gamma
    (+ beta), mean and biased variance in f32, in x's dtype.

    x (..., d) in f32, bf16 or f16; gamma and beta (d,) of one such dtype,
    read as f32 (the plain version's `.float()`). A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/norms.cu's `layernorm_kernel` (one
    read and one write of x, one rounding), under autograd with the plain
    version's derivative (`_LayerNorm`), or raises: d must be whole 16-byte
    vectors, at most LN_MAX_ROW_BYTES. x is read in place where its rows lie
    on 16 bytes, else copied; the output is contiguous."""
    if not _on_card(x, gamma, beta):
        return layer_norm_plain(x, gamma, beta)
    if records(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta)
    return _layer_norm_kernel(x, gamma, beta)


class _LayerNorm(torch.autograd.Function):
    """`layernorm_kernel`'s forward with the plain version's derivative: the
    statistics are taken again from x, then the usual LayerNorm backward in
    f32 (differentiable again, as the R1 penalty's second derivative needs)."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        ctx.save_for_backward(x, gamma, beta)
        return _layer_norm_kernel(x, gamma, beta)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        x32, dy32 = x.float(), dy.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        r = torch.rsqrt(var + EPS)
        xhat = (x32 - mean) * r
        rows = tuple(range(x.ndim - 1))
        dx = dgamma = dbeta = None
        if ctx.needs_input_grad[0]:
            g = dy32 * gamma.float()
            dx = (r * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dgamma = (dy32 * xhat).sum(rows).to(gamma.dtype)
        if beta is not None and ctx.needs_input_grad[2]:
            dbeta = dy32.sum(rows).to(beta.dtype)
        return dx, dgamma, dbeta


def _layer_norm_kernel(x, gamma, beta):
    d = x.shape[-1]
    check_dtypes("LayerNorm kernel", x, gamma, beta)
    if gamma.shape != (d,) or (beta is not None and beta.shape != (d,)):
        raise ValueError(f"LayerNorm kernel: gamma {tuple(gamma.shape)} and beta "
                         f"{None if beta is None else tuple(beta.shape)} must be ({d},)")
    if not takes(x, d, LN_MAX_ROW_BYTES):
        raise ValueError(f"LayerNorm kernel takes rows of whole 16-byte vectors up to {LN_MAX_ROW_BYTES} "
                         f"bytes, not {d} values of {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    rows = rows16(x.reshape(-1, d))
    gamma = gamma.contiguous()
    beta = beta.contiguous() if beta is not None else None
    p = _build.ptr
    err = _build.load_library().layer_norm_fwd(
        p(rows), p(gamma), p(beta), p(out), rows.shape[0], d, rows.stride(0), d, EPS,
        DTYPES[x.dtype], DTYPES[gamma.dtype], _build.stream(x.device))
    _build.check(err, "layer_norm_fwd")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


class LayerNorm(nn.Module):
    """LayerNorm with a learned gamma and beta frozen at zero; eps 1e-5,
    biased variance."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma)


class StandardLayerNorm(nn.Module):
    """LayerNorm with learned gamma and beta."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta)
