"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of phenaki_tpu/ops/pallas_attention.py (the forward of
`flash_qk_attention`, TPU kernel `_flash_kernel`). The kernel lives in
csrc/flash_attention.cu; its source note says what bounds it on the H100.

Contract: `softmax(scale * q @ k^T + bias[h] + kmask[b]) @ v` with f32
statistics, q (b, h, i, d), k/v (b, h, j, d), bias (h, i, j) shared over the
batch, kmask (b, j) additive f32 (0 or NEG_INF), causal with the queries at
the last i of the j keys. The output has the input dtype; `return_lse` adds
the f32 per-row log-sum-exp (b, h, i). The bias is streamed in q's dtype,
as the TPU wrapper does.
"""

from __future__ import annotations

import torch

from phenaki_tpu_torch import _build

NEG_INF = -1e30
MAX_DIM_HEAD = 128


def flash_attention_plain(q, k, v, bias=None, kmask=None, *, scale: float, causal: bool = False,
                          return_lse: bool = False):
    """Plain PyTorch version: the (i, j) scores materialised in f32."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if bias is not None:
        sim = sim + bias.to(q.dtype).float()[None]
    if kmask is not None:
        sim = sim + kmask.float()[:, None, None, :]
    if causal:
        i, j = sim.shape[-2:]
        row = torch.arange(i, device=q.device)[:, None] + (j - i)
        col = torch.arange(j, device=q.device)[None, :]
        sim = sim.masked_fill(col > row, NEG_INF)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    if return_lse:
        return out, torch.logsumexp(sim, dim=-1)
    return out


def _kernel_operands(q, k, v, bias, kmask):
    """Validate shapes and dtypes; return the contiguous operands the kernel
    takes (bias in q's dtype, kmask in f32)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (b, h, seq, d)")
    b, h, i, d = q.shape
    j = k.shape[2]
    if k.shape != (b, h, j, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if d > MAX_DIM_HEAD:
        raise ValueError(f"dim_head {d} > {MAX_DIM_HEAD}")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in {list(_build.DTYPES)}")
    if bias is not None:
        if bias.shape != (h, i, j):
            raise ValueError(f"bias must be (h, i, j) = {(h, i, j)}, got {tuple(bias.shape)}")
        bias = bias.to(q.dtype).contiguous()
    if kmask is not None:
        if kmask.shape != (b, j):
            raise ValueError(f"kmask must be (b, j) = {(b, j)}, got {tuple(kmask.shape)}")
        kmask = kmask.to(torch.float32).contiguous()
    return q.contiguous(), k.contiguous(), v.contiguous(), bias, kmask


def flash_attention(q, k, v, bias=None, kmask=None, *, scale: float, causal: bool = False,
                    return_lse: bool = False):
    """Fused attention forward. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    q, k, v, bias, kmask = _kernel_operands(q, k, v, bias, kmask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, kmask, scale=scale, causal=causal,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    for t in (k, v, bias, kmask):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention: all operands must be on one device")
    lib = _build.load_library()
    b, h, i, d = q.shape
    j = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, i), dtype=torch.float32, device=q.device) if return_lse else None
    p = _build.ptr
    err = lib.flash_attention_fwd(
        p(q), p(k), p(v), p(bias), p(kmask), p(out), p(lse), b, h, i, j, d, float(scale),
        int(bool(causal)), _build.DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
