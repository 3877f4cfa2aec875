"""Fused vocab projection + gumbel sampling + re-mask score: the CUDA
kernel's wrapper and its plain version.

Counterpart of phenaki_tpu/ops/pallas_sampling.py
(`project_gumbel_sample_with_score`, TPU kernel `_proj_kernel`). The kernel
lives in csrc/proj_sample.cu; its source note says what bounds it on the
H100 and how the vocab is split across blocks.

Per row of h: logits = h @ weight^T + bias over the vocab; the sample is
argmax(logits / max(T, 1e-10) + gumbel(u)), ties to the lowest id, and the
score is 1 - softmax(logits)[id] on the untempered logits. On the card the
uniforms u come from Philox-4x32-10 inside the kernel, seeded from the
caller's (CPU) `torch.Generator`; the plain version draws them with
`torch.rand`. The two streams differ, the distribution is the same. `noise=`
(rows, V) uniforms replace both, for exact comparisons.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.sampling import gumbel, uniform

ROW_TILE = 64  # rows per tile of h in the kernel (csrc/proj_sample.cu RT)
VOCAB_CHUNK = 64  # vocab columns per block (csrc/proj_sample.cu VC)
MAX_DIM = 768  # the (VOCAB_CHUNK, d) slice of W must fit shared memory
_NPART = 5


def can_fuse_projection(d: int, v: int) -> bool:
    """Shape gate, the TPU wrapper's: d % 128 == 0 and a vocab that splits
    into 512- or 1024-wide blocks."""
    return d % 128 == 0 and (v % 1024 == 0 or v % 512 == 0) and v >= 512


def _seed(generator: Optional[torch.Generator]) -> int:
    gen = generator if generator is not None else torch.default_generator
    if gen.device.type != "cpu":
        raise ValueError("the sampling seed comes from a CPU torch.Generator (no device sync)")
    return int(torch.randint(0, 2**63 - 1, (1,), generator=gen).item())


def project_sample_plain(h, weight, bias, temperature: float, *, generator=None, noise=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialises the (b, n, V) f32 logits.
    Returns (ids (b, n) int64, score (b, n) f32)."""
    logits = torch.einsum("bnd,vd->bnv", h.float(), weight.float())
    if bias is not None:
        logits = logits + bias.float()
    if noise is None:
        noise = uniform(logits.shape, generator, logits.device)
    y = logits * (1.0 / max(float(temperature), 1e-10)) + gumbel(noise.reshape(logits.shape))
    ids = y.argmax(dim=-1)  # first maximal index: ties go to the lowest id
    m = logits.amax(dim=-1, keepdim=True)
    sumexp = torch.exp(logits - m).sum(dim=-1)
    chosen = logits.gather(-1, ids[..., None])[..., 0]
    score = 1.0 - torch.exp(chosen - m[..., 0]) / sumexp
    return ids, score


def _kernel_operands(h, weight, bias, noise):
    """Validate; return (h rows zero-padded to ROW_TILE, weight, bias f32,
    noise f32) as contiguous tensors."""
    if h.ndim != 3 or weight.ndim != 2 or weight.shape[1] != h.shape[2]:
        raise ValueError(f"h (b, n, d) {tuple(h.shape)} and weight (V, d) {tuple(weight.shape)} disagree")
    b, n, d = h.shape
    v = weight.shape[0]
    if not can_fuse_projection(d, v) or d > MAX_DIM:
        raise ValueError(f"project_sample kernel does not take d={d}, V={v}")
    if h.dtype not in _build.DTYPES or weight.dtype != h.dtype:
        raise ValueError(f"project_sample kernel takes h and weight of one dtype in {list(_build.DTYPES)}")
    rows = b * n
    rows_pad = -(-rows // ROW_TILE) * ROW_TILE
    flat = h.reshape(rows, d)
    if rows_pad != rows:
        flat = torch.cat([flat, flat.new_zeros(rows_pad - rows, d)])
    if bias is not None:
        if bias.shape != (v,):
            raise ValueError(f"bias must be ({v},)")
        bias = bias.float().contiguous()
    if noise is not None:
        noise = noise.reshape(rows, v).float().contiguous()
    return flat.contiguous(), weight.contiguous(), bias, noise


def project_sample(h, weight, bias, temperature: float, *, generator=None, noise=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused `sample(h @ weight^T + bias)` -> (ids (b, n) int64, score (b, n) f32).

    h (b, n, d); weight (V, d), the nn.Linear layout; bias (V,) or None;
    temperature a Python float. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if h.device.type == "cpu":
        return project_sample_plain(h, weight, bias, temperature, generator=generator, noise=noise)
    if h.device.type != "cuda":
        raise RuntimeError(f"project_sample: unsupported device {h.device}")
    flat, weight, bias, noise = _kernel_operands(h, weight, bias, noise)
    for t in (weight, bias, noise):
        if t is not None and t.device != h.device:
            raise ValueError("project_sample: all operands must be on one device")
    b, n, d = h.shape
    v = weight.shape[0]
    rows = b * n
    seed = _seed(generator) if noise is None else 0
    lib = _build.load_library()
    ids = torch.empty(rows, dtype=torch.int32, device=h.device)
    score = torch.empty(rows, dtype=torch.float32, device=h.device)
    partials = torch.empty((rows, v // VOCAB_CHUNK, _NPART), dtype=torch.float32, device=h.device)
    p = _build.ptr
    err = lib.proj_sample(
        p(flat), p(weight), p(bias), p(noise), p(ids), p(score), p(partials), rows, d, v,
        float(temperature), seed, _build.DTYPES[h.dtype], _build.stream(h.device),
    )
    _build.check(err, "proj_sample")
    project_sample.launches += 1
    return ids.long().view(b, n), score.view(b, n)


project_sample.launches = 0
