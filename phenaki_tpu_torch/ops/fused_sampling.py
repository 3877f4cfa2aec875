"""Gumbel sampling + re-mask score: the CUDA kernels' wrappers and their
plain versions.

Counterpart of phenaki_tpu/ops/pallas_sampling.py, both of its kernels:

* `project_sample` (TPU `project_gumbel_sample_with_score`, kernel
  `_proj_kernel`; csrc/proj_sample.cu): the vocab projection fused with the
  sample, so the logits are never materialised;
* `gumbel_sample_with_score` (TPU kernel `_kernel`; csrc/gumbel_sample.cu):
  the same sample over materialised (b, n, V) logits, with the CFG combine
  fused in when the logits arrive stacked (2b, n, V), conditioned rows first.

Per row: the sample is argmax(logits / max(T, 1e-10) + gumbel(u)), ties to
the lowest id, and the score is 1 - softmax(logits)[id] on the untempered
logits. On the card the uniforms u come from Philox-4x32-10 inside the
kernels, keyed by (seed, row, vocab id) and seeded from the caller's (CPU)
`torch.Generator`; the plain versions draw them with `torch.rand`. The two
streams differ, the distribution is the same. `noise=` (b, n, V) uniforms
replace both, for exact comparisons. A CPU tensor takes the plain version; a
CUDA tensor launches a kernel (or raises).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.fused_ce import GEMM_ROWS as ROW_TILE
from phenaki_tpu_torch.ops.fused_ce import GEMM_VOCAB_TILE as VOCAB_TILE
from phenaki_tpu_torch.ops.fused_ce import _aligned, _row_padded, wave_splits
from phenaki_tpu_torch.ops.sampling import gumbel, uniform

# csrc/proj_sample.cu's constants (the bf16 kernel's tiles, ROW_TILE and
# VOCAB_TILE, are csrc/vocab_gemm.cuh's)
F32_VOCAB_CHUNK = 64  # vocab ids a block of the f32 kernel (VC), one partial each
_NPART = 5  # floats a partial: best y, id, chosen logit, max, sum-exp
_DEFAULT_SMS = 132  # an H100 SXM's SMs, for a tensor that is not on a card


def can_fuse_projection(d: int, v: int) -> bool:
    """Shape gate, the TPU wrapper's: d % 128 == 0 and a vocab that splits
    into 512- or 1024-wide blocks. Other shapes materialise the logits and
    take `gumbel_sample_with_score`, as on the TPU."""
    return d % 128 == 0 and (v % 1024 == 0 or v % 512 == 0) and v >= 512


@functools.lru_cache(maxsize=None)
def vocab_splits(rows: int, v: int, dtype: torch.dtype, sms: int = _DEFAULT_SMS) -> int:
    """The kernel's vocab splits S: one partial per (row, split). bf16 takes
    `fused_ce.wave_splits` (9 x 14 = 126 blocks at 1152 rows on 132 SMs);
    the f32 kernel writes one partial per 64-id chunk."""
    if dtype == torch.float32:
        return v // F32_VOCAB_CHUNK
    return wave_splits(rows, v, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return _DEFAULT_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _partials(rows: int, splits: int, device) -> torch.Tensor:
    """The kernel's scratch: one partial per (row, vocab split)."""
    return torch.empty((rows, splits, _NPART), dtype=torch.float32, device=device)


def _seed(generator: Optional[torch.Generator]) -> int:
    gen = generator if generator is not None else torch.default_generator
    if gen.device.type != "cpu":
        raise ValueError("the sampling seed comes from a CPU torch.Generator (no device sync)")
    return int(torch.randint(0, 2**63 - 1, (1,), generator=gen).item())


_on_card = functools.partial(_build.on_card, "sampling kernels")


def _same_device(ref: torch.Tensor, *others) -> None:
    for t in others:
        if t is not None and t.device != ref.device:
            raise ValueError("sampling kernels: all operands must be on one device")


def _sample_and_score(logits, temperature: float, generator, noise):
    """The plain sample and score over f32 (..., V) logits."""
    if noise is None:
        noise = uniform(logits.shape, generator, logits.device)
    y = logits * (1.0 / max(float(temperature), 1e-10)) + gumbel(noise.reshape(logits.shape))
    ids = y.argmax(dim=-1)  # first maximal index: ties go to the lowest id
    m = logits.amax(dim=-1, keepdim=True)
    sumexp = torch.exp(logits - m).sum(dim=-1)
    chosen = logits.gather(-1, ids[..., None])[..., 0]
    return ids, 1.0 - torch.exp(chosen - m[..., 0]) / sumexp


def _projected_logits(h, weight, bias):
    logits = torch.matmul(h.float(), weight.float().t())
    return logits + bias.float() if bias is not None else logits


# ---------------------------------------------------------------------------
# gumbel_sample_with_score: materialised logits (TPU kernel `_kernel`)


def gumbel_sample_with_score_plain(logits, temperature: float, *, cond_scale: Optional[float] = None,
                                   generator=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the CFG combine `null + (cond - null) * cond_scale` in
    f32 on stacked logits, then the sample and score. Returns (ids (b, n)
    int64, score (b, n) f32)."""
    logits = logits.float()
    if cond_scale is not None:
        if logits.shape[0] % 2:
            raise ValueError(f"stacked CFG logits need an even leading size, not {logits.shape[0]}")
        cond, null = logits.chunk(2)
        logits = null + (cond - null) * float(cond_scale)
    return _sample_and_score(logits, temperature, generator, noise)


def _sample_operands(logits, cond_scale, noise):
    """Validate; return (b, n, logits contiguous, noise f32 contiguous or None)."""
    if logits.ndim != 3:
        raise ValueError(f"logits must be (b, n, V), not {tuple(logits.shape)}")
    bb, n, v = logits.shape
    if cond_scale is not None and bb % 2:
        raise ValueError(f"stacked CFG logits need an even leading size, not {bb}")
    if logits.dtype not in _build.DTYPES:
        raise ValueError(f"gumbel_sample kernel takes {list(_build.DTYPES)}, not {logits.dtype}")
    b = bb // 2 if cond_scale is not None else bb
    if noise is not None:
        if noise.shape != (b, n, v):
            raise ValueError(f"noise must be {(b, n, v)}, not {tuple(noise.shape)}")
        noise = noise.float().contiguous()
    return b, n, logits.contiguous(), noise


def gumbel_sample_with_score(logits, temperature: float, *, cond_scale: Optional[float] = None,
                             generator=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over materialised logits -> (ids (b, n) int64, score (b, n) f32).

    logits (b, n, V) in bf16 or f32, any V; with `cond_scale` the stacked CFG
    forward (2b, n, V), conditioned rows first, combined inside the kernel
    (no split, no copy). temperature and cond_scale are Python floats."""
    if not _on_card(logits):
        return gumbel_sample_with_score_plain(logits, temperature, cond_scale=cond_scale,
                                              generator=generator, noise=noise)
    b, n, flat, noise = _sample_operands(logits, cond_scale, noise)
    _same_device(logits, noise)
    rows, v = b * n, logits.shape[2]
    seed = _seed(generator) if noise is None else 0
    ids = torch.empty(rows, dtype=torch.int32, device=logits.device)
    score = torch.empty(rows, dtype=torch.float32, device=logits.device)
    p = _build.ptr
    err = _build.load_library().gumbel_sample(
        p(flat), p(noise), p(ids), p(score), rows, v, 1.0 / max(float(temperature), 1e-10),
        int(cond_scale is not None), float(cond_scale or 0.0), seed, _build.DTYPES[logits.dtype],
        _build.stream(logits.device))
    _build.check(err, "gumbel_sample")
    gumbel_sample_with_score.launches += 1
    return ids.long().view(b, n), score.view(b, n)


# ---------------------------------------------------------------------------
# project_sample: the projection fused in (TPU kernel `_proj_kernel`)


def project_sample_plain(h, weight, bias, temperature: float, *, generator=None, noise=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialises the (b, n, V) f32 logits.
    Returns (ids (b, n) int64, score (b, n) f32)."""
    return _sample_and_score(_projected_logits(h, weight, bias), temperature, generator, noise)


def _kernel_operands(h, weight, bias, noise):
    """Validate; return (h rows zero-padded to ROW_TILE, weight, bias f32,
    noise f32) as contiguous tensors, h, weight and bias 16-byte aligned."""
    if h.ndim != 3 or weight.ndim != 2 or weight.shape[1] != h.shape[2]:
        raise ValueError(f"h (b, n, d) {tuple(h.shape)} and weight (V, d) {tuple(weight.shape)} disagree")
    b, n, d = h.shape
    v = weight.shape[0]
    if not can_fuse_projection(d, v):
        raise ValueError(f"project_sample kernel does not take d={d}, V={v}")
    if h.dtype not in _build.DTYPES or weight.dtype != h.dtype:
        raise ValueError(f"project_sample kernel takes h and weight of one dtype in {list(_build.DTYPES)}")
    rows = b * n
    flat = _row_padded(h.reshape(rows, d), ROW_TILE)
    if bias is not None:
        if bias.shape != (v,):
            raise ValueError(f"bias must be ({v},)")
        bias = _aligned(bias.float().contiguous())
    if noise is not None:
        noise = noise.reshape(rows, v).float().contiguous()
    return _aligned(flat.contiguous()), _aligned(weight.contiguous()), bias, noise


def project_sample(h, weight, bias, temperature: float, *, generator=None, noise=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sample(h @ weight^T + bias)` -> (ids (b, n) int64, score (b, n) f32).

    h (b, n, d); weight (V, d), the nn.Linear layout; bias (V,) or None;
    temperature a Python float. A CPU tensor takes the plain version. On a
    CUDA tensor every shape `can_fuse_projection` admits launches the fused
    kernel; any other shape gets its f32 logits from `torch.matmul` and
    launches `gumbel_sample_with_score`, as the TPU wrapper does in XLA."""
    if not _on_card(h):
        return project_sample_plain(h, weight, bias, temperature, generator=generator, noise=noise)
    _same_device(h, weight, bias, noise)
    if h.ndim == 3 and weight.ndim == 2 and not can_fuse_projection(weight.shape[1], weight.shape[0]):
        return gumbel_sample_with_score(_projected_logits(h, weight, bias), temperature,
                                        generator=generator, noise=noise)
    flat, weight, bias, noise = _kernel_operands(h, weight, bias, noise)
    b, n, d = h.shape
    v = weight.shape[0]
    rows = b * n
    seed = _seed(generator) if noise is None else 0
    lib = _build.load_library()
    ids = torch.empty(rows, dtype=torch.int32, device=h.device)
    score = torch.empty(rows, dtype=torch.float32, device=h.device)
    splits = vocab_splits(rows, v, h.dtype, _sm_count(h.device))
    partials = _partials(rows, splits, h.device)
    p = _build.ptr
    err = lib.proj_sample(
        p(flat), p(weight), p(bias), p(noise), p(ids), p(score), p(partials), rows, d, v, splits,
        float(temperature), seed, _build.DTYPES[h.dtype], _build.stream(h.device),
    )
    _build.check(err, "proj_sample")
    project_sample.launches += 1
    return ids.long().view(b, n), score.view(b, n)


gumbel_sample_with_score.launches = 0
project_sample.launches = 0
