"""Flash attention: the CUDA kernels' wrappers, their plain versions, and the
autograd Function that joins the forward to its backward.

Counterpart of phenaki_tpu/ops/pallas_attention.py (`flash_qk_attention`:
the forward, TPU kernel `_flash_kernel`, and its custom VJP, TPU kernels
`_bwd_dq_kernel`, `_bwd_dkv_kernel`, `_bwd_dbias_kernel`). The kernels live
in csrc/flash_attention.cu and csrc/flash_attention_bwd.cu; their source
notes say what bounds them on the H100.

Contract: `softmax(scale * q @ k^T + bias[h] + kmask[b]) @ v` with f32
statistics, q (b, h, i, d), k/v (b, h, j, d), bias (h, i, j) shared over the
batch, kmask (b, j) additive f32 (0 or NEG_INF), causal with the queries at
the last i of the j keys. The output has the input dtype; `return_lse` adds
the f32 per-row log-sum-exp (b, h, i). The bias is streamed in q's dtype,
as the TPU wrapper does.

Gradients flow to q, k, v and the bias (accumulated in f32 and cast to the
bias's dtype); the kmask gets none, as in the TPU package. The backward
recomputes `p = exp(s - lse)` from the forward's saved lse; a row whose keys
are all masked (lse = -inf, out = 0) has p = 0 and so zero gradients.
Both autograd Functions are first-order only, as the TPU kernel's
`custom_vjp` is: a double backward through them raises (on the card their
backward's outputs come from C kernels and carry no graph).

`flash_attend_chunk` is the ring-attention chunk (TPU kernel 3,
`flash_attend_chunk`): the unnormalised `acc = sum p v` and `l = sum p` of
the queries against one K/V shard, `p = 2^(s log2(e) - c2)` with a bound c2
shared by the whole ring (an f32 tensor on the queries' device) and the
causal mask at global positions `offsets = (q_off, k_off)`: key c is seen
by row r iff `c + k_off <= r + q_off`. The bias may be a column slice of a
wider (h, i, N) tensor; the kernel reads it in place. Its backward runs the
three backward kernels with `lse = c2 ln 2`, `dO = d(acc)` and
`delta = -d(l)`; c2 gets no gradient (the normalised ring output does not
depend on it).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from phenaki_tpu_torch import _build

NEG_INF = -1e30
MAX_DIM_HEAD = 128
# the TPU package's cutoff on query rows, kept until it is measured on the card
MIN_FLASH_SEQ = 64
HARD_MASK = -1e29  # a kmask value at or below this gives the key weight 0
LOG2E = 1.4426950408889634
LN2 = math.log(2.0)


def flash_attention_plain(q, k, v, bias=None, kmask=None, *, scale: float, causal: bool = False,
                          return_lse: bool = False):
    """Plain PyTorch version: the (i, j) scores materialised in f32. A row
    whose keys are all masked gives out = 0 and lse = -inf, as the kernel."""
    sim = _scores(q, k, bias, kmask, scale, causal)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    dead = _dead_rows(sim, kmask, causal)
    if dead is not None:
        out = out.masked_fill(dead[..., None], 0.0)
    if not return_lse:
        return out
    lse = torch.logsumexp(sim, dim=-1)
    return out, (lse if dead is None else lse.masked_fill(dead, -torch.inf))


def _scores(q, k, bias, kmask, scale, causal, offsets=None):
    """f32 scores; a masked key scores about NEG_INF (finite, so a row of
    them has a finite softmax that `_dead_rows` then overrides). Causal
    masking takes the global (q_off, k_off); by default the queries are the
    last i of the j keys."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if bias is not None:
        sim = sim + bias.to(q.dtype).float()[None]
    if kmask is not None:
        sim = sim + kmask.float()[:, None, None, :]
    if causal:
        i, j = sim.shape[-2:]
        q_off, k_off = offsets if offsets is not None else (j - i, 0)
        row = torch.arange(i, device=q.device)[:, None] + q_off
        col = torch.arange(j, device=q.device)[None, :] + k_off
        sim = sim.masked_fill(col > row, NEG_INF)
    return sim


def _dead_rows(sim, kmask, causal):
    """(b, h, i) True where every key is masked (None when no mask can do
    that): the kernel's hard mask is an additive kmask <= HARD_MASK."""
    if kmask is None and not causal:
        return None
    return sim.amax(dim=-1) <= HARD_MASK


def _probs(sim, lse):
    """exp(sim - lse), and 0 on a row with no unmasked key (lse = -inf)."""
    lse = lse[..., None]
    return torch.exp(sim - lse).masked_fill(torch.isneginf(lse), 0.0)


def flash_attention_backward_plain(q, k, v, bias, kmask, out, lse, do, *, scale: float,
                                   causal: bool = False, offsets=None, delta=None):
    """Plain PyTorch backward: (dq, dk, dv, dbias) with dbias (h, i, j) f32,
    or None without a bias.

    It recomputes p = exp(s - lse) from the saved lse the way the TPU
    package's `_recompute_p` does, rather than differentiating the plain
    forward, and rounds p and dS to the input dtype before the products that
    consume them, as the TPU kernels do. `delta` (b, h, i) replaces
    rowsum(dO * O) (the ring chunk passes -d(l) and no `out`); `offsets`
    are the causal mask's global (q_off, k_off)."""
    p, ds = _plain_ds(q, k, v, bias, kmask, out, lse, do, scale, causal, offsets, delta)
    dk, dv = _plain_dkv(q, k, v, do, p, ds, scale)
    dbias = ds.sum(0) if bias is not None else None
    return _plain_dq(k, ds, scale, q.dtype), dk, dv, dbias


def _plain_ds(q, k, v, bias, kmask, out, lse, do, scale, causal, offsets=None, delta=None):
    """p and dS = p * (dO v^T - delta), delta = rowsum(dO * O) unless given, f32."""
    p = _probs(_scores(q, k, bias, kmask, scale, causal, offsets), lse.float())
    if delta is None:
        delta = (do.float() * out.float()).sum(-1)
    dp = torch.einsum("bhid,bhjd->bhij", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def _plain_dq(k, ds, scale, dtype):
    return (torch.einsum("bhij,bhjd->bhid", ds.to(dtype).float(), k.float()) * scale).to(dtype)


def _plain_dkv(q, k, v, do, p, ds, scale):
    dk = torch.einsum("bhij,bhid->bhjd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhij,bhid->bhjd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# The plain version of each backward kernel alone: each recomputes p and dS,
# as its kernel does, then forms its own gradient.


def flash_attention_bwd_dq_plain(q, k, v, bias, kmask, out, lse, do, *, scale: float,
                                 causal: bool = False, offsets=None, delta=None):
    _, ds = _plain_ds(q, k, v, bias, kmask, out, lse, do, scale, causal, offsets, delta)
    return _plain_dq(k, ds, scale, q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, bias, kmask, out, lse, do, *, scale: float,
                                  causal: bool = False, offsets=None, delta=None):
    p, ds = _plain_ds(q, k, v, bias, kmask, out, lse, do, scale, causal, offsets, delta)
    return _plain_dkv(q, k, v, do, p, ds, scale)


def flash_attention_bwd_dbias_plain(q, k, v, bias, kmask, out, lse, do, *, scale: float,
                                    causal: bool = False, offsets=None, delta=None):
    return _plain_ds(q, k, v, bias, kmask, out, lse, do, scale, causal, offsets, delta)[1].sum(0)


def _kernel_operands(q, k, v, bias, kmask):
    """Validate shapes and dtypes; return the operands the kernels take:
    q, k, v contiguous, the bias as `_bias_operand` gives it, kmask in f32.
    On the bf16 wgmma route (`_wgmma_route`) q, k and v also start on a
    16-byte boundary, copied when they do not."""
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
    if bias is not None and bias.shape != (h, i, j):
        raise ValueError(f"bias must be (h, i, j) = {(h, i, j)}, got {tuple(bias.shape)}")
    if kmask is not None:
        if kmask.shape != (b, j):
            raise ValueError(f"kmask must be (b, j) = {(b, j)}, got {tuple(kmask.shape)}")
        kmask = kmask.to(torch.float32).contiguous()
    wgmma = _wgmma_route(q)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if wgmma:
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    return q, k, v, _bias_operand(bias, q.dtype, wgmma), kmask


def _wgmma_route(q) -> bool:
    """True where the call goes to the bf16 wgmma forward (d = 64 or 128 on a
    card), which moves q, k, v and the bias in 16-byte copies, as the wgmma
    dQ, dK/dV and dBias kernels (d = 64 and 128) move them and dO."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128) and _on_card(q)


def _bias_operand(bias, dtype, wgmma: bool):
    """The (h, i, j) bias in `dtype` as the kernels read it: unit column
    stride, rows `stride(1)` apart. A view that has these (a ring chunk's
    column slice of wider rows) is read in place; on the wgmma route only if
    its row stride is also a multiple of 8 and it starts on a 16-byte
    boundary. Any other bias is copied: contiguous, or on the wgmma route
    into rows padded to a multiple of 8, of which the first j columns are
    passed."""
    if bias is None:
        return None
    h, i, j = bias.shape
    row = bias.stride(1)
    if (bias.dtype == dtype and bias.stride(2) == 1 and row >= j and bias.stride(0) == i * row
            and (not wgmma or (row % 8 == 0 and bias.data_ptr() % 16 == 0))):
        return bias
    if not wgmma:
        return bias.to(dtype).contiguous()
    padded = bias.new_empty((h, i, -(-j // 8) * 8), dtype=dtype)
    padded[..., :j] = bias
    return padded[..., :j]


def _on_card(q, *others) -> bool:
    """False for CPU tensors (the plain versions); True for CUDA tensors on
    one device; raises for anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: unsupported device {q.device}")
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError("flash attention: all operands must be on one device")
    return True


def _forward(q, k, v, bias, kmask, scale, causal, return_lse):
    """The forward on prepared operands: plain on the CPU, the kernel on a card."""
    if not _on_card(q, k, v, bias, kmask):
        return flash_attention_plain(q, k, v, bias, kmask, scale=scale, causal=causal,
                                     return_lse=return_lse)
    lib = _build.load_library()
    b, h, i, d = q.shape
    j = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, i), dtype=torch.float32, device=q.device) if return_lse else None
    p = _build.ptr
    err = lib.flash_attention_fwd(
        p(q), p(k), p(v), p(bias), p(kmask), p(out), p(lse), b, h, i, j, d, _bias_ld(bias, j),
        float(scale), int(bool(causal)), _build.DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def _bwd_launch(name, outputs, q, k, v, bias, kmask, do, lse, delta, scale, causal, offsets):
    lib = _build.load_library()
    b, h, i, d = q.shape
    j = k.shape[2]
    q_off, k_off = offsets if offsets is not None else (j - i, 0)
    p = _build.ptr
    err = getattr(lib, name)(
        p(q), p(k), p(v), p(bias), p(kmask), p(do), p(lse), p(delta), *map(p, outputs),
        b, h, i, j, d, _bias_ld(bias, j), float(scale), int(bool(causal)), int(q_off), int(k_off),
        _build.DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(err, name)


def _bias_ld(bias, j: int) -> int:
    """The row stride the kernels read the bias with (j when there is none)."""
    return bias.stride(1) if bias is not None else j


def flash_attention_bwd_dq(q, k, v, bias, kmask, do, lse, delta, *, scale: float,
                           causal: bool = False, offsets=None):
    """dQ kernel on prepared CUDA operands; delta = rowsum(dO * O) f32 (or a
    ring chunk's -d(l)); `offsets` the causal mask's global (q_off, k_off)."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq", [dq], q, k, v, bias, kmask, do, lse, delta, scale, causal,
                offsets)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, kmask, do, lse, delta, *, scale: float,
                            causal: bool = False, offsets=None):
    """dK/dV kernel on prepared CUDA operands."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", [dk, dv], q, k, v, bias, kmask, do, lse, delta, scale,
                causal, offsets)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dbias(q, k, v, bias, kmask, do, lse, delta, *, scale: float,
                              causal: bool = False, offsets=None):
    """dBias kernel on prepared CUDA operands: (h, i, j) f32, summed over b."""
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attention_bwd_dbias", [dbias], q, k, v, bias, kmask, do, lse, delta, scale,
                causal, offsets)
    flash_attention_bwd_dbias.launches += 1
    return dbias


def flash_attention_backward(q, k, v, bias, kmask, out, lse, do, *, scale: float,
                             causal: bool = False, need_dbias: bool = True):
    """(dq, dk, dv, dbias f32 or None) on prepared operands: the plain
    backward on the CPU, the three kernels on a card."""
    if not _on_card(q, k, v, bias, kmask, out, lse, do):
        dq, dk, dv, dbias = flash_attention_backward_plain(q, k, v, bias, kmask, out, lse, do,
                                                           scale=scale, causal=causal)
        return dq, dk, dv, dbias if need_dbias else None
    do = do.to(q.dtype).contiguous()
    # delta = rowsum(dO * O) in f32, outside the kernels as in the TPU package
    delta = (do.float() * out.float()).sum(-1).contiguous()
    return _backward_kernels(q, k, v, bias, kmask, do, lse, delta, scale, causal, None, need_dbias)


def _backward_kernels(q, k, v, bias, kmask, do, lse, delta, scale, causal, offsets, need_dbias):
    """dQ, then dK/dV, then dBias (when asked for and there is a bias), on
    operands as `_kernel_operands` prepared them and a contiguous dO. On the
    wgmma route dO, which the three kernels also move in 16-byte copies, is
    copied when it does not start on a 16-byte boundary."""
    if _wgmma_route(q) and do.data_ptr() % 16:
        do = do.clone()
    args = (q, k, v, bias, kmask, do, lse, delta)
    kw = dict(scale=scale, causal=causal, offsets=offsets)
    dq = flash_attention_bwd_dq(*args, **kw)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    dbias = None
    if bias is not None and need_dbias:
        dbias = flash_attention_bwd_dbias(*args, **kw)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kmask, scale, causal):
        bias_dtype = bias.dtype if bias is not None else None
        q, k, v, bias, kmask = _kernel_operands(q, k, v, bias, kmask)
        out, lse = _forward(q, k, v, bias, kmask, scale, causal, True)
        ctx.save_for_backward(q, k, v, bias, kmask, out, lse)
        ctx.scale, ctx.causal, ctx.bias_dtype = scale, causal, bias_dtype
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, bias, kmask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_backward(
            q, k, v, bias, kmask, out, lse, do, scale=ctx.scale, causal=ctx.causal,
            need_dbias=ctx.needs_input_grad[3])
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, kmask=None, *, scale: float, causal: bool = False,
                    return_lse: bool = False):
    """Fused attention. A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels (or raises). Differentiable in q, k, v and bias
    when autograd records."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        out, lse = _FlashAttention.apply(q, k, v, bias, kmask, float(scale), bool(causal))
        return (out, lse) if return_lse else out
    q, k, v, bias, kmask = _kernel_operands(q, k, v, bias, kmask)
    return _forward(q, k, v, bias, kmask, scale, causal, return_lse)


# ---------------------------------------------------------------------------
# the ring-attention chunk (TPU kernel 3)


def flash_attend_chunk_plain(q, k, v, bias=None, kmask=None, *, c2, scale: float,
                             causal: bool = False, offsets=None):
    """Plain PyTorch version of the chunk: (acc (b, h, i, d), l (b, h, i)),
    both f32, p = 2^(s log2(e) - c2) (0 where masked) rounded to v's dtype
    before the PV product. A row with no visible key gives acc = 0, l = 0."""
    sim = _scores(q, k, bias, kmask, scale, causal, offsets)
    c2 = torch.as_tensor(c2, dtype=torch.float32, device=q.device).reshape(())
    p = torch.exp2(sim * LOG2E - c2)
    acc = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    return acc, p.sum(-1)


def _chunk_operands(q, k, v, bias, kmask, c2):
    """Validate the chunk's operands as `_kernel_operands` does (the bias's
    column slice is read in place where the kernels can), and c2 as one f32."""
    q, k, v, bias, kmask = _kernel_operands(q, k, v, bias, kmask)
    c2 = torch.as_tensor(c2, dtype=torch.float32, device=q.device).reshape(1)
    return q, k, v, bias, kmask, c2


def _chunk_forward(q, k, v, bias, kmask, c2, scale, causal, offsets):
    """The chunk on prepared operands: plain on the CPU, kernel 3 on a card."""
    if not _on_card(q, k, v, bias, kmask, c2):
        return flash_attend_chunk_plain(q, k, v, bias, kmask, c2=c2, scale=scale, causal=causal,
                                        offsets=offsets)
    lib = _build.load_library()
    b, h, i, d = q.shape
    j = k.shape[2]
    q_off, k_off = offsets if offsets is not None else (j - i, 0)
    acc = torch.empty((b, h, i, d), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, i), dtype=torch.float32, device=q.device)
    p = _build.ptr
    err = lib.flash_attend_chunk_fwd(
        p(q), p(k), p(v), p(bias), p(kmask), p(c2), p(acc), p(l), b, h, i, j, d, _bias_ld(bias, j),
        float(scale), int(bool(causal)), int(q_off), int(k_off), _build.DTYPES[q.dtype],
        _build.stream(q.device),
    )
    _build.check(err, "flash_attend_chunk_fwd")
    flash_attend_chunk.launches += 1
    return acc, l


def flash_attend_chunk_backward(q, k, v, bias, kmask, c2, dacc, dl, *, scale: float,
                                causal: bool = False, offsets=None, need_dbias: bool = True):
    """(dq, dk, dv, dbias f32 or None) of the chunk's (acc, l) on prepared
    operands: lse = c2 ln 2, dO = d(acc), delta = -d(l), through the plain
    backward on the CPU and the three backward kernels on a card."""
    b, h, i, _ = q.shape
    lse = (c2.float().reshape(()) * LN2).expand(b, h, i).contiguous()
    delta = (-dl.float()).contiguous()
    do = dacc.to(q.dtype).contiguous()
    if not _on_card(q, k, v, bias, kmask, do):
        dq, dk, dv, dbias = flash_attention_backward_plain(
            q, k, v, bias, kmask, None, lse, do, scale=scale, causal=causal, offsets=offsets,
            delta=delta)
        return dq, dk, dv, dbias if need_dbias else None
    return _backward_kernels(q, k, v, bias, kmask, do, lse, delta, scale, causal, offsets,
                             need_dbias)


class _FlashAttendChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kmask, c2, scale, causal, offsets):
        bias_dtype = bias.dtype if bias is not None else None
        q, k, v, bias, kmask, c2 = _chunk_operands(q, k, v, bias, kmask, c2)
        acc, l = _chunk_forward(q, k, v, bias, kmask, c2, scale, causal, offsets)
        ctx.save_for_backward(q, k, v, bias, kmask, c2)
        ctx.scale, ctx.causal, ctx.offsets, ctx.bias_dtype = scale, causal, offsets, bias_dtype
        return acc, l

    @staticmethod
    @once_differentiable
    def backward(ctx, dacc, dl):
        q, k, v, bias, kmask, c2 = ctx.saved_tensors
        if dacc is None:
            dacc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        if dl is None:
            dl = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        dq, dk, dv, dbias = flash_attend_chunk_backward(
            q, k, v, bias, kmask, c2, dacc, dl, scale=ctx.scale, causal=ctx.causal,
            offsets=ctx.offsets, need_dbias=ctx.needs_input_grad[3])
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attend_chunk(q, k, v, bias=None, kmask=None, *, c2, scale: float, causal: bool = False,
                       offsets=None):
    """One ring chunk: (acc (b, h, i, d), l (b, h, i)) f32. A CPU tensor
    takes the plain version; a CUDA tensor launches kernel 3 (or raises).
    `c2` is the ring's shared bound in log2 units (a tensor on q's device,
    not differentiated); `offsets` the global (q_off, k_off). Differentiable
    in q, k, v and bias when autograd records."""
    offsets = tuple(int(o) for o in offsets) if offsets is not None else None
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttendChunk.apply(q, k, v, bias, kmask, c2, float(scale), bool(causal), offsets)
    q, k, v, bias, kmask, c2 = _chunk_operands(q, k, v, bias, kmask, c2)
    return _chunk_forward(q, k, v, bias, kmask, c2, scale, causal, offsets)


flash_attention.launches = 0
flash_attend_chunk.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dbias.launches = 0
