"""Fused vocab projection + softmax cross-entropy: the CUDA kernels'
wrappers, their plain versions, and the autograd Function that joins the
forward to its backward.

Counterpart of phenaki_tpu/ops/pallas_ce.py (`fused_vocab_cross_entropy`:
the forward, TPU kernel `_fwd_kernel`, and its custom VJP, TPU kernels
`_bwd_dh_kernel` and `_bwd_dw_kernel`). The kernels live in
csrc/fused_ce.cu; its source note says what bounds them on the H100.

Contract, per row of h (rows, d) against its integer label, over the V rows
of the weight (V, d), the nn.Linear layout: `logits = h @ weight^T + bias`
in f32, `loss = logsumexp(logits) - logits[label]` (a label outside [0, V)
picks no logit: loss = lse, the TPU kernels' -1 pad label). The backward
recomputes `dlog = (softmax(logits) - onehot) * g` from the saved lse and
gives `dh = dlog @ weight`, `dweight = dlog^T @ h` (dlog rounded to h's
dtype first, as the TPU kernels do) and `dbias = sum_rows dlog` in f32.
The weight is cast to h's dtype at use and its gradient returned in its own
dtype, so f32 parameters train with bf16 compute without a rounded gradient.
The (rows, V) logits exist only in the plain versions.
"""

from __future__ import annotations

import functools

import torch

from phenaki_tpu_torch import _build

MAX_DIM = 2432  # the TPU gate's VMEM bound; the kernels walk d in 512-wide slices past 512
RESIDENT_ROWS = 32  # rows of h an f32 forward or dh block holds (csrc/fused_ce.cu RES)
VOCAB_TILE = 64  # vocab ids an f32 forward / dh block takes a step (csrc/fused_ce.cu STR, CB_ROWS)
BWD_ROWS = 64  # rows of h a bf16 dh block holds; dh partials are padded to it (CB_ROWS)
# csrc/vocab_gemm.cuh's tiling: the bf16 forward's, and the projection sampler's
GEMM_ROWS = 128  # rows of h a block owns (PB_ROWS); h is zero-padded to a multiple
GEMM_VOCAB_TILE = 128  # vocab ids a tile (PB_VT); a vocab split is a run of tiles


def can_fuse_ce(d: int, v: int) -> bool:
    """Shape gate, the TPU wrapper's: `d % 128 == 0`, a vocab of 512-wide
    blocks, and the d whose smallest TPU blocks fit its VMEM budget
    (d <= 2432 at every vocab)."""
    return d % 128 == 0 and d <= MAX_DIM and v % 512 == 0 and v >= 512


def _logits(h, weight, bias):
    logits = h.float() @ weight.float().t()
    return logits + bias.float() if bias is not None else logits


def _valid(labels, v):
    return (labels >= 0) & (labels < v)


def cross_entropy_plain(h, weight, bias, labels):
    """Plain version of the forward kernel: the (rows, V) f32 logits
    materialised. h (rows, d), weight (V, d), bias (V,) or None, labels
    (rows,) int. Returns (loss, lse), f32 (rows,)."""
    logits = _logits(h, weight, bias)
    lse = torch.logsumexp(logits, dim=-1)
    valid = _valid(labels, weight.shape[0])
    picked = logits.gather(-1, labels.long().clamp(0, weight.shape[0] - 1)[:, None])[:, 0]
    return lse - torch.where(valid, picked, 0.0), lse


def _dlogits(h, weight, bias, labels, lse, g):
    """(softmax - onehot) * g, recomputed from the saved lse, f32 (rows, V)."""
    dlog = (_logits(h, weight, bias) - lse.float()[:, None]).exp_()
    valid = _valid(labels, weight.shape[0])
    idx = labels.long().clamp(0, weight.shape[0] - 1)[:, None]
    dlog.scatter_add_(1, idx, -valid.float()[:, None])
    return dlog.mul_(g.float()[:, None])


def cross_entropy_bwd_dh_plain(h, weight, bias, labels, lse, g):
    """Plain version of the dh kernel: dh (rows, d) f32."""
    dlog = _dlogits(h, weight, bias, labels, lse, g)
    return dlog.to(h.dtype).float() @ weight.float()


def cross_entropy_bwd_dw_plain(h, weight, bias, labels, lse, g):
    """Plain version of the dW kernel: (dweight (V, d), dbias (V,)) f32."""
    dlog = _dlogits(h, weight, bias, labels, lse, g)
    return dlog.to(h.dtype).float().t() @ h.float(), dlog.sum(0)


def _operands(h, weight, bias, labels):
    """Validate; return (h (rows, d), weight in h's dtype, bias f32 or None,
    labels int32 (rows,)) as contiguous tensors."""
    if h.ndim < 2 or weight.ndim != 2 or weight.shape[1] != h.shape[-1]:
        raise ValueError(f"h (..., d) {tuple(h.shape)} and weight (V, d) {tuple(weight.shape)} disagree")
    if labels.shape != h.shape[:-1]:
        raise ValueError(f"labels {tuple(labels.shape)} must be h's leading shape {tuple(h.shape[:-1])}")
    v = weight.shape[0]
    if bias is not None:
        if bias.shape != (v,):
            raise ValueError(f"bias must be ({v},)")
        bias = _aligned(bias.float().contiguous())
    h2 = _aligned(h.reshape(-1, h.shape[-1]).contiguous())
    labels = _aligned(labels.reshape(-1).to(torch.int32).contiguous())
    return h2, _aligned(weight.to(h.dtype).contiguous()), bias, labels


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (the
    kernels stage rows, and the bf16 backward the per-row vectors, with
    16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_on_card = functools.partial(_build.on_card, "fused cross-entropy")


def _check_kernel_shape(h, weight):
    d, v = h.shape[1], weight.shape[0]
    if not can_fuse_ce(d, v):
        raise ValueError(f"fused cross-entropy kernels do not take d={d}, V={v}")
    if h.dtype not in _build.DTYPES:
        raise ValueError(f"fused cross-entropy kernels take {list(_build.DTYPES)}, not {h.dtype}")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(rows: int, v: int, device) -> int:
    """Vocab splits of the f32 forward and dh grids: about 8 blocks per SM in
    all, and at least one vocab tile a split."""
    tiles = v // VOCAB_TILE
    row_blocks = -(-rows // RESIDENT_ROWS)
    return max(1, min(tiles, -(-8 * _sm_count(device) // row_blocks)))


@functools.lru_cache(maxsize=None)
def wave_splits(rows: int, v: int, sms: int) -> int:
    """Vocab splits S of a csrc/vocab_gemm.cuh grid ((row tiles, S) blocks,
    one block an SM): the bf16 forward's and the projection sampler's. The S
    that takes the fewest tile-times, waves x (tiles a split + 1 for the
    pipeline's fill), ties to the smaller S: 14 at 1152 rows (126 blocks,
    one wave of 132 SMs), 11 at the flagship train's 4608 rows (396 blocks,
    3 waves)."""
    row_tiles, tiles = -(-rows // GEMM_ROWS), v // GEMM_VOCAB_TILE
    cost = lambda s: -(-row_tiles * s // sms) * (-(-tiles // s) + 1)  # noqa: E731
    return min(range(1, tiles + 1), key=lambda s: (cost(s), s))


def _row_padded(h, tile: int):
    """h (rows, d) with zero rows appended up to a multiple of `tile`."""
    pad = -h.shape[0] % tile
    return h if pad == 0 else torch.cat([h, h.new_zeros(pad, h.shape[1])])


def dh_splits(rows: int, v: int, sms: int) -> int:
    """Vocab splits of the bf16 dh grid (one block an SM, BWD_ROWS rows a
    block): among 2 to 8 blocks an SM, the count whose last wave is fullest,
    the fewest on a tie; at least one vocab tile a split. 11 at the flagship
    train shape (72 row blocks x 11 = 6 waves of 132 SMs)."""
    tiles = v // VOCAB_TILE
    row_blocks = -(-rows // BWD_ROWS)
    lo, hi = -(-2 * sms // row_blocks), -(-8 * sms // row_blocks)
    candidates = range(min(lo, tiles), min(hi, tiles) + 1)

    def waste(s):
        blocks = row_blocks * s
        return -(-blocks // sms) * sms - blocks

    return max(1, min(candidates, key=lambda s: (waste(s) / (row_blocks * s), s)))


def fused_ce_fwd(h, weight, bias, labels):
    """Forward kernel on prepared CUDA operands: (loss, lse), f32 (rows,).
    bf16 takes the wgmma kernel, h zero-padded to whole GEMM_ROWS tiles and
    `wave_splits` vocab splits; f32 the CUDA-core kernel."""
    _check_kernel_shape(h, weight)
    rows, d = h.shape
    v = weight.shape[0]
    if h.dtype == torch.bfloat16:
        splits = wave_splits(rows, v, _sm_count(h.device))
        h = _row_padded(h, GEMM_ROWS)
    else:
        splits = _splits(rows, v, h.device)
    f32 = dict(dtype=torch.float32, device=h.device)
    loss, lse, label_logit = (torch.empty(rows, **f32) for _ in range(3))
    partials = torch.empty((rows, splits, 2), **f32)
    p = _build.ptr
    err = _build.load_library().fused_ce_fwd(
        p(h), p(weight), p(bias), p(labels), p(loss), p(lse), p(label_logit), p(partials),
        rows, d, v, splits, _build.DTYPES[h.dtype], _build.stream(h.device))
    _build.check(err, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return loss, lse


def fused_ce_bwd_dh(h, weight, bias, labels, lse, g):
    """dh kernel on prepared CUDA operands; lse and g f32 (rows,). dh
    (rows, d) f32."""
    _check_kernel_shape(h, weight)
    rows, d = h.shape
    v = weight.shape[0]
    if h.dtype == torch.bfloat16:
        splits = dh_splits(rows, v, _sm_count(h.device))
    else:
        splits = _splits(rows, v, h.device)
    rows_pad = -(-rows // BWD_ROWS) * BWD_ROWS
    dh = torch.empty((rows, d), dtype=torch.float32, device=h.device)
    partials = torch.empty((splits, rows_pad, d), dtype=torch.float32, device=h.device)
    p = _build.ptr
    err = _build.load_library().fused_ce_bwd_dh(
        p(h), p(weight), p(bias), p(labels), p(lse), p(g), p(dh), p(partials), rows, d, v, splits,
        rows_pad, _build.DTYPES[h.dtype], _build.stream(h.device))
    _build.check(err, "fused_ce_bwd_dh")
    fused_ce_bwd_dh.launches += 1
    return dh


def fused_ce_bwd_dw(h, weight, bias, labels, lse, g):
    """dW kernel on prepared CUDA operands: (dweight (V, d), dbias (V,)) f32."""
    _check_kernel_shape(h, weight)
    rows, d = h.shape
    v = weight.shape[0]
    dw = torch.empty((v, d), dtype=torch.float32, device=h.device)
    db = torch.empty(v, dtype=torch.float32, device=h.device)
    p = _build.ptr
    err = _build.load_library().fused_ce_bwd_dw(
        p(h), p(weight), p(bias), p(labels), p(lse), p(g), p(dw), p(db), rows, d, v,
        _build.DTYPES[h.dtype], _build.stream(h.device))
    _build.check(err, "fused_ce_bwd_dw")
    fused_ce_bwd_dw.launches += 1
    return dw, db


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, bias, labels, whole):
        ctx.h_shape, ctx.h_dtype, ctx.w_dtype = h.shape, h.dtype, weight.dtype
        ctx.b_dtype = bias.dtype if bias is not None else None
        ctx.rows = None
        if whole is not None:  # rows of a head: the kernels read the whole one
            ctx.rows = (whole[2], weight.shape[0])
            weight, bias = whole[0], whole[1]
        ops = _operands(h, weight, bias, labels)
        if _on_card(*ops):
            loss, lse = fused_ce_fwd(*ops)
        else:
            loss, lse = cross_entropy_plain(*ops)
        ctx.save_for_backward(*ops, lse)
        return loss.view(h.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        h, weight, bias, labels, lse = ctx.saved_tensors
        g = _aligned(g.reshape(-1).float().contiguous())
        if _on_card(h, weight, bias, labels, lse, g):
            dh = fused_ce_bwd_dh(h, weight, bias, labels, lse, g)
            dw, db = fused_ce_bwd_dw(h, weight, bias, labels, lse, g)
        else:
            dh = cross_entropy_bwd_dh_plain(h, weight, bias, labels, lse, g)
            dw, db = cross_entropy_bwd_dw_plain(h, weight, bias, labels, lse, g)
        if ctx.rows is not None:  # copies: a view would keep the whole gradient alive
            dw = dw.narrow(0, *ctx.rows).clone()
            db = db.narrow(0, *ctx.rows).clone() if db is not None else None
        db = db.to(ctx.b_dtype) if ctx.b_dtype is not None else None
        return dh.to(ctx.h_dtype).view(ctx.h_shape), dw.to(ctx.w_dtype), db, None, None


def fused_vocab_cross_entropy(h, weight, bias, labels, whole=None):
    """Per-token softmax CE of `h @ weight^T + bias` against integer labels.

    h (..., d); weight (V, d), the nn.Linear layout; bias (V,) or None;
    labels h's leading shape, int. Returns f32 losses of the labels' shape.
    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels (or raises). Gradients reach h, weight and bias.

    `whole` = (whole weight, whole bias, offset) makes `weight` and `bias`
    rows [offset, offset + rows) of a head whose whole copy (in h's dtype,
    no gradient, `parallel.tp_inference.VocabShardedHead.gather`) the kernels
    read: the gradients of those rows are the rows of the whole head's."""
    return _FusedCE.apply(h, weight, bias, labels, whole)


fused_ce_fwd.launches = 0
fused_ce_bwd_dh.launches = 0
fused_ce_bwd_dw.launches = 0
