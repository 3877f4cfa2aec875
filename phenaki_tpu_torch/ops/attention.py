"""QK-L2-norm cosine attention with null-KV, additive bias, key masks and
causal+ALiBi (counterpart of phenaki_tpu/ops/attention.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.feedforward import linear
from phenaki_tpu_torch.ops.flash_attention import MAX_DIM_HEAD, MIN_FLASH_SEQ, flash_attention
from phenaki_tpu_torch.ops import norms
from phenaki_tpu_torch.ops.norms import LayerNorm, l2norm_scaled
from phenaki_tpu_torch.ops.positional import alibi_bias
from phenaki_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group
from phenaki_tpu_torch.parallel.ring_attention import sequence_sharded_attention

NEG_INF = -1e30
SCALE = 8.0  # the fixed cosine-attention temperature
# the widest head row qk_norm_split_kernel takes, in bytes: one warp of 16-byte vectors
QK_MAX_HEAD_BYTES = 32 * 16


def flash_applies(q_shape, attn_bias: Optional[torch.Tensor]) -> bool:
    """Shape gate of the TPU package's `_use_flash`: i >= 64, d <= 128 and a
    3-D or absent bias."""
    if attn_bias is not None and attn_bias.ndim == 4:
        return False
    return q_shape[-1] <= MAX_DIM_HEAD and q_shape[-2] >= MIN_FLASH_SEQ


def use_flash(q: torch.Tensor, attn_bias: Optional[torch.Tensor], dropout: float = 0.0) -> bool:
    """The kernel runs for a CUDA tensor that passes `flash_applies`, unless
    attention dropout is active (the kernel has none, as on the TPU)."""
    return q.is_cuda and dropout == 0.0 and flash_applies(q.shape, attn_bias)


def _alibi(heads, i: int, j: int, device) -> torch.Tensor:
    """ALiBi for `heads` = h, or (total, first, h): heads [first, first + h)
    of `total`, as a tensor-parallel rank holds them."""
    total, first, h = heads if isinstance(heads, tuple) else (heads, 0, heads)
    return alibi_bias(total, i, j, device=device)[first:first + h]


def qk_norm_attention(q, k, v, *, scale: float = SCALE, attn_bias=None, key_mask=None,
                      causal: bool = False, use_alibi: bool = False,
                      dropout: float = 0.0, allow_flash: bool = True,
                      alibi_heads=None) -> torch.Tensor:
    """Attention core: q, k already l2-normalised and scaled per dim.
    q (b, h, i, d); k, v (b, h, j, d); attn_bias (h, i, j) or (b, h, i, j);
    key_mask (b, j) bool, True = attend; `dropout` is the active attention
    dropout rate (0 outside training). `allow_flash=False` keeps the plain
    path on every device: the kernels' backward is first-order only, so a
    result differentiated twice (the R1 penalty) must not reach them.
    `alibi_heads` (total, first, h) takes the ALiBi slopes of heads
    [first, first + h) of `total` (a tensor-parallel rank's)."""
    b, h, i, d = q.shape
    j = k.shape[2]
    alibi_heads = alibi_heads or h
    if allow_flash and use_flash(q, attn_bias, dropout):
        bias = attn_bias
        if causal and use_alibi:
            ab = _alibi(alibi_heads, i, j, q.device)
            bias = ab if bias is None else bias + ab
        kmask = None
        if key_mask is not None:
            kmask = torch.where(key_mask, 0.0, NEG_INF).float()
        return flash_attention(q, k, v, bias, kmask, scale=float(scale), causal=causal)

    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if attn_bias is not None:
        if attn_bias.ndim == 3:
            attn_bias = attn_bias[None]
        sim = sim + attn_bias.float()
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        if use_alibi:
            sim = sim + _alibi(alibi_heads, i, j, q.device)[None]
        q_pos = torch.arange(i, device=q.device)[:, None] + (j - i)
        k_pos = torch.arange(j, device=q.device)[None, :]
        sim = sim.masked_fill(k_pos > q_pos, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    if dropout > 0:
        attn = F.dropout(attn, dropout)
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


def qk_norm_split_plain(q, k, v, heads: int, q_scale, k_scale, null_kv=None):
    """Plain version of `qk_norm_split`: the heads split off as transposed
    views, the null key/values concatenated, then `l2norm_scaled`."""
    batch, d = q.shape[0], q.shape[-1] // heads

    def split_heads(t):
        return t.reshape(batch, t.shape[1], heads, d).transpose(1, 2)

    q, k, v = map(split_heads, (q, k, v))
    if null_kv is not None:
        nk, nv = null_kv.split(null_kv.shape[1] // 2, dim=-2)
        k = torch.cat([nk.expand(batch, -1, -1, -1), k], dim=-2)
        v = torch.cat([nv.expand(batch, -1, -1, -1), v], dim=-2)
    return l2norm_scaled(q, q_scale), l2norm_scaled(k, k_scale), v


def qk_norm_split(q, k, v, heads: int, q_scale, k_scale, null_kv=None):
    """The attention's head split with its q/k normalisation: q (b, n, h*d),
    k and v (b, m, h*d) as the projections give them (column slices of one
    product need no copy), q_scale and k_scale (d,), null_kv (h, 2*num_null,
    d) or None. Returns q (b, h, n, d) and k, v (b, h, num_null + m, d), the
    null keys and values first (`Attention.forward` pads the mask and bias to
    match): q and k l2-normalised over d (f32 sums, eps 1e-12) and times their
    scale (rounded to q's dtype); v as it is.

    A CPU tensor takes the plain version (transposed views, two roundings:
    after the l2norm and after the scale). A CUDA tensor launches
    csrc/norms.cu's `qk_norm_split_kernel`, under autograd with the plain
    version's derivative (`_QkNormSplit`), or raises: d must be whole 16-byte
    vectors, at most QK_MAX_HEAD_BYTES. One pass, one rounding (so within one
    ulp of the plain version), and q, k, v contiguous, as flash attention
    reads them without a copy."""
    if not norms._on_card(q, k, v, q_scale, k_scale, null_kv):
        return qk_norm_split_plain(q, k, v, heads, q_scale, k_scale, null_kv)
    if norms.records(q, k, v, q_scale, k_scale, null_kv):
        return _QkNormSplit.apply(q, k, v, heads, q_scale, k_scale, null_kv)
    return _qk_norm_split_kernel(q, k, v, heads, q_scale, k_scale, null_kv)


def _l2norm_scaled_backward(t, scale, dy):
    """d/dt and d/dscale of `l2norm_scaled(t, scale)` for t (b, h, s, d),
    given dy: in f32 with the forward's rsqrt(max(sum t^2, 1e-24)) (no
    gradient through the clamp, as `clamp_min`'s), the scale rounded to t's
    dtype as the forward multiplies by it."""
    t32 = t.float()
    ss = (t32 * t32).sum(-1, keepdim=True)
    r = torch.rsqrt(ss.clamp_min(1e-24))
    du = dy.float() * scale.to(t.dtype).float()
    dscale = (dy.float() * (t32 * r).to(t.dtype).float()).sum((0, 1, 2)).to(scale.dtype)
    dt = r * du - t32 * (r * r * r * (ss >= 1e-24) * (du * t32).sum(-1, keepdim=True))
    return dt.to(t.dtype), dscale


class _QkNormSplit(torch.autograd.Function):
    """`qk_norm_split_kernel`'s forward with the plain version's derivative:
    q's and k's l2norm backward (`_l2norm_scaled_backward`), v's gradient as
    it comes, each moved back to the projection's (b, n, h*d) layout, and the
    null key/values' summed over the batch. Differentiable again, as the R1
    penalty's second derivative needs."""

    @staticmethod
    def forward(ctx, q, k, v, heads, q_scale, k_scale, null_kv):
        ctx.heads = heads
        ctx.save_for_backward(q, k, q_scale, k_scale, null_kv)
        return _qk_norm_split_kernel(q, k, v, heads, q_scale, k_scale, null_kv)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        q, k, q_scale, k_scale, null_kv = ctx.saved_tensors
        b, n, inner = q.shape
        qh, kh = (t.reshape(b, t.shape[1], ctx.heads, -1).transpose(1, 2) for t in (q, k))
        num_null = 0
        if null_kv is not None:
            num_null = null_kv.shape[1] // 2
            kh = torch.cat([null_kv[:, :num_null].expand(b, -1, -1, -1), kh], dim=-2)
        dq, dq_scale = _l2norm_scaled_backward(qh, q_scale, dq)
        dk, dk_scale = _l2norm_scaled_backward(kh, k_scale, dk)
        dnull = None
        if null_kv is not None:
            dnull = torch.cat([dk[:, :, :num_null].sum(0), dv[:, :, :num_null].sum(0)], dim=1)
            dk, dv = dk[:, :, num_null:], dv[:, :, num_null:]

        def merge(t):
            return t.transpose(1, 2).reshape(b, t.shape[2], inner)

        return merge(dq), merge(dk), merge(dv), None, dq_scale, dk_scale, dnull


def _qk_norm_split_kernel(q, k, v, heads, q_scale, k_scale, null_kv):
    b, n, inner = q.shape
    d = inner // heads
    m = k.shape[1]
    num_null = null_kv.shape[1] // 2 if null_kv is not None else 0
    if (inner != heads * d or k.ndim != 3 or k.shape != (b, m, inner) or v.shape != k.shape
            or (null_kv is not None and (null_kv.shape != (heads, 2 * num_null, d) or null_kv.dtype != q.dtype))
            or k.dtype != q.dtype or v.dtype != q.dtype or q_scale.shape != (d,) or k_scale.shape != (d,)):
        raise ValueError(f"q/k norm kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"({q.dtype}, {k.dtype}, {v.dtype}), {heads} heads, null_kv "
                         f"{None if null_kv is None else (tuple(null_kv.shape), null_kv.dtype)} and scales "
                         f"{tuple(q_scale.shape)}, {tuple(k_scale.shape)} disagree")
    norms.check_dtypes("q/k norm kernel", q, q_scale, k_scale)
    if not norms.takes(q, d, QK_MAX_HEAD_BYTES):
        raise ValueError(f"q/k norm kernel takes head rows of whole 16-byte vectors up to {QK_MAX_HEAD_BYTES} "
                         f"bytes, not {d} values of {q.dtype}")
    q_out = q.new_empty((b, heads, n, d))
    k_out = q.new_empty((b, heads, num_null + m, d))
    v_out = torch.empty_like(k_out)
    if q.numel() == 0 or k_out.numel() == 0:
        return q_out, k_out, v_out
    q, k, v = norms.rows16(q), norms.rows16(k), norms.rows16(v)
    q_scale, k_scale = q_scale.contiguous(), k_scale.contiguous()
    nk = nv = None
    ns = (0, 0)
    if null_kv is not None:
        null_kv = norms.rows16(null_kv)
        nk, nv = null_kv[:, :num_null], null_kv[:, num_null:]
        ns = null_kv.stride()[:2]
    p = _build.ptr
    err = _build.load_library().qk_norm_split(
        p(q), p(k), p(v), p(nk), p(nv), p(q_scale), p(k_scale), p(q_out), p(k_out), p(v_out),
        b, n, m, num_null, heads, d, *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *ns,
        norms.DTYPES[q.dtype], norms.DTYPES[q_scale.dtype], _build.stream(q.device))
    _build.check(err, "qk_norm_split")
    qk_norm_split.launches += 1
    return q_out, k_out, v_out


qk_norm_split.launches = 0


class Attention(nn.Module):
    """Self- or cross-attention block.

    Pre-LN (gamma only) on x, and on the context for cross-attention; no-bias
    projections, fused into one (dim -> 3*inner) product for self-attention;
    l2-normalised q/k with learned per-dim scales and the fixed SCALE (the
    head split, the q/k normalisation and the null key/values in one pass on a
    card: `qk_norm_split`);
    optional learned null key/values prepended to the keys; causal masking
    with ALiBi. `reference_self_kv` takes self-attention K/V from the
    pre-norm input (the reference checkpoints' quirk). Weights are cast to
    the activations' dtype at use; `dropout` acts on the attention
    probabilities in training mode.

    `seq_group` (a `torch.distributed` process group) makes self-attention
    sequence-parallel: where the sequence divides by the group's size, it
    runs as ring attention over the group
    (`parallel.ring_attention.sequence_sharded_attention`), on every rank of
    the group with the same inputs. Cross-attention, null key/values, active
    attention dropout, a group of one and an indivisible sequence take the
    dense path, as in the JAX package (`seq_shard_mesh`).

    `use_flash=False` never reaches `flash_attention`, on any device: for a
    module differentiated to second order (the discriminator under the R1
    penalty).

    `tp_group` (set by `parallel.tp_inference.tp_local_module`, which gives
    the block `heads` of `total_heads` heads from `head_offset` on) makes it
    tensor-parallel, Megatron's way: the normed input enters the
    column-parallel q/kv products through `copy_to_group` (identity forward,
    all-reduce backward), as do the q/k scales, which every head shares;
    `to_out`'s partial product is completed by one all-reduce
    (`reduce_from_group`), JAX's `psum`. ALiBi takes the rank's heads'
    slopes.
    """

    def __init__(self, dim: int, *, dim_context: Optional[int] = None, dim_head: int = 64,
                 heads: int = 8, causal: bool = False, num_null_kv: int = 0, cross: bool = False,
                 reference_self_kv: bool = False, dropout: float = 0.0, seq_group=None,
                 use_flash: bool = True, tp_group=None):
        super().__init__()
        self.dropout = dropout
        self.use_flash = use_flash
        self.seq_group = seq_group
        self.tp_group = tp_group
        self.total_heads, self.head_offset = heads, 0
        inner = dim_head * heads
        kv_dim = (dim_context or dim) if cross else dim
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.num_null_kv = num_null_kv
        self.reference_self_kv = reference_self_kv
        self.norm = LayerNorm(dim)
        self.context_norm = LayerNorm(kv_dim) if cross else None
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(kv_dim, inner * 2, bias=False)  # [k | v] columns
        self.null_kv = (
            nn.Parameter(torch.empty(heads, 2 * num_null_kv, dim_head)) if num_null_kv > 0 else None
        )
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Linear(inner, dim, bias=False)

    def _sequence_sharded(self, context, attn_bias, dropout: float, n: int) -> bool:
        """The ring route's gate (the JAX package's, `attention.py:264-273`)."""
        if self.seq_group is None or context is not None or self.null_kv is not None:
            return False
        if dropout > 0 or (attn_bias is not None and attn_bias.ndim != 3):
            return False
        sp = dist.get_world_size(self.seq_group)
        return sp > 1 and n % sp == 0

    def forward(self, x, mask=None, context=None, attn_bias=None) -> torch.Tensor:
        """x (b, n, dim); mask (b, j) bool key mask; context (b, m, dim_context);
        attn_bias (h, i, j) additive."""
        batch, n, _ = x.shape
        inner = self.heads * self.dim_head
        tp = self.tp_group
        if context is not None:
            kv_input = copy_to_group(self.context_norm(context), tp)
        elif self.reference_self_kv:
            kv_input = copy_to_group(x, tp)
        else:
            kv_input = None

        x = copy_to_group(self.norm(x), tp)
        if kv_input is None:
            qkv = F.linear(x, torch.cat([self.to_q.weight, self.to_kv.weight]).to(x.dtype))
            q, kv = qkv[..., :inner], qkv[..., inner:]
        else:
            q, kv = linear(x, self.to_q), linear(kv_input, self.to_kv)
        k, v = kv[..., :inner], kv[..., inner:]
        null_kv = self.null_kv.to(x.dtype) if self.null_kv is not None else None
        q, k, v = qk_norm_split(q, k, v, self.heads, copy_to_group(self.q_scale, tp),
                                copy_to_group(self.k_scale, tp), null_kv)

        if self.null_kv is not None:
            if attn_bias is not None:
                attn_bias = F.pad(attn_bias, (self.num_null_kv, 0))
            if mask is not None:
                mask = F.pad(mask, (self.num_null_kv, 0), value=True)

        dropout = self.dropout if self.training else 0.0
        if self._sequence_sharded(context, attn_bias, dropout, n):
            ring_bias = attn_bias
            if self.causal:
                ab = _alibi(self.heads, n, n, q.device)
                ring_bias = ab if ring_bias is None else ring_bias + ab
            out = sequence_sharded_attention(q, k, v, self.seq_group, scale=SCALE,
                                             attn_bias=ring_bias, key_mask=mask, causal=self.causal)
        else:
            out = qk_norm_attention(q, k, v, attn_bias=attn_bias, key_mask=mask,
                                    causal=self.causal, use_alibi=self.causal, dropout=dropout,
                                    allow_flash=self.use_flash,
                                    alibi_heads=(self.total_heads, self.head_offset, self.heads))
        out = out.transpose(1, 2).reshape(batch, n, inner)
        return reduce_from_group(linear(out, self.to_out), tp)
