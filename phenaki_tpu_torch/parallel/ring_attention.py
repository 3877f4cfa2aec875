"""Ring attention: sequence-sharded QK-norm attention over a process group
(counterpart of phenaki_tpu/parallel/ring_attention.py).

Each of the group's `sp` ranks holds `n / sp` query rows and one K/V shard;
the shards rotate around the ring (rank r sends to r + 1 and receives from
r - 1, `sp - 1` rotations), and each rank attends its rows to every shard in
turn, so the (n, n) score matrix never exists anywhere. Two rings, as in the
JAX package:

* `ring_flash_qk_attention` runs each rotation through kernel 3
  (`ops.flash_attention.flash_attend_chunk`). Cosine attention's scores are
  bounded, so one `all_reduce(MAX)` of the per-shard Cauchy-Schwarz bounds
  gives every rank the same softmax shift c2; each chunk's unnormalised
  (sum p v, sum p) then simply adds, with no running max between chunks.
* `ring_qk_norm_attention` is the plain online-softmax ring (running max and
  sum per row), for shards too small for the kernel and for CPU tensors.

The transport follows the group's backend (`dist.get_backend`): NCCL moves
device tensors; any other backend (gloo) moves host copies, which are copied
back to the tensor's device. So several ranks may share one GPU over gloo,
at the price of staging every rotation through host memory. Each rotation
and gather is an autograd Function whose backward is the transposed
communication: the backward of a rotation sends the gradient the other way
round the ring, as JAX's `ppermute` transposes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from phenaki_tpu_torch.ops.flash_attention import (
    LOG2E,
    MAX_DIM_HEAD,
    MIN_FLASH_SEQ,
    flash_attend_chunk,
)

NEG_INF = -1e30


def _host_transport(group) -> bool:
    """True when the group's backend moves host tensors (anything but NCCL)."""
    return dist.get_backend(group) != dist.Backend.NCCL


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor as the backend sends it: itself on NCCL; a contiguous host
    copy, viewed as bytes (gloo moves any dtype that way), otherwise."""
    x = x.detach().contiguous()
    if not _host_transport(group):
        return x
    return x.cpu().reshape(-1).view(torch.uint8)


def _from_wire(wire: torch.Tensor, like: torch.Tensor, group) -> torch.Tensor:
    if not _host_transport(group):
        return wire
    return wire.view(like.dtype).reshape(like.shape).to(like.device)


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to rank + shift and receive from rank - shift (group ranks)."""
    sp, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % sp)
    src = dist.get_global_rank(group, (me - shift) % sp)
    send = _to_wire(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(recv, x, group)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in rank order."""
    send = _to_wire(x, group)
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat([_from_wire(p, x.contiguous(), group) for p in parts], dim)


def _all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise max of an f32 tensor over the group."""
    host = _host_transport(group)
    buf = x.detach().float().contiguous()
    buf = buf.cpu() if host else buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(x.device)


class _Rotate(torch.autograd.Function):
    """One step of the ring: receive the shard of rank - 1; the gradient
    goes back to it (rank + 1's gradient arrives here)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1), None


class _ShardSeq(torch.autograd.Function):
    """This rank's rows of a replicated tensor along `dim`; the backward
    all-gathers the rows' gradients, so every rank gets the full gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        sp, me = dist.get_world_size(group), dist.get_rank(group)
        rows = x.shape[dim] // sp
        ctx.group, ctx.dim = group, dim
        return x.narrow(dim, me * rows, rows).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's rows along `dim`, gathered; the backward keeps this
    rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.rows = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.rows, ctx.rows).contiguous(), None, None


def _key_block(t: Optional[torch.Tensor], k_off: int, nk: int) -> Optional[torch.Tensor]:
    return t[..., k_off:k_off + nk] if t is not None else None


def ring_qk_norm_attention(q, k, v, group, *, scale: float = 8.0,
                           attn_bias: Optional[torch.Tensor] = None,
                           key_mask_add: Optional[torch.Tensor] = None, causal: bool = False,
                           null_k: Optional[torch.Tensor] = None,
                           null_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain online-softmax ring on this rank's shards: q (b, h, nq, d),
    k/v (b, h, nk, d); `attn_bias` (h, nq, N) the local rows' bias over the
    global keys; `key_mask_add` (b, N) additive f32 (0 or NEG_INF); null
    keys/values (b, h, nkv, d) replicated. Returns (b, h, nq, d)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    sp, my = dist.get_world_size(group), dist.get_rank(group)

    def attend(m, l, acc, s, vv):
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhij,bhjd->bhid", p.to(vv.dtype).float(), vv.float())
        return m_new, l, acc

    m = torch.full((b, h, nq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, nq, 1), device=q.device)
    acc = torch.zeros((b, h, nq, d), device=q.device)
    kv = torch.stack([k, v])
    for step in range(sp):
        # after `step` rotations this rank holds the shard of rank my - step
        k_off = (my - step) % sp * nk
        s = torch.einsum("bhid,bhjd->bhij", q.float(), kv[0].float()) * scale
        if attn_bias is not None:
            s = s + _key_block(attn_bias, k_off, nk).float()[None]
        if key_mask_add is not None:
            s = s + _key_block(key_mask_add, k_off, nk).float()[:, None, None, :]
        if causal:
            row = torch.arange(nq, device=q.device)[:, None] + my * nq
            col = torch.arange(nk, device=q.device)[None, :] + k_off
            s = s.masked_fill(col > row, NEG_INF)
        m, l, acc = attend(m, l, acc, s, kv[1])
        if step < sp - 1:  # no rotation after the last block: nobody reads it
            kv = _Rotate.apply(kv, group)
    if null_k is not None:
        s = torch.einsum("bhid,bhjd->bhij", q.float(), null_k.float()) * scale
        m, l, acc = attend(m, l, acc, s, null_v)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_flash_qk_attention(q, k, v, group, *, scale: float = 8.0,
                            attn_bias: Optional[torch.Tensor] = None,
                            key_mask_add: Optional[torch.Tensor] = None, causal: bool = False,
                            null_k: Optional[torch.Tensor] = None,
                            null_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel-3 ring, with the arguments of `ring_qk_norm_attention`.

    One `all_reduce(MAX)` of max ||scale q|| and max ||k|| over the shards
    gives the shared bound c2 = max||scale q|| max||k|| log2(e) (computed
    without gradient: the normalised output does not depend on it, so its
    cotangent is 0, as JAX's stop_gradient makes it). Then `sp` chunk calls
    with their global (q_off, k_off) and `sp - 1` rotations; the chunks'
    (acc, l) add, and out = acc / max(l, 1e-37). The bias is cast to q's
    dtype once, and each chunk reads its column slice in place. A null K/V
    block (replicated) is folded in with the same shift, outside the kernel,
    as in the JAX package."""
    nq, nk = q.shape[2], k.shape[2]
    sp, my = dist.get_world_size(group), dist.get_rank(group)
    with torch.no_grad():
        norms = torch.stack([(q.float() * scale).norm(dim=-1).max(), k.float().norm(dim=-1).max()])
        norms = _all_reduce_max(norms, group)
        c2 = norms[0] * norms[1] * LOG2E
    bias_rows = attn_bias.to(q.dtype) if attn_bias is not None else None
    acc = l = None
    kv = torch.stack([k, v])
    for step in range(sp):
        k_off = (my - step) % sp * nk
        a, s = flash_attend_chunk(q, kv[0], kv[1], _key_block(bias_rows, k_off, nk),
                                  _key_block(key_mask_add, k_off, nk), c2=c2, scale=scale,
                                  causal=causal, offsets=(my * nq, k_off) if causal else None)
        acc, l = (a, s) if acc is None else (acc + a, l + s)
        if step < sp - 1:
            kv = _Rotate.apply(kv, group)
    if null_k is not None:
        s = torch.einsum("bhid,bhjd->bhij", q.float(), null_k.float()) * scale
        p = torch.exp2(s * LOG2E - c2)
        acc = acc + torch.einsum("bhij,bhjd->bhid", p.to(null_v.dtype).float(), null_v.float())
        l = l + p.sum(-1)
    return (acc / l.clamp_min(1e-37)[..., None]).to(q.dtype)


def _ring_use_flash(local_rows: int, dim_head: int, device: torch.device) -> bool:
    """The kernel ring for a CUDA tensor whose shards pass the dense path's
    flash gate (dim_head <= 128, local rows >= 64); the plain ring otherwise.
    The TPU package's cap on the ring length (FLASH_RING_MAX_SP) bounded a
    static unroll of Pallas calls and has no counterpart here."""
    return device.type == "cuda" and dim_head <= MAX_DIM_HEAD and local_rows >= MIN_FLASH_SEQ


def sequence_sharded_attention(q, k, v, group, *, scale: float = 8.0,
                               attn_bias: Optional[torch.Tensor] = None,
                               key_mask: Optional[torch.Tensor] = None, causal: bool = False,
                               null_k: Optional[torch.Tensor] = None,
                               null_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over `group`.

    q, k, v (b, h, N, d) and `attn_bias` (h, N, N) are the global tensors,
    replicated on every rank, as the JAX entry takes global arrays under
    `shard_map`; `key_mask` (b, N) bool, True = attend; null keys/values
    (b, h, nkv, d) replicated. Each rank takes its N / sp rows of q, k, v and
    the bias, runs the ring, and all-gathers the outputs, so every rank
    returns the full (b, h, N, d) output. In the backward the gather keeps
    this rank's rows and the shard all-gathers the row gradients, so every
    rank ends with the dense model's full parameter gradients and needs no
    gradient all-reduce. Activations outside self-attention stay replicated
    on every rank: this is the math contract of the JAX path, not a memory
    plan. N must divide by the group size (the Attention gate decides that
    before calling)."""
    sp = dist.get_world_size(group)
    n = q.shape[2]
    if n % sp:
        raise ValueError(f"sequence length {n} does not divide by the group size {sp}")
    key_mask_add = None
    if key_mask is not None:
        key_mask_add = torch.where(key_mask, 0.0, NEG_INF).float()
    ring = (ring_flash_qk_attention if _ring_use_flash(n // sp, q.shape[-1], q.device)
            else ring_qk_norm_attention)
    q, k, v = (_ShardSeq.apply(t, group, 2) for t in (q, k, v))
    if attn_bias is not None:
        attn_bias = _ShardSeq.apply(attn_bias, group, 1)
    out = ring(q, k, v, group, scale=scale, attn_bias=attn_bias, key_mask_add=key_mask_add,
               causal=causal, null_k=null_k, null_v=null_v)
    return _GatherSeq.apply(out, group, 2)
