"""QK-L2-norm cosine attention with null-KV, additive bias, key masks and
causal+ALiBi (counterpart of phenaki_tpu/ops/attention.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.ops.feedforward import linear
from phenaki_tpu_torch.ops.flash_attention import MAX_DIM_HEAD, MIN_FLASH_SEQ, flash_attention
from phenaki_tpu_torch.ops.norms import LayerNorm, l2norm_scaled
from phenaki_tpu_torch.ops.positional import alibi_bias
from phenaki_tpu_torch.parallel.ring_attention import sequence_sharded_attention

NEG_INF = -1e30
SCALE = 8.0  # the fixed cosine-attention temperature


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


def qk_norm_attention(q, k, v, *, scale: float = SCALE, attn_bias=None, key_mask=None,
                      causal: bool = False, use_alibi: bool = False,
                      dropout: float = 0.0, allow_flash: bool = True) -> torch.Tensor:
    """Attention core: q, k already l2-normalised and scaled per dim.
    q (b, h, i, d); k, v (b, h, j, d); attn_bias (h, i, j) or (b, h, i, j);
    key_mask (b, j) bool, True = attend; `dropout` is the active attention
    dropout rate (0 outside training). `allow_flash=False` keeps the plain
    path on every device: the kernels' backward is first-order only, so a
    result differentiated twice (the R1 penalty) must not reach them."""
    b, h, i, d = q.shape
    j = k.shape[2]
    if allow_flash and use_flash(q, attn_bias, dropout):
        bias = attn_bias
        if causal and use_alibi:
            ab = alibi_bias(h, i, j, device=q.device)
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
            sim = sim + alibi_bias(h, i, j, device=q.device)[None]
        q_pos = torch.arange(i, device=q.device)[:, None] + (j - i)
        k_pos = torch.arange(j, device=q.device)[None, :]
        sim = sim.masked_fill(k_pos > q_pos, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    if dropout > 0:
        attn = F.dropout(attn, dropout)
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


class Attention(nn.Module):
    """Self- or cross-attention block.

    Pre-LN (gamma only) on x, and on the context for cross-attention; no-bias
    projections, fused into one (dim -> 3*inner) product for self-attention;
    l2-normalised q/k with learned per-dim scales and the fixed SCALE;
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
    """

    def __init__(self, dim: int, *, dim_context: Optional[int] = None, dim_head: int = 64,
                 heads: int = 8, causal: bool = False, num_null_kv: int = 0, cross: bool = False,
                 reference_self_kv: bool = False, dropout: float = 0.0, seq_group=None,
                 use_flash: bool = True):
        super().__init__()
        self.dropout = dropout
        self.use_flash = use_flash
        self.seq_group = seq_group
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
        if context is not None:
            kv_input = self.context_norm(context)
        elif self.reference_self_kv:
            kv_input = x
        else:
            kv_input = None

        x = self.norm(x)
        if kv_input is None:
            qkv = F.linear(x, torch.cat([self.to_q.weight, self.to_kv.weight]).to(x.dtype))
            q, kv = qkv[..., :inner], qkv[..., inner:]
        else:
            q, kv = linear(x, self.to_q), linear(kv_input, self.to_kv)
        k, v = kv[..., :inner], kv[..., inner:]

        def split_heads(t):
            return t.reshape(batch, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = map(split_heads, (q, k, v))

        if self.null_kv is not None:
            nk, nv = self.null_kv.to(x.dtype).split(self.num_null_kv, dim=-2)
            k = torch.cat([nk.expand(batch, -1, -1, -1), k], dim=-2)
            v = torch.cat([nv.expand(batch, -1, -1, -1), v], dim=-2)

        q = l2norm_scaled(q, self.q_scale)
        k = l2norm_scaled(k, self.k_scale)

        if self.null_kv is not None:
            if attn_bias is not None:
                attn_bias = F.pad(attn_bias, (self.num_null_kv, 0))
            if mask is not None:
                mask = F.pad(mask, (self.num_null_kv, 0), value=True)

        dropout = self.dropout if self.training else 0.0
        if self._sequence_sharded(context, attn_bias, dropout, n):
            ring_bias = attn_bias
            if self.causal:
                ab = alibi_bias(self.heads, n, n, device=q.device)
                ring_bias = ab if ring_bias is None else ring_bias + ab
            out = sequence_sharded_attention(q, k, v, self.seq_group, scale=SCALE,
                                             attn_bias=ring_bias, key_mask=mask, causal=self.causal)
        else:
            out = qk_norm_attention(q, k, v, attn_bias=attn_bias, key_mask=mask,
                                    causal=self.causal, use_alibi=self.causal, dropout=dropout,
                                    allow_flash=self.use_flash)
        out = out.transpose(1, 2).reshape(batch, n, inner)
        return linear(out, self.to_out)
