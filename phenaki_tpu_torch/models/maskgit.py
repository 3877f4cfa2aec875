"""MaskGit (counterpart of phenaki_tpu/models/maskgit.py: `rel_pos_bias`,
`__call__`, `embeds_with_cond_scale`).

The token embedding has an extra row at index `num_tokens`, the mask id.
Classifier-free guidance stacks the conditioned and the null branch on the
batch (the null branch's text mask is all False) and combines them in
embedding space, which equals combining the logits because `to_logits` is
affine.

`dtype` is the compute dtype, as flax's module `dtype`: the embeddings and
the text context are cast to it, and every layer computes in its input's
dtype (weights cast at use), so f32 parameters can train in bf16. None
computes in the parameters' dtype. Training adds a video (key) mask,
conditioning dropout drawn from an explicit generator, and attention and
FF dropout in training mode; `unconditional` builds no cross-attention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.feedforward import linear
from phenaki_tpu_torch.ops.positional import ContinuousPositionBias
from phenaki_tpu_torch.ops.sampling import prob_mask_like

GRADIENT_SHRINK_ALPHA = 0.1


class MaskGit(nn.Module):
    def __init__(self, dim: int, num_tokens: int, max_seq_len: int, *, heads: int = 8,
                 dim_head: int = 64, depth: int = 6, dim_context: Optional[int] = None,
                 unconditional: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_tokens = num_tokens
        self.max_seq_len = max_seq_len
        self.unconditional = unconditional
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.continuous_pos_bias = ContinuousPositionBias(dim_head, heads, num_dims=3)
        self.transformer = Transformer(dim, depth, dim_context=dim_context, dim_head=dim_head,
                                       heads=heads, peg=True, has_cross_attn=not unconditional,
                                       attn_dropout=attn_dropout, ff_dropout=ff_dropout)
        self.to_logits = nn.Linear(dim, num_tokens)

    @property
    def mask_id(self) -> int:
        return self.num_tokens

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.to_logits.weight.dtype

    def rel_pos_bias(self, video_patch_shape: Tuple[int, int, int]) -> torch.Tensor:
        """(heads, n, n) 3-D continuous position bias for a patch grid."""
        return self.continuous_pos_bias(*video_patch_shape)

    def forward(self, x: torch.Tensor, *, video_patch_shape=None, cond_drop_prob: float = 0.0,
                text_mask=None, video_mask=None, context=None, attn_bias=None,
                return_embeds: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (b, n) or (b, t, h, w) token ids -> logits (or final-norm
        embeddings). video_mask (b, n) bool masks the self-attention keys;
        `cond_drop_prob` drops whole text conditions with draws from
        `generator`."""
        if x.ndim == 4:
            video_patch_shape = tuple(x.shape[1:])
            x = x.reshape(x.shape[0], -1)
        if video_patch_shape is None:
            raise ValueError("video patch shape must be given")
        b, n = x.shape
        if n > self.max_seq_len:
            raise ValueError(f"sequence length {n} exceeds max_seq_len {self.max_seq_len}")
        rel_pos_bias = attn_bias if attn_bias is not None else self.rel_pos_bias(video_patch_shape)
        if self.unconditional:
            context = text_mask = None
        if context is not None:
            context = context.to(self.compute_dtype)
            if text_mask is None:
                text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
            if cond_drop_prob > 0:
                # whole-sample conditioning dropout for CFG
                keep = prob_mask_like((b,), 1.0 - cond_drop_prob, generator, device=x.device)
                text_mask = text_mask & keep[:, None]

        dtype = self.compute_dtype
        h = self.token_emb(x).to(dtype) + self.pos_emb(torch.arange(n, device=x.device)).to(dtype)
        # the training-time gradient shrink (alpha 0.1), kept as written: in
        # bf16 the two products round, so it is not the identity
        h = h * GRADIENT_SHRINK_ALPHA + h.detach() * (1 - GRADIENT_SHRINK_ALPHA)

        h = self.transformer(h, video_shape=(b, *video_patch_shape), attn_bias=rel_pos_bias,
                             context=context, self_attn_mask=video_mask,
                             cross_attn_context_mask=text_mask)
        return h if return_embeds else linear(h, self.to_logits)

    def embeds_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None,
                               context=None, **kwargs) -> torch.Tensor:
        """CFG combined in embedding space: (b, n, dim) final-norm embeddings."""
        if cond_scale == 1 or self.unconditional or context is None:
            return self(x, text_mask=text_mask, context=context, return_embeds=True, **kwargs)
        if text_mask is None:
            text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
        video_mask = kwargs.pop("video_mask", None)
        if video_mask is not None:
            kwargs["video_mask"] = torch.cat([video_mask, video_mask])
        embeds2 = self(
            torch.cat([x, x]),
            text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)]),
            context=torch.cat([context, context]),
            return_embeds=True,
            **kwargs,
        )
        embeds, null_embeds = embeds2.chunk(2)
        return null_embeds + (embeds - null_embeds) * cond_scale
