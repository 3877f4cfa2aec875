"""MaskGit, inference side (counterpart of phenaki_tpu/models/maskgit.py:
`rel_pos_bias`, `__call__`, `embeds_with_cond_scale`).

The token embedding has an extra row at index `num_tokens`, the mask id.
Classifier-free guidance stacks the conditioned and the null branch on the
batch (the null branch's text mask is all False) and combines them in
embedding space, which equals combining the logits because `to_logits` is
affine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.positional import ContinuousPositionBias

GRADIENT_SHRINK_ALPHA = 0.1


class MaskGit(nn.Module):
    def __init__(self, dim: int, num_tokens: int, max_seq_len: int, *, heads: int = 8,
                 dim_head: int = 64, depth: int = 6, dim_context: Optional[int] = None):
        super().__init__()
        self.num_tokens = num_tokens
        self.max_seq_len = max_seq_len
        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.continuous_pos_bias = ContinuousPositionBias(dim_head, heads, num_dims=3)
        self.transformer = Transformer(dim, depth, dim_context=dim_context, dim_head=dim_head,
                                       heads=heads, peg=True, has_cross_attn=True)
        self.to_logits = nn.Linear(dim, num_tokens)

    @property
    def mask_id(self) -> int:
        return self.num_tokens

    def rel_pos_bias(self, video_patch_shape: Tuple[int, int, int]) -> torch.Tensor:
        """(heads, n, n) 3-D continuous position bias for a patch grid."""
        return self.continuous_pos_bias(*video_patch_shape)

    def forward(self, x: torch.Tensor, *, video_patch_shape=None, text_mask=None,
                context=None, attn_bias=None, return_embeds: bool = False) -> torch.Tensor:
        """x: (b, n) or (b, t, h, w) token ids -> logits (or final-norm embeddings)."""
        if x.ndim == 4:
            video_patch_shape = tuple(x.shape[1:])
            x = x.reshape(x.shape[0], -1)
        if video_patch_shape is None:
            raise ValueError("video patch shape must be given")
        b, n = x.shape
        if n > self.max_seq_len:
            raise ValueError(f"sequence length {n} exceeds max_seq_len {self.max_seq_len}")
        rel_pos_bias = attn_bias if attn_bias is not None else self.rel_pos_bias(video_patch_shape)
        if context is not None and text_mask is None:
            text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)

        h = self.token_emb(x) + self.pos_emb(torch.arange(n, device=x.device))[None]
        # the training-time gradient shrink (alpha 0.1), kept as written: in
        # bf16 the two products round, so it is not the identity
        h = h * GRADIENT_SHRINK_ALPHA + h.detach() * (1 - GRADIENT_SHRINK_ALPHA)

        h = self.transformer(h, video_shape=(b, *video_patch_shape), attn_bias=rel_pos_bias,
                             context=context, cross_attn_context_mask=text_mask)
        return h if return_embeds else self.to_logits(h)

    def embeds_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None,
                               context=None, **kwargs) -> torch.Tensor:
        """CFG combined in embedding space: (b, n, dim) final-norm embeddings."""
        if cond_scale == 1 or context is None:
            return self(x, text_mask=text_mask, context=context, return_embeds=True, **kwargs)
        if text_mask is None:
            text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
        embeds2 = self(
            torch.cat([x, x]),
            text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)]),
            context=torch.cat([context, context]),
            return_embeds=True,
            **kwargs,
        )
        embeds, null_embeds = embeds2.chunk(2)
        return null_embeds + (embeds - null_embeds) * cond_scale
