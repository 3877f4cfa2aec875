"""MaskGit, TokenCritic and SelfCritic (counterpart of
phenaki_tpu/models/maskgit.py).

The token embedding has an extra row at index `num_tokens`, the mask id.
Classifier-free guidance stacks the conditioned and the null branch on the
batch (the null branch's text mask is all False) and runs one forward at
2b. `embeds_with_cond_scale` combines them in embedding space, which equals
combining the logits because `to_logits` is affine (the fused projection
sampler's path); `forward_with_cond_scale` combines the logits, or returns
them stacked (`combine=False`, conditioned rows first) for the logits-path
sampler, which fuses the combine.

TokenCritic is the same trunk without the gradient shrink and the position
bias, cross-attention only with `has_cross_attn`, and a scalar per-token
logit head. SelfCritic runs a MaskGit's trunk to its final embeddings and
adds a scalar head `to_pred`; it holds the MaskGit it shares, so its own
parameters are the head's.

`dtype` is the compute dtype, as flax's module `dtype`: the embeddings and
the text context are cast to it, and every layer computes in its input's
dtype (weights cast at use), so f32 parameters can train in bf16. None
computes in the parameters' dtype. `seq_group` (a process group) runs the
MaskGit's self-attention as ring attention over the group's ranks, each of
which runs the same forward (the JAX package's `seq_shard_mesh`); a
SelfCritic shares that trunk, and the TokenCritic has no such option, as in
the JAX package. Training adds a video (key) mask,
conditioning dropout drawn from an explicit generator, and attention and
FF dropout in training mode; `unconditional` builds no cross-attention.
`reference_attention_kv` (MaskGit and TokenCritic) takes the self-attention's
K/V from the pre-norm input, as weights trained with the reference
phenaki-pytorch expect (`convert.py`); the parameters do not change.
`pipeline_mesh` (a mesh with a 'pp' axis; JAX `maskgit.py:158-180,359-375`)
runs the trunk on GPipe's schedule (`parallel.pipeline`) in
`pipeline_microbatches` microbatches: the module is then a rank's
stage-local clone (`pipeline_stage_module`), and its dropout streams are
seeded from `generator`. A SelfCritic rides on the MaskGit's trunk.
`remat` recomputes the trunk's attention and FF blocks in the backward
(`models.transformer`); `gradient_shrink_alpha` and `ff_inner_dim` are the
TPU package's fields of the same names.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.feedforward import linear
from phenaki_tpu_torch.ops.positional import ContinuousPositionBias
from phenaki_tpu_torch.ops.sampling import prob_mask_like
from phenaki_tpu_torch.parallel.pipeline import pipeline_transformer_apply


def _with_cond_scale(forward: Callable[..., torch.Tensor], x, *, cond_scale: float, text_mask,
                     context, combine: bool = True, **kwargs) -> torch.Tensor:
    """CFG as one forward at 2b: the conditioned branch, then the null branch
    (text mask all False). Returns `null + (cond - null) * cond_scale`, or
    the stacked output when not `combine`."""
    if text_mask is None:
        text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
    video_mask = kwargs.pop("video_mask", None)
    if video_mask is not None:
        kwargs["video_mask"] = torch.cat([video_mask, video_mask])
    out2 = forward(torch.cat([x, x]), text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)]),
                   context=torch.cat([context, context]), **kwargs)
    if not combine:
        return out2
    cond, null = out2.chunk(2)
    return null + (cond - null) * cond_scale


def _check_seq_len(n: int, max_seq_len: int) -> None:
    """The position table covers `max_seq_len` tokens: a primed scene needs
    it to cover the prime tokens and the scene's."""
    if n > max_seq_len:
        raise ValueError(f"sequence length {n} exceeds max_seq_len {max_seq_len} — when sampling"
                         " with prime frames, max_seq_len must cover the prime tokens plus the new"
                         " scene's tokens")


def _trunk(transformer, h, pipeline_mesh, pipeline_microbatches, generator, **kwargs):
    """The trunk sequentially, or pipelined over `pipeline_mesh`."""
    if pipeline_mesh is None:
        return transformer(h, **kwargs)
    return pipeline_transformer_apply(transformer, h, pipeline_mesh, num_microbatches=pipeline_microbatches,
                                      training=transformer.training, generator=generator, **kwargs)


def _cond_dropout(text_mask, cond_drop_prob: float, b: int, generator, device):
    """Whole-sample conditioning dropout for CFG: drop each sample's text
    with probability `cond_drop_prob`, drawn from `generator`."""
    if cond_drop_prob > 0:
        keep = prob_mask_like((b,), 1.0 - cond_drop_prob, generator, device=device)
        text_mask = text_mask & keep[:, None]
    return text_mask


class MaskGit(nn.Module):
    def __init__(self, dim: int, num_tokens: int, max_seq_len: int, *, heads: int = 8,
                 dim_head: int = 64, depth: int = 6, dim_context: Optional[int] = None,
                 unconditional: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, dtype: Optional[torch.dtype] = None, seq_group=None,
                 reference_attention_kv: bool = False, gradient_shrink_alpha: float = 0.1,
                 remat: bool = False, ff_inner_dim: Optional[int] = None):
        super().__init__()
        self.num_tokens = num_tokens
        self.gradient_shrink_alpha = gradient_shrink_alpha
        self.max_seq_len = max_seq_len
        self.unconditional = unconditional
        self.reference_attention_kv = reference_attention_kv
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.continuous_pos_bias = ContinuousPositionBias(dim_head, heads, num_dims=3)
        self.transformer = Transformer(dim, depth, dim_context=dim_context, dim_head=dim_head,
                                       heads=heads, peg=True, has_cross_attn=not unconditional,
                                       attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                                       attn_reference_self_kv=reference_attention_kv,
                                       seq_group=seq_group, remat=remat, ff_inner_dim=ff_inner_dim)
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
                generator: Optional[torch.Generator] = None, pipeline_mesh=None,
                pipeline_microbatches: Optional[int] = None) -> torch.Tensor:
        """x: (b, n) or (b, t, h, w) token ids -> logits (or final-norm
        embeddings). video_mask (b, n) bool masks the self-attention keys;
        `cond_drop_prob` drops whole text conditions with draws from
        `generator`; `pipeline_mesh` pipelines the trunk (module docstring)."""
        if x.ndim == 4:
            video_patch_shape = tuple(x.shape[1:])
            x = x.reshape(x.shape[0], -1)
        if video_patch_shape is None:
            raise ValueError("video patch shape must be given")
        b, n = x.shape
        _check_seq_len(n, self.max_seq_len)
        rel_pos_bias = attn_bias if attn_bias is not None else self.rel_pos_bias(video_patch_shape)
        if self.unconditional:
            context = text_mask = None
        if context is not None:
            context = context.to(self.compute_dtype)
            if text_mask is None:
                text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
            text_mask = _cond_dropout(text_mask, cond_drop_prob, b, generator, x.device)

        dtype = self.compute_dtype
        h = self.token_emb(x).to(dtype) + self.pos_emb(torch.arange(n, device=x.device)).to(dtype)
        # the training-time gradient shrink, kept as written: in bf16 the two
        # products round, so it is not the identity
        alpha = self.gradient_shrink_alpha
        h = h * alpha + h.detach() * (1 - alpha)

        h = _trunk(self.transformer, h, pipeline_mesh, pipeline_microbatches, generator,
                   video_shape=(b, *video_patch_shape), attn_bias=rel_pos_bias, context=context,
                   self_attn_mask=video_mask, cross_attn_context_mask=text_mask)
        return h if return_embeds else linear(h, self.to_logits)

    def forward_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None, context=None,
                                combine: bool = True, **kwargs) -> torch.Tensor:
        """CFG on the logits: `null + (cond - null) * cond_scale`, or with
        `combine=False` the stacked (2b, n, vocab) logits, conditioned rows
        first, for a sampler that fuses the combine."""
        if cond_scale == 1 or self.unconditional or context is None:
            return self(x, text_mask=text_mask, context=context, **kwargs)
        return _with_cond_scale(self, x, cond_scale=cond_scale, text_mask=text_mask, context=context,
                                combine=combine, **kwargs)

    def embeds_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None,
                               context=None, **kwargs) -> torch.Tensor:
        """CFG combined in embedding space: (b, n, dim) final-norm embeddings."""
        if cond_scale == 1 or self.unconditional or context is None:
            return self(x, text_mask=text_mask, context=context, return_embeds=True, **kwargs)
        return _with_cond_scale(self, x, cond_scale=cond_scale, text_mask=text_mask, context=context,
                                return_embeds=True, **kwargs)


class TokenCritic(nn.Module):
    """The MaskGit trunk's shape with a scalar per-token logit head: no
    gradient shrink, no position bias, cross-attention only with
    `has_cross_attn`."""

    def __init__(self, dim: int, num_tokens: int, max_seq_len: int, *, has_cross_attn: bool = False,
                 heads: int = 8, dim_head: int = 64, depth: int = 6,
                 dim_context: Optional[int] = None, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 reference_attention_kv: bool = False, remat: bool = False,
                 ff_inner_dim: Optional[int] = None):
        super().__init__()
        self.num_tokens = num_tokens
        self.max_seq_len = max_seq_len
        self.has_cross_attn = has_cross_attn
        self.reference_attention_kv = reference_attention_kv
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.transformer = Transformer(dim, depth, dim_context=dim_context, dim_head=dim_head,
                                       heads=heads, peg=True, has_cross_attn=has_cross_attn,
                                       attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                                       attn_reference_self_kv=reference_attention_kv, remat=remat,
                                       ff_inner_dim=ff_inner_dim)
        self.to_logits = nn.Linear(dim, 1)

    @property
    def mask_id(self) -> int:
        return self.num_tokens

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.to_logits.weight.dtype

    def forward(self, x: torch.Tensor, *, video_patch_shape=None, cond_drop_prob: float = 0.0,
                text_mask=None, video_mask=None, context=None,
                generator: Optional[torch.Generator] = None, pipeline_mesh=None,
                pipeline_microbatches: Optional[int] = None) -> torch.Tensor:
        """x: (b, n) or (b, t, h, w) token ids -> (b, n) critic logits."""
        if x.ndim == 4:
            video_patch_shape = tuple(x.shape[1:])
            x = x.reshape(x.shape[0], -1)
        if video_patch_shape is None:
            raise ValueError("video patch shape must be given")
        b, n = x.shape
        _check_seq_len(n, self.max_seq_len)
        if not self.has_cross_attn:
            context = text_mask = None
        if context is not None:
            context = context.to(self.compute_dtype)
            if text_mask is None:
                text_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
            text_mask = _cond_dropout(text_mask, cond_drop_prob, b, generator, x.device)

        dtype = self.compute_dtype
        h = self.token_emb(x).to(dtype) + self.pos_emb(torch.arange(n, device=x.device)).to(dtype)
        h = _trunk(self.transformer, h, pipeline_mesh, pipeline_microbatches, generator,
                   video_shape=(b, *video_patch_shape), context=context, self_attn_mask=video_mask,
                   cross_attn_context_mask=text_mask)
        return linear(h, self.to_logits)[..., 0]

    def forward_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None, context=None,
                                **kwargs) -> torch.Tensor:
        if cond_scale == 1 or context is None or not self.has_cross_attn:
            return self(x, text_mask=text_mask, context=context, **kwargs)
        return _with_cond_scale(self, x, cond_scale=cond_scale, text_mask=text_mask, context=context,
                                **kwargs)


class SelfCritic(nn.Module):
    """A MaskGit's trunk to its final embeddings, then a scalar head
    `to_pred`. The MaskGit is shared, not owned: it is not a submodule, so
    `parameters()` and `state_dict()` hold the head alone, as the TPU
    package's `{"critic": {"to_pred": ...}}` tree does."""

    def __init__(self, maskgit: MaskGit):
        super().__init__()
        self.__dict__["maskgit"] = maskgit  # shared, not registered
        self.to_pred = nn.Linear(maskgit.to_logits.in_features, 1)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """x: (b, n) or (b, t, h, w) token ids -> (b, n) critic logits; the
        keyword arguments are MaskGit's."""
        return linear(self.maskgit(x, return_embeds=True, **kwargs), self.to_pred)[..., 0]

    def forward_with_cond_scale(self, x, *, cond_scale: float = 3.0, text_mask=None, context=None,
                                **kwargs) -> torch.Tensor:
        if cond_scale == 1 or context is None or self.maskgit.unconditional:
            return self(x, text_mask=text_mask, context=context, **kwargs)
        return _with_cond_scale(self, x, cond_scale=cond_scale, text_mask=text_mask, context=context,
                                **kwargs)
