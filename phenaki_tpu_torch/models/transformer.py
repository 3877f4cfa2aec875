"""Transformer block stack (counterpart of phenaki_tpu/models/transformer.py).

Per layer: PEG? -> self-attn -> cross-attn? -> GEGLU FF, all residual; then
a gamma-only LayerNorm. The layers are a plain ModuleList (the TPU package's
`scan_layers` stacked trees are unstacked by phenaki_tpu_torch.bridge).
`attn_reference_self_kv` takes the self-attention's K/V from the pre-norm
input, the quirk of reference-trained weights (`ops.attention.Attention`,
`reference_self_kv`).
Attention and FF dropout act in training mode (`module.train()`), where the
TPU package passes `deterministic=False`. `seq_group` (a process group)
makes the self-attention sequence-parallel (`ops.attention.Attention`).
A pipeline stage's stack (`parallel.pipeline.pipeline_stage_module`) holds
only its layers, keyed by their global index, and runs only through
`parallel.pipeline.pipeline_transformer_apply`.
`remat` recomputes each layer's self-attention, cross-attention and
FeedForward in the backward instead of keeping their activations
(`torch.utils.checkpoint`, non-reentrant), as the TPU package wraps exactly
those blocks in `nn.remat`; PEG and the residual adds are kept. The
recompute replays the global RNG state (dropout draws the same mask), and a
pipeline stage's layers get it too, as they are the same modules.
`ff_mult`, `ff_inner_dim` (the GEGLU width; None: `int(ff_mult * 2/3 * dim)`)
and `attn_num_null_kv` are the TPU package's fields of the same names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from phenaki_tpu_torch.ops.attention import Attention
from phenaki_tpu_torch.ops.feedforward import FeedForward
from phenaki_tpu_torch.ops.norms import LayerNorm
from phenaki_tpu_torch.ops.positional import PEG


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, *, dim_context: Optional[int] = None, causal: bool = False,
                 dim_head: int = 64, heads: int = 8, peg: bool = False, peg_causal: bool = False,
                 peg_layout: str = "thw", has_cross_attn: bool = False,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, ff_mult: int = 4,
                 ff_inner_dim: Optional[int] = None, attn_num_null_kv: int = 2,
                 remat: bool = False, attn_reference_self_kv: bool = False, seq_group=None):
        super().__init__()
        self.remat = remat
        self.peg = PEG(dim, causal=peg_causal, layout=peg_layout) if peg else None
        self.self_attn = Attention(dim, dim_head=dim_head, heads=heads, causal=causal,
                                   reference_self_kv=attn_reference_self_kv,
                                   dropout=attn_dropout, seq_group=seq_group)
        self.cross_attn = (
            Attention(dim, dim_context=dim_context, dim_head=dim_head, heads=heads,
                      num_null_kv=attn_num_null_kv, cross=True, dropout=attn_dropout)
            if has_cross_attn else None
        )
        self.ff = FeedForward(dim, mult=ff_mult, dropout=ff_dropout, inner_dim=ff_inner_dim)

    def _block(self, module, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, x, attn_bias=None, context=None, self_attn_mask=None,
                cross_attn_context_mask=None, video_shape=None):
        if self.peg is not None:
            x = self.peg(x, shape=video_shape)  # the residual is PEG's
        x = self._block(self.self_attn, x, self_attn_mask, None, attn_bias) + x
        if self.cross_attn is not None and context is not None:
            x = self._block(self.cross_attn, x, cross_attn_context_mask, context) + x
        return self._block(self.ff, x) + x


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, **layer_kwargs):
        super().__init__()
        self.depth = depth
        self.causal = layer_kwargs.get("causal", False)
        self.layers = nn.ModuleList(TransformerLayer(dim, **layer_kwargs) for _ in range(depth))
        self.norm_out = LayerNorm(dim)
        # the global indices of the layers a pipeline stage holds (None: all)
        self.stage: Optional[range] = None

    def forward(self, x: torch.Tensor, video_shape: Optional[Tuple[int, int, int, int]] = None,
                attn_bias=None, context=None, self_attn_mask=None,
                cross_attn_context_mask=None) -> torch.Tensor:
        if self.stage is not None:
            raise RuntimeError(f"this stack holds only layers {list(self.stage)} of {self.depth}: "
                               "run it through parallel.pipeline.pipeline_transformer_apply")
        for layer in self.layers:
            x = layer(x, attn_bias, context, self_attn_mask, cross_attn_context_mask, video_shape)
        return self.norm_out(x)
