"""Phenaki text-to-video sampling (counterpart of
phenaki_tpu/models/phenaki.py: `Phenaki.sample` without prime frames or a
critic; text comes in as `text_embeds`).

A sample: pad the text embeddings to `max_text_len` (text mask = rows that
are not all zero) -> the MaskGit 3-D position bias, computed once -> the
18-step decode loop (CFG in embedding space, `to_logits` feeding the fused
projection-sampling kernel) -> C-ViViT decode of the ids to video.
"""

from __future__ import annotations

from typing import Optional

import torch

from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.sampling_loop import maskgit_sample_loop


class Phenaki:
    def __init__(self, *, maskgit: MaskGit, cvivit: CViViT, text_embed_dim: int,
                 steps: int = 18, max_text_len: int = 128):
        self.maskgit = maskgit.eval()
        self.cvivit = cvivit.eval()
        self.steps = steps
        self.text_embed_dim = text_embed_dim
        self.max_text_len = max_text_len

    def pad_text_embeds(self, emb: torch.Tensor) -> torch.Tensor:
        """(b, L, d) -> (b, max_text_len, d), zero-padded or truncated."""
        b, L, d = emb.shape
        if d != self.text_embed_dim:
            raise ValueError(f"text embedding dim {d} != {self.text_embed_dim}")
        if L >= self.max_text_len:
            return emb[:, : self.max_text_len]
        return torch.cat([emb, emb.new_zeros(b, self.max_text_len - L, d)], dim=1)

    @torch.inference_mode()
    def sample(self, *, num_frames: int, text_embeds: Optional[torch.Tensor] = None,
               batch_size: int = 1, cond_scale: float = 3.0, starting_temperature: float = 0.9,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Text-to-video sampling: (b, num_frames, H, W, c) in the C-ViViT pixel
        space. `generator` (a CPU torch.Generator) seeds the sampling noise."""
        ids = self.sample_ids(num_frames=num_frames, text_embeds=text_embeds,
                              batch_size=batch_size, cond_scale=cond_scale,
                              starting_temperature=starting_temperature, generator=generator)
        return self.cvivit.decode_from_codebook_indices(ids)

    @torch.inference_mode()
    def sample_ids(self, *, num_frames: int, text_embeds: Optional[torch.Tensor] = None,
                   batch_size: int = 1, cond_scale: float = 3.0,
                   starting_temperature: float = 0.9,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The decode loop of `sample`: video token ids (b, n) int64."""
        weight = self.maskgit.to_logits.weight
        device, dtype = weight.device, weight.dtype
        context = text_mask = None
        if text_embeds is not None:
            text_embeds = self.pad_text_embeds(text_embeds.to(device))
            batch_size = text_embeds.shape[0]
            text_mask = (text_embeds != 0).any(dim=-1)
            context = text_embeds.to(dtype)

        num_tokens = self.cvivit.num_tokens_per_frames(num_frames)
        patch_shape = self.cvivit.get_video_patch_shape(num_frames)
        rel_pos_bias = self.maskgit.rel_pos_bias(patch_shape)

        def embeds_fn(ids):
            return self.maskgit.embeds_with_cond_scale(
                ids, video_patch_shape=patch_shape, context=context, text_mask=text_mask,
                cond_scale=cond_scale, attn_bias=rel_pos_bias,
            )

        return maskgit_sample_loop(
            embeds_fn,
            (weight, self.maskgit.to_logits.bias),
            batch=batch_size,
            num_tokens_seq=num_tokens,
            mask_id=self.maskgit.mask_id,
            device=device,
            steps=self.steps,
            starting_temperature=starting_temperature,
            generator=generator,
        )
