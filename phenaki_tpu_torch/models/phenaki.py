"""Phenaki: text-to-video sampling and the MaskGit training loss
(counterpart of phenaki_tpu/models/phenaki.py: `Phenaki.sample` without
prime frames or a critic, and `Phenaki.loss` for the generator on
pre-tokenized video ids; text comes in as `text_embeds`).

A sample: pad the text embeddings to `max_text_len` (text mask = rows that
are not all zero) -> the MaskGit 3-D position bias, computed once -> the
18-step decode loop (CFG in embedding space, `to_logits` feeding the fused
projection-sampling kernel) -> C-ViViT decode of the ids to video.

The loss: a random step per sample gives the cosine mask fraction, that
many valid tokens are replaced by the mask id, and the masked tokens'
cross-entropy over the vocab is averaged. Where the fused CE takes the
shape (`can_fuse_ce`, the flagship's d = 512, V = 65,536 among them) the
MaskGit returns its final embeddings and `fused_vocab_cross_entropy` takes
the CE with the `to_logits` projection, so the (b, n, V) logits are never
materialised on the card; otherwise the logits are materialised and the CE
is plain torch in f32, as in the TPU package's non-fused branch. Training
a critic is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.sampling_loop import maskgit_sample_loop
from phenaki_tpu_torch.ops.fused_ce import can_fuse_ce, fused_vocab_cross_entropy
from phenaki_tpu_torch.ops.sampling import get_mask_subset_with_prob, uniform

CRITIC_NOT_PORTED = ("critic training and sampling are not ported yet (ROADMAP A10, the next "
                     "training slice)")


class Phenaki:
    def __init__(self, *, maskgit: MaskGit, cvivit: CViViT, text_embed_dim: int,
                 steps: int = 18, max_text_len: int = 128, cond_drop_prob: float = 0.25,
                 critic: Optional[nn.Module] = None, self_token_critic: bool = False):
        if not cond_drop_prob > 0:
            raise ValueError("cond_drop_prob must be > 0")
        self.maskgit = maskgit
        self.cvivit = cvivit.eval()
        self.steps = steps
        self.text_embed_dim = text_embed_dim
        self.max_text_len = max_text_len
        self.cond_drop_prob = cond_drop_prob
        self.has_critic = critic is not None or self_token_critic

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
        if self.has_critic:
            raise NotImplementedError(CRITIC_NOT_PORTED)
        self.maskgit.eval()
        dtype = self.maskgit.compute_dtype
        weight = self.maskgit.to_logits.weight
        device = weight.device
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
            (weight.to(dtype), self.maskgit.to_logits.bias),
            batch=batch_size,
            num_tokens_seq=num_tokens,
            mask_id=self.maskgit.mask_id,
            device=device,
            steps=self.steps,
            starting_temperature=starting_temperature,
            generator=generator,
        )

    def _loss_draws(self, b: int, n: int, generator: Optional[torch.Generator], device):
        """The loss's random draws: the step per sample (b,) int64 in
        [0, steps) and the uniforms (b, n) that choose the masked tokens."""
        gen_device = generator.device if generator is not None else device
        rand_step = torch.randint(0, self.steps, (b,), generator=generator, device=gen_device)
        return rand_step.to(device), uniform((b, n), generator, device)

    def loss(self, *, video_codebook_ids: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
             video_frame_mask: Optional[torch.Tensor] = None,
             cond_drop_prob: Optional[float] = None, train: bool = True,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked-token cross-entropy of the generator: (loss, metrics).

        video_codebook_ids (b, t, h, w) int; text_embeds (b, L, d) with
        all-zero rows as padding; video_frame_mask (b, f) bool. Every random
        draw (step, mask subset, conditioning dropout) comes from
        `generator`; `train` turns conditioning, attention and FF dropout on."""
        if self.has_critic:
            raise NotImplementedError(CRITIC_NOT_PORTED)
        if text_embeds is None and not self.maskgit.unconditional:
            raise ValueError("text embeds must be given unless unconditional")
        if video_codebook_ids.ndim != 4:
            raise ValueError("video_codebook_ids must be (b, t, h, w)")
        device = self.maskgit.to_logits.weight.device
        patch_shape = tuple(video_codebook_ids.shape[1:])
        ids = video_codebook_ids.reshape(video_codebook_ids.shape[0], -1).to(device).long()
        b, n = ids.shape

        text_mask, drop_prob = None, 0.0
        if not self.maskgit.unconditional:
            text_embeds = text_embeds.to(device)
            text_mask = (text_embeds != 0).any(dim=-1)
            drop_prob = cond_drop_prob if cond_drop_prob is not None else self.cond_drop_prob

        if video_frame_mask is not None:
            video_mask = self.cvivit.calculate_video_token_mask(video_frame_mask.to(device))
        else:
            video_mask = torch.ones((b, n), dtype=torch.bool, device=device)

        rand_step, noise = self._loss_draws(b, n, generator, device)
        mask_prob = torch.cos(rand_step.float() * math.pi * 0.5 / self.steps)
        mask_token_mask = get_mask_subset_with_prob(video_mask, mask_prob, noise=noise)
        masked_input = torch.where(mask_token_mask, self.maskgit.mask_id, ids)

        self.maskgit.train(train)
        proj = self.maskgit.to_logits
        fuse_ce = can_fuse_ce(proj.in_features, proj.out_features)
        out = self.maskgit(masked_input.reshape(b, *patch_shape), video_mask=video_mask,
                           cond_drop_prob=drop_prob if train else 0.0, text_mask=text_mask,
                           context=text_embeds, return_embeds=fuse_ce, generator=generator)
        if fuse_ce:
            ce = fused_vocab_cross_entropy(out, proj.weight, proj.bias, ids).reshape(-1)
        else:
            ce = F.cross_entropy(out.float().reshape(b * n, -1), ids.reshape(-1), reduction="none")
        w = mask_token_mask.reshape(-1).float()
        gen_loss = (ce * w).sum() / w.sum().clamp_min(1.0)
        return gen_loss, {"maskgit_loss": gen_loss, "loss": gen_loss}
