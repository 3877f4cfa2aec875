"""C-ViViT, the video tokenizer-autoencoder (counterpart of
phenaki_tpu/models/cvivit.py without the GAN discriminator). Video is
channels-last (b, f, H, W, c), as in the TPU package; an image is (b, H, W, c).

Encode: the first frame in 1 x p x p patches, the rest in pt x p x p
patches, each through a dual patch-norm embedding (LayerNorm -> Linear ->
LayerNorm) -> spatial transformer per latent frame (2-D continuous position
bias) -> causal temporal transformer over the latent frames (PEG 'bhw_t',
ALiBi) -> the quantizer (LFQ, or cosine VQ with
`lookup_free_quantization=False`) over the flat (b, t*h*w, dim) sequence.
Decode: quantizer indices -> codes -> causal temporal transformer -> spatial
transformer -> pixel heads for the first frame and for the rest.

`seq_group` (a process group) runs both temporal transformers'
self-attention as ring attention over the frame axis; spatial attention
stays dense, as in the JAX package. Attention and FF dropout act in training
mode; `tokenize` always runs in eval mode and skips the decoder. The encoder
computes in its weights' dtype (the video is cast to it), as the decoder does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.norms import StandardLayerNorm
from phenaki_tpu_torch.ops.positional import ContinuousPositionBias
from phenaki_tpu_torch.ops.quantize import LFQ, VectorQuantize


def pair(v):
    return v if isinstance(v, tuple) else (v, v)


class CViViT(nn.Module):
    def __init__(self, dim: int, codebook_size: int, image_size: Union[int, Tuple[int, int]],
                 patch_size: Union[int, Tuple[int, int]], temporal_patch_size: int,
                 spatial_depth: int, temporal_depth: int, *, dim_head: int = 64, heads: int = 8,
                 channels: int = 3, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 lookup_free_quantization: bool = True, lfq_entropy_loss_weight: float = 0.1,
                 lfq_commitment_loss_weight: float = 0.25, lfq_diversity_gamma: float = 1.0,
                 seq_group=None):
        super().__init__()
        self.image_hw = pair(image_size)
        self.patch_hw = pair(patch_size)
        self.temporal_patch_size = temporal_patch_size
        self.channels = channels
        self.lookup_free_quantization = lookup_free_quantization
        ph, pw = self.patch_hw
        c, pt = channels, temporal_patch_size
        spatial = dict(dim_head=dim_head, heads=heads, attn_dropout=attn_dropout, ff_dropout=ff_dropout)
        temporal = dict(spatial, causal=True, peg=True, peg_causal=True, peg_layout="bhw_t",
                        seq_group=seq_group)
        self.spatial_rel_pos_bias = ContinuousPositionBias(dim, heads, num_dims=2)
        self.dec_temporal_transformer = Transformer(dim, temporal_depth, **temporal)
        self.dec_spatial_transformer = Transformer(dim, spatial_depth, **spatial)
        if lookup_free_quantization:
            self.vq = LFQ(dim, codebook_size, entropy_loss_weight=lfq_entropy_loss_weight,
                          commitment_loss_weight=lfq_commitment_loss_weight,
                          diversity_gamma=lfq_diversity_gamma)
        else:
            self.vq = VectorQuantize(dim, codebook_size)
        self.to_pixels_first = nn.Linear(dim, c * ph * pw)
        self.to_pixels_rest = nn.Linear(dim, c * ph * pw * pt)
        # the encoder; its dual patch-norm embeddings are LayerNorm(patch) ->
        # Linear(patch, dim) -> LayerNorm(dim)
        self.patch_norm_in_first = StandardLayerNorm(c * ph * pw)
        self.patch_proj_first = nn.Linear(c * ph * pw, dim)
        self.patch_norm_out_first = StandardLayerNorm(dim)
        self.patch_norm_in_rest = StandardLayerNorm(c * ph * pw * pt)
        self.patch_proj_rest = nn.Linear(c * ph * pw * pt, dim)
        self.patch_norm_out_rest = StandardLayerNorm(dim)
        self.enc_spatial_transformer = Transformer(dim, spatial_depth, **spatial)
        self.enc_temporal_transformer = Transformer(dim, temporal_depth, **temporal)

    def encoder_modules(self) -> List[nn.Module]:
        """The modules only the encode side uses: the patch embeddings, the
        encoder transformers and the LFQ's `project_in`."""
        mods = [self.patch_norm_in_first, self.patch_proj_first, self.patch_norm_out_first,
                self.patch_norm_in_rest, self.patch_proj_rest, self.patch_norm_out_rest,
                self.enc_spatial_transformer, self.enc_temporal_transformer]
        if self.lookup_free_quantization and self.vq.project_in is not None:
            mods.append(self.vq.project_in)
        return mods

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the C-ViViT computes in: its weights'."""
        return self.patch_proj_first.weight.dtype

    @property
    def patch_height_width(self) -> Tuple[int, int]:
        return self.image_hw[0] // self.patch_hw[0], self.image_hw[1] // self.patch_hw[1]

    @property
    def image_num_tokens(self) -> int:
        h, w = self.patch_height_width
        return h * w

    def get_video_patch_shape(self, num_frames: int, include_first_frame: bool = True):
        patch_frames = 0
        if include_first_frame:
            num_frames -= 1
            patch_frames += 1
        patch_frames += num_frames // self.temporal_patch_size
        return (patch_frames, *self.patch_height_width)

    def num_tokens_per_frames(self, num_frames: int, include_first_frame: bool = True) -> int:
        total = 0
        if include_first_frame:
            num_frames -= 1
            total += self.image_num_tokens
        if num_frames % self.temporal_patch_size != 0:
            raise ValueError(
                f"number of frames after the first ({num_frames}) must be divisible by"
                f" temporal_patch_size ({self.temporal_patch_size}); use"
                f" 1 + k*{self.temporal_patch_size} total frames for unprimed scenes, or a"
                f" multiple of {self.temporal_patch_size} new frames for primed scenes"
            )
        return total + (num_frames // self.temporal_patch_size) * self.image_num_tokens

    def frames_per_num_tokens(self, num_tokens: int) -> int:
        """Video frames that decode from `num_tokens` tokens (the first
        latent frame is one frame, each later one `temporal_patch_size`)."""
        if num_tokens <= 0 or num_tokens % self.image_num_tokens != 0:
            raise ValueError(f"{num_tokens} tokens are not a whole number of latent frames"
                             f" of {self.image_num_tokens} tokens")
        return (num_tokens // self.image_num_tokens - 1) * self.temporal_patch_size + 1

    def calculate_video_token_mask(self, video_frame_mask: torch.Tensor) -> torch.Tensor:
        """(b, f) frame mask -> (b, latent_f * h * w) token mask: the first
        frame is its own latent frame, each later latent frame is valid when
        any of its `temporal_patch_size` frames is."""
        first, rest = video_frame_mask[:, :1], video_frame_mask[:, 1:]
        rest = rest.reshape(rest.shape[0], -1, self.temporal_patch_size).any(dim=-1)
        frame_mask = torch.cat([first, rest], dim=-1)
        return frame_mask.repeat_interleave(self.image_num_tokens, dim=-1)

    # encode

    def _to_patch_tokens(self, video: torch.Tensor) -> torch.Tensor:
        """(b, f, H, W, c) -> (b, t, h, w, dim), t = 1 + (f - 1) / pt; a
        patch flattens as (c, ph, pw) for the first frame and (c, pt, ph, pw)
        for the rest."""
        b, f = video.shape[:2]
        ph, pw = self.patch_hw
        pt, c = self.temporal_patch_size, self.channels
        h, w = self.patch_height_width
        video = video.to(self.dtype)
        x = video[:, :1].reshape(b, 1, h, ph, w, pw, c)
        x = x.permute(0, 1, 2, 4, 6, 3, 5).reshape(b, 1, h, w, c * ph * pw)
        t = (f - 1) // pt
        y = video[:, 1:].reshape(b, t, pt, h, ph, w, pw, c)
        y = y.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, t, h, w, c * pt * ph * pw)
        x = self.patch_norm_out_first(self.patch_proj_first(self.patch_norm_in_first(x)))
        if t == 0:  # an image: no later frames
            return x
        y = self.patch_norm_out_rest(self.patch_proj_rest(self.patch_norm_in_rest(y)))
        return torch.cat([x, y], dim=1)

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """Spatial then causal-temporal encoding: (b, t, h, w, d) -> same."""
        b, t, h, w, d = tokens.shape
        video_shape = (b, t, h, w)
        x = tokens.reshape(b * t, h * w, d)
        x = self.enc_spatial_transformer(x, video_shape=video_shape,
                                         attn_bias=self.spatial_rel_pos_bias(h, w))
        x = x.reshape(b, t, h, w, d).permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
        x = self.enc_temporal_transformer(x, video_shape=video_shape)
        return x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)

    def _encoded(self, video: torch.Tensor):
        """Video or image -> (encoded tokens (b, t, h, w, d), is_image)."""
        is_image = video.ndim == 4
        if is_image:
            video = video[:, None]
        f, H, W = video.shape[1:4]
        if (H, W) != self.image_hw:
            raise ValueError(f"expected frames of {self.image_hw}, got {(H, W)}")
        if (f - 1) % self.temporal_patch_size != 0:
            raise ValueError(f"frames ({f}) minus one must be divisible by temporal patch size"
                             f" ({self.temporal_patch_size})")
        return self.encode(self._to_patch_tokens(video)), is_image

    def forward_intermediates(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None,
                              update_codebook: bool = False) -> dict:
        """The full forward with what the VQGAN losses need: `recon_video`,
        `indices` (b, t, h, w), `vq_aux_loss`, `dec_tokens` (the decoder's
        output before the pixel heads) and `is_image`. `mask` (b, f) bool
        weighs the quantizer's losses by latent frame (videos only);
        `update_codebook` moves a VQ codebook's EMA."""
        if video.ndim == 4 and mask is not None:
            raise ValueError("an image takes no frame mask")
        tokens, is_image = self._encoded(video)
        b, t, h, w, d = tokens.shape
        vq_mask = self.calculate_video_token_mask(mask) if mask is not None else None
        vq_kw = {} if self.lookup_free_quantization else {"update_codebook": update_codebook}
        quantized, indices, aux_loss = self.vq(tokens.reshape(b, t * h * w, d), mask=vq_mask, **vq_kw)
        dec_tokens = self.decode_tokens(quantized.reshape(b, t, h, w, d))
        recon = self.to_pixels(dec_tokens)
        return dict(recon_video=recon[:, 0] if is_image else recon,
                    indices=indices.reshape(b, t, h, w), vq_aux_loss=aux_loss,
                    dec_tokens=dec_tokens, is_image=is_image)

    def forward(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_only_codebook_ids: bool = False, update_codebook: bool = False):
        """video (b, f, H, W, c) or image (b, H, W, c) -> (recon, indices
        (b, t, h, w), vq_aux_loss), or the indices alone."""
        out = self.forward_intermediates(video, mask=mask, update_codebook=update_codebook)
        if return_only_codebook_ids:
            return out["indices"]
        return out["recon_video"], out["indices"], out["vq_aux_loss"]

    @torch.no_grad()
    def tokenize(self, video: torch.Tensor) -> torch.Tensor:
        """Video (or image) -> codebook ids (b, t, h, w), in eval mode; the
        decoder does not run."""
        was_training = self.training
        self.eval()
        try:
            tokens, _ = self._encoded(video)
            b, t, h, w, d = tokens.shape
            flat = tokens.reshape(b, t * h * w, d)
            if self.lookup_free_quantization:
                ids = self.vq.codes_to_indices(self.vq.pre_sign(flat))
            else:
                ids = self.vq(flat, update_codebook=False).indices
        finally:
            self.train(was_training)
        return ids.reshape(b, t, h, w)

    # decode

    def to_pixels(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pixel heads: (b, t, h, w, d) -> video (b, f, H, W, c)."""
        b, t, h, w, _ = tokens.shape
        ph, pw = self.patch_hw
        pt, c = self.temporal_patch_size, self.channels
        first = self.to_pixels_first(tokens[:, :1]).reshape(b, 1, h, w, c, ph, pw)
        first = first.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, 1, h * ph, w * pw, c)
        rest = self.to_pixels_rest(tokens[:, 1:]).reshape(b, t - 1, h, w, c, pt, ph, pw)
        rest = rest.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, (t - 1) * pt, h * ph, w * pw, c)
        return torch.cat([first, rest], dim=1)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, h, w, d) or (b, t*h*w, d) -> (b, t, h, w, d)."""
        h, w = self.patch_height_width
        if tokens.ndim == 3:
            b, n, d = tokens.shape
            tokens = tokens.reshape(b, n // (h * w), h, w, d)
        b, t, _, _, d = tokens.shape
        video_shape = (b, t, h, w)
        x = tokens.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
        x = self.dec_temporal_transformer(x, video_shape=video_shape)
        x = x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)
        attn_bias = self.spatial_rel_pos_bias(h, w)
        x = x.reshape(b * t, h * w, d)
        x = self.dec_spatial_transformer(x, video_shape=video_shape, attn_bias=attn_bias)
        return x.reshape(b, t, h, w, d)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.to_pixels(self.decode_tokens(tokens))

    def decode_from_codebook_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (b, n) or (b, t, h, w) -> video (b, f, H, W, c)."""
        if indices.ndim == 4:
            indices = indices.reshape(indices.shape[0], -1)
        if self.lookup_free_quantization:
            codes = self.vq.indices_to_codes(indices)
        else:
            codes = self.vq.codebook_lookup(indices).to(self.to_pixels_first.weight.dtype)
        return self.decode(codes)
