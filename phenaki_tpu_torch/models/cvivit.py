"""C-ViViT, decode path (counterpart of phenaki_tpu/models/cvivit.py:
shape arithmetic, `calculate_video_token_mask`,
`decode_from_codebook_indices`, `decode_tokens`, `_to_pixels`). Video is channels-last (b, f, H, W, c), as in the TPU package.

Decode: LFQ indices -> codes -> causal temporal transformer over the frame
axis (PEG 'bhw_t', ALiBi) -> spatial transformer per frame (2-D continuous
position bias) -> pixel heads for the first frame and for the rest.
`seq_group` (a process group) runs the temporal self-attention as ring
attention over the frame axis; spatial attention stays dense, as in the
JAX package.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.positional import ContinuousPositionBias
from phenaki_tpu_torch.ops.quantize import LFQ


def pair(v):
    return v if isinstance(v, tuple) else (v, v)


class CViViT(nn.Module):
    def __init__(self, dim: int, codebook_size: int, image_size: Union[int, Tuple[int, int]],
                 patch_size: Union[int, Tuple[int, int]], temporal_patch_size: int,
                 spatial_depth: int, temporal_depth: int, *, dim_head: int = 64, heads: int = 8,
                 channels: int = 3, seq_group=None):
        super().__init__()
        self.image_hw = pair(image_size)
        self.patch_hw = pair(patch_size)
        self.temporal_patch_size = temporal_patch_size
        self.channels = channels
        ph, pw = self.patch_hw
        c, pt = channels, temporal_patch_size
        common = dict(dim_head=dim_head, heads=heads)
        self.spatial_rel_pos_bias = ContinuousPositionBias(dim, heads, num_dims=2)
        self.dec_temporal_transformer = Transformer(
            dim, temporal_depth, causal=True, peg=True, peg_causal=True, peg_layout="bhw_t",
            seq_group=seq_group, **common
        )
        self.dec_spatial_transformer = Transformer(dim, spatial_depth, **common)
        self.vq = LFQ(dim, codebook_size)
        self.to_pixels_first = nn.Linear(dim, c * ph * pw)
        self.to_pixels_rest = nn.Linear(dim, c * ph * pw * pt)

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
                f" temporal_patch_size ({self.temporal_patch_size})"
            )
        return total + (num_frames // self.temporal_patch_size) * self.image_num_tokens

    def calculate_video_token_mask(self, video_frame_mask: torch.Tensor) -> torch.Tensor:
        """(b, f) frame mask -> (b, latent_f * h * w) token mask: the first
        frame is its own latent frame, each later latent frame is valid when
        any of its `temporal_patch_size` frames is."""
        first, rest = video_frame_mask[:, :1], video_frame_mask[:, 1:]
        rest = rest.reshape(rest.shape[0], -1, self.temporal_patch_size).any(dim=-1)
        frame_mask = torch.cat([first, rest], dim=-1)
        return frame_mask.repeat_interleave(self.image_num_tokens, dim=-1)

    def _to_pixels(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, h, w, dim) -> (b, f, H, W, c)."""
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
        return self._to_pixels(self.decode_tokens(tokens))

    def decode_from_codebook_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (b, n) or (b, t, h, w) -> video (b, f, H, W, c)."""
        if indices.ndim == 4:
            indices = indices.reshape(indices.shape[0], -1)
        return self.decode(self.vq.indices_to_codes(indices))
