"""C-ViViT, the video tokenizer-autoencoder, and the frame discriminator of
its GAN training (counterpart of phenaki_tpu/models/cvivit.py). Video is
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
mode; `tokenize` always runs in eval mode and skips the decoder. `remat`
recomputes the four transformers' attention and FF blocks in the backward
(`models.transformer`), as the TPU package's field of the same name.

`dtype` is the compute dtype (the TPU package's `dtype` field): the video
and the activations are cast to it and the weights at use, so f32 weights
train with bf16 compute. None computes in the weights' dtype.

Two flags reproduce the quirks that weights trained with the reference
phenaki-pytorch expect (`convert.py`), without changing the parameters:
`peg_reference_layout` reads the temporal PEG's flat (b*h*w, t) sequence as
a (t, h, w) grid ('thw'), and `reference_attention_kv` takes every
self-attention's K/V from its pre-norm input.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.attention import Attention
from phenaki_tpu_torch.ops.feedforward import linear
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
                 seq_group=None, dtype: Optional[torch.dtype] = None,
                 peg_reference_layout: bool = False, reference_attention_kv: bool = False,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.peg_reference_layout = peg_reference_layout
        self.reference_attention_kv = reference_attention_kv
        self.image_hw = pair(image_size)
        self.patch_hw = pair(patch_size)
        self.temporal_patch_size = temporal_patch_size
        self.channels = channels
        self.lookup_free_quantization = lookup_free_quantization
        ph, pw = self.patch_hw
        c, pt = channels, temporal_patch_size
        spatial = dict(dim_head=dim_head, heads=heads, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                       attn_reference_self_kv=reference_attention_kv, remat=remat)
        # 'thw' on the flat (b*h*w, t) temporal sequence is the reference's
        # scrambled-grid stencil, which its trained weights expect
        temporal = dict(spatial, causal=True, peg=True, peg_causal=True,
                        peg_layout="thw" if peg_reference_layout else "bhw_t", seq_group=seq_group)
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
        """The dtype the C-ViViT computes in: `compute_dtype`, else its weights'."""
        return self.compute_dtype or self.patch_proj_first.weight.dtype

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
        x = self.patch_norm_out_first(linear(self.patch_norm_in_first(x), self.patch_proj_first))
        if t == 0:  # an image: no later frames
            return x
        y = self.patch_norm_out_rest(linear(self.patch_norm_in_rest(y), self.patch_proj_rest))
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
        first = linear(tokens[:, :1], self.to_pixels_first).reshape(b, 1, h, w, c, ph, pw)
        first = first.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, 1, h * ph, w * pw, c)
        rest = linear(tokens[:, 1:], self.to_pixels_rest).reshape(b, t - 1, h, w, c, pt, ph, pw)
        rest = rest.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, (t - 1) * pt, h * ph, w * pw, c)
        return torch.cat([first, rest], dim=1)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, h, w, d) or (b, t*h*w, d) -> (b, t, h, w, d)."""
        h, w = self.patch_height_width
        tokens = tokens.to(self.dtype)
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
            codes = self.vq.codebook_lookup(indices)
        return self.decode(codes)


# the frame discriminator


def conv2d(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """`layer(x)` computed in x's dtype: the weights are cast at use."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride, layer.padding)


class DiscriminatorBlock(nn.Module):
    """Residual block on (b, c, H, W): a 1 x 1 residual conv (of every other
    pixel with `downsample`: stride 2) beside two 3 x 3 convs with leaky
    ReLU (0.1); with `downsample`, space-to-depth into 4c channels ordered
    (c, 2, 2), as the TPU package's transpose orders them, then a 1 x 1
    conv. The sum is scaled by 1/sqrt(2)."""

    def __init__(self, in_channels: int, filters: int, downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.conv_res = nn.Conv2d(in_channels, filters, 1)
        self.conv1 = nn.Conv2d(in_channels, filters, 3, padding=1)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.conv_down = nn.Conv2d(filters * 4, filters, 1) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the 1 x 1 stride-2 residual conv, as the same 1 x 1 conv of every
        # other pixel: torch's CPU double backward of a strided conv on a
        # channels-last input crashes (the R1 penalty needs it)
        res = conv2d(x[:, :, ::2, ::2] if self.downsample else x, self.conv_res)
        x = F.leaky_relu(conv2d(x, self.conv1), 0.1)
        x = F.leaky_relu(conv2d(x, self.conv2), 0.1)
        if self.conv_down is not None:
            x = conv2d(F.pixel_unshuffle(x, 2), self.conv_down)
        return (x + res) * (1 / math.sqrt(2))


class Discriminator(nn.Module):
    """Single frames (b, H, W, c) -> (b,) logits, computing in `dtype` (None:
    the weights' dtype).

    log2(min(H, W)) - 1 blocks, each but the last halving the frame, of
    min(4 dim 2^i, max_dim) channels; after the block at a resolution in
    `attn_res_layers` (counted from min(H, W), halved each block), a
    residual self-attention over its H x W positions that never reaches the
    flash kernels (`use_flash=False`: the R1 penalty differentiates it
    twice). Then a 3 x 3 conv, leaky ReLU, and a linear head over the frame
    flattened as (h, w, c), the TPU package's channels-last order. Blocks
    and convs run channels-first on a channels-last view of the input.
    With `return_features=True` the per-block activations (b, h, w, c) come
    too, the perceptual loss's `"disc"` features."""

    def __init__(self, dim: int, image_size: Union[int, Tuple[int, int]], channels: int = 3,
                 attn_res_layers: Tuple[int, ...] = (16,), max_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.image_hw = pair(image_size)
        min_res = min(self.image_hw)
        num_layers = int(math.log2(min_res) - 2)
        dims = [channels] + [min(dim * 4 * 2**i, max_dim) for i in range(num_layers + 1)]
        self.num_blocks = len(dims) - 1
        self.attn_blocks = set()
        resolution = min_res
        for ind, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            block = DiscriminatorBlock(cin, cout, downsample=ind != self.num_blocks - 1)
            self.add_module(f"block_{ind}", block)
            if resolution in attn_res_layers:
                self.add_module(f"attn_{ind}", Attention(cout, use_flash=False))
                self.attn_blocks.add(ind)
            resolution //= 2
        last = dims[-1]
        self.to_logits_conv = nn.Conv2d(last, last, 3, padding=1)
        h, w = self.image_hw
        down = 2 ** (self.num_blocks - 1)
        self.to_logits = nn.Linear(last * (h // down) * (w // down), 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.to_logits.weight.dtype

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        features = []
        for ind in range(self.num_blocks):
            x = getattr(self, f"block_{ind}")(x)
            if ind in self.attn_blocks:
                b, c, H, W = x.shape
                flat = x.permute(0, 2, 3, 1).reshape(b, H * W, c)
                flat = getattr(self, f"attn_{ind}")(flat) + flat
                x = flat.reshape(b, H, W, c).permute(0, 3, 1, 2)
            features.append(x.permute(0, 2, 3, 1))
        x = F.leaky_relu(conv2d(x, self.to_logits_conv), 0.1)
        logits = linear(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), self.to_logits)[:, 0]
        return (logits, features) if return_features else logits
