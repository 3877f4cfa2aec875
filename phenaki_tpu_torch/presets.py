"""Flagship presets (counterpart of phenaki_tpu/presets.py): the reference's
8 heads x 64 head shape, or with `tpu_native=True` the TPU package's 4 heads
x 128 for the MaskGit and the TokenCritic (the same inner width 512, so
every projection keeps its shape; only the CPB MLP, whose width follows
d_head, and the QK-norm scales change). The C-ViViT keeps 8 x 64.

C-ViViT: dim 512, 256x128 frames, patch 16, temporal patch 2, spatial and
temporal depth 4, 8 heads x 64, LFQ with 65,536 codes: 17 frames decode from
9 latent frames x 16x8 = 1152 tokens. MaskGit: dim 512, depth 6, 8 x 64,
vocab 65,536, max_seq_len 1152, dim_context 768 (t5-v1_1-base), max text
length 128. TokenCritic: the MaskGit trunk's shape with cross-attention and
a scalar head. Sampling: 18 steps.

`flagship_phenaki` builds the sampling model (bf16 weights);
`flagship_train_phenaki` the training one: the MaskGit's and the critic's
f32 parameters with bf16 compute, as the TPU package's flagship trains
(`dtype=jnp.bfloat16`), and the frozen C-ViViT in bf16, the TPU package's
flagship C-ViViT dtype, so that raw pixels are tokenized in bf16.
`flagship_cvivit(dtype=torch.bfloat16)` with f32 weights is the flagship's
training C-ViViT (the TPU package trains it with `dtype=jnp.bfloat16`);
`flagship_train_cvivit` builds it with seeded weights on a device.
`critic=True` adds a TokenCritic, `self_token_critic=True` a SelfCritic on
the MaskGit's trunk; the C-ViViT and MaskGit weights do not change with
either (the critic's are drawn after them). The C-ViViT's encoder
(`CViViT.encoder_modules`) is drawn last of all, so every other weight is
what it was before the port had an encoder.
"""

from __future__ import annotations

import torch
from torch import nn

from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters

FLAGSHIP_IMAGE_SIZE = (256, 128)
FLAGSHIP_NUM_FRAMES = 17
FLAGSHIP_TEXT_DIM = 768


def flagship_cvivit(**overrides) -> CViViT:
    cfg = dict(dim=512, codebook_size=65536, image_size=FLAGSHIP_IMAGE_SIZE, patch_size=16,
               temporal_patch_size=2, spatial_depth=4, temporal_depth=4, dim_head=64, heads=8)
    cfg.update(overrides)
    return CViViT(**cfg)


def flagship_train_cvivit(seed: int = 0, *, device="cuda") -> CViViT:
    """The flagship C-ViViT for GAN training (`CViViTTrainer`): f32 weights,
    drawn on the CPU from `torch.Generator().manual_seed(seed)` in module
    order, on `device`, computing in bf16."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flagship_train_cvivit(device='cuda'): torch.cuda.is_available() is False")
    with torch.device("meta"):
        cvivit = flagship_cvivit(dtype=torch.bfloat16)
    cvivit = init_parameters(cvivit.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    return cvivit.to(device)


def _head_shape(tpu_native: bool) -> dict:
    return dict(heads=4, dim_head=128) if tpu_native else dict(heads=8, dim_head=64)


def flagship_maskgit(max_seq_len: int = 1152, *, tpu_native: bool = False, **overrides) -> MaskGit:
    cfg = dict(dim=512, num_tokens=65536, max_seq_len=max_seq_len, depth=6,
               dim_context=FLAGSHIP_TEXT_DIM, **_head_shape(tpu_native))
    cfg.update(overrides)
    return MaskGit(**cfg)


def flagship_token_critic(max_seq_len: int = 1152, *, tpu_native: bool = False,
                          **overrides) -> TokenCritic:
    cfg = dict(dim=512, num_tokens=65536, max_seq_len=max_seq_len, depth=6, has_cross_attn=True,
               dim_context=FLAGSHIP_TEXT_DIM, **_head_shape(tpu_native))
    cfg.update(overrides)
    return TokenCritic(**cfg)


def flagship_phenaki(seed: int = 0, *, device="cuda", dtype=torch.bfloat16,
                     num_frames: int = FLAGSHIP_NUM_FRAMES, steps: int = 18, critic: bool = False,
                     self_token_critic: bool = False, seq_group=None, mesh=None,
                     tpu_native: bool = False) -> Phenaki:
    """The flagship Phenaki with seeded random weights on `device`.

    Weights are drawn in f32 on the CPU from `torch.Generator().manual_seed(seed)`
    (so a seed gives the same weights on every machine), then moved to
    `device` and `dtype`. `seq_group` makes the MaskGit's self-attention
    sequence-parallel over that process group (every rank builds the same
    model and runs the same calls). `mesh` (a `parallel.mesh.Mesh` with
    tp > 1) returns this rank's tensor-parallel Phenaki (`Phenaki.tp_shard`),
    for `sample(mesh=)` and `PhenakiServer(mesh=)`; the trainers take the
    whole model and shard it themselves. `tpu_native` builds the MaskGit and
    the critic at 4 heads x 128 (module docstring)."""
    ph = _seeded_flagship(seed, device, dtype, num_frames, steps, None, critic, self_token_critic,
                          seq_group, cvivit_dtype=dtype, tpu_native=tpu_native)
    return ph.tp_shard(mesh) if mesh is not None else ph


def flagship_train_phenaki(seed: int = 0, *, device="cuda", num_frames: int = FLAGSHIP_NUM_FRAMES,
                           critic: bool = False, self_token_critic: bool = False,
                           seq_group=None, tpu_native: bool = False, remat: bool = False) -> Phenaki:
    """The flagship Phenaki for training: the same seeded weights as
    `flagship_phenaki`, the MaskGit's and the critic's kept in f32 and
    computing in bf16, the frozen C-ViViT's in bf16; `seq_group` and
    `tpu_native` as for `flagship_phenaki`; `remat` recomputes the MaskGit's
    and the critic's attention and FF blocks in the backward."""
    return _seeded_flagship(seed, device, torch.float32, num_frames, 18, torch.bfloat16, critic,
                            self_token_critic, seq_group, cvivit_dtype=torch.bfloat16,
                            tpu_native=tpu_native, remat=remat)


def _seeded_flagship(seed, device, dtype, num_frames, steps, compute_dtype, critic,
                     self_token_critic, seq_group, *, cvivit_dtype, tpu_native=False,
                     remat=False) -> Phenaki:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flagship_phenaki(device='cuda'): torch.cuda.is_available() is False")
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        cvivit = flagship_cvivit()
        n = cvivit.num_tokens_per_frames(num_frames)
        trunk = dict(dtype=compute_dtype, tpu_native=tpu_native, remat=remat)
        modules = [cvivit, flagship_maskgit(max_seq_len=n, seq_group=seq_group, **trunk)]
        if critic:
            modules.append(flagship_token_critic(max_seq_len=n, **trunk))
        elif self_token_critic:
            modules.append(nn.Linear(512, 1))  # the SelfCritic's head, to_pred
    modules = [m.to_empty(device="cpu") for m in modules]
    encoder = cvivit.encoder_modules()
    for i, m in enumerate(modules):
        init_parameters(m, gen, skip=encoder if i == 0 else ())
    for m in encoder:
        init_parameters(m, gen)
    # every weight is drawn in f32 above; only the casts below differ by preset
    dtypes = [cvivit_dtype] + [dtype] * (len(modules) - 1)
    modules = [m.to(device=device, dtype=t) for m, t in zip(modules, dtypes)]
    ph = Phenaki(maskgit=modules[1], cvivit=modules[0], text_embed_dim=FLAGSHIP_TEXT_DIM,
                 steps=steps, max_text_len=128, critic=modules[2] if critic else None,
                 self_token_critic=self_token_critic)
    if self_token_critic:
        ph.critic.to_pred.load_state_dict(modules[2].state_dict())
    return ph
