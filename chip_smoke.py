#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship sampling and training paths, with
and without a critic, on one NVIDIA GPU.

    python3 chip_smoke.py                         # every check; the last line is the verdict
    python3 chip_smoke.py --profile-train OUT.txt  # the same, and a profile of two
                                                  # flagship train steps written to OUT.txt
    python3 chip_smoke.py --profile-seq OUT.txt    # and a profile of one sequence-sharded
                                                  # flagship sample (rank 0) written to OUT.txt
    python3 chip_smoke.py --profile-sample OUT.txt # and a profile of three b = 1 flagship
                                                  # samples written to OUT.txt
    python3 chip_smoke.py --profile-scene OUT.txt  # and a profile of three primed flagship
                                                  # scenes (16 frames after 5) written to OUT.txt
    python3 chip_smoke.py --profile-tokenize OUT.txt  # and a profile of three B = 32
                                                  # tokenize calls written to OUT.txt
    python3 chip_smoke.py --profile-gan OUT        # and profiles of a C-ViViT GAN step without
                                                  # and with the R1 penalty, OUT.{without,with}_penalty.txt
    python3 chip_smoke.py --profile-serving OUT.txt  # and a profile of three bare b = 8 flagship
                                                  # samples (a served launch) written to OUT.txt
    python3 chip_smoke.py --profile-tp OUT.txt     # and a profile of one tp = 2 flagship sample
                                                  # (rank 0, with the all-reduces' host share)

Builds the CUDA kernels of phenaki_tpu_torch from csrc/ with nvcc (and
checks that the SASS of the bf16 attention forward, its dQ, dK/dV and dBias
kernels, the projection sampler and the fused CE's forward, dh and dW
kernels holds wgmma), holds each
kernel against its plain PyTorch version at the flagship shapes (the
flash-attention forward and its three backward kernels (these also at the
C-ViViT's spatial shape in a GAN train step), the projection
sampler, the fused cross-entropy forward and its two backward kernels, the
logits-path sampler, PEG's stencil (`check_peg`: the MaskGit's and the
C-ViViT decoder's shapes), the norm kernels (`check_norms`) and the
feedforward's GEGLU GEMM (`check_ff`); the attention forward also at the C-ViViT encoder's
tokenize shape, the primed MaskGit's and the served batches', the
projection sampler also on the strided scene rows of primed embeddings and
at a served bucket 8), checks small fp32 models sampled and trained on the
card against the same models on the CPU (with and without a critic, and on
the logits path; a small discriminator's R1 penalty and its second-order
gradients, which launch no kernel), overfits tests/test_learning.py's small
C-ViViT on one batch on the card (the recon loss must fall below 0.7 of its
first and the PSNR rise), and drives the flagship model (random weights from a
seed) through its entry points: `flagship_phenaki(...).sample(...)` plain,
with a TokenCritic and with a SelfCritic; the logits path of
`maskgit_sample_loop`; and `PhenakiTrainer(...).train_step()` on seeded
random token ids, without a critic and with a TokenCritic. The 4 heads x
128 flagship (`tpu_native=True`: kernel 1 and kernels 4-6 at d = 128) is
sampled and trained beside the 8 x 64 one, and the 8 x 64 trainer runs
again with `remat=True` on the MaskGit (the same losses, a lower peak,
kernel 1 twice for each attention call). Then the
primed flagship (`flagship_phenaki(num_frames=21)`): `CViViT.tokenize` of
B = 32 videos of 17 x 256 x 128 (videos/s over two windows of back-to-back
calls, the median call, peak memory; an f32 copy of the C-ViViT on the card
against one on the CPU), `make_video` of 17 hash-encoded texts into 273
frames, each scene after the first primed with the last 5 frames of the one
before (the seconds of two bare calls; seconds, prime tokenize ms and
launches a scene from an instrumented pass between them), and
`sample_images`. Then serving: the flagship behind `PhenakiServer` as the
TPU package's bench.py serves it (prewarmed, 24 requests at once into bucket-8
launches: served videos/s beside the bare b = 8 and b = 1 sample, request
latencies, each launch's delivery lag), uint8 against float32 output,
multi-scene video requests and an uploaded prime on the primed flagship,
`serve_http`, and a TokenCritic server; every future's result is read.
A small fp32 model built with the reference checkpoints' quirks
(`reference_attention_kv`, `peg_reference_layout`) is held card vs CPU
beside the plain one. Then the raw train path: `PhenakiTrainer(
flagship_train_phenaki(), dataset=...)` on 8 seeded GIFs of 17 x 256 x 128
written and read back by the port's codecs and `VideoDataset`, each with a
caption (the data wait, tokenize's device time and the step's beside it),
5 steps at b = 4 whose first milestone samples 4 GIFs and saves a
checkpoint, and a trainer resumed from a checkpoint that must take the
same two steps, bit for bit, as one that ran on. Then the C-ViViT GAN
train path: `CViViTTrainer(flagship_train_cvivit(), dataset=...)` on 8
seeded GIFs, b = 4, a discriminator of base dim 64 and the R1 penalty every
4th step (seconds a step with and without it, GAN videos/s, the
reconstructions and checkpoint of step 0, profiled device ms), and a
trainer loaded from a checkpoint whose next step must be bit-equal to the
live one's. Then the sequence-parallel paths on SP = 2 spawned ranks (NCCL with a GPU a rank
when there are enough cards, otherwise gloo with both ranks on the one
card): kernel 3 (the ring chunk) and the offset backward kernels against
their plain versions, a small fp32 sequence-sharded model against dense,
and `flagship_phenaki(seq_group=...).sample(...)` and
`PhenakiTrainer.train_step()` on `flagship_train_phenaki(seq_group=...)`,
with ids and parameters bit-identical across the ranks. Then the mesh paths
on MESH = 2 spawned ranks (gloo, both on the one card when it is alone):
`sample(mesh=)` at tp = 2 (ids identical across ranks, beside the dense
sample) and at dp = 2 (each rank's row bit-equal alone), a small fp32 tp =
2 model against the CPU, `PhenakiTrainer` at dp = 2, with FSDP and at tp = 2
(first loss against one process on the global batch of 8, FSDP's
consolidated parameters against DDP's), a consolidated checkpoint written at
dp = 2 and loaded at tp = 2 and a bit-equal resume, `CViViTTrainer` at dp =
2, and `PhenakiServer(mesh=)` at tp = 2; kernels 1 and 4-6 are also held at
a tp rank's 4-head shapes, and kernels 4-6 at a pipeline microbatch's 2
rows. The same ranks train a small fp32 model at pp =
2 against the CPU, and the flagship at pp = 2 in 4 microbatches
(`PhenakiTrainer(pp=2, pipeline_microbatches=4)`: the first loss against one
process's, exact launches a rank and step, peak memory with and without
the whole Phenaki rank 0 keeps for its milestones, the trunk's bytes a
rank, a bit-equal resume from its consolidated checkpoint); at tp = 2 each
rank holds its 32,768 rows of the vocab head, and the head's gather is
timed. Then FSDP_PIPE_RANKS = 4 spawned ranks at dp 2 x pp 2 (gloo, all on
the one card when it is alone): a small fp32 FSDP model against one process
(losses, parameters and every step-1 gradient), and the flagship trained in 4 microbatches without FSDP and with it
(`PhenakiTrainer(mesh=make_mesh(dp=2, pp=2), fsdp=True)`: the first loss
against one process's, exact launches a rank, peak memory, parameter and
Adam bytes a rank beside the run without FSDP, a bit-equal resume). Before the
flagship paths, the T5 encoder stack at t5-v1_1-base's width is held card
vs CPU, and examples/e2e_smoke_torch.py runs on the card. Each main path is
checked to have launched exactly its kernels. Every check raises on
failure; the last line is the JSON verdict, printed only when all passed.
Needs no JAX.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FLASH_TPU = "phenaki_tpu/ops/pallas_attention.py:79"  # _flash_kernel
PROJ_TPU = "phenaki_tpu/ops/pallas_sampling.py:220"  # _proj_kernel
FLASH_SRC = "phenaki_tpu_torch/csrc/flash_attention.cu"
PROJ_SRC = "phenaki_tpu_torch/csrc/proj_sample.cu"
BWD_SRC = "phenaki_tpu_torch/csrc/flash_attention_bwd.cu"
BWD_TPU = {"dq": "phenaki_tpu/ops/pallas_attention.py:458",  # _bwd_dq_kernel
           "dkv": "phenaki_tpu/ops/pallas_attention.py:500",  # _bwd_dkv_kernel
           "dbias": "phenaki_tpu/ops/pallas_attention.py:550"}  # _bwd_dbias_kernel
CE_SRC = "phenaki_tpu_torch/csrc/fused_ce.cu"
CE_TPU = {"ce_fwd": "phenaki_tpu/ops/pallas_ce.py:123",  # _fwd_kernel
          "ce_dh": "phenaki_tpu/ops/pallas_ce.py:219",  # _bwd_dh_kernel
          "ce_dw": "phenaki_tpu/ops/pallas_ce.py:240"}  # _bwd_dw_kernel

GUMBEL_SRC = "phenaki_tpu_torch/csrc/gumbel_sample.cu"
GUMBEL_TPU = "phenaki_tpu/ops/pallas_sampling.py:33"  # _kernel
PEG_SRC = "phenaki_tpu_torch/csrc/peg_stencil.cu"
PEG_TPU = None  # no TPU kernel: XLA's 27-tap loop, phenaki_tpu/ops/positional.py:24 depthwise3x3x3
NORMS_SRC = "phenaki_tpu_torch/csrc/norms.cu"
NORMS_TPU = None  # no TPU kernel: XLA fuses phenaki_tpu/ops/norms.py and the head split
FF_SRC = "phenaki_tpu_torch/csrc/geglu_gemm.cu"
FF_TPU = None  # no TPU kernel: XLA fuses phenaki_tpu/ops/feedforward.py's GEGLU into the product
CHUNK_TPU = "phenaki_tpu/ops/pallas_attention.py:812"  # flash_attend_chunk (_flash_kernel, offs_ref)

# the H100 SXM's published peaks (NVIDIA's data sheet; dense tensor-core rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}

# kernel launches per flagship sample (every other kernel: none): 6 MaskGit
# layers x (self + cross attention) x 18 steps + 4 C-ViViT spatial layers
# (the seq-9 temporal attention takes the plain path), and one
# projection-sampling call a step. A critic (TokenCritic, or SelfCritic on
# the MaskGit trunk) adds 6 x 2 attention calls on every step but the last;
# the logits path samples with the logits-path kernel instead of the
# projection sampler. PEG's stencil: one launch a MaskGit (and critic) layer
# a forward, one a C-ViViT temporal layer (4 in the decoder, 4 in the
# encoder); its backward is PyTorch's, and `remat` does not recompute it.
# The norm kernels: a MaskGit or critic forward runs 6 layers x 4
# LayerNorms (the attention's, the cross-attention's and its text context's,
# the feedforward's) and the stack's final norm ("ln"), and 6 x 2 head splits
# ("qk"); a C-ViViT decoder or encoder 8 layers x 2 LayerNorms and its two
# stacks' final norms, and 8 head splits; the encoder also its four patch
# norms (at patch 16: 768 and 1536 wide, then 512). A forward autograd
# records launches them all the same (their backward is the plain version's
# derivative in PyTorch, and launches nothing). The GEGLU GEMM ("ff"): one
# launch a transformer layer's feedforward in every forward, autograd's too
# (its backward is PyTorch's products): 6 a MaskGit or critic forward, 8 a
# C-ViViT decoder or encoder (4 temporal and 4 spatial layers)
PEG_SAMPLE = 6 * 18 + 4
FF_FORWARD, FF_DECODE, FF_ENCODE = 6, 8, 8
FF_SAMPLE = 18 * FF_FORWARD + FF_DECODE
NORM_FORWARD = {"ln": 6 * 4 + 1, "qk": 6 * 2}
NORM_DECODE = {"ln": 8 * 2 + 2, "qk": 8}
NORM_ENCODE = {"ln": NORM_DECODE["ln"] + 4, "qk": NORM_DECODE["qk"]}
NORM_SAMPLE = {k: 18 * NORM_FORWARD[k] + NORM_DECODE[k] for k in NORM_FORWARD}
SAMPLE_LAUNCHES = {"fwd": 6 * 2 * 18 + 4, "proj": 18, "peg": PEG_SAMPLE, **NORM_SAMPLE, "ff": FF_SAMPLE}
CRITIC_SAMPLE_LAUNCHES = {"fwd": 6 * 2 * 18 + 6 * 2 * 17 + 4, "proj": 18, "peg": PEG_SAMPLE + 6 * 17,
                          **{k: NORM_SAMPLE[k] + 17 * NORM_FORWARD[k] for k in NORM_FORWARD},
                          "ff": FF_SAMPLE + 17 * FF_FORWARD}
LOGITS_SAMPLE_LAUNCHES = {"fwd": 6 * 2 * 18 + 4, "gumbel": 18, "peg": PEG_SAMPLE, **NORM_SAMPLE, "ff": FF_SAMPLE}
# kernel launches per flagship train step (grad_accum_every = 1): 6 MaskGit
# layers x (self + cross attention) forward, dQ and dK/dV; dBias for the
# self-attention's CPB bias only; one fused CE forward, dh and dW. A
# TokenCritic adds its 6 x 2 attention calls each way (no position bias, so
# no dBias) and one projection sample of the generator's tokens
TRAIN_PER_STEP = {"fwd": 12, "dq": 12, "dkv": 12, "dbias": 6, "ce_fwd": 1, "ce_dh": 1, "ce_dw": 1, "peg": 6,
                  **NORM_FORWARD, "ff": FF_FORWARD}
CRITIC_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, fwd=24, dq=24, dkv=24, proj=1, peg=12,
                             **{k: 2 * NORM_FORWARD[k] for k in NORM_FORWARD}, ff=2 * FF_FORWARD)
TRAIN_BATCH, TRAIN_STEPS, CRITIC_TRAIN_STEPS = 4, 5, 3
# the 4 heads x 128 flagship (`tpu_native=True`) launches what the 8 x 64
# one does, kernel 1 and kernels 4-6 at d = 128 (dK/dV and dBias on wgmma,
# dQ on its f32 CUDA-core route); `remat=True` on the MaskGit recomputes each of its 12
# attention calls once in the backward, so kernel 1 launches twice each, and
# so do the layers' norm kernels (not the stack's final norm) and their
# feedforwards
TPU_NATIVE_TRAIN_STEPS = 3
REMAT_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, fwd=2 * TRAIN_PER_STEP["fwd"], ln=2 * NORM_FORWARD["ln"] - 1,
                            qk=2 * NORM_FORWARD["qk"], ff=2 * FF_FORWARD)
# a train path's losses beside "train path"'s: bit-equal is expected (the
# kernels are deterministic); the check allows this relative difference, and
# the phase prints the largest one seen
REMAT_LOSS_RTOL = 1e-3
# each sample and train path's summary numbers by label, for the phases that
# print one path beside another
PATH_NUMBERS = {}
# the tokenize path: the flagship C-ViViT on B = 32 videos of 17 frames; a
# call launches kernel 1 once for each of the encoder's 4 spatial layers
# (its temporal attention, over 9 latent frames, takes the plain path)
TOKENIZE_BATCH, TOKENIZE_CALLS = 32, 5
TOKENIZE_LAUNCHES = {"fwd": 4, "peg": 4, **NORM_ENCODE, "ff": FF_ENCODE}
# the long video: 17 scenes, the first of 17 frames, each later one 16 new
# frames primed with the previous scene's last 5 (3 latent frames, 384
# tokens, in front of the scene's 1024). Scene 1 launches what a 17-frame
# sample does; a primed scene adds the prime's tokenize (4 encoder spatial
# layers), and its decode of 11 latent frames is one call a spatial layer
LONG_VIDEO_FRAMES = (17,) + (16,) * 16
LONG_VIDEO_PRIME = 5
PRIMED_SCENE_LAUNCHES = {"fwd": 6 * 2 * 18 + 4 + 4, "proj": 18, "peg": PEG_SAMPLE + 4,
                         **{k: NORM_SAMPLE[k] + NORM_ENCODE[k] for k in NORM_FORWARD}, "ff": FF_SAMPLE + FF_ENCODE}
# sample_images: one latent frame of 128 tokens, decoded by one frame
IMAGE_LAUNCHES = {"fwd": 6 * 2 * 18 + 4, "proj": 18, "peg": PEG_SAMPLE, **NORM_SAMPLE, "ff": FF_SAMPLE}
# the sequence-sharded flagship over SP ranks (1152 / 2 = 576 rows a rank):
# a sample launches, on each rank, 2 ring chunks (kernel 3) for each of the 6
# MaskGit self-attention layers on each of the 18 steps; cross-attention (6 x
# 18) and the C-ViViT spatial layers (4) stay on kernel 1; the C-ViViT
# temporal attention (9 frames, indivisible by 2) takes the dense path. A
# train step: 12 chunks forward, each chunk's dq, dkv and dbias backward,
# and the cross-attention's kernel 1 forward, dq and dkv. Every rank runs
# the whole forward outside attention, PEG's stencil among it
SP = 2
SEQ_SAMPLE_LAUNCHES = {"chunk": 18 * 6 * SP, "fwd": 18 * 6 + 4, "proj": 18, "peg": PEG_SAMPLE, **NORM_SAMPLE,
                       "ff": FF_SAMPLE}
SEQ_TRAIN_PER_STEP = {"chunk": 6 * SP, "fwd": 6, "dq": 6 + 6 * SP, "dkv": 6 + 6 * SP, "dbias": 6 * SP,
                      "ce_fwd": 1, "ce_dh": 1, "ce_dw": 1, "peg": 6, **NORM_FORWARD, "ff": FF_FORWARD}
SEQ_TRAIN_STEPS = 3
RANK_TIMEOUT_S = 600  # the spawned ranks' join timeout
# the mesh paths (data, fully sharded and tensor parallelism) on MESH
# spawned ranks, gloo with both on the one card when it is alone: a rank of a
# tp = 2 mesh runs kernel 1 on 4 of the 8 heads, so a sample or a train step
# launches what the dense one does; a dp rank what the dense one does on its
# rows. The train paths take MESH_TRAIN_STEPS counted steps after the first
# (the milestone) at a global batch of MESH_TRAIN_BATCH (4 a dp rank); the
# C-ViViT GAN at dp = 2 a global batch of MESH_GAN_BATCH, the R1 penalty on
# step 0; the server at tp = 2 MESH_SERVE_REQUESTS requests in bucket 1
MESH = 2
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS = 8, 2
MESH_GAN_BATCH, MESH_GAN_STEPS = 4, 3
MESH_SERVE_REQUESTS = 2
# the pipeline train path on the mesh ranks: `PhenakiTrainer(pp=2,
# pipeline_microbatches=4)` on the flagship at the mesh paths' global batch
# of 8 (two rows a microbatch). Each rank holds 3 of the 6 MaskGit layers and
# runs them on all 4 microbatches: kernel 1 (self + cross attention), dQ and
# dK/dV 3 x 2 x 4 times a step, dBias (the self-attention's CPB bias) 3 x 4
# times; the loss runs on every rank's replicated output, as in the JAX
# package, so each rank launches the fused CE's three kernels once a step,
# and the stack's final norm after its layers' 4 LayerNorms and 2 head splits
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_TRAIN_STEPS = 2, 4, 2
PIPE_STAGE_LAYERS = 6 // PIPE_STAGES
PIPE_ATTENTION_CALLS = PIPE_STAGE_LAYERS * 2 * PIPE_MICROBATCHES  # self + cross, each microbatch
PIPE_TRAIN_PER_STEP = {"fwd": PIPE_ATTENTION_CALLS, "dq": PIPE_ATTENTION_CALLS, "dkv": PIPE_ATTENTION_CALLS,
                       "dbias": PIPE_STAGE_LAYERS * PIPE_MICROBATCHES, "ce_fwd": 1, "ce_dh": 1, "ce_dw": 1,
                       "peg": PIPE_STAGE_LAYERS * PIPE_MICROBATCHES, "ln": PIPE_STAGE_LAYERS * 4 * PIPE_MICROBATCHES + 1,
                       "qk": PIPE_ATTENTION_CALLS, "ff": PIPE_STAGE_LAYERS * PIPE_MICROBATCHES}
# the FSDP x pipeline train path on FSDP_PIPE_RANKS spawned ranks (gloo, all
# on the one card when it is alone): `PhenakiTrainer(mesh=make_mesh(dp=2,
# pp=2), fsdp=True, pipeline_microbatches=4)` on the flagship at the mesh
# paths' global batch of 8. Each data row pipelines 2 of the 4 microbatches
# (two rows each), so a rank runs its stage's 3 layers on 2 microbatches:
# kernel 1, dQ and dK/dV 3 x 2 x 2 times a step, dBias 3 x 2 times, and the
# fused CE's three kernels once on its 4 rows
FSDP_PIPE_RANKS, FSDP_PIPE_DP = 4, 2
FSDP_PIPE_STEPS = 3
FSDP_PIPE_MB_LOCAL = PIPE_MICROBATCHES // FSDP_PIPE_DP
FSDP_PIPE_TRAIN_PER_STEP = {
    "fwd": PIPE_STAGE_LAYERS * 2 * FSDP_PIPE_MB_LOCAL, "dq": PIPE_STAGE_LAYERS * 2 * FSDP_PIPE_MB_LOCAL,
    "dkv": PIPE_STAGE_LAYERS * 2 * FSDP_PIPE_MB_LOCAL, "dbias": PIPE_STAGE_LAYERS * FSDP_PIPE_MB_LOCAL,
    "ce_fwd": 1, "ce_dh": 1, "ce_dw": 1, "peg": PIPE_STAGE_LAYERS * FSDP_PIPE_MB_LOCAL,
    "ln": PIPE_STAGE_LAYERS * 4 * FSDP_PIPE_MB_LOCAL + 1, "qk": PIPE_STAGE_LAYERS * 2 * FSDP_PIPE_MB_LOCAL,
    "ff": PIPE_STAGE_LAYERS * FSDP_PIPE_MB_LOCAL}
# the C-ViViT overfit check: tests/test_learning.py's C-ViViT, recon-only,
# 30 Adam steps at lr 3e-3 on one batch, f32 on the card; the last recon loss
# must be below 0.7 of the first and the reconstruction PSNR must rise
OVERFIT_CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
                      spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
OVERFIT_STEPS, OVERFIT_LR, OVERFIT_DROP = 30, 3e-3, 0.7
# the T5 encoder stack at t5-v1_1-base's width (12 layers, d 768, 12 heads,
# d_ff 2048, vocab 32128) with seeded random weights, f32 on the card against
# the CPU: 8 sequences of 128 ids with a padding mask
T5_BATCH, T5_LEN, T5_TOL = 8, 128, 1e-3
LEARN_MARGIN = 3.0  # nats the learning check's loss must fall by
# every trainer samples and checkpoints at its step-1 milestone; the paths
# that measure steps sample one video there, with this caption
SAMPLE_TEXT = "a red ball rolls across a green field"
# the raw train path: 8 seeded GIFs of 17 x 256 x 128 read back through
# VideoDataset, each with a caption; 5 steps at b = 4, the first of them the
# milestone, which samples 4 videos (one b = 4 group: the launches of one
# flagship sample) and saves a checkpoint. A step launches what a train step
# on ids does, and the C-ViViT's tokenize of the batch (kernel 1 in its 4
# spatial layers). Then the resume check: 2 steps on a fixed dataset
RAW_VIDEOS, RAW_TRAIN_STEPS, RAW_SAMPLES, RESUME_STEPS = 8, 5, 4, 2
RAW_CAPTIONS = [f"clip {k}: a ball bounces {k + 1} times on a wooden floor" for k in range(RAW_VIDEOS)]
RAW_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, fwd=TRAIN_PER_STEP["fwd"] + TOKENIZE_LAUNCHES["fwd"],
                          peg=TRAIN_PER_STEP["peg"] + TOKENIZE_LAUNCHES["peg"],
                          **{k: TRAIN_PER_STEP[k] + NORM_ENCODE[k] for k in NORM_FORWARD},
                          ff=TRAIN_PER_STEP["ff"] + TOKENIZE_LAUNCHES["ff"])
MILESTONE_LAUNCHES = SAMPLE_LAUNCHES


# the C-ViViT GAN train path: the flagship C-ViViT (f32 weights, bf16
# compute) and a discriminator of base dim 64 (blocks of 256 and 512
# channels; attention at 16 x 8 positions) trained by CViViTTrainer at b = 4
# on 8 seeded GIFs, the R1 penalty on every 4th step (0, 4, 8, ...). A step
# launches kernel 1 in the 4 encoder and 4 decoder spatial layers (9 latent
# frames of 16 x 8 tokens a video: (36, 8, 128, 64)) of the generator
# phase's forward, and again in the discriminator phase's reconstruction
# (no gradient), and dQ, dK/dV and dBias (the CPB is trained) once each in
# the 8 spatial layers of the generator phase's backward. The temporal
# attention (9 latent frames) and the discriminator's attention take the
# plain path; the adaptive weight's gradients stop at the pixel heads. Step
# 0 also reconstructs a batch with the EMA and the raw parameters (8
# forward launches each) and checkpoints. PEG's stencil runs once in each of
# the 4 encoder and 4 decoder temporal layers of each forward. The norm
# kernels run in every C-ViViT forward (the generator phase's and the
# reconstructions), and once in each of the discriminator's calls on its one
# attention block: the generator phase's perceptual features of the real
# frame (without a gradient) and of the reconstructed one, and its logits of
# the reconstructed one; the discriminator phase's logits of the fake and of
# the real frame; on a penalty step once more, the R1 penalty's logits
GAN_BATCH, GAN_STEPS, GAN_PENALTY_EVERY = 4, 8, 4
GAN_RECON_LAUNCHES = {"fwd": 8, "peg": 8, **{k: NORM_ENCODE[k] + NORM_DECODE[k] for k in NORM_FORWARD},
                      "ff": FF_ENCODE + FF_DECODE}
GAN_PER_STEP = {"fwd": 16, "dq": 8, "dkv": 8, "dbias": 8, "peg": 16,
                **{k: 2 * GAN_RECON_LAUNCHES[k] + 5 for k in NORM_FORWARD}, "ff": 2 * GAN_RECON_LAUNCHES["ff"]}
GAN_PENALTY_LAUNCHES = {"ln": 1, "qk": 1}


def gan_step_launches(step):
    """A GAN step's launches: GAN_PER_STEP, and the R1 penalty's on every
    GAN_PENALTY_EVERY-th step."""
    extra = GAN_PENALTY_LAUNCHES if step % GAN_PENALTY_EVERY == 0 else {}
    return {k: v + extra.get(k, 0) for k, v in GAN_PER_STEP.items()}


# serving (`PhenakiServer`): the plain flagship served as the TPU package's
# bench.py serves it, buckets (1, 8), a 40 ms coalescing window, seed 0:
# one warm request, then 24 seeded (50, 768) embeddings requests submitted
# at once, which coalesce into three bucket-8 launches. A launch at any
# bucket makes the launches of one flagship sample (a TokenCritic server's,
# a critic-guided sample's). The video requests run on the primed flagship
# (max_seq_len 1408): two 3-scene requests (17, 16 and 16 frames, each scene
# after the first primed with 5 frames) coalesce into bucket 2, and one
# 2-scene request continues an uploaded uint8 prime of 5 frames
SERVE_BUCKETS, SERVE_DELAY_MS, SERVE_REQUESTS = (1, 8), 40.0, 24
SERVE_LOG = [(1, 1)] + [(8, 8)] * 3
SERVE_VIDEO_FRAMES, SERVE_UPLOAD_FRAMES, SERVE_PRIME = (17, 16, 16), (16, 16), 5
SERVE_VIDEO_LOG = [(2, 2)] * 3 + [(1, 1)] * 2
SERVE_TIMEOUT_S = 600  # the longest any one served request may take


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def phase(name: str, **numbers) -> None:
    print(f"{name}: {json.dumps(numbers)}", flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of `fn` over `reps` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of `fn`, replayed from one CUDA graph of
    `reps` calls: the launches without the host's cost of issuing them. The
    Python wrapper of a forward kernel takes about as long to issue a call as
    the card takes to run it, so `cuda_ms` of back-to-back calls measures the
    host there."""
    import torch

    side = torch.cuda.Stream()  # warm up off the default stream, as torch.cuda.graphs asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, ops: float, kind: str = "bf16"):
    """The least time the card could take: (ms, what bounds it), from the
    bytes moved (each input read once, each output written once) and the
    operations done at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def qk(shape, gen, dtype):
    """l2-normalised vectors times per-dim scales: the kernel's input contract."""
    import torch

    t = torch.randn(shape, generator=gen)
    t = t / t.norm(dim=-1, keepdim=True) * (0.5 + 1.5 * torch.rand(shape[-1], generator=gen))
    return t.to("cuda", dtype)


# the backward kernels' timed shapes (the train steps'), and those also
# given bounds and SDPA's whole backward beside them
BWD_TIMED_SHAPES = ("maskgit_self", "critic_self", "maskgit_cross", "cvivit_spatial_b4", "maskgit_self_tp2",
                    "maskgit_cross_tp2", "maskgit_self_mb2", "maskgit_cross_mb2", "tpu_native_self",
                    "tpu_native_cross")
BWD_YARDSTICK_SHAPES = ("maskgit_self", "cvivit_spatial_b4", "maskgit_self_tp2", "maskgit_self_mb2",
                        "tpu_native_self", "tpu_native_cross")
# kernel 1's main-path shapes: each is timed beside its bound and one SDPA
# call on the same inputs
FLASH_MAIN_SHAPES = ("maskgit_self", "maskgit_cross", "cvivit_spatial", "critic_self",
                     "cvivit_encode_spatial_b4", "cvivit_encode_spatial_b32", "maskgit_self_primed",
                     "maskgit_self_b8", "maskgit_cross_b8", "maskgit_self_primed_b2",
                     "maskgit_self_tp2", "maskgit_cross_tp2", "tpu_native_self", "tpu_native_cross",
                     "tpu_native_train_self")


def flash_cases(torch, dtype, gen):
    """The flagship shapes at b = 1 (CFG stacks 2 rows): MaskGit
    self-attention with the CPB bias, the TokenCritic's self-attention
    without one, cross-attention, the C-ViViT's spatial attention, its
    encoder's at the raw train step's b = 4 and at tokenize B = 32, the
    primed MaskGit self-attention; the served batches' shapes (MaskGit self-
    and cross-attention at bucket 8, the primed self-attention at bucket 2);
    the cross-attention with every key of one batch row hard-masked (out = 0,
    lse = -inf), a causal case, ragged tiles (i = j = 1000 with a bias),
    d = 128 with ragged tiles, the 4 heads x 128 flagship's (`tpu_native`)
    sample and train shapes, and d = 128 on a grid large enough for the
    one-stage ring with ragged tiles, a bias, a key mask and causal."""
    from phenaki_tpu_torch.ops.attention import NEG_INF
    from phenaki_tpu_torch.ops.positional import alibi_bias

    cases = {}
    q, k = qk((2, 8, 1152, 64), gen, dtype), qk((2, 8, 1152, 64), gen, dtype)
    v = torch.randn(2, 8, 1152, 64, generator=gen).to("cuda", dtype)
    bias = torch.randn(8, 1152, 1152, generator=gen).to("cuda", dtype)
    cases["maskgit_self"] = (q, k, v, bias, None, False)
    cases["critic_self"] = (q, k, v, None, None, False)
    kc, vc = qk((2, 8, 130, 64), gen, dtype), torch.randn(2, 8, 130, 64, generator=gen).to("cuda", dtype)
    keep = torch.rand(2, 130, generator=gen) > 0.3
    keep[:, :2] = True
    keep[1, 2:] = False  # the null branch of CFG: only the null-KV columns
    kmask = torch.where(keep, 0.0, NEG_INF).float().cuda()
    cases["maskgit_cross"] = (q, kc, vc, None, kmask, False)
    dead = kmask.clone()
    dead[1] = NEG_INF  # batch row 1 attends no key
    cases["masked_batch_row"] = (q, kc, vc, None, dead, False)
    qs, ks = qk((9, 8, 128, 64), gen, dtype), qk((9, 8, 128, 64), gen, dtype)
    vs = torch.randn(9, 8, 128, 64, generator=gen).to("cuda", dtype)
    cases["cvivit_spatial"] = (qs, ks, vs, torch.randn(8, 128, 128, generator=gen).to("cuda", dtype), None, False)
    # the C-ViViT encoder's spatial attention at tokenize B = 32 (9 latent
    # frames a video), and the MaskGit's self-attention over a primed scene
    # (384 prime + 1024 scene tokens)
    qe, ke = qk((288, 8, 128, 64), gen, dtype), qk((288, 8, 128, 64), gen, dtype)
    ve = torch.randn(288, 8, 128, 64, generator=gen).to("cuda", dtype)
    cases["cvivit_encode_spatial_b32"] = (qe, ke, ve, torch.randn(8, 128, 128, generator=gen).to("cuda", dtype),
                                          None, False)
    qp, kp = qk((2, 8, 1408, 64), gen, dtype), qk((2, 8, 1408, 64), gen, dtype)
    vp = torch.randn(2, 8, 1408, 64, generator=gen).to("cuda", dtype)
    cases["maskgit_self_primed"] = (qp, kp, vp, torch.randn(8, 1408, 1408, generator=gen).to("cuda", dtype),
                                    None, False)
    qa, ka = qk((2, 8, 256, 64), gen, dtype), qk((2, 8, 320, 64), gen, dtype)
    va = torch.randn(2, 8, 320, 64, generator=gen).to("cuda", dtype)
    cases["causal_alibi"] = (qa, ka, va, alibi_bias(8, 256, 320, device="cuda").to(dtype), None, True)
    qr, kr = qk((2, 8, 1000, 64), gen, dtype), qk((2, 8, 1000, 64), gen, dtype)
    vr = torch.randn(2, 8, 1000, 64, generator=gen).to("cuda", dtype)
    cases["ragged_1000"] = (qr, kr, vr, torch.randn(8, 1000, 1000, generator=gen).to("cuda", dtype), None, False)
    qd, kd = qk((1, 4, 200, 128), gen, dtype), qk((1, 4, 200, 128), gen, dtype)
    vd = torch.randn(1, 4, 200, 128, generator=gen).to("cuda", dtype)
    cases["dim_head_128"] = (qd, kd, vd, torch.randn(4, 200, 200, generator=gen).to("cuda", dtype), None, False)
    # the C-ViViT encoder's spatial attention in the raw train step's
    # tokenize (b = 4, 9 latent frames a video); drawn last, so that the
    # cases above keep their inputs
    q4, k4 = qk((36, 8, 128, 64), gen, dtype), qk((36, 8, 128, 64), gen, dtype)
    v4 = torch.randn(36, 8, 128, 64, generator=gen).to("cuda", dtype)
    cases["cvivit_encode_spatial_b4"] = (q4, k4, v4, torch.randn(8, 128, 128, generator=gen).to("cuda", dtype),
                                         None, False)
    # the served batches, drawn after the rest for the same reason: a
    # bucket-8 launch (16 CFG rows) of MaskGit self-attention with the bias
    # and of cross-attention over (50, 768) text requests (the conditioned
    # rows see the 2 null-KV columns and 50 tokens, the null rows the null
    # columns only), and a bucket-2 video launch's primed self-attention
    q8, k8 = qk((16, 8, 1152, 64), gen, dtype), qk((16, 8, 1152, 64), gen, dtype)
    v8 = torch.randn(16, 8, 1152, 64, generator=gen).to("cuda", dtype)
    cases["maskgit_self_b8"] = (q8, k8, v8, torch.randn(8, 1152, 1152, generator=gen).to("cuda", dtype),
                                None, False)
    kc8, vc8 = qk((16, 8, 130, 64), gen, dtype), torch.randn(16, 8, 130, 64, generator=gen).to("cuda", dtype)
    keep8 = torch.zeros(16, 130, dtype=torch.bool)
    keep8[:8, :52] = True
    keep8[8:, :2] = True
    cases["maskgit_cross_b8"] = (q8, kc8, vc8, None, torch.where(keep8, 0.0, NEG_INF).float().cuda(), False)
    qp2, kp2 = qk((4, 8, 1408, 64), gen, dtype), qk((4, 8, 1408, 64), gen, dtype)
    vp2 = torch.randn(4, 8, 1408, 64, generator=gen).to("cuda", dtype)
    cases["maskgit_self_primed_b2"] = (qp2, kp2, vp2,
                                       torch.randn(8, 1408, 1408, generator=gen).to("cuda", dtype), None, False)
    # a tp = 2 rank's share (heads 4-7 of 8): self-attention with its head
    # slice of the (8, 1152, 1152) bias read in place, and cross-attention
    q4h, k4h = qk((2, 4, 1152, 64), gen, dtype), qk((2, 4, 1152, 64), gen, dtype)
    v4h = torch.randn(2, 4, 1152, 64, generator=gen).to("cuda", dtype)
    bias8 = torch.randn(8, 1152, 1152, generator=gen).to("cuda", dtype)
    cases["maskgit_self_tp2"] = (q4h, k4h, v4h, bias8[4:], None, False)
    kc4, vc4 = qk((2, 4, 130, 64), gen, dtype), torch.randn(2, 4, 130, 64, generator=gen).to("cuda", dtype)
    cases["maskgit_cross_tp2"] = (q4h, kc4, vc4, None, kmask, False)
    # the 4 heads x 128 flagship (`tpu_native`): a sample's self-attention
    # with its (4, 1152, 1152) bias and its cross-attention over 130 keys
    # (b = 1, CFG stacks 2 rows), and a train step's self-attention (b = 4,
    # an all-zero key mask, as the loss gives it)
    qn, kn = qk((2, 4, 1152, 128), gen, dtype), qk((2, 4, 1152, 128), gen, dtype)
    vn = torch.randn(2, 4, 1152, 128, generator=gen).to("cuda", dtype)
    cases["tpu_native_self"] = (qn, kn, vn, torch.randn(4, 1152, 1152, generator=gen).to("cuda", dtype),
                                None, False)
    kcn, vcn = qk((2, 4, 130, 128), gen, dtype), torch.randn(2, 4, 130, 128, generator=gen).to("cuda", dtype)
    cases["tpu_native_cross"] = (qn, kcn, vcn, None, kmask, False)
    qt, kt = qk((4, 4, 1152, 128), gen, dtype), qk((4, 4, 1152, 128), gen, dtype)
    vt = torch.randn(4, 4, 1152, 128, generator=gen).to("cuda", dtype)
    cases["tpu_native_train_self"] = (qt, kt, vt, torch.randn(4, 1152, 1152, generator=gen).to("cuda", dtype),
                                      torch.zeros(4, 1152, device="cuda"), False)
    # d = 128 on a grid of 288 blocks, which takes the one-stage ring (the
    # train shape's): ragged tiles, a bias, a key mask and causal at once
    qw, kw = qk((18, 4, 200, 128), gen, dtype), qk((18, 4, 200, 128), gen, dtype)
    vw = torch.randn(18, 4, 200, 128, generator=gen).to("cuda", dtype)
    keep_w = torch.rand(18, 200, generator=gen) > 0.3
    keep_w[:, 0] = True  # every causal row sees a key
    cases["dim_head_128_one_stage"] = (qw, kw, vw, torch.randn(4, 200, 200, generator=gen).to("cuda", dtype),
                                       torch.where(keep_w, 0.0, NEG_INF).float().cuda(), True)
    return cases


# the wgmma kernels and their instances: the forward for kernels 1 and 3 at
# d = 64, and at d = 128 with a ring of one or two stages, the backward's dQ,
# dK/dV and dBias (kernels 4-6) at d = 64 and 128, the projection sampler's bf16
# kernel (kernel 2), the fused CE's bf16
# forward (kernel 7: h resident up to d = 512, streamed past it) and its dh
# and dW (kernels 8 and 9: whole tiles at d = 512, and the streamed ring
# with 128-, 256-, 384- and 512-column output chunks at every other d)
WGMMA_KERNELS = {"flash_fwd_wgmma_kernel": 2, "flash_fwd_wgmma_d128": 4, "flash_bwd_dq_wgmma": 2,
                 "flash_bwd_dkv_wgmma": 2,
                 "flash_bwd_dbias_wgmma": 2, "proj_wgmma_kernel": 4, "ce_fwd_wgmma_kernel": 2,
                 "ce_dh_wgmma_kernel": 5, "ce_dw_wgmma_kernel": 5, "geglu_gemm_kernel": 4}


def check_wgmma_build():
    """The wgmma kernels as built: ptxas's registers, spills and shared
    memory for each instance, from the build log, and the wgmma instructions
    (HGMMA) in each one's SASS, from cuobjdump. Fails if an instance is
    missing or holds none."""
    import shutil

    from phenaki_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    hgmma, fn = {kernel: {} for kernel in WGMMA_KERNELS}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            for kernel in WGMMA_KERNELS:
                if kernel in fn:
                    hgmma[kernel][fn] = 0
        elif "HGMMA" in line:
            for found in hgmma.values():
                if fn in found:
                    found[fn] += 1
    for kernel, instances in WGMMA_KERNELS.items():
        phase(f"{kernel} build", ptxas=_build.ptxas_report(kernel), hgmma=hgmma[kernel])
        check(len(hgmma[kernel]) == instances and all(hgmma[kernel].values()),
              f"{kernel}: HGMMA by instance {hgmma[kernel]}")


def check_flash(torch):
    """Kernel 1 against its plain version on every case, bf16 and f32: the
    output within a tolerance, the lse within 1e-3 where finite and -inf on
    the same rows. `ms` and `plain_ms` time back-to-back calls from Python,
    as every other kernel is timed; `graph_ms` replays the kernel's calls
    from one CUDA graph, its device time alone. At the main-path shapes in
    bf16 also the bound and SDPA's time by both methods (`library_ms`,
    `library_graph_ms`; the bias and the key mask, as a (b, 1, 1, j) mask in
    q's dtype, summed into its float mask)."""
    from phenaki_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator().manual_seed(1)
    # bf16: the plain version rounds the normalised probabilities to bf16
    # before the PV product, the kernel the unnormalised ones; outputs are
    # bf16 (2^-8 relative), held within 2e-2 or one bf16 ulp of the
    # reference, whichever is larger (the ulp only where |ref| >= 4)
    tol = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (q, k, v, bias, kmask, causal) in flash_cases(torch, dtype, gen).items():
            kw = dict(scale=8.0, causal=causal)
            out, lse = flash_attention(q, k, v, bias, kmask, return_lse=True, **kw)
            ref, ref_lse = flash_attention_plain(q, k, v, bias, kmask, return_lse=True, **kw)
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            # the tolerance, or one ulp of the bf16 reference where that is
            # larger (|ref| >= 4: there any rounding difference is 2^-5)
            ulp = torch.ldexp(torch.ones_like(diff), torch.frexp(ref.float().abs()).exponent - 8)
            allowed = ulp.clamp(min=tol[dtype]) if dtype == torch.bfloat16 else torch.full_like(diff, tol[dtype])
            over_tol = (diff - allowed).max().item()
            over_ratio = (diff / allowed).max().item()
            del diff, ulp, allowed
            dead = torch.isneginf(ref_lse)
            check(torch.equal(torch.isneginf(lse), dead), f"flash {tag}: lse is -inf on other rows")
            lse_err = (lse - ref_lse)[~dead].abs().max().item()
            if name == "masked_batch_row":
                check(bool(dead[1].all()) and not dead[0].any() and out[1].abs().max().item() == 0.0,
                      f"flash {tag}: the masked batch row is not out = 0, lse = -inf")
            entry = dict(max_abs_err=err, max_err_over_allowed=over_ratio, lse_max_abs_err=lse_err,
                         ms=cuda_ms(lambda: flash_attention(q, k, v, bias, kmask, **kw)),
                         graph_ms=graph_ms(lambda: flash_attention(q, k, v, bias, kmask, **kw)),
                         plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, bias, kmask, **kw), reps=5))
            if dtype == torch.bfloat16 and name in FLASH_MAIN_SHAPES:
                b, h, i, d = q.shape
                mask = bias
                if kmask is not None:  # the key mask as SDPA's float mask, on the bias where both are given
                    km = kmask[:, None, None, :].to(q.dtype)
                    mask = km if mask is None else mask + km
                entry["bound_ms"], entry["bound_by"] = bound(
                    nbytes(q, k, v, bias, kmask, out), 4 * b * h * i * k.shape[2] * d)
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, scale=8.0)
                entry["library_ms"], entry["library_graph_ms"] = cuda_ms(sdpa), graph_ms(sdpa)
            phase(f"flash_attention {tag}", shape=list(q.shape), j=k.shape[2], **entry)
            check(torch.isfinite(out).all().item(), f"flash {tag}: non-finite output")
            check(over_tol <= 0, f"flash {tag}: max abs err {err}, {over_ratio} of the allowed ({tol[dtype]})")
            check(lse_err <= 1e-3, f"flash {tag}: lse err {lse_err}")
            result[tag] = entry
    return result


def flash_bwd_cases(torch, dtype, gen):
    """The train shapes (b = 4): MaskGit self-attention with the CPB bias and
    an all-zero key mask, the TokenCritic's self-attention without a bias,
    cross-attention with a row that sees only the
    null-KV columns, the same with a row that sees no key at all (without a
    bias, and with an (8, 1152, 130) bias: ragged key tiles, dBias rows of
    130), a causal ALiBi case, d = 128 with ragged tiles, and the C-ViViT's
    spatial attention in the GAN train step (b = 4 videos x 9 latent frames
    of 16 x 8 tokens, with the trained (8, 128, 128) CPB bias); a tp = 2
    rank's self- and cross-attention (4 heads); a pipeline microbatch's
    (b = 2); and the 4 heads x 128 flagship's self- and cross-attention."""
    from phenaki_tpu_torch.ops.attention import NEG_INF
    from phenaki_tpu_torch.ops.positional import alibi_bias

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    cases = {}
    q, k, v = qk((4, 8, 1152, 64), gen, dtype), qk((4, 8, 1152, 64), gen, dtype), rand(4, 8, 1152, 64)
    cases["maskgit_self"] = (q, k, v, rand(8, 1152, 1152), torch.zeros(4, 1152, device="cuda"), False)
    cases["critic_self"] = (q, k, v, None, torch.zeros(4, 1152, device="cuda"), False)
    kc, vc = qk((4, 8, 130, 64), gen, dtype), rand(4, 8, 130, 64)
    keep = torch.rand(4, 130, generator=gen) > 0.3
    keep[:, :2] = True
    keep[1, 2:] = False  # the null branch of CFG: only the null-KV columns
    cases["maskgit_cross"] = (q, kc, vc, None, torch.where(keep, 0.0, NEG_INF).float().cuda(), False)
    keep[2] = False  # a row that attends no key: lse = -inf, out = 0, gradients 0
    cases["fully_masked_row"] = (q, kc, vc, None, torch.where(keep, 0.0, NEG_INF).float().cuda(), False)
    # the bias as the attention Function hands it on: rows of 136 (a multiple
    # of 8, for the 16-byte copies), its first 130 columns
    cases["fully_masked_row_bias"] = (q, kc, vc, rand(8, 1152, 136)[..., :130],
                                      torch.where(keep, 0.0, NEG_INF).float().cuda(), False)
    qa, ka, va = qk((2, 8, 256, 64), gen, dtype), qk((2, 8, 320, 64), gen, dtype), rand(2, 8, 320, 64)
    cases["causal_alibi"] = (qa, ka, va, alibi_bias(8, 256, 320, device="cuda").to(dtype), None, True)
    qd, kd, vd = qk((1, 4, 200, 128), gen, dtype), qk((1, 4, 200, 128), gen, dtype), rand(1, 4, 200, 128)
    cases["dim_head_128"] = (qd, kd, vd, rand(4, 200, 200), None, False)
    qs, ks, vs = qk((36, 8, 128, 64), gen, dtype), qk((36, 8, 128, 64), gen, dtype), rand(36, 8, 128, 64)
    cases["cvivit_spatial_b4"] = (qs, ks, vs, rand(8, 128, 128), None, False)
    # a tp = 2 rank's share at the train shape: 4 of the 8 heads, the bias
    # read in place as heads 4-7 of the (8, 1152, 1152) one; cross-attention
    q4, k4, v4 = qk((4, 4, 1152, 64), gen, dtype), qk((4, 4, 1152, 64), gen, dtype), rand(4, 4, 1152, 64)
    cases["maskgit_self_tp2"] = (q4, k4, v4, rand(8, 1152, 1152)[4:], torch.zeros(4, 1152, device="cuda"), False)
    kc4, vc4 = qk((4, 4, 130, 64), gen, dtype), rand(4, 4, 130, 64)
    cases["maskgit_cross_tp2"] = (q4, kc4, vc4, None, torch.where(keep, 0.0, NEG_INF).float().cuda(), False)
    # a pipeline microbatch of the train path (8 rows in 4 microbatches): 2
    # rows of self-attention with the bias, whose dBias sums the 2 rows, and
    # of cross-attention
    q2, k2, v2 = qk((2, 8, 1152, 64), gen, dtype), qk((2, 8, 1152, 64), gen, dtype), rand(2, 8, 1152, 64)
    cases["maskgit_self_mb2"] = (q2, k2, v2, rand(8, 1152, 1152), torch.zeros(2, 1152, device="cuda"), False)
    kc2, vc2 = qk((2, 8, 130, 64), gen, dtype), rand(2, 8, 130, 64)
    cases["maskgit_cross_mb2"] = (q2, kc2, vc2, None, torch.where(keep[:2], 0.0, NEG_INF).float().cuda(), False)
    # the 4 heads x 128 flagship's train step (`tpu_native`): self-attention
    # with the (4, 1152, 1152) bias and cross-attention (with the batch row
    # that sees no key); bf16 at d = 128 runs dQ, dK/dV and dBias on wgmma
    qn, kn, vn = qk((4, 4, 1152, 128), gen, dtype), qk((4, 4, 1152, 128), gen, dtype), rand(4, 4, 1152, 128)
    cases["tpu_native_self"] = (qn, kn, vn, rand(4, 1152, 1152), torch.zeros(4, 1152, device="cuda"), False)
    kcn, vcn = qk((4, 4, 130, 128), gen, dtype), rand(4, 4, 130, 128)
    cases["tpu_native_cross"] = (qn, kcn, vcn, None, torch.where(keep, 0.0, NEG_INF).float().cuda(), False)
    return cases


def check_flash_bwd(torch):
    """The three backward kernels against `flash_attention_backward_plain` on
    the same forward output, lse and cotangent; then autograd through
    `flash_attention` on the card (gradients reach q, k, v and the bias)."""
    import phenaki_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator().manual_seed(4)
    # error relative to max |ref|. f32: the two differ only in summation order
    # over up to 1152 terms. bf16: the plain version rounds p and dS to bf16
    # before the products (as the TPU kernels do), the kernels keep them in
    # f32, and dq/dk/dv are stored in bf16 (2^-8 relative)
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (q, k, v, bias, kmask, causal) in flash_bwd_cases(torch, dtype, gen).items():
            kw = dict(scale=8.0, causal=causal)
            out, lse = fa.flash_attention(q, k, v, bias, kmask, return_lse=True, **kw)
            do = torch.randn(out.shape, generator=gen).to("cuda", dtype)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, bias, kmask, do, lse, delta)
            got = {"dq": fa.flash_attention_bwd_dq(*args, **kw)}
            got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(*args, **kw)
            if bias is not None:
                got["dbias"] = fa.flash_attention_bwd_dbias(*args, **kw)
            ref = dict(zip(("dq", "dk", "dv", "dbias"),
                           fa.flash_attention_backward_plain(q, k, v, bias, kmask, out, lse, do, **kw)))
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            errs, abs_errs = {}, {}
            for key, g in got.items():
                r = ref[key].float()
                check(torch.isfinite(g).all().item(), f"flash bwd {tag}: non-finite {key}")
                abs_errs[key] = (g.float() - r).abs().max().item()
                errs[key] = abs_errs[key] / max(r.abs().max().item(), 1e-30)
                check(errs[key] <= tol[dtype], f"flash bwd {tag}: {key} rel err {errs[key]} > {tol[dtype]}")
            if name.startswith("fully_masked_row") or name == "tpu_native_cross":
                for key in ("dq", "dk", "dv"):
                    check(got[key][2].abs().max().item() == 0.0, f"flash bwd {tag}: {key} of the masked row")
                check(torch.isneginf(lse[2]).all().item(), f"flash bwd {tag}: lse of the masked row")
            if name == "fully_masked_row_bias":
                # p = 0 on the batch row that sees no key: it adds exactly
                # nothing to dBias, which equals the other rows' dBias
                live = torch.tensor([0, 1, 3], device="cuda")
                sub = [t.index_select(0, live) for t in (q, k, v)]
                rest = fa.flash_attention_bwd_dbias(*sub, bias, kmask.index_select(0, live),
                                                    do.index_select(0, live), lse.index_select(0, live),
                                                    delta.index_select(0, live), **kw)
                check(torch.equal(got["dbias"], rest), f"flash bwd {tag}: the masked batch row moves dBias")
            if dtype == torch.bfloat16 and bias is not None:
                # dBias sums the batch inside the block, in order: a second
                # call is bit-identical
                check(torch.equal(got["dbias"], fa.flash_attention_bwd_dbias(*args, **kw)),
                      f"flash bwd {tag}: two dBias calls differ")
            ms = graph = plain_ms = None
            if dtype == torch.bfloat16 and name in BWD_TIMED_SHAPES:
                # timed at the train shapes only: each kernel back to back
                # (`ms`) and by CUDA-graph replay (`graph_ms`, the device time
                # alone), against the plain version of that kernel alone
                # (which recomputes p and dS, as the kernel does), and the
                # whole plain backward
                pargs = (q, k, v, bias, kmask, out, lse, do)
                kernels = {"dq": (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain),
                           "dkv": (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain)}
                if bias is not None:
                    kernels["dbias"] = (fa.flash_attention_bwd_dbias, fa.flash_attention_bwd_dbias_plain)
                ms = {key: cuda_ms(lambda: kern(*args, **kw), reps=10) for key, (kern, _) in kernels.items()}
                graph = {key: graph_ms(lambda: kern(*args, **kw)) for key, (kern, _) in kernels.items()}
                plain_ms = {key: cuda_ms(lambda: plain(*pargs, **kw), reps=10)
                            for key, (_, plain) in kernels.items()}
                plain_ms["whole_backward"] = cuda_ms(
                    lambda: fa.flash_attention_backward_plain(*pargs, **kw), reps=10)
            phase(f"flash_attention_bwd {tag}", shape=list(q.shape), j=k.shape[2],
                  rel_err=errs, ms=ms, graph_ms=graph, plain_ms=plain_ms)
            result[tag] = dict(abs_errs=abs_errs, ms=ms, graph_ms=graph, plain_ms=plain_ms)
            if dtype == torch.bfloat16 and name in BWD_YARDSTICK_SHAPES:
                result[tag].update(bwd_yardsticks(torch, q, k, v, bias, kmask, do, lse, delta, got, name))

    # autograd on the card: the Function launches the kernels and every
    # differentiable input gets a gradient equal to the plain backward's. f32
    # on a slice of the self-attention case; bf16 (the wgmma forward, dQ and
    # dK/dV and dBias) at the whole train shape with an f32 bias, as
    # the CPB gives it, so the Function's casts (bias to bf16 and back, dO to
    # bf16) are on the path; and so at the 4 heads x 128 train shape (the
    # d = 128 forward, dQ, dK/dV and dBias, all on wgmma)
    q, k, v, bias, kmask, _ = flash_bwd_cases(torch, torch.float32, gen)["maskgit_self"]
    f32_leaves = [t[:1, :2].clone() for t in (q, k, v)] + [bias[:2].clone()]
    bf16_cases = flash_bwd_cases(torch, torch.bfloat16, gen)
    q, k, v, _, _, _ = bf16_cases["maskgit_self"]
    bf16_leaves = [q, k, v, torch.randn(8, 1152, 1152, generator=gen).cuda()]
    q, k, v, _, native_kmask, _ = bf16_cases["tpu_native_self"]
    native_leaves = [q, k, v, torch.randn(4, 1152, 1152, generator=gen).cuda()]
    del bf16_cases
    for label, dtype, leaves, km in (("float32", torch.float32, f32_leaves, kmask[:1]),
                                     ("bfloat16", torch.bfloat16, bf16_leaves, kmask),
                                     ("bfloat16 tpu_native_self", torch.bfloat16, native_leaves, native_kmask)):
        leaves = [t.clone().requires_grad_() for t in leaves]
        out = fa.flash_attention(*leaves, km, scale=8.0)
        check(out.grad_fn is not None, "flash_attention on the card records no grad_fn")
        do = torch.randn(out.shape, generator=gen).to("cuda", dtype)
        out.backward(do)
        detached = [t.detach() for t in leaves]
        lse = fa.flash_attention(*detached, km, scale=8.0, return_lse=True)[1]
        plain = fa.flash_attention_backward_plain(*detached, km, out.detach(), lse, do, scale=8.0)
        errs = {}
        for t, r, key in zip(leaves, plain, ("q", "k", "v", "bias")):
            check(t.grad is not None and t.grad.dtype == t.dtype,
                  f"flash_attention on the card: no gradient of its dtype for {key}")
            errs[key] = ((t.grad.float() - r.float()).abs().max() / r.float().abs().max()).item()
            check(errs[key] <= tol[dtype], f"autograd on the card ({dtype}): d{key} rel err {errs[key]}")
        phase(f"flash_attention autograd on the card {label}", shape=list(out.shape),
              grad_fn=type(out.grad_fn).__name__, rel_err=errs)
    return result


def bwd_bounds(q, k, v, bias, kmask, do, lse, delta, got):
    """Each backward kernel's bound: its inputs and outputs once, and the
    products it must do (S and dP recomputed, then its own: dQ, or dK and
    dV; dBias none)."""
    b, h, i, d = q.shape
    ijd = b * h * i * k.shape[2] * d
    inputs = nbytes(q, k, v, bias, kmask, do, lse, delta)
    return {"dq": bound(inputs + nbytes(got["dq"]), 6 * ijd),
            "dkv": bound(inputs + nbytes(got["dk"], got["dv"]), 8 * ijd),
            "dbias": bound(inputs + nbytes(got.get("dbias")), 4 * ijd)}


def bwd_yardsticks(torch, q, k, v, bias, kmask, do, lse, delta, got, name):
    """Bounds of kernels 4-6, and the yardstick: SDPA's whole backward (dq,
    dk, dv and the bias's gradient in one autograd call) on the same inputs.
    Without a bias the key mask is SDPA's float mask, (b, 1, 1, j) in q's
    dtype, and gets no gradient."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias) if t is not None]
    mask = leaves[3] if bias is not None else kmask[:, None, None, :].to(q.dtype)
    out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=mask, scale=8.0)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps=10)
    bounds = bwd_bounds(q, k, v, bias, kmask, do, lse, delta, got)
    phase(f"flash_attention_bwd yardsticks {name}", bound_ms={key: b[0] for key, b in bounds.items()},
          library_whole_backward_ms=library_ms)
    return dict(bounds=bounds, library_ms=library_ms)


def chunk_cases(torch, dtype, gen, b):
    """Kernel 3 at the sequence-sharded flagship (sp = 2: 576 rows a rank):
    the chunk against the other rank's shard with its bias slice (8, 576,
    576) read in place from the rows' (8, 576, 1152) bias; the same with a
    key mask, against the rank's own shard; causal chunks at global offsets
    (0, 0) (the diagonal), (576, 0) (wholly visible) and (0, 576) (wholly
    masked: acc = l = 0); and d = 128 with ragged tiles (200 rows and keys),
    its bias slice read in place from (4, 200, 400) rows and a causal mask at
    offsets (37, 0) that cuts through tiles, also on 9 b rows (a grid that
    takes the d = 128 forward's one-stage ring). Each bias is a slice of rows
    twice its width. Each: (q, k, v, bias, kmask, causal, offsets)."""
    from phenaki_tpu_torch.ops.attention import NEG_INF

    q, k = qk((b, 8, 576, 64), gen, dtype), qk((b, 8, 576, 64), gen, dtype)
    v = torch.randn(b, 8, 576, 64, generator=gen).to("cuda", dtype)
    rows_bias = torch.randn(8, 576, 1152, generator=gen).to("cuda", dtype)
    keep = torch.rand(b, 576, generator=gen) > 0.3
    kmask = torch.where(keep, 0.0, NEG_INF).float().cuda()
    qd, kd = qk((b, 4, 200, 128), gen, dtype), qk((b, 4, 200, 128), gen, dtype)
    vd = torch.randn(b, 4, 200, 128, generator=gen).to("cuda", dtype)
    rows_d = torch.randn(4, 200, 400, generator=gen).to("cuda", dtype)
    # d = 128 on 9 b rows: a grid of at least 288 blocks, the one-stage ring
    qw, kw = qk((9 * b, 4, 200, 128), gen, dtype), qk((9 * b, 4, 200, 128), gen, dtype)
    vw = torch.randn(9 * b, 4, 200, 128, generator=gen).to("cuda", dtype)
    return {"flagship_other_shard": (q, k, v, rows_bias[..., 576:], None, False, None),
            "kmask_own_shard": (q, k, v, rows_bias[..., :576], kmask, False, None),
            "causal_diagonal": (q, k, v, rows_bias[..., :576], None, True, (0, 0)),
            "causal_below": (q, k, v, rows_bias[..., :576], None, True, (576, 0)),
            "causal_above": (q, k, v, rows_bias[..., 576:], None, True, (0, 576)),
            "dim_head_128_causal": (qd, kd, vd, rows_d[..., 200:], None, True, (37, 0)),
            "dim_head_128_one_stage": (qw, kw, vw, rows_d[..., 200:], None, True, (37, 0))}


def ring_bound(torch, q, k):
    """The ring's c2 for these shards: max ||8 q|| max ||k|| log2(e)."""
    return ((q.float() * 8.0).norm(dim=-1).max() * k.float().norm(dim=-1).max() * 1.4426950408889634)


def check_chunk(torch):
    """Kernel 3 (`flash_attend_chunk`) against `flash_attend_chunk_plain` on
    the same inputs, bf16 and f32, at the sample shape (b = 2); acc and l
    each within a tolerance of max |ref| (bf16 2e-2: the output sums bf16
    products in another order; f32 5e-5), and exactly 0 where every key is
    masked. The bias slice is read through its row stride (no copy)."""
    import phenaki_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator().manual_seed(31)
    tol = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (q, k, v, bias, kmask, causal, offsets) in chunk_cases(torch, dtype, gen, 2).items():
            check(bias.stride(1) == 2 * k.shape[2], "the chunk's bias is not the in-place slice")
            c2 = ring_bound(torch, q, k)
            kw = dict(c2=c2, scale=8.0, causal=causal, offsets=offsets)
            acc, l = fa.flash_attend_chunk(q, k, v, bias, kmask, **kw)
            ref_acc, ref_l = fa.flash_attend_chunk_plain(q, k, v, bias, kmask, **kw)
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            errs = {}
            for key, got, ref in (("acc", acc, ref_acc), ("l", l, ref_l)):
                check(torch.isfinite(got).all().item(), f"chunk {tag}: non-finite {key}")
                scale_ref = max(ref.abs().max().item(), 1e-30)
                errs[key] = (got - ref).abs().max().item() / scale_ref
                check(errs[key] <= tol[dtype], f"chunk {tag}: {key} rel err {errs[key]} > {tol[dtype]}")
            if name == "causal_above":
                check(acc.abs().max().item() == 0.0 and l.abs().max().item() == 0.0,
                      f"chunk {tag}: a wholly masked chunk is not 0")
            entry = dict(rel_err=errs, max_abs_err=max((acc - ref_acc).abs().max().item(),
                                                       (l - ref_l).abs().max().item()))
            if tag == "flagship_other_shard_bfloat16":
                # timed as kernel 1 is (see check_flash)
                entry["ms"] = cuda_ms(lambda: fa.flash_attend_chunk(q, k, v, bias, kmask, **kw))
                entry["graph_ms"] = graph_ms(lambda: fa.flash_attend_chunk(q, k, v, bias, kmask, **kw))
                entry["plain_ms"] = cuda_ms(lambda: fa.flash_attend_chunk_plain(q, k, v, bias, kmask, **kw),
                                            reps=5)
                b, h, i, d = q.shape
                entry["bound_ms"], entry["bound_by"] = bound(
                    nbytes(q, k, v, bias, acc, l), 4 * b * h * i * k.shape[2] * d)
                entry["library_ms"] = None  # no one PyTorch call returns the raw (acc, l)
            phase(f"flash_attend_chunk {tag}", shape=list(q.shape), causal=causal, offsets=offsets,
                  **entry)
            result[tag] = entry
    return result


def check_chunk_bwd(torch):
    """Kernels 4-6 in the chunk's mode, at the train shape (b = 4): global
    offsets, lse = c2 ln 2, dO = d(acc), delta = -d(l), the bias slice read
    through its stride; each against its plain version on the same inputs,
    within the tolerances of `check_flash_bwd` (relative to max |ref|). A
    wholly masked chunk gives zero gradients. Then the autograd Function on
    the card: every gradient equals the plain backward's."""
    import phenaki_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator().manual_seed(32)
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (q, k, v, bias, kmask, causal, offsets) in chunk_cases(torch, dtype, gen, 4).items():
            c2 = ring_bound(torch, q, k).reshape(1)
            dacc = torch.randn(q.shape, generator=gen).cuda()
            dl = torch.randn(q.shape[:3], generator=gen).cuda()
            lse = (c2 * fa.LN2).expand(q.shape[:3]).contiguous()
            delta = (-dl).contiguous()
            do = dacc.to(dtype)
            args = (q, k, v, bias, kmask, do, lse, delta)
            kw = dict(scale=8.0, causal=causal, offsets=offsets)
            got = {"dq": fa.flash_attention_bwd_dq(*args, **kw)}
            got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(*args, **kw)
            got["dbias"] = fa.flash_attention_bwd_dbias(*args, **kw)
            if dtype == torch.bfloat16:
                check(torch.equal(got["dbias"], fa.flash_attention_bwd_dbias(*args, **kw)),
                      f"chunk bwd {name}: two dBias calls differ")
            pargs = (q, k, v, bias, kmask, None, lse, do)
            ref = dict(zip(("dq", "dk", "dv", "dbias"),
                           fa.flash_attention_backward_plain(*pargs, delta=delta, **kw)))
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            errs, abs_errs = {}, {}
            for key, g in got.items():
                r = ref[key].float()
                check(torch.isfinite(g).all().item(), f"chunk bwd {tag}: non-finite {key}")
                abs_errs[key] = (g.float() - r).abs().max().item()
                if name == "causal_above":
                    check(g.abs().max().item() == 0.0, f"chunk bwd {tag}: {key} of a masked chunk is not 0")
                    continue
                errs[key] = abs_errs[key] / max(r.abs().max().item(), 1e-30)
                check(errs[key] <= tol[dtype], f"chunk bwd {tag}: {key} rel err {errs[key]} > {tol[dtype]}")
            entry = dict(rel_err=errs, abs_errs=abs_errs)
            if tag == "flagship_other_shard_bfloat16":
                kernels = {"dq": (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain),
                           "dkv": (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain),
                           "dbias": (fa.flash_attention_bwd_dbias, fa.flash_attention_bwd_dbias_plain)}
                entry["ms"] = {key: cuda_ms(lambda: kern(*args, **kw), reps=10)
                               for key, (kern, _) in kernels.items()}
                entry["plain_ms"] = {key: cuda_ms(lambda: plain(*pargs, delta=delta, **kw), reps=10)
                                     for key, (_, plain) in kernels.items()}
                entry["bound_ms"] = {key: b[0] for key, b in
                                     bwd_bounds(q, k, v, bias, kmask, do, lse, delta, got).items()}
            phase(f"flash_attend_chunk bwd {tag}", shape=list(q.shape), causal=causal, offsets=offsets,
                  **entry)
            result[tag] = entry

    # autograd through the chunk on the card (bf16, an f32 bias slice as the
    # CPB gives it): the Function launches kernels 3-6
    q, k, v, bias, _, _, _ = chunk_cases(torch, torch.bfloat16, gen, 4)["causal_below"]
    rows_bias = torch.randn(8, 576, 1152, generator=gen).cuda().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    c2 = ring_bound(torch, q, k)
    kw = dict(c2=c2, scale=8.0, causal=True, offsets=(576, 0))
    acc, l = fa.flash_attend_chunk(*leaves, rows_bias[..., :576], **kw)
    check(acc.grad_fn is not None, "flash_attend_chunk on the card records no grad_fn")
    dacc, dl = torch.randn(acc.shape, generator=gen).cuda(), torch.randn(l.shape, generator=gen).cuda()
    torch.autograd.backward([acc, l], [dacc, dl])
    lse = (c2 * fa.LN2).expand(l.shape).contiguous()
    plain = fa.flash_attention_backward_plain(
        *(t.detach() for t in leaves), rows_bias.detach()[..., :576].to(q.dtype), None, None, lse,
        dacc.to(q.dtype), scale=8.0, causal=True, offsets=(576, 0), delta=-dl)
    errs = {}
    for t, r, key in zip([*leaves, rows_bias], plain, ("q", "k", "v", "bias")):
        check(t.grad is not None and t.grad.dtype == t.dtype, f"chunk autograd: no gradient of its dtype for {key}")
        g = t.grad if key != "bias" else t.grad[..., :576]
        errs[key] = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        check(errs[key] <= tol[torch.bfloat16], f"chunk autograd on the card: d{key} rel err {errs[key]}")
    check(rows_bias.grad[..., 576:].abs().max().item() == 0.0, "chunk autograd: gradient outside the slice")
    phase("flash_attend_chunk autograd on the card bfloat16", grad_fn=type(acc.grad_fn).__name__,
          rel_err=errs)
    return result


def check_fused_ce(torch):
    """The three fused-CE kernels against their plain versions (the (rows, V)
    f32 logits materialised) on the same inputs: at the flagship train shape
    (4 x 1152 rows, d = 512, V = 65,536, a bias) and at d = 1024, where the
    kernels walk d in two slices, in bf16 and f32; and rows that fill no
    whole tile (1000 rows, V = 1024, no bias, every 7th label -1, the pad
    label) at d = 128 and at d = 640 (a 512- and a 128-wide slice). Two calls
    of each bf16 kernel must be bit-identical, and the forward's C entry
    refuses a vocab that is not a multiple of 512. At d = 512 and 1024
    in bf16 each kernel is timed back to back (`ms`), by CUDA-graph replay
    (`graph_ms`) and beside `matmul_ms` (`ce_matmul_ms`). Then a train
    step's CE both ways, forward and backward: the kernels against the
    non-fused branch (a bf16 logits GEMM and F.cross_entropy in f32)."""
    import torch.nn.functional as F

    import phenaki_tpu_torch.ops.fused_ce as ce

    gen = torch.Generator().manual_seed(12)
    # loss and lse: absolute (values near 11), the two sum 65,536 exps in
    # other orders. Gradients, relative to max |ref|: f32 differs only in
    # summation order; bf16 rounds dlog to bf16 in both, and a logit that
    # differs in its last f32 bit can move one dlog entry by a bf16 ulp
    tol = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
    cases = {"train": (4 * 1152, 512, 65536, True), "d1024": (4 * 1152, 1024, 65536, True),
             "ragged": (1000, 128, 1024, False), "ragged_d640": (1000, 640, 1024, False)}
    result = {}
    for name, (rows, d, v, with_bias) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            h = (torch.randn(rows, d, generator=gen) * 0.5).to("cuda", dtype)
            w = (torch.randn(v, d, generator=gen) * 2 / d**0.5).to("cuda", dtype)
            bias = (torch.randn(v, generator=gen) * 0.1).cuda() if with_bias else None
            labels = torch.randint(0, v, (rows,), generator=gen)
            if name.startswith("ragged"):
                labels[::7] = -1
            labels = labels.to(torch.int32).cuda()
            g = torch.rand(rows, generator=gen).cuda()
            args = (h, w, bias, labels)
            loss, lse = ce.fused_ce_fwd(*args)
            ref_loss, ref_lse = ce.cross_entropy_plain(*args)
            bargs = (*args, ref_lse, g)
            got, ref = {"dh": ce.fused_ce_bwd_dh(*bargs)}, {"dh": ce.cross_entropy_bwd_dh_plain(*bargs)}
            got["dw"], got["db"] = ce.fused_ce_bwd_dw(*bargs)
            ref["dw"], ref["db"] = ce.cross_entropy_bwd_dw_plain(*bargs)
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            abs_errs = {"loss": (loss - ref_loss).abs().max().item(), "lse": (lse - ref_lse).abs().max().item()}
            errs = dict(abs_errs)
            for key in ("loss", "lse"):
                check(math.isfinite(errs[key]) and errs[key] <= 1e-4, f"fused CE {tag}: {key} err {errs[key]}")
            for key in ("dh", "dw", "db"):
                check(torch.isfinite(got[key]).all().item(), f"fused CE {tag}: non-finite {key}")
                abs_errs[key] = (got[key] - ref[key]).abs().max().item()
                errs[key] = abs_errs[key] / max(ref[key].abs().max().item(), 1e-30)
                check(errs[key] <= tol[dtype], f"fused CE {tag}: {key} rel err {errs[key]} > {tol[dtype]}")
            ms = plain_ms = graph = matmul = None
            if dtype == torch.bfloat16:
                # the bf16 kernels own what they write and sum their partials
                # in a fixed order: a second call is bit-identical
                again = dict(zip(("loss", "lse"), ce.fused_ce_fwd(*args)))
                again["dh"] = ce.fused_ce_bwd_dh(*bargs)
                again["dw"], again["db"] = ce.fused_ce_bwd_dw(*bargs)
                got.update(loss=loss, lse=lse)
                for key in ("loss", "lse", "dh", "dw", "db"):
                    check(torch.equal(got[key], again[key]), f"fused CE {tag}: two calls differ in {key}")
                del again
            if tag in ("train_bfloat16", "d1024_bfloat16"):
                pairs = {"ce_fwd": (ce.fused_ce_fwd, ce.cross_entropy_plain, args),
                         "ce_dh": (ce.fused_ce_bwd_dh, ce.cross_entropy_bwd_dh_plain, bargs),
                         "ce_dw": (ce.fused_ce_bwd_dw, ce.cross_entropy_bwd_dw_plain, bargs)}
                ms = {key: cuda_ms(lambda: kern(*a), reps=5) for key, (kern, _, a) in pairs.items()}
                graph = {key: graph_ms(lambda: kern(*a), reps=5) for key, (kern, _, a) in pairs.items()}
                plain_ms = {key: cuda_ms(lambda: plain(*a), reps=5) for key, (_, plain, a) in pairs.items()}
                matmul = ce_matmul_ms(torch, h, w, rows, v)
            phase(f"fused_ce {tag}", rows=rows, d=d, vocab=v, err=errs, ms=ms, graph_ms=graph,
                  plain_ms=plain_ms, matmul_ms=matmul)
            result[tag] = dict(abs_errs=abs_errs, ms=ms, graph_ms=graph, plain_ms=plain_ms, matmul_ms=matmul)
            if tag == "train_bfloat16":
                inputs = nbytes(h, w, bias, labels)
                result[tag]["bounds"] = {
                    "ce_fwd": bound(inputs + nbytes(loss, lse), 2 * rows * d * v),
                    "ce_dh": bound(inputs + nbytes(ref_lse, g, got["dh"]), 4 * rows * d * v),
                    "ce_dw": bound(inputs + nbytes(ref_lse, g, got["dw"], got["db"]), 4 * rows * d * v)}
            del got, ref

    # the forward's C entry takes the vocabs the gate admits (V % 512 == 0)
    # and refuses the rest before any launch (cudaErrorInvalidValue = 1)
    from phenaki_tpu_torch import _build

    h = torch.zeros(128, 128, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(640, 128, device="cuda", dtype=torch.bfloat16)
    labels = torch.zeros(128, device="cuda", dtype=torch.int32)
    outs = [torch.empty(128, device="cuda") for _ in range(3)] + [torch.empty(128, 5, 2, device="cuda")]
    p = _build.ptr
    err = _build.load_library().fused_ce_fwd(p(h), p(w), p(None), p(labels), *map(p, outs), 128, 128, 640, 5,
                                             _build.DTYPES[torch.bfloat16], _build.stream(h.device))
    check(err == 1, f"fused CE forward: the C entry took V = 640 (error {err})")

    rows, d, v = 4 * 1152, 512, 65536
    h = (torch.randn(4, 1152, d, generator=gen) * 0.5).to("cuda", torch.bfloat16).requires_grad_()
    w = (torch.randn(v, d, generator=gen) * 2 / d**0.5).cuda().requires_grad_()
    bias = torch.zeros(v, device="cuda", requires_grad=True)
    ids = torch.randint(0, v, (4, 1152), generator=gen).cuda()
    wgt = (torch.rand(4, 1152, generator=gen) < 0.5).float().cuda()

    def fused():
        per_token = ce.fused_vocab_cross_entropy(h, w, bias, ids)
        ((per_token * wgt).sum() / wgt.sum()).backward()

    def nonfused():
        logits = F.linear(h, w.to(h.dtype), bias.to(h.dtype))
        per_token = F.cross_entropy(logits.float().reshape(rows, v), ids.reshape(-1), reduction="none")
        ((per_token.view(4, 1152) * wgt).sum() / wgt.sum()).backward()

    both = {}
    for key, fn in (("fused", fused), ("nonfused", nonfused)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        both[f"{key}_extra_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        both[f"{key}_fwd_bwd_ms"] = cuda_ms(fn, reps=5)
    phase("fused_ce train-step CE, forward + backward", **both)
    return result


def ce_matmul_ms(torch, h, w, rows, v):
    """A yardstick for each fused-CE kernel: the bf16 `torch.matmul`
    products it computes, each timed alone and added: the logits h W^T for
    the forward; and for dh the logits and dlog W, for dW the logits and
    dlog^T h, with a bf16 (rows, V) stand-in for dlog."""
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    dlog = torch.empty(rows, v, device="cuda", dtype=torch.bfloat16).normal_(0.0, 1e-3)
    logits = cuda_ms(lambda: torch.matmul(hb, wb.t()), reps=5)
    out = {"ce_fwd": logits,
           "ce_dh": logits + cuda_ms(lambda: torch.matmul(dlog, wb), reps=5),
           "ce_dw": logits + cuda_ms(lambda: torch.matmul(dlog.t(), hb), reps=5)}
    del dlog
    torch.cuda.empty_cache()
    return out


# kernel 2's main-path shapes: a b = 1 decode step and a served bucket 8
PROJ_MAIN_SHAPES = ("d512_bfloat16", "serve_b8_bfloat16")


def check_proj(torch):
    """The projection sampler against its plain version with injected noise:
    at the flagship decode shape (d = 512) and at d = 1024 (sixteen ring
    slices of d for bf16; the f32 kernel stages W in d-slices there), in
    bf16 and f32; at the critic train
    shape, (4, 1152, 512) bf16 embeddings with the f32 weight cast to bf16
    at the call, as `Phenaki.loss` does, at its sample temperature 1; and at
    a served bucket-8 launch's (8, 1152, 512) bf16. The main-path shapes
    (`PROJ_MAIN_SHAPES`) also get their bounds."""
    from phenaki_tpu_torch.ops.fused_sampling import project_sample, project_sample_plain

    gen = torch.Generator().manual_seed(2)
    rows, v = 1152, 65536
    # (batch, d, embedding dtype, weight dtype, temperature)
    cases = {f"d{d}_{str(dtype).split('.')[-1]}": (1, d, dtype, dtype, 0.85)
             for d in (512, 1024) for dtype in (torch.bfloat16, torch.float32)}
    cases["critic_train_bfloat16"] = (4, 512, torch.bfloat16, torch.float32, 1.0)
    # a served bucket-8 launch's decode rows (8 x 1152, after the CFG combine)
    cases["serve_b8_bfloat16"] = (8, 512, torch.bfloat16, torch.bfloat16, 0.85)
    result = {}
    for tag, (b, d, dtype, w_dtype, temp) in cases.items():
        h = torch.randn(b, rows, d, generator=gen).to("cuda", dtype)
        # logits peaked (std ~9), so that scores spread over [0, 1] and are
        # not all ~1 - 1/V as at the default init
        w = ((torch.rand(v, d, generator=gen) * 2 - 1) * 16 / d**0.5).to("cuda", w_dtype)
        bias = ((torch.rand(v, generator=gen) * 2 - 1) / d**0.5).cuda()
        noise = torch.rand(b, rows, v, generator=gen).cuda()
        ids, score = project_sample(h, w.to(dtype), bias, temp, noise=noise)
        ref_ids, ref_score = project_sample_plain(h, w.to(dtype), bias, temp, noise=noise)
        torch.cuda.synchronize()
        same = ids == ref_ids
        agree = same.float().mean().item()
        err = (score - ref_score)[same].abs().max().item()
        wk = w.to(dtype)  # the kernel's operand, cast once outside the timed calls
        ms = cuda_ms(lambda: project_sample(h, wk, bias, temp, noise=noise), reps=10)
        plain_ms = cuda_ms(lambda: project_sample_plain(h, wk, bias, temp, noise=noise), reps=10)
        gseed = torch.Generator().manual_seed(7)
        ms_philox = cuda_ms(lambda: project_sample(h, wk, bias, temp, generator=gseed), reps=10)
        # the device time alone, by CUDA-graph replay (the seed is drawn at
        # capture: every replay samples with the same one)
        graph = graph_ms(lambda: project_sample(h, wk, bias, temp, noise=noise), reps=10)
        graph_philox = graph_ms(lambda: project_sample(h, wk, bias, temp, generator=gseed), reps=10)
        numbers = dict(ms=ms, graph_ms=graph, ms_philox=ms_philox, graph_ms_philox=graph_philox,
                       plain_ms=plain_ms)
        if dtype == torch.bfloat16:
            # the product alone, a yardstick: it samples nothing
            numbers["matmul_ms"] = cuda_ms(lambda: torch.matmul(h, wk.t()), reps=10)
        phase(f"project_sample {tag}", rows=b * rows, d=d, vocab=v, weight_dtype=str(w_dtype),
              id_agreement=agree, score_max_abs_err=err, score_min=score.min().item(), **numbers)
        check(ids.shape == (b, rows) and score.shape == (b, rows), f"project_sample {tag}: shapes")
        check(agree >= 0.999, f"project_sample {tag}: ids agree on {agree} < 0.999 of rows")
        check(err <= 1e-4, f"project_sample {tag}: score err {err} > 1e-4")
        # `ms` against `plain_ms` on the same injected noise; the main paths
        # run the in-kernel Philox stream, timed as `ms_philox`
        result[tag] = dict(max_abs_err=err, **numbers)
        if tag in PROJ_MAIN_SHAPES:
            # the bound of `ms`'s call (the noise read, ids and scores
            # written) and of the Philox call the main paths run
            out_bytes, ops = b * rows * 8, 2 * b * rows * d * v
            result[tag]["bound_ms"], result[tag]["bound_by"] = bound(nbytes(h, wk, bias, noise) + out_bytes, ops)
            result[tag]["bound_ms_philox"], result[tag]["bound_by_philox"] = bound(
                nbytes(h, wk, bias) + out_bytes, ops)
            result[tag]["library_ms"] = None  # no one PyTorch call samples from h W + b
        del h, w, wk, noise

    # the in-kernel Philox stream: softmax frequencies and seed determinism
    n_rows, d, v = 4096, 128, 512
    h = torch.zeros(1, n_rows, d, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(v, d, device="cuda", dtype=torch.bfloat16)
    logits = torch.full((v,), -4.0)
    logits[[5, 40, 100]] = torch.tensor([2.0, 1.5, 1.0])
    ids, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(5))
    again, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(5))
    other, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(6))
    probs = torch.softmax(logits, -1)
    freq = {c: (ids == c).float().mean().item() for c in (5, 40, 100)}
    dev = max(abs(freq[c] - probs[c].item()) for c in freq)
    phase("project_sample philox", rows=n_rows, vocab=v, max_freq_dev=dev,
          freqs=[freq[c] for c in (5, 40, 100)], probs=[probs[c].item() for c in (5, 40, 100)])
    check(dev < 0.03, f"Philox sample frequencies deviate by {dev} from softmax")
    check(torch.equal(ids, again), "the same seed gave different ids")
    check(not torch.equal(ids, other), "different seeds gave the same ids")
    return result


def check_proj_primed_slice(torch):
    """Kernel 2 on the scene rows of primed embeddings, as the primed decode
    loop calls it: h[:, 384:] of (b, 1408, 512) bf16. At b = 1 the slice is
    contiguous (an offset view, read in place); at b = 2 it is strided and
    the wrapper copies its rows. Ids and scores against the plain version on
    injected noise; `ms` is the Philox call on the slice (any copy
    included), `contiguous_ms` the same call on a contiguous copy, `copy_ms`
    the copy alone. Returns the b = 1 numbers, the main path's, with b = 2's
    under "b2"."""
    from phenaki_tpu_torch.ops.fused_sampling import project_sample, project_sample_plain

    gen = torch.Generator().manual_seed(4)
    d, v, prime, n, temp = 512, 65536, 384, 1024, 0.85
    w = ((torch.rand(v, d, generator=gen) * 2 - 1) * 16 / d**0.5).to("cuda", torch.bfloat16)
    bias = ((torch.rand(v, generator=gen) * 2 - 1) / d**0.5).cuda()
    result = {}
    for b in (1, 2):
        h = torch.randn(b, prime + n, d, generator=gen).to("cuda", torch.bfloat16)[:, prime:]
        noise = torch.rand(b, n, v, generator=gen).cuda()
        ids, score = project_sample(h, w, bias, temp, noise=noise)
        ref_ids, ref_score = project_sample_plain(h, w, bias, temp, noise=noise)
        torch.cuda.synchronize()
        same = ids == ref_ids
        agree = same.float().mean().item()
        err = (score - ref_score)[same].abs().max().item()
        hc, gseed = h.contiguous(), torch.Generator().manual_seed(7)
        numbers = dict(ms=cuda_ms(lambda: project_sample(h, w, bias, temp, generator=gseed), reps=10),
                       contiguous_ms=cuda_ms(lambda: project_sample(hc, w, bias, temp, generator=gseed),
                                             reps=10),
                       copy_ms=cuda_ms(lambda: h.contiguous(), reps=10))
        numbers["bound_ms"], numbers["bound_by"] = bound(nbytes(hc, w, bias) + b * n * 8, 2 * b * n * d * v)
        phase(f"project_sample primed_slice b{b}", rows=b * n, d=d, vocab=v,
              contiguous_input=h.is_contiguous(), id_agreement=agree, score_max_abs_err=err, **numbers)
        check(h.is_contiguous() == (b == 1), f"primed slice b{b}: contiguous is {h.is_contiguous()}")
        check(agree >= 0.999, f"project_sample primed_slice b{b}: ids agree on {agree} < 0.999 of rows")
        check(err <= 1e-4, f"project_sample primed_slice b{b}: score err {err} > 1e-4")
        result[f"b{b}"] = dict(max_abs_err=err, id_agreement=agree, **numbers)
    return dict(result["b1"], b2=result["b2"])


def check_gumbel_kernel(torch):
    """`gumbel_sample_with_score` (kernel 10) against its plain version with
    injected noise: the stacked CFG logits of a flagship logits-path decode
    step (2, 1152, 65,536) in bf16 and f32, an odd row count (2, 1151,
    65,536), and an odd vocab without CFG at temperature 0 (one value a
    load). The kernel writes its arithmetic with round-to-nearest
    intrinsics, so with the same uniforms the ids must agree on every row;
    the score within 1e-5 (the sum-exp adds 65,536 terms in another order).
    Then the in-kernel Philox stream: softmax frequencies and seeds."""
    from phenaki_tpu_torch.ops.fused_sampling import (
        gumbel_sample_with_score,
        gumbel_sample_with_score_plain,
    )

    gen = torch.Generator().manual_seed(21)
    cases = {"stacked_bfloat16": (2, 1152, 65536, torch.bfloat16, 5.0, 0.85),
             "stacked_float32": (2, 1152, 65536, torch.float32, 5.0, 0.85),
             "stacked_odd_rows_bfloat16": (2, 1151, 65536, torch.bfloat16, 5.0, 0.5),
             "odd_vocab_t0_float32": (3, 100, 5003, torch.float32, None, 0.0)}
    result = {}
    for tag, (bb, n, v, dtype, scale, temp) in cases.items():
        logits = (torch.randn(bb, n, v, generator=gen) * 3).to("cuda", dtype)
        b = bb // 2 if scale is not None else bb
        noise = torch.rand(b, n, v, generator=gen).cuda()
        kw = dict(cond_scale=scale, noise=noise)
        ids, score = gumbel_sample_with_score(logits, temp, **kw)
        ref_ids, ref_score = gumbel_sample_with_score_plain(logits, temp, **kw)
        torch.cuda.synchronize()
        agree = (ids == ref_ids).float().mean().item()
        err = (score - ref_score).abs().max().item()
        ms = cuda_ms(lambda: gumbel_sample_with_score(logits, temp, **kw), reps=10)
        plain_ms = cuda_ms(lambda: gumbel_sample_with_score_plain(logits, temp, **kw), reps=10)
        gseed = torch.Generator().manual_seed(7)
        ms_philox = cuda_ms(lambda: gumbel_sample_with_score(logits, temp, cond_scale=scale,
                                                             generator=gseed), reps=10)
        phase(f"gumbel_sample {tag}", shape=[bb, n, v], cond_scale=scale, temperature=temp,
              id_agreement=agree, score_max_abs_err=err, ms=ms, ms_philox=ms_philox,
              plain_ms=plain_ms)
        check(ids.shape == (b, n) and score.shape == (b, n), f"gumbel_sample {tag}: shapes")
        check(agree == 1.0, f"gumbel_sample {tag}: ids agree on {agree} of rows, not all")
        check(err <= 1e-5, f"gumbel_sample {tag}: score err {err} > 1e-5")
        result[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_philox=ms_philox)
        if tag == "stacked_bfloat16":
            # the logits and uniforms read, ids and scores written; about 8
            # f32 operations a (row, vocab) element (combine, gumbel, max, exp)
            result[tag]["bound_ms"], result[tag]["bound_by"] = bound(
                nbytes(logits, noise) + b * n * 8, 8 * b * n * v, "f32")
            result[tag]["library_ms"] = None  # no one PyTorch call samples with the score
        del logits, noise

    # Philox: 4096 rows of stacked logits whose CFG combine peaks three ids
    n_rows, v = 4096, 512
    cond = torch.full((v,), -4.0)
    cond[[5, 40, 100]] = torch.tensor([2.0, 1.5, 1.0])
    null = torch.zeros(v)
    stacked = torch.stack([cond.expand(n_rows, v), null.expand(n_rows, v)]).cuda()
    draw = [gumbel_sample_with_score(stacked, 1.0, cond_scale=2.0,
                                     generator=torch.Generator().manual_seed(s))[0] for s in (5, 5, 6)]
    probs = torch.softmax(cond * 2.0, -1)
    freq = {c: (draw[0] == c).float().mean().item() for c in (5, 40, 100)}
    dev = max(abs(freq[c] - probs[c].item()) for c in freq)
    phase("gumbel_sample philox", rows=n_rows, vocab=v, max_freq_dev=dev,
          freqs=[freq[c] for c in (5, 40, 100)], probs=[probs[c].item() for c in (5, 40, 100)])
    check(dev < 0.03, f"gumbel_sample Philox frequencies deviate by {dev} from softmax")
    check(torch.equal(draw[0], draw[1]), "gumbel_sample: the same seed gave different ids")
    check(not torch.equal(draw[0], draw[2]), "gumbel_sample: different seeds gave the same ids")
    return result


def check_peg(torch):
    """`peg_stencil` (PEG with the layer's residual, csrc/peg_stencil.cu)
    against its plain version at its two main-path shapes: the MaskGit's
    (and the TokenCritic's) guided forward, 128 rows of a 9 x 8 x 4 grid at
    d = 512, and the C-ViViT decoder's causal temporal layers at b = 64,
    read in their (b h w) t d layout. The bf16 output within half a bf16 ulp
    (rtol 2^-8) and 1e-4 of the plain version in f32 on the same bf16
    values. `ms` back to back and `graph_ms` by graph replay, each cycling
    over four inputs (300 MB, beyond the 50 MB L2, so each call reads x
    from device memory); `plain_ms` the plain version (the windowed
    multiply-and-sum, its padded copy and the residual add); the bound
    reads x and writes the output once. `residual_add_graph_ms` is what the
    layer's residual would cost as its own add after the kernel (graph
    replay of `out + x` over the same four inputs): the kernel adds it on
    its centre tap."""
    import itertools

    from phenaki_tpu_torch.ops.positional import peg_stencil, peg_stencil_plain

    gen = torch.Generator().manual_seed(23)
    cases = {"maskgit": (128, 9, 8, 4, 512, False, "thw"), "decoder_bhw_t": (64, 9, 8, 4, 512, True, "bhw_t")}
    result = {}
    for tag, (b, t, h, w, d, causal, layout) in cases.items():
        xs = []
        for _ in range(4):
            if layout == "thw":
                xs.append(torch.randn(b, t, h, w, d, generator=gen).to("cuda", torch.bfloat16))
            else:
                flat = torch.randn(b * h * w, t, d, generator=gen).to("cuda", torch.bfloat16)
                xs.append(flat.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4))
        weight = ((torch.rand(d, 1, 3, 3, 3, generator=gen) * 2 - 1) / 27**0.5).to("cuda", torch.bfloat16)
        bias = ((torch.rand(d, generator=gen) * 2 - 1) / 27**0.5).to("cuda", torch.bfloat16)
        x = xs[0]
        got = peg_stencil(x, weight, bias, causal)
        ref = peg_stencil_plain(x.float(), weight.float(), bias.float(), causal)
        plain = peg_stencil_plain(x, weight, bias, causal)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        excess = ((got.float() - ref).abs() - 2.0**-8 * ref.abs() - 1e-4).max().item()
        plain_err = (plain.float() - ref).abs().max().item()
        cycle = itertools.cycle(xs)
        ms = cuda_ms(lambda: peg_stencil(next(cycle), weight, bias, causal), reps=20)
        g_ms = graph_ms(lambda: peg_stencil(next(cycle), weight, bias, causal), reps=20)
        plain_ms = cuda_ms(lambda: peg_stencil_plain(next(cycle), weight, bias, causal), reps=8)
        pairs = itertools.cycle([(peg_stencil(xi, weight, bias, causal), xi) for xi in xs])
        add_ms = graph_ms(lambda: torch.add(*next(pairs)), reps=20)
        bound_ms, bound_by = bound(2 * nbytes(x) + nbytes(weight, bias), 54 * x.numel(), "f32")
        phase(f"peg_stencil {tag}", shape=[b, t, h, w, d], causal=causal, layout=layout,
              strides=list(x.stride()), max_abs_err=err, plain_bf16_max_abs_err=plain_err, ms=ms,
              graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
              graph_roofline_pct=100.0 * bound_ms / g_ms, residual_add_graph_ms=add_ms)
        check(got.stride() == x.stride(), f"peg_stencil {tag}: output not in x's layout")
        check(excess <= 0.0, f"peg_stencil {tag}: off the f32 plain version by {excess} beyond its tolerance")
        # library_ms: no one PyTorch call (a grouped conv3d runs a cuDNN launch a channel)
        result[tag] = dict(max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None, residual_add_graph_ms=add_ms)
        del xs, x, got, ref, plain, pairs
    torch.cuda.empty_cache()
    return result


def _within_one_ulp(torch, got, want):
    """How far the bf16 `got` lies beyond one bf16 ulp of the larger
    magnitude (1e-6 at least) from `want`: <= 0 where it is within."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - (2.0**-7 * torch.maximum(g.abs(), w.abs())).clamp_min(1e-6)).max().item()


def check_norms(torch):
    """The trunk's norm kernels (csrc/norms.cu) against their plain versions
    at the sampling path's shapes, bf16: `layer_norm` (`layernorm_kernel`) on
    the MaskGit's and the TokenCritic's guided forward (128 rows of 288 tokens
    at d = 512, the attention's norm and the feedforward's with beta), the
    text context (128 x 128 at 768), the C-ViViT decoder's temporal and
    spatial layers and the encoder's patch norms at patch 32 (3072 and 6144
    wide, a block a row); `qk_norm_split` (`qk_norm_split_kernel`) on the MaskGit's
    self-attention (the fused (b, n, 3 * 512) product) and cross-attention (128
    text keys and 2 null key/values), and the decoder's. Each output within
    one bf16 ulp of the plain version (both round an f32 value once for
    LayerNorm; the plain q/k normalisation rounds twice), v bit-equal. `ms`
    back to back and `graph_ms` by graph replay, each cycling over four inputs
    (beyond the 50 MB L2, so each call reads from device memory); `plain_ms`
    the plain version; `library_ms` and `library_graph_ms` PyTorch's fused
    `F.layer_norm` (f32 statistics, one rounding, gamma and beta in x's
    dtype: the one library call that computes the same function); the bound
    reads every input and writes every output once. At the MaskGit's shape
    the LayerNorm must be within 1.5x of its bound and the head split within
    2x."""
    import itertools

    import torch.nn.functional as F

    from phenaki_tpu_torch.ops.attention import qk_norm_split, qk_norm_split_plain
    from phenaki_tpu_torch.ops.norms import EPS, layer_norm, layer_norm_plain

    gen = torch.Generator().manual_seed(24)
    bf16 = torch.bfloat16

    def params(d, beta):
        gamma = (1 + 0.5 * torch.randn(d, generator=gen)).to("cuda", bf16)
        return gamma, (0.5 * torch.randn(d, generator=gen)).to("cuda", bf16) if beta else None

    result = {}
    ln_cases = {"maskgit": ((128, 288, 512), False), "maskgit_ff": ((128, 288, 512), True),
                "text_context": ((128, 128, 768), False), "decoder_temporal": ((2048, 9, 512), True),
                "decoder_spatial": ((576, 32, 512), False), "patch_norm_3072": ((128, 32, 3072), True),
                "patch_norm_6144": ((32, 256, 6144), True)}
    for tag, (shape, beta) in ln_cases.items():
        xs = [(2 * torch.randn(*shape, generator=gen) + 0.5).to("cuda", bf16) for _ in range(4)]
        gamma, b = params(shape[-1], beta)
        x = xs[0]
        got, plain = layer_norm(x, gamma, b), layer_norm_plain(x, gamma, b)
        excess = _within_one_ulp(torch, got, plain)
        cycle = itertools.cycle(xs)
        ms = cuda_ms(lambda: layer_norm(next(cycle), gamma, b), reps=20)
        g_ms = graph_ms(lambda: layer_norm(next(cycle), gamma, b), reps=20)
        plain_ms = cuda_ms(lambda: layer_norm_plain(next(cycle), gamma, b), reps=8)
        d = shape[-1]
        lib_ms = cuda_ms(lambda: F.layer_norm(next(cycle), (d,), gamma, b, EPS), reps=20)
        lib_g_ms = graph_ms(lambda: F.layer_norm(next(cycle), (d,), gamma, b, EPS), reps=20)
        lib_excess = _within_one_ulp(torch, F.layer_norm(x, (d,), gamma, b, EPS), plain)
        bound_ms, bound_by = bound(2 * nbytes(x) + nbytes(gamma, b), 8 * x.numel(), "f32")
        phase(f"layer_norm {tag}", shape=list(shape), beta=beta, max_abs_err=(got.float() - plain.float()).abs().max().item(),
              ulp_excess=excess, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
              library_graph_ms=lib_g_ms, library_ulp_excess=lib_excess, bound_ms=bound_ms, bound_by=bound_by,
              graph_roofline_pct=100.0 * bound_ms / g_ms, library_graph_roofline_pct=100.0 * bound_ms / lib_g_ms)
        check(excess <= 0.0, f"layer_norm {tag}: more than one bf16 ulp off the plain version (by {excess})")
        result[f"layer_norm_{tag}"] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by, library_ms=lib_ms, library_graph_ms=lib_g_ms)
        del xs, x, got, plain
    qk_cases = {"maskgit_self": (128, 288, 288, 0, True), "maskgit_cross": (128, 288, 128, 2, False),
                "decoder_spatial": (576, 32, 32, 0, True), "decoder_temporal": (2048, 9, 9, 0, True)}
    heads, d = 8, 64
    inner = heads * d
    for tag, (b, n, m, null, fused) in qk_cases.items():
        inputs = []
        for _ in range(4):
            if fused:
                qkv = torch.randn(b, n, 3 * inner, generator=gen).to("cuda", bf16)
                inputs.append((qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]))
            else:
                kv = torch.randn(b, m, 2 * inner, generator=gen).to("cuda", bf16)
                inputs.append((torch.randn(b, n, inner, generator=gen).to("cuda", bf16), kv[..., :inner],
                               kv[..., inner:]))
        qs, ks = (params(d, False)[0] for _ in range(2))
        null_kv = torch.randn(heads, 2 * null, d, generator=gen).to("cuda", bf16) if null else None
        q, k, v = inputs[0]
        got, plain = qk_norm_split(q, k, v, heads, qs, ks, null_kv), qk_norm_split_plain(q, k, v, heads, qs, ks, null_kv)
        excess = max(_within_one_ulp(torch, g, w) for g, w in zip(got[:2], plain[:2]))
        cycle = itertools.cycle(inputs)
        ms = cuda_ms(lambda: qk_norm_split(*next(cycle), heads, qs, ks, null_kv), reps=20)
        g_ms = graph_ms(lambda: qk_norm_split(*next(cycle), heads, qs, ks, null_kv), reps=20)
        plain_ms = cuda_ms(lambda: [t.contiguous() for t in qk_norm_split_plain(*next(cycle), heads, qs, ks, null_kv)],
                           reps=8)
        moved = nbytes(q, k, v, null_kv, qs, ks) + nbytes(*got)
        bound_ms, bound_by = bound(moved, 3 * (q.numel() + k.numel()), "f32")
        phase(f"qk_norm_split {tag}", b=b, n=n, m=m, num_null=null, heads=heads, d=d, ulp_excess=excess,
              v_equal=bool(torch.equal(got[2], plain[2])), contiguous=all(t.is_contiguous() for t in got),
              ms=ms, graph_ms=g_ms, plain_with_copies_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
              graph_roofline_pct=100.0 * bound_ms / g_ms)
        check(excess <= 0.0, f"qk_norm_split {tag}: more than one bf16 ulp off the plain version (by {excess})")
        check(torch.equal(got[2], plain[2]) and all(t.is_contiguous() for t in got),
              f"qk_norm_split {tag}: v not copied bit for bit, or an output not contiguous")
        result[f"qk_norm_split_{tag}"] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by, library_ms=None)
        del inputs, q, k, v, got, plain
    torch.cuda.empty_cache()
    for key, limit in (("layer_norm_maskgit", 1.5), ("qk_norm_split_maskgit_self", 2.0)):
        r = result[key]
        check(r["graph_ms"] <= limit * r["bound_ms"],
              f"{key}: {r['graph_ms']:.5f} ms by graph replay, over {limit}x its bound {r['bound_ms']:.5f} ms")
    return result


def check_ff(torch):
    """`geglu_gemm` (the feedforward's first product with GEGLU in its
    epilogue, csrc/geglu_gemm.cu) against its plain version, bf16: the
    MaskGit's and the TokenCritic's guided forward (128 rows of 288 tokens,
    36,864 rows at d = 512, inner 1365 padded to 1408), the C-ViViT decoder's
    layers at b = 64 (18,432 rows), a ragged row count (1000), a tensor-parallel
    rank's 683 columns (704 padded) and the tokenize shape at patch 16 (32
    videos of 9 x 16 x 8 tokens). Each h within half a bf16 ulp (rtol 2^-8)
    plus 1e-4 of the largest value of the f32 GEGLU of the f32 product on the
    same bf16 operands (the kernel rounds once), the padded columns exactly 0,
    and the packed pre-activation (the backward's) within one bf16 ulp of the
    f32 product. At the MaskGit's shape `ms` back to back and `graph_ms` by
    graph replay, each cycling over four inputs (151 MB, beyond the 50 MB
    L2); `plain_ms` the plain version (the aligned 2816-wide product, `gelu`
    and its multiply); two library yardsticks: `unaligned_ms`, cuBLAS on the
    2730-wide product of the unpacked weight with `gelu` and its multiply (the
    feedforward's first half before the kernel), and `aligned_product_ms`,
    cuBLAS on the padded 2816-wide product alone; and the whole feedforward
    after its norm, `ff_before_ms` (both unaligned products and the GEGLU)
    against `ff_ms` (the kernel and proj_out's aligned product). The bound
    counts the unpadded operations, 2 rows d (2 inner + inner) of the
    kernel, and reads x and the weight and writes h once."""
    import itertools

    import torch.nn.functional as F

    from phenaki_tpu_torch.ops.feedforward import (geglu, geglu_gemm, geglu_gemm_plain, geglu_packed, pack_proj_in,
                                                   pad_proj_out, padded_inner)

    gen = torch.Generator().manual_seed(25)
    bf16 = torch.bfloat16
    cases = {"maskgit": (128 * 288, 512, 1365), "decoder": (64 * 288, 512, 1365), "ragged": (1000, 512, 1365),
             "tp_rank": (128 * 288, 512, 683), "tokenize_patch16": (32 * 1152, 512, 1365)}
    result = {}
    for tag, (rows, d, inner) in cases.items():
        timed = tag == "maskgit"
        xs = [torch.randn(rows, d, generator=gen).to("cuda", bf16) for _ in range(4 if timed else 1)]
        w = (torch.randn(2 * inner, d, generator=gen) / d**0.5).to("cuda", bf16)
        w_out = (torch.randn(d, inner, generator=gen) / inner**0.5).to("cuda", bf16)
        wp, ip = pack_proj_in(w), padded_inner(inner)
        x = xs[0]
        before = geglu_gemm.launches
        h, pre = geglu_gemm(x, wp, pre=True)
        torch.cuda.synchronize()
        check(geglu_gemm.launches == before + 1, f"geglu_gemm {tag}: {geglu_gemm.launches - before} launches")
        ref_pre = torch.matmul(x.float(), wp.float().t())
        ref = geglu_packed(ref_pre)
        excess = ((h.float() - ref).abs() - 2.0**-8 * ref.abs() - 1e-4 * ref.abs().max()).max().item()
        pre_excess = ((pre.float() - ref_pre).abs() - 2.0**-7 * ref_pre.abs() - 1e-4 * ref_pre.abs().max()).max().item()
        pad_zero = bool((h[:, inner:] == 0).all()) if ip > inner else True
        numbers = dict(rows=rows, d=d, inner=inner, padded=ip, max_abs_err=(h.float() - ref).abs().max().item(),
                       excess=excess, pre_excess=pre_excess, padded_columns_zero=pad_zero)
        if timed:
            cycle = itertools.cycle(xs)
            w_pad_out = pad_proj_out(w_out)
            numbers["ms"] = cuda_ms(lambda: geglu_gemm(next(cycle), wp), reps=20)
            numbers["graph_ms"] = graph_ms(lambda: geglu_gemm(next(cycle), wp), reps=20)
            numbers["pre_graph_ms"] = graph_ms(lambda: geglu_gemm(next(cycle), wp, pre=True), reps=10)
            numbers["plain_ms"] = cuda_ms(lambda: geglu_gemm_plain(next(cycle), wp), reps=10)
            numbers["unaligned_ms"] = cuda_ms(lambda: geglu(F.linear(next(cycle), w)), reps=10)
            numbers["aligned_product_ms"] = cuda_ms(lambda: torch.matmul(next(cycle), wp.t()), reps=10)
            numbers["ff_before_ms"] = cuda_ms(lambda: F.linear(geglu(F.linear(next(cycle), w)), w_out), reps=10)
            numbers["ff_ms"] = cuda_ms(lambda: torch.matmul(geglu_gemm(next(cycle), wp), w_pad_out.t()), reps=10)
            numbers["ff_graph_ms"] = graph_ms(lambda: torch.matmul(geglu_gemm(next(cycle), wp), w_pad_out.t()),
                                              reps=10)
            numbers["bound_ms"], numbers["bound_by"] = bound(nbytes(x, w) + rows * inner * 2, 2.0 * rows * d * 2 * inner)
            numbers["graph_roofline_pct"] = 100.0 * numbers["bound_ms"] / numbers["graph_ms"]
            numbers["ff_bound_ms"] = bound(nbytes(x, w, w_out) + 2 * rows * inner * 2 + rows * d * 2,
                                           2.0 * rows * d * 3 * inner)[0]
        phase(f"geglu_gemm {tag}", **numbers)
        check(excess <= 0.0, f"geglu_gemm {tag}: off the f32 GEGLU by {excess} beyond its tolerance")
        check(pre_excess <= 0.0, f"geglu_gemm {tag}: pre-activation off the f32 product by {pre_excess}")
        check(pad_zero, f"geglu_gemm {tag}: a padded column of h is not 0")
        result[tag] = dict(numbers, library_ms=numbers.get("unaligned_ms"))
        del xs, x, h, pre, ref, ref_pre
    torch.cuda.empty_cache()
    # small f32 shapes of the card checks' models: the CUDA-core kernel
    for rows, d, inner in ((300, 128, 341), (77, 48, 40)):
        x = torch.randn(rows, d, generator=gen).to("cuda")
        wp = pack_proj_in(torch.randn(2 * inner, d, generator=gen).to("cuda") / d**0.5)
        h = geglu_gemm(x, wp)
        err = (h - geglu_gemm_plain(x, wp)).abs().max().item()
        phase(f"geglu_gemm f32 {rows}x{d} inner {inner}", max_abs_err=err)
        check(err <= 1e-5, f"geglu_gemm f32 {rows}x{d}: {err} off the plain version")
    return result


def check_small_model(torch, reference_layout=False):
    """A small fp32 model whose shapes pass both kernel gates, sampled greedy
    on the card and on the CPU (plain versions): ids equal, video atol 1e-4.
    `reference_layout` builds the MaskGit and the C-ViViT with the quirks of
    reference-trained weights (`reference_attention_kv`, and the C-ViViT's
    `peg_reference_layout`)."""
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(3)
    flags = dict(reference_attention_kv=True) if reference_layout else {}
    cv_flags = dict(flags, peg_reference_layout=True) if reference_layout else {}
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, 1, dim_head=64, heads=2, **cv_flags), gen)
    mg = init_parameters(MaskGit(128, 512, 192, depth=2, heads=2, dim_head=64, dim_context=64, **flags), gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0
    videos, ids = {}, {}
    for device in ("cpu", "cuda"):
        ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=6,
                     max_text_len=16)
        kw = dict(num_frames=5, text_embeds=emb, cond_scale=5.0, starting_temperature=0.0,
                  generator=torch.Generator().manual_seed(0))
        before = kernel_counts()
        ids[device] = ph.sample_ids(**kw).cpu()
        videos[device] = ph.sample(**kw).float().cpu()
        launched = launched_since(before)
    err = (videos["cuda"] - videos["cpu"]).abs().max().item()
    label = "small fp32 reference-layout model" if reference_layout else "small fp32 model"
    phase(f"{label} card vs cpu", ids_equal=bool(torch.equal(ids["cuda"], ids["cpu"])),
          video_max_abs_err=err, kernel_launches=nonzero(launched))
    check(launched["fwd"] > 0 and launched["proj"] > 0, "the small model did not launch both kernels")
    check(torch.equal(ids["cuda"], ids["cpu"]), "greedy ids differ between card and CPU")
    check(err <= 1e-4, f"video differs between card and CPU by {err}")


def logits_path_ids(torch, ph, text_embeds, generator, *, num_frames, cond_scale=5.0,
                    starting_temperature=0.9):
    """Decode through the logits path, as a user of `maskgit_sample_loop`
    does: the stacked (2b, n, V) cond/null logits of
    `MaskGit.forward_with_cond_scale(combine=False)` go to the logits-path
    sampler, which fuses the CFG combine. Returns the ids (b, n)."""
    from phenaki_tpu_torch.models.sampling_loop import maskgit_sample_loop

    mg = ph.maskgit.eval()
    device = mg.to_logits.weight.device
    text = ph.pad_text_embeds(text_embeds.to(device))
    mask = (text != 0).any(dim=-1)
    patch_shape = ph.cvivit.get_video_patch_shape(num_frames)
    with torch.inference_mode():
        bias = mg.rel_pos_bias(patch_shape)
        return maskgit_sample_loop(
            lambda ids: mg.forward_with_cond_scale(
                ids, video_patch_shape=patch_shape, context=text, text_mask=mask,
                cond_scale=cond_scale, attn_bias=bias, combine=False),
            stacked_cfg_scale=cond_scale, batch=text.shape[0],
            num_tokens_seq=ph.cvivit.num_tokens_per_frames(num_frames), mask_id=mg.mask_id,
            device=device, steps=ph.steps, starting_temperature=starting_temperature,
            generator=generator)


def sample_requests(torch):
    """(name, text embeddings, seed): a warm-up, three b = 1 prompts, b = 2,
    and the first prompt again with its seed."""
    def embeds(b, seed):
        return torch.randn(b, 50, 768, generator=torch.Generator().manual_seed(seed))

    return [("warmup", embeds(1, 100), 10), ("req1", embeds(1, 101), 11),
            ("req2", embeds(1, 102), 12), ("req3", embeds(1, 103), 13),
            ("batch2", embeds(2, 104), 14), ("req1_again", embeds(1, 101), 11)]


def run_sample_path(torch, label, sample, per_sample):
    """Flagship requests through `sample(text_embeds, generator)`, 17 frames
    of 256 x 128 each: every request launches exactly `per_sample` kernels
    (counts set to 0 before the path, read after it); the same seed gives
    the same video, distinct prompts distinct videos."""
    torch.cuda.reset_peak_memory_stats()  # the kernel checks before allocated more
    reset_kernel_counts()
    videos, seconds = {}, {}
    for name, emb, seed in sample_requests(torch):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = sample(emb, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        counts = launched_since(before)
        b = emb.shape[0]
        check(tuple(video.shape) == (b, 17, 256, 128, 3), f"{label} {name}: video shape {tuple(video.shape)}")
        check(torch.isfinite(video).all().item(), f"{label} {name}: non-finite video")
        check(counts == exact(per_sample), f"{label} {name}: launches {nonzero(counts)} != {per_sample}")
        videos[name] = video
        phase(f"{label} {name}", batch=b, seconds=seconds[name], launches=nonzero(counts),
              video_mean=video.float().mean().item(), video_std=video.float().std().item())
    launches = kernel_counts()
    check(torch.equal(videos["req1"], videos["req1_again"]), f"{label}: the same seed gave a different video")
    check(not torch.equal(videos["req1"][:, :1], videos["req2"][:, :1]), f"{label}: distinct prompts gave one video")
    per_sample_s = statistics.median(seconds[n] for n in ("req1", "req2", "req3"))
    PATH_NUMBERS[label] = dict(seconds_per_sample_b1=per_sample_s, seconds_batch2=seconds["batch2"],
                               frames_per_s_b1=17 / per_sample_s,
                               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    phase(label, **PATH_NUMBERS[label], launches=nonzero(launches))
    return launches


def device_shares(torch, events, kernel="flash_fwd_wgmma"):
    """From a profiler's `key_averages()`: the device milliseconds (the self
    time of the rows that are device events other than user annotations,
    the table's "Self CUDA time total"; an operator's row repeats its
    kernels' time) and those of the kernels whose name holds `kernel`."""
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in rows if kernel in e.key) / 1e3
    return device_ms, kernel_ms


def profile_samples(torch, sample, path, n=3, label="sample profile", emb=None):
    """`torch.profiler` over `n` more flagship samples of `emb` (the path
    has warmed up; by default a b = 1 request), written to `path`: device
    time by kernel and operator. The phase line (`label`) gives device and
    wall milliseconds a sample, the idle share (1 - device / wall) and
    kernel 1's device time and share."""
    from torch.profiler import ProfilerActivity, profile

    emb = sample_requests(torch)[1][1] if emb is None else emb
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            sample(emb, torch.Generator().manual_seed(11 + i))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    events = prof.key_averages()
    device_ms, flash_ms = (x / n for x in device_shares(torch, events))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(
        events.table(sort_by="self_device_time_total", row_limit=50, max_name_column_width=100)
        + "\n" + events.table(sort_by="cpu_time_total", row_limit=40, max_name_column_width=100))
    phase(label, path=str(path), samples=n, device_ms_per_sample=device_ms,
          wall_ms_per_sample=wall_ms, idle=1 - device_ms / wall_ms, flash_fwd_ms_per_sample=flash_ms,
          flash_fwd_share=flash_ms / device_ms)


def run_sample_paths(torch, profile_path=None):
    """The flagship sampled four ways, each model built by its preset: plain
    (`flagship_phenaki(...).sample`), on the logits path (its MaskGit through
    `maskgit_sample_loop(logits_fn=..., stacked_cfg_scale=5)`), and
    critic-guided with a TokenCritic and with a SelfCritic. Returns each
    path's launches. With `profile_path`, the plain path is profiled after
    its run (`profile_samples`)."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    paths = {}
    for label, kw in (("sample", {}), ("token_critic_sample", {"critic": True}),
                      ("self_critic_sample", {"self_token_critic": True})):
        t0 = time.perf_counter()
        ph = flagship_phenaki(seed=0, device="cuda", **kw)
        torch.cuda.synchronize()
        phase(f"{label} model", build_model_s=time.perf_counter() - t0)

        def sample(emb, gen):
            return ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, generator=gen)

        per_sample = SAMPLE_LAUNCHES if not kw else CRITIC_SAMPLE_LAUNCHES
        paths[label] = run_sample_path(torch, label, sample, per_sample)
        if not kw and profile_path:
            profile_samples(torch, sample, profile_path)
        if not kw:
            def logits_sample(emb, gen):
                ids = logits_path_ids(torch, ph, emb, gen, num_frames=17)
                with torch.inference_mode():
                    return ph.cvivit.decode_from_codebook_indices(ids)

            paths["logits_path_sample"] = run_sample_path(torch, "logits_path_sample", logits_sample,
                                                          LOGITS_SAMPLE_LAUNCHES)
        del ph
        torch.cuda.empty_cache()
    return paths


def timed(torch, fn):
    """(fn's result, host seconds of fn ending in a synchronise)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def run_tokenize_path(torch, cvivit, card, profile_path=None):
    """`CViViT.tokenize` of the seeded flagship C-ViViT (bf16) on B = 32
    seeded uniform videos of 17 x 256 x 128. After a warm-up call, a window
    of `TOKENIZE_CALLS` calls back to back, synchronised only at its ends,
    gives the path's launches, exactly `TOKENIZE_LAUNCHES` a call. Then as
    many calls each timed alone give the median s a call, each with exact
    launches and ids (32, 9, 16, 8) in [0, 65536); then a second window.
    videos/s is B x calls over the two windows' seconds, each window's
    beside it (the first comes straight after the warm-up, so the two show
    whether order moves it). Then the kernel route against the plain
    one: the weights copied into an f32 C-ViViT on the card and one on the
    CPU, the full forward of two of the videos through both. With
    `profile_path`, three more calls are profiled (`profile_samples`)."""
    import copy

    gen = torch.Generator(device="cuda").manual_seed(21)
    videos = torch.rand(TOKENIZE_BATCH, 17, 256, 128, 3, generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cvivit.tokenize(videos)  # warm-up
    reset_kernel_counts()
    window_s = [timed(torch, lambda: [cvivit.tokenize(videos) for _ in range(TOKENIZE_CALLS)])[1]]
    launches = kernel_counts()
    window = {k: v * TOKENIZE_CALLS for k, v in TOKENIZE_LAUNCHES.items()}
    check(launches == exact(window), f"tokenize: launches {nonzero(launches)} != {window}")
    seconds = []
    for _ in range(TOKENIZE_CALLS):
        before = kernel_counts()
        ids, s = timed(torch, lambda: cvivit.tokenize(videos))
        seconds.append(s)
        counts = launched_since(before)
        check(counts == exact(TOKENIZE_LAUNCHES), f"tokenize: launches {nonzero(counts)} != {TOKENIZE_LAUNCHES}")
    check(tuple(ids.shape) == (TOKENIZE_BATCH, 9, 16, 8), f"tokenize: ids shape {tuple(ids.shape)}")
    check(0 <= ids.min().item() and ids.max().item() < 65536, "tokenize: ids out of the codebook")
    window_s.append(timed(torch, lambda: [cvivit.tokenize(videos) for _ in range(TOKENIZE_CALLS)])[1])
    per_call = statistics.median(seconds)
    phase("tokenize path", card=card, batch=TOKENIZE_BATCH, frames=17, calls_per_window=TOKENIZE_CALLS,
          window_s=window_s, vids_per_s=TOKENIZE_BATCH * TOKENIZE_CALLS * len(window_s) / sum(window_s),
          window_vids_per_s=[TOKENIZE_BATCH * TOKENIZE_CALLS / w for w in window_s],
          median_seconds_per_call=per_call, median_call_vids_per_s=TOKENIZE_BATCH / per_call,
          seconds_per_call=seconds, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          distinct_ids=ids.unique().numel(), launches=nonzero(launches))
    if profile_path:
        profile_samples(torch, lambda emb, gen: cvivit.tokenize(videos), profile_path, label="tokenize profile")

    # the kernel route (f32 flash on the card) against the plain one (CPU)
    small = videos[:2]
    mods = {"cuda": copy.deepcopy(cvivit).float(), "cpu": copy.deepcopy(cvivit).float().cpu()}
    out = {}
    with torch.no_grad():
        for device, mod in mods.items():
            x = small.to(device)
            z = mod.vq.pre_sign(mod.encode(mod._to_patch_tokens(x)).reshape(2, -1, 512))
            recon, ids2, aux = mod(x)
            out[device] = dict(z=z.cpu(), recon=recon.cpu(), ids=ids2.cpu(), aux=aux.item())
        same_ids = out["cpu"]["ids"].to("cuda")
        decoded = {device: mod.decode_from_codebook_indices(same_ids.to(device)).cpu()
                   for device, mod in mods.items()}
    agree = (out["cuda"]["ids"] == out["cpu"]["ids"]).float().mean().item()
    z_err = (out["cuda"]["z"] - out["cpu"]["z"]).abs().max().item()
    recon_err = (out["cuda"]["recon"] - out["cpu"]["recon"]).abs().max().item()
    decode_err = (decoded["cuda"] - decoded["cpu"]).abs().max().item()
    aux_rel = abs(out["cuda"]["aux"] - out["cpu"]["aux"]) / max(abs(out["cpu"]["aux"]), 1e-6)
    phase("tokenize f32 card vs cpu", batch=2, id_agreement=agree, z_max_abs_err=z_err,
          recon_max_abs_err=recon_err, decode_same_ids_max_abs_err=decode_err, aux_loss_rel_err=aux_rel)
    check(agree >= 0.999, f"tokenize: card and CPU ids agree on {agree} < 0.999")
    check(z_err <= 1e-3, f"tokenize: pre-sign activations differ by {z_err} > 1e-3")
    check(decode_err <= 1e-3, f"tokenize: decode of the same ids differs by {decode_err} > 1e-3")
    check(agree < 1.0 or recon_err <= 1e-3, f"tokenize: recon differs by {recon_err} > 1e-3 on equal ids")
    check(aux_rel <= 1e-4, f"tokenize: aux loss differs by {aux_rel} relative")
    del videos, mods
    return launches


LONG_VIDEO_TEXTS = [f"scene {k}: a red ball rolls across a green field and turns {k} times"
                    for k in range(len(LONG_VIDEO_FRAMES))]


def run_long_video_path(torch, ph, profile_path=None):
    """`make_video` over 17 hash-encoded texts, 17 + 16 x 16 = 273 frames of
    256 x 128, each scene after the first primed with the last 5 frames of
    the one before, after a two-scene warm-up. The timed pass is the bare
    call, synchronised only at its ends: its seconds and the path's
    launches, exactly `SAMPLE_LAUNCHES` + 16 x `PRIMED_SCENE_LAUNCHES`; the
    video is (1, 273, 256, 128, 3) and finite. A second pass with the same
    seed reads each scene's host seconds, its prime's tokenize milliseconds
    and its launches around `Phenaki.sample` and `CViViT.tokenize` (the
    functions make_video calls; each read synchronises): scene 1 launches
    exactly `SAMPLE_LAUNCHES`, each primed scene `PRIMED_SCENE_LAUNCHES`.
    A third pass, bare again, times the call once more (the first comes
    straight after the warm-up); frames/s is the frames of the two bare
    passes over their seconds. All three give the same video.
    With `profile_path`, three more primed scenes (the video's last 5
    frames as their prime) are profiled (`profile_samples`)."""
    from phenaki_tpu_torch.models.phenaki import make_video

    def run(n_scenes, seed):
        return make_video(ph, LONG_VIDEO_TEXTS[:n_scenes], num_frames=LONG_VIDEO_FRAMES[:n_scenes],
                          prime_lengths=LONG_VIDEO_PRIME, cond_scale=5.0,
                          generator=torch.Generator().manual_seed(seed))

    run(2, 30)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    (video, parts), seconds = timed(torch, lambda: run(len(LONG_VIDEO_FRAMES), 31))
    launches = kernel_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    n_primed = len(LONG_VIDEO_FRAMES) - 1
    whole = {k: SAMPLE_LAUNCHES.get(k, 0) + n_primed * PRIMED_SCENE_LAUNCHES.get(k, 0)
             for k in SAMPLE_LAUNCHES.keys() | PRIMED_SCENE_LAUNCHES.keys()}
    check(launches == exact(whole), f"long video: launches {nonzero(launches)} != {whole}")
    frames = sum(LONG_VIDEO_FRAMES)
    check(len(parts) == len(LONG_VIDEO_FRAMES), f"long video: {len(parts)} scenes sampled")
    check(tuple(video.shape) == (1, frames, 256, 128, 3), f"long video: shape {tuple(video.shape)}")
    check(torch.isfinite(video).all().item(), "long video: non-finite values")

    # the instrumented pass: each scene and each prime tokenize timed alone
    sample, tokenize = ph.sample, ph.cvivit.tokenize
    scenes, tokenize_s = [], []

    def timed_tokenize(video):
        ids, s = timed(torch, lambda: tokenize(video))
        tokenize_s.append(s)
        return ids

    def timed_sample(**kw):
        before, primes = kernel_counts(), len(tokenize_s)
        video, s = timed(torch, lambda: sample(**kw))
        scenes.append(dict(seconds=s, prime_tokenize_ms=sum(tokenize_s[primes:]) * 1e3,
                           launches=launched_since(before)))
        return video

    ph.sample, ph.cvivit.tokenize = timed_sample, timed_tokenize
    try:
        traced, _ = run(len(LONG_VIDEO_FRAMES), 31)
    finally:
        del ph.sample, ph.cvivit.tokenize
    for k, scene in enumerate(scenes):
        per_scene = SAMPLE_LAUNCHES if k == 0 else PRIMED_SCENE_LAUNCHES
        phase(f"long video scene {k + 1}", frames=parts[k].shape[1], seconds=scene["seconds"],
              prime_tokenize_ms=scene["prime_tokenize_ms"], launches=nonzero(scene["launches"]))
        check(scene["launches"] == exact(per_scene),
              f"long video scene {k + 1}: launches {nonzero(scene['launches'])} != {per_scene}")
    (again, _), seconds2 = timed(torch, lambda: run(len(LONG_VIDEO_FRAMES), 31))
    phase("long video path", scenes=len(parts), frames=frames, seconds=[seconds, seconds2],
          frames_per_s=2 * frames / (seconds + seconds2), instrumented_seconds=sum(x["seconds"] for x in scenes),
          seconds_per_scene=[x["seconds"] for x in scenes],
          median_primed_scene_s=statistics.median(x["seconds"] for x in scenes[1:]),
          peak_mem_gb=peak_mem_gb, video_mean=video.float().mean().item(),
          video_std=video.float().std().item(), launches=nonzero(launches))
    check(len(scenes) == len(LONG_VIDEO_FRAMES), f"long video: {len(scenes)} scenes in the instrumented pass")
    check(torch.equal(traced, video) and torch.equal(again, video), "long video: a pass gave another video")
    del traced, again
    if profile_path:
        prime = video[:, -LONG_VIDEO_PRIME:]
        profile_samples(torch, lambda emb, gen: ph.sample(num_frames=16, text_embeds=emb, prime_frames=prime,
                                                          cond_scale=5.0, generator=gen),
                        profile_path, label="primed scene profile")
    return launches


def run_sample_images_path(torch, ph):
    """`Phenaki.sample_images` at b = 1 from a text, after a warm-up: each
    call launches exactly `IMAGE_LAUNCHES` and gives a finite (1, 256, 128,
    3) image; the same seed gives the same image."""
    text = "a red ball on green grass"
    ph.sample_images(texts=text, cond_scale=5.0, generator=torch.Generator().manual_seed(40))
    reset_kernel_counts()
    images, seconds = [], []
    for seed in (41, 42, 41):
        before = kernel_counts()
        image, s = timed(torch, lambda: ph.sample_images(texts=text, cond_scale=5.0,
                                                         generator=torch.Generator().manual_seed(seed)))
        counts = launched_since(before)
        check(counts == exact(IMAGE_LAUNCHES), f"sample_images: launches {nonzero(counts)} != {IMAGE_LAUNCHES}")
        check(tuple(image.shape) == (1, 256, 128, 3), f"sample_images: shape {tuple(image.shape)}")
        check(torch.isfinite(image).all().item(), "sample_images: non-finite values")
        images.append(image)
        seconds.append(s)
    launches = kernel_counts()
    phase("sample_images path", batch=1, seconds=seconds, launches=nonzero(launches))
    check(torch.equal(images[0], images[2]), "sample_images: the same seed gave another image")
    return launches


def run_long_video_paths(torch, card, tokenize_profile=None, scene_profile=None):
    """The primed flagship (`flagship_phenaki(num_frames=21)`: max_seq_len
    11 x 128 = 1408, a 5-frame prime and a 16-frame scene): its C-ViViT's
    tokenize path, the 17-scene long video and `sample_images`. Returns
    each path's launches. The profiles as for `run_tokenize_path` and
    `run_long_video_path`."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    ph, s = timed(torch, lambda: flagship_phenaki(seed=0, device="cuda", num_frames=21))
    phase("primed model", build_model_s=s)
    paths = {"tokenize": run_tokenize_path(torch, ph.cvivit, card, tokenize_profile)}
    torch.cuda.empty_cache()
    paths["long_video"] = run_long_video_path(torch, ph, scene_profile)
    paths["sample_images"] = run_sample_images_path(torch, ph)
    del ph
    torch.cuda.empty_cache()
    return paths


def probed_server(torch, ph, **kw):
    """A `PhenakiServer` whose dispatcher records, at each hand-off to the
    resolver (one a single-scene launch, one a video group): the kernel
    launches since the hand-off before, the host time, and a timing event
    recorded right after the server's own (after the copy to the host). A
    future's resolution time is read by its done callback; the delivery lag
    of a hand-off is the last of its futures' resolution times minus the
    host time at which its event completed on the card (the event's offset
    from an epoch event that was synchronised on the host)."""
    from phenaki_tpu_torch.serving import PhenakiServer

    class ProbedServer(PhenakiServer):
        def __init__(self, *a, **kw):
            self.handoffs = []
            self._mark = kernel_counts()
            self.epoch = torch.cuda.Event(enable_timing=True)
            self.epoch.record()
            self.epoch.synchronize()
            self.epoch_s = time.perf_counter()
            super().__init__(*a, **kw)

        def _handoff(self, videos, batch):
            super()._handoff(videos, batch)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            now = kernel_counts()
            self.handoffs.append(dict(futures=[r.future for r in batch], event=done,
                                      handoff_s=time.perf_counter(),
                                      launches={k: now[k] - self._mark[k] for k in now}))
            self._mark = now

        def rebase(self):
            """Count the next hand-off's launches from now (after a prewarm)."""
            self._mark = kernel_counts()

        def delivery(self, resolved):
            """Per hand-off: (host s of the device completion, delivery lag s)."""
            out = []
            for h in self.handoffs:
                done_s = self.epoch_s + self.epoch.elapsed_time(h["event"]) / 1e3
                out.append((done_s, max(resolved[f] for f in h["futures"]) - done_s))
            return out

    return ProbedServer(ph, **kw)


def track(futures, resolved):
    """Record each future's resolution time (host s) into `resolved`."""
    for f in futures:
        f.add_done_callback(lambda f: resolved.__setitem__(f, time.perf_counter()))
    return futures


def check_handoffs(label, server, per_handoff):
    for i, (h, per) in enumerate(zip(server.handoffs, per_handoff)):
        check(h["launches"] == exact(per), f"{label} hand-off {i}: launches {nonzero(h['launches'])} != {per}")
    check(len(server.handoffs) == len(per_handoff), f"{label}: {len(server.handoffs)} hand-offs")


def scaled(per, n):
    return {k: v * n for k, v in per.items()}


def summed(*pers):
    return {k: sum(p.get(k, 0) for p in pers) for k in set().union(*pers)}


def run_serving_path(torch, ph, card, profile_path=None):
    """The flagship behind `PhenakiServer` as the TPU package's bench.py
    serves it (`SERVE_*`): `prewarm` (one dummy launch a bucket, so that no
    timed launch is the model's first at its batch; its launches exact and
    the launch log left empty), a warm request, then 24 seeded (50, 768)
    embeddings requests submitted at once. Every future's result is read:
    a (17, 256, 128, 3) uint8 video each, not all equal; the launch log is
    `SERVE_LOG`; each launch makes exactly a flagship sample's launches.
    Reports served videos/s and frames/s over the 24, the median and largest
    latency, peak memory, each of the burst's launches' host seconds (from
    the burst's submission, or the hand-off before, to its own hand-off),
    how long after its hand-off the card finished it, and the delivery lag
    of every launch;
    then, in the same phase, the bare `Phenaki.sample` at b = 8 (twice) and
    b = 1 (three times) on the same model. With `profile_path`, three more
    bare b = 8 samples, a served launch's work, are profiled
    (`profile_samples`)."""
    reqs = torch.randn(SERVE_REQUESTS, 50, 768, generator=torch.Generator().manual_seed(9)).numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    resolved = {}
    server = probed_server(torch, ph, num_frames=17, cond_scale=5.0, batch_buckets=SERVE_BUCKETS,
                           max_delay_ms=SERVE_DELAY_MS, seed=0)
    try:
        before, t_prewarm = kernel_counts(), time.perf_counter()
        server.prewarm()
        prewarm_s = time.perf_counter() - t_prewarm
        prewarmed = launched_since(before)
        check(prewarmed == exact(scaled(SAMPLE_LAUNCHES, len(SERVE_BUCKETS))),
              f"serving: prewarm launched {nonzero(prewarmed)}")
        check(server.launch_log == [], f"serving: prewarm logged {server.launch_log}")
        server.rebase()
        warm, = track([server.submit(text_embeds=reqs[0])], resolved)
        warm.result(timeout=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        futures = track([server.submit(text_embeds=r) for r in reqs], resolved)
        videos = [f.result(timeout=SERVE_TIMEOUT_S) for f in futures]
        seconds = time.perf_counter() - t0
        log = server.launch_log
    finally:
        server.close()
    launches = kernel_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    for v in videos:
        check(v.shape == (17, 256, 128, 3) and v.dtype.name == "uint8", f"serving: video {v.shape} {v.dtype}")
    check(any((v != videos[0]).any() for v in videos[1:]), "serving: every request gave one video")
    check(log == SERVE_LOG, f"serving: launch log {log} != {SERVE_LOG}")
    check_handoffs("serving", server, [SAMPLE_LAUNCHES] * len(SERVE_LOG))
    latencies = sorted(resolved[f] - t0 for f in futures)
    delivery = server.delivery(resolved)
    handoff_s = [h["handoff_s"] for h in server.handoffs]

    def bare(b, n, seed):
        emb = torch.from_numpy(reqs[:b]).cuda()
        return [timed(torch, lambda: ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0,
                                               generator=torch.Generator().manual_seed(seed + i)))[1]
                for i in range(n)]

    bare8, bare1 = bare(8, 2, 50), bare(1, 3, 60)
    if profile_path:
        profile_samples(torch, lambda emb, gen: ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0,
                                                          generator=gen),
                        profile_path, label="serving b8 profile", emb=torch.from_numpy(reqs[:8]))
    served = SERVE_REQUESTS / seconds
    phase("serving path", card=card, requests=SERVE_REQUESTS, buckets=list(SERVE_BUCKETS),
          max_delay_ms=SERVE_DELAY_MS, prewarm_s=prewarm_s, seconds=seconds, served_videos_per_s=served,
          served_frames_per_s=17 * served, latency_median_s=statistics.median(latencies),
          latency_max_s=latencies[-1], launch_log=log,
          launches_per_launch=[nonzero(h["launches"]) for h in server.handoffs],
          launch_host_s=[b - a for a, b in zip([t0] + handoff_s[1:-1], handoff_s[1:])],
          device_done_after_handoff_ms=[(d - h) * 1e3 for (d, _), h in zip(delivery, handoff_s)],
          delivery_lag_ms=[lag * 1e3 for _, lag in delivery], peak_mem_gb=peak_mem_gb,
          bare_b8_seconds=bare8, bare_b8_videos_per_s=8 / statistics.median(bare8),
          bare_b1_seconds=bare1, bare_b1_videos_per_s=1 / statistics.median(bare1),
          served_over_bare_b8=served / (8 / statistics.median(bare8)))
    return launches


def run_serving_uint8(torch, ph):
    """Two servers with the same seed, uint8 and float32 output, each
    prewarmed (the kernels loaded, one dummy launch: a flagship sample's
    launches, and the launch log stays empty) and then given the same
    request: the uint8 video equals the float32 one quantised on the host,
    bit for bit."""
    import numpy as np

    emb = torch.randn(50, 768, generator=torch.Generator().manual_seed(70)).numpy()
    reset_kernel_counts()
    out = {}
    for dtype in ("uint8", "float32"):
        server = probed_server(torch, ph, num_frames=17, cond_scale=5.0, batch_buckets=(1,),
                               max_delay_ms=1.0, seed=3, output_dtype=dtype)
        try:
            before = kernel_counts()
            server.prewarm()
            warm = launched_since(before)
            check(warm == exact(SAMPLE_LAUNCHES), f"serving uint8: prewarm launched {nonzero(warm)}")
            check(server.launch_log == [], f"serving uint8: prewarm logged {server.launch_log}")
            server.rebase()
            out[dtype] = server.submit(text_embeds=emb).result(timeout=SERVE_TIMEOUT_S)
            check(server.launch_log == [(1, 1)], f"serving uint8: launch log {server.launch_log}")
        finally:
            server.close()
        check_handoffs(f"serving uint8 {dtype}", server, [SAMPLE_LAUNCHES])
    launches = kernel_counts()
    check(launches == exact(scaled(SAMPLE_LAUNCHES, 4)), f"serving uint8: launches {nonzero(launches)}")
    expected = np.clip(out["float32"] * 255.0, 0, 255).astype(np.uint8)
    mismatched = int((out["uint8"] != expected).sum())
    phase("serving uint8", dtypes=[str(out["uint8"].dtype), str(out["float32"].dtype)],
          shape=list(out["uint8"].shape), mismatched=mismatched, launches=nonzero(launches))
    check(out["uint8"].dtype == np.uint8 and out["float32"].dtype == np.float32, "serving uint8: dtypes")
    check(mismatched == 0, f"serving uint8: {mismatched} values differ from the quantised float32")
    return launches


def run_serving_video(torch, ph):
    """Multi-scene requests on the primed flagship: two 3-scene requests
    (`SERVE_VIDEO_FRAMES`, primes of `SERVE_PRIME` frames) coalesce into
    bucket 2, three (2, 2) launches and one (49, 256, 128, 3) video each;
    then a 2-scene request continuing an uploaded uint8 prime of (5, 256,
    128, 3) frames, two (1, 1) launches and a (32, 256, 128, 3) video.
    Launches exact: a flagship sample's for scene 1, a primed scene's after."""
    texts = [[f"request {r} scene {k}: a ball rolls {k + 1} times" for k in range(3)] for r in range(3)]
    upload = torch.randint(0, 256, (SERVE_PRIME, 256, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(80)).numpy()
    reset_kernel_counts()
    resolved = {}
    server = probed_server(torch, ph, num_frames=17, cond_scale=5.0, batch_buckets=(1, 2),
                           max_delay_ms=SERVE_DELAY_MS, seed=0)
    try:
        t0 = time.perf_counter()
        futures = track([server.submit_video(texts[0], num_frames=SERVE_VIDEO_FRAMES, prime_lengths=SERVE_PRIME),
                         server.submit_video(texts[1], num_frames=SERVE_VIDEO_FRAMES, prime_lengths=SERVE_PRIME),
                         server.submit_video(texts[2][:2], num_frames=SERVE_UPLOAD_FRAMES,
                                             prime_lengths=SERVE_PRIME, prime_video=upload)], resolved)
        videos = [f.result(timeout=SERVE_TIMEOUT_S) for f in futures]
        log = server.launch_log
    finally:
        server.close()
    launches = kernel_counts()
    frames = sum(SERVE_VIDEO_FRAMES)
    check([v.shape for v in videos] == [(frames, 256, 128, 3)] * 2 + [(sum(SERVE_UPLOAD_FRAMES), 256, 128, 3)],
          f"serving video: shapes {[v.shape for v in videos]}")
    check((videos[0] != videos[1]).any(), "serving video: two requests gave one video")
    check(log == SERVE_VIDEO_LOG, f"serving video: launch log {log} != {SERVE_VIDEO_LOG}")
    check_handoffs("serving video", server, [summed(SAMPLE_LAUNCHES, scaled(PRIMED_SCENE_LAUNCHES, 2)),
                                             scaled(PRIMED_SCENE_LAUNCHES, 2)])
    phase("serving video requests", shapes=[list(v.shape) for v in videos], launch_log=log,
          latency_s=[resolved[f] - t0 for f in futures],
          delivery_lag_ms=[lag * 1e3 for _, lag in server.delivery(resolved)],
          launches_per_group=[nonzero(h["launches"]) for h in server.handoffs])
    return launches


def run_serving_http(torch, ph):
    """After a GIF is encoded once (the codec's first use builds its native
    library), `serve_http` on 127.0.0.1 (a free port) in a thread for 3 requests:
    GET /healthz (polled until up), POST /generate from a text (hash
    encoded) and POST /generate_video (17 then 16 frames primed with 5):
    status 200 each, GIFs of 17 and 33 frames of 256 x 128."""
    import socket
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from phenaki_tpu_torch.serving import PhenakiServer, _gif_b64_to_video, _video_to_gif_b64, serve_http

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())

    # the GIF codec's native library is built at its first use: build it
    # first, so that the seconds below are the requests'
    _, codec_warm_s = timed(torch, lambda: _video_to_gif_b64(np.zeros((1, 16, 16, 3), np.uint8)))
    reset_kernel_counts()
    server = PhenakiServer(ph, num_frames=17, cond_scale=5.0, batch_buckets=(1,), max_delay_ms=1.0, seed=0)
    thread = threading.Thread(target=serve_http, args=(server, port), kwargs={"max_requests": 3}, daemon=True)
    thread.start()
    seconds, results = {}, {}
    try:
        t, deadline = time.perf_counter(), time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                    results["healthz"] = [r.status, r.read().decode()]
                break
            except urllib.error.URLError:
                check(time.monotonic() < deadline, "serving http: /healthz never answered")
                time.sleep(0.05)
        seconds["healthz"] = time.perf_counter() - t
        for name, path, body in (
                ("generate", "/generate", {"text": "a red ball rolls across a green field"}),
                ("generate_video", "/generate_video", {
                    "texts": ["a red ball rolls in", "the ball bounces away"], "num_frames": [17, 16],
                    "prime_lengths": SERVE_PRIME})):
            t = time.perf_counter()
            status, payload = post(path, body)
            seconds[name] = time.perf_counter() - t
            results[name] = [status, list(_gif_b64_to_video(payload["video_gif_b64"]).shape)]
    finally:
        thread.join(timeout=60)
        server.close()
    launches = kernel_counts()
    phase("serving http", port=port, results=results, seconds=seconds, codec_warm_s=codec_warm_s,
          launches=nonzero(launches))
    check(not thread.is_alive(), "serving http: the serve loop did not end")
    check(results["healthz"] == [200, "ok"], f"serving http: /healthz {results['healthz']}")
    check(results["generate"] == [200, [17, 256, 128, 3]], f"serving http: /generate {results['generate']}")
    check(results["generate_video"] == [200, [33, 256, 128, 3]],
          f"serving http: /generate_video {results['generate_video']}")
    per = summed(SAMPLE_LAUNCHES, SAMPLE_LAUNCHES, PRIMED_SCENE_LAUNCHES)
    check(launches == exact(per), f"serving http: launches {nonzero(launches)} != {per}")
    return launches


def run_serving_critic(torch, card):
    """One request to a server around the flagship with a TokenCritic:
    exactly a critic-guided sample's launches (424 of kernel 1)."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    ph = flagship_phenaki(seed=0, device="cuda", critic=True)
    emb = torch.randn(50, 768, generator=torch.Generator().manual_seed(90)).numpy()
    reset_kernel_counts()
    server = probed_server(torch, ph, num_frames=17, cond_scale=5.0, batch_buckets=(1,), max_delay_ms=1.0,
                           seed=0)
    try:
        t = time.perf_counter()
        video = server.submit(text_embeds=emb).result(timeout=SERVE_TIMEOUT_S)
        seconds = time.perf_counter() - t
    finally:
        server.close()
    launches = kernel_counts()
    phase("serving token critic", card=card, seconds=seconds, shape=list(video.shape),
          launch_log=server.launch_log, launches=nonzero(launches))
    check(video.shape == (17, 256, 128, 3), f"serving token critic: video {video.shape}")
    check_handoffs("serving token critic", server, [CRITIC_SAMPLE_LAUNCHES])
    del ph
    torch.cuda.empty_cache()
    return launches


def run_serving_paths(torch, card, profile_path=None):
    """Serving: the plain flagship ("serving path", "serving uint8"), the
    primed flagship (`flagship_phenaki(num_frames=21)`; "serving video
    requests", "serving http") and the flagship with a TokenCritic
    ("serving token critic"). Returns each path's launches."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    ph = flagship_phenaki(seed=0, device="cuda")
    paths = {"serving": run_serving_path(torch, ph, card, profile_path),
             "serving_uint8": run_serving_uint8(torch, ph)}
    del ph
    torch.cuda.empty_cache()
    ph = flagship_phenaki(seed=0, device="cuda", num_frames=21)
    paths["serving_video"] = run_serving_video(torch, ph)
    paths["serving_http"] = run_serving_http(torch, ph)
    del ph
    torch.cuda.empty_cache()
    paths["serving_token_critic"] = run_serving_critic(torch, card)
    return paths


def all_kernels():
    """Every kernel's wrapper by key: the attention forward, the ring chunk,
    their three backward kernels, the fused CE's forward and two backward kernels, the
    projection sampler, the logits-path sampler, PEG's stencil, the LayerNorm and
    the attention's head split with its q/k l2norm, and the feedforward's GEGLU
    GEMM."""
    import phenaki_tpu_torch.ops.attention as attention
    import phenaki_tpu_torch.ops.feedforward as feedforward
    import phenaki_tpu_torch.ops.flash_attention as fa
    import phenaki_tpu_torch.ops.fused_ce as ce
    import phenaki_tpu_torch.ops.fused_sampling as fs
    import phenaki_tpu_torch.ops.norms as norms
    import phenaki_tpu_torch.ops.positional as pos

    return {"fwd": fa.flash_attention, "chunk": fa.flash_attend_chunk, "dq": fa.flash_attention_bwd_dq,
            "dkv": fa.flash_attention_bwd_dkv, "dbias": fa.flash_attention_bwd_dbias,
            "ce_fwd": ce.fused_ce_fwd, "ce_dh": ce.fused_ce_bwd_dh, "ce_dw": ce.fused_ce_bwd_dw,
            "proj": fs.project_sample, "gumbel": fs.gumbel_sample_with_score, "peg": pos.peg_stencil,
            "ln": norms.layer_norm, "qk": attention.qk_norm_split, "ff": feedforward.geglu_gemm}


def kernel_counts():
    return {key: fn.launches for key, fn in all_kernels().items()}


def reset_kernel_counts():
    for fn in all_kernels().values():
        fn.launches = 0


def launched_since(before):
    return {k: v - before[k] for k, v in kernel_counts().items()}


def exact(per_call):
    """Launches of every kernel: `per_call`'s, and none of the others."""
    return {key: per_call.get(key, 0) for key in all_kernels()}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def check_t5_stack(torch):
    """`T5EncoderStack` at t5-v1_1-base's width with seeded random weights
    (torch's default init under seed 0), f32: 8 sequences of 128 ids, each
    padded after a seeded length, encoded on the card and on the CPU. The
    outputs within T5_TOL, padded positions exactly zero on the card; the
    card's milliseconds a call (back to back, `cuda_ms`)."""
    from phenaki_tpu_torch.text.t5_torch import T5EncoderConfig, T5EncoderStack

    cfg = T5EncoderConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        stack = T5EncoderStack(cfg).eval()
    gen = torch.Generator().manual_seed(9)
    ids = torch.randint(0, cfg.vocab_size, (T5_BATCH, T5_LEN), generator=gen)
    lengths = torch.randint(8, T5_LEN + 1, (T5_BATCH,), generator=gen)
    lengths[0] = T5_LEN
    mask = (torch.arange(T5_LEN)[None] < lengths[:, None]).long()
    with torch.no_grad():
        cpu = stack(ids, mask)
        stack.cuda()
        ids_c, mask_c = ids.cuda(), mask.cuda()
        card = stack(ids_c, mask_c)
        ms = cuda_ms(lambda: stack(ids_c, mask_c))
    err = (card.cpu() - cpu).abs().max().item()
    padded_zero = bool((card[mask_c == 0] == 0).all().item())
    check(err <= T5_TOL, f"t5 stack: card vs cpu max abs err {err} > {T5_TOL}")
    check(padded_zero, "t5 stack: a padded position is not zero on the card")
    phase("t5 stack card vs cpu", layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, batch=T5_BATCH, length=T5_LEN, lengths=lengths.tolist(), max_abs_err=err,
          tolerance=T5_TOL, max_abs_out=cpu.abs().max().item(), padded_zero=padded_zero, ms=ms)
    del stack
    torch.cuda.empty_cache()


def run_e2e_example(torch):
    """examples/e2e_smoke_torch.py's `main` in this process on the card:
    every stage must pass and the last line must be "E2E: ALL PASS"; its
    kernel launches are reported (the example's small model is not a main
    path)."""
    import contextlib
    import importlib.util
    import io

    example = Path(__file__).parent / "examples" / "e2e_smoke_torch.py"
    spec = importlib.util.spec_from_file_location("e2e_smoke_torch", example)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    reset_kernel_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(["--device", "cuda"])
    seconds = time.perf_counter() - t
    lines = buf.getvalue().strip().splitlines()
    check(bool(lines) and lines[-1] == "E2E: ALL PASS", f"e2e example: last line {lines[-1:] or None}")
    phase("e2e example on the card", seconds=seconds, stages=[line.split("] ", 1)[-1] for line in lines],
          launches=nonzero(kernel_counts()))


def small_train_models(torch, seed):
    """A small fp32 MaskGit over 128 tokens on a (2, 8, 8) grid with 2 x 64
    heads (both attention calls pass the kernel gate; dim 128 and a 512-word
    vocab pass the fused CE's) and the C-ViViT whose frame-to-token mask it
    needs."""
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(seed)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, 1, dim_head=64, heads=2), gen)
    mg = init_parameters(MaskGit(128, 512, 128, depth=2, heads=2, dim_head=64, dim_context=64), gen)
    return mg, cv


def check_small_train(torch):
    """`Phenaki.loss` and its backward on the same weights, ids, frame mask,
    text and draws (conditioning dropout on), on the card (the attention and
    CE kernels) and on the CPU (their plain versions). The loss agrees within 1e-4
    relative and each gradient within 1e-3 * max|g| of its tensor (floored
    at 1e-5: the CPB output bias's true gradient is 0, the softmax cancels
    a per-head constant), fp32 with TF32 off: cuBLAS and the CPU sum in
    other orders."""
    import copy

    from phenaki_tpu_torch.models.phenaki import Phenaki

    mg, cv = small_train_models(torch, 5)
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 512, (2, 2, 8, 8), generator=gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0
    frame_mask = torch.tensor([[True, True, True], [True, False, False]])
    runs = {}
    for device in ("cpu", "cuda"):
        ph = Phenaki(maskgit=copy.deepcopy(mg).to(device), cvivit=cv, text_embed_dim=64, steps=18,
                     max_text_len=16)
        before = kernel_counts()
        loss, _ = ph.loss(video_codebook_ids=ids, text_embeds=emb, video_frame_mask=frame_mask,
                          generator=torch.Generator().manual_seed(7))
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.cpu() for n, p in ph.maskgit.named_parameters()}
        runs[device] = (loss.item(), grads, launched_since(before))
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launched) = runs["cpu"], runs["cuda"]
    worst = max(((g_gpu[n] - r).abs().max() / max(r.abs().max().item(), 1e-5)).item()
                for n, r in g_cpu.items())
    phase("small fp32 train card vs cpu", loss_cpu=loss_cpu, loss_gpu=loss_gpu,
          worst_grad_rel_err=worst, kernel_launches=nonzero(launched))
    check(all(launched[k] > 0 for k in TRAIN_PER_STEP), f"the small train step did not launch every kernel: {launched}")
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu), f"loss differs: {loss_gpu} vs {loss_cpu}")
    check(worst <= 1e-3, f"a gradient differs between card and CPU by {worst} of its max")


def check_small_critic(torch):
    """Small fp32 models on the card (the kernels) and on the CPU (their
    plain versions), greedy (starting temperature 0, noise_K 0): the
    logits-path decode and critic-guided `sample_ids` with a TokenCritic and
    with a SelfCritic give the same ids; then `Phenaki.loss` with each
    critic, on the same weights, ids, text and draws and with the
    generator's sample uniforms injected, gives the same losses and every
    MaskGit and critic gradient within the tolerances of
    `check_small_train`."""
    import copy

    from torch import nn

    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(13)
    trunk = dict(depth=2, heads=2, dim_head=64, dim_context=64)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, 1, dim_head=64, heads=2), gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0

    def models(n_tokens, kind):
        mg = init_parameters(MaskGit(128, 512, n_tokens, **trunk), gen)
        critic = init_parameters(TokenCritic(128, 512, n_tokens, has_cross_attn=True, **trunk), gen)
        head = init_parameters(nn.Linear(128, 1), gen)
        return mg, critic if kind == "token" else None, head

    def phenaki(parts, kind, device):
        mg, critic, head = (copy.deepcopy(m) for m in parts)
        ph = Phenaki(maskgit=mg.to(device), cvivit=copy.deepcopy(cv).to(device), text_embed_dim=64, steps=6,
                     max_text_len=16, critic=critic.to(device) if critic is not None else None,
                     self_token_critic=kind == "self")
        if kind == "self":
            ph.critic.to_pred.load_state_dict(head.state_dict())
        return ph

    for kind in ("token", "self"):
        parts = models(192, kind)  # 5 frames: (3, 8, 8) tokens
        ids, launched = {}, {}
        for device in ("cpu", "cuda"):
            ph = phenaki(parts, kind, device)
            before = kernel_counts()
            kw = dict(text_embeds=emb, generator=torch.Generator().manual_seed(0), num_frames=5,
                      starting_temperature=0.0)
            ids[device] = (ph.sample_ids(cond_scale=5.0, noise_K=0.0, **kw).cpu(),
                           logits_path_ids(torch, ph, **kw).cpu())
            torch.cuda.synchronize()
            launched[device] = nonzero(launched_since(before))
        same = [torch.equal(a, b) for a, b in zip(ids["cpu"], ids["cuda"])]
        phase(f"small fp32 {kind} critic sampling card vs cpu", critic_guided_ids_equal=same[0],
              logits_path_ids_equal=same[1], kernel_launches=launched["cuda"])
        check(not launched["cpu"], f"the CPU run launched kernels: {launched['cpu']}")
        check(all(launched["cuda"].get(k, 0) > 0 for k in ("fwd", "proj", "gumbel")),
              f"the small {kind} critic sample did not launch every sampling kernel: {launched['cuda']}")
        check(all(same), f"greedy ids differ between card and CPU ({kind} critic): {same}")

    g = torch.Generator().manual_seed(14)
    vid = torch.randint(0, 512, (2, 2, 8, 8), generator=g)
    frame_mask = torch.tensor([[True, True, True], [True, False, False]])
    sample_noise = torch.rand(2, 128, 512, generator=g)
    for kind in ("token", "self"):
        parts = models(128, kind)  # (2, 8, 8) tokens
        runs = {}
        for device in ("cpu", "cuda"):
            ph = phenaki(parts, kind, device)
            ph._critic_sample_noise = lambda *a, device=device: sample_noise.to(device)
            before = kernel_counts()
            loss, metrics = ph.loss(video_codebook_ids=vid, text_embeds=emb, video_frame_mask=frame_mask,
                                    generator=torch.Generator().manual_seed(15))
            loss.backward()
            torch.cuda.synchronize()
            named = [*ph.maskgit.named_parameters(), *(("critic." + n, p) for n, p in ph.critic.named_parameters())]
            runs[device] = ({k: v.item() for k, v in metrics.items()}, {n: p.grad.cpu() for n, p in named},
                            nonzero(launched_since(before)))
        (m_cpu, g_cpu, _), (m_gpu, g_gpu, launched) = runs["cpu"], runs["cuda"]
        worst = max(((g_gpu[n] - r).abs().max() / max(r.abs().max().item(), 1e-5)).item()
                    for n, r in g_cpu.items())
        phase(f"small fp32 {kind} critic train card vs cpu", metrics_cpu=m_cpu, metrics_gpu=m_gpu,
              worst_grad_rel_err=worst, kernel_launches=launched)
        check(all(launched.get(k, 0) > 0 for k in (*TRAIN_PER_STEP, "proj")),
              f"the small {kind} critic loss did not launch every kernel: {launched}")
        for key, ref in m_cpu.items():
            check(abs(m_gpu[key] - ref) <= 1e-4 * abs(ref), f"{kind} critic {key}: {m_gpu[key]} vs {ref}")
        check(worst <= 1e-3, f"a {kind} critic-loss gradient differs between card and CPU by {worst} of its max")


def check_gumbel(torch):
    """`gumbel_sample` on CUDA logits with a CPU generator: it draws on the
    generator's device, so it gives the CPU's ids."""
    from phenaki_tpu_torch.ops.sampling import gumbel_sample

    logits = torch.randn(2, 64, 512, generator=torch.Generator().manual_seed(10))
    got = gumbel_sample(logits.cuda(), 0.9, generator=torch.Generator().manual_seed(11))
    ref = gumbel_sample(logits, 0.9, generator=torch.Generator().manual_seed(11))
    phase("gumbel_sample cuda logits, cpu generator", device=str(got.device),
          ids_equal_cpu=bool(torch.equal(got.cpu(), ref)))
    check(got.is_cuda and torch.equal(got.cpu(), ref), "gumbel_sample on the card differs from the CPU")


def check_learning(torch):
    """`PhenakiTrainer` on one repeated batch (the small model, lr 1e-3): the
    loss must fall by LEARN_MARGIN nats between the mean of the first 3 and
    of the last 5 of 40 steps, and by more than 5 times the step-to-step
    noise (the std of the last 10 steps' differences: each step masks
    another random share of the tokens)."""
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    mg, cv = small_train_models(torch, 8)
    ph = Phenaki(maskgit=mg.cuda(), cvivit=cv.cuda(), text_embed_dim=64, steps=18, max_text_len=16)
    gen = torch.Generator().manual_seed(9)
    item = (torch.randint(0, 512, (2, 8, 8), generator=gen), torch.randn(8, 64, generator=gen))
    with tempfile.TemporaryDirectory() as results:  # the step-1 milestone: a 3-frame sample
        trainer = PhenakiTrainer(ph, dataset=[item] * 4, batch_size=4, train_lr=1e-3, seed=0,
                                 log_every=10**9, num_frames=3, num_samples=1,
                                 sample_texts=[SAMPLE_TEXT], results_folder=results)
        losses = [trainer.train_step().item() for _ in range(40)]
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-5:])
    noise = statistics.stdev(b - a for a, b in zip(losses[-11:], losses[-10:]))
    phase("learning check", first=first, last=last, step_noise=noise, losses=losses[::5])
    check(all(map(math.isfinite, losses)), "non-finite loss in the learning check")
    check(first - last >= max(LEARN_MARGIN, 5 * noise),
          f"the loss fell by {first - last} (margin {LEARN_MARGIN}, noise {noise})")


def check_cvivit_overfit(torch, card):
    """tests/test_learning.py's C-ViViT overfit on the card in f32: seeded
    weights, one seeded batch of 2 videos of 3 x 16 x 16, OVERFIT_STEPS
    recon-only Adam steps (`cvivit_generator_loss(use_vgg_and_gan=False)`);
    the last step's recon loss below OVERFIT_DROP of the first, and the
    reconstruction PSNR up."""
    import numpy as np

    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.cvivit_losses import cvivit_generator_loss
    from phenaki_tpu_torch.ops.torch_init import init_parameters
    from phenaki_tpu_torch.training.optimizer import get_optimizer
    from phenaki_tpu_torch.utils.metrics import reconstruction_psnr

    model = init_parameters(CViViT(**OVERFIT_CVIVIT), torch.Generator().manual_seed(0)).cuda().train()
    video = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 16, 16, 3).astype(np.float32)).cuda()
    psnr_before = reconstruction_psnr(model, video).item()
    opt = get_optimizer(model.parameters(), lr=OVERFIT_LR, wd=0.0)
    losses = []
    t = time.perf_counter()
    for _ in range(OVERFIT_STEPS):
        loss, aux = cvivit_generator_loss(model, video, use_vgg_and_gan=False)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(aux["recon_loss"].item())
    seconds = time.perf_counter() - t
    psnr_after = reconstruction_psnr(model, video).item()
    phase("cvivit overfit check", card=card, steps=OVERFIT_STEPS, lr=OVERFIT_LR, first_recon_loss=losses[0],
          last_recon_loss=losses[-1], psnr_before=psnr_before, psnr_after=psnr_after, seconds=seconds,
          recon_losses=losses[::5])
    check(all(map(math.isfinite, losses)), "cvivit overfit: non-finite recon loss")
    check(losses[-1] < OVERFIT_DROP * losses[0], f"cvivit overfit: recon loss {losses[0]} -> {losses[-1]}")
    check(psnr_after > psnr_before, f"cvivit overfit: PSNR {psnr_before} -> {psnr_after}")


def run_train_path(torch, label, per_step, steps, profile_path=None, **preset):
    """The flagship (f32 parameters, bf16 compute; `preset` adds a critic)
    trained through `PhenakiTrainer.train_step()` at b = 4 on seeded random
    token ids and text embeddings: a warm-up step (with the step-1
    milestone: one sample and a checkpoint), then `steps` timed steps,
    each with exactly `per_step` kernel launches (counts set to 0 after the
    warm-up, read after the last step); the losses finite and every
    parameter, the MaskGit's and the critic's, moved."""
    from phenaki_tpu_torch.presets import flagship_train_phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    t0 = time.perf_counter()
    ph = flagship_train_phenaki(seed=0, device="cuda", **preset)
    torch.cuda.synchronize()
    build_model_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(20)
    ids = torch.randint(0, 65536, (2 * TRAIN_BATCH, 9, 16, 8), generator=gen)
    emb = torch.randn(2 * TRAIN_BATCH, 50, 768, generator=gen)
    results = tempfile.TemporaryDirectory()
    trainer = PhenakiTrainer(ph, dataset=torch.utils.data.TensorDataset(ids, emb),
                             batch_size=TRAIN_BATCH, seed=0, log_every=10**9, num_samples=1,
                             sample_texts=[SAMPLE_TEXT], results_folder=results.name)
    params = {f"maskgit.{n}": p for n, p in ph.maskgit.named_parameters()}
    if ph.critic is not None:
        params.update({f"critic.{n}": p for n, p in ph.critic.named_parameters()})
    before = {n: p.detach().clone() for n, p in params.items()}
    warmup_loss = trainer.train_step().item()
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for step in range(steps):
        counts = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = trainer.train_step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        launched = launched_since(counts)
        check(launched == exact(per_step), f"{label} step {step}: launches {nonzero(launched)} != {per_step}")
        losses.append(loss.item())
    launches = kernel_counts()
    check(all(map(math.isfinite, [warmup_loss, *losses])), f"{label}: non-finite train loss {losses}")
    unchanged = [n for n, p in params.items() if torch.equal(p, before[n])]
    check(not unchanged, f"{label}: parameters unchanged by training: {unchanged[:5]}")
    per_step_s = statistics.median(seconds)
    PATH_NUMBERS[label] = dict(seconds_per_step=per_step_s, tokens_per_s=TRAIN_BATCH * 1152 / per_step_s,
                               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, warmup_loss=warmup_loss,
                               losses=losses)
    phase(label, build_model_s=build_model_s, batch=TRAIN_BATCH, tokens_per_step=TRAIN_BATCH * 1152,
          step_seconds=seconds, **PATH_NUMBERS[label], parameters=len(params), launches=nonzero(launches))
    if profile_path:
        profile_train_steps(torch, trainer, profile_path)
    del trainer, ph
    results.cleanup()
    torch.cuda.empty_cache()
    return launches


def run_tpu_native_sample_path(torch):
    """The 4 heads x 128 flagship (`flagship_phenaki(tpu_native=True)`)
    sampled as the "sample" path is (`run_sample_path`): kernel 1 at d = 128,
    exactly the 8 x 64 flagship's launches a sample; two b = 1 decodes from
    one seed give the same ids. Its seconds a sample and frames/s print
    beside the "sample" path's of this run. Returns the path's launches."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    t0 = time.perf_counter()
    ph = flagship_phenaki(seed=0, device="cuda", tpu_native=True)
    torch.cuda.synchronize()
    build_model_s = time.perf_counter() - t0
    attn = ph.maskgit.transformer.layers[0].self_attn
    check((attn.heads, attn.dim_head) == (4, 128), f"tpu_native: heads x dim_head {attn.heads} x {attn.dim_head}")

    def sample(emb, gen):
        return ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, generator=gen)

    launches = run_sample_path(torch, "tpu_native sample", sample, SAMPLE_LAUNCHES)
    emb = sample_requests(torch)[1][1]
    ids = [ph.sample_ids(num_frames=17, text_embeds=emb, cond_scale=5.0, generator=torch.Generator().manual_seed(11))
           for _ in range(2)]
    check(torch.equal(ids[0], ids[1]), "tpu_native sample: one seed gave two id grids")
    phase("tpu_native sample path", build_model_s=build_model_s, heads=4, dim_head=128, ids_reproducible=True,
          **PATH_NUMBERS["tpu_native sample"], flagship_8x64=PATH_NUMBERS["sample"], launches=nonzero(launches))
    del ph
    torch.cuda.empty_cache()
    return launches


def run_tpu_native_train_path(torch):
    """`run_train_path` on the 4 heads x 128 flagship
    (`flagship_train_phenaki(tpu_native=True)`), TPU_NATIVE_TRAIN_STEPS
    counted steps with exactly TRAIN_PER_STEP launches each (kernels 1 and
    4-6 at d = 128); its seconds a step, tokens/s and peak print beside the
    "train path"'s of this run."""
    launches = run_train_path(torch, "tpu_native train", TRAIN_PER_STEP, TPU_NATIVE_TRAIN_STEPS, tpu_native=True)
    ours, ref = PATH_NUMBERS["tpu_native train"], PATH_NUMBERS["train path"]
    keys = ("seconds_per_step", "tokens_per_s", "peak_mem_gb")
    phase("tpu_native train path", heads=4, dim_head=128, **{k: ours[k] for k in keys},
          flagship_8x64={k: ref[k] for k in keys}, losses=ours["losses"], launches=nonzero(launches))
    return launches


def run_remat_train_path(torch):
    """`run_train_path` on the 8 x 64 flagship with `remat=True` on the
    MaskGit, the seed and data of "train path": kernel 1 launches twice a
    step for each attention call (the backward recomputes it), the rest as
    TRAIN_PER_STEP; the warm-up and every counted loss equal to "train
    path"'s (bit-equal expected; within REMAT_LOSS_RTOL, the largest relative
    difference printed); the peak below "train path"'s."""
    launches = run_train_path(torch, "remat train", REMAT_TRAIN_PER_STEP, TRAIN_STEPS, remat=True)
    ours, ref = PATH_NUMBERS["remat train"], PATH_NUMBERS["train path"]
    pairs = list(zip([ours["warmup_loss"], *ours["losses"]], [ref["warmup_loss"], *ref["losses"]]))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    check(rel <= REMAT_LOSS_RTOL, f"remat train path: losses {pairs} differ by {rel} relative")
    check(ours["peak_mem_gb"] < ref["peak_mem_gb"],
          f"remat train path: peak {ours['peak_mem_gb']} GB not below {ref['peak_mem_gb']}")
    keys = ("seconds_per_step", "tokens_per_s", "peak_mem_gb")
    phase("remat train path", **{k: ours[k] for k in keys}, train_path={k: ref[k] for k in keys},
          losses_bit_equal=all(a == b for a, b in pairs), max_loss_rel_diff=rel,
          peak_saved_gb=ref["peak_mem_gb"] - ours["peak_mem_gb"], launches=nonzero(launches))
    return launches


class CaptionedVideos:
    """`VideoDataset` items paired with captions, the k-th item with the
    k-th caption: the (video, text) tuples the trainer takes."""

    def __init__(self, videos, captions):
        self.videos, self.captions = videos, captions

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return self.videos[i], self.captions[i]


def _timed_batches(it, waits):
    """The batches of `it`, each one's host seconds appended to `waits`."""
    while True:
        t = time.perf_counter()
        batch = next(it)
        waits.append(time.perf_counter() - t)
        yield batch


def _instrument_raw_trainer(torch, trainer, events, milestone):
    """Record CUDA events around each `tokenize` call (into `events`), and
    the seconds, launches and drawn captions of each milestone's sampling
    and the seconds of its save (into `milestone`)."""
    cvivit, tokenize = trainer.model.cvivit, trainer.model.cvivit.tokenize
    sample_artifacts, save = trainer._sample_artifacts, trainer.save

    def timed_tokenize(video):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.profiler.record_function("raw_train.tokenize"):
            ids = tokenize(video)
        end.record()
        events.append((start, end))
        return ids

    def timed_artifacts(m):
        before = kernel_counts()
        milestone["captions"], milestone["sample_s"] = timed(torch, lambda: sample_artifacts(m))
        milestone["launches"] = launched_since(before)
        return milestone["captions"]

    def timed_save(m):
        milestone["save_s"] = timed(torch, lambda: save(m))[1]

    cvivit.tokenize = timed_tokenize
    trainer._sample_artifacts, trainer.save = timed_artifacts, timed_save


def raw_trainer(dataset, results, **kw):
    from phenaki_tpu_torch.presets import flagship_train_phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    args = dict(batch_size=TRAIN_BATCH, num_frames=17, save_and_sample_every=1000, seed=0,
                log_every=10**9, sample_texts=RAW_CAPTIONS, results_folder=results)
    args.update(kw)
    return PhenakiTrainer(flagship_train_phenaki(seed=0, device="cuda"), dataset=dataset, **args)


def run_raw_train_path(torch, card):
    """The flagship trained from raw videos and texts at b = 4: 8 seeded
    GIFs of 17 x 256 x 128 written by `video_tensor_to_gif` and read back
    through `VideoDataset` (the native route or PIL, reported), each with a
    caption, into `PhenakiTrainer(flagship_train_phenaki(), dataset=...)`.
    Each step embeds its texts and tokenizes its pixels with the frozen bf16
    C-ViViT. Counts set to 0 before the first step and read after the
    fifth: step 1's milestone (4 sampled GIFs, one b = 4 group, and a
    checkpoint) launches exactly MILESTONE_LAUNCHES, every step exactly
    RAW_TRAIN_PER_STEP. Steps 2-5 give the seconds a step, the host's wait
    for data apart, tokens/s, peak memory and the CUDA-event spans of
    tokenize and of the step; two more steps under `torch.profiler` give the
    device time a step and tokenize's. Each GIF's decode is timed once
    alone first. Then `resume_check`."""
    import numpy as np

    from phenaki_tpu_torch.data.codecs import gif_to_tensor, video_tensor_to_gif
    from phenaki_tpu_torch.data.datasets import VideoDataset
    from phenaki_tpu_torch.presets import FLAGSHIP_IMAGE_SIZE
    from phenaki_tpu_torch.training.phenaki_trainer import simple_slugify

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "videos").mkdir()
        rng = np.random.RandomState(22)
        t = time.perf_counter()
        for k in range(RAW_VIDEOS):
            video_tensor_to_gif(rng.rand(17, *FLAGSHIP_IMAGE_SIZE, 3).astype(np.float32),
                                str(tmp / "videos" / f"{k}.gif"))
        gif_write_s = time.perf_counter() - t
        videos = VideoDataset(str(tmp / "videos"), FLAGSHIP_IMAGE_SIZE, num_frames=17)
        check(len(videos) == RAW_VIDEOS, f"raw train: {len(videos)} videos found")
        decode_s = [timed(torch, lambda: videos[k])[1] for k in range(RAW_VIDEOS)]
        gc.collect()  # earlier phases' trainers may sit in reference cycles until collected
        torch.cuda.empty_cache()
        baseline_gb = torch.cuda.memory_allocated() / 1e9
        trainer, build_s = timed(torch, lambda: raw_trainer(CaptionedVideos(videos, RAW_CAPTIONS),
                                                            str(tmp / "results"), num_samples=RAW_SAMPLES))
        ph = trainer.model
        check(ph.cvivit.dtype == torch.bfloat16, "raw train: the C-ViViT is not bf16")
        check(ph.maskgit.to_logits.weight.dtype == torch.float32, "raw train: the MaskGit is not f32")
        waits, tok_events, milestone = [], [], {}
        trainer.dl = _timed_batches(trainer.dl, waits)
        _instrument_raw_trainer(torch, trainer, tok_events, milestone)

        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses, step_ms = [], [], []
        for step in range(RAW_TRAIN_STEPS):
            before = kernel_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            loss = trainer.train_step()
            end.record()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            step_ms.append(start.elapsed_time(end))
            losses.append(loss.item())
            launched = launched_since(before)
            expected = dict(RAW_TRAIN_PER_STEP)
            if step == 0:
                expected = {k: expected.get(k, 0) + MILESTONE_LAUNCHES.get(k, 0)
                            for k in {*expected, *MILESTONE_LAUNCHES}}
            check(launched == exact(expected),
                  f"raw train step {step + 1}: launches {nonzero(launched)} != {expected}")
        launches = kernel_counts()
        check(milestone["launches"] == exact(MILESTONE_LAUNCHES),
              f"raw train milestone: launches {nonzero(milestone['launches'])} != {MILESTONE_LAUNCHES}")
        check(all(map(math.isfinite, losses)), f"raw train: non-finite loss {losses}")
        # one GIF a distinct caption drawn (a caption drawn twice keeps its
        # last sample), each of 17 full-size frames
        captions = milestone["captions"]
        gifs = sorted(g.name for g in (tmp / "results" / "videos.0").glob("*.gif"))
        check(len(captions) == RAW_SAMPLES and gifs == sorted(f"{simple_slugify(c)}.gif" for c in set(captions))
              and all(gif_to_tensor(str(tmp / "results" / "videos.0" / g)).shape == (17, *FLAGSHIP_IMAGE_SIZE, 3)
                      for g in gifs),
              f"raw train milestone: sampled GIFs {gifs} for captions {captions}")
        ckpt = trainer.checkpoints.path(0)
        check(trainer.checkpoints.all_steps() == [0],
              f"raw train: checkpoints {trainer.checkpoints.all_steps()}")
        tok_ms = [s.elapsed_time(e) for s, e in tok_events]
        timed_steps = slice(1, None)  # step 1 is the warm-up and the milestone
        per_step = statistics.median(seconds[timed_steps])
        wait = statistics.median(waits[timed_steps])
        peak = torch.cuda.max_memory_allocated() / 1e9
        device_ms, tok_device_ms, h2d_device_ms, wall_ms = profile_raw_steps(torch, trainer)
        phase("raw train path", card=card, batch=TRAIN_BATCH, frames=17, videos=RAW_VIDEOS,
              gif_decode_route="native" if videos.native_fast_path() else "pil",
              gif_write_s=gif_write_s, gif_item_decode_s=decode_s, build_model_s=build_s,
              tokens_per_step=TRAIN_BATCH * 1152,
              seconds_per_step=per_step, step_seconds=seconds, data_wait_s=wait, data_wait_seconds=waits,
              seconds_per_step_without_data_wait=statistics.median(
                  [s - w for s, w in zip(seconds[timed_steps], waits[timed_steps])]),
              tokens_per_s=TRAIN_BATCH * 1152 / per_step, peak_mem_gb=peak, allocated_before_gb=baseline_gb,
              step_event_ms=step_ms, tokenize_event_ms=tok_ms,
              rest_event_ms=[s - k for s, k in zip(step_ms, tok_ms)],
              profiled_device_ms_per_step=device_ms, profiled_tokenize_device_ms_per_step=tok_device_ms,
              profiled_rest_device_ms_per_step=device_ms - tok_device_ms,
              profiled_h2d_device_ms_per_step=h2d_device_ms,
              profiled_wall_ms_per_step=wall_ms, profiled_idle=1 - device_ms / wall_ms, losses=losses,
              launches_per_step=RAW_TRAIN_PER_STEP, launches=nonzero(launches),
              milestone={"sample_s": milestone["sample_s"], "samples": RAW_SAMPLES, "gifs": len(gifs),
                         "distinct_captions": len(set(captions)),
                         "launches": nonzero(milestone["launches"]), "checkpoint_bytes": ckpt.stat().st_size,
                         "save_s": milestone["save_s"]})
        fixed_video = videos[0]
        del trainer, ph
        gc.collect()  # the instrumented trainer is a reference cycle
        torch.cuda.empty_cache()
        resume_check(torch, fixed_video, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_raw_steps(torch, trainer, n=2):
    """`torch.profiler` over `n` more raw steps: (device ms a step, the
    device ms a step of the kernels that tokenize launched, the device ms a
    step of the host-to-device copies, wall ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            trainer.train_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    events = prof.key_averages()
    device_ms, h2d_ms = device_shares(torch, events, kernel="Memcpy HtoD")
    tok_ms = sum(e.device_time_total for e in events
                 if e.key == "raw_train.tokenize" and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    return device_ms / n, tok_ms / n, h2d_ms / n, wall_ms


def resume_check(torch, video, tmp):
    """JAX's `test_phenaki_trainer_true_resume_bitwise` contract at full
    width: a trainer on a fixed dataset (one of the GIFs, one caption)
    takes step 1, whose milestone writes checkpoint 0, then RESUME_STEPS
    more; a second trainer, its MaskGit moved off the seeded weights, loads
    checkpoint 0 and takes the same RESUME_STEPS. The parameters and Adam's
    state must be bit-equal."""
    fixed = [(video, RAW_CAPTIONS[0])] * RAW_VIDEOS
    folder = str(tmp / "resume")
    ran_on = raw_trainer(fixed, folder, num_samples=1)
    ran_on.train_step()
    resumed = raw_trainer(fixed, folder, num_samples=1)
    with torch.no_grad():
        for p in resumed.model.maskgit.parameters():
            p.add_(1.0)
    _, load_s = timed(torch, lambda: resumed.load(0))
    check(resumed.step == 1, f"resume: step {resumed.step} after the load")
    for _ in range(RESUME_STEPS):
        ran_on.train_step()
        resumed.train_step()
    torch.cuda.synchronize()
    params = dict(ran_on.model.maskgit.named_parameters())
    differ = {n: (p - params[n]).abs().max().item() / max(params[n].abs().max().item(), 1e-30)
              for n, p in resumed.model.maskgit.named_parameters() if not torch.equal(p, params[n])}
    sa, sb = ran_on.opt.state_dict()["state"], resumed.opt.state_dict()["state"]
    adam_differ = [(k, key) for k in sa for key in sa[k] if not torch.equal(sa[k][key], sb[k][key])]
    ckpt = ran_on.checkpoints.path(0)
    phase("raw train resume", steps_after_load=RESUME_STEPS, checkpoint_bytes=ckpt.stat().st_size,
          load_s=load_s, params=len(params), params_bit_equal=not differ, adam_state_bit_equal=not adam_differ,
          max_rel_diff=max(differ.values(), default=0.0), differing=sorted(differ)[:10])
    check(not differ and not adam_differ,
          f"resume: {len(differ)} parameters and {len(adam_differ)} Adam tensors differ: {sorted(differ)[:5]}")
    del ran_on, resumed


def check_small_discriminator(torch):
    """A small fp32 `Discriminator` (base dim 4, 64 x 64 frames, attention at
    8 x 8 positions and 64 channels, which would pass kernel 1's gate) on
    the card and on the CPU: the hinge loss plus the R1 penalty, and every
    gradient of it (second order through the plain attention). The loss
    agrees within 1e-4 relative and each gradient within 1e-3 * max|g| of
    its tensor (floored at 1e-5), TF32 off; no attention kernel is launched,
    the norm kernels once in each of its three calls (their gradients, to
    the second order, are the plain version's)."""
    import copy

    import phenaki_tpu_torch.models.cvivit_losses as L
    from phenaki_tpu_torch.models.cvivit import Discriminator
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    d = init_parameters(Discriminator(4, 64, attn_res_layers=(16,)), torch.Generator().manual_seed(30))
    gen = torch.Generator().manual_seed(31)
    real, fake = torch.rand(2, 64, 64, 3, generator=gen), torch.rand(2, 64, 64, 3, generator=gen)
    runs = {}
    for device in ("cpu", "cuda"):
        dd = copy.deepcopy(d).to(device)
        before = kernel_counts()
        r, f = real.to(device), fake.to(device)
        loss = L.hinge_discr_loss(dd(f), dd(r)) + L.gradient_penalty(dd, r)
        loss.backward()
        torch.cuda.synchronize()
        runs[device] = (loss.item(), {n: p.grad.cpu() for n, p in dd.named_parameters() if p.grad is not None},
                        launched_since(before))
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launched) = runs["cpu"], runs["cuda"]
    worst = max(((g_gpu[n] - r).abs().max() / max(r.abs().max().item(), 1e-5)).item()
                for n, r in g_cpu.items())
    phase("small fp32 discriminator R1 card vs cpu", loss_cpu=loss_cpu, loss_gpu=loss_gpu,
          gradients=len(g_cpu), worst_grad_rel_err=worst, kernel_launches=nonzero(launched))
    check(sorted(g_cpu) == sorted(g_gpu), "the discriminator's gradients differ in which parameters they reach")
    check(launched == exact({"ln": 3, "qk": 3}), f"the discriminator launched kernels: {nonzero(launched)}")
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu), f"R1 loss differs: {loss_gpu} vs {loss_cpu}")
    check(worst <= 1e-3, f"a discriminator gradient differs between card and CPU by {worst} of its max")


class GanTrainerProbe:
    """Wraps a `CViViTTrainer`'s data iterator, `_save_results` and `save`:
    the host's wait for each batch, and the seconds, launches and written
    files of each reconstruction save and checkpoint."""

    def __init__(self, torch, trainer):
        self.waits, self.saves, self.results = [], [], []
        trainer.dl = _timed_batches(trainer.dl, self.waits)
        save_results, save = trainer._save_results, trainer.save

        def timed_results(steps):
            before = kernel_counts()
            self.results.append(dict(seconds=timed(torch, lambda: save_results(steps))[1],
                                     launches=launched_since(before)))

        def timed_save(milestone):
            self.saves.append(timed(torch, lambda: save(milestone))[1])

        trainer._save_results, trainer.save = timed_results, timed_save


def gan_trainer(torch, dataset, results):
    from phenaki_tpu_torch.presets import flagship_train_cvivit
    from phenaki_tpu_torch.training.cvivit_trainer import CViViTTrainer

    return CViViTTrainer(flagship_train_cvivit(seed=0, device="cuda"), dataset=dataset, num_train_steps=10**9,
                         batch_size=GAN_BATCH, num_frames=17, discr_base_dim=64, discr_attn_res_layers=(16,),
                         perceptual_mode="disc", use_ema=True, apply_grad_penalty_every=GAN_PENALTY_EVERY,
                         valid_frac=0.0, save_results_every=10**9, save_model_every=10**9, seed=0,
                         log_every=10**9, results_folder=results)


def gan_step(torch, trainer, seconds, logs):
    counts = kernel_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = trainer.train_step()
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t)
    logs.append({k: v.item() for k, v in out.items()})
    return launched_since(counts)


def run_cvivit_gan_path(torch, card, profile_path=None):
    """The flagship C-ViViT (f32 weights, bf16 compute) trained as a VQGAN by
    `CViViTTrainer` at b = 4 on 8 seeded GIFs of 17 x 256 x 128 written and
    read back through `VideoDataset`, with a discriminator of base dim 64
    (attention at 16 x 8 positions), the "disc" perceptual loss, the EMA,
    and the R1 penalty every 4th step. Counts set to 0 before step 0, the
    warm-up, whose reconstructions (EMA and raw parameters: 4 GIFs each,
    each decoding to 17 x 256 x 128) and checkpoint are timed apart; every
    step launches exactly GAN_PER_STEP (step 0 also GAN_RECON_LAUNCHES for
    each reconstruction; a penalty step also GAN_PENALTY_LAUNCHES). Steps 1-8 give the seconds a step with and without
    the penalty, videos/s over the 8 (2 of them with the penalty: the
    1-in-4 mix), the host's wait for data and peak memory; two more steps
    under `torch.profiler`, one without the penalty and one with, the
    device ms and idle share of each. The losses and the adaptive weight
    must be finite, the weight > 0 (with `profile_path`, each profiled
    step's tables go to `{profile_path}.{without,with}_penalty.txt`). Then
    the resume: the trainer saves, a
    second one loads the checkpoint, and both take one step on the same
    batch; their losses and parameters must be bit-equal."""
    import numpy as np

    from phenaki_tpu_torch.data.codecs import gif_to_tensor, video_tensor_to_gif
    from phenaki_tpu_torch.data.datasets import VideoDataset
    from phenaki_tpu_torch.presets import FLAGSHIP_IMAGE_SIZE

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "videos").mkdir()
        rng = np.random.RandomState(23)
        for k in range(RAW_VIDEOS):
            video_tensor_to_gif(rng.rand(17, *FLAGSHIP_IMAGE_SIZE, 3).astype(np.float32),
                                str(tmp / "videos" / f"{k}.gif"))
        videos = VideoDataset(str(tmp / "videos"), FLAGSHIP_IMAGE_SIZE, num_frames=17)
        gc.collect()
        torch.cuda.empty_cache()
        trainer, build_s = timed(torch, lambda: gan_trainer(torch, videos, str(tmp / "results")))
        check(trainer.vae.dtype == torch.bfloat16 and trainer.discr.dtype == torch.bfloat16,
              "gan train: the C-ViViT or the discriminator does not compute in bf16")
        check(trainer.vae.to_pixels_first.weight.dtype == torch.float32, "gan train: the C-ViViT is not f32")
        check(trainer.discr.attn_blocks == {3} and not trainer.discr.attn_3.use_flash,
              "gan train: the discriminator's attention is not the plain one at 16 x 8")
        probe = GanTrainerProbe(torch, trainer)

        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        seconds, logs = [], []
        launched = gan_step(torch, trainer, seconds, logs)
        expected = {k: v + 2 * GAN_RECON_LAUNCHES.get(k, 0) for k, v in gan_step_launches(0).items()}
        check(launched == exact(expected), f"gan step 0: launches {nonzero(launched)} != {expected}")
        for step in range(1, GAN_STEPS + 1):
            launched = gan_step(torch, trainer, seconds, logs)
            expected = gan_step_launches(step)
            check(launched == exact(expected), f"gan step {step}: launches {nonzero(launched)} != {expected}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(math.isfinite(v) for entry in logs for v in entry.values()), f"gan train: non-finite logs {logs}")
        check(all(entry["adaptive_weight"] > 0 for entry in logs), "gan train: adaptive weight not > 0")
        penalty = [s % GAN_PENALTY_EVERY == 0 for s in range(GAN_STEPS + 1)]
        check([entry["grad_penalty"] > 0 for entry in logs] == penalty,
              f"gan train: penalties {[entry['grad_penalty'] for entry in logs]}")
        for label in ("0", "0.ema"):
            gifs = sorted((tmp / "results" / f"samples.{label}").glob("*.gif"))
            check(len(gifs) == GAN_BATCH and all(gif_to_tensor(str(g)).shape == (17, *FLAGSHIP_IMAGE_SIZE, 3)
                                                  for g in gifs), f"gan train: reconstructions {gifs}")
        check(probe.results[0]["launches"] == exact(scaled(GAN_RECON_LAUNCHES, 2)),
              f"gan reconstructions: launches {nonzero(probe.results[0]['launches'])}")
        timed_s = seconds[1:]
        with_gp = [s for s, gp in zip(timed_s, penalty[1:]) if gp]
        without_gp = [s for s, gp in zip(timed_s, penalty[1:]) if not gp]
        # two batches a step, the generator's and the discriminator's
        waits = probe.waits[2: 2 + 2 * GAN_STEPS]
        profiled = {}
        for label in ("without_penalty", "with_penalty"):
            while (trainer.step % GAN_PENALTY_EVERY == 0) != (label == "with_penalty"):
                gan_step(torch, trainer, [], logs)
            profiled[label] = profile_gan_step(
                torch, trainer, f"{profile_path}.{label}.txt" if profile_path else None)
        launches = kernel_counts()
        # the logged steps and the two profiled ones, the second with the penalty
        penalties = sum(entry["grad_penalty"] > 0 for entry in logs) + 1
        check(launches == exact({k: v * (len(logs) + 2) + penalties * GAN_PENALTY_LAUNCHES.get(k, 0)
                                 + 2 * GAN_RECON_LAUNCHES.get(k, 0) for k, v in GAN_PER_STEP.items()}),
              f"gan train: launches {nonzero(launches)} over {len(logs) + 2} steps, {penalties} with the penalty")
        ckpt = trainer.checkpoints.path(0)
        phase("cvivit gan train path", card=card, batch=GAN_BATCH, frames=17, videos=RAW_VIDEOS,
              gif_decode_route="native" if videos.native_fast_path() else "pil", build_model_s=build_s,
              discr_base_dim=64, vae_params=sum(p.numel() for p in trainer.vae.parameters()),
              discr_params=sum(p.numel() for p in trainer.discr.parameters()),
              seconds_per_step_with_penalty=statistics.median(with_gp),
              seconds_per_step_without_penalty=statistics.median(without_gp), step_seconds=seconds,
              gan_videos_per_s=GAN_BATCH * len(timed_s) / sum(timed_s), window_steps=len(timed_s),
              window_penalty_steps=len(with_gp), data_wait_s=statistics.median(waits),
              data_wait_s_per_step=2 * statistics.median(waits), peak_mem_gb=peak,
              profiled=profiled, losses=logs[:GAN_STEPS + 1],
              save_results={"seconds": probe.results[0]["seconds"], "gifs": 2 * GAN_BATCH,
                            "launches": nonzero(probe.results[0]["launches"])},
              checkpoint_bytes=ckpt.stat().st_size, save_s=probe.saves[0],
              launches_per_step=GAN_PER_STEP, launches=nonzero(launches))
        gan_resume_check(torch, trainer, videos, tmp)
        del trainer, probe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_gan_step(torch, trainer, path=None):
    """`torch.profiler` over one step: device ms, wall ms and the idle share,
    and the device ms of kernel 1 and of kernels 4-6; with `path`, the
    profiler's tables (by kernel, and by the operator that launched it) are
    written there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device_ms, flash_ms = device_shares(torch, events)
    _, bwd_ms = device_shares(torch, events, kernel="flash_bwd_")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            events.table(sort_by="self_device_time_total", row_limit=60, max_name_column_width=100)
            + "\n" + events.table(sort_by="device_time_total", row_limit=80, max_name_column_width=100))
    return dict(step=trainer.step - 1, device_ms=device_ms, wall_ms=wall_ms, idle=1 - device_ms / wall_ms,
                flash_fwd_ms=flash_ms, flash_bwd_ms=bwd_ms)


def gan_resume_check(torch, trainer, videos, tmp):
    """The live trainer saves milestone m; a second trainer, built the same
    way, loads it; both take one step on the same batch (the first 4 GIFs).
    The step's losses and the C-ViViT's, the discriminator's and the EMA's
    parameters must be bit-equal."""
    import numpy as np

    m = trainer.step
    _, save_s = timed(torch, lambda: trainer.checkpoints.save(m, trainer._ckpt_tree()))
    resumed = gan_trainer(torch, videos, str(tmp / "results"))
    _, load_s = timed(torch, lambda: resumed.load(m))
    check(resumed.step == m and resumed.ema.step == trainer.ema.step, f"gan resume: step {resumed.step} != {m}")
    batch = (torch.from_numpy(np.stack([videos[k] for k in range(GAN_BATCH)])).to(trainer.vae.dtype),)
    logs = []
    for tr in (trainer, resumed):
        tr.dl = iter([batch] * 2)
        gan_step(torch, tr, [], logs)
    differ = [k for k in logs[0] if logs[0][k] != logs[1][k]]
    params = [(f"{label}.{n}", p, q) for label, a, b in
              (("vae", trainer.vae, resumed.vae), ("discr", trainer.discr, resumed.discr))
              for (n, p), q in zip(a.named_parameters(), b.parameters())]
    params += [(f"ema.{n}", p, resumed.ema.params[n]) for n, p in trainer.ema.params.items()]
    param_differ = [n for n, p, q in params if not torch.equal(p, q)]
    phase("cvivit gan resume", milestone=m, checkpoint_bytes=trainer.checkpoints.path(m).stat().st_size,
          save_s=save_s, load_s=load_s, losses_bit_equal=not differ, params=len(params),
          params_bit_equal=not param_differ, differing=(differ + param_differ)[:10], losses=logs)
    check(not differ and not param_differ, f"gan resume: {differ} and {len(param_differ)} tensors differ")
    del resumed


def seq_parallel_rank(rank, world, profile_path=None):
    """One rank of the sequence-parallel phases (spawned; every rank runs the
    same calls with the same seeds): the small fp32 model against dense,
    then the flagship sample path and train path, each with its counts set
    to 0 before it. Returns plain numbers and numpy arrays; raises on a
    failed check."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dist.get_backend() != "nccl":
        torch.cuda.set_device(0)  # every gloo rank computes on the one card
    group = dist.group.WORLD
    return {"backend": dist.get_backend(), "device": torch.cuda.current_device(),
            "small": ring_small_check(torch, group),
            "sample": seq_sample_path(torch, group, profile_path),
            "train": seq_train_path(torch, group)}


def ring_small_check(torch, group):
    """The small fp32 MaskGit (`small_train_models`, 128 tokens: 64 a rank,
    the kernel ring) sequence-sharded against the same weights dense, both
    on the card: logits within 1e-5 of max |ref|; `Phenaki.loss` (same ids,
    frame mask, text, draws) within 1e-4 relative and every parameter
    gradient within 1e-4 of its max |ref|, floored at 1e-4 (the CPB output
    bias's true gradient is 0, the softmax cancels a per-head constant, and
    both sides hold ~1e-9 of rounding noise there); greedy `sample_ids` (3
    frames, 128 tokens) the same ids."""
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki

    mg, cv = small_train_models(torch, 5)
    ring_mg = MaskGit(128, 512, 128, depth=2, heads=2, dim_head=64, dim_context=64, seq_group=group)
    ring_mg.load_state_dict(mg.state_dict())
    models = {"dense": mg.cuda(), "ring": ring_mg.cuda()}
    cv = cv.cuda()
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 512, (2, 2, 8, 8), generator=gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0
    frame_mask = torch.tensor([[True, True, True], [True, False, False]])
    runs = {}
    for name, model in models.items():
        reset_kernel_counts()
        with torch.no_grad():
            logits = model(ids.cuda(), context=emb.cuda())
        ph = Phenaki(maskgit=model, cvivit=cv, text_embed_dim=64, steps=6, max_text_len=16)
        loss, _ = ph.loss(video_codebook_ids=ids, text_embeds=emb, video_frame_mask=frame_mask,
                          generator=torch.Generator().manual_seed(7))
        loss.backward()
        sampled = ph.sample_ids(num_frames=3, text_embeds=emb, cond_scale=5.0, starting_temperature=0.0,
                                generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        runs[name] = dict(logits=logits, loss=loss.item(), ids=sampled.cpu(), launches=nonzero(kernel_counts()),
                          grads={n: p.grad for n, p in model.named_parameters()})
    dense, ring = runs["dense"], runs["ring"]
    fwd_err = ((ring["logits"] - dense["logits"]).abs().max() / dense["logits"].abs().max()).item()
    loss_err = abs(ring["loss"] - dense["loss"]) / abs(dense["loss"])
    worst = max(((ring["grads"][n] - r).abs().max() / max(r.abs().max().item(), 1e-4)).item()
                for n, r in dense["grads"].items())
    ids_equal = bool(torch.equal(ring["ids"], dense["ids"]))
    check(ring["launches"].get("chunk", 0) > 0 and "chunk" not in dense["launches"],
          f"the ring model did not run kernel 3: {ring['launches']} (dense {dense['launches']})")
    check(fwd_err <= 1e-5, f"ring forward differs from dense by {fwd_err} of max |ref|")
    check(loss_err <= 1e-4, f"ring loss {ring['loss']} vs dense {dense['loss']}")
    check(worst <= 1e-4, f"a ring gradient differs from dense by {worst} of its max")
    check(ids_equal, "greedy ids differ between the ring model and dense")
    return dict(forward_rel_err=fwd_err, loss_dense=dense["loss"], loss_ring=ring["loss"],
                loss_rel_err=loss_err, worst_grad_rel_err=worst, greedy_ids_equal=ids_equal,
                ring_launches=ring["launches"], dense_launches=dense["launches"])


def seq_sample_path(torch, group, profile_path=None):
    """`flagship_phenaki(seq_group=...).sample(...)` at b = 1: a warm-up and
    three requests, each with exactly SEQ_SAMPLE_LAUNCHES launches on this
    rank; returns each request's ids (for the check across ranks), a digest
    of its video, and its seconds. With `profile_path`, every rank samples
    once more under `torch.profiler` (`profile_seq_sample`)."""
    import hashlib

    from phenaki_tpu_torch.presets import flagship_phenaki

    t0 = time.perf_counter()
    ph = flagship_phenaki(seed=0, device="cuda", seq_group=group)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    seen = []
    sample_ids = ph.sample_ids
    ph.sample_ids = lambda **kw: seen.append(sample_ids(**kw)) or seen[-1]
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    out = {"ids": {}, "video_sha": {}, "seconds": {}}
    for name, emb, seed in sample_requests(torch)[:4]:
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0,
                          generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t
        counts = launched_since(before)
        check(tuple(video.shape) == (1, 17, 256, 128, 3), f"seq sample {name}: video shape {tuple(video.shape)}")
        check(torch.isfinite(video).all().item(), f"seq sample {name}: non-finite video")
        check(counts == exact(SEQ_SAMPLE_LAUNCHES),
              f"seq sample {name}: launches {nonzero(counts)} != {SEQ_SAMPLE_LAUNCHES}")
        out["ids"][name] = seen[-1].cpu().numpy()
        out["video_sha"][name] = hashlib.sha256(video.contiguous().view(torch.int16).cpu().numpy()).hexdigest()
    out.update(launches=kernel_counts(), build_model_s=build_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile_path is not None:
        out["profile"] = profile_seq_sample(torch, ph, profile_path)
    del ph
    torch.cuda.empty_cache()
    return out


def profile_seq_sample(torch, ph, path):
    """One more flagship sample under `torch.profiler`, on every rank (the
    ring's collectives need them all); rank 0 writes its table of device
    time by kernel and operator to `path`. Returns this rank's device
    milliseconds (`device_shares`) and wall milliseconds. With the ranks
    sharing one GPU, the other rank's kernels occupy the card too: the idle
    share is this rank's only."""
    from torch.profiler import ProfilerActivity, profile

    emb = sample_requests(torch)[1][1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, generator=torch.Generator().manual_seed(11))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device_ms = device_shares(torch, events)[0]
    if torch.distributed.get_rank() == 0:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            events.table(sort_by="self_device_time_total", row_limit=50, max_name_column_width=100)
            + "\n" + events.table(sort_by="cpu_time_total", row_limit=40, max_name_column_width=100))
    return dict(device_ms=device_ms, wall_ms=wall_ms, idle=1 - device_ms / wall_ms)


def seq_train_path(torch, group):
    """`PhenakiTrainer.train_step()` at b = 4 on `flagship_train_phenaki(
    seq_group=...)`. Its first step (the warm-up) runs the batch and draws
    of a dense trainer's first step with the same seeds, and its loss must
    be within 1e-3 relative of the dense loss (bf16 compute: the ring and
    kernel 1 round the attention output differently); then SEQ_TRAIN_STEPS
    steps with exactly SEQ_TRAIN_PER_STEP launches each. Returns a digest
    of every parameter after the steps (the check across ranks)."""
    import hashlib

    from phenaki_tpu_torch.presets import flagship_train_phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    gen = torch.Generator().manual_seed(20)
    data = torch.utils.data.TensorDataset(torch.randint(0, 65536, (2 * TRAIN_BATCH, 9, 16, 8), generator=gen),
                                          torch.randn(2 * TRAIN_BATCH, 50, 768, generator=gen))

    results = tempfile.TemporaryDirectory()  # this rank's milestones (a sample and a checkpoint)

    def trainer(ph, folder):
        return PhenakiTrainer(ph, dataset=data, batch_size=TRAIN_BATCH, seed=0, log_every=10**9,
                              num_samples=1, sample_texts=[SAMPLE_TEXT],
                              results_folder=f"{results.name}/{folder}")

    dense_loss = trainer(flagship_train_phenaki(seed=0, device="cuda"), "dense").train_step().item()
    torch.cuda.empty_cache()
    ph = flagship_train_phenaki(seed=0, device="cuda", seq_group=group)
    tr = trainer(ph, "seq")
    first_loss = tr.train_step().item()
    check(abs(first_loss - dense_loss) <= 1e-3 * abs(dense_loss),
          f"seq train: first loss {first_loss} vs dense {dense_loss}")
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for step in range(SEQ_TRAIN_STEPS):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = tr.train_step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        launched = launched_since(before)
        check(launched == exact(SEQ_TRAIN_PER_STEP),
              f"seq train step {step}: launches {nonzero(launched)} != {SEQ_TRAIN_PER_STEP}")
        losses.append(loss.item())
    check(all(map(math.isfinite, losses)), f"seq train: non-finite loss {losses}")
    digest = hashlib.sha256()
    for _, p in ph.maskgit.named_parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out = dict(dense_loss=dense_loss, first_loss=first_loss, losses=losses, step_seconds=seconds,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=kernel_counts(),
               params_sha=digest.hexdigest())
    del tr, ph
    results.cleanup()
    torch.cuda.empty_cache()
    return out


def run_seq_parallel(torch, profile_path=None):
    """Spawn SP ranks (NCCL with a GPU a rank when there are enough cards;
    gloo with every rank on cuda:0 otherwise), the kernel library built
    before. Checks across ranks: the same ids and videos, the same
    parameters after training. Returns the main paths' launches summed over
    the ranks."""
    import numpy as np

    from phenaki_tpu_torch.parallel.distributed import default_backend, spawn_ranks

    backend = default_backend(SP)
    t0 = time.perf_counter()
    results = spawn_ranks(seq_parallel_rank, SP, profile_path, backend=backend, timeout=RANK_TIMEOUT_S)
    phase("ring ranks", backend=backend, ranks=SP, devices=[r["device"] for r in results],
          one_shared_gpu=backend != "nccl", wall_s=time.perf_counter() - t0)
    check(all(r["backend"] == backend for r in results), "a rank ran another backend")
    for rank, r in enumerate(results):
        phase(f"ring, card vs dense, rank {rank}", **r["small"])
    samples = [r["sample"] for r in results]
    for name in samples[0]["ids"]:
        check(all(np.array_equal(s["ids"][name], samples[0]["ids"][name]) for s in samples),
              f"seq sample {name}: ids differ across ranks")
        check(len({s["video_sha"][name] for s in samples}) == 1, f"seq sample {name}: videos differ across ranks")
    for rank, smp in enumerate(samples):
        per_sample = statistics.median(smp["seconds"][n] for n in ("req1", "req2", "req3"))
        phase(f"seq-sharded flagship sample, rank {rank}", seconds_per_sample_b1=per_sample,
              seconds=smp["seconds"], launches_per_sample=SEQ_SAMPLE_LAUNCHES, launches=nonzero(smp["launches"]),
              ids_identical_across_ranks=True, build_model_s=smp["build_model_s"], peak_mem_gb=smp["peak_mem_gb"],
              profile=smp.get("profile"))
    trains = [r["train"] for r in results]
    check(len({t["params_sha"] for t in trains}) == 1, "seq train: parameters differ across ranks")
    check(all(t["losses"] == trains[0]["losses"] for t in trains), "seq train: losses differ across ranks")
    for rank, tr in enumerate(trains):
        per_step = statistics.median(tr["step_seconds"])
        phase(f"seq-sharded flagship train, rank {rank}", seconds_per_step=per_step,
              tokens_per_s=TRAIN_BATCH * 1152 / per_step, step_seconds=tr["step_seconds"],
              dense_first_loss=tr["dense_loss"], first_loss=tr["first_loss"], losses=tr["losses"],
              peak_mem_gb=tr["peak_mem_gb"], launches_per_step=SEQ_TRAIN_PER_STEP,
              launches=nonzero(tr["launches"]), params_identical_across_ranks=True)
    return {key: sum(r[path]["launches"][key] for r in results for path in ("sample", "train"))
            for key in all_kernels()}


def mesh_rank(rank, world, profile_path=None):
    """One rank of the mesh paths (spawned; every rank runs the same calls
    with the same seeds, each phase with its counts set to 0 before it).
    Returns plain numbers and arrays; raises on a failed check."""
    import torch
    import torch.distributed as dist

    from phenaki_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # two ranks share the host's cores (the small model's CPU run)
    if dist.get_backend() != "nccl":
        torch.cuda.set_device(0)  # every gloo rank computes on the one card
    tp, dp, pp = make_mesh(tp=MESH), make_mesh(dp=MESH), make_mesh(pp=PIPE_STAGES)
    out = {"backend": dist.get_backend(), "device": torch.cuda.current_device(), "phase_s": {}}
    phases = (("tp_sample", lambda: mesh_tp_sample(torch, tp, profile_path)),
              ("small_tp", lambda: mesh_small_tp(torch, tp)), ("dp_sample", lambda: mesh_dp_sample(torch, dp)),
              ("train", lambda: mesh_train_paths(torch, dp, tp)), ("resume", lambda: mesh_resume(torch, dp, tp)),
              ("small_pp", lambda: mesh_small_pp(torch, pp)), ("pipeline", lambda: mesh_pipeline_train(torch, pp)),
              ("gan", lambda: mesh_gan_dp(torch, dp)), ("serving", lambda: mesh_serving(torch, tp)))
    for name, run in phases:
        t = time.perf_counter()
        out[name] = run()
        out["phase_s"][name] = time.perf_counter() - t
    return out


def _video_sha(torch, video):
    import hashlib

    return hashlib.sha256(video.contiguous().float().cpu().numpy().tobytes()).hexdigest()


def _params_sha(params):
    import hashlib

    digest = hashlib.sha256()
    for _, p in params:
        p = p.to_local() if hasattr(p, "to_local") else p
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def mesh_tp_sample(torch, tp, profile_path=None):
    """`flagship_phenaki(...).sample(mesh=)` at tp = 2, b = 1: a warm-up and
    three requests, each launching exactly SAMPLE_LAUNCHES on this rank
    (kernel 1 on the rank's 4 heads); their ids (for the check across
    ranks), seconds, and the share of ids equal to the dense sample's with
    the same seed (the tp sum of two bf16 partials rounds otherwise than
    the dense product, so the decode may go its own way), the dense sample
    timed beside it. With `profile_path`, one more tp sample under
    `torch.profiler` on every rank, rank 0's table written there."""
    from phenaki_tpu_torch.presets import flagship_phenaki

    ph = flagship_phenaki(seed=0, device="cuda")
    view = ph._sampling_view(tp)  # the rank's tp clone, built outside the timed calls
    seen = {"tp": [], "dense": []}
    for model, key in ((view, "tp"), (ph, "dense")):
        sample_ids = model.sample_ids
        model.sample_ids = lambda _f=sample_ids, _k=key, **kw: seen[_k].append(_f(**kw)) or seen[_k][-1]
    requests = sample_requests(torch)[:4]
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    out = {"ids": {}, "seconds": {}, "dense_seconds": {}, "equal_share": {}}
    for name, emb, seed in requests:
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, mesh=tp,
                          generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t
        counts = launched_since(before)
        check(tuple(video.shape) == (1, 17, 256, 128, 3), f"tp sample {name}: video shape {tuple(video.shape)}")
        check(torch.isfinite(video).all().item(), f"tp sample {name}: non-finite video")
        check(counts == exact(SAMPLE_LAUNCHES), f"tp sample {name}: launches {nonzero(counts)} != {SAMPLE_LAUNCHES}")
        out["ids"][name] = seen["tp"][-1].cpu().numpy()
    out["launches"] = kernel_counts()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for name, emb, seed in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        out["dense_seconds"][name] = time.perf_counter() - t
        out["equal_share"][name] = float((seen["dense"][-1].cpu().numpy() == out["ids"][name]).mean())
    if profile_path is not None:
        out["profile"] = profile_tp_sample(torch, ph, tp, profile_path)
    del ph, view
    torch.cuda.empty_cache()
    return out


def profile_tp_sample(torch, ph, tp, path):
    """One more tp = 2 flagship sample under `torch.profiler` on every rank;
    rank 0 writes its tables (device time by kernel; host time by operator,
    the all-reduces' range "collectives.all_reduce" among them) to `path`.
    Returns this rank's device and wall milliseconds and the host share of
    the all-reduces."""
    from torch.profiler import ProfilerActivity, profile

    emb = sample_requests(torch)[1][1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, mesh=tp,
                  generator=torch.Generator().manual_seed(11))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device_ms = device_shares(torch, events)[0]
    # the range's host rows (the profiler also lists it as a device annotation)
    reduce = [e for e in events if e.key == "collectives.all_reduce" and e.cpu_time_total > 0]
    reduce_ms = sum(e.cpu_time_total for e in reduce) / 1e3
    calls = sum(e.count for e in reduce)
    if torch.distributed.get_rank() == 0:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            events.table(sort_by="self_device_time_total", row_limit=50, max_name_column_width=100)
            + "\n" + events.table(sort_by="cpu_time_total", row_limit=40, max_name_column_width=100))
    return dict(device_ms=device_ms, wall_ms=wall_ms, idle=1 - device_ms / wall_ms, all_reduce_ms=reduce_ms,
                all_reduce_calls=calls, all_reduce_host_share=reduce_ms / wall_ms)


def mesh_small_tp(torch, tp):
    """The small fp32 model (`small_train_models`) at tp = 2 on the card
    against the same at tp = 2 on the CPU: greedy `sample_ids` equal, and two
    `PhenakiTrainer` steps whose losses agree within rtol 2e-4, atol 2e-5 and
    consolidated parameters within rtol 1e-3, atol 3e-4 (the tolerances of
    tests/test_parallel.py:380-393)."""
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    gen = torch.Generator().manual_seed(8)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0
    data = torch.utils.data.TensorDataset(torch.randint(0, 512, (8, 2, 8, 8), generator=gen),
                                          torch.randn(8, 8, 64, generator=gen))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cpu", "cuda"):
            mg, cv = small_train_models(torch, 5)
            ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=6,
                         max_text_len=16)
            before = kernel_counts()
            t = time.perf_counter()
            ids = ph.tp_shard(tp).sample_ids(num_frames=3, text_embeds=emb, cond_scale=5.0,
                                             starting_temperature=0.0, generator=torch.Generator().manual_seed(0))
            trainer = PhenakiTrainer(ph, dataset=data, batch_size=4, seed=0, log_every=10**9, num_samples=1,
                                     num_frames=3, sample_texts=[SAMPLE_TEXT], results_folder=f"{tmp}/{device}",
                                     mesh=tp, train_lr=1e-4)
            losses = [trainer.train_step().item() for _ in range(2)]
            params = trainer._ckpt_tree(with_optimizer=False)["params"]["maskgit"]
            runs[device] = dict(ids=ids.cpu(), losses=losses, params=params, launches=nonzero(launched_since(before)),
                                seconds=time.perf_counter() - t)
    cpu, card = runs["cpu"], runs["cuda"]
    worst = max(((card["params"][k] - v).abs() - (3e-4 + 1e-3 * v.abs())).max().item()
                for k, v in cpu["params"].items())
    loss_ok = all(abs(a - b) <= 2e-5 + 2e-4 * abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    check(card["launches"].get("fwd", 0) > 0 and "fwd" not in cpu["launches"],
          f"small tp: kernel 1 ran {card['launches']} on the card, {cpu['launches']} on the CPU")
    check(torch.equal(card["ids"], cpu["ids"]), "small tp: greedy ids differ between card and CPU")
    check(loss_ok, f"small tp: losses {card['losses']} vs CPU {cpu['losses']}")
    check(worst <= 0, f"small tp: a parameter is {worst} beyond rtol 1e-3, atol 3e-4 of the CPU's")
    return dict(ids_equal=True, losses_card=card["losses"], losses_cpu=cpu["losses"],
                worst_param_excess=worst, card_launches=card["launches"], seconds_card=card["seconds"],
                seconds_cpu=cpu["seconds"])


def mesh_dp_sample(torch, dp):
    """`sample(mesh=)` at dp = 2, b = 2 (one row a rank): exactly
    SAMPLE_LAUNCHES a rank; this rank's row bit-equal to the same row
    sampled alone with its generator (`dp_generator`); returns a digest of
    the global video (the check that both ranks hold the same)."""
    from phenaki_tpu_torch.models.phenaki import dp_generator
    from phenaki_tpu_torch.presets import flagship_phenaki

    ph = flagship_phenaki(seed=0, device="cuda")
    _, emb, seed = sample_requests(torch)[4]  # b = 2
    ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, mesh=dp, generator=torch.Generator().manual_seed(1))
    reset_kernel_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    video = ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0, mesh=dp,
                      generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = kernel_counts()
    check(tuple(video.shape) == (2, 17, 256, 128, 3), f"dp sample: video shape {tuple(video.shape)}")
    check(launches == exact(SAMPLE_LAUNCHES), f"dp sample: launches {nonzero(launches)} != {SAMPLE_LAUNCHES}")
    r = dp.dp_index
    alone = ph.sample(num_frames=17, text_embeds=emb[r:r + 1], cond_scale=5.0,
                      generator=dp_generator(torch.Generator().manual_seed(seed), r))
    check(torch.equal(video[r:r + 1], alone), f"dp sample: rank {r}'s row differs from its shard sampled alone")
    out = dict(seconds_b2=seconds, row_equal_alone=True, video_sha=_video_sha(torch, video), launches=launches)
    del ph
    torch.cuda.empty_cache()
    return out


def _mesh_data(torch, same=False):
    """Seeded token ids and (50, 768) text embeddings of 16 samples; with
    `same` every sample is the first (a resume then sees the same batch)."""
    gen = torch.Generator().manual_seed(21)
    ids = torch.randint(0, 65536, (16, 9, 16, 8), generator=gen)
    text = torch.randn(16, 50, 768, generator=gen)
    if same:
        ids, text = ids[:1].expand(16, -1, -1, -1).clone(), text[:1].expand(16, -1, -1).clone()
    return torch.utils.data.TensorDataset(ids, text)


def _mesh_trainer(ph, folder, data, **kw):
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    return PhenakiTrainer(ph, dataset=data, batch_size=MESH_TRAIN_BATCH, seed=0, log_every=10**9, num_samples=1,
                          sample_texts=[SAMPLE_TEXT], results_folder=folder, **kw)


def mesh_train_paths(torch, dp, tp):
    """`PhenakiTrainer` on the flagship (f32 parameters, bf16 compute) at a
    global batch of 8: "dp" (dp = 2, 4 rows a rank, one all-reduce of the
    gradients a step), "fsdp" (dp = 2 with `fsdp=True`) and "tp" (tp = 2,
    the 8 rows on 4 heads a rank). Rank 0 first takes one step of a
    one-process trainer on the global batch; each path's first step (its
    milestone) must give its loss within 1e-3 relative. Then
    MESH_TRAIN_STEPS counted steps, each with exactly TRAIN_PER_STEP
    launches on this rank. Returns the losses, seconds, peak memory, a
    digest of this rank's parameters (dp) or of the consolidated ones, and,
    for dp and fsdp, the consolidated MaskGit to compare on rank 0."""
    import copy

    from phenaki_tpu_torch.presets import flagship_train_phenaki

    data = _mesh_data(torch)
    base = flagship_train_phenaki(seed=0, device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if dp.rank == 0:  # its first loss, one timed step and its peak (the pipeline path's yardsticks too)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ref = _mesh_trainer(copy.deepcopy(base), f"{tmp}/ref", data)
            out["one_process_loss"] = ref.train_step().item()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref.train_step().item()
            out["one_process_step_s"] = time.perf_counter() - t
            out["one_process_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del ref
            torch.cuda.empty_cache()
        for label, mesh, fsdp in (("dp", dp, False), ("fsdp", dp, True), ("tp", tp, False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = _mesh_trainer(copy.deepcopy(base), f"{tmp}/{label}", data, mesh=mesh, fsdp=fsdp)
            gather_s = _time_head_gather(torch, trainer) if label == "tp" else None
            first = trainer.train_step().item()
            if gather_s is not None:
                gather_s.clear()  # the counted steps' gathers alone
            reset_kernel_counts()
            seconds, losses = [], []
            for step in range(MESH_TRAIN_STEPS):
                before = kernel_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(trainer.train_step().item())
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
                launched = launched_since(before)
                check(launched == exact(TRAIN_PER_STEP),
                      f"{label} train step {step}: launches {nonzero(launched)} != {TRAIN_PER_STEP}")
            check(all(map(math.isfinite, losses)), f"{label} train: non-finite loss {losses}")
            entry = dict(first_loss=first, losses=losses, step_seconds=seconds, launches=kernel_counts(),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if label == "dp":
                entry["params_sha"] = _params_sha(trainer.model.maskgit.named_parameters())
            if label == "tp":  # the rank's rows of the vocab head, and of Adam's moments of them
                head = trainer.model.maskgit.to_logits
                moments = trainer.opt.state[head.weight]
                entry.update(head_rows=head.weight.shape[0], head_bias_rows=head.bias.shape[0],
                             head_moment_rows=[moments[k].shape[0] for k in ("exp_avg", "exp_avg_sq")],
                             head_gather_s=list(gather_s))
                check(entry["head_rows"] * tp.tp == head.out_features and entry["head_moment_rows"] == [
                    entry["head_rows"]] * 2, f"tp train: the rank holds {entry['head_rows']} head rows")
            consolidated = trainer._ckpt_tree(with_optimizer=False)["params"]["maskgit"]
            entry["consolidated_sha"] = _params_sha(sorted(consolidated.items()))
            if label in ("dp", "fsdp") and dp.rank == 0:
                entry["consolidated"] = {k: v.cpu() for k, v in consolidated.items()}
            out[label] = entry
            del trainer
            torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return out


def _time_head_gather(torch, trainer):
    """A list that gains the host seconds of each gather of the tp rank's
    vocab head (`VocabShardedHead.gather`, synchronised at both ends)."""
    head = trainer.model.maskgit.to_logits
    seconds, gather = [], head.gather

    def timed(dtype):
        torch.cuda.synchronize()
        t = time.perf_counter()
        whole = gather(dtype)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return whole

    head.gather = timed
    return seconds


def mesh_resume(torch, dp, tp):
    """"sharded resume": trainer A at dp = 2 on a fixed batch takes its first
    step, whose milestone writes the consolidated checkpoint 0; trainer B at
    tp = 2 loads it, and its consolidated parameters and Adam state must equal
    the file's; A takes one more step, and trainer C at dp = 2 loads the
    checkpoint and takes one step: its parameters must equal A's, bit for
    bit."""
    import copy

    from phenaki_tpu_torch.parallel.collectives import broadcast_object
    from phenaki_tpu_torch.presets import flagship_train_phenaki

    data = _mesh_data(torch, same=True)
    base = flagship_train_phenaki(seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        folder = broadcast_object(tmp, dp.world_group)  # one folder for both ranks: rank 0's
        a = _mesh_trainer(copy.deepcopy(base), f"{folder}/a", data, mesh=dp)
        a.train_step()
        written = a.checkpoints.restore(0)
        b = _mesh_trainer(copy.deepcopy(base), f"{folder}/b", data, mesh=tp)
        b.checkpoints = a.checkpoints
        t = time.perf_counter()
        b.load(0)
        load_s = time.perf_counter() - t
        loaded = b._ckpt_tree()
        params_equal = all(torch.equal(loaded["params"]["maskgit"][k], v.to(loaded["params"]["maskgit"][k].device))
                           for k, v in written["params"]["maskgit"].items())
        adam_equal = all(torch.equal(loaded["opt_state"]["state"][i][k].cpu(), v.cpu())
                         for i, per in written["opt_state"]["state"].items() for k, v in per.items())
        check(params_equal, "sharded resume: the tp = 2 trainer's parameters differ from the dp = 2 checkpoint's")
        check(adam_equal, "sharded resume: the tp = 2 trainer's Adam state differs from the checkpoint's")
        del b, loaded, written
        a.train_step()
        c = _mesh_trainer(copy.deepcopy(base), f"{folder}/c", data, mesh=dp)
        c.checkpoints = a.checkpoints
        c.load(0)
        c.train_step()
        same = _params_sha(a.model.maskgit.named_parameters()) == _params_sha(c.model.maskgit.named_parameters())
        check(same, "sharded resume: the resumed dp = 2 trainer's step differs from the live one's")
        torch.distributed.barrier()  # rank 0's folder outlives every rank's use of it
    del a, c, base
    torch.cuda.empty_cache()
    return dict(tp_load_params_equal=params_equal, tp_load_adam_equal=adam_equal, load_s=load_s,
                resume_bit_equal=same)


def mesh_small_pp(torch, pp):
    """The small fp32 model (`small_train_models`, 2 layers: one a stage) at
    pp = 2 in 2 microbatches on the card against the same at pp = 2 on the
    CPU: two `PhenakiTrainer` steps whose losses agree within rtol 2e-4,
    atol 2e-5 and consolidated parameters within rtol 1e-3, atol 3e-4 (the
    tolerances of tests/test_parallel.py:380-393); the card's run launches
    kernel 1, the CPU's none."""
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    gen = torch.Generator().manual_seed(8)
    data = torch.utils.data.TensorDataset(torch.randint(0, 512, (8, 2, 8, 8), generator=gen),
                                          torch.randn(8, 8, 64, generator=gen))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cpu", "cuda"):
            mg, cv = small_train_models(torch, 5)
            ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=6, max_text_len=16)
            before = kernel_counts()
            t = time.perf_counter()
            trainer = PhenakiTrainer(ph, dataset=data, batch_size=4, seed=0, log_every=10**9, num_samples=1,
                                     num_frames=3, sample_texts=[SAMPLE_TEXT], results_folder=f"{tmp}/{device}",
                                     mesh=pp, pipeline_microbatches=2, train_lr=1e-4)
            losses = [trainer.train_step().item() for _ in range(2)]
            params = trainer._ckpt_tree(with_optimizer=False)["params"]["maskgit"]
            runs[device] = dict(losses=losses, params=params, launches=nonzero(launched_since(before)),
                                seconds=time.perf_counter() - t)
    cpu, card = runs["cpu"], runs["cuda"]
    worst = max(((card["params"][k] - v).abs() - (3e-4 + 1e-3 * v.abs())).max().item()
                for k, v in cpu["params"].items())
    loss_ok = all(abs(a - b) <= 2e-5 + 2e-4 * abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    check(card["launches"].get("fwd", 0) > 0 and "fwd" not in cpu["launches"],
          f"small pp: kernel 1 ran {card['launches']} on the card, {cpu['launches']} on the CPU")
    check(loss_ok, f"small pp: losses {card['losses']} vs CPU {cpu['losses']}")
    check(worst <= 0, f"small pp: a parameter is {worst} beyond rtol 1e-3, atol 3e-4 of the CPU's")
    return dict(losses_card=card["losses"], losses_cpu=cpu["losses"], worst_param_excess=worst,
                card_launches=card["launches"], seconds_card=card["seconds"], seconds_cpu=cpu["seconds"])


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mesh_pipeline_train(torch, pp):
    """`PhenakiTrainer(pp=2, pipeline_microbatches=4)` on the flagship (f32
    parameters, bf16 compute) at a global batch of MESH_TRAIN_BATCH, every
    rank of the pipeline on the whole batch: the pipeline trainer A's first
    step (the milestone: rank 0's dense sample and the consolidated
    checkpoint 0) must give the one process's loss ("dp train"'s reference)
    within 1e-3 relative; then PIPE_TRAIN_STEPS counted steps, each with
    exactly PIPE_TRAIN_PER_STEP launches on this rank. Trainer B loads
    checkpoint 0 and takes A's second step on A's second batch: this rank's
    parameters must equal A's after that step, bit for bit. Rank 0 keeps the
    whole Phenaki for its milestones; the other rank drops its reference
    once its trainer is built, and its trainer keeps none. Returns seconds,
    tokens/s, the peak memory of the build (the whole Phenaki and the stage's
    copy) and of the counted steps, the bytes of the whole Phenaki kept, the
    bytes of the trunk this rank holds, and the launches."""
    from phenaki_tpu_torch.parallel.collectives import broadcast_object
    from phenaki_tpu_torch.presets import flagship_train_phenaki

    data = _mesh_data(torch)
    torch.cuda.synchronize()
    base_before = torch.cuda.memory_allocated()
    base = flagship_train_phenaki(seed=0, device="cuda")
    torch.cuda.synchronize()
    dense_gb = (torch.cuda.memory_allocated() - base_before) / 1e9
    out = {"dense_phenaki_gb": dense_gb,
           "trunk_gb_whole": _tensor_bytes(base.maskgit.transformer.layers.parameters()) / 1e9}
    with tempfile.TemporaryDirectory() as tmp:
        folder = broadcast_object(tmp, pp.world_group)  # one folder for both ranks: rank 0's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        a = _mesh_trainer(base, f"{folder}/a", data, mesh=pp, pipeline_microbatches=PIPE_MICROBATCHES)
        out["build_s"] = time.perf_counter() - t
        check((a.dense_model is not None) == (pp.rank == 0),
              f"pipeline train: rank {pp.rank}'s trainer keeps the whole Phenaki: {a.dense_model is not None}")
        if pp.rank != 0:
            base = None  # only rank 0 samples the milestones
        gc.collect()
        torch.cuda.synchronize()
        out["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["dense_phenaki_gb_kept"] = dense_gb if base is not None else 0.0
        out["trunk_gb_this_rank"] = _tensor_bytes(a.model.maskgit.transformer.layers.parameters()) / 1e9
        out["stage_layers"] = sorted(int(k) for k in a.model.maskgit.transformer.layers.keys())
        t = time.perf_counter()
        out["first_loss"] = a.train_step().item()
        out["first_step_s"] = time.perf_counter() - t  # the milestone's sample and checkpoint included
        torch.cuda.synchronize()
        out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        seconds, losses = [], []
        for step in range(PIPE_TRAIN_STEPS):
            before = kernel_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(a.train_step().item())
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            launched = launched_since(before)
            check(launched == exact(PIPE_TRAIN_PER_STEP),
                  f"pipeline train step {step}: launches {nonzero(launched)} != {PIPE_TRAIN_PER_STEP}")
            if step == 0:
                after_step2 = _params_sha(a.model.maskgit.named_parameters())
        check(all(map(math.isfinite, losses)), f"pipeline train: non-finite loss {losses}")
        out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["train_peak_gb_without_dense"] = out["train_peak_gb"] - out["dense_phenaki_gb_kept"]
        consolidated = a._ckpt_tree(with_optimizer=False)["params"]["maskgit"]
        out.update(losses=losses, step_seconds=seconds, launches=kernel_counts(),
                   consolidated_sha=_params_sha(sorted(consolidated.items())))
        checkpoints = a.checkpoints
        del a
        torch.cuda.empty_cache()
        b = _mesh_trainer(base if base is not None else flagship_train_phenaki(seed=0, device="cuda"),
                          f"{folder}/b", data, mesh=pp, pipeline_microbatches=PIPE_MICROBATCHES)
        b.checkpoints = checkpoints
        next(b.dl)  # the batch A's first step took: a checkpoint holds no data order
        t = time.perf_counter()
        b.load(0)
        out["load_s"] = time.perf_counter() - t
        b.train_step()
        out["resume_bit_equal"] = _params_sha(b.model.maskgit.named_parameters()) == after_step2
        check(out["resume_bit_equal"], "pipeline resume: the resumed pp = 2 trainer's step differs from the live one's")
        out["checkpoint_bytes"] = checkpoints.path(0).stat().st_size
        del b
        torch.distributed.barrier()  # rank 0's folder outlives every rank's use of it
    del base
    torch.cuda.empty_cache()
    return out


def fsdp_pipeline_rank(rank, world):
    """One rank of the FSDP x pipeline paths (spawned, FSDP_PIPE_RANKS ranks
    on a dp 2 x pp 2 mesh): the small fp32 check, then the flagship train
    path. Returns plain numbers; raises on a failed check."""
    import torch
    import torch.distributed as dist

    from phenaki_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    if dist.get_backend() != "nccl":
        torch.cuda.set_device(0)  # every gloo rank computes on the one card
    mesh = make_mesh(dp=FSDP_PIPE_DP, pp=PIPE_STAGES)
    out = {"backend": dist.get_backend(), "device": torch.cuda.current_device(), "coords": mesh.coords,
           "phase_s": {}}
    for name, run in (("small", lambda: fsdp_pipeline_small(torch, mesh)),
                      ("train", lambda: fsdp_pipeline_train(torch, mesh))):
        t = time.perf_counter()
        out[name] = run()
        out["phase_s"][name] = time.perf_counter() - t
    return out


def fsdp_pipeline_small(torch, mesh):
    """The small fp32 model (`small_train_models`) at dp 2 x pp 2 with FSDP
    (the size threshold lowered to 256, as the CPU tests lower it, so that
    its layers shard too) in 4 microbatches against one process, both on the
    card: two `PhenakiTrainer` steps, the losses and parameters within the
    tolerances of tests/test_parallel.py:380-393, and step 1's gradient of
    every parameter this rank holds (consolidated, the clipped ones Adam
    reads) within atol 1e-4 x max|g| (floored at 1e-3), since Adam's first
    steps barely see a gradient's scale. Each rank runs the one process too."""
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.parallel import mesh as mesh_rules
    from phenaki_tpu_torch.parallel.tp_inference import global_value
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    gen = torch.Generator().manual_seed(8)
    data = torch.utils.data.TensorDataset(torch.randint(0, 512, (8, 2, 8, 8), generator=gen),
                                          torch.randn(8, 8, 64, generator=gen))
    runs, min_size = {}, mesh_rules.FSDP_MIN_SIZE
    mesh_rules.FSDP_MIN_SIZE = 256
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label, on_mesh in (("one", None), ("fsdp_pp", mesh)):
                mg, cv = small_train_models(torch, 5)
                ph = Phenaki(maskgit=mg.cuda(), cvivit=cv.cuda(), text_embed_dim=64, steps=6, max_text_len=16)
                before = kernel_counts()
                t = time.perf_counter()
                trainer = PhenakiTrainer(ph, dataset=data, batch_size=4, seed=0, log_every=10**9, num_samples=1,
                                         num_frames=3, sample_texts=[SAMPLE_TEXT], results_folder=f"{tmp}/{label}",
                                         mesh=on_mesh, fsdp=on_mesh is not None,
                                         pipeline_microbatches=None if on_mesh is None else 4, train_lr=1e-4,
                                         max_grad_norm=0.5)
                grads = []

                def record(*_, trainer=trainer, on_mesh=on_mesh):
                    grads.append({n: global_value(n, p.grad, on_mesh, trainer.global_shapes[n]).cpu()
                                  if on_mesh is not None else p.grad.detach().cpu()
                                  for n, p in trainer._named_params()})

                trainer.opt.register_step_pre_hook(record)
                losses = [trainer.train_step().item() for _ in range(2)]
                params = {k: v.cpu() for k, v in trainer._ckpt_tree(with_optimizer=False)["params"]["maskgit"].items()}
                runs[label] = dict(losses=losses, params=params, grads=grads[0], seconds=time.perf_counter() - t,
                                   launches=nonzero(launched_since(before)),
                                   sharded=sum(hasattr(p, "placements") for p in trainer.model.maskgit.parameters()))
    finally:
        mesh_rules.FSDP_MIN_SIZE = min_size
    one, sharded = runs["one"], runs["fsdp_pp"]
    worst = max(((sharded["params"][k] - v).abs() - (3e-4 + 1e-3 * v.abs())).max().item()
                for k, v in one["params"].items())
    grad_worst = max(((g - one["grads"][n]).abs().max() / max(one["grads"][n].abs().max().item(), 1e-3)).item()
                     for n, g in sharded["grads"].items())
    loss_ok = all(abs(a - b) <= 2e-5 + 2e-4 * abs(b) for a, b in zip(sharded["losses"], one["losses"]))
    check(sharded["sharded"] > 0, "small fsdp pp: no parameter is FSDP-sharded")
    check(sharded["launches"].get("fwd", 0) > 0, f"small fsdp pp: kernel 1 ran {sharded['launches']}")
    check(loss_ok, f"small fsdp pp: losses {sharded['losses']} vs one process {one['losses']}")
    check(worst <= 0, f"small fsdp pp: a parameter is {worst} beyond rtol 1e-3, atol 3e-4 of one process's")
    check(grad_worst <= 1e-4, f"small fsdp pp: a step-1 gradient is {grad_worst} x max|g| from one process's")
    return dict(losses=sharded["losses"], losses_one_process=one["losses"], worst_param_excess=worst,
                worst_grad_err_over_max=grad_worst, grads_compared=len(sharded["grads"]),
                sharded_maskgit_params=sharded["sharded"], launches=sharded["launches"],
                seconds=sharded["seconds"], seconds_one_process=one["seconds"])


def _local_bytes(params) -> int:
    return _tensor_bytes(p.to_local() if hasattr(p, "to_local") else p for p in params)


def fsdp_pipeline_train(torch, mesh):
    """`PhenakiTrainer(mesh=dp 2 x pp 2, pipeline_microbatches=4)` on the
    flagship (f32 parameters, bf16 compute) at a global batch of
    MESH_TRAIN_BATCH, without FSDP (the yardstick) and with it: each
    trainer's first step (the milestone) must give rank 0's one-process loss
    within 1e-3 relative; then FSDP_PIPE_STEPS counted steps, each with
    exactly FSDP_PIPE_TRAIN_PER_STEP launches on this rank. With FSDP,
    trainer B loads checkpoint 0 and takes A's second step on A's second
    batch: this rank's shards must equal A's, bit for bit. Returns seconds,
    peak memory of the counted steps, the parameter bytes this rank holds,
    the launches, and the consolidated parameters' digest."""
    import copy

    from phenaki_tpu_torch.parallel.collectives import broadcast_object
    from phenaki_tpu_torch.presets import flagship_train_phenaki

    data = _mesh_data(torch)
    base = flagship_train_phenaki(seed=0, device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = broadcast_object(tmp, mesh.world_group)  # one folder for every rank: rank 0's
        if mesh.rank == 0:
            ref = _mesh_trainer(copy.deepcopy(base), f"{folder}/ref", data)
            out["one_process_loss"] = ref.train_step().item()
            del ref
            torch.cuda.empty_cache()
        for label, fsdp in (("pp", False), ("fsdp_pp", True)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            a = _mesh_trainer(copy.deepcopy(base), f"{folder}/{label}", data, mesh=mesh, fsdp=fsdp,
                              pipeline_microbatches=PIPE_MICROBATCHES)
            entry = {"build_s": time.perf_counter() - t,
                     "param_bytes": _local_bytes(a.model.maskgit.parameters()),
                     "sharded_params": sum(hasattr(p, "placements") for p in a.model.maskgit.parameters()),
                     "stage_layers": sorted(int(k) for k in a.model.maskgit.transformer.layers.keys())}
            t = time.perf_counter()
            entry["first_loss"] = a.train_step().item()
            entry["first_step_s"] = time.perf_counter() - t  # the milestone's sample and checkpoint included
            torch.cuda.synchronize()
            entry["resident_gb"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_counts()
            seconds, losses = [], []
            for step in range(FSDP_PIPE_STEPS):
                before = kernel_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(a.train_step().item())
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
                launched = launched_since(before)
                check(launched == exact(FSDP_PIPE_TRAIN_PER_STEP),
                      f"{label} train step {step}: launches {nonzero(launched)} != {FSDP_PIPE_TRAIN_PER_STEP}")
                if step == 0:
                    after_step2 = _params_sha(a.model.maskgit.named_parameters())
            check(all(map(math.isfinite, losses)), f"{label} train: non-finite loss {losses}")
            entry.update(losses=losses, step_seconds=seconds, launches=kernel_counts(),
                         train_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         adam_bytes=_local_bytes(v for per in a.opt.state.values() for v in per.values()
                                                 if isinstance(v, torch.Tensor) and v.ndim))
            consolidated = a._ckpt_tree(with_optimizer=False)["params"]["maskgit"]
            entry["consolidated_sha"] = _params_sha(sorted(consolidated.items()))
            del consolidated
            if fsdp:
                checkpoints = a.checkpoints
                del a
                gc.collect()
                torch.cuda.empty_cache()
                b = _mesh_trainer(copy.deepcopy(base), f"{folder}/b", data, mesh=mesh, fsdp=True,
                                  pipeline_microbatches=PIPE_MICROBATCHES)
                b.checkpoints = checkpoints
                next(b.dl)  # the batch A's first step took: a checkpoint holds no data order
                t = time.perf_counter()
                b.load(0)
                entry["load_s"] = time.perf_counter() - t
                b.train_step()
                entry["resume_bit_equal"] = _params_sha(b.model.maskgit.named_parameters()) == after_step2
                check(entry["resume_bit_equal"],
                      "fsdp pipeline resume: the resumed trainer's step differs from the live one's")
                entry["checkpoint_bytes"] = checkpoints.path(0).stat().st_size
                del b
            else:
                del a
            out[label] = entry
        torch.distributed.barrier()  # rank 0's folder outlives every rank's use of it
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_fsdp_pipeline(torch, card, pipe_peaks_gb=None):
    """Spawn FSDP_PIPE_RANKS ranks (NCCL with a GPU a rank when there are
    enough cards; gloo with every rank on cuda:0 otherwise) for the FSDP x
    pipeline paths. Checks across ranks: equal losses and consolidated
    parameters, first losses against rank 0's one process, the stages'
    layers. `pipe_peaks_gb` is the pp = 2 path's step peaks a rank (two
    ranks, no FSDP, each rank on the whole batch), printed beside. Returns
    the FSDP path's launches summed over the ranks."""
    from phenaki_tpu_torch.parallel.distributed import default_backend, spawn_ranks

    backend = default_backend(FSDP_PIPE_RANKS)
    t0 = time.perf_counter()
    results = spawn_ranks(fsdp_pipeline_rank, FSDP_PIPE_RANKS, backend=backend, timeout=RANK_TIMEOUT_S)
    phase("fsdp pipeline ranks", backend=backend, ranks=FSDP_PIPE_RANKS, coords=[r["coords"] for r in results],
          devices=[r["device"] for r in results], one_shared_gpu=backend != "nccl",
          gpus=torch.cuda.device_count(), wall_s=time.perf_counter() - t0,
          phase_s=[r["phase_s"] for r in results], card=card)
    for rank, r in enumerate(results):
        phase(f"small fp32 fsdp pipeline vs one process on the card, rank {rank}", card=card, **r["small"])
    ref = results[0]["train"]["one_process_loss"]
    for label in ("pp", "fsdp_pp"):
        entries = [r["train"][label] for r in results]
        firsts = [e["first_loss"] for e in entries]
        check(all(abs(f - ref) <= 1e-3 * abs(ref) for f in firsts),
              f"{label} train: first losses {firsts} vs one process {ref}")
        check(all(e["losses"] == entries[0]["losses"] for e in entries), f"{label} train: losses differ across ranks")
        check(len({e["consolidated_sha"] for e in entries}) == 1, f"{label} train: consolidated parameters differ")
        check(sorted(set(sum((e["stage_layers"] for e in entries), []))) == list(range(6)),
              f"{label} train: the stages hold layers {[e['stage_layers'] for e in entries]}")
    fsdp, plain = ([r["train"][k] for r in results] for k in ("fsdp_pp", "pp"))
    check(all(e["sharded_params"] > 0 for e in fsdp), "fsdp pipeline train: a rank shards no parameter")
    for rank, (e, p) in enumerate(zip(fsdp, plain)):
        per_step = statistics.median(e["step_seconds"])
        phase(f"fsdp pipeline train, rank {rank}", card=card, coords=results[rank]["coords"], dp=FSDP_PIPE_DP,
              stages=PIPE_STAGES, microbatches=PIPE_MICROBATCHES, batch=MESH_TRAIN_BATCH,
              seconds_per_step=per_step, step_seconds=e["step_seconds"],
              tokens_per_s=MESH_TRAIN_BATCH * 1152 / per_step, first_loss=e["first_loss"],
              one_process_first_loss=ref, losses=e["losses"], train_peak_gb=e["train_peak_gb"],
              train_peak_gb_without_fsdp=p["train_peak_gb"], pp2_two_rank_train_peak_gb=pipe_peaks_gb,
              seconds_per_step_without_fsdp=statistics.median(p["step_seconds"]),
              param_bytes=e["param_bytes"], param_bytes_without_fsdp=p["param_bytes"],
              adam_bytes=e["adam_bytes"], adam_bytes_without_fsdp=p["adam_bytes"],
              sharded_params=e["sharded_params"], stage_layers=e["stage_layers"],
              resident_gb_after_milestone=e["resident_gb"], build_s=e["build_s"], first_step_s=e["first_step_s"],
              launches_per_step=FSDP_PIPE_TRAIN_PER_STEP, launches=nonzero(e["launches"]),
              resume_bit_equal=e["resume_bit_equal"], load_s=e["load_s"], checkpoint_bytes=e["checkpoint_bytes"])
    return {"fsdp_pipeline_train": {key: sum(e["launches"][key] for e in fsdp) for key in all_kernels()}}


def mesh_gan_dp(torch, dp):
    """`CViViTTrainer` on the flagship C-ViViT at dp = 2, a global batch of
    MESH_GAN_BATCH (2 a rank) from 8 seeded videos, the R1 penalty on step
    0 (whose reconstructions and checkpoint follow it); steps 1 and 2 each
    launch exactly GAN_PER_STEP on this rank. Returns the losses, seconds and
    a digest of both models' parameters (the check across ranks)."""
    from phenaki_tpu_torch.presets import flagship_train_cvivit
    from phenaki_tpu_torch.training.cvivit_trainer import CViViTTrainer

    gen = torch.Generator().manual_seed(30)
    videos = [torch.rand(17, 256, 128, 3, generator=gen).numpy() for _ in range(8)]
    with tempfile.TemporaryDirectory() as tmp:
        trainer = CViViTTrainer(flagship_train_cvivit(seed=0, device="cuda"), dataset=videos, num_train_steps=10**9,
                                batch_size=MESH_GAN_BATCH, num_frames=17, discr_base_dim=64,
                                discr_attn_res_layers=(16,), perceptual_mode="disc", use_ema=True,
                                apply_grad_penalty_every=GAN_PENALTY_EVERY, valid_frac=0.0, save_results_every=10**9,
                                save_model_every=10**9, seed=0, log_every=10**9, results_folder=tmp, mesh=dp)
        seconds, logs, launches = [], [], []
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        for step in range(MESH_GAN_STEPS):
            launches.append(gan_step(torch, trainer, seconds, logs))
        for step, launched in enumerate(launches[1:], start=1):
            check(launched == exact(GAN_PER_STEP), f"gan dp step {step}: launches {nonzero(launched)} != {GAN_PER_STEP}")
        check(all(math.isfinite(v) for log in logs for v in log.values()), f"gan dp: non-finite loss {logs}")
        check(logs[0]["grad_penalty"] > 0 and logs[1]["grad_penalty"] == 0.0,
              f"gan dp: the R1 penalty on step 0 only: {[log['grad_penalty'] for log in logs]}")
        out = dict(logs=logs, step_seconds=seconds, launches=kernel_counts(),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   params_sha=_params_sha(list(trainer.vae.named_parameters())
                                          + list(trainer.discr.named_parameters())))
        del trainer
    torch.cuda.empty_cache()
    return out


def mesh_serving(torch, tp):
    """`PhenakiServer(mesh=)` at tp = 2 on the flagship: rank 0 takes
    MESH_SERVE_REQUESTS requests (bucket 1, float32 output) and the other
    rank follows; each launch makes exactly SAMPLE_LAUNCHES on each rank,
    `close()` returns on both, and every served video equals
    `sample(mesh=)`'s for its launch's seed."""
    from phenaki_tpu_torch.presets import flagship_phenaki
    from phenaki_tpu_torch.serving import PhenakiServer

    ph = flagship_phenaki(seed=0, device="cuda")
    emb = [torch.randn(50, 768, generator=torch.Generator().manual_seed(40 + i)) for i in range(MESH_SERVE_REQUESTS)]
    server = PhenakiServer(ph, mesh=tp, num_frames=17, cond_scale=5.0, batch_buckets=(1,), seed=3,
                           output_dtype="float32", max_delay_ms=1.0)
    reset_kernel_counts()
    t = time.perf_counter()
    served = None
    if tp.rank == 0:
        futures = [server.submit(text_embeds=e) for e in emb]
        served = [f.result(timeout=SERVE_TIMEOUT_S) for f in futures]
    server.close(timeout=SERVE_TIMEOUT_S)
    seconds = time.perf_counter() - t
    launches = kernel_counts()
    check(not server._thread.is_alive(), "serving mesh: close() did not end this rank's serving thread")
    check(launches == exact(scaled(SAMPLE_LAUNCHES, MESH_SERVE_REQUESTS)),
          f"serving mesh: launches {nonzero(launches)} != {MESH_SERVE_REQUESTS} x {SAMPLE_LAUNCHES}")
    seeds = torch.Generator().manual_seed(3)
    equal = []
    for i, e in enumerate(emb):
        launch = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=seeds)))
        want = ph.sample(num_frames=17, text_embeds=e[None], cond_scale=5.0, mesh=tp, generator=launch)[0]
        if served is not None:
            equal.append(bool(torch.equal(torch.from_numpy(served[i]), want.float().cpu())))
    check(all(equal), f"serving mesh: served videos equal sample(mesh=)'s: {equal}")
    del ph, server
    torch.cuda.empty_cache()
    return dict(seconds=seconds, requests=MESH_SERVE_REQUESTS, launches=launches, served_equal_sample=equal)


def run_mesh_paths(torch, card, profile_path=None):
    """Spawn MESH ranks (NCCL with a GPU a rank when there are enough cards;
    gloo with every rank on cuda:0 otherwise) for the mesh paths. Checks
    across ranks: the same tp ids, the same dp video, dp parameters
    bit-identical, the same GAN parameters; on rank 0 the dp and fsdp
    first losses against the one-process step, and FSDP's consolidated
    parameters against DDP's. Returns each path's launches summed over the
    ranks, and the pipeline path's step peaks a rank."""
    import numpy as np

    from phenaki_tpu_torch.parallel.distributed import default_backend, spawn_ranks

    backend = default_backend(MESH)
    t0 = time.perf_counter()
    results = spawn_ranks(mesh_rank, MESH, profile_path, backend=backend, timeout=RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    phase("mesh ranks", backend=backend, ranks=MESH, devices=[r["device"] for r in results],
          one_shared_gpu=backend != "nccl", gpus=torch.cuda.device_count(), wall_s=wall,
          phase_s=[r["phase_s"] for r in results], card=card)
    check(all(r["backend"] == backend for r in results), "a rank ran another backend")

    tps = [r["tp_sample"] for r in results]
    for name in tps[0]["ids"]:
        check(all(np.array_equal(t["ids"][name], tps[0]["ids"][name]) for t in tps),
              f"tp sample {name}: ids differ across ranks")
    for rank, t in enumerate(tps):
        timed = ("req1", "req2", "req3")
        phase(f"tp sample, rank {rank}", seconds_per_sample_b1=statistics.median(t["seconds"][n] for n in timed),
              dense_seconds_per_sample_b1=statistics.median(t["dense_seconds"][n] for n in timed),
              seconds=t["seconds"], dense_seconds=t["dense_seconds"], ids_equal_dense_share=t["equal_share"],
              ids_identical_across_ranks=True, launches_per_sample=SAMPLE_LAUNCHES, launches=nonzero(t["launches"]),
              peak_mem_gb=t["peak_mem_gb"], profile=t.get("profile"), card=card)
    for rank, r in enumerate(results):
        phase(f"small fp32 tp = 2 model card vs cpu, rank {rank}", **r["small_tp"])

    dps = [r["dp_sample"] for r in results]
    check(len({d["video_sha"] for d in dps}) == 1, "dp sample: the ranks hold different global videos")
    phase("dp sample", seconds_b2=[d["seconds_b2"] for d in dps], rows_equal_alone=True,
          same_global_video=True, launches_per_rank=SAMPLE_LAUNCHES, card=card)

    trains = [r["train"] for r in results]
    ref = trains[0]["one_process_loss"]
    for label in ("dp", "fsdp", "tp"):
        entries = [t[label] for t in trains]
        firsts = [e["first_loss"] for e in entries]
        check(all(abs(f - ref) <= 1e-3 * abs(ref) for f in firsts),
              f"{label} train: first losses {firsts} vs one process {ref}")
        check(len({e["consolidated_sha"] for e in entries}) == 1, f"{label} train: consolidated parameters differ")
        check(all(e["losses"] == entries[0]["losses"] for e in entries), f"{label} train: losses differ across ranks")
        extra = {}
        if label == "dp":
            check(len({e["params_sha"] for e in entries}) == 1, "dp train: parameters differ across ranks")
            extra["params_identical_across_ranks"] = True
        if label == "tp":
            extra.update(head_rows_per_rank=[e["head_rows"] for e in entries],
                         head_moment_rows_per_rank=[e["head_moment_rows"] for e in entries],
                         head_gather_host_s_per_step=statistics.median(s for e in entries for s in e["head_gather_s"]),
                         head_gather_host_s=[e["head_gather_s"] for e in entries])
        if label == "fsdp":
            dense = trains[0]["dp"]["consolidated"]
            worst = max((v.float().cpu() - dense[k].float().cpu()).abs().max().item()
                        for k, v in trains[0]["fsdp"]["consolidated"].items())
            check(worst <= 1e-3, f"fsdp train: consolidated parameters {worst} from DDP's")
            extra["max_abs_diff_from_ddp"] = worst
            extra["peak_mem_gb_ddp"] = [t["dp"]["peak_mem_gb"] for t in trains]
        per_step = statistics.median(s for e in entries for s in e["step_seconds"])
        phase(f"{label} train", one_process_first_loss=ref, first_losses=firsts, losses=entries[0]["losses"],
              seconds_per_step=per_step, step_seconds=[e["step_seconds"] for e in entries],
              samples_per_s=MESH_TRAIN_BATCH / per_step, peak_mem_gb=[e["peak_mem_gb"] for e in entries],
              launches_per_step_per_rank=TRAIN_PER_STEP, card=card, **extra)
    for rank, r in enumerate(results):
        phase(f"sharded resume, rank {rank}", **r["resume"])
    for rank, r in enumerate(results):
        phase(f"small fp32 pipeline card vs cpu, rank {rank}", **r["small_pp"])
    pipes = [r["pipeline"] for r in results]
    one = trains[0]  # rank 0's one-process trainer on the same data ("dp train")
    ref = one["one_process_loss"]
    firsts = [p["first_loss"] for p in pipes]
    check(all(abs(f - ref) <= 1e-3 * abs(ref) for f in firsts),
          f"pipeline train: first losses {firsts} vs one process {ref}")
    check(all(p["losses"] == pipes[0]["losses"] for p in pipes), "pipeline train: losses differ across ranks")
    check(len({p["consolidated_sha"] for p in pipes}) == 1, "pipeline train: consolidated parameters differ")
    check(sorted(sum((p["stage_layers"] for p in pipes), [])) == list(range(6)),
          f"pipeline train: the stages hold layers {[p['stage_layers'] for p in pipes]}")
    for rank, p in enumerate(pipes):
        per_step = statistics.median(p["step_seconds"])
        phase(f"pipeline train path, rank {rank}", card=card, stages=PIPE_STAGES, microbatches=PIPE_MICROBATCHES,
              batch=MESH_TRAIN_BATCH, seconds_per_step=per_step, step_seconds=p["step_seconds"],
              tokens_per_s=MESH_TRAIN_BATCH * 1152 / per_step, first_loss=p["first_loss"],
              one_process_first_loss=ref, losses=p["losses"], train_peak_gb=p["train_peak_gb"],
              train_peak_gb_without_dense=p["train_peak_gb_without_dense"],
              dense_phenaki_gb_kept_for_milestones=p["dense_phenaki_gb_kept"],
              dense_phenaki_gb=p["dense_phenaki_gb"], build_peak_gb=p["build_peak_gb"],
              resident_gb_after_milestone=p["resident_gb"],
              one_process_peak_gb=one["one_process_peak_gb"], one_process_step_s=one["one_process_step_s"],
              build_s=p["build_s"], first_step_s=p["first_step_s"], stage_layers=p["stage_layers"],
              trunk_gb_this_rank=p["trunk_gb_this_rank"], trunk_gb_whole=p["trunk_gb_whole"],
              launches_per_step=PIPE_TRAIN_PER_STEP, launches=nonzero(p["launches"]),
              resume_bit_equal=p["resume_bit_equal"], load_s=p["load_s"], checkpoint_bytes=p["checkpoint_bytes"])
    gans = [r["gan"] for r in results]
    check(len({g["params_sha"] for g in gans}) == 1, "gan dp: parameters differ across ranks")
    phase("cvivit gan dp", logs=gans[0]["logs"], step_seconds=[g["step_seconds"] for g in gans],
          peak_mem_gb=[g["peak_mem_gb"] for g in gans], params_identical_across_ranks=True,
          launches_per_step_per_rank=GAN_PER_STEP, card=card)
    serves = [r["serving"] for r in results]
    phase("serving mesh", seconds=[s["seconds"] for s in serves], requests=MESH_SERVE_REQUESTS,
          served_equal_sample=serves[0]["served_equal_sample"], close_returned_on_every_rank=True,
          launches_per_rank=[nonzero(s["launches"]) for s in serves], card=card)

    def summed(path, sub=None):
        return {key: sum((r[path][sub] if sub else r[path])["launches"][key] for r in results)
                for key in all_kernels()}

    launches = {"tp_sample": summed("tp_sample"), "dp_sample": summed("dp_sample"),
                "dp_train": summed("train", "dp"), "fsdp_train": summed("train", "fsdp"),
                "tp_train": summed("train", "tp"), "pipeline_train": summed("pipeline"),
                "cvivit_gan_dp": summed("gan"), "serving_mesh": summed("serving")}
    return launches, [p["train_peak_gb"] for p in pipes]


def profile_train_steps(torch, trainer, path):
    """torch.profiler over two flagship train steps, written to `path`:
    device time by kernel, and by the operator (autograd node included)
    that launched it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer.train_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(
        events.table(sort_by="self_device_time_total", row_limit=60, max_name_column_width=100)
        + "\n" + events.table(sort_by="device_time_total", row_limit=80, max_name_column_width=100))
    device_ms, flash_ms = device_shares(torch, events)
    phase("train profile", path=str(path), steps=2, device_ms_per_step=device_ms / 2,
          flash_fwd_ms_per_step=flash_ms / 2, flash_fwd_share=flash_ms / device_ms)


def main() -> int:
    try:
        import torch
        from phenaki_tpu_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    t = time.perf_counter()
    _build.load_library()
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          nvcc_build_s=_build.build_seconds, load_s=time.perf_counter() - t)
    check_wgmma_build()

    flash = check_flash(torch)
    bwd_all = check_flash_bwd(torch)
    bwd = bwd_all["maskgit_self_bfloat16"]
    chunk = check_chunk(torch)["flagship_other_shard_bfloat16"]
    check_chunk_bwd(torch)
    proj_all = check_proj(torch)
    proj = proj_all["d512_bfloat16"]
    proj_slice = check_proj_primed_slice(torch)
    ce = check_fused_ce(torch)["train_bfloat16"]
    gumbel = check_gumbel_kernel(torch)["stacked_bfloat16"]
    peg_all = check_peg(torch)
    norms_all = check_norms(torch)
    ff_all = check_ff(torch)
    check_small_model(torch)
    check_small_model(torch, reference_layout=True)
    check_small_train(torch)
    check_small_critic(torch)
    check_gumbel(torch)
    check_learning(torch)
    check_cvivit_overfit(torch, card)
    check_small_discriminator(torch)
    check_t5_stack(torch)
    run_e2e_example(torch)
    args = sys.argv[1:]
    sample_profile = args[args.index("--profile-sample") + 1] if "--profile-sample" in args else None
    paths = run_sample_paths(torch, sample_profile)
    paths["tpu_native_sample"] = run_tpu_native_sample_path(torch)
    tokenize_profile = args[args.index("--profile-tokenize") + 1] if "--profile-tokenize" in args else None
    scene_profile = args[args.index("--profile-scene") + 1] if "--profile-scene" in args else None
    paths.update(run_long_video_paths(torch, card, tokenize_profile, scene_profile))
    serving_profile = args[args.index("--profile-serving") + 1] if "--profile-serving" in args else None
    paths.update(run_serving_paths(torch, card, serving_profile))
    profile_path = args[args.index("--profile-train") + 1] if "--profile-train" in args else None
    paths["train"] = run_train_path(torch, "train path", TRAIN_PER_STEP, TRAIN_STEPS, profile_path)
    paths["tpu_native_train"] = run_tpu_native_train_path(torch)
    paths["remat_train"] = run_remat_train_path(torch)
    paths["token_critic_train"] = run_train_path(torch, "token critic train path", CRITIC_TRAIN_PER_STEP,
                                                 CRITIC_TRAIN_STEPS, critic=True)
    paths["raw_train"] = run_raw_train_path(torch, card)
    gan_profile = args[args.index("--profile-gan") + 1] if "--profile-gan" in args else None
    paths["cvivit_gan_train"] = run_cvivit_gan_path(torch, card, gan_profile)
    seq_profile = args[args.index("--profile-seq") + 1] if "--profile-seq" in args else None
    paths["seq_sharded_sample_and_train"] = run_seq_parallel(torch, seq_profile)
    tp_profile = args[args.index("--profile-tp") + 1] if "--profile-tp" in args else None
    mesh_paths, pipe_peaks_gb = run_mesh_paths(torch, card, tp_profile)
    paths.update(mesh_paths)
    paths.update(run_fsdp_pipeline(torch, card, pipe_peaks_gb))
    # each path ran with its counts set to 0 before it: a kernel's launches
    # are its sum over the paths
    launches = {key: sum(p[key] for p in paths.values()) for key in all_kernels()}
    phase("launches by path", **{name: nonzero(p) for name, p in paths.items()})
    check(all(launches.values()), f"a kernel was launched on no main path: {launches}")

    # every number measured in this run; bound_ms from this run's shapes;
    # library_ms the one PyTorch call computing the same function, or null
    # (every ms timed by back-to-back calls; graph_ms of kernels 1-9, and
    # the forward's library_graph_ms, by CUDA-graph replay, the device time
    # alone)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_graph_ms")
    self_bf16 = flash["maskgit_self_bfloat16"]
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=FLASH_SRC, replaces=FLASH_TPU,
             launches=launches["fwd"], **{k: self_bf16[k] for k in keys}, graph_ms=self_bf16["graph_ms"],
             library_graph_ms=self_bf16["library_graph_ms"],
             shapes={name: {k: flash[f"{name}_bfloat16"][k] for k in shape_keys}
                     for name in FLASH_MAIN_SHAPES}),
        dict(name="flash_attend_chunk", route="cuda", source=FLASH_SRC, replaces=CHUNK_TPU,
             launches=launches["chunk"], **{k: chunk[k] for k in keys}, graph_ms=chunk["graph_ms"]),
        dict(name="proj_sample", route="cuda", source=PROJ_SRC, replaces=PROJ_TPU,
             launches=launches["proj"], **{k: proj[k] for k in keys},
             **{k: proj[k] for k in ("graph_ms", "ms_philox", "graph_ms_philox", "bound_ms_philox",
                                     "bound_by_philox", "matmul_ms")}, primed_slice=proj_slice,
             shapes={tag: {k: proj_all[tag][k] for k in ("max_abs_err", "ms", "graph_ms", "ms_philox",
                                                         "graph_ms_philox", "plain_ms", "bound_ms",
                                                         "bound_by", "bound_ms_philox", "library_ms")}
                     for tag in PROJ_MAIN_SHAPES}),
        dict(name="gumbel_sample", route="cuda", source=GUMBEL_SRC, replaces=GUMBEL_TPU,
             launches=launches["gumbel"], ms_philox=gumbel["ms_philox"], **{k: gumbel[k] for k in keys}),
    ]
    def bwd_numbers(case, name, errs):
        return dict(max_abs_err=max(case["abs_errs"][e] for e in errs), ms=case["ms"][name],
                    graph_ms=case["graph_ms"][name], plain_ms=case["plain_ms"][name],
                    bound_ms=case["bounds"][name][0], bound_by=case["bounds"][name][1],
                    library_ms=case["library_ms"])

    for name, errs in (("dq", ["dq"]), ("dkv", ["dk", "dv"]), ("dbias", ["dbias"])):
        # library_ms: SDPA's whole backward, which computes all three at once
        kernels.append(dict(name=f"flash_attention_bwd_{name}", route="cuda", source=BWD_SRC,
                            replaces=BWD_TPU[name], launches=launches[name], **bwd_numbers(bwd, name, errs),
                            shapes={shape: bwd_numbers(bwd_all[f"{shape}_bfloat16"], name, errs)
                                    for shape in BWD_YARDSTICK_SHAPES
                                    if name in bwd_all[f"{shape}_bfloat16"]["ms"]}))
    for name, errs in (("ce_fwd", ["loss", "lse"]), ("ce_dh", ["dh"]), ("ce_dw", ["dw", "db"])):
        # matmul_ms: the bf16 torch.matmul products the kernel computes, a
        # yardstick (no one PyTorch call computes the fused function)
        kernels.append(dict(name=f"fused_{name}", route="cuda", source=CE_SRC, replaces=CE_TPU[name],
                            launches=launches[name], max_abs_err=max(ce["abs_errs"][e] for e in errs),
                            ms=ce["ms"][name], graph_ms=ce["graph_ms"][name], plain_ms=ce["plain_ms"][name],
                            bound_ms=ce["bounds"][name][0], bound_by=ce["bounds"][name][1], library_ms=None,
                            matmul_ms=ce["matmul_ms"][name]))
    kernels.append(dict(name="peg_stencil", route="cuda", source=PEG_SRC, replaces=PEG_TPU,
                        launches=launches["peg"], **peg_all["maskgit"],
                        shapes={tag: peg_all[tag] for tag in peg_all}))
    for name, key, main in (("layer_norm", "ln", "layer_norm_maskgit"),
                            ("qk_norm_split", "qk", "qk_norm_split_maskgit_self")):
        kernels.append(dict(name=name, route="cuda", source=NORMS_SRC, replaces=NORMS_TPU, launches=launches[key],
                            **norms_all[main], shapes={tag: r for tag, r in norms_all.items() if tag.startswith(name)}))
    kernels.append(dict(name="geglu_gemm", route="cuda", source=FF_SRC, replaces=FF_TPU, launches=launches["ff"],
                        **ff_all["maskgit"], shapes=ff_all))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
