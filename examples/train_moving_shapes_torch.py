"""End-to-end learning demonstration of the PyTorch/CUDA port on synthetic
data (the port's counterpart of examples/train_moving_shapes.py, with its
data, model sizes, optimizers, defaults and verdict).

Trains the whole Phenaki pipeline from scratch on a toy text-to-video task,
a bright square moving in the direction its caption names, and checks that
the system learns end to end:

  1. the C-ViViT tokenizer, recon-only -> reconstruction PSNR
  2. the MaskGit on (tokens, caption) pairs -> masked-CE drop
  3. text-conditioned sampling with classifier-free guidance -> does the
     generated video move as its caption says? (the brightest blob tracked)

The tokenizer, the transformer, the conditioning and CFG must all work for
the direction accuracy to beat chance (25%). The verdict line reads
"SYSTEM E2E: PASS" when the tokenizer's PSNR exceeds 25 dB and the
accuracy 50%, else "SYSTEM E2E: WEAK".

Runs on the GPU unless `--device cpu` is given (`--steps1 20 --steps2 20`
makes a smoke run of it on the CPU). Imports torch and the port only.

Usage: python examples/train_moving_shapes_torch.py [--steps1 N] [--steps2 N]
       [--batch N] [--device cuda|cpu] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.cvivit_losses import cvivit_generator_loss
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.training.optimizer import get_optimizer
from phenaki_tpu_torch.utils.metrics import psnr

DIRECTIONS = ["right", "left", "down", "up"]
DELTAS = {"right": (0, 2), "left": (0, -2), "down": (2, 0), "up": (-2, 0)}
SIZE = 16
FRAMES = 5
# one-hot "text" embeddings per direction word (standing in for T5: the
# point is the conditioning, not language)
TEXT_DIM = 16
SAMPLES_PER_DIRECTION = 8


def make_batch(rng: np.random.RandomState, batch: int):
    """(videos (b, 5, 16, 16, 3), direction indices (b,))."""
    vids = np.zeros((batch, FRAMES, SIZE, SIZE, 3), np.float32)
    dirs = rng.randint(0, 4, batch)
    for i in range(batch):
        dy, dx = DELTAS[DIRECTIONS[dirs[i]]]
        y, x = rng.randint(4, SIZE - 7, 2)
        color = 0.5 + 0.5 * rng.rand(3)
        for f in range(FRAMES):
            yy, xx = np.clip(y + dy * f, 0, SIZE - 3), np.clip(x + dx * f, 0, SIZE - 3)
            vids[i, f, yy:yy + 3, xx:xx + 3] = color
    return vids, dirs


def direction_of(video: np.ndarray) -> str:
    """The dominant motion of the brightest blob across the frames."""
    centers = []
    for frame in video:
        lum = frame.sum(-1)
        centers.append(np.unravel_index(np.argmax(lum), lum.shape))
    centers = np.asarray(centers, np.float32)
    dy, dx = (centers[-1] - centers[0]) / max(len(centers) - 1, 1)
    if abs(dx) >= abs(dy):
        return "right" if dx > 0 else "left"
    return "down" if dy > 0 else "up"


def embed_direction(dirs: np.ndarray) -> np.ndarray:
    emb = np.zeros((len(dirs), 4, TEXT_DIM), np.float32)
    for i, d in enumerate(dirs):
        emb[i, :, d] = 1.0
        emb[i, :, 8:] = 0.1  # rows stay non-zero, so the text mask covers them
    return emb


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps1", type=int, default=600, help="tokenizer steps")
    ap.add_argument("--steps2", type=int, default=800, help="maskgit steps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_moving_shapes_torch: no GPU (torch.cuda.is_available() is False); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng_np = np.random.RandomState(args.seed)
    gen = torch.Generator().manual_seed(args.seed)

    # ---- stage 1: the tokenizer ---- #
    cvivit = CViViT(dim=64, codebook_size=256, image_size=SIZE, patch_size=4, temporal_patch_size=2,
                    spatial_depth=2, temporal_depth=2, dim_head=32, heads=2)
    cvivit = init_parameters(cvivit, gen).to(device).train()
    opt = get_optimizer(cvivit.parameters(), lr=2e-3, wd=0.0, max_grad_norm=1.0)
    t0 = time.perf_counter()
    for step in range(args.steps1):
        videos, _ = make_batch(rng_np, args.batch)
        loss, aux = cvivit_generator_loss(cvivit, torch.from_numpy(videos).to(device), use_vgg_and_gan=False)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step % 200 == 0:
            print(f"[tok {step}] recon_loss={aux['recon_loss'].item():.4f}", flush=True)
    _sync(device)
    tok_seconds = time.perf_counter() - t0
    cvivit.eval()
    test_videos, _ = make_batch(rng_np, 32)
    test = torch.from_numpy(test_videos).to(device)
    with torch.no_grad():
        recon, _, _ = cvivit(test)
    p = psnr(recon.float().clamp(0.0, 1.0), test).item()
    print(f"tokenizer PSNR after {args.steps1} steps: {p:.2f} dB ({tok_seconds:.0f}s)", flush=True)

    # ---- stage 2: the MaskGit ---- #
    maskgit = MaskGit(dim=64, num_tokens=256, max_seq_len=cvivit.num_tokens_per_frames(FRAMES), depth=2,
                      heads=2, dim_head=32, dim_context=TEXT_DIM)
    maskgit = init_parameters(maskgit, gen).to(device)
    for p_ in cvivit.parameters():
        p_.requires_grad_(False)
    ph = Phenaki(maskgit=maskgit, cvivit=cvivit, steps=8, text_embed_dim=TEXT_DIM, max_text_len=4,
                 cond_drop_prob=0.25)
    opt2 = get_optimizer(maskgit.parameters(), lr=2e-3, wd=0.0, max_grad_norm=1.0)
    t0 = time.perf_counter()
    ce_first = ce = None
    for step in range(args.steps2):
        videos, dirs = make_batch(rng_np, args.batch)
        loss, _ = ph.loss(videos=torch.from_numpy(videos).to(device),
                          text_embeds=torch.from_numpy(embed_direction(dirs)).to(device), generator=gen)
        opt2.zero_grad(set_to_none=True)
        loss.backward()
        opt2.step()
        if step % 200 == 0:
            ce = loss.item()
            ce_first = ce if ce_first is None else ce_first
            print(f"[maskgit {step}] masked_ce={ce:.4f}", flush=True)
    ce_last = loss.item() if args.steps2 else None
    _sync(device)
    mg_seconds = time.perf_counter() - t0
    print(f"maskgit trained ({mg_seconds:.0f}s)", flush=True)

    # ---- stage 3: conditioned sampling ---- #
    maskgit.eval()
    correct = 0
    t0 = time.perf_counter()
    for d_idx, d in enumerate(DIRECTIONS):
        text = torch.from_numpy(embed_direction(np.full(SAMPLES_PER_DIRECTION, d_idx))).to(device)
        with torch.no_grad():
            vids = ph.sample(num_frames=FRAMES, text_embeds=text, cond_scale=3.0, generator=gen)
        vids = np.clip(vids.float().cpu().numpy(), 0.0, 1.0)
        got = [direction_of(v) for v in vids]
        hits = sum(g == d for g in got)
        correct += hits
        print(f"caption '{d}': sampled motions {got} ({hits}/{SAMPLES_PER_DIRECTION})", flush=True)
    _sync(device)
    sample_seconds = time.perf_counter() - t0

    total = SAMPLES_PER_DIRECTION * len(DIRECTIONS)
    acc = correct / total
    verdict = "PASS" if (p > 25.0 and acc > 0.5) else "WEAK"
    print(f"\ndirection accuracy: {correct}/{total} = {acc:.0%} (chance 25%)", flush=True)
    print(json.dumps({"device": str(device), "steps1": args.steps1, "steps2": args.steps2, "batch": args.batch,
                      "tokenizer_psnr_db": p, "masked_ce_first": ce_first, "masked_ce_last": ce_last,
                      "direction_accuracy": acc, "tokenizer_s": tok_seconds, "maskgit_s": mg_seconds,
                      "sampling_s": sample_seconds, "verdict": verdict}), flush=True)
    print("SYSTEM E2E:", verdict, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
