"""MaskGit iterative parallel decoding (counterpart of
phenaki_tpu/models/sampling_loop.py, the `embeds_fn` + `vocab_proj` path).

Per step: re-mask the k highest-scoring tokens, k = clip(round(n *
cos(pi/2 * step/steps)), 1, n) (step 0 masks everything); run the
CFG-combined MaskGit forward to final-norm embeddings; project onto the
vocab and sample with the fused kernel; keep the new ids where masked, and
score them 1 - p(chosen) (unmasked tokens score -1e4). The loop never reads
a device value on the host: k and the temperature are Python numbers and the
kernel seeds come from a CPU generator.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from phenaki_tpu_torch.ops.fused_sampling import (
    can_fuse_projection,
    project_sample,
    project_sample_plain,
)
from phenaki_tpu_torch.ops.sampling import cosine_schedule, topk_mask

NEG_SCORE = -1e4


def remask_count(step: int, steps: int, n: int) -> int:
    """Tokens re-masked at `step`: clip(round(n * cos(pi/2 * step/steps)), 1, n)."""
    frac = cosine_schedule(np.float32(step) / np.float32(steps))
    return int(np.clip(np.round(np.float32(n) * frac), 1, n))


def maskgit_sample_loop(
    embeds_fn: Callable[[torch.Tensor], torch.Tensor],
    vocab_proj: Tuple[torch.Tensor, Optional[torch.Tensor]],
    *,
    batch: int,
    num_tokens_seq: int,
    mask_id: int,
    device,
    steps: int = 18,
    starting_temperature: float = 0.9,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Run the decode; returns the final token ids (b, num_tokens_seq) int64.

    `embeds_fn(ids)` maps (b, n) ids to (b, n, dim) CFG-combined final-norm
    embeddings; `vocab_proj` = (weight (V, dim), bias (V,) or None)."""
    n = num_tokens_seq
    weight, bias = vocab_proj
    sample = project_sample if can_fuse_projection(weight.shape[1], weight.shape[0]) else project_sample_plain
    ids = torch.full((batch, n), mask_id, dtype=torch.long, device=device)
    scores = torch.zeros((batch, n), dtype=torch.float32, device=device)
    for step in range(steps):
        remask = topk_mask(scores, remask_count(step, steps, n))
        if step == 0:
            remask = torch.ones_like(remask)
        ids = torch.where(remask, mask_id, ids)
        temperature = starting_temperature * (steps - step - 1) / steps
        h = embeds_fn(ids)
        pred_ids, pred_scores = sample(h, weight, bias, temperature, generator=generator)
        ids = torch.where(remask, pred_ids, ids)
        scores = torch.where(remask, pred_scores, NEG_SCORE)
    return ids
