"""MaskGit iterative parallel decoding (counterpart of
phenaki_tpu/models/sampling_loop.py).

Per step: re-mask the k highest-scoring tokens, k = clip(round(n *
cos(pi/2 * step/steps)), 1, n) (step 0 masks everything); predict every
token and keep the prediction where masked; then score the tokens for the
next step's re-mask. Two ways to predict:

* `embeds_fn` + `vocab_proj` (the fast path, the one `Phenaki.sample` takes):
  CFG-combined final-norm embeddings go through `project_sample`, which
  fuses the vocab projection into the sampler on the card;
* `logits_fn` (the TPU loop's public logits path): (b, n, V) logits, or with
  `stacked_cfg_scale` the stacked (2b, n, V) cond/null logits of
  `MaskGit.forward_with_cond_scale(combine=False)`, go through
  `gumbel_sample_with_score`, which fuses the CFG combine.

Without a critic a token's score is 1 - p(chosen) where it was re-masked,
-1e4 elsewhere. With `critic_fn` the score is the critic's logit plus
`noise_K * (u - 0.5) * mult`, mult per `critic_noise_anneal_schedule`
(`critic_noise_multiplier`), with no -1e4 masking; the last step runs no
critic and leaves zeros. Random draws, in this order each step, all from
the CPU `generator`: the sampler's (a seed on the card, the (b, n, V)
uniforms on the CPU), then, on a step that runs the critic, the critic
noise's (b, n) uniforms. The loop never reads a device value on the host:
k, the temperature and the multiplier are Python numbers.

`prime_ids` (b, P), the tokens of the frames a scene continues, go in front
of the scene's n ids before every forward (the MaskGit's and the critic's);
their outputs are sliced back to the scene's n rows (`h[:, P:]`: at b = 1
a contiguous view the projection sampler reads in place, at b > 1 strided
rows it copies) and only those n positions are masked, sampled and scored.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from phenaki_tpu_torch.ops.fused_sampling import gumbel_sample_with_score, project_sample
from phenaki_tpu_torch.ops.sampling import cosine_schedule, topk_mask, uniform
from phenaki_tpu_torch.utils.logging import span

NEG_SCORE = -1e4
ANNEAL_SCHEDULES = ("fixed", "decay", "increase")


def remask_count(step: int, steps: int, n: int) -> int:
    """Tokens re-masked at `step`: clip(round(n * cos(pi/2 * step/steps)), 1, n)."""
    frac = cosine_schedule(np.float32(step) / np.float32(steps))
    return int(np.clip(np.round(np.float32(n) * frac), 1, n))


def critic_noise_multiplier(schedule: str, step: int, steps: int) -> np.float32:
    """The critic noise's scale at `step`, in f32 as the TPU loop computes it:
    1 (fixed), (steps - step - 1) / steps (decay), (step + 1) / steps
    (increase)."""
    if schedule == "fixed":
        return np.float32(1.0)
    if schedule == "decay":
        return np.float32(steps - step - 1) / np.float32(steps)
    if schedule == "increase":
        return np.float32(step + 1) / np.float32(steps)
    raise ValueError(f"invalid critic noise anneal schedule {schedule!r}")


def maskgit_sample_loop(
    logits_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    batch: int,
    num_tokens_seq: int,
    mask_id: int,
    device,
    steps: int = 18,
    starting_temperature: float = 0.9,
    generator: Optional[torch.Generator] = None,
    critic_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    noise_K: float = 1.0,
    critic_noise_anneal_schedule: str = "decay",
    stacked_cfg_scale: Optional[float] = None,
    embeds_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    vocab_proj: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    prime_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the decode; returns the final token ids (b, num_tokens_seq) int64.

    `embeds_fn(ids)` maps (b, n) ids to (b, n, dim) CFG-combined final-norm
    embeddings and needs `vocab_proj` = (weight (V, dim), bias (V,) or None);
    when given, `logits_fn` and `stacked_cfg_scale` are ignored.
    `logits_fn(ids)` maps them to (b, n, V) logits, or to the stacked
    (2b, n, V) cond/null logits when `stacked_cfg_scale` is set.
    `critic_fn(ids)` maps them to (b, n) critic logits. With `prime_ids`
    (b, P) each function takes (b, P + n) ids and gives P + n rows."""
    if embeds_fn is not None and vocab_proj is None:
        raise ValueError("embeds_fn requires vocab_proj=(weight, bias)")
    if embeds_fn is None and logits_fn is None:
        raise ValueError("give logits_fn or embeds_fn")
    if critic_noise_anneal_schedule not in ANNEAL_SCHEDULES:
        raise ValueError(f"invalid critic noise anneal schedule {critic_noise_anneal_schedule!r}")
    n = num_tokens_seq
    prime_len = prime_ids.shape[-1] if prime_ids is not None else 0

    def primed(fn, ids):
        """`fn` over the prime ids and `ids`, sliced to the scene's rows."""
        if not prime_len:
            return fn(ids)
        return fn(torch.cat([prime_ids.to(ids), ids], dim=-1))[:, prime_len:]

    ids = torch.full((batch, n), mask_id, dtype=torch.long, device=device)
    scores = torch.zeros((batch, n), dtype=torch.float32, device=device)
    for step in range(steps):
        with span("phenaki.decode_step"):
            with span("phenaki.remask"):
                remask = topk_mask(scores, remask_count(step, steps, n))
                if step == 0:
                    remask = torch.ones_like(remask)
                ids = torch.where(remask, mask_id, ids)
            temperature = starting_temperature * (steps - step - 1) / steps
            with span("phenaki.maskgit_forward"):
                out = primed(embeds_fn if embeds_fn is not None else logits_fn, ids)
            with span("phenaki.pick_tokens"):
                if embeds_fn is not None:
                    weight, bias = vocab_proj
                    pred_ids, pred_scores = project_sample(out, weight, bias, temperature, generator=generator)
                else:
                    pred_ids, pred_scores = gumbel_sample_with_score(
                        out, temperature, cond_scale=stacked_cfg_scale, generator=generator)
                del out  # the embeddings or logits go before the next forward
                ids = torch.where(remask, pred_ids, ids)
                if critic_fn is None:
                    scores = torch.where(remask, pred_scores, NEG_SCORE)
            if critic_fn is not None and step < steps - 1:
                with span("phenaki.critic_forward"):
                    critic = primed(critic_fn, ids).float()
                mult = float(critic_noise_multiplier(critic_noise_anneal_schedule, step, steps))
                with span("phenaki.critic_noise"):
                    scores = critic + noise_K * (uniform(critic.shape, generator, device) - 0.5) * mult
            elif critic_fn is not None:
                scores = torch.zeros((batch, n), dtype=torch.float32, device=device)
    return ids
