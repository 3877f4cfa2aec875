"""The comparison that decides `correct`: what the timed path produced,
judged by the float32 reference (`reference/phenaki_ref.py`) on the
benchmark's own weights and inputs.

Sampling (the sample and serve cells), for each kept call or launch:

* `pick_gap`: the widest gap, in logits, by which a token that the final,
  greedy decode step picked lies below the reference's best logit at that
  position, the reference run once over the step's input ids with the
  row's own text under classifier-free guidance (the MaskGit trunk with its
  position bias, cross-attention, GEGLU and PEG; the vocab head; kernel 2's
  pick);
* `kept_ids`: positions that step did not re-mask whose id changed (exact);
* `bad_ids`: picks outside the vocabulary (exact);
* `critic_err` (with a critic): the largest error of the critic's logits at
  the kept steps, over the reference's largest logit;
* `frame_err`: the decoded frames of the final ids against the reference's
  decode, the largest error over the reference's largest pixel; for uint8
  delivery `frame_levels`, the largest difference in levels after the
  server's quantisation.

Training: `loss_gap` (the largest relative gap of the first steps' losses),
`grad_gap` (the first gradient, from Adam's first moment after step 1) and
`change_gap` (the parameters' change after three steps), each the largest
gap of a leaf's norm against the reference's, over the larger of that
leaf's reference norm and the median leaf's. The change leaves out leaves
whose reference gradient is under a thousandth of the median leaf's.

The control (`control=True`, for setting limits, never in a benchmark run)
puts the reference computed in float8 in the program's place and reads the
same numbers."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference import phenaki_ref as R


def _stack_text(emb):
    return torch.cat([emb, emb]), torch.cat([R.text_mask_of(emb), torch.zeros_like(R.text_mask_of(emb))])


@torch.no_grad()
def guided_logits(W, config, ids, emb, cast, bias, block: int):
    """(b, n, V) float32 logits of the guided embeddings, in blocks of rows."""
    m, scale = config["maskgit"], config["_cond_scale"]
    grid = config["_grid"]
    out = []
    for s in range(0, ids.shape[0], block):
        x, e = ids[s:s + block], emb[s:s + block]
        ctx, tm = _stack_text(e)
        h = R.maskgit_embeds(W, m, torch.cat([x, x]), grid, ctx, tm, cast, bias=bias)
        cond, null = h.chunk(2)
        out.append(R.vocab_logits(W, R.guided(cond, null, scale), cast))
    return torch.cat(out)


@torch.no_grad()
def critic_stacked(W, config, ids2, emb, cast, block: int):
    """The critic's (2b, n) logits of the stacked ids (conditioned rows
    first), in blocks of clips."""
    b = emb.shape[0]
    cond, null = [], []
    for s in range(0, b, block):
        e = emb[s:s + block]
        x = torch.cat([ids2[s:s + len(e)], ids2[b + s:b + s + len(e)]])
        ctx, tm = _stack_text(e)
        c, nl = R.critic_logits(W, config["critic"], x, config["_grid"], ctx, tm, cast).chunk(2)
        cond.append(c)
        null.append(nl)
    return torch.cat(cond + null)


@torch.no_grad()
def sample_numbers(W, config, rec, emb, *, uint8: Optional[torch.Tensor] = None, control: bool = False,
                   critic_steps: Sequence[int] = (), block: int = 4) -> Dict[str, float]:
    """The numbers of one kept call or launch. `rec` holds the program's step
    inputs and final codes (`recorder.CallRecord`), `emb` (b, L, d) the
    rows' own text, `uint8` the delivered videos of the first rows (else
    `rec.video`)."""
    cast = R.fp8_cast if control else R.identity
    V, mask_id = config["maskgit"]["num_tokens"], config["maskgit"]["num_tokens"]
    b = emb.shape[0]
    x_last = rec.last_input[:b].long()
    final = rec.final_ids()
    masked = x_last == mask_id
    bias = R.position_bias(W, "maskgit.continuous_pos_bias.", config["_grid"])
    ref = guided_logits(W, config, x_last, emb, R.identity, bias, block)
    best = ref.amax(-1)
    if control:
        picks = guided_logits(W, config, x_last, emb, cast, bias, block).argmax(-1)
    else:
        picks = final.clamp(0, V - 1)
    gap = (best - ref.gather(-1, picks[..., None])[..., 0])[masked]
    out = {"pick_gap": float(gap.max()) if gap.numel() else float("inf"),
           "kept_ids": float((final[~masked] != x_last[~masked]).sum()),
           "bad_ids": float(((final < 0) | (final >= V)).sum())}
    del ref
    if config.get("critic"):
        errs = []
        for s in critic_steps:
            ids2, got = rec.critic_io[s]
            want = critic_stacked(W, config, ids2.long(), emb, R.identity, block)
            if control:
                got = critic_stacked(W, config, ids2.long(), emb, cast, block)
            errs.append(float((got.float() - want).abs().max() / want.abs().max()))
        out["critic_err"] = max(errs)
    video = R.cvivit_decode(W, config["cvivit"], final.clamp(0, V - 1))
    got = R.cvivit_decode(W, config["cvivit"], final.clamp(0, V - 1), cast) if control else None
    if uint8 is None:
        got = rec.video if got is None else got
        out["frame_err"] = float((got.float() - video).abs().max() / video.abs().max())
    else:  # the delivered rows come first; a bucket's padding rows deliver nothing
        real = uint8.shape[0]
        got = uint8.float() if got is None else R.to_uint8(got[:real])
        out["frame_levels"] = float((got - R.to_uint8(video[:real])).abs().max())
    return out


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest value of each number over the kept calls."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> Dict[str, float]:
    """|prog - ref| / max(ref, the median leaf's ref), by leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> Dict[str, list]:
    """The leaves that read the largest gaps (notes, not checks)."""
    out = {}
    for key, leaves in (("grad", list(ref["grad"])), ("change", moving_leaves(ref["grad"]))):
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        out[key] = [[k, gaps[k], ref[key][k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:top]]
    return out


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by rounding alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    leaves = list(ref["grad"])
    return {"loss_gap": max(losses),
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"], leaves).values()),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["grad"])).values())}
