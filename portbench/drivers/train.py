"""Training the MaskGit on token ids: `PhenakiTrainer.train_step()` back to
back at `batch` clips a step, f32 parameters computing in bf16, Adam, with
the trainer's own loader (worker processes, pinned batches) over a seeded
dataset of token ids over the whole vocabulary and T5-base-width text
embeddings.

Set-up builds one trainer and drives it through its first three steps, the
same calls and feed the window uses; step 1 is the trainer's milestone (a
sample of `milestone_clips` clips and a checkpoint under the run's TMPDIR).
Those steps give the comparison its readings: each step's loss, the first
gradient as Adam got it (its first moment after step 1 over 1 - beta1) and
the parameters' change after step 3, read before step 4 moves them. The
window then runs steps until `--seconds` have passed and synchronises:
`train_tokens_per_s` is every token of every step started in the window over
that time; `train_peak_mem_gb` the allocator's peak over the window, reset
at its start. After the window the reference trains the same three steps
from the same weights, batches and random draws (the trainer's documented
order: its loader shuffles with `random.Random(seed + 1)`, its generator
draws each step's mask steps, mask uniforms and text dropout, and one seed
for the milestone after step 1)."""

from __future__ import annotations

import gc
import math
import multiprocessing
import random
import time

import numpy as np

from portbench import build, checks, inputs
from portbench.common import GB, Outcome, device_record, metric, subseed, sync
from portbench.drivers.common import (Clock, Ctx, device_trace_record, free_program, limits_checks,
                                      per_layer, scratch_cleanup, setup_torch)
from portbench.trace import Profiler

WEIGHTS, TRAINER = 1, 2
READ_STEPS = 3


class Clips:
    """A dataset of (token ids (t, h, w), text embeddings (L, d)) items."""

    def __init__(self, ids: np.ndarray, emb: np.ndarray):
        self.ids, self.emb = ids, emb

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def run(spec) -> Outcome:
    torch = setup_torch(spec)
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    clock = Clock(spec)
    phases = {"torch_and_kernels": clock.since_start()}
    t, cfg, dev = spec.traffic, spec.config, spec.device
    s, m = cfg["sampling"], cfg["maskgit"]
    b = t["batch"]
    n, grid = build.num_tokens(cfg)
    wseed = subseed(spec.seed, WEIGHTS)
    trainer_seed = subseed(spec.seed, TRAINER) % 2**31
    ph, layout, dtypes = build.build(cfg, wseed, dev, "train")
    phases["model"] = clock.since_start()
    ph.cond_drop_prob = t["cond_drop_prob"]
    ids = inputs.token_ids(spec.seed, (t["dataset_clips"], *grid), m["num_tokens"], dev).cpu().numpy()
    emb = inputs.text_embeds(spec.seed, t["dataset_clips"], text_dim=s["text_dim"], max_text_len=s["max_text_len"],
                             text_len=t["text_len"], device=dev).cpu().numpy()
    scratch = spec.scratch()
    trainer = PhenakiTrainer(ph, dataset=Clips(ids, emb), batch_size=b, num_frames=s["num_frames"],
                             train_lr=t["lr"], adam_betas=tuple(t["betas"]), sample_texts=t["sample_texts"],
                             num_samples=t["milestone_clips"], save_and_sample_every=10**9,
                             results_folder=str(scratch / "results"), clear_previous_results=True,
                             seed=trainer_seed, log_every=10**9)
    params = dict(ph.maskgit.named_parameters())
    beta1 = t["betas"][0]
    losses, grad = [], {}
    for step in range(READ_STEPS):
        losses.append(float(trainer.train_step()))
        if step == 0:  # a parameter Adam holds no state of has not moved
            grad = {k: float(trainer.opt.state.get(p, {}).get("exp_avg", torch.zeros(())).norm()) / (1 - beta1)
                    for k, p in params.items()}
    from portbench import weights

    w0 = weights.make(layout, wseed, dev, dtypes)
    change = {k: float((p.detach() - w0[f"maskgit.{k}"]).norm()) for k, p in params.items()}
    del w0, params
    profiler = Profiler(scratch, t["profile_steps"], cuda=dev == "cuda") if spec.trace else None
    if profiler:
        profiler.warm(lambda: sync(torch, dev))
    sync(torch, dev)
    setup_s = clock.since_start()
    phases["warm"] = setup_s

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < spec.seconds:
        if profiler is None:
            trainer.train_step()
        else:
            profiler.run(trainer.train_step, time.perf_counter() - t0, spec.seconds, lambda: sync(torch, dev))
        steps += 1
    sync(torch, dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    trace = profiler.read() if profiler else None
    ctx = Ctx(cfg, t, trace, steps=profiler.calls if profiler else 0,
              wall_s=profiler.wall if profiler else 0.0, batch=b)
    e2e = {"train_tokens_per_s": metric(steps * b * n / window, "tokens/s"),
           "train_peak_mem_gb": metric(peak / GB, "GB"), "setup_s": metric(setup_s, "s")}
    metrics = per_layer(spec, ctx) if spec.trace else e2e

    stop_loader(trainer)
    del trainer, ph
    free_program(torch, dev)
    prog = {"losses": losses, "grad": grad, "change": change}
    numbers, control, worst = judge(torch, spec, layout, dtypes, wseed, trainer_seed, ids, emb, prog)
    scratch_cleanup(scratch)
    device = device_record(torch, dev, spec.chips, peak)
    if spec.trace:
        device.update(device_trace_record(trace) or {})
    notes = {"setup_phases_s": phases, "steps": steps, "losses": losses, "numbers": numbers,
             "worst_leaves": worst}
    if control is not None:
        notes["control"] = control
    return Outcome(attempted=steps, failed=0, metrics=metrics, checks=limits_checks(numbers, t["limits"]),
                   device=device, breakdown=trace.breakdown() if trace and trace.calls else None, notes=notes)


def stop_loader(trainer) -> None:
    """End the trainer's loader workers and wait for them."""
    trainer.dl = None
    gc.collect()
    for child in multiprocessing.active_children():
        child.join(timeout=30)
        if child.is_alive():
            child.terminate()
            child.join(timeout=10)


def reference_run(torch, spec, W, trainer_seed, ids, emb, *, cast, half_batch: bool = False,
                  adam_steps: bool = True) -> dict:
    """The reference's three steps: {"losses", "grad" (step 1's, by leaf),
    "change" (after step 3, by leaf)}; `half_batch` leaves out the second
    half of every batch and takes the mean over the rest (a fault)."""
    from portbench.reference import phenaki_ref as R

    t, cfg, dev = spec.traffic, spec.config, spec.device
    b, steps = t["batch"], cfg["sampling"]["steps"]
    n, grid = build.num_tokens(cfg)
    names = [k for k in W if k.startswith("maskgit.")]
    params = {k: W[k].float().clone().requires_grad_(True) for k in names}
    start = {k: v.detach().clone() for k, v in params.items()}
    adam = R.Adam(params, t["lr"], tuple(t["betas"]), 1e-8)
    order = list(range(len(ids)))
    random.Random(trainer_seed + 1).shuffle(order)  # the trainer's loader, epoch 0
    gen = torch.Generator().manual_seed(trainer_seed)
    losses, grad = [], {}
    rows_used = b // 2 if half_batch else b
    for step in range(READ_STEPS):
        rows = order[step * b:(step + 1) * b]
        rand_step = torch.randint(0, steps, (b,), generator=gen).to(dev)
        noise = torch.rand((b, n), generator=gen).to(dev)
        keep = (torch.rand((b,), generator=gen) < 1.0 - t["cond_drop_prob"]).to(dev)
        if step == 0:
            torch.randint(0, 2**62, (), generator=gen)  # the milestone's sample seed
        mask_prob = torch.cos(rand_step.float() * math.pi * 0.5 / steps)
        k = torch.round(mask_prob * float(n)).clamp_min(1.0)
        rank = torch.argsort(torch.argsort(noise, dim=-1, stable=True), dim=-1)
        masked = (rank < k[:, None])[:rows_used]
        x = torch.as_tensor(ids[rows]).to(dev).reshape(b, -1)[:rows_used]
        e = torch.as_tensor(emb[rows]).to(dev)[:rows_used]
        count = float(masked.sum())
        total = 0.0
        for c in range(0, rows_used, t["reference_block"]):
            sl = slice(c, c + t["reference_block"])
            loss = R.masked_token_loss(params, cfg["maskgit"], x[sl], grid, e[sl], masked[sl], keep[sl],
                                       count, cast)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
        if step == 0:
            grad = {k[len("maskgit."):]: float(g.norm()) for k, g in grads.items()}
        if adam_steps:
            adam.step(params, grads)
        for p in params.values():
            p.grad = None
    change = {k[len("maskgit."):]: float((params[k].detach() - start[k]).norm()) for k in names}
    return {"losses": losses, "grad": grad, "change": change}


def judge(torch, spec, layout, dtypes, wseed, trainer_seed, ids, emb, prog):
    from portbench import weights
    from portbench.reference import phenaki_ref as R

    R.exact_float32()
    W = weights.make(layout, wseed, spec.device, dtypes)
    ref = reference_run(torch, spec, W, trainer_seed, ids, emb, cast=R.identity)
    numbers = checks.train_numbers(prog, ref)
    control = None
    if spec.control:
        control = {
            "fp8": checks.train_numbers(reference_run(torch, spec, W, trainer_seed, ids, emb, cast=R.fp8_cast), ref),
            "half_batch": checks.train_numbers(
                reference_run(torch, spec, W, trainer_seed, ids, emb, cast=R.identity, half_batch=True), ref),
            "state_unchanged": checks.train_numbers(
                reference_run(torch, spec, W, trainer_seed, ids, emb, cast=R.identity, adam_steps=False), ref),
            "reference_ranks": {"grad_min": min(ref["grad"].values()),
                                "grad_median": float(np.median(list(ref["grad"].values())))},
        }
    return numbers, control, checks.worst_leaves(prog, ref)
