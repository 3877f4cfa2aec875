"""Offline batch generation: a closed loop of back-to-back
`Phenaki.sample(num_frames=, text_embeds=, cond_scale=, generator=)` calls
of `batch` clips, each call synchronised before the next starts.

Set-up builds the model with the benchmark's weights, makes a pool of
`prompts` seeded text embeddings and runs `warmup_calls` calls of the same
shape. The window runs calls until `--seconds` have passed; `frames_per_s`
is every frame of every call started in the window over the time until the
last of them finished. `check_calls` calls, drawn from the seed among the
window's first `check_among_first`, are kept (`recorder`) and judged by the
reference once the window has closed and the program is freed. A traced run
profiles `profile_calls` whole calls from the middle of the window on."""

from __future__ import annotations

import time

from portbench import build, checks, inputs
from portbench.common import Outcome, device_record, metric, subseed, sync
from portbench.drivers.common import (Clock, Ctx, device_trace_record, free_program, limits_checks,
                                      peak_bytes, per_layer, scratch_cleanup, setup_torch)
from portbench.recorder import Recorder
from portbench.trace import Profiler

WEIGHTS, CALL_SEED, CHECKED, CRITIC_STEPS = 1, 2, 3, 4


def run(spec) -> Outcome:
    torch = setup_torch(spec)
    clock = Clock(spec)
    phases = {"torch_and_kernels": clock.since_start()}
    t, cfg, dev = spec.traffic, spec.config, spec.device
    s = cfg["sampling"]
    b, frames = t["batch"], s["num_frames"]
    wseed = subseed(spec.seed, WEIGHTS)
    ph, layout, dtypes = build.build(cfg, wseed, dev, "sample")
    phases["model"] = clock.since_start()
    pool = inputs.text_embeds(spec.seed, t["prompts"], text_dim=s["text_dim"],
                              max_text_len=s["max_text_len"], text_len=t["text_len"], device=dev)

    def call(i):
        rows = inputs.call_rows(spec.seed, i, b, t["prompts"])
        gen = torch.Generator().manual_seed(subseed(spec.seed, CALL_SEED, i % 2**32))
        video = ph.sample(num_frames=frames, text_embeds=pool[rows], cond_scale=t["cond_scale"],
                          starting_temperature=t["starting_temperature"], generator=gen)
        return rows, video

    for w in range(t["warmup_calls"]):
        call(2**32 - 1 - w)
        sync(torch, dev)
    profiler = Profiler(spec.scratch(), t["profile_calls"], cuda=dev == "cuda") if spec.trace else None
    if profiler:
        profiler.warm(lambda: sync(torch, dev))
    setup_s = clock.since_start()
    phases["warm"] = setup_s

    checked = set(inputs.permutation(subseed(spec.seed, CHECKED), t["check_among_first"])[:t["check_calls"]])
    recorder = Recorder(ph)
    records = []
    done = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < spec.seconds:
        keep = done in checked
        if keep:
            recorder.arm()
        if profiler is None:
            rows, video = call(done)
            sync(torch, dev)
        else:
            rows, video = profiler.run(lambda: call(done), time.perf_counter() - t0, spec.seconds,
                                   lambda: sync(torch, dev))
        if keep:
            recorder.disarm()
            rec = recorder.take()
            rec.video = video
            records.append((rows, rec))
        done += 1
    window = time.perf_counter() - t0
    peak = peak_bytes(torch, dev)

    trace = profiler.read() if profiler else None
    ctx = Ctx(cfg, t, trace, calls=profiler.calls if profiler else 0,
              clips=profiler.calls * b if profiler else 0, wall_s=profiler.wall if profiler else 0.0, batch=b)
    e2e = {"frames_per_s": metric(done * b * frames / window, "frames/s"), "setup_s": metric(setup_s, "s")}
    metrics = per_layer(spec, ctx) if spec.trace else e2e

    # the program's state goes before the reference runs
    del ph, recorder
    free_program(torch, dev)
    numbers, control = judge(torch, spec, layout, dtypes, wseed, records, pool)
    scratch_cleanup(spec.scratch())
    device = device_record(torch, dev, spec.chips, peak)
    if spec.trace:
        device.update(device_trace_record(trace) or {})
    notes = {"setup_phases_s": phases, "calls": done, "kept_calls": sorted(checked), "numbers": numbers}
    if control is not None:
        notes["control"] = {"fp8": control}
    return Outcome(attempted=done * b, failed=0, metrics=metrics,
                   checks=limits_checks(numbers, t["limits"]) if numbers else [],
                   device=device, breakdown=trace.breakdown() if trace and trace.calls else None,
                   notes=notes)


def judge(torch, spec, layout, dtypes, wseed, records, pool):
    """The reference's numbers over the kept calls (and the control's)."""
    from portbench import weights
    from portbench.reference import phenaki_ref as R

    if not records:
        return {}, None
    R.exact_float32()
    cfg = dict(spec.config, _cond_scale=spec.traffic["cond_scale"], _grid=build.num_tokens(spec.config)[1])
    W = weights.make(layout, wseed, spec.device, dtypes)
    steps = cfg["sampling"]["steps"]
    critic_steps = inputs.permutation(subseed(spec.seed, CRITIC_STEPS), steps - 1)[:spec.traffic.get("critic_check_steps", 0)]
    got, ctl = [], []
    for rows, rec in records:
        emb = pool[rows]
        got.append(checks.sample_numbers(W, cfg, rec, emb, critic_steps=critic_steps))
        if spec.control:
            ctl.append(checks.sample_numbers(W, cfg, rec, emb, critic_steps=critic_steps, control=True))
    return checks.worst(got), (checks.worst(ctl) if ctl else None)
