"""Serving independent users: an open loop of `PhenakiServer.submit(
text_embeds=)` requests, one clip each, at a fixed Poisson rate, through the
server at its own defaults (buckets, coalescing delay, uint8 delivery,
sampling settings).

Set-up builds the model with the benchmark's weights, starts the server and
runs its `prewarm` (one launch a bucket). The window offers round(rate x
seconds) requests due at seeded times (`inputs.arrivals`), each a client's
own text of a seeded length; the generator thread sleeps until a request is
due and submits it. A request is timed from when it was due until its future
has resolved to a host array; one that fails or never resolves counts as
missing (an infinite latency). `clip_latency_p95_s` is over all requests of
the window. Afterwards `check_requests` requests drawn from the seed are
judged with every row of their launches, padding rows included: the picks
of the final step and the delivered uint8 videos against the reference.
A traced run profiles from the middle of the window until `profile_launches`
more launches have been made."""

from __future__ import annotations

import time

from portbench import build, checks, inputs
from portbench.common import Outcome, device_record, metric, percentile, subseed, sync
from portbench.drivers.common import (Clock, Ctx, device_trace_record, free_program, limits_checks,
                                      peak_bytes, per_layer, scratch_cleanup, setup_torch)
from portbench.recorder import Recorder
from portbench.trace import Profiler

WEIGHTS, SERVER, CHECKED = 1, 2, 3
LATE_S = 60.0  # how long past the window's close a request may still resolve


def run(spec) -> Outcome:
    torch = setup_torch(spec)
    from phenaki_tpu_torch.serving import PhenakiServer

    clock = Clock(spec)
    phases = {"torch_and_kernels": clock.since_start()}
    t, cfg, dev = spec.traffic, spec.config, spec.device
    s = cfg["sampling"]
    wseed = subseed(spec.seed, WEIGHTS)
    ph, layout, dtypes = build.build(cfg, wseed, dev, "sample")
    phases["model"] = clock.since_start()
    due = inputs.arrivals(spec.seed, t["rate"], spec.seconds)
    count = len(due)
    pool = inputs.text_embeds(spec.seed, count, text_dim=s["text_dim"], max_text_len=s["max_text_len"],
                              text_len=t["text_len"], device=dev)
    lengths = (pool != 0).any(-1).sum(-1).tolist()
    host = pool.cpu().numpy()
    client = [host[i, :lengths[i]] for i in range(count)]  # a client sends its own tokens
    server = PhenakiServer(ph, num_frames=s["num_frames"], seed=subseed(spec.seed, SERVER) % 2**63)
    server.prewarm()
    recorder = Recorder(ph)
    recorder.arm()
    prof = Profiling(spec.scratch(), t["profile_launches"], server, lambda: sync(torch, dev),
                     cuda=dev == "cuda") if spec.trace else None
    if prof:
        prof.profiler.warm(lambda: sync(torch, dev))
    sync(torch, dev)
    setup_s = clock.since_start()
    phases["warm"] = setup_s

    offered = open_loop(server, due, client, spec.seconds, prof)
    recorder.disarm()
    log = server.launch_log
    cond_scale = server.cond_scale
    server.close()
    peak = peak_bytes(torch, dev)

    latency, lag_ms, results, shed = offered
    failed = sum(1 for r in results if r is None)
    trace = prof.read() if prof else None
    ctx = Ctx(cfg, t, trace, launch_log=log, latency_s=latency, lag_ms=lag_ms, launches=prof.made if prof else 0)
    e2e = {"clip_latency_p95_s": metric(percentile(latency, 95), "s"), "setup_s": metric(setup_s, "s")}
    metrics = per_layer(spec, ctx) if spec.trace else e2e

    launches = recorder.launches
    del ph, recorder, server
    free_program(torch, dev)
    admitted = [i for i in range(count) if not shed[i]]
    numbers, control, kept = judge(torch, spec, layout, dtypes, wseed, pool, results, log, launches, admitted,
                                   cond_scale)
    scratch_cleanup(spec.scratch())
    device = device_record(torch, dev, spec.chips, peak)
    if spec.trace:
        device.update(device_trace_record(trace) or {})
    notes = {"setup_phases_s": phases, "requests": count, "launches": len(log), "launch_log_buckets": bucket_counts(log),
             "kept_requests": kept, "numbers": numbers}
    if control is not None:
        notes["control"] = {"fp8": control}
    return Outcome(attempted=count, failed=failed, metrics=metrics,
                   checks=limits_checks(numbers, t["limits"]) if numbers else [],
                   device=device, breakdown=trace.breakdown() if trace and trace.calls else None, notes=notes)


class Profiling:
    """The traced run's stretch, counted in the server's launches: from the
    middle of the window until `launches` launches have been made, inside
    one `portbench.call` range on the generator's thread (`trace.Profiler`)."""

    def __init__(self, scratch, launches: int, server, sync, cuda: bool = True):
        self.profiler = Profiler(scratch, 1, cuda=cuda)
        self.n, self.server, self.sync = launches, server, sync
        self.made = 0

    def _log(self) -> int:
        return len(self.server.launch_log)

    def before(self, due: float, seconds: float) -> None:
        if self.profiler.state == "waiting" and due >= seconds / 2:
            self.profiler.start()
            self.range = self.profiler.call()
            self.range.__enter__()
            self.l0 = self._log()

    def after(self, final: bool = False) -> None:
        if self.profiler.state == "on" and (final or self._log() - self.l0 >= self.n):
            self.sync()
            self.range.__exit__(None, None, None)
            self.profiler.stop()
            self.made = self._log() - self.l0

    def read(self):
        self.after(final=True)
        return self.profiler.read()


def open_loop(server, due, client, seconds: float, prof=None):
    """Submit client[i] at its due time (s after the start); wait for every
    future until LATE_S past the window. Returns (latency s, generator lag
    ms, result or None, refused at admission) a request; a request that
    failed or did not resolve has an infinite latency."""
    count = len(due)
    done_at = [None] * count
    submitted_at = [0.0] * count
    shed = [False] * count
    futures = []
    t0 = time.perf_counter()
    for i in range(count):
        if prof:
            prof.before(due[i], seconds)
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        submitted_at[i] = time.perf_counter()
        fut = server.submit(text_embeds=client[i])
        shed[i] = fut.done()  # refused at admission: the queue was full
        fut.add_done_callback(lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
        futures.append(fut)
        if prof:
            prof.after()
    results = wait_all(futures, t0 + seconds + LATE_S)
    if prof:
        prof.after(final=True)
    latency = [(d - (t0 + due[i])) if (d is not None and results[i] is not None) else float("inf")
               for i, d in enumerate(done_at)]
    lag_ms = [(submitted_at[i] - (t0 + due[i])) * 1e3 for i in range(count)]
    return latency, lag_ms, results, shed


def wait_all(futures, deadline: float):
    """Each future's result, or None where it failed or did not resolve by
    `deadline` (host clock)."""
    out = []
    for f in futures:
        try:
            out.append(f.result(timeout=max(0.0, deadline - time.perf_counter())))
        except Exception:  # noqa: BLE001 - a failed or late request is a missing one
            out.append(None)
    return out


def bucket_counts(log) -> dict:
    counts: dict = {}
    for _, bucket in log:
        counts[str(bucket)] = counts.get(str(bucket), 0) + 1
    return counts


def launch_rows(log, admitted):
    """The server's launches in order, each (the request of every row, the
    real rows): the dispatcher takes admitted requests first in, first out,
    and pads a bucket with copies of its last request."""
    rows, at = [], 0
    for n, bucket in log:
        take = admitted[at:at + n]
        at += n
        rows.append((take + [take[-1]] * (bucket - n), n))
    return rows


def judge(torch, spec, layout, dtypes, wseed, pool, results, log, launches, admitted, cond_scale):
    from portbench import weights
    from portbench.reference import phenaki_ref as R

    if len(log) != len(launches) or sum(n for n, _ in log) != len(admitted):
        return {"launch_records": float("inf")}, None, []
    rows = launch_rows(log, admitted)
    finished = [i for i, r in enumerate(results) if r is not None]
    if not finished:
        return {}, None, []
    order = inputs.permutation(subseed(spec.seed, CHECKED), len(finished))
    kept = sorted(finished[k] for k in order[:spec.traffic["check_requests"]])
    where = {i: k for k, (launch, n) in enumerate(rows) for i in launch[:n]}
    R.exact_float32()
    cfg = dict(spec.config, _cond_scale=cond_scale, _grid=build.num_tokens(spec.config)[1])
    W = weights.make(layout, wseed, spec.device, dtypes)
    got, ctl = [], []
    for k in sorted({where[i] for i in kept}):
        launch, n = rows[k]
        emb = pool[launch]
        delivered = torch.stack([torch.as_tensor(results[i]) for i in launch[:n]]).to(spec.device)
        got.append(checks.sample_numbers(W, cfg, launches[k], emb, uint8=delivered))
        if spec.control:
            ctl.append(checks.sample_numbers(W, cfg, launches[k], emb, uint8=delivered, control=True))
    return dict(checks.worst(got), launch_records=0.0), (checks.worst(ctl) if ctl else None), kept
