"""The traced run's reading of the device: `torch.profiler` (CUPTI, with the
host's operators) over a fixed number of whole calls from the middle of the
window on, each inside a `portbench.call` range, exported as a Chrome trace
into the run's scratch folder and parsed here; the file is deleted after.
(A profile of the device alone, without host operators, recorded no kernel
on the H100 machine with torch 2.11.)

`busy_s` is the union of the device's kernel, copy and set intervals inside
the calls (not a sum of self times, which counts overlapping work twice) and
`window_s` the calls' wall span. The host's ranges name the operator that
launched each kernel and what the host was doing while the device idled.
Profiling the host's operators slows the host, so a traced call is longer,
and its idle share higher, than an unprofiled one where the host sets the
pace."""

from __future__ import annotations

import json
import re
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    name: str
    ts: float  # microseconds
    dur: float
    tid: object = None
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    kernels: List[Event] = field(default_factory=list)
    device: List[Event] = field(default_factory=list)  # kernels, copies, sets
    cpu: List[Event] = field(default_factory=list)  # operators and annotations on the host
    runtime: List[Event] = field(default_factory=list)  # launches (cudaLaunchKernel, ...)
    calls: List[Event] = field(default_factory=list)  # the portbench.call ranges

    @property
    def window_s(self) -> float:
        return sum(c.dur for c in self.calls) / 1e6

    def _in_calls(self, events: Iterable[Event]) -> List[Event]:
        spans = sorted((c.ts, c.end) for c in self.calls)
        starts = [s for s, _ in spans]
        out = []
        for e in events:
            k = bisect_right(starts, e.ts) - 1
            if k >= 0 and e.ts < spans[k][1]:
                out.append(e)
        return out

    def busy_s(self) -> float:
        """The union of the device's intervals, clipped to the calls."""
        total = 0.0
        for call in self.calls:
            total += union_length([(max(e.ts, call.ts), min(e.end, call.end)) for e in self.device
                                   if e.end > call.ts and e.ts < call.end])
        return total / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels (inside the calls) whose name
        matches the regular expression `pattern`."""
        rx = re.compile(pattern)
        return sum(e.dur for e in self._in_calls(self.kernels) if rx.search(e.name)) / 1e6

    def launched_under_s(self, op_prefix: str) -> float:
        """Device seconds of the kernels launched inside host ranges whose
        name starts with `op_prefix` (matched by the launch's correlation id
        and the range's thread)."""
        ranges = [e for e in self.cpu if e.name.startswith(op_prefix)]
        corr = {r.corr for r in self.runtime
                if any(o.tid == r.tid and o.ts <= r.ts < o.end for o in ranges)}
        return sum(e.dur for e in self._in_calls(self.kernels) if e.corr in corr) / 1e6

    def launchers(self) -> dict:
        """correlation id -> the innermost host operator (not an annotation
        of this benchmark) open on the launching thread at the launch."""
        by_tid: dict = {}
        for e in self.cpu:
            if e.name != CALL:
                by_tid.setdefault(e.tid, []).append(e)
        out = {}
        runtime: dict = {}
        for r in self.runtime:
            runtime.setdefault(r.tid, []).append(r)
        for tid, launches in runtime.items():
            ops = sorted(by_tid.get(tid, []), key=lambda e: (e.ts, -e.dur))
            stack, k = [], 0
            for r in sorted(launches, key=lambda e: e.ts):
                while k < len(ops) and ops[k].ts <= r.ts:
                    stack.append(ops[k])
                    k += 1
                while stack and stack[-1].end <= r.ts:
                    stack.pop()
                open_ = [o for o in stack if o.end > r.ts]
                if open_:
                    out[r.corr] = open_[-1].name
        return out

    def breakdown(self, top: int = 10, labelled: int = 400) -> dict:
        """The device operations that took most time, and the idle time of
        the `labelled` longest gaps summed by what the host was doing: the
        shortest host range (operator or annotation) open at a gap's middle."""
        import numpy as np

        launcher = self.launchers()
        by_name: dict = {}
        for e in self._in_calls(self.device):
            op = launcher.get(e.corr)
            key = f"{short_name(op, 32)}: {short_name(e.name, 64)}" if op else short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + e.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for call in self.calls:
            spans = merged([(max(e.ts, call.ts), min(e.end, call.end)) for e in self.device
                            if e.end > call.ts and e.ts < call.end])
            edges = [call.ts] + [x for s in spans for x in s] + [call.end]
            gaps += [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [e for e in self.cpu if e.name != CALL]
        ts = np.array([e.ts for e in host])
        end = np.array([e.end for e in host])
        dur = np.array([e.dur for e in host])
        idle: dict = {}
        for lo, hi in gaps[:labelled]:
            t = (lo + hi) / 2
            open_ = np.nonzero((ts <= t) & (end > t))[0]
            label = short_name(host[open_[np.argmin(dur[open_])]].name) if len(open_) else "no host range open"
            idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e6
        gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps_out]}


def short_name(name: str, limit: int = 80) -> str:
    """A kernel's or operator's name without `void`, anonymous namespaces and
    its argument list, cut to `limit` letters."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for k, ch in enumerate(name):  # the argument list: the first '(' outside template brackets
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = k
            break
    return name[:cut][:limit]


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def union_length(intervals) -> float:
    return sum(hi - lo for lo, hi in merged(intervals))


def parse(path: Path) -> Trace:
    """A Chrome trace exported by torch.profiler -> Trace."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    tr = Trace()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        e = Event(ev.get("name", ""), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0)), ev.get("tid"),
                  args.get("correlation"))
        if cat in DEVICE_CATS:
            tr.device.append(e)
            if cat == "kernel":
                tr.kernels.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            tr.runtime.append(e)
        elif cat in ("cpu_op", "user_annotation"):
            tr.cpu.append(e)
            if cat == "user_annotation" and e.name == CALL:
                tr.calls.append(e)
    return tr


class Profiler:
    """The traced run's stretch of whole calls: from the middle of the
    window, `calls` calls profiled, each in a `portbench.call` range. Wrap
    every call of the window in `run`; `read()` after the window parses."""

    def __init__(self, scratch: Path, calls: int, cuda: bool = True):
        self.scratch, self.cuda, self.n = Path(scratch), cuda, calls
        self.state, self.calls, self.wall = "waiting", 0, 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.state = "on"

    def call(self):
        from torch.profiler import record_function

        return record_function(CALL)

    def warm(self, fn) -> None:
        """Start and stop the profiler once around fn() in set-up: the first
        start initialises CUPTI (about 0.2 s), which would stall the window."""
        self.start()
        fn()
        self._prof.__exit__(None, None, None)
        self._prof, self.state = None, "waiting"

    def stop(self) -> None:
        if self.state == "on":
            self._prof.__exit__(None, None, None)
            self.state = "done"

    def run(self, fn, elapsed: float, seconds: float, sync):
        """fn() as the window's next call, synchronised, profiled in its turn."""
        import time

        if self.state == "waiting" and elapsed >= seconds / 2:
            sync()  # nothing earlier runs inside the profile
            self.start()
        if self.state != "on":
            out = fn()
            sync()
            return out
        t0 = time.perf_counter()
        with self.call():
            out = fn()
            sync()
        self.wall += time.perf_counter() - t0
        self.calls += 1
        if self.calls == self.n:
            self.stop()
        return out

    def read(self) -> Optional[Trace]:
        self.stop()
        if self._prof is None:
            return None
        path = self.scratch / "trace.json"
        self._prof.export_chrome_trace(str(path))
        try:
            return parse(path)
        finally:
            path.unlink(missing_ok=True)
            self._prof = None
