"""loop_idle_ms.sample: milliseconds a call that the device sat idle while
the host ran the decode loop: every gap between the device's merged kernel,
copy and set intervals inside the profiled calls whose midpoint falls
inside one of the program's `phenaki.decode_step` spans, summed and divided
by the profiled calls. None where the program has no such span."""

from bisect import bisect_right

from portbench.trace import merged

SPAN = "phenaki.decode_step"


def gaps(trace):
    """(start, end) of each stretch inside a call with no device interval."""
    out = []
    for call in trace.calls:
        busy = merged([(max(e.ts, call.ts), min(e.end, call.end)) for e in trace.device
                       if e.end > call.ts and e.ts < call.end])
        edges = [call.ts] + [x for s in busy for x in s] + [call.end]
        out += [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]
    return out


def read(ctx):
    if ctx.trace is None or not ctx.get("calls") or not ctx.trace.calls:
        return None
    steps = merged((e.ts, e.end) for e in ctx.trace.cpu if e.name == SPAN)
    if not steps:
        return None
    starts = [lo for lo, _ in steps]
    idle = 0.0
    for lo, hi in gaps(ctx.trace):
        k = bisect_right(starts, (lo + hi) / 2) - 1
        if k >= 0 and (lo + hi) / 2 < steps[k][1]:
            idle += hi - lo
    return idle / 1e3 / ctx.calls
