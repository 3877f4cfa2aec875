"""host_waits.sample: the CUDA runtime calls that block the host until the
device has caught up (a stream, device or event synchronize, a synchronous
`cudaMemcpy`) made inside the program's `phenaki.sample` spans, a profiled
call: each is a point where the host drained the device's queue. The
benchmark's `synchronize()` after each call lies outside the span. None
where the program has no such span."""

import re

SPAN = "phenaki.sample"
WAITS = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize|cudaMemcpy)"
                   r"(_v\d+|_ptsz|_ptds)?$")


def read(ctx):
    if ctx.trace is None or not ctx.get("calls"):
        return None
    spans = [e for e in ctx.trace.cpu if e.name == SPAN]
    if not spans:
        return None
    waits = [r for r in ctx.trace.runtime if WAITS.match(r.name)
             and any(s.tid == r.tid and s.ts <= r.ts < s.end for s in spans)]
    return len(waits) / ctx.calls
