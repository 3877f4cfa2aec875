"""clip_latency_p50_s.serve: the median latency over all requests of the
window, each from when it was due until its future resolved (a missing one
counts as infinite), beside the p95 that is the end-to-end metric."""

from portbench.common import percentile


def read(ctx):
    lat = ctx.get("latency_s") or []
    return percentile(lat, 50) if lat else None
