"""generator_lag_ms.serve: how late the benchmark's load generator submitted
requests against their due times, the 95th percentile over the window, in
milliseconds (host clock): a late generator offers less load than the
cell's rate."""

from portbench.common import percentile


def read(ctx):
    lag = ctx.get("lag_ms") or []
    return percentile(lag, 95) if lag else None
