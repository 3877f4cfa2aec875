"""idle_share.serve: the device's idle share while the server made the
profiled launches: 1 - the union of its kernel, copy and set intervals over
the profiled span's wall time, from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
