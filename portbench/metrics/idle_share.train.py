"""idle_share.train: the device's idle share over the profiled train
steps: 1 - the union of its kernel, copy and set intervals over the calls'
wall span, from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
