"""adam_ms.train: device milliseconds a step of the optimizer: the kernels
launched inside torch's `Optimizer.step#Adam.step` range (the foreach Adam
update), matched to their launches in the profiler's trace."""

RANGE = "Optimizer.step#Adam.step"


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    spent = ctx.trace.launched_under_s(RANGE)
    return spent * 1e3 / len(ctx.trace.calls) if spent > 0 else None
