"""ff_ms.sample: device milliseconds a clip of the kernels launched inside
the program's `phenaki.feedforward` spans (each transformer layer's
feedforward after its norm: the first product with its GEGLU and the second
product; in the MaskGit, the critic and the C-ViViT decoder), over the
profiled clips. None where the program has no such span."""

SPAN = "phenaki.feedforward"


def read(ctx):
    if ctx.trace is None or not ctx.get("clips"):
        return None
    seconds = ctx.trace.launched_under_s(SPAN)
    return seconds * 1e3 / ctx.clips if seconds > 0 else None
