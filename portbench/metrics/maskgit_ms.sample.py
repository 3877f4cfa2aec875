"""maskgit_ms.sample: device milliseconds a clip of the kernels launched
inside the program's `phenaki.maskgit_forward` spans (the MaskGit's stacked
cond/null trunk and the guidance combine, once a decoding step), over the
profiled clips. None where the program has no such span."""

SPAN = "phenaki.maskgit_forward"


def read(ctx):
    if ctx.trace is None or not ctx.get("clips"):
        return None
    seconds = ctx.trace.launched_under_s(SPAN)
    return seconds * 1e3 / ctx.clips if seconds > 0 else None
