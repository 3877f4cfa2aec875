"""cvivit_decode_ms.sample: device milliseconds a clip of the kernels
launched inside the program's `phenaki.cvivit_decode` spans (the C-ViViT
decoder turning the final ids into frames, once a call), over the profiled
clips. None where the program has no such span."""

SPAN = "phenaki.cvivit_decode"


def read(ctx):
    if ctx.trace is None or not ctx.get("clips"):
        return None
    seconds = ctx.trace.launched_under_s(SPAN)
    return seconds * 1e3 / ctx.clips if seconds > 0 else None
