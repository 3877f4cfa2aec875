"""peg_ms.sample: device milliseconds a clip of PEG's stencil kernel
(`peg_stencil_kernel`, csrc/peg_stencil.cu: the depthwise 3x3x3 stencil with
its bias and the layer's residual, once a MaskGit and critic layer a step
and once a decoder temporal layer), over the profiled clips. None where the
program has no such kernel."""

KERNELS = r"\bpeg_stencil_kernel\b"


def read(ctx):
    if ctx.trace is None or not ctx.get("clips"):
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    return seconds * 1e3 / ctx.clips if seconds > 0 else None
