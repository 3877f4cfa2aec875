"""norm_ms.sample: device milliseconds a clip of the trunk's norm kernels
(csrc/norms.cu: `layernorm_kernel`, every LayerNorm of the MaskGit, the
critic and the decoder, and `qk_norm_split_kernel`, every attention's head
split with its q/k l2norm), over the profiled clips. None where the program
has no such kernels."""

KERNELS = r"\b(layernorm_kernel|qk_norm_split_kernel)\b"


def read(ctx):
    if ctx.trace is None or not ctx.get("clips"):
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    return seconds * 1e3 / ctx.clips if seconds > 0 else None
