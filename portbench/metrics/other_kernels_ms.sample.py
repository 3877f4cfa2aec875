"""other_kernels_ms.sample: device milliseconds a clip of every kernel that
is neither one of the port's (`csrc/`: flash attention, the projection
sampler, the fused CE, the Gumbel sampler) nor a GEMM (cuBLAS, CUTLASS):
the trunk's elementwise work, PEG, norms, copies and reductions."""

PORT = r"\b(flash_(fwd|bwd)_\w+|proj_(wgmma|merge|partials)_kernel|ce_\w+_kernel|gumbel_sample_kernel)\b"
GEMM = r"(?i)(gemm|nvjet|xmma|cutlass|cublas)"


def read(ctx):
    import re

    if ctx.trace is None or not ctx.get("clips"):
        return None
    port, gemm = re.compile(PORT), re.compile(GEMM)
    total = sum(e.dur for e in ctx.trace._in_calls(ctx.trace.kernels)
                if not port.search(e.name) and not gemm.search(e.name))
    return total / 1e3 / ctx.clips if total > 0 else None
