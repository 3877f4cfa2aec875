"""proj_sample_roofline: kernel 2's share of its roofline: the least
time of every (b * n, 512) x (512, 65,536) projection-and-pick of the
profiled calls (`flops.proj_sample_least`: the product at the bf16 peak, or
h, the head and its bias read and an id and a score written at the HBM
bandwidth) over the device time of `proj_wgmma_kernel` and its merge of the
vocab splits, `proj_merge_kernel`."""

from portbench import flops

KERNELS = r"\bproj_(wgmma|merge)_kernel\b"


def read(ctx):
    if ctx.trace is None or not ctx.get("calls"):
        return None
    call = flops.sample_call(ctx.config, ctx.batch)
    least = sum(flops.proj_sample_least(rows, call["dim"], call["vocab"]) for rows in call["proj_rows"])
    spent = ctx.trace.kernel_s(KERNELS)
    return 100.0 * least * ctx.calls / spent if spent > 0 else None
