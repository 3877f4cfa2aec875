"""flash_bwd_roofline: kernels 4-6's share of their roofline: the
least time of dQ, dK/dV and dBias at each of a step's attention calls
(`flops.train_step`'s calls: self-attention with the position bias and the
video mask, cross-attention over the text; `Attn.bwd_least`) a profiled
step, over the device time of `flash_bwd_dq_wgmma`, `flash_bwd_dkv_wgmma`
and `flash_bwd_dbias_wgmma`."""

from portbench import flops

KERNELS = r"\bflash_bwd_(dq|dkv|dbias)_wgmma\b"


def read(ctx):
    if ctx.trace is None or not ctx.get("steps"):
        return None
    least = sum(a.bwd_least() for a in flops.train_step(ctx.config, ctx.batch)["attn"])
    spent = ctx.trace.kernel_s(KERNELS)
    return 100.0 * least * ctx.steps / spent if spent > 0 else None
