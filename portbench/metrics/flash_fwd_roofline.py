"""flash_fwd_roofline: kernel 1's share of its roofline over the
profiled sample calls: the least time of each attention call's shapes
(`flops.sample_call`'s calls: the MaskGit's and the critic's self- and
cross-attention at the guidance batch every step, the decoder's spatial
attention where it has kernel 1's 64 rows or more; `Attn.fwd_least`)
over the device time of `flash_fwd_wgmma*`."""

from portbench import flops

KERNELS = r"\bflash_fwd_wgmma\w*"


def read(ctx):
    if ctx.trace is None or not ctx.get("calls"):
        return None
    least = sum(a.fwd_least() for a in flops.sample_call(ctx.config, ctx.batch)["attn"])
    spent = ctx.trace.kernel_s(KERNELS)
    return 100.0 * least * ctx.calls / spent if spent > 0 else None
