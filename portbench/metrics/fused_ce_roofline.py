"""fused_ce_roofline: kernels 7-9's share of their roofline: the least
time of the (b * n, 512) x (65,536, 512) cross-entropy's forward, dh and
dW (`flops.fused_ce_least`: five products at the bf16 peak, the logits
computed again in each backward from the saved lse) a profiled step, over
the device time of `ce_fwd_wgmma_kernel`, `ce_merge_kernel`,
`ce_dh_wgmma_kernel`, `ce_sum_kernel` and `ce_dw_wgmma_kernel`."""

from portbench import flops

KERNELS = r"\bce_(fwd_wgmma|merge|dh_wgmma|sum|dw_wgmma)_kernel\b"


def read(ctx):
    if ctx.trace is None or not ctx.get("steps"):
        return None
    step = flops.train_step(ctx.config, ctx.batch)
    least = flops.fused_ce_least(step["ce_rows"], step["dim"], step["vocab"])
    spent = ctx.trace.kernel_s(KERNELS)
    return 100.0 * least * ctx.steps / spent if spent > 0 else None
