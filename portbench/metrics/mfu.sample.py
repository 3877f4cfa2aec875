"""mfu.sample: the whole sample's share of the chip's bf16 peak: the model
FLOPs of the profiled clips (`flops.sample_call`: the MaskGit trunk at the
guidance batch and the vocab head every step, the critic's trunk every step
but the last, the C-ViViT decoder) over their wall time (host clock, each
call synchronised) and 989 TFLOP/s."""

from portbench import flops


def read(ctx):
    if ctx.trace is None or not ctx.get("calls") or ctx.get("wall_s", 0) <= 0:
        return None
    work = flops.sample_call(ctx.config, ctx.batch)["flops"] * ctx.calls
    return 100.0 * work / ctx.wall_s / flops.PEAK_FLOPS["bf16"]
