"""mfu.train: the whole train step's share of the chip's bf16 peak: three
times the forward model FLOPs (`flops.train_step`: the MaskGit trunk and
the vocab head at the step's batch) of the profiled steps over their wall
time (host clock, each step synchronised) and 989 TFLOP/s."""

from portbench import flops


def read(ctx):
    if ctx.trace is None or not ctx.get("steps") or ctx.get("wall_s", 0) <= 0:
        return None
    work = 3 * flops.train_step(ctx.config, ctx.batch)["forward_flops"] * ctx.steps
    return 100.0 * work / ctx.wall_s / flops.PEAK_FLOPS["bf16"]
