"""ff_roofline: the feedforwards' share of their roofline over the profiled
sample calls: the least time of every feedforward of a sample call (after
its norm), over the device time of the kernels launched inside the
program's `phenaki.feedforward` spans. Each feedforward is counted from the
configuration in the served dtype, on the unpadded width `flops.ff_inner`:
tokens x (2 dim 2 inner + 2 inner dim) operations, and x read, both weights
read, h written and read, and the output written, each once; the MaskGit at
the guidance batch every step, the critic every step but the last, the
C-ViViT decoder's temporal and spatial layers once at the call's batch.
None where the program has no such span."""

from portbench import flops
from portbench.build import num_tokens

SPAN = "phenaki.feedforward"
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def least(tokens: int, dim: int, size: int) -> float:
    """One feedforward's least seconds over `tokens` rows of width dim."""
    inner = flops.ff_inner(dim)
    ops = tokens * (2.0 * dim * 2 * inner + 2.0 * inner * dim)
    elements = tokens * dim + 3 * inner * dim + 2 * tokens * inner + tokens * dim
    return flops.least_seconds(ops, elements * size)


def call_seconds(config: dict, b: int) -> float:
    """The least seconds of the feedforwards of one `Phenaki.sample` call of
    b clips."""
    n, grid = num_tokens(config)
    steps = config["sampling"]["steps"]
    size = ELEMENT_BYTES[config["precision"]["serve"]]
    m, c = config["maskgit"], config["cvivit"]
    total = steps * m["depth"] * least(2 * b * n, m["dim"], size)
    if config.get("critic"):
        total += (steps - 1) * config["critic"]["depth"] * least(2 * b * n, config["critic"]["dim"], size)
    decoded = b * grid[0] * grid[1] * grid[2]
    return total + (c["temporal_depth"] + c["spatial_depth"]) * least(decoded, c["dim"], size)


def read(ctx):
    if ctx.trace is None or not ctx.get("calls"):
        return None
    spent = ctx.trace.launched_under_s(SPAN)
    return 100.0 * call_seconds(ctx.config, ctx.batch) * ctx.calls / spent if spent > 0 else None
