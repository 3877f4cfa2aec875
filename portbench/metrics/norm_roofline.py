"""norm_roofline: the trunk's norm kernels' share of their roofline over the
profiled sample calls: the least time by bytes of every normalisation of a
sample call, over the device time of `layernorm_kernel` and
`qk_norm_split_kernel` (csrc/norms.cu). The bytes are counted here from the
configuration, in the served dtype, each input read once and each output
written once: each trunk layer's LayerNorms (its attention's and its
feedforward's over the tokens, its cross-attention's over the tokens and over
the text), each attention's head split (q, k and v read in the projection's
layout and written per head; the cross-attention's keys and values with the
null key/values in front), and each stack's final norm; the MaskGit at the
guidance batch every step, the critic every step but the last, the C-ViViT
decoder's temporal and spatial layers once. None where the program has no
such kernels."""

from portbench import flops
from portbench.build import num_tokens

KERNELS = r"\b(layernorm_kernel|qk_norm_split_kernel)\b"
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def _trunk(cfg: dict, seqs: int, n: int, text_len: int) -> float:
    """Elements read and written by one trunk forward's normalisations."""
    dim, inner = cfg["dim"], cfg["heads"] * cfg["dim_head"]
    tokens, text = seqs * n, seqs * text_len
    norms = 2 * (3 * tokens * dim + text * cfg["dim_context"])  # attention, cross, feedforward; context
    self_split = 2 * 3 * tokens * inner
    cross_split = (tokens * inner + 2 * text * inner + 2 * flops.NULL_KV * inner  # read
                   + tokens * inner + 2 * seqs * (text_len + flops.NULL_KV) * inner)  # written
    return cfg["depth"] * (norms + self_split + cross_split) + 2 * tokens * dim


def _decoder(c: dict, b: int, grid) -> float:
    tokens = b * grid[0] * grid[1] * grid[2]
    dim, inner = c["dim"], c["heads"] * c["dim_head"]
    per_layer = 2 * 2 * tokens * dim + 2 * 3 * tokens * inner
    return (c["temporal_depth"] + c["spatial_depth"]) * per_layer + 2 * 2 * tokens * dim


def call_bytes(config: dict, b: int) -> float:
    """Bytes of the normalisations of one `Phenaki.sample` call of b clips."""
    n, grid = num_tokens(config)
    steps, text_len = config["sampling"]["steps"], config["sampling"]["max_text_len"]
    elements = steps * _trunk(config["maskgit"], 2 * b, n, text_len) + _decoder(config["cvivit"], b, grid)
    if config.get("critic"):
        elements += (steps - 1) * _trunk(config["critic"], 2 * b, n, text_len)
    return elements * ELEMENT_BYTES[config["precision"]["serve"]]


def read(ctx):
    if ctx.trace is None or not ctx.get("calls"):
        return None
    spent = ctx.trace.kernel_s(KERNELS)
    least = flops.least_seconds(0.0, call_bytes(ctx.config, ctx.batch))
    return 100.0 * least * ctx.calls / spent if spent > 0 else None
