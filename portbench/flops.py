"""The yardstick: the chip's published peaks, and the operations and bytes of
the model and of each kernel's operation, counted from shapes alone.

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory bandwidth, each input read once and each
output written once, in the dtypes the operation takes (bf16 operands,
float32 masks, log-sum-exps and bias gradients). Model FLOPs count the
products (2 per multiply-add), attention's two products included; norms,
softmax and elementwise work are not counted.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16, 67
TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3, at the full
power limit of 700 W.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4
FLASH_MIN_ROWS = 64  # the port's gate for kernel 1 (`ops/attention.py`): i >= 64 query rows
NULL_KV = 2  # learned null key/values in front of every cross-attention's keys


def least_seconds(flops: float, nbytes: float, kind: str = "bf16") -> float:
    return max(flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S)


def ff_inner(dim: int, mult: int = 4) -> int:
    return int(mult * (2 / 3) * dim)


@dataclass(frozen=True)
class Attn:
    """One attention call: q (b, h, i, d), k and v (b, h, j, d); an (h, i, j)
    bias and a (b, j) key mask where present."""

    b: int
    h: int
    i: int
    j: int
    d: int
    bias: bool
    kmask: bool

    @property
    def ijd(self) -> float:
        return float(self.b * self.h * self.i * self.j * self.d)

    def operand_bytes(self, lse: bool) -> float:
        q = self.b * self.h * self.i * self.d * BF16
        kv = 2 * self.b * self.h * self.j * self.d * BF16
        bias = self.h * self.i * self.j * BF16 if self.bias else 0
        kmask = self.b * self.j * F32 if self.kmask else 0
        return q + kv + bias + kmask + (self.b * self.h * self.i * F32 if lse else 0)

    def fwd_least(self, lse: bool = False) -> float:
        """QK^T and PV; out (and the lse when training) written once."""
        out = self.b * self.h * self.i * self.d * BF16
        return least_seconds(4 * self.ijd, self.operand_bytes(lse) + out)

    def bwd_least(self) -> float:
        """dQ (S, dP recomputed, dS K), dK/dV (S, dP, dS^T Q, P^T dO) and
        dBias (S, dP; the bias gradient summed over the batch)."""
        io = self.operand_bytes(lse=True) + self.b * self.h * self.i * (self.d * BF16 + F32)  # dO, delta
        dq = least_seconds(6 * self.ijd, io + self.b * self.h * self.i * self.d * BF16)
        dkv = least_seconds(8 * self.ijd, io + 2 * self.b * self.h * self.j * self.d * BF16)
        dbias = least_seconds(4 * self.ijd, io + self.h * self.i * self.j * F32) if self.bias else 0.0
        return dq + dkv + dbias


def trunk_calls(cfg: dict, seqs: int, n: int, text_len: Optional[int], bias: bool, kmask_self: bool) -> List[Attn]:
    """The attention calls of one trunk forward over `seqs` sequences of n
    tokens, with cross-attention over `text_len` text tokens (None: none)."""
    h, d = cfg["heads"], cfg["dim_head"]
    calls = []
    for _ in range(cfg["depth"]):
        calls.append(Attn(seqs, h, n, n, d, bias, kmask_self))
        if text_len is not None:
            calls.append(Attn(seqs, h, n, text_len + NULL_KV, d, False, True))
    return calls


def trunk_flops(cfg: dict, seqs: int, n: int, text_len: Optional[int], dim_context: Optional[int]) -> float:
    """Model FLOPs of one trunk forward (no head)."""
    dim, inner = cfg["dim"], cfg["heads"] * cfg["dim_head"]
    tokens = seqs * n
    per_layer = tokens * 2 * dim * 3 * inner + tokens * 2 * inner * dim  # qkv, out
    per_layer += 4 * tokens * n * inner  # QK^T, PV
    per_layer += tokens * 2 * 27 * dim  # PEG's depthwise 3x3x3
    if text_len is not None:
        per_layer += tokens * 2 * dim * inner + tokens * 2 * inner * dim  # q, out
        per_layer += seqs * text_len * 2 * dim_context * 2 * inner  # kv of the text
        per_layer += 4 * tokens * (text_len + NULL_KV) * inner
    per_layer += tokens * 2 * dim * 2 * ff_inner(dim) + tokens * 2 * ff_inner(dim) * dim
    return float(cfg["depth"] * per_layer)


def cvivit_decode(c: dict, b: int, grid) -> tuple:
    """(model FLOPs, kernel-1 calls) of decoding b clips of latent grid
    (t, h, w): codes -> temporal (causal, over t) -> spatial (over h*w) ->
    pixel heads. An attention of fewer than FLASH_MIN_ROWS rows (the temporal
    one, over t; the spatial one at patch 32, over 8 x 4) takes the plain
    path, not kernel 1."""
    t, h, w = grid
    dim, inner, patch = c["dim"], c["heads"] * c["dim_head"], c["patch_size"]
    bits = c["codebook_size"].bit_length() - 1
    tokens = b * t * h * w

    def stack(depth, seq):
        per = tokens * (2 * dim * 3 * inner + 2 * inner * dim + 4 * seq * inner
                        + 2 * dim * 2 * ff_inner(dim) + 2 * ff_inner(dim) * dim)
        return depth * per

    flops = tokens * 2 * bits * dim
    flops += stack(c["temporal_depth"], t) + tokens * 2 * 27 * dim * c["temporal_depth"]
    flops += stack(c["spatial_depth"], h * w)
    flops += b * h * w * 2 * dim * 3 * patch * patch * (1 + (t - 1) * c["temporal_patch_size"])
    spatial = [Attn(b * t, c["heads"], h * w, h * w, c["dim_head"], True, False)] * c["spatial_depth"]
    return float(flops), spatial if h * w >= FLASH_MIN_ROWS else []


def sample_call(config: dict, b: int) -> dict:
    """One `Phenaki.sample` call of b clips: model FLOPs, kernel-1 calls and
    kernel 2's rows, by the decode loop's structure (CFG doubles the
    trunks' batch; the critic scores every step but the last)."""
    m, s = config["maskgit"], config["sampling"]
    from portbench.build import num_tokens  # shapes only

    n, grid = num_tokens(config)
    steps, L = s["steps"], s["max_text_len"]
    trunk = trunk_flops(m, 2 * b, n, L, m["dim_context"])
    head = 2.0 * b * n * m["dim"] * m["num_tokens"]
    flops = steps * (trunk + head)
    calls = steps * trunk_calls(m, 2 * b, n, L, bias=True, kmask_self=False)
    critic = config.get("critic")
    if critic:
        flops += (steps - 1) * (trunk_flops(critic, 2 * b, n, L, critic["dim_context"]) + 2.0 * 2 * b * n * critic["dim"])
        calls += (steps - 1) * trunk_calls(critic, 2 * b, n, L, bias=False, kmask_self=False)
    dec_flops, dec_calls = cvivit_decode(config["cvivit"], b, grid)
    return {"flops": flops + dec_flops, "attn": calls + dec_calls, "proj_rows": [b * n] * steps,
            "dim": m["dim"], "vocab": m["num_tokens"]}


def train_step(config: dict, b: int) -> dict:
    """One MaskGit train step of b clips on token ids: forward model FLOPs,
    the attention calls (self with the position bias and the all-true video
    mask, cross over the text) and the CE's rows."""
    m, s = config["maskgit"], config["sampling"]
    from portbench.build import num_tokens

    n, _ = num_tokens(config)
    L = s["max_text_len"]
    fwd = trunk_flops(m, b, n, L, m["dim_context"]) + 2.0 * b * n * m["dim"] * m["num_tokens"]
    return {"forward_flops": fwd, "attn": trunk_calls(m, b, n, L, bias=True, kmask_self=True),
            "ce_rows": b * n, "dim": m["dim"], "vocab": m["num_tokens"]}


def proj_sample_least(rows: int, d: int, v: int) -> float:
    """Kernel 2: the (rows, d) x (d, V) product with the Gumbel-max pick:
    h, the bf16 head and its f32 bias read, an id and a score written."""
    return least_seconds(2.0 * rows * d * v, rows * d * BF16 + v * d * BF16 + v * F32 + rows * 8)


def fused_ce_least(rows: int, d: int, v: int) -> float:
    """Kernels 7-9: the forward (logits once: loss and lse out), dh (the
    logits again and dlogits W) and dW (the logits again and dlogits^T h),
    each from h, the bf16 head and its bias, labels and the saved lse."""
    product = 2.0 * rows * d * v
    inputs = rows * d * BF16 + v * d * BF16 + v * F32 + rows * 4
    fwd = least_seconds(product, inputs + rows * 2 * F32)
    dh = least_seconds(2 * product, inputs + rows * 2 * F32 + rows * d * BF16)
    dw = least_seconds(2 * product, inputs + rows * 2 * F32 + v * d * F32 + v * F32)
    return fwd + dh + dw
