"""The yardstick's operation and byte counts against hand counts."""

import math

import pytest

from portbench import flops
from portbench.common import BENCH, load_json

PEAK, BW = 989e12, 3.35e12


def test_attention_forward_least_time_by_hand():
    a = flops.Attn(b=2, h=2, i=3, j=5, d=4, bias=True, kmask=True)
    ops = 4 * 2 * 2 * 3 * 5 * 4  # QK^T and PV, 2 flops a multiply-add
    nbytes = (2 * 2 * 3 * 4 * 2  # q, bf16
              + 2 * 2 * 2 * 5 * 4 * 2  # k, v
              + 2 * 3 * 5 * 2  # bias (h, i, j)
              + 2 * 5 * 4  # key mask (b, j) f32
              + 2 * 2 * 3 * 4 * 2)  # out
    assert a.fwd_least() == pytest.approx(max(ops / PEAK, nbytes / BW))
    assert a.fwd_least(lse=True) == pytest.approx(max(ops / PEAK, (nbytes + 2 * 2 * 3 * 4) / BW))


def test_attention_backward_least_time_by_hand():
    b, h, i, j, d = 2, 8, 1152, 1152, 64
    a = flops.Attn(b, h, i, j, d, bias=True, kmask=False)
    ijd = b * h * i * j * d
    io = (b * h * i * d * 2 + 2 * b * h * j * d * 2 + h * i * j * 2 + b * h * i * 4  # q, k, v, bias, lse
          + b * h * i * (d * 2 + 4))  # dO, delta
    want = (max(6 * ijd / PEAK, (io + b * h * i * d * 2) / BW)
            + max(8 * ijd / PEAK, (io + 2 * b * h * j * d * 2) / BW)
            + max(4 * ijd / PEAK, (io + h * i * j * 4) / BW))
    assert a.bwd_least() == pytest.approx(want)
    assert flops.Attn(b, h, i, j, d, bias=False, kmask=True).bwd_least() < a.bwd_least()


def test_projection_sampler_and_fused_ce_by_hand():
    rows, d, v = 1152, 512, 65536
    ops = 2 * rows * d * v
    assert flops.proj_sample_least(rows, d, v) == pytest.approx(
        max(ops / PEAK, (rows * d * 2 + v * d * 2 + v * 4 + rows * 8) / BW))
    # five products: the forward once, dh and dW twice each (the logits again)
    assert flops.fused_ce_least(36864, d, v) == pytest.approx(5 * 2 * 36864 * d * v / PEAK)


def test_trunk_flops_by_hand():
    cfg = {"dim": 8, "heads": 2, "dim_head": 4, "depth": 1}
    seqs, n, L, dc = 2, 3, 5, 6
    inner, ff = 8, int(4 * (2 / 3) * 8)
    tokens = seqs * n
    want = (tokens * 2 * 8 * 3 * inner + tokens * 2 * inner * 8 + 4 * tokens * n * inner + tokens * 2 * 27 * 8
            + tokens * 2 * 8 * inner + tokens * 2 * inner * 8 + seqs * L * 2 * dc * 2 * inner
            + 4 * tokens * (L + 2) * inner + tokens * 2 * 8 * 2 * ff + tokens * 2 * ff * 8)
    assert flops.trunk_flops(cfg, seqs, n, L, dc) == want


@pytest.mark.parametrize("config, kernel_1_calls", [("phenaki-flagship", 216), ("phenaki-flagship-critic", 420)])
def test_a_flagship_sample_counts_the_ports_launches(config, kernel_1_calls):
    """Kernel 1 launches 216 times a flagship sample (420 with a critic; the
    decoder's attention over 8 x 4 patches takes the plain path) and kernel
    2 18 times, as the port's launch counters read on the card."""
    call = flops.sample_call(load_json(BENCH / "configs" / f"{config}.json"), 8)
    assert len(call["attn"]) == kernel_1_calls
    assert call["proj_rows"] == [8 * 288] * 18
    # the MaskGit trunk and head dominate: about 18 x (16 x 288 tokens x 64 MFLOP + the head's 2.4 TFLOP / 18)
    assert 5e12 < call["flops"] < 15e12


def test_a_flagship_train_step_counts_the_ports_launches():
    step = flops.train_step(load_json(BENCH / "configs" / "phenaki-flagship.json"), 32)
    assert len(step["attn"]) == 12 and sum(a.bias for a in step["attn"]) == 6
    assert step["ce_rows"] == 32 * 288
    head = 2 * 32 * 288 * 512 * 65536
    assert head < step["forward_flops"] < 3 * head
    assert math.isclose(step["forward_flops"] - head,
                        flops.trunk_flops(load_json(BENCH / "configs" / "phenaki-flagship.json")["maskgit"],
                                          32, 288, 128, 768))
