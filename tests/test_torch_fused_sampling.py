"""The port's fused projection-sampling module
(phenaki_tpu_torch/ops/fused_sampling.py) and top-k re-mask against the JAX
package: `project_gumbel_sample_with_score` run in interpret mode with the
same injected uniforms, and `topk_mask`.

On a CPU tensor `project_sample` takes its plain version, so these tests pin
the math contract the CUDA kernel is held to on the card (chip_smoke.py).
Ids must agree exactly; scores within atol 1e-5 (fp32).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_sampling as ps  # noqa: E402
from phenaki_tpu.ops.sampling import topk_mask as j_topk_mask  # noqa: E402
from phenaki_tpu_torch.ops.fused_sampling import (
    ROW_TILE,
    _kernel_operands,
    can_fuse_projection,
    project_sample,
)
from phenaki_tpu_torch.models.sampling_loop import remask_count
from phenaki_tpu_torch.ops.sampling import gumbel_sample, topk_mask

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _inputs(seed, b, n, d, v, scale=4.0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(b, n, d) * 0.2).astype(np.float32)
    w = (rng.randn(d, v) * (scale / np.sqrt(d))).astype(np.float32)  # flax (d, V)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    noise = rng.uniform(1e-6, 1 - 1e-6, size=(b, n, v)).astype(np.float32)
    return h, w, bias, noise


@pytest.mark.parametrize(
    "b, n, temperature, with_bias",
    [(1, 16, 0.5, True), (2, 9, 0.8, False), (1, 7, 0.0, True)],
    ids=["two_vocab_blocks", "odd_rows_no_bias", "zero_temperature"],
)
def test_matches_pallas_projection_kernel(b, n, temperature, with_bias):
    d, v = 128, 2048  # two of the TPU kernel's 1024-wide vocab blocks
    h, w, bias, noise = _inputs(b * 100 + n, b, n, d, v)
    bias = bias if with_bias else None
    ids_j, score_j = ps.project_gumbel_sample_with_score(
        jnp.asarray(h), jnp.asarray(w), None if bias is None else jnp.asarray(bias),
        seed=0, temperature=temperature, noise=jnp.asarray(noise),
    )
    ids_t, score_t = project_sample(
        torch.from_numpy(h), torch.from_numpy(w.T.copy()),
        None if bias is None else torch.from_numpy(bias), temperature,
        noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), atol=1e-5, rtol=0)


def test_generator_draws_are_seeded():
    h, w, bias, _ = _inputs(5, 1, 32, 128, 512, scale=1.0)
    args = (torch.from_numpy(h), torch.from_numpy(w.T.copy()), torch.from_numpy(bias), 1.0)
    a, _ = project_sample(*args, generator=torch.Generator().manual_seed(1))
    b, _ = project_sample(*args, generator=torch.Generator().manual_seed(1))
    c, _ = project_sample(*args, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_topk_mask_matches_jax_with_ties():
    rng = np.random.RandomState(3)
    scores = rng.randn(3, 40).astype(np.float32)
    scores[:, 5:15] = 0.25  # a block of ties straddling the cut
    scores[1, ::3] = -1e4
    for k in (1, 7, 12, 40):
        np.testing.assert_array_equal(
            topk_mask(torch.from_numpy(scores), k).numpy(),
            np.asarray(j_topk_mask(jnp.asarray(scores), k)),
        )
    kb = np.array([3, 9, 20])
    np.testing.assert_array_equal(
        topk_mask(torch.from_numpy(scores), torch.from_numpy(kb)).numpy(),
        np.asarray(j_topk_mask(jnp.asarray(scores), jnp.asarray(kb))),
    )


def test_remask_schedule_and_greedy_gumbel_sample():
    # the TPU loop's count (models/sampling_loop.py body), in f32 under XLA
    def j_count(step, steps, n):
        t = jnp.float32(step) / steps
        return int(jnp.clip(jnp.round(n * jnp.cos(t * np.pi * 0.5)).astype(jnp.int32), 1, n))

    for steps, n in ((18, 1152), (18, 2304), (6, 192), (4, 12)):
        assert [remask_count(s, steps, n) for s in range(steps)] == [
            j_count(s, steps, n) for s in range(steps)]
    logits = torch.from_numpy(np.random.RandomState(4).randn(3, 50).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(gumbel_sample(logits, 0.0, generator=gen), logits.argmax(-1))


def test_kernel_operand_checks_and_row_padding():
    assert can_fuse_projection(512, 65536)
    assert not can_fuse_projection(96, 1024)
    assert not can_fuse_projection(128, 256)
    h = torch.randn(2, 9, 128, dtype=torch.bfloat16)
    w = torch.randn(1024, 128, dtype=torch.bfloat16)
    flat, w2, bias, noise = _kernel_operands(h, w, torch.zeros(1024, dtype=torch.bfloat16),
                                             torch.rand(2, 9, 1024))
    assert flat.shape == (ROW_TILE, 128) and torch.equal(flat[:18], h.reshape(18, 128))
    assert torch.all(flat[18:] == 0)
    assert bias.dtype == torch.float32 and noise.shape == (18, 1024)
    with pytest.raises(ValueError):
        _kernel_operands(h.half(), w.half(), None, None)  # f32 or bf16 only
    with pytest.raises(ValueError):
        _kernel_operands(h.float(), w, None, None)  # one dtype
    with pytest.raises(ValueError):
        _kernel_operands(h[..., :96], w[:, :96], None, None)  # gate
    with pytest.raises(ValueError):
        _kernel_operands(h, w, torch.zeros(512), None)
    meta = torch.empty(1, 8, 128, device="meta")
    with pytest.raises(RuntimeError):
        project_sample(meta, torch.empty(1024, 128, device="meta"), None, 1.0)
