"""The port's logits-path sampler and the sampling routes on the card
(phenaki_tpu_torch/ops/fused_sampling.py) against the JAX package.

* `gumbel_sample_with_score` (kernel 10's plain version, which a CPU tensor
  takes) against `gumbel_sample_with_score` of the JAX package run in
  interpret mode with the same injected uniforms: no CFG, stacked CFG with a
  row count that is a multiple of the TPU row block and one that is not
  (the JAX wrapper then combines in XLA), temperature 0, an odd vocab. Ids
  exactly, scores within atol 1e-5 (fp32).
* `project_sample` against `project_gumbel_sample_with_score` for a shape
  outside the fused gate (d = 96, V = 5000), where both materialise the
  logits.
* The routes a CUDA tensor takes, with the C entry points stubbed (there is
  no card here): every shape `can_fuse_projection` admits launches the
  projection kernel, d = 1024 included; any other shape, and the logits
  path, launch the logits-path kernel; the decode loop never takes a plain
  sampler.
"""

import ctypes

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_sampling as ps  # noqa: E402
import phenaki_tpu_torch.ops.fused_sampling as fs  # noqa: E402
from phenaki_tpu_torch import _build  # noqa: E402
from phenaki_tpu_torch.models.sampling_loop import maskgit_sample_loop  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _logits(seed, shape, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * scale).astype(np.float32)
    return logits, rng


@pytest.mark.parametrize(
    "bb, n, v, cond_scale, temperature",
    [(2, 16, 512, None, 0.9), (4, 8, 1024, 5.0, 0.7), (2, 9, 512, 3.0, 1.0),
     (1, 8, 512, None, 0.0), (2, 5, 1001, 5.0, 0.6)],
    ids=["no_cfg", "cfg_rows_multiple_of_8", "cfg_rows_not_multiple_of_8", "zero_temperature",
         "odd_vocab"],
)
def test_matches_pallas_sampling_kernel(bb, n, v, cond_scale, temperature):
    logits, rng = _logits(bb * 1000 + n + v, (bb, n, v))
    b = bb // 2 if cond_scale is not None else bb
    noise = rng.uniform(1e-6, 1 - 1e-6, size=(b, n, v)).astype(np.float32)
    ids_j, score_j = ps.gumbel_sample_with_score(jnp.asarray(logits), 0, temperature,
                                                 noise=jnp.asarray(noise), cond_scale=cond_scale)
    ids_t, score_t = fs.gumbel_sample_with_score(torch.from_numpy(logits), temperature,
                                                 cond_scale=cond_scale, noise=torch.from_numpy(noise))
    assert ids_t.dtype == torch.int64 and ids_t.shape == (b, n)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), atol=1e-5, rtol=0)


def test_project_sample_outside_the_gate_matches_jax():
    d, v = 96, 5000
    assert not fs.can_fuse_projection(d, v)
    rng = np.random.RandomState(9)
    h = (rng.randn(2, 7, d) * 0.3).astype(np.float32)
    w = (rng.randn(d, v) * (4.0 / np.sqrt(d))).astype(np.float32)  # flax (d, V)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    noise = rng.uniform(1e-6, 1 - 1e-6, size=(2, 7, v)).astype(np.float32)
    ids_j, score_j = ps.project_gumbel_sample_with_score(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias), 0, 0.8, noise=jnp.asarray(noise))
    ids_t, score_t = fs.project_sample(torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                                       torch.from_numpy(bias), 0.8, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), atol=1e-5, rtol=0)


def test_plain_draws_follow_the_generator():
    logits = torch.from_numpy(_logits(3, (2, 6, 300), scale=1.0)[0])
    draw = [fs.gumbel_sample_with_score(logits, 1.0, cond_scale=2.0,
                                        generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    with pytest.raises(ValueError, match="even"):
        fs.gumbel_sample_with_score(torch.randn(3, 2, 8), 1.0, cond_scale=2.0)
    with pytest.raises(RuntimeError):  # neither the CPU nor a card
        fs.gumbel_sample_with_score(torch.empty(2, 2, 8, device="meta"), 1.0)


# ---------------------------------------------------------------------------
# the routes of a CUDA tensor, with the C entry points stubbed


class _StubLibrary:
    """Records each C call; writes zeros to its ids and scores."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _zero(ids, score, rows):
        ctypes.memset(ids.value, 0, 4 * rows)
        ctypes.memset(score.value, 0, 4 * rows)

    def proj_sample(self, h, w, bias, noise, ids, score, partials, rows, d, v, splits, temperature,
                    seed, dtype, stream):
        self.calls.append(("proj_sample", dict(rows=rows, d=d, v=v, splits=splits, dtype=dtype,
                                               bias=bool(bias.value), noise=bool(noise.value))))
        self._zero(ids, score, rows)
        return 0

    def gumbel_sample(self, logits, noise, ids, score, rows, v, inv_temp, has_cfg, cond_scale, seed,
                      dtype, stream):
        self.calls.append(("gumbel_sample", dict(rows=rows, v=v, dtype=dtype, has_cfg=has_cfg,
                                                 cond_scale=cond_scale, inv_temp=inv_temp,
                                                 noise=bool(noise.value))))
        self._zero(ids, score, rows)
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(fs, "_on_card", lambda t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    for fn in (fs.project_sample, fs.gumbel_sample_with_score):
        monkeypatch.setattr(fn, "launches", 0)
    return lib


@pytest.mark.parametrize("d, v", [(128, 512), (512, 65536), (768, 1536), (1024, 1024), (2048, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_gated_shape_launches_the_projection_kernel(stub_card, d, v, dtype):
    assert fs.can_fuse_projection(d, v)
    h = torch.randn(1, 70, d).to(dtype)
    w = torch.randn(v, d).to(dtype)
    ids, score = fs.project_sample(h, w, torch.zeros(v), 0.5, generator=torch.Generator().manual_seed(0))
    assert ids.shape == (1, 70) and ids.dtype == torch.int64 and score.dtype == torch.float32
    assert stub_card.calls == [("proj_sample", dict(rows=70, d=d, v=v, splits=fs.vocab_splits(70, v, dtype),
                                                    dtype=_build.DTYPES[dtype], bias=True, noise=False))]
    assert fs.project_sample.launches == 1 and fs.gumbel_sample_with_score.launches == 0


@pytest.mark.parametrize("d", [512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scratch_holds_one_partial_per_vocab_split(stub_card, monkeypatch, d, dtype):
    """The wrapper's scratch is (rows, S, 5) for the S it passes: bf16 one
    partial per (row, vocab split), S picked so that the (row tiles, S) grid
    is one wave of 132 SMs at the flagship rows; f32 one per 64-id chunk."""
    made, partials = [], fs._partials
    monkeypatch.setattr(fs, "_partials", lambda *args: made.append(partials(*args)) or made[-1])
    rows, v = 1152, 65536
    fs.project_sample(torch.zeros(1, rows, d, dtype=dtype), torch.empty(v, d, dtype=dtype), None, 1.0,
                      generator=torch.Generator().manual_seed(0))
    splits = stub_card.calls[0][1]["splits"]
    assert len(made) == 1 and made[0].shape == (rows, splits, 5) and made[0].dtype == torch.float32
    if dtype == torch.bfloat16:
        assert splits == 14 and -(-rows // fs.ROW_TILE) * splits <= 132
        assert fs.vocab_splits(4608, v, dtype) == 11  # the critic train rows: 396 blocks, 3 waves
        assert fs.vocab_splits(7, 512, dtype) == 512 // fs.VOCAB_TILE  # at most one split a tile
    else:
        assert splits == v // fs.F32_VOCAB_CHUNK


def test_ungated_projection_and_logits_path_launch_the_sampling_kernel(stub_card):
    h, w = torch.randn(2, 7, 96), torch.randn(5000, 96)
    noise = torch.rand(2, 7, 5000)
    fs.project_sample(h, w, None, 0.8, noise=noise)
    stacked = torch.randn(4, 9, 1001, dtype=torch.bfloat16)
    fs.gumbel_sample_with_score(stacked, 0.0, cond_scale=5.0, generator=torch.Generator().manual_seed(0))
    assert [c[0] for c in stub_card.calls] == ["gumbel_sample", "gumbel_sample"]
    first, second = stub_card.calls[0][1], stub_card.calls[1][1]
    assert first == dict(rows=14, v=5000, dtype=0, has_cfg=0, cond_scale=0.0,
                         inv_temp=pytest.approx(1.25), noise=True)
    assert second["rows"] == 18 and second["v"] == 1001 and second["dtype"] == 1
    assert second["has_cfg"] == 1 and second["cond_scale"] == 5.0 and not second["noise"]
    assert second["inv_temp"] == pytest.approx(1e10)
    assert fs.gumbel_sample_with_score.launches == 2 and fs.project_sample.launches == 0
    with pytest.raises(ValueError, match="float16"):
        fs.gumbel_sample_with_score(stacked.half(), 1.0)
    with pytest.raises(ValueError, match="noise"):
        fs.gumbel_sample_with_score(stacked, 1.0, noise=torch.rand(4, 9, 1000))


@pytest.mark.parametrize("d, v", [(128, 1024), (96, 1000)], ids=["gated", "ungated"])
def test_decode_loop_launches_a_kernel_every_step(stub_card, d, v):
    """Both loop paths on a (stubbed) card: no step takes a plain sampler."""
    steps = 4
    w = torch.randn(v, d)
    maskgit_sample_loop(batch=2, num_tokens_seq=6, mask_id=v, device="cpu", steps=steps,
                        embeds_fn=lambda ids: torch.randn(ids.shape[0], ids.shape[1], d),
                        vocab_proj=(w, None), generator=torch.Generator().manual_seed(0))
    maskgit_sample_loop(lambda ids: torch.randn(2 * ids.shape[0], ids.shape[1], v),
                        stacked_cfg_scale=3.0, batch=2, num_tokens_seq=6, mask_id=v, device="cpu",
                        steps=steps, generator=torch.Generator().manual_seed(0))
    kernel = "proj_sample" if fs.can_fuse_projection(d, v) else "gumbel_sample"
    assert [c[0] for c in stub_card.calls] == [kernel] * steps + ["gumbel_sample"] * steps
