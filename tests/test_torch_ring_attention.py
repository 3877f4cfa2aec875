"""The port's ring attention (phenaki_tpu_torch/parallel/ring_attention.py)
and its chunk (TPU kernel 3's plain version) against the JAX package, fp32
on the CPU, with the Pallas kernels in interpret mode.

* `flash_attend_chunk` (a CPU tensor takes `flash_attend_chunk_plain`)
  against JAX `flash_attend_chunk`: acc = raw[..., :d], l = raw[..., d],
  with a bias, a key mask and causal global offsets (a chunk on the
  diagonal, one below it, one wholly above it); atol 2e-5. Its autograd
  gradients against `jax.vjp` of the JAX chunk for q, k, v and the bias;
  atol 5e-5.
* Rings over real process groups: gloo ranks started with the `spawn`
  method (`spawn_ranks`, one spawn per group size for the whole module).
  Two ranks run the kernel ring (n = 128: 64 local rows; forced on the CPU,
  where the chunk is its plain version) against JAX
  `sequence_sharded_attention` on a 2-device mesh, where the Pallas ring
  runs: bias with key mask, causal, bf16 (atol 2e-2), null K/V, and the
  q/k/v/bias gradients (atol 5e-5). Four ranks with 16 local rows run the
  plain online-softmax ring against JAX on a 4-device mesh.
* The card's routes with the C entry points stubbed (there is no card here):
  the ring launches the chunk kernel `sp` times, and the chunk's backward the
  three backward kernels, with each chunk's global offsets and the bias row
  stride; a failing launch raises; a CPU tensor never reaches a C entry.
* `spawn_ranks` carries each rank's result pickled by value (tensors
  included), so a rank may exit as soon as it has returned.

The rank functions import no JAX (a spawned rank imports this module by
name): JAX is imported inside the tests and fixtures only.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import phenaki_tpu_torch.ops.flash_attention as fa
import phenaki_tpu_torch.parallel.ring_attention as ra
from phenaki_tpu_torch import _build
from phenaki_tpu_torch.parallel.distributed import _rank_main, spawn_ranks

from _torch_card_stub import StubLibrary, stub_card

torch.set_num_threads(1)

SCALE = 8.0


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _qkv(seed, b=1, h=2, n=128, d=16):
    """Cosine attention's inputs: l2-normalised q and k, as the layers give them."""
    rng = np.random.RandomState(seed)
    return _unit(rng, b, h, n, d), _unit(rng, b, h, n, d), rng.randn(b, h, n, d).astype(np.float32), rng


@pytest.fixture
def interpret(monkeypatch):
    import phenaki_tpu.ops.pallas_attention as pa

    monkeypatch.setattr(pa, "_INTERPRET", True)
    return pa


# ---------------------------------------------------------------------------
# the chunk


CHUNK_CASES = {
    "bias_kmask": dict(causal=False, offsets=None),
    "causal_diagonal": dict(causal=True, offsets=(64, 64)),
    "causal_below": dict(causal=True, offsets=(64, 0)),
    "causal_above": dict(causal=True, offsets=(0, 64)),  # every key masked: acc = l = 0
}


def _chunk_inputs(seed):
    q, k, v, rng = _qkv(seed, b=2, n=64)
    bias = (rng.randn(2, 64, 64) * 0.3).astype(np.float32)
    kmask = np.where(rng.rand(2, 64) > 0.2, 0.0, fa.NEG_INF).astype(np.float32)
    c2 = np.float32(SCALE * fa.LOG2E)  # the bound of unit q and k
    return q, k, v, bias, kmask, c2, rng


def _jax_chunk(pa, q, k, v, bias, kmask, c2, causal, offsets):
    import jax.numpy as jnp

    offs = jnp.asarray(offsets, jnp.int32) if offsets is not None else None
    return pa.flash_attend_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                                 jnp.asarray(kmask), jnp.asarray(c2).reshape(1, 1), offs, SCALE,
                                 causal)


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_matches_pallas(interpret, case):
    q, k, v, bias, kmask, c2, _ = _chunk_inputs(1)
    kw = CHUNK_CASES[case]
    raw = np.asarray(_jax_chunk(interpret, q, k, v, bias, kmask, c2, **kw))
    acc, l = fa.flash_attend_chunk(*map(torch.from_numpy, (q, k, v, bias, kmask)),
                                   c2=torch.tensor(c2), scale=SCALE, **kw)
    assert acc.dtype == torch.float32 and acc.shape == q.shape and l.shape == q.shape[:3]
    np.testing.assert_allclose(acc.numpy(), raw[..., :16], atol=2e-5, rtol=0)
    np.testing.assert_allclose(l.numpy(), raw[..., 16], atol=2e-5, rtol=0)
    if case == "causal_above":
        assert not acc.any() and not l.any()


@pytest.mark.parametrize("case", ["bias_kmask", "causal_below"])
def test_chunk_grads_match_jax_vjp(interpret, case):
    import jax
    import jax.numpy as jnp

    q, k, v, bias, kmask, c2, rng = _chunk_inputs(2)
    kw = CHUNK_CASES[case]
    dacc = rng.randn(*q.shape).astype(np.float32)
    dl = rng.randn(*q.shape[:3]).astype(np.float32)
    cot = np.zeros((*q.shape[:3], 128), np.float32)  # the TPU's [acc | l | 0...] layout
    cot[..., :16], cot[..., 16] = dacc, dl

    def f(q_, k_, v_, b_):
        return _jax_chunk(interpret, q_, k_, v_, b_, kmask, c2, **kw)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, bias)))
    ref = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    acc, l = fa.flash_attend_chunk(*leaves, torch.from_numpy(kmask), c2=torch.tensor(c2),
                                   scale=SCALE, **kw)
    ((acc * torch.from_numpy(dacc)).sum() + (l * torch.from_numpy(dl)).sum()).backward()
    for name, t, r in zip("q k v bias".split(), leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# rings over real process groups (module-level rank functions: no JAX)


def _ring_inputs():
    """(q, k, v, bias, key mask, null k, null v) for the 2-rank cases."""
    q, k, v, rng = _qkv(10, b=2)
    bias = (rng.randn(2, 128, 128) * 0.3).astype(np.float32)
    mask = rng.rand(2, 128) > 0.2
    null_k = (_unit(rng, 2, 2, 2, 16) * 0.5).astype(np.float32)
    null_v = rng.randn(2, 2, 2, 16).astype(np.float32)
    cot = rng.randn(2, 2, 128, 16).astype(np.float32)
    return dict(q=q, k=k, v=v, bias=bias, mask=mask, null_k=null_k, null_v=null_v, cot=cot)


def _two_rank_cases(rank, world, x):
    """Every 2-rank case on the kernel ring (the chunk's plain version)."""
    ra._ring_use_flash = lambda *a: True
    t = {key: torch.from_numpy(val) for key, val in x.items()}
    q, k, v = t["q"], t["k"], t["v"]
    out = {}

    def ring(q_, k_, v_, **kw):
        return ra.sequence_sharded_attention(q_, k_, v_, dist.group.WORLD, scale=SCALE, **kw)

    out["bias_kmask"] = ring(q, k, v, attn_bias=t["bias"], key_mask=t["mask"]).numpy()
    out["causal"] = ring(q, k, v, causal=True).numpy()
    bf = ring(*(a.bfloat16() for a in (q, k, v)))
    out["bf16_dtype"] = str(bf.dtype)
    out["bf16"] = bf.float().numpy()
    out["null_kv"] = ring(q, k, v, null_k=t["null_k"], null_v=t["null_v"]).numpy()
    leaves = [a.clone().requires_grad_() for a in (q, k, v, t["bias"])]
    (ring(*leaves[:3], attn_bias=leaves[3]).sin() * t["cot"]).sum().backward()
    out["grads"] = [a.grad.numpy() for a in leaves]
    out["stub_card"] = _stubbed_ring_calls(t)
    return out


def _four_rank_cases(rank, world, x):
    """The plain ring: 64 tokens over 4 ranks, 16 local rows."""
    assert not ra._ring_use_flash(16, 16, torch.device("cpu"))
    t = {key: torch.from_numpy(val) for key, val in x.items()}
    group = dist.group.WORLD
    out = ra.sequence_sharded_attention(t["q"], t["k"], t["v"], group, scale=SCALE,
                                        attn_bias=t["bias"], key_mask=t["mask"])
    causal = ra.sequence_sharded_attention(t["q"], t["k"], t["v"], group, scale=SCALE, causal=True)
    return {"bias_kmask": out.numpy(), "causal": causal.numpy()}


def _stubbed_ring_calls(t):
    """A causal ring with a bias and its backward on a stubbed card: the
    C calls this rank made, and the chunk's launch count."""
    lib = StubLibrary()
    undo = stub_card(lib)
    fa.flash_attend_chunk.launches = 0
    try:
        leaves = [a.clone().requires_grad_() for a in (t["q"], t["k"], t["v"], t["bias"])]
        ra.sequence_sharded_attention(*leaves[:3], dist.group.WORLD, scale=SCALE, attn_bias=leaves[3],
                                      causal=True).sum().backward()
    finally:
        undo()
    return lib.calls, fa.flash_attend_chunk.launches


@pytest.fixture(scope="module")
def two_ranks():
    x = _ring_inputs()
    return x, spawn_ranks(_two_rank_cases, 2, x, backend="gloo", timeout=300)


@pytest.fixture(scope="module")
def jax_ring():
    """JAX `sequence_sharded_attention` over an sp-device mesh, the Pallas
    ring in interpret mode where it applies (64 local rows)."""
    import jax
    import phenaki_tpu.ops.pallas_attention as pa
    from phenaki_tpu.parallel.mesh import make_mesh
    from phenaki_tpu.parallel.ring_attention import sequence_sharded_attention

    def run(sp, q, k, v, **kw):
        mesh = make_mesh(jax.devices()[:sp], tp=1)
        return sequence_sharded_attention(q, k, v, mesh, scale=SCALE, **kw)

    saved, pa._INTERPRET = pa._INTERPRET, True  # for the module's tests (gradients lower late)
    yield run
    pa._INTERPRET = saved


def _both_ranks(results, key):
    a, b = (r[key] for r in results)
    np.testing.assert_array_equal(a, b)  # every rank holds the whole output
    return a


def test_two_rank_ring_with_bias_and_key_mask(two_ranks, jax_ring):
    import jax.numpy as jnp

    x, results = two_ranks
    ref = jax_ring(2, x["q"], x["k"], x["v"], attn_bias=x["bias"], key_mask=jnp.asarray(x["mask"]))
    np.testing.assert_allclose(_both_ranks(results, "bias_kmask"), np.asarray(ref), atol=2e-5, rtol=0)


def test_two_rank_ring_causal(two_ranks, jax_ring):
    x, results = two_ranks
    ref = jax_ring(2, x["q"], x["k"], x["v"], causal=True)
    np.testing.assert_allclose(_both_ranks(results, "causal"), np.asarray(ref), atol=2e-5, rtol=0)


def test_two_rank_ring_bf16(two_ranks, jax_ring):
    import jax.numpy as jnp

    x, results = two_ranks
    ref = jax_ring(2, *(jnp.asarray(x[n], jnp.bfloat16) for n in "qkv"))
    assert results[0]["bf16_dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(_both_ranks(results, "bf16"), np.asarray(ref, np.float32), atol=2e-2,
                               rtol=0)


def test_two_rank_ring_null_kv(two_ranks, jax_ring):
    x, results = two_ranks
    ref = jax_ring(2, x["q"], x["k"], x["v"], null_k=x["null_k"], null_v=x["null_v"])
    np.testing.assert_allclose(_both_ranks(results, "null_kv"), np.asarray(ref), atol=2e-5, rtol=0)


def test_two_rank_ring_grads(two_ranks, jax_ring):
    import jax
    import jax.numpy as jnp

    x, results = two_ranks

    def loss(q, k, v, bias):
        return jnp.sum(jnp.sin(jax_ring(2, q, k, v, attn_bias=bias)) * x["cot"])

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x[n]) for n in ("q", "k", "v", "bias")))
    for rank in results:
        for name, got, r in zip("q k v bias".split(), rank["grads"], ref):
            np.testing.assert_allclose(got, np.asarray(r), atol=5e-5, rtol=0, err_msg=name)


def _rank_tensor(rank, world):
    return torch.full((64,), float(rank))


def test_rank_results_travel_by_value(tmp_path):
    """A rank sends its result pickled by value, so the parent can read it
    after the rank has exited (a tensor sent through the queue's own pickler
    shares its storage by a file descriptor the parent must fetch from the
    live sender)."""
    sent = []

    class Queue:
        put = staticmethod(sent.append)

    _rank_main(_rank_tensor, 0, 1, str(tmp_path / "store"), "gloo", Queue(), ())
    [(rank, ok, payload)] = sent
    assert rank == 0 and ok and isinstance(payload, bytes) and not dist.is_initialized()
    assert torch.equal(pickle.loads(payload), torch.zeros(64))
    results = spawn_ranks(_rank_tensor, 2, backend="gloo", timeout=120)
    assert [r.tolist() for r in results] == [[0.0] * 64, [1.0] * 64]


def test_four_rank_plain_ring():
    import jax.numpy as jnp

    q, k, v, rng = _qkv(20, b=2, n=64)
    x = dict(q=q, k=k, v=v, bias=(rng.randn(2, 64, 64) * 0.3).astype(np.float32),
             mask=rng.rand(2, 64) > 0.25)
    results = spawn_ranks(_four_rank_cases, 4, x, backend="gloo", timeout=300)
    from phenaki_tpu.parallel.mesh import make_mesh
    from phenaki_tpu.parallel.ring_attention import sequence_sharded_attention
    import jax

    mesh = make_mesh(jax.devices()[:4], tp=1)
    ref = sequence_sharded_attention(q, k, v, mesh, scale=SCALE, attn_bias=x["bias"],
                                     key_mask=jnp.asarray(x["mask"]))
    ref_causal = sequence_sharded_attention(q, k, v, mesh, scale=SCALE, causal=True)
    for rank in results:
        np.testing.assert_allclose(rank["bias_kmask"], np.asarray(ref), atol=2e-5, rtol=0)
        np.testing.assert_allclose(rank["causal"], np.asarray(ref_causal), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the card's routes, stubbed


def test_stubbed_ring_launches_a_chunk_per_shard_with_global_offsets(two_ranks):
    """Rank r of 2, 64 rows each, causal: chunk 0 holds its own shard
    (k_off = 64 r), chunk 1 the other's; the bias slice is read with the
    row stride 128 in place. The backward runs dq, dkv and dbias for each
    chunk, in reverse order, with the same offsets."""
    _, results = two_ranks
    for rank, result in enumerate(results):
        calls, launches = result["stub_card"]
        assert launches == 2
        offsets = [(64 * rank, 64 * rank), (64 * rank, 64 * (1 - rank))]
        fwd = [c for c in calls if c[0] == "chunk"]
        assert [(c[1]["q_off"], c[1]["k_off"]) for c in fwd] == offsets
        assert all(c[1]["ldb"] == 128 and c[1]["i"] == c[1]["j"] == 64 and c[1]["causal"] for c in fwd)
        bwd = [c for c in calls if c[0] != "chunk"]
        assert [c[0] for c in bwd] == ["dq", "dkv", "dbias"] * 2
        assert [(c[1]["q_off"], c[1]["k_off"]) for c in bwd] == [offsets[1]] * 3 + [offsets[0]] * 3
        assert all(c[1]["ldb"] == 128 for c in bwd)


def test_failing_chunk_kernel_raises():
    lib = StubLibrary(fail=True)
    undo = stub_card(lib)
    try:
        q = torch.randn(1, 2, 64, 16)
        with pytest.raises(RuntimeError, match="flash_attend_chunk_fwd"):
            fa.flash_attend_chunk(q, q, q, c2=torch.tensor(1.0), scale=SCALE)
    finally:
        undo()
    assert len(lib.calls) == 1


def test_cpu_tensors_never_reach_a_c_entry(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", no_library)
    q, k, v, rng = _qkv(3, n=64)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    acc, l = fa.flash_attend_chunk(*leaves, torch.randn(2, 64, 64) * 0.1, c2=torch.tensor(11.5),
                                   scale=SCALE, causal=True, offsets=(0, 0))
    (acc.sum() + l.sum()).backward()
    assert all(t.grad is not None for t in leaves)
    with pytest.raises(RuntimeError, match="unsupported device"):
        fa.flash_attend_chunk(*(t.detach().to("meta") for t in leaves), c2=1.0, scale=SCALE)
