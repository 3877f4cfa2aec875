"""The port's flash-attention backward (phenaki_tpu_torch/ops/flash_attention.py)
against the JAX package's backward kernels, run in interpret mode on the CPU.

`flash_attention_backward_plain` is held against `_flash_backward` (the
three Pallas kernels) on the same inputs and cotangent, and autograd through
the port's `flash_attention` against `jax.grad` of `flash_qk_attention`. On a
CPU tensor the wrapper's autograd Function takes the plain forward and the
plain backward, so these tests pin the math contract the CUDA kernels are
held to on the card (chip_smoke.py). Tolerance: atol 1e-3 on O(1)
gradients, fp32, the JAX tests' own (recomputing p from the saved lse is a
different f32 rounding path from one-shot autodiff).

The card's route of the three backward entries runs here with the C
library stubbed (`_torch_card_stub`): the operands the dQ, dK/dV and dBias
kernels move in 16-byte copies (q, k, v, the bias and dO) reach them aligned
and contiguous, a ring chunk's bias slice is read in place where its row
stride is a multiple of 8 and copied otherwise, a failing launch
raises, a CPU tensor never reaches a C entry, and each launch counts once.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
import phenaki_tpu_torch.ops.flash_attention as fa  # noqa: E402
from phenaki_tpu.ops.positional import alibi_bias as j_alibi_bias  # noqa: E402
from phenaki_tpu_torch import _build  # noqa: E402
from phenaki_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_bwd_dbias_plain,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
)

from _torch_card_stub import StubLibrary, stub_card  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-3, rtol=0)
SCALE = 8.0


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)


def _qk(rng, *shape):
    t = rng.randn(*shape).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return t * rng.uniform(0.5, 2.0, size=shape[-1]).astype(np.float32)


def _case(name):
    """(q, k, v, bias, kmask, causal, dout) made with numpy from a seed."""
    rng = np.random.RandomState({"bias": 0, "kmask": 1, "causal_alibi": 2, "ragged": 3, "d128": 4}[name])
    b, h, d = 2, 2, 128 if name == "d128" else 32
    i, j = {"bias": (128, 128), "kmask": (128, 130), "causal_alibi": (128, 192),
            "ragged": (120, 130), "d128": (128, 130)}[name]
    q, k = _qk(rng, b, h, i, d), _qk(rng, b, h, j, d)
    v = rng.randn(b, h, j, d).astype(np.float32)
    bias = kmask = None
    causal = name == "causal_alibi"
    if name in ("bias", "ragged", "d128"):
        bias = rng.randn(h, i, j).astype(np.float32)
    if name in ("kmask", "ragged", "d128"):
        keep = rng.rand(b, j) > 0.3
        keep[:, :2] = True  # the null-KV columns are always attended
        kmask = np.where(keep, 0.0, NEG_INF).astype(np.float32)
    if causal:
        bias = np.array(j_alibi_bias(h, i, j))
    dout = rng.randn(b, h, i, d).astype(np.float32)
    return q, k, v, bias, kmask, causal, dout


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _no_plain(*args, **kwargs):
    raise AssertionError("an operand on the card's route reached the plain version")


@pytest.mark.parametrize("name", ["bias", "kmask", "causal_alibi", "ragged", "d128"])
def test_plain_backward_matches_pallas_kernels(name):
    """The plain backward against the Pallas kernels; "d128" is the 4 heads x
    128 head size (a bias, a key mask, ragged keys), at which the card holds
    its dQ, dK/dV and dBias kernels against these plain versions."""
    q, k, v, bias, kmask, causal, dout = _case(name)
    jargs = list(map(_j, (q, k, v, bias, kmask)))
    jout, jlse = pa._flash_forward(*jargs, scale=SCALE, causal=causal, return_lse=True)
    ref = pa._flash_backward(*jargs, jout, jlse, jnp.asarray(dout), scale=SCALE, causal=causal)

    targs = list(map(_t, (q, k, v, bias, kmask)))
    out, lse = flash_attention(*targs, scale=SCALE, causal=causal, return_lse=True)
    got = flash_attention_backward_plain(*targs, out, lse, _t(dout), scale=SCALE, causal=causal)
    for name_, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None, name_
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL, err_msg=name_)


@pytest.mark.parametrize("name", ["ragged", "d128"])
def test_each_kernels_plain_version_matches_the_plain_backward(name):
    """The plain version of each backward kernel alone (the card's timing
    reference and yardstick) gives that kernel's share of the plain
    backward, exactly: at d = 32 and at the 4 heads x 128 head size."""
    q, k, v, bias, kmask, causal, dout = _case(name)
    targs = list(map(_t, (q, k, v, bias, kmask)))
    out, lse = flash_attention(*targs, scale=SCALE, causal=causal, return_lse=True)
    args = (*targs, out, lse, _t(dout))
    dq, dk, dv, dbias = flash_attention_backward_plain(*args, scale=SCALE, causal=causal)
    assert torch.equal(flash_attention_bwd_dq_plain(*args, scale=SCALE, causal=causal), dq)
    got_dk, got_dv = flash_attention_bwd_dkv_plain(*args, scale=SCALE, causal=causal)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert torch.equal(flash_attention_bwd_dbias_plain(*args, scale=SCALE, causal=causal), dbias)


@pytest.mark.parametrize("name", ["bias", "ragged"])
def test_autograd_matches_jax_grad(name):
    q, k, v, bias, kmask, causal, dout = _case(name)

    def loss(q_, k_, v_, bias_):
        out = pa.flash_qk_attention(q_, k_, v_, bias_, _j(kmask), SCALE, causal)
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(_j, (q, k, v, bias)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = flash_attention(*leaves, _t(kmask), scale=SCALE, causal=causal)
    assert out.grad_fn is not None
    (out * _t(dout)).sum().backward()
    for name_, t, r in zip(("dq", "dk", "dv", "dbias"), leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL, err_msg=name_)


def test_fully_masked_row_has_zero_gradients_and_kmask_none():
    q, k, v, bias, kmask, causal, dout = _case("kmask")
    kmask = kmask.copy()
    kmask[1] = NEG_INF  # batch row 1 attends no key at all
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    km = torch.from_numpy(kmask).requires_grad_()
    out, lse = flash_attention(*leaves, None, km, scale=SCALE, return_lse=True)
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    (out * _t(dout)).sum().backward()
    dq, dk, dv = (t.grad for t in leaves)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
        assert torch.equal(g[1], torch.zeros_like(g[1]))
    assert dq[0].abs().max() > 0
    assert km.grad is None  # the kmask takes no gradient, as in the TPU package


def test_no_gradient_without_grad_inputs():
    q, k, v, bias, kmask, causal, dout = _case("bias")
    out = flash_attention(*map(_t, (q, k, v, bias)), scale=SCALE)
    assert out.grad_fn is None
    # a bias that needs no gradient is not differentiated
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, _t(bias), scale=SCALE)
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)


# ---------------------------------------------------------------------------
# the card's route of the backward entries, stubbed


def _misaligned(t):
    """A contiguous copy of `t` whose data starts one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _on_stub(lib, fn, *args, **kwargs):
    undo = stub_card(lib)
    try:
        return fn(*args, **kwargs)
    finally:
        undo()


def _bf16_case(d, i=70, j=130, seed=0):
    """bf16 q, k, v (2, 2, i|j, d), an f32 (2, i, j) bias and a dO, from a seed."""
    rng = np.random.RandomState(seed)
    q, k = _qk(rng, 2, 2, i, d), _qk(rng, 2, 2, j, d)
    v, do = rng.randn(2, 2, j, d), rng.randn(2, 2, i, d)
    bias = torch.from_numpy(rng.randn(2, i, j).astype(np.float32))
    return [torch.from_numpy(np.asarray(t, np.float32)).bfloat16() for t in (q, k, v, do)] + [bias]


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_backward_reaches_the_kernels_aligned_and_contiguous(monkeypatch, d):
    """Operands as the forward prepared them (the f32 bias copied into bf16
    rows of 136) and a dO view one element past a 16-byte boundary: every
    backward entry reads 16-byte aligned, contiguous operands, dO copied,
    the bias read in place with ldb = 136. No plain version runs."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    q, k, v, do, bias = _bf16_case(d)
    lib = StubLibrary()
    ops = _on_stub(lib, fa._kernel_operands, q, k, v, bias, None)
    out = torch.randn(q.shape).bfloat16()
    lse = torch.zeros(q.shape[:3])
    dq, dk, dv, dbias = _on_stub(lib, fa.flash_attention_backward, *ops, out, lse, _misaligned(do),
                                 scale=SCALE)
    assert [name for name, _ in lib.calls] == ["dq", "dkv", "dbias"]
    for name, call in lib.calls:
        assert all(call[key] % 16 == 0 for key in ("q", "k", "v", "bias", "do")), name
        assert (call["d"], call["dtype"], call["ldb"], call["q_off"], call["k_off"]) == (d, 1, 136, 60, 0)
        assert call["bias"] == ops[3].data_ptr()
        for key, want in (("q", q), ("k", k), ("v", v), ("bias", bias.bfloat16()), ("do", do)):
            assert torch.equal(call["data"][key], want), (name, key)
    assert dq.dtype == torch.bfloat16 and dk.shape == k.shape and dbias.dtype == torch.float32


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dacc_dtype", [torch.float32, torch.bfloat16])
def test_ring_chunk_backward_reads_its_bias_slice_in_place(monkeypatch, dacc_dtype, d):
    """A ring chunk's backward (d = 64 and 128): the bias slice at column 64
    of (h, i, 192) rows is read in place with ldb 192, at the chunk's global
    offsets; its d(acc) (f32, or a misaligned bf16 view) reaches dq and dkv
    as an aligned, contiguous bf16 dO; lse = c2 ln 2."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    q, k, v, _, _ = _bf16_case(d, 64, 64, seed=1)
    rows = torch.randn(2, 64, 192).bfloat16()
    dacc = torch.randn(q.shape)
    dacc_in = dacc if dacc_dtype == torch.float32 else _misaligned(dacc.bfloat16())
    lib = StubLibrary()
    _on_stub(lib, fa.flash_attend_chunk_backward, q, k, v, rows[..., 64:128], None,
             torch.tensor([11.5]), dacc_in, torch.randn(q.shape[:3]), scale=SCALE, causal=True,
             offsets=(64, 0))
    assert [name for name, _ in lib.calls] == ["dq", "dkv", "dbias"]
    for name, call in lib.calls:
        assert call["bias"] == rows[..., 64:128].data_ptr() and call["ldb"] == 192, name
        assert (call["q_off"], call["k_off"], call["causal"], call["d"]) == (64, 0, 1, d)
        assert call["do"] % 16 == 0 and torch.equal(call["data"]["do"], dacc.bfloat16())
        assert torch.equal(call["data"]["bias"], rows[..., 64:128])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("row_width", [192, 190])
def test_bf16_dbias_reaches_its_kernel_aligned(monkeypatch, row_width, d):
    """The wgmma dBias entry (d = 64 and 128) through a ring chunk as its
    Function prepares it: q, k, v one element past a 16-byte boundary arrive
    aligned; the bias slice at column 64 of (h, i, row_width) rows is read
    in place when its row stride is a multiple of 8 (192: ldb 192), and
    copied into rows padded to a multiple of 8 otherwise (190: ldb 64).
    Either way the kernel reads the slice, at the chunk's global offsets."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    q, k, v, _, _ = _bf16_case(d, 64, 64, seed=6)
    rows = torch.randn(2, 64, row_width).bfloat16()
    lib = StubLibrary()
    ops = _on_stub(lib, fa._chunk_operands, *(_misaligned(t) for t in (q, k, v)), rows[..., 64:128],
                   None, torch.tensor([11.5]))
    _on_stub(lib, fa.flash_attend_chunk_backward, *ops, torch.randn(q.shape), torch.randn(q.shape[:3]),
             scale=SCALE, causal=True, offsets=(64, 0))
    assert [name for name, _ in lib.calls] == ["dq", "dkv", "dbias"]
    call = lib.calls[-1][1]
    assert all(call[key] % 16 == 0 for key in ("q", "k", "v", "bias", "do"))
    in_place = row_width % 8 == 0
    assert call["ldb"] == (row_width if in_place else 64) and call["ldb"] % 8 == 0
    assert (call["bias"] == rows[..., 64:128].data_ptr()) == in_place
    assert (call["q_off"], call["k_off"], call["causal"], call["dtype"], call["d"]) == (64, 0, 1, 1, d)
    for key, want in (("q", q), ("k", k), ("v", v), ("bias", rows[..., 64:128])):
        assert torch.equal(call["data"][key], want), key


def test_cuda_core_backward_takes_do_in_place(monkeypatch):
    """f32 is not on the wgmma route: a misaligned dO is passed as it is."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    q, k, v, do, _ = (t.float() for t in _bf16_case(64, 64, 64, seed=2))
    do = _misaligned(do)
    lib = StubLibrary()
    _on_stub(lib, fa.flash_attention_backward, q, k, v, None, None, torch.zeros(q.shape),
             torch.zeros(q.shape[:3]), do, scale=SCALE)
    assert [name for name, _ in lib.calls] == ["dq", "dkv"]
    assert all(call["do"] == do.data_ptr() and call["dtype"] == 0 for _, call in lib.calls)


@pytest.mark.parametrize("entry", ["dq", "dkv", "dbias"])
def test_failing_backward_launch_raises(entry):
    q, k, v, do, bias = _bf16_case(64, 64, 64, seed=3)
    fn = getattr(fa, f"flash_attention_bwd_{entry}")
    lib = StubLibrary(fail=True)
    with pytest.raises(RuntimeError, match=f"flash_attention_bwd_{entry}"):
        _on_stub(lib, fn, q, k, v, bias.bfloat16(), None, do, torch.zeros(q.shape[:3]),
                 torch.zeros(q.shape[:3]), scale=SCALE)
    assert [name for name, _ in lib.calls] == [entry]


def test_backward_launch_counters_move_once_a_kernel():
    """Autograd through the Function on the stubbed card: one forward, then
    one dq, dkv and dbias launch; a bias that needs no gradient skips dbias."""
    q, k, v, do, bias = _bf16_case(64, 64, 64, seed=4)
    names = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dbias")
    for bias_grad, want in ((True, (1, 1, 1, 1)), (False, (1, 1, 1, 0))):
        before = [getattr(fa, n).launches for n in names]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        b = bias.clone().requires_grad_(bias_grad)
        lib = StubLibrary()
        undo = stub_card(lib)
        try:
            fa.flash_attention(*leaves, b, scale=SCALE).backward(do)
        finally:
            undo()
        assert tuple(getattr(fa, n).launches - c for n, c in zip(names, before)) == want
        assert all(t.grad is not None for t in leaves) and (b.grad is not None) == bias_grad


def test_cpu_backward_never_reaches_a_c_entry(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", no_library)
    q, k, v, do, bias = _bf16_case(64, 64, 64, seed=5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    fa.flash_attention(*leaves, scale=SCALE).backward(do)
    assert all(t.grad is not None and t.grad.dtype == t.dtype for t in leaves)
