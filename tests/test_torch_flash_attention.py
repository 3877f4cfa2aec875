"""The port's flash-attention module (phenaki_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against its plain XLA reference.

On a CPU tensor the wrapper takes its plain version, so these tests pin the
math contract the CUDA kernel is held to on the card (chip_smoke.py).
Inputs follow the kernel's contract: l2-normalised q/k times per-dim scales.
Tolerance: atol 2e-5, rtol 2e-5 (fp32, the JAX tests' own).

The card's route of the two forward entries (kernels 1 and 3) runs with the
C library stubbed (tests/_torch_card_stub.py): bf16 operands at d = 64 and
128 reach it contiguous, 16-byte aligned and with a bias row stride that is
a multiple of 8 (what the wgmma kernel's 16-byte copies need), copied where
they were not and never sent to the plain version; a ring chunk's aligned
bias slice is read in place; a failing launch raises.
"""

import numpy as np
import pytest
import torch
from _torch_card_stub import StubLibrary, stub_card

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.ops.positional import alibi_bias as j_alibi_bias  # noqa: E402
import phenaki_tpu_torch.ops.flash_attention as fa  # noqa: E402
from phenaki_tpu_torch import _build  # noqa: E402
from phenaki_tpu_torch.ops.attention import flash_applies, use_flash  # noqa: E402
from phenaki_tpu_torch.ops.flash_attention import (  # noqa: E402
    NEG_INF,
    _kernel_operands,
    flash_attention,
    flash_attention_plain,
)
from phenaki_tpu_torch.ops.positional import alibi_bias  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)


def _qk(rng, *shape):
    t = rng.randn(*shape).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return t * rng.uniform(0.5, 2.0, size=shape[-1]).astype(np.float32)


def _case(name):
    """"d128" is the 4 x 128 flagship's head size (the wgmma forward's d =
    128 kernel on the card) with a bias and a key mask at once, as its train
    step calls it."""
    rng = np.random.RandomState(0)
    b, h, d = (2, 2, 128) if name == "d128" else (1, 2, 32)
    i, j = {"bias": (128, 128), "kmask": (128, 130), "causal_alibi": (128, 192), "d128": (128, 130)}[name]
    q, k = _qk(rng, b, h, i, d), _qk(rng, b, h, j, d)
    v = rng.randn(b, h, j, d).astype(np.float32)
    bias = kmask = None
    causal = name == "causal_alibi"
    if name in ("bias", "d128"):
        bias = rng.randn(h, i, j).astype(np.float32)
    if name in ("kmask", "d128"):
        keep = rng.rand(b, j) > 0.3
        keep[:, :2] = True  # the null-KV columns are always attended
        kmask = np.where(keep, 0.0, NEG_INF).astype(np.float32)
    if causal:
        bias = np.array(j_alibi_bias(h, i, j))
    return q, k, v, bias, kmask, causal


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", ["bias", "kmask", "causal_alibi", "d128"])
def test_matches_pallas_kernel_and_reference(name):
    q, k, v, bias, kmask, causal = _case(name)
    out = flash_attention(*map(_t, (q, k, v, bias, kmask)), scale=8.0, causal=causal)
    ref_kernel = pa.flash_qk_attention(*map(_j, (q, k, v, bias, kmask)), 8.0, causal)
    ref_plain = pa._reference_attention(*map(_j, (q, k, v, bias, kmask)), scale=8.0, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_plain), **TOL)


@pytest.mark.parametrize("name", ["kmask", "d128"])
def test_lse_matches_pallas_forward(name):
    q, k, v, bias, kmask, causal = _case(name)
    _, lse = flash_attention(*map(_t, (q, k, v, bias, kmask)), scale=8.0, return_lse=True)
    _, ref = pa._flash_forward(*map(_j, (q, k, v, bias, kmask)), scale=8.0, causal=False,
                               return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref)[..., : q.shape[2], 0], **TOL)


def test_alibi_bias_matches_jax():
    np.testing.assert_array_equal(alibi_bias(8, 9, 9).numpy(), np.asarray(j_alibi_bias(8, 9, 9)))


def test_wrapper_gate_and_operand_checks():
    # the dispatch gate of ops/attention.py: shapes as in the TPU package,
    # and never on a CPU tensor
    assert flash_applies((2, 8, 1152, 64), torch.zeros(8, 1152, 1152))
    assert flash_applies((2, 8, 128, 128), None)
    assert not flash_applies((2, 8, 63, 64), None)
    assert not flash_applies((2, 8, 128, 129), None)
    assert not flash_applies((2, 8, 128, 64), torch.zeros(2, 8, 128, 128))
    assert not use_flash(torch.zeros(2, 8, 128, 64), None)

    q = torch.randn(2, 2, 70, 16, dtype=torch.bfloat16)
    k = torch.randn(2, 2, 130, 16, dtype=torch.bfloat16)
    bias = torch.randn(2, 130, 70).transpose(1, 2)  # f32, not contiguous
    kmask = torch.zeros(2, 130, dtype=torch.float64)
    _, _, _, b2, m2 = _kernel_operands(q, k, k, bias, kmask)
    assert b2.dtype == torch.bfloat16 and b2.is_contiguous()
    assert m2.dtype == torch.float32
    with pytest.raises(ValueError):
        _kernel_operands(q, k[:, :, :, :8], k, None, None)
    with pytest.raises(ValueError):
        _kernel_operands(q, k, k, bias[:, :, :129], None)
    with pytest.raises(ValueError):
        _kernel_operands(q, k, k, None, kmask[:1])
    with pytest.raises(ValueError):
        _kernel_operands(q.half(), k.half(), k.half(), None, None)
    big = torch.zeros(1, 1, 64, 160)
    with pytest.raises(ValueError):
        _kernel_operands(big, big, big, None, None)
    # a tensor that is neither on the CPU nor on a card has no kernel and
    # no fallback
    meta = torch.empty(1, 1, 64, 16, device="meta")
    with pytest.raises(RuntimeError):
        flash_attention(meta, meta, meta, scale=8.0)
    # bf16 on the CPU: the plain version, in the input dtype
    out = flash_attention(q, k, k, None, kmask, scale=8.0)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = flash_attention_plain(q.float(), k.float(), k.float(), None, kmask, scale=8.0)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the card's route of the forward entries, stubbed


def _no_plain(*args, **kwargs):
    raise AssertionError("an operand on the card's route reached the plain version")


def _misaligned(t):
    """A contiguous copy of `t` whose data starts one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _bf16_qkv(seed, b, h, i, j, d):
    rng = np.random.RandomState(seed)
    q, k = _qk(rng, b, h, i, d), _qk(rng, b, h, j, d)
    v = rng.randn(b, h, j, d).astype(np.float32)
    return tuple(torch.from_numpy(t).bfloat16() for t in (q, k, v)), rng


def _on_stub(lib, fn, *args, **kwargs):
    undo = stub_card(lib)
    try:
        return fn(*args, **kwargs)
    finally:
        undo()


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_forward_reaches_the_kernel_aligned_and_contiguous(monkeypatch, d):
    """q misaligned, k not contiguous, an f32 bias with rows of 130: all
    copied (the bias into rows of 136); v passed in place."""
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    (q, k, v), rng = _bf16_qkv(d, 2, 2, 70, 130, d)
    bias = torch.from_numpy(rng.randn(2, 70, 130).astype(np.float32))
    k_strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    lib = StubLibrary()
    out, lse = _on_stub(lib, flash_attention, _misaligned(q), k_strided, v, bias, None, scale=8.0,
                        return_lse=True)
    [(name, call)] = lib.calls
    assert name == "fwd" and (call["d"], call["j"], call["dtype"]) == (d, 130, 1)
    assert all(call[key] % 16 == 0 for key in ("q", "k", "v", "bias"))
    assert call["v"] == v.data_ptr() and call["ldb"] == 136
    for key, want in (("q", q), ("k", k), ("v", v), ("bias", bias.bfloat16())):
        assert torch.equal(call["data"][key], want), key
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and lse.shape == q.shape[:3]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 32)])
def test_cuda_core_forward_takes_the_bias_unpadded(monkeypatch, dtype, d):
    """f32, or bf16 at a d the wgmma kernel does not take: the CUDA-core
    kernel reads the bias contiguous with ldb = j = 130, not padded."""
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    (q, k, v), rng = _bf16_qkv(d + 2, 1, 2, 70, 130, d)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    bias = torch.from_numpy(rng.randn(2, 130, 70).astype(np.float32)).transpose(1, 2)
    lib = StubLibrary()
    _on_stub(lib, flash_attention, q, k, v, bias, None, scale=8.0)
    [(name, call)] = lib.calls
    assert name == "fwd" and call["ldb"] == 130 and call["dtype"] == _build.DTYPES[dtype]
    assert torch.equal(call["data"]["bias"], bias.to(dtype))


@pytest.mark.parametrize("d", [64, 128])
def test_chunk_bias_slice_read_in_place_when_aligned(monkeypatch, d):
    """A ring chunk's bias: the column slice at 64 of (h, i, 192) rows is
    passed in place with ldb 192; the slice at 3 (6 bytes past a 16-byte
    boundary) is copied into rows of 64."""
    monkeypatch.setattr(fa, "flash_attend_chunk_plain", _no_plain)
    (q, k, v), rng = _bf16_qkv(d + 1, 1, 2, 64, 64, d)
    rows = torch.from_numpy(rng.randn(2, 64, 192).astype(np.float32)).bfloat16()
    lib = StubLibrary()
    for start in (64, 3):
        view = rows[..., start:start + 64]
        acc, l = _on_stub(lib, fa.flash_attend_chunk, q, k, v, view, None, c2=torch.tensor(11.5),
                          scale=8.0, causal=True, offsets=(64, 0))
        call = lib.calls[-1][1]
        assert (call["q_off"], call["k_off"], call["d"], call["dtype"]) == (64, 0, d, 1)
        if start == 64:
            assert call["bias"] == view.data_ptr() and call["ldb"] == 192
        else:
            assert call["bias"] % 16 == 0 and call["ldb"] == 64
        assert torch.equal(call["data"]["bias"], view)
        assert acc.shape == q.shape and acc.dtype == torch.float32 and l.shape == q.shape[:3]
    assert fa.flash_attend_chunk.launches >= 2


def test_failing_forward_launch_raises():
    (q, k, v), _ = _bf16_qkv(7, 1, 2, 64, 64, 64)
    lib = StubLibrary(fail=True)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        _on_stub(lib, flash_attention, q, k, v, scale=8.0)
    assert [name for name, _ in lib.calls] == ["fwd"]


def test_operands_the_kernel_cannot_take_raise_before_the_card():
    (q, k, v), _ = _bf16_qkv(8, 1, 2, 64, 64, 64)
    lib = StubLibrary()
    with pytest.raises(ValueError):
        _on_stub(lib, flash_attention, q.half(), k.half(), v.half(), scale=8.0)
    with pytest.raises(ValueError):
        _on_stub(lib, flash_attention, q, k, v, torch.zeros(2, 64, 63), scale=8.0)
    with pytest.raises(ValueError):
        _on_stub(lib, fa.flash_attend_chunk, q, k[..., :32], v, c2=1.0, scale=8.0)
    assert lib.calls == []
