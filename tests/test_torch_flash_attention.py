"""The port's flash-attention module (phenaki_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against its plain XLA reference.

On a CPU tensor the wrapper takes its plain version, so these tests pin the
math contract the CUDA kernel is held to on the card (chip_smoke.py).
Inputs follow the kernel's contract: l2-normalised q/k times per-dim scales.
Tolerance: atol 2e-5, rtol 2e-5 (fp32, the JAX tests' own).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.ops.positional import alibi_bias as j_alibi_bias  # noqa: E402
from phenaki_tpu_torch.ops.attention import flash_applies, use_flash
from phenaki_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _kernel_operands,
    flash_attention,
    flash_attention_plain,
)
from phenaki_tpu_torch.ops.positional import alibi_bias

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
    rng = np.random.RandomState(0)
    b, h, d = 1, 2, 32
    i, j = {"bias": (128, 128), "kmask": (128, 130), "causal_alibi": (128, 192)}[name]
    q, k = _qk(rng, b, h, i, d), _qk(rng, b, h, j, d)
    v = rng.randn(b, h, j, d).astype(np.float32)
    bias = kmask = None
    causal = name == "causal_alibi"
    if name == "bias":
        bias = rng.randn(h, i, j).astype(np.float32)
    if name == "kmask":
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


@pytest.mark.parametrize("name", ["bias", "kmask", "causal_alibi"])
def test_matches_pallas_kernel_and_reference(name):
    q, k, v, bias, kmask, causal = _case(name)
    out = flash_attention(*map(_t, (q, k, v, bias, kmask)), scale=8.0, causal=causal)
    ref_kernel = pa.flash_qk_attention(*map(_j, (q, k, v, bias, kmask)), 8.0, causal)
    ref_plain = pa._reference_attention(*map(_j, (q, k, v, bias, kmask)), scale=8.0, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_plain), **TOL)


def test_lse_matches_pallas_forward():
    q, k, v, bias, kmask, causal = _case("kmask")
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
