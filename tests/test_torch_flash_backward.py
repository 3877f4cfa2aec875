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
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.ops.positional import alibi_bias as j_alibi_bias  # noqa: E402
from phenaki_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_bwd_dbias_plain,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
)

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
    rng = np.random.RandomState({"bias": 0, "kmask": 1, "causal_alibi": 2, "ragged": 3}[name])
    b, h, d = 2, 2, 32
    i, j = {"bias": (128, 128), "kmask": (128, 130), "causal_alibi": (128, 192),
            "ragged": (120, 130)}[name]
    q, k = _qk(rng, b, h, i, d), _qk(rng, b, h, j, d)
    v = rng.randn(b, h, j, d).astype(np.float32)
    bias = kmask = None
    causal = name == "causal_alibi"
    if name in ("bias", "ragged"):
        bias = rng.randn(h, i, j).astype(np.float32)
    if name in ("kmask", "ragged"):
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


@pytest.mark.parametrize("name", ["bias", "kmask", "causal_alibi", "ragged"])
def test_plain_backward_matches_pallas_kernels(name):
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


def test_each_kernels_plain_version_matches_the_plain_backward():
    """The plain version of each backward kernel alone (the card's timing
    reference) gives that kernel's share of the plain backward, exactly."""
    q, k, v, bias, kmask, causal, dout = _case("ragged")
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
