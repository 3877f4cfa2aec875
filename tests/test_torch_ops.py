"""The port's primitives against the flax modules on bridged weights, fp32 on
the CPU: LayerNorm (gamma only) and StandardLayerNorm, l2norm_scaled, the
GEGLU FeedForward, the 2-D and 3-D continuous position bias, PEG (with the
layer's residual, forward and gradients) in both layouts, and
LFQ.indices_to_codes. Tolerance atol 1e-5 (1e-4 for the
multi-layer blocks).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.ops.feedforward import FeedForward as JFeedForward  # noqa: E402
from phenaki_tpu.ops.norms import LayerNorm as JLayerNorm  # noqa: E402
from phenaki_tpu.ops.norms import StandardLayerNorm as JStandardLayerNorm  # noqa: E402
from phenaki_tpu.ops.norms import l2norm_scaled as j_l2norm_scaled  # noqa: E402
from phenaki_tpu.ops.positional import PEG as JPEG  # noqa: E402
from phenaki_tpu.ops.positional import ContinuousPositionBias as JCPB  # noqa: E402
from phenaki_tpu.ops.quantize import LFQ as JLFQ  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.ops.feedforward import FeedForward, ff_inner_dim
from phenaki_tpu_torch.ops.norms import LayerNorm, StandardLayerNorm, l2norm_scaled
from phenaki_tpu_torch.ops.positional import PEG, ContinuousPositionBias
from phenaki_tpu_torch.ops.quantize import LFQ

torch.set_num_threads(1)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(variables, seed):
    """Params with every leaf perturbed, so gamma/beta/scales are not trivial."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(np.float32),
        _numpy_tree(variables["params"]),
    )


def _compare(jmod, tmod, jargs, targs, atol, jkw=None, seed=0):
    params = _perturbed(jit_init(jmod, jax.random.PRNGKey(seed), *jargs, **(jkw or {})), seed)
    ref = np.asarray(jmod.apply({"params": params}, *jargs, **(jkw or {})))
    load_flax_params(tmod, params)
    with torch.no_grad():
        out = tmod(*targs)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)


def test_norms_and_l2norm():
    x = np.random.RandomState(1).randn(3, 7, 24).astype(np.float32) * 3 + 1
    _compare(JLayerNorm(24), LayerNorm(24), [jnp.asarray(x)], [torch.from_numpy(x)], 1e-5)
    _compare(JStandardLayerNorm(24), StandardLayerNorm(24), [jnp.asarray(x)],
             [torch.from_numpy(x)], 1e-5)
    scale = np.random.RandomState(2).randn(24).astype(np.float32)
    x[0, 0] = 0.0  # a zero vector stays zero
    np.testing.assert_allclose(
        l2norm_scaled(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_l2norm_scaled(jnp.asarray(x), jnp.asarray(scale))), atol=1e-6, rtol=0)


def test_feedforward():
    assert ff_inner_dim(512) == 1365
    x = np.random.RandomState(3).randn(2, 5, 48).astype(np.float32)
    _compare(JFeedForward(48), FeedForward(48), [jnp.asarray(x)], [torch.from_numpy(x)], 1e-5)


@pytest.mark.parametrize("dims", [(4, 3), (3, 4, 2)], ids=["2d", "3d"])
def test_continuous_position_bias(dims):
    jmod = JCPB(dim=16, heads=3, num_dims=len(dims))
    _compare(jmod, ContinuousPositionBias(16, 3, num_dims=len(dims)), list(dims), list(dims), 1e-5)


@pytest.mark.parametrize("causal, layout", [(False, "thw"), (True, "bhw_t")])
def test_peg(causal, layout):
    """PEG carries the layer's residual: the port's PEG(x) is JAX's PEG(x) + x,
    forward and every gradient (dx, the taps, the bias) at 1e-5."""
    b, t, h, w, d = 2, 3, 4, 2, 8
    rows, seq = (b, t * h * w) if layout == "thw" else (b * h * w, t)
    rng = np.random.RandomState(4)
    x = rng.randn(rows, seq, d).astype(np.float32)
    dy = rng.randn(rows, seq, d).astype(np.float32)
    jmod = JPEG(d, causal=causal, layout=layout)
    params = _perturbed(jit_init(jmod, jax.random.PRNGKey(0), jnp.asarray(x), shape=(b, t, h, w)), 0)

    def jax_peg(p, x_):
        return jmod.apply({"params": p}, x_, shape=(b, t, h, w)) + x_

    ref, vjp = jax.vjp(jax_peg, params, jnp.asarray(x))
    dparams, dx_ref = vjp(jnp.asarray(dy))

    tmod = load_flax_params(PEG(d, causal=causal, layout=layout), params)
    xx = torch.from_numpy(x).requires_grad_()
    out = tmod(xx, (b, t, h, w))
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(dx_ref), atol=1e-5, rtol=0)
    # JAX's parameter gradients in the port's layout, through the same bridge
    want = load_flax_params(PEG(d, causal=causal, layout=layout), _numpy_tree(dparams))
    np.testing.assert_allclose(tmod.weight.grad.numpy(), want.weight.detach().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tmod.bias.grad.numpy(), want.bias.detach().numpy(), atol=1e-5, rtol=0)


def test_lfq_indices_to_codes():
    jmod = JLFQ(dim=32, codebook_size=64)
    idx = np.random.RandomState(5).randint(0, 64, size=(2, 10))
    variables = jit_init(jmod, jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(idx), method=JLFQ.indices_to_codes))
    mod = load_flax_params(LFQ(32, 64), _numpy_tree(variables["params"]))
    with torch.no_grad():
        out = mod.indices_to_codes(torch.from_numpy(idx))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
