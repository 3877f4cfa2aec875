"""The port's `Attention` block (phenaki_tpu_torch/ops/attention.py) against
the flax module on bridged weights, fp32 on the CPU, atol 1e-4: self-attention
with a bias and a key mask (the fused QKV), cross-attention with null-KV and
a padded text mask, causal self-attention with ALiBi, and the
`reference_self_kv` variant.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.ops.attention import Attention as JAttention  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.ops.attention import Attention

torch.set_num_threads(1)

DIM, HEADS, DIM_HEAD, CTX = 32, 2, 16, 24


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


CASES = {
    "self_bias_mask": dict(jax=dict(), port=dict(), context=False, bias=True, mask=True),
    "cross_null_kv": dict(jax=dict(dim_context=CTX, num_null_kv=2),
                          port=dict(dim_context=CTX, num_null_kv=2, cross=True),
                          context=True, bias=False, mask=True),
    "causal_alibi": dict(jax=dict(causal=True), port=dict(causal=True), context=False,
                         bias=False, mask=False),
    "reference_self_kv": dict(jax=dict(reference_self_kv=True),
                              port=dict(reference_self_kv=True), context=False, bias=True,
                              mask=False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_attention_matches_flax(name):
    case = CASES[name]
    rng = np.random.RandomState(0)
    b, n, m = 2, 12, 5
    x = rng.randn(b, n, DIM).astype(np.float32)
    context = rng.randn(b, m, CTX).astype(np.float32) if case["context"] else None
    j = m if case["context"] else n
    mask = (rng.rand(b, j) > 0.3) if case["mask"] else None
    if mask is not None:
        mask[1] = False  # a row whose keys are all masked (CFG's null branch)
        if not case["context"]:
            mask[1, 0] = True  # self-attention has no null-KV to fall back on
    bias = rng.randn(HEADS, n, n).astype(np.float32) if case["bias"] else None

    jmod = JAttention(dim=DIM, dim_head=DIM_HEAD, heads=HEADS, **case["jax"])
    jargs = [jnp.asarray(x), None if mask is None else jnp.asarray(mask),
             None if context is None else jnp.asarray(context),
             None if bias is None else jnp.asarray(bias)]
    variables = jit_init(jmod, jax.random.PRNGKey(1), *jargs)
    ref = np.asarray(jmod.apply(variables, *jargs))

    mod = load_flax_params(Attention(DIM, dim_head=DIM_HEAD, heads=HEADS, **case["port"]),
                           _numpy_tree(variables["params"]))
    with torch.no_grad():
        out = mod(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                  None if context is None else torch.from_numpy(context),
                  None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
