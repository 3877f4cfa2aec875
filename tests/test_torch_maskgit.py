"""The port's MaskGit (phenaki_tpu_torch/models/maskgit.py) against the flax
module on bridged weights, fp32 on the CPU, atol 1e-4: the 3-D position bias
(`rel_pos_bias`), the logits forward, and the CFG forward in embedding
space (`embeds_with_cond_scale`) with a padded text mask.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.models.maskgit import MaskGit

torch.set_num_threads(1)

CFG = dict(dim=32, num_tokens=64, max_seq_len=64, depth=2, heads=2, dim_head=16, dim_context=16)
PATCH = (3, 2, 2)


@pytest.fixture(scope="module")
def models():
    jmod = JMaskGit(**CFG, scan_layers=True)
    variables = jit_init(jmod, jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32),
                         video_patch_shape=PATCH, context=jnp.zeros((1, 6, 16)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["params"]))
    return jmod, variables, load_flax_params(MaskGit(**CFG).eval(), params)


def _inputs(b):
    rng = np.random.RandomState(b)
    ids = rng.randint(0, 65, size=(b, 12))  # 64 is the mask id
    ctx = rng.randn(b, 6, 16).astype(np.float32)
    ctx[:, 4:] = 0.0
    return ids, ctx, np.any(ctx != 0, axis=-1)


def test_rel_pos_bias(models):
    jmod, variables, mod = models
    ref = jmod.apply(variables, PATCH, method=JMaskGit.rel_pos_bias)
    with torch.no_grad():
        out = mod.rel_pos_bias(PATCH)
    assert out.shape == (2, 12, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_logits_forward(models):
    jmod, variables, mod = models
    ids, ctx, mask = _inputs(2)
    ref = jmod.apply(variables, jnp.asarray(ids), video_patch_shape=PATCH,
                     context=jnp.asarray(ctx), text_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = mod(torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
                  text_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cond_scale", [1.0, 5.0])
def test_embeds_with_cond_scale(models, cond_scale):
    jmod, variables, mod = models
    ids, ctx, mask = _inputs(2)
    bias = jmod.apply(variables, PATCH, method=JMaskGit.rel_pos_bias)
    ref = jmod.apply(variables, jnp.asarray(ids), video_patch_shape=PATCH,
                     context=jnp.asarray(ctx), text_mask=jnp.asarray(mask),
                     cond_scale=cond_scale, attn_bias=bias,
                     method=JMaskGit.embeds_with_cond_scale)
    with torch.no_grad():
        out = mod.embeds_with_cond_scale(
            torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
            text_mask=torch.from_numpy(mask), cond_scale=cond_scale,
            attn_bias=mod.rel_pos_bias(PATCH))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
