"""The port's C-ViViT decode path (phenaki_tpu_torch/models/cvivit.py)
against the flax module on bridged weights, fp32 on the CPU, atol 1e-4:
`decode_from_codebook_indices` from flat and from (b, t, h, w) ids, and the
token/frame arithmetic. The encode side is in test_torch_cvivit_encode.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT

torch.set_num_threads(1)

CFG = dict(dim=32, codebook_size=64, image_size=(16, 24), patch_size=8, temporal_patch_size=2,
           spatial_depth=2, temporal_depth=2, dim_head=16, heads=2)


@pytest.fixture(scope="module")
def models():
    jmod = JCViViT(**CFG, scan_layers=True)
    variables = jit_init(jmod, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 24, 3)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["params"]))
    return jmod, variables, load_flax_params(CViViT(**CFG), params)


def test_shape_arithmetic(models):
    jmod, _, mod = models
    for frames in (1, 5, 17):
        assert mod.num_tokens_per_frames(frames) == jmod.num_tokens_per_frames(frames)
        assert mod.get_video_patch_shape(frames) == jmod.get_video_patch_shape(frames)
    with pytest.raises(ValueError):
        mod.num_tokens_per_frames(4)


@pytest.mark.parametrize("grid", [False, True], ids=["flat", "thw"])
def test_decode_from_codebook_indices(models, grid):
    jmod, variables, mod = models
    ids = np.random.RandomState(1).randint(0, 64, size=(2, 3 * 2 * 3))
    if grid:
        ids = ids.reshape(2, 3, 2, 3)
    ref = jmod.apply(variables, jnp.asarray(ids), method=JCViViT.decode_from_codebook_indices)
    with torch.no_grad():
        out = mod.decode_from_codebook_indices(torch.from_numpy(ids))
    assert out.shape == (2, 5, 16, 24, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
