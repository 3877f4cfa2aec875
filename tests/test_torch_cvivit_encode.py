"""The port's C-ViViT encode side (phenaki_tpu_torch/models/cvivit.py)
against the flax module on bridged variables, fp32 on the CPU: an LFQ
C-ViViT and a cosine-VQ one (whose codebook crosses in `vq_stats`).

* `_to_patch_tokens` and `encode` within atol 1e-5 and 1e-4;
* `__call__`: recon within atol 1e-4, ids equal, aux loss within rtol 1e-5;
  `tokenize` equal to JAX's `tokenize`; an image (b, H, W, c); a masked
  `forward_intermediates` (recon, dec_tokens, aux loss); for the VQ, one
  `update_codebook` step's codebook and cluster sizes within atol 1e-5;
* `frames_per_num_tokens` and its refusal of a partial latent frame;
* the bridge: every flax leaf lands in the port and every port tensor has a
  leaf; an extra entry, or a VQ tree without its `vq_stats`, raises.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_cvivit_variables, load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT

torch.set_num_threads(1)

CFG = dict(dim=32, codebook_size=64, image_size=(16, 24), patch_size=8, temporal_patch_size=2,
           spatial_depth=2, temporal_depth=2, dim_head=16, heads=2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _models(lfq: bool):
    jmod = JCViViT(**CFG, lookup_free_quantization=lfq, scan_layers=True)
    variables = _numpy_tree(jit_init(jmod, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 24, 3))))
    mod = load_cvivit_variables(CViViT(**CFG, lookup_free_quantization=lfq), variables)
    return jmod, variables, mod


@pytest.fixture(scope="module", params=[True, False], ids=["lfq", "vq"])
def models(request):
    return _models(request.param)


def _video(b=2, f=5, seed=0):
    return np.random.RandomState(seed).rand(b, f, 16, 24, 3).astype(np.float32)


def test_patch_tokens_and_encode(models):
    jmod, variables, mod = models
    video = _video()
    ref = jmod.apply(variables, jnp.asarray(video), method=JCViViT._to_patch_tokens)
    with torch.no_grad():
        tokens = mod._to_patch_tokens(torch.from_numpy(video))
    assert tokens.shape == (2, 3, 2, 3, 32)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    enc_ref = jmod.apply(variables, ref, method=JCViViT.encode)
    with torch.no_grad():
        enc = mod.encode(torch.from_numpy(np.array(ref)))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=1e-4, rtol=0)


def test_forward_and_tokenize(models):
    jmod, variables, mod = models
    video = _video(seed=1)
    recon_j, ids_j, aux_j = jmod.apply(variables, jnp.asarray(video))
    with torch.no_grad():
        recon, ids, aux = mod(torch.from_numpy(video))
    assert recon.shape == video.shape and ids.shape == (2, 3, 2, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-5, atol=0)
    tok_j = jmod.apply(variables, jnp.asarray(video), method=JCViViT.tokenize)
    np.testing.assert_array_equal(mod.tokenize(torch.from_numpy(video)).numpy(), np.asarray(tok_j))
    with torch.no_grad():
        np.testing.assert_array_equal(mod(torch.from_numpy(video), return_only_codebook_ids=True).numpy(),
                                      np.asarray(tok_j))


def test_image_input(models):
    jmod, variables, mod = models
    image = _video(b=3, f=1, seed=2)[:, 0]
    recon_j, ids_j, aux_j = jmod.apply(variables, jnp.asarray(image))
    with torch.no_grad():
        recon, ids, aux = mod(torch.from_numpy(image))
    assert recon.shape == image.shape and ids.shape == (3, 1, 2, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-5, atol=0)


def test_masked_forward_intermediates(models):
    jmod, variables, mod = models
    video = _video(f=7, seed=3)
    mask = np.ones((2, 7), bool)
    mask[1, 3:] = False  # the second video's last two latent frames are padding
    ref = jmod.apply(variables, jnp.asarray(video), mask=jnp.asarray(mask),
                     method=JCViViT.forward_intermediates)
    with torch.no_grad():
        out = mod.forward_intermediates(torch.from_numpy(video), mask=torch.from_numpy(mask))
    assert not out["is_image"]
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref["indices"]))
    for key in ("recon_video", "dec_tokens"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["vq_aux_loss"].item(), float(ref["vq_aux_loss"]), rtol=1e-5, atol=0)


def test_vq_codebook_update():
    jmod, variables, _ = _models(False)
    video = _video(seed=4)
    _, new_state = jmod.apply(variables, jnp.asarray(video), update_codebook=True,
                              method=JCViViT.forward_intermediates, mutable=["vq_stats"])
    fresh = load_cvivit_variables(CViViT(**CFG, lookup_free_quantization=False), variables)
    with torch.no_grad():
        fresh.forward_intermediates(torch.from_numpy(video), update_codebook=True)
    new = _numpy_tree(new_state["vq_stats"]["vq"])
    np.testing.assert_allclose(fresh.vq.embed.numpy(), new["codebook"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(fresh.vq.cluster_size.numpy(), new["cluster_size"], atol=1e-5, rtol=0)


def test_frames_per_num_tokens(models):
    jmod, _, mod = models
    for frames in (1, 3, 5, 17):
        n = mod.num_tokens_per_frames(frames)
        assert mod.frames_per_num_tokens(n) == jmod.frames_per_num_tokens(n) == frames
    for bad in (0, 5):
        with pytest.raises(ValueError):
            mod.frames_per_num_tokens(bad)


def test_bridge_uses_every_leaf(models):
    jmod, variables, mod = models
    tree = dict(variables["params"])
    if "vq_stats" in variables:
        stats = variables["vq_stats"]["vq"]
        tree["vq"] = {"embed": stats["codebook"], "cluster_size": stats["cluster_size"]}
    assert sorted(flax_to_state_dict(tree)) == sorted(mod.state_dict())
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="land nowhere"):
        load_flax_params(CViViT(**CFG, lookup_free_quantization=jmod.lookup_free_quantization), extra)
    if "vq_stats" in variables:
        with pytest.raises(KeyError, match="lacks"):
            load_flax_params(CViViT(**CFG, lookup_free_quantization=False), variables["params"])
