"""The sampling slice end to end: `Phenaki.sample` in the JAX package and in
the PyTorch port on the same bridged weights, fp32 on the CPU.

At starting_temperature=0 both samplers are greedy (the gumbel noise is
negligible against logits / 1e-10), so no shared random stream is needed:
the token ids must agree exactly and the decoded video within atol 1e-4.
The JAX side uses `scan_layers=True`, so the bridge's unstacking of the
stacked layer trees is on the path.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.models.sampling_loop import maskgit_sample_loop as j_loop  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki

torch.set_num_threads(1)

TEXT_DIM, TEXT_LEN, FRAMES, STEPS, COND_SCALE = 16, 6, 5, 4, 5.0
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=2, temporal_depth=2, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=64, depth=2, heads=2, dim_head=16,
               dim_context=TEXT_DIM)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def models():
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   steps=STEPS, text_embed_dim=TEXT_DIM, max_text_len=TEXT_LEN)
    jph.init(jax.random.PRNGKey(1))

    cv = load_flax_params(CViViT(**CVIVIT), _numpy_tree(cv_vars["params"]))
    mg = load_flax_params(MaskGit(**MASKGIT), _numpy_tree(jph.params["maskgit"]))
    tph = Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, steps=STEPS,
                  max_text_len=TEXT_LEN)
    return jph, tph


def _text_embeds(b, seed):
    emb = np.random.RandomState(seed).randn(b, 4, TEXT_DIM).astype(np.float32)
    emb[:, 3:] = 0.0  # padding rows; pad_text_embeds adds two more
    return emb


def _jax_ids(jph, emb):
    """The JAX sample program's decode loop (models/phenaki.py
    _build_sample_fn without primes or critic), returning the ids."""
    mg, params = jph.maskgit, {"params": jph.params["maskgit"]}
    patch_shape = jph.cvivit.get_video_patch_shape(FRAMES)
    n = jph.cvivit.num_tokens_per_frames(FRAMES)

    @jax.jit
    def run(text_embeds):
        bias = mg.apply(params, patch_shape, method=JMaskGit.rel_pos_bias)
        mask = jnp.any(text_embeds != 0, axis=-1)

        def embeds_fn(ids):
            return mg.apply(params, ids, video_patch_shape=patch_shape, context=text_embeds,
                            text_mask=mask, cond_scale=COND_SCALE, attn_bias=bias,
                            method=JMaskGit.embeds_with_cond_scale)

        proj = params["params"]["to_logits"]
        return j_loop(None, rng=jax.random.PRNGKey(3), batch=text_embeds.shape[0],
                      num_tokens_seq=n, mask_id=mg.mask_id, steps=STEPS,
                      starting_temperature=0.0, embeds_fn=embeds_fn,
                      vocab_proj=(proj["kernel"], proj["bias"]))

    return np.asarray(run(jnp.asarray(jph.pad_text_embeds(emb))))


@pytest.mark.parametrize("batch", [1, 2])
def test_greedy_sample_matches_jax(models, batch):
    jph, tph = models
    emb = _text_embeds(batch, seed=10 + batch)
    ids_j = _jax_ids(jph, emb)
    video_j = np.asarray(jph.sample(num_frames=FRAMES, text_embeds=emb, cond_scale=COND_SCALE,
                                    starting_temperature=0.0, rng=jax.random.PRNGKey(3)))
    gen = torch.Generator().manual_seed(0)
    ids_t = tph.sample_ids(num_frames=FRAMES, text_embeds=torch.from_numpy(emb),
                           cond_scale=COND_SCALE, starting_temperature=0.0, generator=gen)
    video_t = tph.sample(num_frames=FRAMES, text_embeds=torch.from_numpy(emb),
                         cond_scale=COND_SCALE, starting_temperature=0.0, generator=gen)
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    assert video_t.shape == (batch, FRAMES, 16, 16, 3)
    np.testing.assert_allclose(video_t.numpy(), video_j, atol=1e-4, rtol=0)
