"""Prime-frame sampling, `sample_images` and `make_video` in the port against
the JAX package on bridged weights, fp32 on the CPU.

Greedy decoding (starting_temperature 0, and noise_K 0 with a critic: the
gumbel noise is negligible against logits / 1e-10, as in
test_torch_phenaki.py) needs no shared random stream:

* a primed `sample` (3 prime frames, 4 new ones): the prime ids equal the
  JAX C-ViViT's, the scene's ids equal the JAX loop's with the same prime
  ids in front, and the video equals the JAX `Phenaki.sample(prime_frames=)`
  within atol 1e-4; plain and with a TokenCritic;
* `sample_images` from texts (the offline hash encoder on both sides):
  (b, H, W, c) within atol 1e-4;
* a 3-scene `make_video` from texts, 5 + 4 + 4 frames primed with 3 frames:
  every scene and the whole video within atol 1e-4;
* the sequence-length guard with JAX's message, and `texts` excluding
  `text_embeds`.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.maskgit import TokenCritic as JTokenCritic  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.models.phenaki import make_video as j_make_video  # noqa: E402
from phenaki_tpu.models.sampling_loop import maskgit_sample_loop as j_loop  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import load_cvivit_variables, load_phenaki_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki, make_video

torch.set_num_threads(1)

TEXT_DIM, TEXT_LEN, STEPS, COND_SCALE = 16, 6, 4, 5.0
PRIME, SCENE = 3, 4  # frames: 2 + 2 latent frames of 2 x 2 tokens
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=2, temporal_depth=2, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=64, depth=2, heads=2, dim_head=16,
               dim_context=TEXT_DIM)
TEXTS = ["a red ball rolls left", "the ball stops", "a blue square appears!"]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _pair(critic: bool, seed: int):
    """The JAX Phenaki (initialised) and the port's on its bridged weights."""
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(seed), jnp.zeros((1, 3, 16, 16, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   critic=JTokenCritic(**MASKGIT, has_cross_attn=True, scan_layers=True) if critic else None,
                   steps=STEPS, text_embed_dim=TEXT_DIM, max_text_len=TEXT_LEN)
    jph.init(jax.random.PRNGKey(seed + 1))
    cv = load_cvivit_variables(CViViT(**CVIVIT), _numpy_tree(cv_vars))
    tph = Phenaki(maskgit=MaskGit(**MASKGIT), cvivit=cv, text_embed_dim=TEXT_DIM, steps=STEPS,
                  max_text_len=TEXT_LEN,
                  critic=TokenCritic(**MASKGIT, has_cross_attn=True) if critic else None)
    return jph, load_phenaki_params(tph, _numpy_tree(jph.params))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "token_critic"])
def pair(request):
    return _pair(request.param, seed=20 if request.param else 0)


def _text(b, seed):
    emb = np.random.RandomState(seed).randn(b, 4, TEXT_DIM).astype(np.float32)
    emb[:, 3:] = 0.0
    return emb


def _video(b, frames, seed):
    return np.random.RandomState(seed).rand(b, frames, 16, 16, 3).astype(np.float32)


def _jax_primed_ids(jph, emb, prime_ids):
    """The JAX sample program's decode loop (models/phenaki.py
    `_build_sample_fn`) with prime ids, greedy with noise_K = 0."""
    mg, params = jph.maskgit, jph.params
    mg_vars = {"params": params["maskgit"]}
    patch_shape = jph.cvivit.get_video_patch_shape(SCENE + PRIME)
    n = jph.cvivit.num_tokens_per_frames(SCENE, include_first_frame=False)

    @jax.jit
    def run(text_embeds, prime):
        bias = mg.apply(mg_vars, patch_shape, method=JMaskGit.rel_pos_bias)
        mask = jnp.any(text_embeds != 0, axis=-1)
        kw = dict(video_patch_shape=patch_shape, context=text_embeds, text_mask=mask,
                  cond_scale=COND_SCALE)
        critic_fn = None
        if jph.critic is not None:
            critic_vars = jph._critic_variables(params)

            def critic_fn(ids):
                return jph.critic.apply(critic_vars, ids, method=JTokenCritic.forward_with_cond_scale, **kw)

        proj = params["maskgit"]["to_logits"]
        return j_loop(None, rng=jax.random.PRNGKey(3), batch=text_embeds.shape[0], num_tokens_seq=n,
                      mask_id=mg.mask_id, steps=STEPS, starting_temperature=0.0, prime_ids=prime,
                      critic_fn=critic_fn, noise_K=0.0,
                      embeds_fn=lambda ids: mg.apply(mg_vars, ids, attn_bias=bias,
                                                     method=JMaskGit.embeds_with_cond_scale, **kw),
                      vocab_proj=(proj["kernel"], proj["bias"]))

    return np.asarray(run(jnp.asarray(jph.pad_text_embeds(emb)), jnp.asarray(prime_ids)))


@pytest.mark.parametrize("batch", [1, 2])
def test_primed_greedy_sample_matches_jax(pair, batch):
    jph, tph = pair
    emb, prime = _text(batch, seed=30 + batch), _video(batch, PRIME, seed=40 + batch)
    j_prime = np.asarray(jph.cvivit.apply(jph.cvivit_vars, jnp.asarray(prime),
                                          return_only_codebook_ids=True)).reshape(batch, -1)
    t_prime = tph.tokenize_prime(torch.from_numpy(prime))
    np.testing.assert_array_equal(t_prime.numpy(), j_prime)

    kw = dict(num_frames=SCENE, cond_scale=COND_SCALE, starting_temperature=0.0, noise_K=0.0)
    ids_t = tph.sample_ids(text_embeds=torch.from_numpy(emb), prime_ids=t_prime,
                           generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(ids_t.numpy(), _jax_primed_ids(jph, emb, j_prime))

    video_j = np.asarray(jph.sample(text_embeds=emb, prime_frames=jnp.asarray(prime),
                                    rng=jax.random.PRNGKey(3), **kw))
    video_t = tph.sample(text_embeds=torch.from_numpy(emb), prime_frames=torch.from_numpy(prime),
                         generator=torch.Generator().manual_seed(0), **kw)
    assert video_t.shape == (batch, SCENE, 16, 16, 3)
    np.testing.assert_allclose(video_t.numpy(), video_j, atol=1e-4, rtol=0)


def test_sample_images_matches_jax(pair):
    jph, tph = pair
    kw = dict(cond_scale=COND_SCALE, starting_temperature=0.0, noise_K=0.0)
    images_j = np.asarray(jph.sample_images(texts=TEXTS[:2], rng=jax.random.PRNGKey(3), **kw))
    images_t = tph.sample_images(texts=TEXTS[:2], generator=torch.Generator().manual_seed(0), **kw)
    assert images_t.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(images_t.numpy(), images_j, atol=1e-4, rtol=0)


def test_make_video_matches_jax(pair):
    jph, tph = pair
    kw = dict(num_frames=(5, SCENE, SCENE), prime_lengths=PRIME, cond_scale=COND_SCALE,
              starting_temperature=0.0, noise_K=0.0)
    video_j, scenes_j = j_make_video(jph, TEXTS, rng=jax.random.PRNGKey(3), **kw)
    video_t, scenes_t = make_video(tph, TEXTS, generator=torch.Generator().manual_seed(0), **kw)
    assert video_t.shape == (1, 5 + 2 * SCENE, 16, 16, 3)
    assert [s.shape[1] for s in scenes_t] == [5, SCENE, SCENE]
    for scene_t, scene_j in zip(scenes_t, scenes_j):
        np.testing.assert_allclose(scene_t.numpy(), np.asarray(scene_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(video_t.numpy(), np.asarray(video_j), atol=1e-4, rtol=0)


def test_primed_length_guard_and_text_arguments():
    cv = CViViT(**CVIVIT)
    short = Phenaki(maskgit=MaskGit(**dict(MASKGIT, max_seq_len=12)), cvivit=cv,
                    text_embed_dim=TEXT_DIM, steps=STEPS, max_text_len=TEXT_LEN)
    prime = torch.from_numpy(_video(1, PRIME, seed=5))
    with pytest.raises(ValueError, match="max_seq_len must cover the prime tokens"):
        short.sample(num_frames=SCENE, texts="a cat", prime_frames=prime)
    with pytest.raises(ValueError, match="texts or text_embeds"):
        short.sample(num_frames=5, texts="a cat", text_embeds=torch.zeros(1, 2, TEXT_DIM))
    with pytest.raises(ValueError, match="batch"):
        short.sample(num_frames=SCENE, texts=["a", "b"], prime_frames=prime)
