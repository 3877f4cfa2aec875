"""The flagship presets' head shapes (`tpu_native`) and the 4 x 128 head shape
in the port, against the JAX package, fp32 on the CPU.

* The preset trunks at both head shapes on `tests/test_presets.py`'s
  dim-reduced config (dim 64, vocab 256, 16 positions, depth 1): every
  MaskGit and TokenCritic tensor has the shape of the bridged JAX leaf (a
  scanned and an unscanned JAX tree both load, the bridge refusing any
  mismatch), and between the two head shapes only the CPB MLP (its width
  follows d_head) and the QK-norm scales differ in size. The flagship
  MaskGit preset builds 4 heads x 128 with `tpu_native=True` and 8 x 64
  without.
* d_head = 128 on bridged weights (dim 256, 2 heads x 128, depth 2):
  MaskGit and TokenCritic logits within atol 1e-4; `Phenaki.loss` (128
  tokens, so JAX runs its Pallas kernels at d = 128 in interpret mode, with
  its draws fed to the port as `tests/test_torch_train.py` does) within
  rtol 1e-5 and every MaskGit gradient within 1e-3 x max|g| of its tensor
  (max|g| floored at 1e-5, that file's rule); a greedy sample's ids equal.
* On two spawned gloo ranks: a greedy tp = 2 sample at 4 heads x 128 (2
  heads a rank) equal to the dense port's video within atol 1e-5 and its ids
  exactly, and a MaskGit with `ff_inner_dim=45` (odd, so each rank's half is
  zero-padded to 23) gives logits at tp = 2 within atol 1e-5 of the dense
  port's. JAX's own tp clone sizes the GEGLU from the reference width, so
  the port's tp = 2 is held to its dense model, and the dense field to JAX's
  in `tests/test_torch_remat.py`.

The rank function imports no JAX: JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.parallel.mesh import make_mesh
from phenaki_tpu_torch.presets import flagship_maskgit, flagship_token_critic

torch.set_num_threads(1)

# tests/test_presets.py's dim-reduced preset config
REDUCED = dict(dim=64, num_tokens=256, max_seq_len=16, depth=1)
# d_head = 128 at a small width
TEXT_DIM, STEPS = 16, 4
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
WIDE = dict(dim=256, num_tokens=64, max_seq_len=128, depth=2, heads=2, dim_head=128, dim_context=TEXT_DIM)
GRID = (2, 8, 8)  # 3 frames: 128 tokens
SAMPLE_FRAMES = 1  # one latent frame: 64 tokens
GREEDY = dict(cond_scale=3.0, starting_temperature=0.0)
# the tp = 2 cases: 4 heads x 128, and an odd GEGLU width
TP_CVIVIT = dict(CVIVIT, image_size=16)
TP_MASKGIT = dict(WIDE, heads=4, max_seq_len=16)
FF_MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=2, heads=2, dim_head=16, dim_context=TEXT_DIM,
                  ff_inner_dim=45)


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_tree(cls, scan_layers, **cfg):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.presets import flagship_maskgit as j_maskgit, flagship_token_critic as j_critic

    build = j_maskgit if cls is MaskGit else j_critic
    model = build(scan_layers=scan_layers, dtype=jnp.float32, **cfg)
    # the tree's shapes alone (traced, not compiled), as zeros for the bridge
    shapes = jax.eval_shape(lambda r: model.init(r, jnp.zeros((1, 16), jnp.int32), video_patch_shape=(1, 4, 4),
                                                 context=jnp.zeros((1, 5, 768))), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes["params"])


@pytest.mark.parametrize("tpu_native", [False, True], ids=["8x64", "4x128"])
def test_preset_shapes_match_jax(tpu_native):
    for cls, preset in ((MaskGit, flagship_maskgit), (TokenCritic, flagship_token_critic)):
        port = preset(tpu_native=tpu_native, **REDUCED)
        shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        for scan_layers in (False, True):
            tree = _jax_tree(cls, scan_layers, tpu_native=tpu_native, **REDUCED)
            assert {k: tuple(v.shape) for k, v in flax_to_state_dict(tree).items()} == shapes
            load_flax_params(port, tree)  # raises on a missing, extra or misshapen tensor


def test_head_shapes_differ_only_in_the_cpb_and_qk_scales():
    for preset in (flagship_maskgit, flagship_token_critic):
        ref, tpu = (preset(tpu_native=t, **REDUCED).state_dict() for t in (False, True))
        assert ref.keys() == tpu.keys()
        # sizes, as tests/test_presets.py compares them (a cross-attention's
        # null_kv (heads, 4, d_head) changes shape, not size)
        differ = {k for k in ref if ref[k].numel() != tpu[k].numel()}
        assert all("continuous_pos_bias" in k or k.endswith(("q_scale", "k_scale")) for k in differ), differ
        if preset is flagship_maskgit:
            assert any("continuous_pos_bias" in k for k in differ)
        n_ref, n_tpu = (sum(v.numel() for v in sd.values()) for sd in (ref, tpu))
        assert abs(n_ref - n_tpu) / n_ref < 0.02


def test_flagship_presets_build_both_head_shapes():
    for tpu_native, shape in ((False, (8, 64)), (True, (4, 128))):
        with torch.device("meta"):
            mg = flagship_maskgit(tpu_native=tpu_native)
        for attn in (mg.transformer.layers[0].self_attn, mg.transformer.layers[0].cross_attn):
            assert (attn.heads, attn.dim_head) == shape
        assert mg.continuous_pos_bias.net_in.out_features == shape[1]  # the CPB width follows d_head


# ---------------------------------------------------------------------------
# d_head = 128 on bridged weights


@pytest.fixture(scope="module")
def wide():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.cvivit import CViViT as JCViViT
    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit, TokenCritic as JTokenCritic
    from phenaki_tpu.models.phenaki import Phenaki as JPhenaki
    from phenaki_tpu.utils.jit_init import jit_init

    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**WIDE, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars, steps=STEPS,
                   text_embed_dim=TEXT_DIM, max_text_len=8)
    jph.init(jax.random.PRNGKey(1))
    critic_cfg = dict(WIDE, has_cross_attn=True)
    jcritic = JTokenCritic(**critic_cfg, scan_layers=True)
    critic_vars = jit_init(jcritic, jax.random.PRNGKey(2), jnp.zeros((1, 12), jnp.int32), video_patch_shape=(3, 2, 2),
                           context=jnp.zeros((1, 6, TEXT_DIM)))
    cv = load_flax_params(CViViT(**CVIVIT), _numpy_tree(cv_vars["params"]))
    mg = load_flax_params(MaskGit(**WIDE), _numpy_tree(jph.params["maskgit"]))
    tph = Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, steps=STEPS, max_text_len=8)
    critic = load_flax_params(TokenCritic(**critic_cfg), _numpy_tree(critic_vars["params"]))
    return dict(jph=jph, tph=tph, jcritic=(jcritic, critic_vars), critic=critic)


def _small_inputs():
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 65, size=(2, 12))  # 64 is the mask id
    ctx = rng.randn(2, 6, TEXT_DIM).astype(np.float32)
    ctx[1, 3:] = 0.0
    return ids, ctx, np.any(ctx != 0, axis=-1)


def test_d128_logits_match_jax(wide):
    import jax
    import jax.numpy as jnp

    ids, ctx, mask = _small_inputs()
    kw = dict(video_patch_shape=(3, 2, 2))
    jmg, jparams = wide["jph"].maskgit, {"params": wide["jph"].params["maskgit"]}
    jcritic, critic_vars = wide["jcritic"]
    args = (jnp.asarray(ids), jnp.asarray(ctx), jnp.asarray(mask))
    ref = jax.jit(lambda i, c, m: jmg.apply(jparams, i, context=c, text_mask=m, **kw))(*args)
    ref_critic = jax.jit(lambda i, c, m: jcritic.apply(critic_vars, i, context=c, text_mask=m, **kw))(*args)
    t = dict(context=torch.from_numpy(ctx), text_mask=torch.from_numpy(mask), **kw)
    with torch.no_grad():
        got = wide["tph"].maskgit(torch.from_numpy(ids), **t)
        got_critic = wide["critic"](torch.from_numpy(ids), **t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_critic.numpy(), np.asarray(ref_critic), atol=1e-4, rtol=0)


def test_d128_loss_and_grads_match_jax(wide, monkeypatch):
    import jax
    import jax.numpy as jnp
    import phenaki_tpu.ops.pallas_attention as pa

    monkeypatch.setattr(pa, "_INTERPRET", True)
    jph, tph = wide["jph"], wide["tph"]
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, size=(2, *GRID)).astype(np.int32)
    emb = rng.randn(2, 6, TEXT_DIM).astype(np.float32)
    emb[1, 2:] = 0.0
    key = jax.random.PRNGKey(7)

    def j_loss(mg_params):
        loss, _ = jph.loss({"maskgit": mg_params, "critic": None}, key, video_codebook_ids=jnp.asarray(ids),
                           text_embeds=jnp.asarray(emb), cond_drop_prob=0.0)
        return loss

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(j_loss))(jph.params["maskgit"])
    # the JAX loss's own draws, from the same split of its key
    rng_mask, rng_step = jax.random.split(key, 7)[:2]
    step = np.asarray(jax.random.randint(rng_step, (2,), 0, STEPS))
    noise = np.asarray(jax.random.uniform(rng_mask, (2, ids[0].size)))
    monkeypatch.setattr(tph, "_loss_draws", lambda b, n, gen, device: (
        torch.from_numpy(step.copy()).long(), torch.from_numpy(noise.copy())))
    tph.maskgit.zero_grad()
    loss, _ = tph.loss(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb),
                       cond_drop_prob=0.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = flax_to_state_dict(_numpy_tree(ref_grads))
    named = dict(tph.maskgit.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-5), rtol=0, err_msg=name)


def test_d128_greedy_sample_ids_match_jax(wide):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.models.sampling_loop import maskgit_sample_loop as j_loop

    jph, tph = wide["jph"], wide["tph"]
    emb = np.random.RandomState(12).randn(2, 4, TEXT_DIM).astype(np.float32)
    emb[1, 2:] = 0.0
    mg, params = jph.maskgit, {"params": jph.params["maskgit"]}
    patch_shape = jph.cvivit.get_video_patch_shape(SAMPLE_FRAMES)
    n = jph.cvivit.num_tokens_per_frames(SAMPLE_FRAMES)

    @jax.jit
    def run(text_embeds):
        bias = mg.apply(params, patch_shape, method=JMaskGit.rel_pos_bias)
        mask = jnp.any(text_embeds != 0, axis=-1)

        def embeds_fn(ids):
            return mg.apply(params, ids, video_patch_shape=patch_shape, context=text_embeds, text_mask=mask,
                            cond_scale=GREEDY["cond_scale"], attn_bias=bias, method=JMaskGit.embeds_with_cond_scale)

        proj = params["params"]["to_logits"]
        return j_loop(None, rng=jax.random.PRNGKey(3), batch=text_embeds.shape[0], num_tokens_seq=n,
                      mask_id=mg.mask_id, steps=STEPS, starting_temperature=0.0, embeds_fn=embeds_fn,
                      vocab_proj=(proj["kernel"], proj["bias"]))

    ref = np.asarray(run(jnp.asarray(jph.pad_text_embeds(emb))))
    got = tph.sample_ids(num_frames=SAMPLE_FRAMES, text_embeds=torch.from_numpy(emb),
                         generator=torch.Generator().manual_seed(0), **GREEDY)
    assert ref.shape == (2, n) and len(np.unique(ref)) > 1
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# tp = 2 on two gloo ranks


def _tp_phenaki():
    gen = torch.Generator().manual_seed(0)
    cv = init_parameters(CViViT(**TP_CVIVIT), gen)
    return Phenaki(maskgit=init_parameters(MaskGit(**TP_MASKGIT), gen), cvivit=cv, text_embed_dim=TEXT_DIM,
                   steps=STEPS, max_text_len=4)


def _ff_model():
    return init_parameters(MaskGit(**FF_MASKGIT), torch.Generator().manual_seed(3))


def _tp_sample_kw():
    text = torch.from_numpy(np.random.RandomState(9).randn(2, 3, TEXT_DIM).astype(np.float32))
    return dict(num_frames=3, text_embeds=text, generator=torch.Generator().manual_seed(4), **GREEDY)


def _ff_logits(model):
    ids, ctx, mask = _small_inputs()
    with torch.no_grad():
        return model(torch.from_numpy(ids), video_patch_shape=(3, 2, 2), context=torch.from_numpy(ctx),
                     text_mask=torch.from_numpy(mask)).numpy()


def _tp_rank(rank, world):
    from phenaki_tpu_torch.parallel.tp_inference import tp_local_module

    torch.set_num_threads(1)
    mesh = make_mesh(tp=2)
    ph = _tp_phenaki()
    local = ph.tp_shard(mesh)
    out = {"heads": local.maskgit.transformer.layers[0].self_attn.heads}
    out["ids"] = local.sample_ids(**_tp_sample_kw()).numpy()
    out["video"] = ph.sample(mesh=mesh, **_tp_sample_kw()).numpy()
    ff = tp_local_module(_ff_model(), 2, mesh.tp_group)
    out["ff_inner"] = ff.transformer.layers[0].ff.inner_dim
    out["ff_logits"] = _ff_logits(ff)
    return out


@pytest.fixture(scope="module")
def tp_ranks():
    return spawn_ranks(_tp_rank, 2, timeout=300)


def test_tp2_sample_at_4x128_matches_the_dense_port(tp_ranks):
    ph = _tp_phenaki()
    ids = ph.sample_ids(**_tp_sample_kw()).numpy()
    video = ph.sample(**_tp_sample_kw()).numpy()
    assert len(np.unique(ids)) > 1
    for r in tp_ranks:
        assert r["heads"] == 2  # 4 heads x 128 over tp = 2
        np.testing.assert_array_equal(r["ids"], ids)
        np.testing.assert_allclose(r["video"], video, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tp_ranks[0]["video"], tp_ranks[1]["video"])


def test_tp2_ff_inner_dim_matches_the_dense_port(tp_ranks):
    model = _ff_model()
    assert model.transformer.layers[0].ff.proj_out.in_features == 45
    dense = _ff_logits(model)
    for r in tp_ranks:
        assert r["ff_inner"] == 23  # ceil(45 / 2), zero-padded
        np.testing.assert_allclose(r["ff_logits"], dense, atol=1e-5, rtol=0)
