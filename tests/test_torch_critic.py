"""The port's critics, critic-guided sampling and critic training against
the JAX package, fp32 on the CPU, on bridged weights (`scan_layers=True`
trees on the JAX side, so the bridge unstacks them).

* `MaskGit.forward_with_cond_scale` (combined and stacked), `TokenCritic`
  and `SelfCritic` forwards and their `forward_with_cond_scale`: atol 1e-4.
* `load_phenaki_params` on the `{"maskgit", "critic"}` trees of
  `Phenaki.init`, and TokenCritic trees unrolled or stacked.
* The critic noise multipliers against the TPU loop's f32 expressions.
* Greedy decoding (starting_temperature 0, noise_K 0; the gumbel noise is
  negligible against logits / 1e-10, so no shared stream is needed): the
  logits-path loop (stacked CFG logits) and critic-guided `sample_ids`
  with a TokenCritic and with a SelfCritic give the JAX loop's ids exactly.
* `Phenaki.loss` with a critic and every MaskGit and critic gradient
  against `jax.value_and_grad` of the JAX loss, for the default,
  `only_train_generator` and `only_train_critic`, with the JAX draws (step,
  mask subset, the generator's sample uniforms) fed to the port. The
  non-fused branch at a tiny width; the fused branch (the projection
  sampler on the detached embeddings) at d = 128, V = 512, with the JAX
  side's fused branch patched on. Tolerances as test_torch_train.py's:
  loss rtol 1e-5, each gradient within 1e-3 * max|g| of its tensor
  (floored at 1e-5).
* A 3-step `PhenakiTrainer` run with a critic: `only_train_critic` leaves
  the MaskGit gradients zero (and moves every parameter: Adam's moments
  see a zero gradient, as in the JAX step).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.models.phenaki as jphenaki_module  # noqa: E402
import phenaki_tpu.ops.pallas_ce as pce  # noqa: E402
import phenaki_tpu.ops.pallas_sampling as ps  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.maskgit import SelfCritic as JSelfCritic  # noqa: E402
from phenaki_tpu.models.maskgit import TokenCritic as JTokenCritic  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.models.sampling_loop import maskgit_sample_loop as j_loop  # noqa: E402
from phenaki_tpu.models.transformer import stack_layer_params  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params, load_phenaki_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, SelfCritic, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.models.sampling_loop import critic_noise_multiplier, maskgit_sample_loop
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

TEXT_DIM, TEXT_LEN, COND_SCALE = 16, 6, 5.0
TRUNK = dict(dim=32, num_tokens=64, max_seq_len=64, depth=2, heads=2, dim_head=16,
             dim_context=TEXT_DIM)
CRITIC = dict(TRUNK, has_cross_attn=True)
PATCH = (3, 2, 2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _inputs(b, seed=0, n=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 65, size=(b, n))  # 64 is the mask id
    ctx = rng.randn(b, TEXT_LEN, TEXT_DIM).astype(np.float32)
    ctx[:, 4:] = 0.0
    return ids, ctx, np.any(ctx != 0, axis=-1)


# ---------------------------------------------------------------------------
# forwards on bridged weights


@pytest.fixture(scope="module")
def trunks():
    ids = jnp.zeros((1, 12), jnp.int32)
    ctx = jnp.zeros((1, TEXT_LEN, TEXT_DIM))
    jmg = JMaskGit(**TRUNK, scan_layers=True)
    mg_vars = jit_init(jmg, jax.random.PRNGKey(0), ids, video_patch_shape=PATCH, context=ctx)
    jcr = JTokenCritic(**CRITIC, scan_layers=True)
    cr_vars = jit_init(jcr, jax.random.PRNGKey(1), ids, video_patch_shape=PATCH, context=ctx)
    jsc = JSelfCritic(jmg)
    sc_vars = jit_init(jsc, jax.random.PRNGKey(2), ids, video_patch_shape=PATCH, context=ctx)
    sc_vars = {"params": {"maskgit": mg_vars["params"], "to_pred": sc_vars["params"]["to_pred"]}}
    mg = load_flax_params(MaskGit(**TRUNK).eval(), _numpy_tree(mg_vars["params"]))
    cr = load_flax_params(TokenCritic(**CRITIC).eval(), _numpy_tree(cr_vars["params"]))
    sc = load_flax_params(SelfCritic(mg).eval(), {"to_pred": _numpy_tree(sc_vars["params"]["to_pred"])})
    return dict(maskgit=(jmg, mg_vars, mg), token=(jcr, cr_vars, cr), self=(jsc, sc_vars, sc))


@pytest.mark.parametrize("combine", [True, False])
def test_maskgit_forward_with_cond_scale(trunks, combine):
    jmod, variables, mod = trunks["maskgit"]
    ids, ctx, mask = _inputs(2)
    bias = jmod.apply(variables, PATCH, method=JMaskGit.rel_pos_bias)
    ref = jmod.apply(variables, jnp.asarray(ids), video_patch_shape=PATCH, context=jnp.asarray(ctx),
                     text_mask=jnp.asarray(mask), cond_scale=COND_SCALE, attn_bias=bias,
                     combine=combine, method=JMaskGit.forward_with_cond_scale)
    with torch.no_grad():
        out = mod.forward_with_cond_scale(
            torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
            text_mask=torch.from_numpy(mask), cond_scale=COND_SCALE, combine=combine,
            attn_bias=mod.rel_pos_bias(PATCH))
    assert out.shape == ((2, 12, 64) if combine else (4, 12, 64))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["token", "self"])
@pytest.mark.parametrize("cond_scale", [None, 1.0, COND_SCALE])
def test_critic_forwards(trunks, kind, cond_scale):
    """`cond_scale=None`: the plain forward, with a video mask."""
    jmod, variables, mod = trunks[kind]
    ids, ctx, mask = _inputs(3, seed=4)
    video_mask = np.ones((3, 12), bool)
    video_mask[1, 8:] = False
    kw = dict(video_patch_shape=PATCH, video_mask=video_mask)
    jkw = dict(context=jnp.asarray(ctx), text_mask=jnp.asarray(mask), **kw)
    tkw = dict(context=torch.from_numpy(ctx), text_mask=torch.from_numpy(mask),
               **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    if cond_scale is None:
        ref = jmod.apply(variables, jnp.asarray(ids), **jkw)
        with torch.no_grad():
            out = mod(torch.from_numpy(ids), **tkw)
    else:
        ref = jmod.apply(variables, jnp.asarray(ids), cond_scale=cond_scale, **jkw,
                         method=type(jmod).forward_with_cond_scale)
        with torch.no_grad():
            out = mod.forward_with_cond_scale(torch.from_numpy(ids), cond_scale=cond_scale, **tkw)
    assert out.shape == (3, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_self_critic_shares_the_trunk(trunks):
    _, _, sc = trunks["self"]
    _, _, mg = trunks["maskgit"]
    assert sc.maskgit is mg
    assert sorted(sc.state_dict()) == ["to_pred.bias", "to_pred.weight"]
    assert [p.shape for p in sc.parameters()] == [(1, 32), (1,)]


def test_token_critic_trees_unrolled_and_stacked():
    jcr = JTokenCritic(**CRITIC)  # unrolled
    tree = _numpy_tree(jit_init(jcr, jax.random.PRNGKey(5), jnp.zeros((1, 12), jnp.int32),
                                video_patch_shape=PATCH, context=jnp.zeros((1, 4, TEXT_DIM)))["params"])
    stacked = dict(tree, transformer=_numpy_tree(stack_layer_params(tree["transformer"], 2)))
    a, b = flax_to_state_dict(tree), flax_to_state_dict(stacked)
    assert sorted(a) == sorted(b) == sorted(TokenCritic(**CRITIC).state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert "continuous_pos_bias" not in " ".join(a) and a["to_logits.weight"].shape == (1, 32)


# ---------------------------------------------------------------------------
# the critic noise schedule


@pytest.mark.parametrize("schedule", ["fixed", "decay", "increase"])
def test_critic_noise_multiplier_matches_the_tpu_loop(schedule):
    steps = 18
    for step in range(steps):
        s = jnp.int32(step)
        ref = {"fixed": 1.0, "decay": (steps - s - 1).astype(jnp.float32) / steps,
               "increase": (s + 1).astype(jnp.float32) / steps}[schedule]
        got = critic_noise_multiplier(schedule, step, steps)
        assert got.dtype == np.float32 and got == np.float32(ref), (step, got, ref)
    with pytest.raises(ValueError, match="anneal"):
        critic_noise_multiplier("cosine", 0, steps)
    with pytest.raises(ValueError, match="anneal"):
        maskgit_sample_loop(lambda ids: ids, batch=1, num_tokens_seq=4, mask_id=0, device="cpu",
                            critic_fn=lambda ids: ids, critic_noise_anneal_schedule="cosine")


# ---------------------------------------------------------------------------
# greedy decoding against the JAX loop

FRAMES, STEPS = 5, 4
CVIVIT_SMALL = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
                    spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)


def _phenaki_pair(critic, cvivit, image, seed, **extra):
    """The JAX Phenaki (initialised) and the port's on its bridged weights."""
    jcv = JCViViT(**cvivit, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(seed), jnp.zeros((1, 3, image, image, 3)))
    trunk = dict(TRUNK, **extra.pop("trunk", {}))
    jcr = JTokenCritic(**dict(trunk, has_cross_attn=True), scan_layers=True) if critic == "token" else None
    jph = JPhenaki(maskgit=JMaskGit(**trunk, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   critic=jcr, self_token_critic=critic == "self", steps=extra.get("steps", STEPS),
                   text_embed_dim=TEXT_DIM, max_text_len=TEXT_LEN, **extra.get("phenaki", {}))
    jph.init(jax.random.PRNGKey(seed + 1))
    cv = load_flax_params(CViViT(**cvivit), _numpy_tree(cv_vars["params"]))
    tph = Phenaki(maskgit=MaskGit(**trunk), cvivit=cv, text_embed_dim=TEXT_DIM,
                  steps=extra.get("steps", STEPS), max_text_len=TEXT_LEN,
                  critic=TokenCritic(**dict(trunk, has_cross_attn=True)) if critic == "token" else None,
                  self_token_critic=critic == "self", **extra.get("phenaki", {}))
    return jph, load_phenaki_params(tph, _numpy_tree(jph.params))


@pytest.fixture(scope="module", params=["token", "self"])
def sampling_pair(request):
    return request.param, *_phenaki_pair(request.param, CVIVIT_SMALL, 16, seed=10)


def _jax_ids(jph, emb, logits_path=False):
    """The JAX sample program's decode loop (models/phenaki.py
    `_build_sample_fn` without primes), greedy with noise_K = 0."""
    mg, params = jph.maskgit, jph.params
    mg_vars = {"params": params["maskgit"]}
    patch_shape = jph.cvivit.get_video_patch_shape(FRAMES)
    n = jph.cvivit.num_tokens_per_frames(FRAMES)

    @jax.jit
    def run(text_embeds):
        bias = mg.apply(mg_vars, patch_shape, method=JMaskGit.rel_pos_bias)
        mask = jnp.any(text_embeds != 0, axis=-1)
        kw = dict(video_patch_shape=patch_shape, context=text_embeds, text_mask=mask,
                  cond_scale=COND_SCALE, attn_bias=bias)
        critic_fn = None
        if jph.critic is not None:
            critic_vars = jph._critic_variables(params)
            has_text = jph.self_token_critic or jph.critic.has_cross_attn
            extra = {"attn_bias": bias} if jph.self_token_critic else {}

            def critic_fn(ids):
                return jph.critic.apply(critic_vars, ids, video_patch_shape=patch_shape,
                                        context=text_embeds if has_text else None,
                                        text_mask=mask if has_text else None, cond_scale=COND_SCALE,
                                        method=type(jph.critic).forward_with_cond_scale, **extra)

        loop = dict(rng=jax.random.PRNGKey(3), batch=text_embeds.shape[0], num_tokens_seq=n,
                    mask_id=mg.mask_id, steps=STEPS, starting_temperature=0.0, critic_fn=critic_fn,
                    noise_K=0.0)
        if logits_path:
            return j_loop(lambda ids: mg.apply(mg_vars, ids, combine=False,
                                               method=JMaskGit.forward_with_cond_scale, **kw),
                          stacked_cfg_scale=COND_SCALE, **loop)
        proj = params["maskgit"]["to_logits"]
        return j_loop(None, embeds_fn=lambda ids: mg.apply(
            mg_vars, ids, method=JMaskGit.embeds_with_cond_scale, **kw),
            vocab_proj=(proj["kernel"], proj["bias"]), **loop)

    return np.asarray(run(jnp.asarray(jph.pad_text_embeds(emb))))


def _text(b, seed):
    emb = np.random.RandomState(seed).randn(b, 4, TEXT_DIM).astype(np.float32)
    emb[:, 3:] = 0.0
    return emb


def test_greedy_critic_guided_sample_matches_jax(sampling_pair):
    kind, jph, tph = sampling_pair
    emb = _text(2, seed=20)
    gen = torch.Generator().manual_seed(0)
    ids = tph.sample_ids(num_frames=FRAMES, text_embeds=torch.from_numpy(emb), cond_scale=COND_SCALE,
                         starting_temperature=0.0, noise_K=0.0, generator=gen)
    np.testing.assert_array_equal(ids.numpy(), _jax_ids(jph, emb), err_msg=kind)
    video = tph.sample(num_frames=FRAMES, text_embeds=torch.from_numpy(emb), cond_scale=COND_SCALE,
                       starting_temperature=0.0, noise_K=0.0, generator=gen)
    assert video.shape == (2, FRAMES, 16, 16, 3) and torch.isfinite(video).all()


def test_greedy_logits_path_loop_matches_jax(sampling_pair):
    """`maskgit_sample_loop(logits_fn=..., stacked_cfg_scale=...)` on the
    stacked logits of `forward_with_cond_scale(combine=False)`, with the
    critic."""
    kind, jph, tph = sampling_pair
    emb = _text(2, seed=21)
    text = tph.pad_text_embeds(torch.from_numpy(emb))
    mask = (text != 0).any(-1)
    patch_shape = tph.cvivit.get_video_patch_shape(FRAMES)
    mg, critic = tph.maskgit.eval(), tph.critic.eval()
    bias = mg.rel_pos_bias(patch_shape)
    kw = dict(video_patch_shape=patch_shape, context=text, text_mask=mask, cond_scale=COND_SCALE)
    with torch.no_grad():
        ids = maskgit_sample_loop(
            lambda x: mg.forward_with_cond_scale(x, combine=False, attn_bias=bias, **kw),
            stacked_cfg_scale=COND_SCALE, batch=2, num_tokens_seq=tph.cvivit.num_tokens_per_frames(FRAMES),
            mask_id=mg.mask_id, device="cpu", steps=STEPS, starting_temperature=0.0, noise_K=0.0,
            critic_fn=lambda x: critic.forward_with_cond_scale(
                x, **kw, **({"attn_bias": bias} if kind == "self" else {})),
            generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(ids.numpy(), _jax_ids(jph, emb, logits_path=True), err_msg=kind)


# ---------------------------------------------------------------------------
# critic training against jax.value_and_grad

CVIVIT_LOSS = dict(CVIVIT_SMALL, image_size=32)  # a 4 x 4 patch grid: (2, 4, 4) = 32 tokens
GRID = (2, 4, 4)
MODES = {"default": {}, "only_train_generator": {"only_train_generator": True},
         "only_train_critic": {"only_train_critic": True}}


@pytest.fixture(scope="module", params=["token", "self"])
def loss_pair(request):
    return request.param, *_phenaki_pair(request.param, CVIVIT_LOSS, 32, seed=30)


def _loss_inputs(vocab=64):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, vocab, size=(2, *GRID)).astype(np.int32)
    emb = rng.randn(2, 5, TEXT_DIM).astype(np.float32)
    emb[0, 3:] = 0.0
    frame_mask = np.array([[1, 1, 1], [1, 0, 0]], bool)
    return ids, emb, frame_mask


def _check_loss_and_grads(jph, tph, monkeypatch, mode, frame_mask=True, fused=False):
    ids, emb, fmask = _loss_inputs(tph.maskgit.num_tokens)
    fmask = fmask if frame_mask else None
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, 7)
    b, n, v = ids.shape[0], int(np.prod(GRID)), tph.maskgit.num_tokens
    # the JAX loss's own draws, from the same split of its key
    step = np.asarray(jax.random.randint(keys[1], (b,), 0, jph.steps))
    noise = np.asarray(jax.random.uniform(keys[0], (b, n)))
    sample_u = np.asarray(jax.random.uniform(keys[4], (b, n, v)))
    if fused:
        real = ps.project_gumbel_sample_with_score
        monkeypatch.setattr(jphenaki_module, "project_gumbel_sample_with_score",
                            lambda h, w, bias, seed, t: real(h, w, bias, seed, t, noise=jnp.asarray(sample_u)))
    kw = MODES[mode]

    def j_loss(params):
        return jph.loss(params, rng, video_codebook_ids=jnp.asarray(ids), text_embeds=jnp.asarray(emb),
                        video_frame_mask=None if fmask is None else jnp.asarray(fmask),
                        cond_drop_prob=0.0, **kw)

    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jph.params))
    monkeypatch.setattr(tph, "_loss_draws", lambda *a: (torch.from_numpy(step.copy()).long(),
                                                        torch.from_numpy(noise.copy())))
    monkeypatch.setattr(tph, "_critic_sample_noise", lambda *a: torch.from_numpy(sample_u.copy()))
    for p in tph.parameters():
        p.grad = None
    loss, metrics = tph.loss(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb),
                             video_frame_mask=None if fmask is None else torch.from_numpy(fmask),
                             cond_drop_prob=0.0, **kw)
    loss.backward()
    assert sorted(metrics) == sorted(ref_metrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(ref_metrics[key]), rtol=1e-5, err_msg=key)
    grads = _numpy_tree(ref_grads)
    for part, module in (("maskgit", tph.maskgit), ("critic", tph.critic)):
        ref = flax_to_state_dict(grads[part])
        named = dict(module.named_parameters())
        assert sorted(ref) == sorted(named)
        for name, p in named.items():
            r = ref[name].numpy()
            g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
            np.testing.assert_allclose(g, r, atol=1e-3 * max(np.abs(r).max(), 1e-5), rtol=0,
                                       err_msg=f"{part}.{name}")
    return ref_grads


@pytest.mark.parametrize("mode", sorted(MODES))
def test_critic_loss_and_grads_match_jax(loss_pair, monkeypatch, mode):
    kind, jph, tph = loss_pair
    grads = _check_loss_and_grads(jph, tph, monkeypatch, mode)
    zero = [float(np.abs(x).max()) == 0.0 for x in jax.tree_util.tree_leaves(grads["maskgit"])]
    # under only_train_critic the MaskGit learns only through a SelfCritic's shared trunk
    assert all(zero) == (mode == "only_train_critic" and kind == "token")


def test_critic_loss_fused_branch_matches_jax(monkeypatch):
    """The fused CE branch with a TokenCritic at d = 128, V = 512: the
    generator's sample comes from the projection sampler on the detached
    embeddings (the JAX side's Pallas kernel in interpret mode, both fed the
    same uniforms)."""
    monkeypatch.setattr(jphenaki_module, "use_fused_ce", lambda: True)
    monkeypatch.setattr(pce, "_INTERPRET", True)
    monkeypatch.setattr(ps, "_INTERPRET", True)
    jph, tph = _phenaki_pair("token", CVIVIT_LOSS, 32, seed=40,
                             trunk=dict(dim=128, num_tokens=512, depth=1, dim_head=32))
    calls = []
    real = tph.critic.forward
    monkeypatch.setattr(tph.critic, "forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    _check_loss_and_grads(jph, tph, monkeypatch, "default", frame_mask=False, fused=True)
    assert calls == [1]


def test_phenaki_critic_arguments():
    mg = MaskGit(**TRUNK)
    cv = CViViT(**CVIVIT_SMALL)
    with pytest.raises(ValueError, match="not both"):
        Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, critic=TokenCritic(**CRITIC),
                self_token_critic=True)
    with pytest.raises(ValueError, match="cross-attention"):
        Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, critic=TokenCritic(**TRUNK))
    ph = Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, self_token_critic=True)
    assert isinstance(ph.critic, SelfCritic) and ph.critic.maskgit is mg
    assert len(list(ph.parameters())) == len(list(mg.parameters())) + 2
    ids, emb, _ = _loss_inputs()
    with pytest.raises(ValueError, match="exclude"):
        ph.loss(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb),
                only_train_generator=True, only_train_critic=True)


# ---------------------------------------------------------------------------
# trainer


class _Ids(torch.utils.data.Dataset):
    def __init__(self, n=8, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 64, size=(n, *GRID))
        self.emb = rng.randn(n, 5, TEXT_DIM).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


@pytest.mark.parametrize("kind", ["token", "self"])
def test_trainer_three_steps_with_a_critic(kind, tmp_path):
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(3)
    mg = init_parameters(MaskGit(**TRUNK), gen)
    critic = init_parameters(TokenCritic(**CRITIC), gen) if kind == "token" else None
    ph = Phenaki(maskgit=mg, cvivit=CViViT(**CVIVIT_LOSS), text_embed_dim=TEXT_DIM, steps=STEPS,
                 critic=critic, self_token_critic=kind == "self")
    # the step-1 milestone samples one critic-guided 3-frame video (32 tokens) and saves
    trainer = PhenakiTrainer(ph, dataset=_Ids(), batch_size=2, train_lr=1e-3, log_every=10**9,
                             num_frames=3, num_samples=1, sample_texts=["a cat"],
                             results_folder=str(tmp_path / "results"))
    assert {id(p) for g in trainer.opt.param_groups for p in g["params"]} == {id(p) for p in ph.parameters()}
    seen, step = [], trainer.opt.step

    def capture(*a, **k):
        seen.append({n: p.grad.clone() for n, p in ph.maskgit.named_parameters()})
        seen[-1].update({f"critic.{n}": p.grad.clone() for n, p in ph.critic.named_parameters()})
        return step(*a, **k)

    trainer.opt.step = capture
    before = {n: p.detach().clone() for n, p in [*mg.named_parameters(), *ph.critic.named_parameters()]}
    losses = [trainer.train_step(**kw).item() for kw in
              ({}, {"only_train_critic": True}, {"only_train_generator": True})]
    assert trainer.step == 3 and all(np.isfinite(losses))
    critic_grads = [g for n, g in seen[1].items() if n.startswith("critic.")]
    mg_grads = [g for n, g in seen[1].items() if not n.startswith("critic.")]
    assert all(g.abs().max() > 0 for g in critic_grads)
    # a TokenCritic's step leaves the MaskGit's gradients zero; a SelfCritic
    # trains the shared trunk
    assert all(g.abs().max() == 0 for g in mg_grads) == (kind == "token")
    assert all(g.abs().max() == 0 for n, g in seen[2].items() if n.startswith("critic."))
    after = dict([*mg.named_parameters(), *ph.critic.named_parameters()])
    assert all(not torch.equal(after[n], p) for n, p in before.items())
