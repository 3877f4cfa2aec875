"""The port's MaskGit training path against the JAX package, fp32 on the CPU.

* the gradients of `l2norm_scaled`, GEGLU and PEG (autograd in the port)
  against the JAX package's hand-written `custom_vjp`s: atol 1e-5;
* `calculate_video_token_mask` exactly, and the properties of
  `get_mask_subset_with_prob` (an exact count a row, pads never chosen);
* `Phenaki.loss` and every MaskGit parameter gradient against
  `jax.value_and_grad` of the JAX `Phenaki.loss`, on bridged
  `scan_layers=True` weights, at a size whose 128 tokens pass the flash gate
  (i >= 64), so JAX runs its Pallas kernels in interpret mode. The JAX
  random draws (step, mask subset) are reproduced from the same
  `jax.random.split(rng, 7)` and fed to the port. Tolerances: loss rtol
  1e-5; each gradient within 1e-3 * max|g| of its tensor, with max|g|
  floored at 1e-5: the CPB output bias adds one constant per head to every
  self-attention score, which the softmax cancels, so its true gradient is 0
  and both sides hold only rounding noise (~1e-9);
* the optimizer against optax over 3 steps: atol 1e-6 (torch's global-norm
  clip divides by norm + 1e-6, optax's by the norm), also with `eps=1e-6`
  and `group_wd_params=False` (every parameter decays);
* gradient accumulation equals the mean of the micro-batch gradients, and
  a 3-step `PhenakiTrainer` run (its step-1 milestone samples and saves).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.ops.feedforward import geglu as j_geglu  # noqa: E402
from phenaki_tpu.ops.norms import l2norm_scaled as j_l2norm_scaled  # noqa: E402
from phenaki_tpu.ops.positional import depthwise3x3x3  # noqa: E402
from phenaki_tpu.training.optimizer import get_optimizer as j_get_optimizer  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.feedforward import geglu
from phenaki_tpu_torch.ops.norms import l2norm_scaled
from phenaki_tpu_torch.ops.positional import PEG
from phenaki_tpu_torch.ops.sampling import get_mask_subset_with_prob
from phenaki_tpu_torch.training.optimizer import get_optimizer
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer, determine_types

torch.set_num_threads(1)

TEXT_DIM, STEPS = 16, 4
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=128, depth=2, heads=2, dim_head=16,
               dim_context=TEXT_DIM)
GRID = (2, 8, 8)  # 128 tokens


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _torch_grads(fn, *arrays):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return fn(*leaves), leaves


def test_l2norm_scaled_grads_match_jax_vjp():
    rng = np.random.RandomState(0)
    t = rng.randn(2, 3, 5, 16).astype(np.float32)
    t[0, 0, 0] = 0.0  # a zero vector: the clamped branch
    scale = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    dy = rng.randn(*t.shape).astype(np.float32)
    out, vjp = jax.vjp(j_l2norm_scaled, jnp.asarray(t), jnp.asarray(scale))
    dt_ref, ds_ref = vjp(jnp.asarray(dy))
    y, (tt, ss) = _torch_grads(l2norm_scaled, t, scale)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(dt_ref), atol=1e-5)
    np.testing.assert_allclose(ss.grad.numpy(), np.asarray(ds_ref), atol=1e-5)


def test_geglu_grads_match_jax_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 2 * 21).astype(np.float32) * 2
    dy = rng.randn(2, 7, 21).astype(np.float32)
    out, vjp = jax.vjp(j_geglu, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dy))
    y, (xx,) = _torch_grads(geglu, x)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(dx_ref), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_peg_grads_match_jax_vjp(causal):
    rng = np.random.RandomState(2)
    b, t, h, w, d = 2, 3, 4, 5, 8
    x = rng.randn(b, t, h, w, d).astype(np.float32)
    kernel = rng.randn(3, 3, 3, 1, d).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, k_, b_: depthwise3x3x3(x_, k_, b_, causal),
                       *map(jnp.asarray, (x, kernel, bias)))
    dx_ref, dk_ref, db_ref = vjp(jnp.asarray(dy))

    peg = PEG(d, causal=causal)
    with torch.no_grad():
        peg.weight.copy_(torch.from_numpy(np.transpose(kernel, (4, 3, 0, 1, 2)).copy()))
        peg.bias.copy_(torch.from_numpy(bias))
    xx = torch.from_numpy(x).requires_grad_()
    y = peg(xx)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(dx_ref), atol=1e-5)
    np.testing.assert_allclose(peg.weight.grad.numpy(),
                               np.transpose(np.asarray(dk_ref), (4, 3, 0, 1, 2)), atol=1e-4)
    np.testing.assert_allclose(peg.bias.grad.numpy(), np.asarray(db_ref), atol=1e-4)


def test_video_token_mask_matches_jax():
    frame_mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [1, 0, 1, 0, 0]], bool)
    ref = JCViViT(**CVIVIT).calculate_video_token_mask(jnp.asarray(frame_mask))
    got = CViViT(**CVIVIT).calculate_video_token_mask(torch.from_numpy(frame_mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mask_subset_exact_count_and_no_pads():
    gen = torch.Generator().manual_seed(0)
    mask = torch.ones(6, 50, dtype=torch.bool)
    mask[1, 30:] = False
    mask[2, 1:] = False
    mask[3, 10:40] = False
    prob = torch.tensor([0.5, 0.5, 0.01, 0.3, 1.0, 0.0])
    for _ in range(5):
        chosen = get_mask_subset_with_prob(mask, prob, gen)
        n_valid = mask.sum(-1).float()
        expected = torch.round(prob * n_valid).clamp_min(1).long()
        assert torch.equal(chosen.sum(-1), expected)
        assert not (chosen & ~mask).any()
    # a scalar prob, and the draw follows the generator
    a = get_mask_subset_with_prob(mask, 0.4, torch.Generator().manual_seed(3))
    b = get_mask_subset_with_prob(mask, 0.4, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Phenaki.loss against the JAX package


@pytest.fixture(scope="module")
def phenakis():
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   steps=STEPS, text_embed_dim=TEXT_DIM, max_text_len=8)
    jph.init(jax.random.PRNGKey(1))
    params = _numpy_tree(jph.params["maskgit"])
    return jph, params


def _port_phenaki(params):
    mg = load_flax_params(MaskGit(**MASKGIT), params)
    return Phenaki(maskgit=mg, cvivit=CViViT(**CVIVIT), text_embed_dim=TEXT_DIM, steps=STEPS,
                   max_text_len=8)


def _loss_inputs():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, size=(2, *GRID)).astype(np.int32)
    emb = rng.randn(2, 6, TEXT_DIM).astype(np.float32)
    emb[0, 4:] = 0.0  # padding rows
    emb[1, 2:] = 0.0
    frame_mask = np.array([[1, 1, 1], [1, 0, 0]], bool)  # sample 1: second latent frame padded
    return ids, emb, frame_mask


def test_loss_and_grads_match_jax(phenakis, monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    jph, params = phenakis
    ids, emb, frame_mask = _loss_inputs()
    rng = jax.random.PRNGKey(7)

    def j_loss(mg_params):
        loss, _ = jph.loss({"maskgit": mg_params, "critic": None}, rng,
                           video_codebook_ids=jnp.asarray(ids), text_embeds=jnp.asarray(emb),
                           video_frame_mask=jnp.asarray(frame_mask), cond_drop_prob=0.0)
        return loss

    ref_loss, ref_grads = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, params))

    # the JAX loss's own draws, from the same split of its key
    rng_mask, rng_step = jax.random.split(rng, 7)[:2]
    step = np.asarray(jax.random.randint(rng_step, (2,), 0, STEPS))
    noise = np.asarray(jax.random.uniform(rng_mask, (2, ids[0].size)))
    tph = _port_phenaki(params)
    monkeypatch.setattr(tph, "_loss_draws", lambda b, n, gen, device: (
        torch.from_numpy(step.copy()).long(), torch.from_numpy(noise.copy())))
    loss, metrics = tph.loss(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb),
                             video_frame_mask=torch.from_numpy(frame_mask), cond_drop_prob=0.0)
    loss.backward()
    assert metrics["loss"] is loss
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)

    ref = flax_to_state_dict(_numpy_tree(ref_grads))
    named = dict(tph.maskgit.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-5),
                                   rtol=0, err_msg=name)


def test_loss_draws_follow_the_generator(phenakis):
    _, params = phenakis
    tph = _port_phenaki(params)
    ids, emb, _ = _loss_inputs()
    kw = dict(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb))
    with torch.no_grad():
        a, _ = tph.loss(**kw, generator=torch.Generator().manual_seed(0))
        b, _ = tph.loss(**kw, generator=torch.Generator().manual_seed(0))
        c, _ = tph.loss(**kw, generator=torch.Generator().manual_seed(1))
    assert a.item() == b.item() and a.item() != c.item()
    # with a critic the same seed gives the same loss, and the critic's draws
    # come after the MaskGit's, so the generator's loss does not change
    critic = Phenaki(maskgit=tph.maskgit, cvivit=tph.cvivit, text_embed_dim=TEXT_DIM, steps=tph.steps,
                     max_text_len=tph.max_text_len, self_token_critic=True)
    with torch.no_grad():
        d, metrics = critic.loss(**kw, generator=torch.Generator().manual_seed(0))
        e, _ = critic.loss(**kw, generator=torch.Generator().manual_seed(0))
    assert d.item() == e.item() and metrics["maskgit_loss"].item() == a.item()


@pytest.mark.parametrize("which", ["attn_dropout", "ff_dropout"])
def test_dropout_options(which):
    """A dropout rate changes nothing in eval mode or under
    `Phenaki.loss(train=False)`; in training mode it changes the output
    (seeded, so repeatably). Attention dropout sends attention off the
    kernel, which has none, as on the TPU."""
    from types import SimpleNamespace

    from phenaki_tpu_torch.ops.attention import use_flash
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    base = init_parameters(MaskGit(**MASKGIT), torch.Generator().manual_seed(0))
    drop = MaskGit(**MASKGIT, **{which: 0.3})
    drop.load_state_dict(base.state_dict())
    ids, emb, _ = _loss_inputs()
    kw = dict(context=torch.from_numpy(emb))
    x = torch.from_numpy(ids).long()
    with torch.no_grad():
        ref = base.train()(x, **kw)
        assert torch.equal(drop.eval()(x, **kw), ref)
        drop.train()
        torch.manual_seed(0)
        a = drop(x, **kw)
        torch.manual_seed(0)
        assert torch.equal(drop(x, **kw), a) and not torch.allclose(a, ref)

    q = SimpleNamespace(is_cuda=True, shape=(2, 2, 128, 16))
    assert use_flash(q, None, 0.0) and not use_flash(q, None, 0.3)

    loss_kw = dict(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb))
    ph = dict(cvivit=CViViT(**CVIVIT), text_embed_dim=TEXT_DIM, steps=STEPS, max_text_len=8)
    with torch.no_grad():
        off, _ = Phenaki(maskgit=drop, **ph).loss(**loss_kw, train=False,
                                                  generator=torch.Generator().manual_seed(1))
        same, _ = Phenaki(maskgit=base, **ph).loss(**loss_kw, cond_drop_prob=0.0,
                                                   generator=torch.Generator().manual_seed(1))
    assert off.item() == same.item()


# ---------------------------------------------------------------------------
# optimizer and trainer


@pytest.mark.parametrize("cfg", [dict(wd=0.0), dict(wd=0.1), dict(wd=0.0, max_grad_norm=0.5),
                                 dict(wd=0.1, eps=1e-6, group_wd_params=False)],
                         ids=["adam", "adamw_masked", "clip", "adamw_unmasked_eps"])
def test_optimizer_matches_optax(cfg):
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
              "gamma": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), **cfg)

    jopt = j_get_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(jp)
    for g in grads:
        updates, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = get_optimizer(tp.values(), **kw)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)


def _small_phenaki(seed=0):
    gen = torch.Generator().manual_seed(seed)
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    mg = init_parameters(MaskGit(**MASKGIT), gen)
    return Phenaki(maskgit=mg, cvivit=CViViT(**CVIVIT), text_embed_dim=TEXT_DIM, steps=STEPS)


class _Ids(torch.utils.data.Dataset):
    """Seeded random (video_codebook_ids, text_embeds) pairs."""

    def __init__(self, n=8, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 64, size=(n, *GRID))
        self.emb = rng.randn(n, 5, TEXT_DIM).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def _capture_grads(trainer):
    seen = []

    def step(*_, **__):
        seen.append({n: p.grad.clone() for n, p in trainer.model.maskgit.named_parameters()})

    trainer.opt.step = step
    return seen


def _trainer(ph, tmp_path, **kw):
    """A trainer whose step-1 milestone samples one 3-frame video (128 tokens)."""
    return PhenakiTrainer(ph, dataset=_Ids(), batch_size=2, num_frames=3, num_samples=1,
                          sample_texts=["a cat"], results_folder=str(tmp_path / "results"), **kw)


def test_grad_accumulation_is_the_mean_of_micro_batches(tmp_path):
    ph = _small_phenaki()
    accum = _trainer(ph, tmp_path, grad_accum_every=2, seed=5)
    single = _trainer(ph, tmp_path, grad_accum_every=1, seed=5)
    # the step-1 milestone samples from the generator, which would put its
    # draws between single's two micro-batches; this test is about the steps
    accum._sample_and_save = single._sample_and_save = lambda milestone: None
    got, micro = _capture_grads(accum), _capture_grads(single)
    loss = accum.train_step()
    losses = [single.train_step() for _ in range(2)]
    assert abs(loss.item() - (losses[0].item() + losses[1].item()) / 2) < 1e-6
    for name, g in got[0].items():
        torch.testing.assert_close(g, (micro[0][name] + micro[1][name]) / 2, atol=1e-7, rtol=1e-5)


def test_trainer_three_steps(tmp_path):
    ph = _small_phenaki(1)
    before = {n: p.detach().clone() for n, p in ph.maskgit.named_parameters()}
    trainer = _trainer(ph, tmp_path, train_num_steps=3, log_every=1, train_lr=1e-3)
    trainer.train()
    assert trainer.checkpoints.all_steps() == [0]
    assert trainer.step == 3 and trainer.dataset_fields == ("video_codebook_ids", "text_embeds")
    assert np.isfinite(trainer.train_step().item())
    changed = [n for n, p in ph.maskgit.named_parameters() if not torch.equal(p, before[n])]
    assert "to_logits.weight" in changed and "continuous_pos_bias.net_out.weight" in changed


def test_trainer_field_inference(tmp_path):
    ids = torch.zeros(2, *GRID, dtype=torch.long)
    emb, mask, video = torch.zeros(2, 5, 16), torch.ones(2, 3, dtype=torch.bool), torch.zeros(2, 3, 8, 8, 3)
    assert determine_types([ids, emb, mask]) == ("video_codebook_ids", "text_embeds", "video_frame_mask")
    assert determine_types([video, ["a", "b"]]) == ("videos", "texts")
    assert determine_types([video.bfloat16(), emb.bfloat16()]) == ("videos", "text_embeds")
    trainer = _trainer(_small_phenaki(), tmp_path, dataset_fields=("videos", "texts"))
    assert trainer.dataset_fields == ("videos", "texts")
    with pytest.raises(ValueError, match="distinct"):
        _trainer(_small_phenaki(), tmp_path, dataset_fields=("videos", "videos"))
