"""Training from raw videos and texts on the CPU (phenaki_tpu_torch/models/
phenaki.py `Phenaki.loss(videos=)`, `__call__`, `save`/`load`;
phenaki_tpu_torch/training/phenaki_trainer.py):

* `Phenaki.loss(videos=)` on a video (with a frame mask) and on images,
  against the JAX `Phenaki.loss(videos=)` on bridged weights (the C-ViViT
  through `load_cvivit_variables`, the MaskGit through `load_flax_params`,
  both `scan_layers=True`), with the JAX draws reproduced from the same
  `jax.random.split(rng, 7)` as `tests/test_torch_train.py` does, Pallas
  in interpret mode. The seed's pre-sign activations all have |z| > 1e-4
  (asserted), so the ids must be equal; loss rtol 1e-5; each MaskGit
  gradient within 1e-3 * max|g| of its tensor (max|g| floored at 1e-5);
* `__call__(texts=)` equals `loss` on `embed_texts` of the same texts;
  `save`/`load` round-trip the MaskGit, the critic and the C-ViViT;
* `PhenakiTrainer` on tiny models, mirroring tests/test_trainers.py: the
  mock dataset's fields are ("videos", "texts"); a milestone writes GIFs
  and a checkpoint; image mode writes a PNG grid; `only_train_critic`
  leaves the MaskGit unmoved; a resume is bit-identical with
  `grad_accum_every=2`; `profile_dir` writes a trace; `folder=` of videos
  or images trains an unconditional model.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.data.codecs import video_tensor_to_gif as j_video_tensor_to_gif  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_cvivit_variables, load_flax_params
from phenaki_tpu_torch.data.codecs import gif_to_tensor
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

TEXT_DIM, STEPS = 16, 4
# 64 x 64 frames in 8 x 8 patches: 64 tokens a latent frame, so a 3-frame
# video's 128 tokens and an image's 64 pass the flash gate (i >= 64)
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=128, depth=2, heads=2, dim_head=16,
               dim_context=TEXT_DIM)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def phenakis():
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = _numpy_tree(jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3))))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   steps=STEPS, text_embed_dim=TEXT_DIM, max_text_len=8)
    jph.init(jax.random.PRNGKey(1))
    params = _numpy_tree(jph.params["maskgit"])
    tph = Phenaki(maskgit=load_flax_params(MaskGit(**MASKGIT), params),
                  cvivit=load_cvivit_variables(CViViT(**CVIVIT), cv_vars), text_embed_dim=TEXT_DIM,
                  steps=STEPS, max_text_len=8)
    return jph, params, tph


def _raw_inputs(form):
    rng = np.random.RandomState(11)
    shape = (2, 3, 64, 64, 3) if form == "video" else (2, 64, 64, 3)
    pixels = rng.rand(*shape).astype(np.float32)
    emb = rng.randn(2, 6, TEXT_DIM).astype(np.float32)
    emb[0, 4:] = 0.0  # padding rows
    emb[1, 2:] = 0.0
    frame_mask = np.array([[1, 1, 1], [1, 0, 0]], bool) if form == "video" else None
    return pixels, emb, frame_mask


@pytest.mark.parametrize("form", ["video", "image"])
def test_loss_from_videos_matches_jax(phenakis, monkeypatch, form):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    jph, params, tph = phenakis
    pixels, emb, frame_mask = _raw_inputs(form)
    x = torch.from_numpy(pixels)

    # the seed keeps every pre-sign activation away from the sign tie, so
    # the ids must be equal
    with torch.no_grad():
        tokens, _ = tph.cvivit._encoded(x)
        z = tph.cvivit.vq.pre_sign(tokens.reshape(2, -1, tokens.shape[-1]))
    assert z.abs().min().item() > 1e-4
    ids = tph.cvivit.tokenize(x)
    ref_ids = jph.cvivit.apply(jph.cvivit_vars, jnp.asarray(pixels), method=JCViViT.tokenize)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))

    rng = jax.random.PRNGKey(9)
    kw = dict(text_embeds=emb, cond_drop_prob=0.0)
    if frame_mask is not None:
        kw["video_frame_mask"] = frame_mask

    def j_loss(mg_params):
        loss, _ = jph.loss({"maskgit": mg_params, "critic": None}, rng, videos=jnp.asarray(pixels),
                           **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        return loss

    ref_loss, ref_grads = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, params))

    n = ids[0].numel()
    rng_mask, rng_step = jax.random.split(rng, 7)[:2]
    step = np.asarray(jax.random.randint(rng_step, (2,), 0, STEPS))
    noise = np.asarray(jax.random.uniform(rng_mask, (2, n)))
    monkeypatch.setattr(tph, "_loss_draws", lambda b, n_, gen, device: (
        torch.from_numpy(step.copy()).long(), torch.from_numpy(noise.copy())))
    tph.maskgit.zero_grad(set_to_none=True)
    loss, metrics = tph.loss(videos=x, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                          for k, v in kw.items()})
    loss.backward()
    assert metrics["loss"] is loss
    assert not any(p.grad is not None for p in tph.cvivit.parameters())  # the C-ViViT is frozen
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)

    ref = flax_to_state_dict(_numpy_tree(ref_grads))
    named = dict(tph.maskgit.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-5), rtol=0,
                                   err_msg=name)
    tph.maskgit.zero_grad(set_to_none=True)

    # the same loss from the ids the C-ViViT gave
    loss_ids, _ = tph.loss(video_codebook_ids=ids, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                                                      else v for k, v in kw.items()})
    assert loss_ids.item() == loss.item()


def test_call_with_texts_equals_loss_on_their_embeddings(phenakis):
    _, _, tph = phenakis
    pixels, _, frame_mask = _raw_inputs("video")
    x, mask = torch.from_numpy(pixels), torch.from_numpy(frame_mask)
    texts = ["a red ball rolls", "two dogs run on the beach"]
    with torch.no_grad():
        got = tph(x, texts=texts, video_frame_mask=mask, generator=torch.Generator().manual_seed(3))
        ref, _ = tph.loss(videos=x, text_embeds=tph.embed_texts(texts), video_frame_mask=mask,
                          generator=torch.Generator().manual_seed(3))
        ids = tph.cvivit.tokenize(x)
        by_ids = tph(video_codebook_ids=ids, text_embeds=tph.embed_texts(texts), video_frame_mask=mask,
                     generator=torch.Generator().manual_seed(3))
    assert got.ndim == 0 and got.item() == ref.item() == by_ids.item()
    with pytest.raises(ValueError, match="not both"):
        tph(x, texts=texts, text_embeds=tph.embed_texts(texts))
    with pytest.raises(ValueError, match="exactly one"):
        tph.loss(videos=x, video_codebook_ids=ids, text_embeds=tph.embed_texts(texts))


# ---------------------------------------------------------------------------
# the trainer, on tiny models (16 x 16 frames, 4 tokens a latent frame)

TINY_CVIVIT = dict(CVIVIT, image_size=16)


def _tiny(seed=0, critic=False, unconditional=False):
    gen = torch.Generator().manual_seed(seed)
    cv = init_parameters(CViViT(**TINY_CVIVIT), gen)
    ctx = dict(unconditional=True) if unconditional else dict(dim_context=TEXT_DIM)
    mg = init_parameters(MaskGit(dim=32, num_tokens=64, max_seq_len=64, depth=1, heads=2, dim_head=16, **ctx),
                         gen)
    tc = None
    if critic:
        tc = init_parameters(TokenCritic(dim=32, num_tokens=64, max_seq_len=64, depth=1, heads=2, dim_head=16,
                                         has_cross_attn=True, dim_context=TEXT_DIM), gen)
    return Phenaki(maskgit=mg, cvivit=cv, critic=tc, text_embed_dim=TEXT_DIM, steps=2, max_text_len=8)


class MockTextVideoDataset(torch.utils.data.Dataset):
    """Random 5-frame 16 x 16 videos with a caption (tests/test_trainers.py's)."""

    def __init__(self, length=8, image=False):
        self.length = length
        self.shape = (16, 16, 3) if image else (5, 16, 16, 3)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return np.random.rand(*self.shape).astype(np.float32), "a video of a cat"


def _trainer(ph, results, **kw):
    args = dict(dataset=MockTextVideoDataset(), batch_size=2, num_frames=5, sample_num_frames=3,
                train_num_steps=2, num_samples=1, save_and_sample_every=1000, results_folder=str(results),
                sample_texts=["a cat"], log_every=1)
    args.update(kw)
    return PhenakiTrainer(ph, **args)


def test_trainer_with_mock_dataset(tmp_path):
    trainer = _trainer(_tiny(), tmp_path / "results")
    loss1 = trainer.train_step()
    assert np.isfinite(loss1.item())
    assert trainer.dataset_fields == ("videos", "texts")
    trainer.train()
    assert trainer.step == 2
    assert trainer.checkpoints.all_steps() == [0]  # step 1 was the only milestone
    (gif,) = (tmp_path / "results" / "videos.0").glob("*.gif")
    assert gif.name == "a_cat.gif" and gif_to_tensor(str(gif)).shape == (3, 16, 16, 3)


def test_trainer_sampling_artifacts(tmp_path):
    texts = ["a cat dancing", "a dog, running - fast"]
    (tmp_path / "texts.txt").write_text("\n".join(texts) + "\n\n")
    trainer = _trainer(_tiny(), tmp_path / "results", num_samples=4, save_and_sample_every=1,
                       sample_texts=None, sample_texts_file_path=str(tmp_path / "texts.txt"))
    assert trainer.sample_texts == texts
    drawn = []
    sample_artifacts = trainer._sample_artifacts
    trainer._sample_artifacts = lambda m: drawn.append(sample_artifacts(m)) or drawn[-1]
    trainer.train_step()
    trainer.train_step()
    trainer.checkpoints.wait()
    slugs = {"a cat dancing": "a_cat_dancing.gif", "a dog, running - fast": "a_dog_running___fast.gif"}
    assert len(drawn) == 2
    for m, captions in enumerate(drawn):
        # one GIF a distinct caption drawn, each of the sampled frames
        gifs = sorted((tmp_path / "results" / f"videos.{m}").glob("*.gif"))
        assert len(captions) == 4 and [g.name for g in gifs] == sorted(slugs[c] for c in set(captions))
        assert all(gif_to_tensor(str(g)).shape == (3, 16, 16, 3) for g in gifs)
    assert trainer.checkpoints.all_steps() == [0, 1] and trainer.checkpoints.latest_step == 1


def test_trainer_image_mode(tmp_path):
    trainer = _trainer(_tiny(), tmp_path / "results", dataset=MockTextVideoDataset(image=True),
                       train_on_images=True, num_samples=4, save_and_sample_every=1)
    loss = trainer.train_step()
    assert np.isfinite(loss.item())
    png = tmp_path / "results" / "0.png"
    from PIL import Image

    assert Image.open(png).size == (2 * 18 + 2, 2 * 18 + 2)  # 2 x 2 images of 16 with padding 2
    videos = _trainer(_tiny(), tmp_path / "videos", train_on_images=True)
    with pytest.raises(ValueError, match="train on images"):
        videos.train_step()


def test_trainer_only_train_critic(tmp_path):
    trainer = _trainer(_tiny(critic=True), tmp_path / "results")
    ph = trainer.model
    before = {n: p.detach().clone() for n, p in ph.maskgit.named_parameters()}
    before_c = {n: p.detach().clone() for n, p in ph.critic.named_parameters()}
    trainer.train_step(only_train_critic=True)
    assert all(torch.equal(p, before[n]) for n, p in ph.maskgit.named_parameters())
    assert any(not torch.equal(p, before_c[n]) for n, p in ph.critic.named_parameters())
    assert "critic" in trainer.checkpoints.restore(0)["params"]


def test_trainer_true_resume_bitwise(tmp_path):
    """Train -> save -> a fresh trainer loads -> continue: bit-identical to
    the uninterrupted run (parameters, Adam's state, the generator)."""
    video = np.random.RandomState(1).rand(5, 16, 16, 3).astype(np.float32)
    fixed = [(video, "a video of a cat")] * 4  # every batch the same: the order does not matter

    def build(results):
        return _trainer(_tiny(), results, dataset=fixed, grad_accum_every=2, train_num_steps=10, seed=123)

    tr_a = build(tmp_path / "a")
    for _ in range(4):
        tr_a.train_step()
    tr_b = build(tmp_path / "b")
    tr_b.train_step()
    tr_b.train_step()
    tr_b.save(1)
    tr_c = build(tmp_path / "b")
    with torch.no_grad():  # other weights than the checkpoint's: the load must replace them
        for p in tr_c.model.maskgit.parameters():
            p.add_(1.0)
    tr_c.load(1)
    assert tr_c.step == 2
    tr_c.train_step()
    tr_c.train_step()
    for (name, p), (_, q) in zip(tr_a.model.maskgit.named_parameters(), tr_c.model.maskgit.named_parameters()):
        assert torch.equal(p, q), name
    sa, sc = tr_a.opt.state_dict(), tr_c.opt.state_dict()
    assert sa["state"].keys() == sc["state"].keys()
    for k in sa["state"]:
        for key, v in sa["state"][k].items():
            assert torch.equal(v, sc["state"][k][key]), (k, key)
    assert torch.equal(tr_a.generator.get_state(), tr_c.generator.get_state())
    with pytest.raises(ValueError, match="critic"):
        _trainer(_tiny(critic=True), tmp_path / "b").load(1)


def test_trainer_profile_dir_writes_a_trace(tmp_path):
    trainer = _trainer(_tiny(), tmp_path / "results", profile_dir=str(tmp_path / "prof"),
                       profile_steps=(1, 2))
    trainer.train_step()
    assert not (tmp_path / "prof").exists()
    trainer.train_step()  # the trace starts before step index 1 ...
    trainer.train_step()  # ... and is written before step index 2
    (trace,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("loss" in str(e.get("name", "")) or "aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("kind", ["videos", "images"])
def test_trainer_from_a_folder_unconditional(tmp_path, kind):
    folder = tmp_path / "data"
    folder.mkdir()
    rng = np.random.RandomState(2)
    for i in range(4):
        if kind == "videos":
            j_video_tensor_to_gif(rng.rand(5, 20, 20, 3).astype(np.float32), str(folder / f"{i}.gif"))
        else:
            from PIL import Image

            Image.fromarray((rng.rand(20, 24, 3) * 255).astype(np.uint8)).save(folder / f"{i}.png")
    ph = _tiny(unconditional=True)
    trainer = _trainer(ph, tmp_path / "results", dataset=None, folder=str(folder), sample_texts=None,
                       train_on_images=kind == "images", num_samples=4)
    before = {n: p.detach().clone() for n, p in ph.maskgit.named_parameters()}
    assert np.isfinite(trainer.train_step().item())
    assert trainer.dataset_fields == ("videos",)
    assert any(not torch.equal(p, before[n]) for n, p in ph.maskgit.named_parameters())
    if kind == "videos":
        names = sorted(p.name for p in (tmp_path / "results" / "videos.0").glob("*.gif"))
        assert names == ["0.gif", "1.gif", "2.gif", "3.gif"]
    else:
        assert (tmp_path / "results" / "0.png").exists()


def test_trainer_arguments_checked(tmp_path):
    with pytest.raises(ValueError, match="sample_texts"):
        _trainer(_tiny(), tmp_path / "r", sample_texts=None)
    with pytest.raises(ValueError, match="square root"):
        _trainer(_tiny(), tmp_path / "r", num_samples=3)
    with pytest.raises(ValueError, match="folder"):
        _trainer(_tiny(), tmp_path / "r", dataset=None, train_on_images=True)
    with pytest.raises(ValueError, match="no dataset"):
        _trainer(_tiny(), tmp_path / "r", dataset=None).train_step()
    # pp = 2 needs two ranks; microbatches need a pipeline; a mesh must be a Mesh
    with pytest.raises(ValueError, match="pp"):
        _trainer(_tiny(), tmp_path / "r", pp=2)
    with pytest.raises(ValueError, match="pipeline_microbatches needs pp > 1"):
        _trainer(_tiny(), tmp_path / "r", pipeline_microbatches=2)
    with pytest.raises(TypeError, match="Mesh"):
        _trainer(_tiny(), tmp_path / "r", mesh=object())


@pytest.mark.parametrize("critic", ["none", "token", "self"])
def test_phenaki_save_load_round_trip(tmp_path, critic):
    def build(seed):
        ph = _tiny(seed, critic=critic == "token")
        if critic == "self":
            ph = Phenaki(maskgit=ph.maskgit, cvivit=ph.cvivit, text_embed_dim=TEXT_DIM, steps=2,
                         max_text_len=8, self_token_critic=True)
        return ph

    src, dst = build(0), build(5)
    src.save(tmp_path / "ph.pt")
    dst.load(tmp_path / "ph.pt")
    mods = [("maskgit", src.maskgit, dst.maskgit), ("cvivit", src.cvivit, dst.cvivit)]
    if critic != "none":
        mods.append(("critic", src.critic, dst.critic))
    for label, a, b in mods:
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (label, key)
    if critic == "self":
        assert sorted(src.critic.state_dict()) == ["to_pred.bias", "to_pred.weight"]
    other = build(1) if critic == "none" else _tiny(1)
    if critic != "none":
        with pytest.raises(ValueError, match="critic"):
            other.load(tmp_path / "ph.pt")
