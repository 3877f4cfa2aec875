"""The port's `CViViTTrainer` (phenaki_tpu_torch/training/cvivit_trainer.py)
on the CPU:

* one generator step and one discriminator step (the penalty's) against the
  JAX trainer's `_gen_step` and `_discr_step` from the same weights and
  batch, JAX's frame draws passed in: the C-ViViT's, the discriminator's and
  the EMA's parameters after Adam within 1e-4 * max|p| of each tensor,
  Adam's moments against optax's `mu` and `nu` within 1e-3 * max of each
  tensor (the gradients each optimizer saw, after clipping), and the step's
  losses within rtol 1e-4 (64 x 64 frames in 8 x 8 patches, so JAX takes its
  Pallas flash kernel in interpret mode). Adam's first step moves an
  element by lr * g / (|g| + eps), about lr * sign(g), so where |g| is at
  the two packages' f32 noise the steps differ by a fraction of lr (up to
  0.14 lr measured, in the discriminator's 256-channel convs): the test
  runs at lr 3e-6, where that stays under the tolerance, and floors
  max|p| at 1e-3, under which only tensors initialised to zero fall
  (LayerNorm betas one step from 0);
* tiny models (16 x 16 frames): 3 steps from a GIF folder (the penalty on
  step 0 only with `apply_grad_penalty_every=2`, reconstructions as GIFs
  and checkpoints at the steps `save_*_every` names);
  `grad_accum_every=2` on one repeated batch equal to one step on it;
  `train_on_images` (PNG grids of originals and reconstructions);
  a bit-identical resume (both models, both Adam states, the EMA, the
  generator); the VGG's weights from `vgg_params` and from
  PHENAKI_VGG16_PATH; `profile_dir`; `mesh=` and `fsdp=` raise;
* on the stubbed card (`tests/_torch_card_stub.py`), one train step
  launches kernel 1 in the C-ViViT's spatial attention only (the
  generator's forward and the discriminator phase's reconstruction), its
  three backward kernels once a spatial layer, and nothing in the
  discriminator's attention, whose R1 penalty runs to second order.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.models.cvivit_losses as JL  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.parallel.mesh import make_mesh  # noqa: E402

import phenaki_tpu_torch.models.cvivit_losses as L
import phenaki_tpu_torch.ops.attention as attention
import phenaki_tpu_torch.ops.flash_attention as fa
import phenaki_tpu_torch.training.cvivit_trainer as ct
from _torch_card_stub import StubLibrary, stub_card
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_cvivit_variables, load_discriminator_params
from phenaki_tpu_torch.data.codecs import gif_to_tensor, video_tensor_to_gif
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.vgg import VGG16Features
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.training.cvivit_trainer import CViViTTrainer

torch.set_num_threads(1)

CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
TINY = dict(CVIVIT, image_size=16)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, ref, rel, what, floor=1e-30):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, atol=rel * max(np.abs(ref).max(), floor),
                               rtol=0, err_msg=what)


def _trainer(cv, results, **kw):
    args = dict(num_train_steps=3, batch_size=2, num_frames=5, discr_base_dim=4, valid_frac=0.0,
                save_results_every=1000, save_model_every=1000, results_folder=str(results), log_every=1,
                seed=3)
    args.update(kw)
    return CViViTTrainer(cv, **args)


def _tiny(seed=0, **kw):
    return init_parameters(CViViT(**TINY, **kw), torch.Generator().manual_seed(seed))


def _videos(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(5, 16, 16, 3).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# one step of each phase against the JAX trainer


def test_train_step_matches_jax_trainer(tmp_path, monkeypatch):
    from phenaki_tpu.training.cvivit_trainer import CViViTTrainer as JTrainer

    monkeypatch.setattr(pa, "_INTERPRET", True)
    common = dict(num_train_steps=1, batch_size=2, discr_base_dim=4, discr_attn_res_layers=(16,), lr=3e-6,
                  save_results_every=1000, save_model_every=1000, log_every=10**9)
    jtr = JTrainer(JCViViT(**CVIVIT, scan_layers=True), mesh=make_mesh(jax.devices()[:1]),
                   results_folder=str(tmp_path / "jax"), **common)
    vae_params = _numpy_tree(jtr.state["vae_params"])
    discr_params = _numpy_tree(jtr.state["discr_params"])

    cv = load_cvivit_variables(CViViT(**CVIVIT), {"params": vae_params})
    tr = CViViTTrainer(cv, results_folder=str(tmp_path / "port"), **common)
    load_discriminator_params(tr.discr, discr_params)
    video = np.random.RandomState(8).rand(2, 3, 64, 64, 3).astype(np.float32)  # no LFQ sign tie
    tr.dl = iter([(torch.from_numpy(video),)] * 2)

    rng_gen, rng_discr = jax.random.split(jax.random.PRNGKey(5))
    draws = [torch.tensor(np.asarray(JL.pick_random_frame_indices(jax.random.split(r)[0], 2, 3)))
             for r in (rng_gen, rng_discr)]
    monkeypatch.setattr(L, "pick_random_frame_indices", lambda *a, **k: draws.pop(0))

    batch = jnp.asarray(video)
    state, g_metrics = jtr._gen_step(jtr.state, None, batch, rng_gen)
    state, d_metrics = jtr._discr_step(state, batch, rng_discr, apply_grad_penalty=True)
    logs = tr.train_step()
    assert not draws

    for key in ("loss", "recon_loss", "vq_aux_loss", "perceptual_loss", "gen_loss"):
        np.testing.assert_allclose(logs[key].item(), float(g_metrics[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(logs["adaptive_weight"].item(), float(g_metrics["adaptive_weight"]), rtol=1e-3)
    for key in ("discr_loss", "grad_penalty"):
        np.testing.assert_allclose(logs[key].item(), float(d_metrics[key]), rtol=1e-4, err_msg=key)
    assert logs["grad_penalty"].item() > 0

    for label, module, opt, tree, opt_state in (
            ("vae", tr.vae, tr.gen_opt, state["vae_params"], state["gen_opt_state"]),
            ("discr", tr.discr, tr.discr_opt, state["discr_params"], state["discr_opt_state"])):
        ref = flax_to_state_dict(_numpy_tree(tree))
        named = dict(module.named_parameters())
        assert sorted(ref) == sorted(named)
        for name, p in named.items():
            _close(p.detach().numpy(), ref[name].numpy(), 1e-4, f"{label} {name}", floor=1e-3)
        (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                   if hasattr(s, "mu")]
        moments = opt.state_dict()["state"]
        for key, ref_tree, floor in (("exp_avg", adam.mu, 1e-6), ("exp_avg_sq", adam.nu, 1e-12)):
            ref = flax_to_state_dict(_numpy_tree(ref_tree))
            for i, name in enumerate(named):
                _close(moments[i][key].numpy(), ref[name].numpy(), 1e-3, f"{label} {key} {name}", floor=floor)
    ref_ema = flax_to_state_dict(_numpy_tree(state["ema"].params))
    assert tr.ema.step == int(state["ema"].step) == 1
    for name, t in tr.ema.params.items():
        _close(t.numpy(), ref_ema[name].numpy(), 1e-4, f"ema {name}", floor=1e-3)


# ---------------------------------------------------------------------------
# tiny trainers


@pytest.fixture
def video_folder(tmp_path):
    folder = tmp_path / "videos"
    folder.mkdir()
    for i, video in enumerate(_videos()):
        video_tensor_to_gif(video, str(folder / f"{i}.gif"))
    return folder


def test_three_steps_from_a_gif_folder(tmp_path, video_folder):
    tr = _trainer(_tiny(), tmp_path / "results", folder=str(video_folder), apply_grad_penalty_every=2,
                  save_results_every=2, save_model_every=2)
    seen = []
    tr.train(log_fn=seen.append)
    assert tr.step == 3 and len(seen) == 3 and tr.ema.step == 3
    for logs in seen:
        assert all(np.isfinite(v.item()) for v in logs.values())
        assert logs["adaptive_weight"].item() > 0
    assert [logs["grad_penalty"].item() > 0 for logs in seen] == [True, False, True]
    assert tr.checkpoints.all_steps() == [0, 2]
    for name in ("samples.0", "samples.0.ema", "samples.2", "samples.2.ema"):
        label = name.split("samples.")[1]
        gifs = sorted(p.name for p in (tmp_path / "results" / name).glob("*.gif"))
        assert gifs == [f"{label}-0.gif", f"{label}-1.gif"]
        assert gif_to_tensor(str(tmp_path / "results" / name / gifs[0])).shape == (5, 16, 16, 3)


def test_grad_accumulation_of_a_repeated_batch_is_one_step(tmp_path, monkeypatch):
    monkeypatch.setattr(L, "pick_random_frame_indices", lambda gen, b, *a, **k: torch.arange(b))
    batch = (torch.from_numpy(np.stack(_videos(2))),)
    trainers = []
    for accum in (1, 2):
        tr = _trainer(_tiny(), tmp_path / f"r{accum}", grad_accum_every=accum)
        tr.dl = iter([batch] * 4)
        logs = tr.train_step()
        assert tr.ema.step == 1 and np.isfinite(logs["loss"].item())
        trainers.append((tr, logs))
    (a, la), (b, lb) = trainers
    for key in la:
        assert la[key].item() == lb[key].item(), key
    for module in ("vae", "discr"):
        for (name, p), q in zip(getattr(a, module).named_parameters(), getattr(b, module).parameters()):
            assert torch.equal(p, q), (module, name)


def test_train_on_images_writes_grids(tmp_path):
    from PIL import Image

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.RandomState(2)
    for i in range(4):
        Image.fromarray((rng.rand(20, 24, 3) * 255).astype(np.uint8)).save(folder / f"{i}.png")
    tr = _trainer(_tiny(), tmp_path / "results", folder=str(folder), train_on_images=True,
                  save_results_every=1, valid_frac=0.5)
    assert len(tr.ds) == 2 and len(tr.valid_ds) == 2
    logs = tr.train_step()
    assert np.isfinite(logs["loss"].item()) and np.isfinite(logs["discr_loss"].item())
    for name in ("0.png", "0.ema.png"):
        # originals and reconstructions interleaved, two a row: 2 x 2 images of 16 with padding 2
        assert Image.open(tmp_path / "results" / name).size == (2 * 18 + 2, 2 * 18 + 2)
    videos = _trainer(_tiny(), tmp_path / "v", dataset=_videos(), train_on_images=True)
    with pytest.raises(ValueError, match="train on images"):
        videos.train_step()


def _state(tr):
    out = {f"vae.{k}": v for k, v in tr.vae.state_dict().items()}
    out.update({f"discr.{k}": v for k, v in tr.discr.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in tr.ema.params.items()})
    for label, opt in (("gen", tr.gen_opt), ("discr", tr.discr_opt)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{label}_opt.{i}.{k}": v for k, v in s.items()})
    out["generator"] = tr.generator.get_state()
    return out


def test_resume_is_bit_identical(tmp_path):
    fixed = [_videos(1)[0]] * 4  # every batch the same: the data order does not matter

    def build(results):
        return _trainer(_tiny(), results, dataset=fixed, num_train_steps=10, seed=123)

    ran_on = build(tmp_path / "a")
    for _ in range(4):
        ran_on.train_step()
    first = build(tmp_path / "b")
    first.train_step()
    first.train_step()
    first.save(1)
    resumed = build(tmp_path / "b")
    with torch.no_grad():  # other weights than the checkpoint's: the load must replace them
        for p in [*resumed.vae.parameters(), *resumed.discr.parameters()]:
            p.add_(1.0)
    resumed.load(1)
    assert resumed.step == 2 and resumed.ema.step == 2
    resumed.train_step()
    resumed.train_step()
    a, b = _state(ran_on), _state(resumed)
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    with pytest.raises(ValueError, match="EMA"):
        _trainer(_tiny(), tmp_path / "b", dataset=fixed, use_ema=False).load(1)


def test_vgg_weights_from_params_and_from_the_environment(tmp_path, monkeypatch):
    with torch.device("meta"):
        shapes = VGG16Features().state_dict()
    weights = {k: torch.full(v.shape, 1e-3) for k, v in shapes.items()}
    tr = _trainer(_tiny(), tmp_path / "a", dataset=_videos(), vgg_params=weights)
    assert tr.perceptual_mode == "vgg" and tr.vgg.fc2.weight.eq(1e-3).all()
    assert not any(p.requires_grad for p in tr.vgg.parameters())
    logs = tr.train_step()
    assert np.isfinite(logs["perceptual_loss"].item())

    path = tmp_path / "vgg16.pth"
    path.write_bytes(b"")
    loaded = []
    monkeypatch.setattr(ct, "load_vgg16_from_file", lambda p: loaded.append(p) or weights)
    monkeypatch.setenv("PHENAKI_VGG16_PATH", str(path))
    assert _trainer(_tiny(), tmp_path / "b").vgg is None  # "disc" ignores the variable
    tr = _trainer(_tiny(), tmp_path / "c", perceptual_mode="vgg")
    assert loaded == [str(path)] and tr.vgg.fc2.weight.eq(1e-3).all()


def test_profile_dir_writes_a_trace(tmp_path):
    tr = _trainer(_tiny(), tmp_path / "results", dataset=_videos(), profile_dir=str(tmp_path / "prof"),
                  profile_steps=(1, 2), use_vgg_and_gan=False)
    for _ in range(3):
        logs = tr.train_step()
        assert sorted(logs) == ["loss", "recon_loss", "vq_aux_loss"]
    (trace,) = (tmp_path / "prof").glob("*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def test_arguments_checked(tmp_path):
    for parallel in (dict(mesh=object()), dict(fsdp=True)):
        with pytest.raises(NotImplementedError, match="A13"):
            _trainer(_tiny(), tmp_path / "r", **parallel)
    with pytest.raises(ValueError, match="perceptual_mode"):
        _trainer(_tiny(), tmp_path / "r", perceptual_mode="lpips")
    with pytest.raises(ValueError, match="no dataset"):
        _trainer(_tiny(), tmp_path / "r").train_step()


def test_vq_codebook_moves_in_the_generator_phase(tmp_path):
    tr = _trainer(_tiny(lookup_free_quantization=False), tmp_path / "r", dataset=_videos())
    embed = tr.vae.vq.embed.clone()
    tr.train_step()
    assert not torch.equal(embed, tr.vae.vq.embed)
    assert "vq.embed" in tr.checkpoints.restore(0)["vae"]


# ---------------------------------------------------------------------------
# the card route, stubbed


def test_train_step_launches_on_the_stubbed_card(tmp_path, monkeypatch):
    """A step at 64 spatial tokens (kernel 1's gate passes): the C-ViViT's
    one encoder and one decoder spatial layer launch the forward in the
    generator phase and again in the discriminator phase's reconstruction,
    and dQ, dK/dV and dBias (the CPB bias is trained) once each; the
    discriminator's attention at 8 x 8 positions (64 tokens, 64 channels)
    would pass the gate too, but takes the plain path, also under the R1
    penalty."""
    monkeypatch.setattr(attention, "use_flash",
                        lambda q, bias, dropout=0.0: dropout == 0 and attention.flash_applies(q.shape, bias))
    cv = init_parameters(CViViT(**CVIVIT), torch.Generator().manual_seed(0))
    tr = _trainer(cv, tmp_path / "r", dataset=[np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)] * 2,
                  apply_grad_penalty_every=1)
    assert tr.discr.attn_blocks
    tr.step = 1  # past step 0's reconstructions and checkpoint
    names = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_bwd_dbias")
    before = [getattr(fa, n).launches for n in names]
    lib = StubLibrary()
    undo = stub_card(lib)
    try:
        logs = tr.train_step()
    finally:
        undo()
    spatial = 2 * CVIVIT["spatial_depth"]  # encoder + decoder
    assert tuple(getattr(fa, n).launches - c for n, c in zip(names, before)) == (2 * spatial, spatial, spatial,
                                                                                    spatial)
    fwd = [call for name, call in lib.calls if name == "fwd"]
    assert len(fwd) == 2 * spatial and all((c["i"], c["j"], c["h"], c["d"]) == (64, 64, 2, 16) for c in fwd)
    assert logs["grad_penalty"].item() >= 0
