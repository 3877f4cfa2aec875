"""The port's C-ViViT GAN pieces against the JAX package on bridged
weights, fp32 on the CPU (phenaki_tpu_torch/models/cvivit.py
`Discriminator`, models/vgg.py, models/cvivit_losses.py, training/ema.py,
the bridge's conv rules, ops/attention.py's `use_flash` and
ops/flash_attention.py's first-order guard):

* `Discriminator` logits and block features within 1e-4 * max|ref| (a
  square and an oblong frame; the space-to-depth channel order and the
  channels-last flatten before `to_logits` both show there);
* `VGG16Features` within 1e-4 * max|ref|, at a frame the trunk shrinks to
  2 x 2 (resized up) and at the flagship 256 x 128 (8 x 4: H down, W up);
  the resize alone against `jax.image.resize` down (8 -> 7, 14 -> 7) and up
  (4 -> 7) within atol 1e-6;
* every term of `cvivit_generator_loss` in each perceptual mode (JAX's frame
  draw passed in) within rtol 1e-4, the adaptive weight within rtol 1e-3,
  every C-ViViT gradient within 1e-3 * max|g| of its tensor, max|g|
  floored at 1e-5 as in tests/test_torch_raw_train.py (the pre-sign activations all
  have |z| > 1e-4, asserted, so the LFQ ids agree); the C-ViViT (64 x 64
  frames in 8 x 8 patches) sends JAX through its Pallas flash kernel in
  interpret mode;
* `gradient_penalty` and `cvivit_discriminator_loss` with and without the
  penalty: loss within rtol 1e-4, discriminator gradients (second order
  through the plain attention) within 1e-3 * max|g| (floored as above);
* `ema_update` (warm-up, `update_every`, `apply`) within 1e-7;
* a double backward through either flash autograd Function raises;
  `Attention(use_flash=False)` reaches no kernel on the stubbed card;
* the bridge: a 4-D conv kernel's layout, strict loads of discriminator and
  VGG variables, and a torchvision-layout VGG state dict through
  `load_torch_state_dict` and `load_vgg16_from_file`.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.models.cvivit_losses as JL  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.cvivit import Discriminator as JDiscriminator  # noqa: E402
from phenaki_tpu.models.vgg import VGG16Features as JVGG  # noqa: E402
from phenaki_tpu.models.vgg import _adaptive_avg_pool  # noqa: E402
from phenaki_tpu.training.ema import ema_init as j_ema_init  # noqa: E402
from phenaki_tpu.training.ema import ema_update as j_ema_update  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402

import phenaki_tpu_torch.models.cvivit_losses as L
import phenaki_tpu_torch.ops.attention as attention
import phenaki_tpu_torch.ops.flash_attention as fa
from _torch_card_stub import StubLibrary, stub_card
from phenaki_tpu_torch.bridge import (
    flax_to_state_dict,
    load_cvivit_variables,
    load_discriminator_params,
    load_vgg_params,
)
from phenaki_tpu_torch.models.cvivit import CViViT, Discriminator
from phenaki_tpu_torch.models.vgg import (
    VGG16Features,
    init_vgg,
    linear_resize,
    load_torch_state_dict,
    load_vgg16_from_file,
)
from phenaki_tpu_torch.training.ema import ema_init, ema_update

torch.set_num_threads(1)

# 64 x 64 frames in 8 x 8 patches: 64 spatial tokens, so JAX takes its
# Pallas flash kernel (interpret mode)
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
DISCR = dict(dim=4, image_size=64, attn_res_layers=(16,))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, atol=rel * max(np.abs(ref).max(), 1e-30), rtol=0, err_msg=what)


@functools.lru_cache(maxsize=None)
def _discriminator(image_size=64, attn_res_layers=(16,), seed=1):
    jd = JDiscriminator(dim=4, image_size=image_size, attn_res_layers=attn_res_layers)
    hw = image_size if isinstance(image_size, tuple) else (image_size, image_size)
    variables = _numpy_tree(jit_init(jd, jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3))))
    d = load_discriminator_params(Discriminator(dim=4, image_size=image_size,
                                                attn_res_layers=attn_res_layers), variables)
    return jd, variables, d


@functools.lru_cache(maxsize=None)
def _vgg():
    jv = JVGG()
    variables = _numpy_tree(jit_init(jv, jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))))
    return jv, variables, load_vgg_params(VGG16Features(), variables)


@pytest.fixture(scope="module")
def models():
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = _numpy_tree(jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3))))
    return jcv, cv_vars, load_cvivit_variables(CViViT(**CVIVIT), cv_vars)


def _video(seed=8, shape=(2, 3, 64, 64, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _assert_no_sign_tie(cv, x):
    """The LFQ ids of both packages must agree: no pre-sign activation near 0."""
    with torch.no_grad():
        tokens, _ = cv._encoded(x)
        z = cv.vq.pre_sign(tokens.reshape(x.shape[0], -1, tokens.shape[-1]))
    assert z.abs().min().item() > 1e-4


# ---------------------------------------------------------------------------
# the discriminator and the VGG


@pytest.mark.parametrize("image_size,attn", [(64, (16,)), ((64, 32), (8,))], ids=["square", "oblong"])
def test_discriminator_matches_jax(image_size, attn):
    jd, variables, d = _discriminator(image_size, attn)
    hw = image_size if isinstance(image_size, tuple) else (image_size, image_size)
    x = _video(1, (2, *hw, 3))
    ref_logits, ref_feats = jd.apply(variables, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        logits, feats = d(torch.from_numpy(x), return_features=True)
    assert logits.shape == (2,) and len(feats) == len(ref_feats) == d.num_blocks
    assert d.attn_blocks and all(not a.use_flash for n, a in d.named_children() if n.startswith("attn_"))
    _close(logits, ref_logits, 1e-4, "logits")
    for i, (f, r) in enumerate(zip(feats, ref_feats)):
        assert tuple(f.shape) == r.shape
        _close(f, r, 1e-4, f"feature {i}")


@pytest.mark.parametrize("in_hw", [(8, 4), (14, 4), (4, 7), (7, 7)], ids=["8to7", "14to7", "4to7", "same"])
def test_linear_resize_matches_jax_image_resize(in_hw):
    x = _video(2, (2, *in_hw, 5))
    ref = np.asarray(_adaptive_avg_pool(jnp.asarray(x), (7, 7)))
    got = linear_resize(torch.from_numpy(x), (7, 7)).numpy()
    assert got.shape == ref.shape == (2, 7, 7, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(64, 64), (256, 128)], ids=["trunk_2x2", "flagship_8x4"])
def test_vgg_features_match_jax(hw):
    jv, variables, v = _vgg()
    x = _video(3, (1, *hw, 3))
    ref = np.asarray(jv.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = v(torch.from_numpy(x))
    assert got.shape == (1, 4096)
    _close(got, ref, 1e-4)


def test_init_vgg_is_seeded_he_normal():
    a, b = init_vgg(7), init_vgg(7)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    w = a.conv_5.weight  # 256 x 128 x 3 x 3
    std = (2.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.05 and w.abs().max().item() <= 2 * std / 0.8796 + 1e-6
    assert a.conv_5.bias.abs().max().item() == 0.0
    with torch.no_grad():
        feats = a(torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0)))
    assert feats.shape == (1, 4096) and feats.abs().max().item() > 0  # the pool guard keeps a 1 x 1 trunk


# ---------------------------------------------------------------------------
# the losses


def _j_frame_indices(rng, b, f, mask=None):
    rng_frame, _ = jax.random.split(rng)
    return np.asarray(JL.pick_random_frame_indices(rng_frame, b, f, None if mask is None else jnp.asarray(mask)))


GEN_CASES = {"vgg": ("vgg", True, False), "disc": ("disc", True, False), "none": ("none", True, False),
             "disc_bce_masked": ("disc", False, True)}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generator_loss_matches_jax(models, monkeypatch, case):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    mode, hinge, masked = GEN_CASES[case]
    jcv, cv_vars, cv = models
    jd, d_vars, d = _discriminator()
    d.requires_grad_(False)
    jv = v_vars = v = None
    if mode == "vgg":
        jv, v_vars, v = _vgg()
    video = _video()
    mask = np.array([[1, 1, 1], [1, 1, 0]], bool) if masked else None
    x = torch.from_numpy(video)
    _assert_no_sign_tie(cv, x)

    rng = jax.random.PRNGKey(4)

    def j_loss(params, d_vars, v_vars):
        (loss, aux), _ = JL.cvivit_generator_loss(
            jcv, {"params": params}, jnp.asarray(video), rng, mask=None if mask is None else jnp.asarray(mask),
            discr=jd, discr_vars=d_vars, vgg=jv, vgg_vars=v_vars, use_hinge_loss=hinge, deterministic=True,
            perceptual_mode=mode)
        aux = {k: v_ for k, v_ in aux.items() if k != "recon_video"}
        return loss, aux

    # jitted, with the weights as arguments (not constants of the program)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (cv_vars["params"], d_vars, v_vars)))

    cv.zero_grad(set_to_none=True)
    idx = torch.tensor(_j_frame_indices(rng, 2, 3, mask))
    loss, aux = L.cvivit_generator_loss(cv, x, mask=None if mask is None else torch.from_numpy(mask),
                                        discr=d, vgg=v, use_hinge_loss=hinge, perceptual_mode=mode,
                                        frame_indices=idx)
    loss.backward()
    for key in ("recon_loss", "vq_aux_loss", "perceptual_loss", "gen_loss", "loss"):
        np.testing.assert_allclose(aux[key].item(), float(ref_aux[key]), rtol=1e-4, atol=0, err_msg=key)
    assert aux["adaptive_weight"].item() > 0 and not aux["adaptive_weight"].requires_grad
    np.testing.assert_allclose(aux["adaptive_weight"].item(), float(ref_aux["adaptive_weight"]), rtol=1e-3)
    assert all(p.grad is None for p in d.parameters())

    ref = flax_to_state_dict(_numpy_tree(ref_grads))
    named = dict(cv.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
        np.testing.assert_allclose(g, r, atol=1e-3 * max(np.abs(r).max(), 1e-5), rtol=0, err_msg=name)
    cv.zero_grad(set_to_none=True)


def test_generator_loss_without_gan_is_recon_plus_aux(models):
    _, _, cv = models
    loss, aux = L.cvivit_generator_loss(cv, torch.from_numpy(_video()), use_vgg_and_gan=False)
    assert loss.item() == (aux["recon_loss"] + aux["vq_aux_loss"]).item()
    assert "adaptive_weight" not in aux
    with pytest.raises(ValueError, match="discriminator"):
        L.cvivit_generator_loss(cv, torch.from_numpy(_video()))


def _discr_grads_vs_jax(jd, d_vars, d, loss_of_params, loss_torch):
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(loss_of_params, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, d_vars["params"]))
    d.requires_grad_(True)
    d.zero_grad(set_to_none=True)
    loss, aux = loss_torch()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4, atol=0)
    ref = flax_to_state_dict(_numpy_tree(ref_grads))
    named = dict(d.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)  # unreached: zeros, as in JAX
        np.testing.assert_allclose(g, r, atol=1e-3 * max(np.abs(r).max(), 1e-5), rtol=0, err_msg=name)
    d.zero_grad(set_to_none=True)
    return aux, ref_aux


def test_gradient_penalty_matches_jax():
    jd, d_vars, d = _discriminator()
    frames = _video(8, (2, 64, 64, 3))

    def j_gp(params):
        gp = JL.gradient_penalty(jd, {"params": params}, jnp.asarray(frames))
        return gp, {}

    aux, _ = _discr_grads_vs_jax(jd, d_vars, d, j_gp,
                                 lambda: (L.gradient_penalty(d, torch.from_numpy(frames)), {}))


@pytest.mark.parametrize("grad_penalty", [True, False], ids=["penalty", "no_penalty"])
def test_discriminator_loss_matches_jax(models, monkeypatch, grad_penalty):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    jcv, cv_vars, cv = models
    jd, d_vars, d = _discriminator()
    video = _video(9)
    _assert_no_sign_tie(cv, torch.from_numpy(video))
    rng = jax.random.PRNGKey(12)

    def j_loss(params):
        return JL.cvivit_discriminator_loss(jcv, jd, cv_vars, {"params": params}, jnp.asarray(video), rng,
                                            apply_grad_penalty=grad_penalty)

    idx = torch.tensor(_j_frame_indices(rng, 2, 3))
    aux, ref_aux = _discr_grads_vs_jax(
        jd, d_vars, d, j_loss,
        lambda: L.cvivit_discriminator_loss(cv, d, torch.from_numpy(video), apply_grad_penalty=grad_penalty,
                                            frame_indices=idx))
    assert all(p.grad is None for p in cv.parameters())
    for key in ("discr_loss", "grad_penalty"):
        np.testing.assert_allclose(aux[key].item(), float(ref_aux[key]), rtol=1e-4, atol=1e-7, err_msg=key)
    assert (aux["grad_penalty"].item() > 0) == grad_penalty


def test_gan_losses_and_frame_picks():
    gen = torch.Generator().manual_seed(0)
    fake, real = torch.randn(6, generator=gen), torch.randn(6, generator=gen)
    for name in ("hinge_discr_loss", "bce_discr_loss"):
        ref = getattr(JL, name)(jnp.asarray(fake.numpy()), jnp.asarray(real.numpy()))
        np.testing.assert_allclose(getattr(L, name)(fake, real).item(), float(ref), rtol=1e-6)
    for name in ("hinge_gen_loss", "bce_gen_loss"):
        ref = getattr(JL, name)(jnp.asarray(fake.numpy()))
        np.testing.assert_allclose(getattr(L, name)(fake).item(), float(ref), rtol=1e-6)
    mask = torch.tensor([[True, False, False], [False, True, True]])
    for _ in range(5):
        idx = L.pick_random_frame_indices(gen, 2, 3, mask)
        assert idx[0] == 0 and idx[1] in (1, 2)
    video = torch.arange(2 * 3 * 1 * 1 * 1).float().reshape(2, 3, 1, 1, 1)
    assert L.pick_video_frame(video, torch.tensor([2, 0])).flatten().tolist() == [2.0, 3.0]
    assert L._lift_to_rgb(torch.zeros(2, 4, 4, 1)).shape == (2, 4, 4, 3)
    assert L.safe_div(torch.tensor(1.0), torch.tensor(0.0)).item() == pytest.approx(1e8)


# ---------------------------------------------------------------------------
# the EMA

EMA_CASES = {"warmup": dict(update_after_step=2), "every_3": dict(update_every=3),
             "apply_gate": dict(update_after_step=1, update_every=2)}


@pytest.mark.parametrize("case", list(EMA_CASES))
def test_ema_update_matches_jax(case):
    kw = EMA_CASES[case]
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    j_state = j_ema_init({k: jnp.asarray(v) for k, v in params.items()})
    state = ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    for i in range(7):
        new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        apply = None if case != "apply_gate" else i % 2 == 0
        j_state = j_ema_update(j_state, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.9,
                               apply=None if apply is None else jnp.asarray(apply), **kw)
        state = ema_update(state, {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.9, apply=apply,
                           **kw)
        assert state.step == int(j_state.step)
        for k in params:
            np.testing.assert_allclose(state.params[k].numpy(), np.asarray(j_state.params[k]), atol=1e-7,
                                       rtol=0, err_msg=f"{k} after update {i}")


# ---------------------------------------------------------------------------
# the first-order guard and the use_flash switch


def _qkv(seed=0, shape=(1, 2, 64, 16)):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).requires_grad_() for _ in range(3)]


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attend_chunk"])
def test_double_backward_through_a_flash_function_raises(fn):
    q, k, v = _qkv()
    if fn == "flash_attention":
        out = fa.flash_attention(q, k, v, scale=8.0)
    else:
        out = fa.flash_attend_chunk(q, k, v, c2=torch.tensor(20.0), scale=8.0)[0]
    (dq,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_use_flash_false_reaches_no_kernel(monkeypatch):
    """On the stubbed card, an attention that passes the kernel's gate
    launches kernel 1 and its backward; the same module with
    `use_flash=False`, and the discriminator's attention, launch nothing."""
    monkeypatch.setattr(attention, "use_flash", lambda q, bias, dropout=0.0: attention.flash_applies(q.shape, bias))
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(1))
    _, _, d = _discriminator()
    d.requires_grad_(True)
    frames = torch.from_numpy(_video(9, (2, 64, 64, 3)))
    for use_flash, module in ((True, attention.Attention(64)), (False, attention.Attention(64, use_flash=False)),
                              (False, d)):
        lib = StubLibrary()
        undo = stub_card(lib)
        try:
            if module is d:
                L.gradient_penalty(d, frames).backward()
            else:
                module(x.clone().requires_grad_()).sum().backward()
        finally:
            undo()
        names = [name for name, _ in lib.calls]
        assert names == (["fwd", "dq", "dkv"] if use_flash else []), (type(module).__name__, names)
    d.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the bridge's conv rules and the VGG loaders


def test_conv_kernel_layout_and_strict_discriminator_load():
    jd, variables, d = _discriminator()
    k = variables["params"]["block_1"]["conv1"]["kernel"]  # (3, 3, in, out)
    w = d.block_1.conv1.weight.detach().numpy()  # (out, in, 3, 3)
    assert w.shape == (k.shape[3], k.shape[2], 3, 3)
    np.testing.assert_array_equal(w[5, 2, 0, 1], k[0, 1, 2, 5])
    params = variables["params"]
    missing = {name: sub for name, sub in params.items() if name != "to_logits"}
    with pytest.raises(KeyError, match="lacks"):
        load_discriminator_params(Discriminator(**DISCR), {"params": missing})
    extra = dict(params, attn_9=params["attn_2"])
    with pytest.raises(KeyError, match="land nowhere"):
        load_discriminator_params(Discriminator(**DISCR), extra)


def test_strict_vgg_load():
    _, variables, _ = _vgg()
    params = variables["params"]
    with pytest.raises(KeyError, match="lacks"):
        load_vgg_params(VGG16Features(), {k: v for k, v in params.items() if k != "fc2"})
    with pytest.raises(KeyError, match="land nowhere"):
        load_vgg_params(VGG16Features(), dict(params, conv_13=params["conv_12"]))


def _torchvision_layout_state_dict(vgg: VGG16Features):
    """A torchvision vgg16 state dict built from a VGG16Features: features.{k}
    at torchvision's indices (convs, ReLUs and pools counted), classifier.0
    and classifier.3, and classifier.6 (the head the features drop)."""
    sd, k, conv = {}, 0, 0
    for spec in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"):
        if spec == "M":
            k += 1
            continue
        layer = getattr(vgg, f"conv_{conv}")
        sd[f"features.{k}.weight"], sd[f"features.{k}.bias"] = layer.weight.detach().clone(), layer.bias.detach().clone()
        conv, k = conv + 1, k + 2
    for name, idx in (("fc1", 0), ("fc2", 3)):
        layer = getattr(vgg, name)
        sd[f"classifier.{idx}.weight"] = layer.weight.detach().clone()
        sd[f"classifier.{idx}.bias"] = layer.bias.detach().clone()
    sd["classifier.6.weight"], sd["classifier.6.bias"] = torch.zeros(1000, 4096), torch.zeros(1000)
    return sd


def test_torchvision_state_dict_loads(tmp_path):
    src = init_vgg(11)
    sd = _torchvision_layout_state_dict(src)
    converted = load_torch_state_dict(sd)
    assert sorted(converted) == sorted(VGG16Features().state_dict())
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)
    with torch.device("meta"):
        dst = VGG16Features()
    dst.to_empty(device="cpu").load_state_dict(load_vgg16_from_file(str(path)))
    for (name, p), q in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(p, q), name
    # the same weights through JAX's converter give the same features
    from phenaki_tpu.models.vgg import load_torch_state_dict as j_load

    j_vars = j_load({k: v.numpy() for k, v in sd.items()})
    x = _video(4, (1, 64, 64, 3))
    ref = np.asarray(JVGG().apply(j_vars, jnp.asarray(x)))
    with torch.no_grad():
        _close(dst(torch.from_numpy(x)), ref, 1e-4)
