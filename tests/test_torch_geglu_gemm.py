"""The feedforward's GEGLU GEMM (csrc/geglu_gemm.cu) and its wrapper
`ops.feedforward.geglu_gemm`, and `FeedForward` on the card's route.

On the CPU: the packed layout's plain emulation (pack proj_in, the product,
the paired GEGLU, proj_out zero-padded, unpack) against the plain
`FeedForward`; the card's route with the C library stubbed
(tests/_torch_card_stub.py, which writes the plain version's h and packed
pre-activation through the pointers the wrapper hands it): what the wrapper
passes, its launch counter, the packed weights' cache, the written-out
backward (`_GegluGemm`) against plain autograd to the second order and under
remat, and the operands it refuses. The backward against the JAX package's
`_geglu_bwd` is in tests/test_torch_train.py (this file imports no JAX).

Tests marked `card` need a CUDA device, decide so inside the test, and skip
without one; on the card the file runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_geglu_gemm.py -q`.
Tolerances, and why:
* f32 (the plain emulation against the plain module; the card's f32 kernel
  against the plain version): 1e-5, products summed in another order;
* the bf16 kernel against the f32 GEGLU of the f32 product on the same bf16
  operands: half a bf16 ulp (rtol 2^-8, the kernel's one rounding) plus
  1e-4 of the largest value (f32 sums in another order); the plain bf16
  version rounds the product before the gate, so it is not the reference;
* gradients (`_grads_close`): the backward redoes the gate's math in f32 and
  runs the products in the operands' dtype, as plain autograd does, but
  rounds d pre once where autograd rounds its two halves' terms apart: 1e-5
  in f32, one bf16 ulp of the element and of the tensor's largest value from
  bf16 operands.
"""

import ctypes

import pytest
import torch

import phenaki_tpu_torch.ops.feedforward as ff_mod
from _torch_card_stub import StubLibrary
from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.feedforward import (FeedForward, _GegluGemm, ff_inner_dim, geglu, geglu_gemm,
                                               geglu_gemm_plain, geglu_packed, geglu_splits, linear, pack_proj_in,
                                               pad_proj_out, padded_inner, unpack_proj_in)

ULP = {torch.bfloat16: 2.0**-7}


def _ff(dim, inner, gen, dtype=torch.float32):
    ff = FeedForward(dim, inner_dim=inner)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5 + (1.0 if p.ndim == 1 else 0.0))
    return ff.to(dtype)


def _grads_close(got, want, dtype):
    tol = ULP.get(dtype, 1e-5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g32, w32 = g.float(), w.float()
        allowed = tol * (torch.maximum(g32.abs(), w32.abs()) + w32.abs().max())
        excess = ((g32 - w32).abs() - allowed).max().item()
        assert excess <= 0, f"a {tuple(w.shape)} gradient off the plain route's by {excess} beyond its tolerance"


# ---------------------------------------------------------------------------
# the packed layout, plain


@pytest.mark.parametrize("dim, inner", [(512, 1365), (512, 683), (96, 64), (48, 40)],
                         ids=["inner_1365", "tp_rank_683", "inner_64", "inner_40"])
def test_the_packed_emulation_equals_the_plain_feedforward(dim, inner):
    """pack proj_in, the product, the paired GEGLU (padded columns exactly 0),
    proj_out zero-padded: the plain FeedForward's output in f32; unpacking
    gives proj_in back bit for bit."""
    gen = torch.Generator().manual_seed(inner)
    ff = _ff(dim, inner, gen)
    x = torch.randn(3, 5, dim, generator=gen)
    w_in, w_out = ff.proj_in.weight.detach(), ff.proj_out.weight.detach()
    wp, ip = pack_proj_in(w_in), padded_inner(inner)
    assert wp.shape == (2 * ip, dim) and ip % 64 == 0 and ip - inner < 64
    assert torch.equal(unpack_proj_in(wp, inner), w_in)
    with torch.no_grad():
        xn = ff.norm(x)
        h = geglu_gemm_plain(xn, wp)
        assert h.shape == (3, 5, ip) and torch.equal(h[..., inner:], torch.zeros_like(h[..., inner:]))
        got = torch.matmul(h, pad_proj_out(w_out).t())
        want = ff(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h[..., :inner], geglu(linear(xn, ff.proj_in)), atol=1e-5, rtol=1e-5)


def test_the_packed_tiles_pair_a_with_its_gate():
    """Tile t holds rows 64 t .. 64 t + 63 of a, then the same rows of gate."""
    inner, d = 100, 3
    w = torch.arange(2 * inner * d, dtype=torch.float32).reshape(2 * inner, d)
    wp = pack_proj_in(w)
    assert wp.shape == (256, d)
    assert torch.equal(wp[:64], w[:64]) and torch.equal(wp[64:128], w[inner:inner + 64])
    assert torch.equal(wp[128:164], w[64:100]) and torch.equal(wp[192:228], w[inner + 64:])
    assert not wp[164:192].any() and not wp[228:].any()


def test_the_feedforward_takes_the_plain_path_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    ff = _ff(64, ff_inner_dim(64), gen)
    x = torch.randn(2, 9, 64, generator=gen)
    before = geglu_gemm.launches
    with torch.no_grad():
        got = ff(x)
        want = linear(geglu(linear(ff.norm(x), ff.proj_in)), ff.proj_out)
    assert geglu_gemm.launches == before and torch.equal(got, want)


def test_the_splits_fill_the_last_wave():
    """2 at the MaskGit's 36,864 rows and the decoder's 18,432 (22 tiles, 132
    SMs); every split at least one tile."""
    assert geglu_splits(128 * 288, 22, 132) == 2
    assert geglu_splits(64 * 288, 22, 132) == 2
    for rows in (1, 1000, 4608, 36864):
        for tiles in (1, 11, 22):
            assert 1 <= geglu_splits(rows, tiles, 132) <= tiles


# ---------------------------------------------------------------------------
# the card's route on the CPU, with the library stubbed


@pytest.fixture
def stub(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(ff_mod, "_on_card", lambda *t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    return lib


def _plain(ff, x):
    """The module's plain route, computed apart from its forward."""
    return linear(geglu(linear(ff.norm(x), ff.proj_in)), ff.proj_out)


@pytest.mark.parametrize("rows, inner", [(2 * 288, 1365), (1000, 1365), (128, 683)],
                         ids=["maskgit_rows", "ragged_1000", "tp_rank_683"])
def test_the_card_route_launches_once_on_unpadded_rows(stub, rows, inner):
    """One launch a forward on x as it is (no row padding), the packed
    weight at the padded width, the splits the wrapper picks; the output is
    the plain module's."""
    gen = torch.Generator().manual_seed(rows)
    ff = _ff(128, inner, gen)
    x = torch.randn(rows, 128, generator=gen)
    with torch.no_grad():
        before = geglu_gemm.launches
        got = ff(x)
    assert geglu_gemm.launches == before + 1
    ((name, call),) = stub.calls
    ip = padded_inner(inner)
    assert name == "geglu_gemm" and (call["rows"], call["d"], call["ip"]) == (rows, 128, ip)
    assert call["splits"] == geglu_splits(rows, 2 * ip // 128, 132) and not call["pre"]
    assert call["dtype"] == _build.DTYPES[torch.float32]
    torch.testing.assert_close(got, _plain(ff, x), atol=1e-5, rtol=1e-5)


def test_the_packed_weights_are_cached_until_the_parameter_changes(stub):
    """Two forwards read one packed weight; an in-place update of proj_in
    (an optimizer step) or of proj_out makes the next forward repack."""
    gen = torch.Generator().manual_seed(3)
    ff = _ff(128, 100, gen)
    x = torch.randn(4, 128, generator=gen)
    with torch.no_grad():
        ff(x)
        ff(x)
        assert stub.calls[0][1]["w"] == stub.calls[1][1]["w"]
        ff.proj_in.weight.mul_(-2.0)
        got = ff(x)
        assert stub.calls[2][1]["w"] != stub.calls[1][1]["w"]
        torch.testing.assert_close(got, _plain(ff, x), atol=1e-5, rtol=1e-5)
        ff.proj_out.weight.add_(0.5)
        torch.testing.assert_close(ff(x), _plain(ff, x), atol=1e-5, rtol=1e-5)
    assert len(stub.calls) == 4


def test_training_after_a_sample_under_inference_mode(stub):
    """A trainer's milestone samples under `torch.inference_mode` (the cache
    then holds inference tensors); the next training forward packs afresh and
    its backward runs."""
    gen = torch.Generator().manual_seed(11)
    ff = _ff(128, 64, gen)
    x = torch.randn(3, 128, generator=gen)
    with torch.inference_mode():
        ff(x)
    assert ff._packed_in.value.is_inference()
    ff(x.requires_grad_()).sum().backward()
    assert x.grad is not None and ff.proj_in.weight.grad is not None and ff.proj_out.weight.grad is not None
    assert len(stub.calls) == 2 and stub.calls[1][1]["pre"]


def test_a_module_made_under_inference_mode_runs(stub):
    """A served tensor-parallel rank's clone is made under
    `torch.inference_mode`: its weights are inference tensors, which have no
    version counter."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(3, 128, generator=gen)
    with torch.inference_mode():
        ff = _ff(128, 64, gen)
        assert ff.proj_in.weight.is_inference()
        got = [ff(x), ff(x)]
        want = _plain(ff, x)
    assert stub.calls[0][1]["w"] == stub.calls[1][1]["w"]
    for g in got:
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_training_launches_and_takes_the_plain_gradients(stub, dtype):
    """Under autograd the kernel runs the forward (and writes the packed
    pre-activation); x's, the norm's and both weights' gradients are plain
    autograd's (`_grads_close`)."""
    gen = torch.Generator().manual_seed(4)
    ff = _ff(128, 90, gen)
    x = torch.randn(2, 7, 128, generator=gen).to(dtype).requires_grad_()
    weight = torch.randn(2, 7, 128, generator=gen)
    params = list(ff.parameters())
    got = (ff(x).float() * weight).sum()
    got_grads = torch.autograd.grad(got, [x, *params])
    ((name, call),) = stub.calls
    assert call["pre"] and call["dtype"] == _build.DTYPES[dtype]

    def plain(xx):
        xn = ff.norm(xx).to(dtype)
        return linear(geglu(linear(xn, ff.proj_in)), ff.proj_out)

    want = (plain(x).float() * weight).sum()
    want_grads = torch.autograd.grad(want, [x, *params])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=ULP.get(dtype, 1e-5))
    _grads_close(got_grads, want_grads, dtype)


def test_the_second_derivative_is_plain_autograd_s(stub):
    """A gradient differentiated again (create_graph): the backward recomputes
    the projection with plain operations, so the graph reaches x and proj_in."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(6, 32, generator=gen, requires_grad=True)
    w = (torch.randn(2 * 40, 32, generator=gen) / 6).requires_grad_()
    weight = torch.randn(6, padded_inner(40), generator=gen)
    results = []
    for route in ("kernel", "plain"):
        h = _GegluGemm.apply(x, w, pack_proj_in(w.detach())) if route == "kernel" else \
            geglu_gemm_plain(x, pack_proj_in(w))
        dx, dw = torch.autograd.grad((h * weight).sum().sin(), (x, w), create_graph=True)
        results.append(torch.autograd.grad(dx.square().sum() + dw.square().sum(), (x, w)))
    assert len(stub.calls) == 1
    _grads_close(*results, torch.float32)


def test_remat_launches_again_and_takes_the_plain_gradients(stub):
    """`remat` (a non-reentrant checkpoint) runs the kernel again in the
    backward's recompute."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator().manual_seed(6)
    ff = _ff(64, 40, gen)
    x = torch.randn(5, 64, generator=gen, requires_grad=True)
    weight = torch.randn(5, 64, generator=gen)
    (checkpoint(ff, x, use_reentrant=False) * weight).sum().backward()
    assert [name for name, _ in stub.calls] == ["geglu_gemm"] * 2
    got = [x.grad] + [p.grad for p in ff.parameters()]
    x.grad = None
    for p in ff.parameters():
        p.grad = None
    (_plain(ff, x) * weight).sum().backward()
    _grads_close(got, [x.grad] + [p.grad for p in ff.parameters()], torch.float32)


@pytest.mark.parametrize("case", ["bf16_d_96", "f16", "wrong_width"])
def test_operands_the_kernel_cannot_take_raise(stub, case):
    """No card tensor is sent to the plain version."""
    gen = torch.Generator().manual_seed(7)
    d = 96 if case == "bf16_d_96" else 128
    dtype = {"bf16_d_96": torch.bfloat16, "f16": torch.float16}.get(case, torch.float32)
    x = torch.randn(4, d, generator=gen).to(dtype)
    wp = pack_proj_in(torch.randn(2 * 64, d + (8 if case == "wrong_width" else 0), generator=gen)).to(dtype)
    with pytest.raises(ValueError, match="GEGLU GEMM"):
        geglu_gemm(x, wp)
    assert not stub.calls


def test_a_copied_module_packs_its_own_weights(stub):
    """A tensor-parallel rank's clone (a deep copy) or an unpickled module
    starts with an empty cache."""
    import copy
    import pickle

    gen = torch.Generator().manual_seed(8)
    ff = _ff(128, 64, gen)
    x = torch.randn(3, 128, generator=gen)
    with torch.no_grad():
        ff(x)
        for clone in (copy.deepcopy(ff), pickle.loads(pickle.dumps(ff))):
            assert clone._packed_in.value is None
            clone.proj_in.weight.mul_(3.0)
            torch.testing.assert_close(clone(x), _plain(clone, x), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card

# (rows, d, inner): the MaskGit's guided forward (128 x 288 tokens), the
# decoder's layers at b = 64, tokenize at patch 16 (32 x 9 x 16 x 8), a
# ragged row count, a tensor-parallel rank's width
CARD_CASES = {"maskgit": (128 * 288, 512, 1365), "decoder": (64 * 288, 512, 1365),
              "tokenize_patch16": (32 * 1152, 512, 1365), "ragged_1000": (1000, 512, 1365),
              "tp_rank_683": (4 * 288, 512, 683), "d_1024_streamed": (300, 1024, 1365)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the GEGLU GEMM runs on the card only")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("pre", [False, True], ids=["h", "h_and_pre"])
def test_the_kernel_matches_the_f32_geglu(card, case, pre):
    rows, d, inner = CARD_CASES[case]
    gen = torch.Generator().manual_seed(list(CARD_CASES).index(case))
    x = torch.randn(rows, d, generator=gen).to(card, torch.bfloat16)
    wp = pack_proj_in(torch.randn(2 * inner, d, generator=gen) / d**0.5).to(card, torch.bfloat16)
    before = geglu_gemm.launches
    out = geglu_gemm(x, wp, pre=pre)
    torch.cuda.synchronize()
    assert geglu_gemm.launches == before + 1
    h, p = out if pre else (out, None)
    ref_pre = torch.matmul(x.float(), wp.float().t())
    ref = geglu_packed(ref_pre)
    torch.testing.assert_close(h.float(), ref, atol=1e-4 * ref.abs().max().item(), rtol=2.0**-8)
    assert not h[:, inner:].any()
    if pre:
        torch.testing.assert_close(p.float(), ref_pre, atol=1e-4 * ref_pre.abs().max().item(), rtol=2.0**-8)


@pytest.mark.card
def test_the_f32_kernel_matches_the_plain_version(card):
    gen = torch.Generator().manual_seed(9)
    for rows, d, inner in ((300, 128, 341), (77, 48, 40), (64, 512, 1365)):
        x = torch.randn(rows, d, generator=gen).to(card)
        wp = pack_proj_in(torch.randn(2 * inner, d, generator=gen) / d**0.5).to(card)
        h, p = geglu_gemm(x, wp, pre=True)
        torch.testing.assert_close(h, geglu_gemm_plain(x, wp), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(p, torch.matmul(x, wp.t()), atol=1e-5, rtol=1e-5)


@pytest.mark.card
def test_training_on_the_card_takes_the_plain_gradients(card):
    """A bf16 feedforward with f32 parameters, as the trainer runs it: the
    kernel's forward, the written-out backward; every gradient plain
    autograd's within bf16 rounding."""
    gen = torch.Generator().manual_seed(10)
    ff = _ff(512, 1365, gen).to(card)
    x = torch.randn(4, 288, 512, generator=gen).to(card, torch.bfloat16).requires_grad_()
    weight = torch.randn(4, 288, 512, generator=gen).to(card)
    before = geglu_gemm.launches
    got = torch.autograd.grad((ff(x).float() * weight).sum(), [x, *ff.parameters()])
    torch.cuda.synchronize()
    assert geglu_gemm.launches == before + 1

    def plain(xx):
        return linear(geglu(linear(ff.norm(xx), ff.proj_in)), ff.proj_out)

    want = torch.autograd.grad((plain(x).float() * weight).sum(), [x, *ff.parameters()])
    _grads_close(got, want, torch.bfloat16)


@pytest.mark.card
def test_a_tiny_sample_launches_the_kernel_once_a_feedforward(card):
    """Each MaskGit layer's feedforward at each step and each decoder layer's
    (f32 models: the CUDA-core kernel); the greedy ids equal the CPU's."""
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    depth, steps, spatial_depth, temporal_depth = 2, 6, 1, 1
    gen = torch.Generator().manual_seed(3)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, spatial_depth, temporal_depth, dim_head=64, heads=2), gen)
    mg = init_parameters(MaskGit(128, 512, 192, depth=depth, heads=2, dim_head=64, dim_context=64), gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    ids = {}
    for device in ("cpu", "cuda"):
        ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=steps,
                     max_text_len=16)
        kw = dict(num_frames=5, text_embeds=emb, cond_scale=5.0, starting_temperature=0.0,
                  generator=torch.Generator().manual_seed(0))
        before = geglu_gemm.launches
        with torch.no_grad():
            ids[device] = ph.sample_ids(**kw).cpu()
            ph.sample(**kw)
        launched = geglu_gemm.launches - before
        assert launched == ((2 * steps * depth + spatial_depth + temporal_depth) if device == "cuda" else 0)
    assert torch.equal(ids["cuda"], ids["cpu"])
