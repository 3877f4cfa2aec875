"""PEG's stencil kernel (csrc/peg_stencil.cu) and its wrapper
`ops.positional.peg_stencil`: x + bias + the depthwise 3x3x3 stencil.

On the CPU, the card's route runs with the C library stubbed
(tests/_torch_card_stub.py): the stub reads x through the pointer and strides
the wrapper hands it and writes the plain version's result through the
output's, so the tests hold what the wrapper passes (strides of the C-ViViT's
temporal layout without a copy, dtype codes, the causal flag), its launch
counter, and the operands it refuses (d or strides off 16 bytes among them).

Tests marked `card` need a CUDA device, decide so inside the test, and skip
without one; the file imports no JAX, so on the card it runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_peg_kernel.py -q`.
Tolerances of the kernel (f32 sums, one rounding to x's dtype) against the
plain version:
* bf16 x against the plain version in f32 on the same bf16 values (taps and
  bias rounded to bf16 as the plain version casts them): rtol 2^-8, half a
  bf16 ulp, the kernel's one rounding; atol 1e-4, f32 sums of 29 terms of
  magnitude up to about 10 taken in another order;
* bf16 x against the plain version in bf16, which rounds each of the 27
  products, their sum, the bias add and the residual add to bf16: within
  2^-8 of the magnitude of each rounded value, summed element by element,
  plus the kernel's own half ulp and the atol above;
* f32 x against the plain version in f32: atol and rtol 1e-5 (sums in another
  order).
"""

import ctypes

import pytest
import torch
from _torch_card_stub import StubLibrary

import phenaki_tpu_torch.ops.positional as pos
from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.positional import PEG, peg_stencil, peg_stencil_plain


def _weights(d, gen, dtype=torch.float32):
    """PEG's init scale (fan_in 27), with a bias, on the CPU."""
    weight = (torch.rand(d, 1, 3, 3, 3, generator=gen) * 2 - 1) / 27**0.5
    bias = (torch.rand(d, generator=gen) * 2 - 1) / 27**0.5
    return weight.to(dtype), bias.to(dtype)


# ---------------------------------------------------------------------------
# the card's route on the CPU, with the library stubbed


@pytest.fixture
def stub(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(pos, "_on_card", lambda *t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    return lib


@pytest.mark.parametrize("causal, layout, dtype", [(False, "thw", torch.float32), (True, "bhw_t", torch.bfloat16)],
                         ids=["thw-f32", "bhw_t-causal-bf16"])
def test_card_route_reads_x_in_place_through_its_strides(stub, monkeypatch, causal, layout, dtype):
    b, t, h, w, d = 2, 3, 4, 5, 16
    gen = torch.Generator().manual_seed(0)
    rows, seq = (b, t * h * w) if layout == "thw" else (b * h * w, t)
    x = torch.randn(rows, seq, d, generator=gen).to(dtype)
    peg = PEG(d, causal=causal, layout=layout)
    weight, bias = _weights(d, gen)
    with torch.no_grad():
        peg.weight.copy_(weight)
        peg.bias.copy_(bias)
        before = peg_stencil.launches
        got = peg(x, (b, t, h, w))
        assert peg_stencil.launches == before + 1
        monkeypatch.undo()  # the CPU route: the plain version on the same module
        want = peg(x, (b, t, h, w))
    ((name, call),) = stub.calls
    assert name == "peg" and call["x"] == x.data_ptr()  # no copy of x, in either layout
    want_strides = (t * h * w * d, h * w * d, w * d, d) if layout == "thw" else (h * w * t * d, d, w * t * d, t * d)
    assert call["strides"] == want_strides and call["out_strides"] == want_strides
    assert call["causal"] == int(causal) and call["dtype"] == _build.DTYPES[dtype]
    assert call["weight_dtype"] == _build.DTYPES[torch.float32]
    assert got.shape == x.shape and torch.equal(got, want)


def test_the_cpu_route_launches_nothing():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 2, 3, 3, 8, generator=gen)
    weight, bias = _weights(8, gen)
    before = peg_stencil.launches
    out = peg_stencil(x, weight, bias, causal=False)
    assert peg_stencil.launches == before
    assert torch.equal(out, peg_stencil_plain(x, weight, bias, False))


@pytest.mark.parametrize("case", ["float16", "mixed_weight_bias", "weight_shape", "flat_x", "d_off_16_bytes",
                                  "stride_off_16_bytes", "address_off_16_bytes"])
def test_operands_the_kernel_cannot_take_raise_before_the_card(stub, case):
    """Among them d = 12 in bf16 (24 bytes), channels 0-7 of a d = 12 bf16
    tensor (d = 8, its strides multiples of 12) and a view from the second
    f32 value of a buffer: the kernel copies 16 bytes at a time."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 2, 3, 3, 8, generator=gen)
    weight, bias = _weights(8, gen)
    if case == "d_off_16_bytes":
        x = torch.randn(1, 2, 3, 3, 12, generator=gen).to(torch.bfloat16)
        weight, bias = _weights(12, gen)
    elif case == "stride_off_16_bytes":
        x = torch.randn(1, 2, 3, 3, 12, generator=gen).to(torch.bfloat16)[..., :8]
    elif case == "address_off_16_bytes":
        x = torch.randn(1 + x.numel(), generator=gen)[1:].view(x.shape)
    elif case == "float16":
        x = x.half()
    elif case == "mixed_weight_bias":
        bias = bias.to(torch.bfloat16)
    elif case == "weight_shape":
        weight = weight[:4]
    else:
        x = x.reshape(1, 18, 8)
    with pytest.raises(ValueError, match="PEG kernel"):
        peg_stencil(x, weight, bias, causal=False)
    assert not stub.calls


# ---------------------------------------------------------------------------
# the kernel on the card

# (b, t, h, w, d, causal, layout, dtype): the MaskGit's and the TokenCritic's
# guided forward (2b = 128 rows); the C-ViViT decoder's temporal layers at
# b = 64 (causal, read in the (b h w) t d layout); a primed scene's 13
# frames; the patch-16 presets' 16 x 8 plane (taller than one tile: halo rows
# from the next tile); a plane wider than a tile; the edge grids; d = 8, the
# smallest the kernel takes in bf16 (16 bytes), and d = 12 in f32 (a lane's
# channels past d masked); f32 as the small models run it.
CARD_CASES = {
    "maskgit": (128, 9, 8, 4, 512, False, "thw", torch.bfloat16),
    "decoder_bhw_t": (64, 9, 8, 4, 512, True, "bhw_t", torch.bfloat16),
    "primed_t13": (4, 13, 8, 4, 512, False, "thw", torch.bfloat16),
    "patch16_plane": (4, 9, 16, 8, 512, False, "thw", torch.bfloat16),
    "wide_plane": (2, 3, 5, 20, 64, True, "thw", torch.bfloat16),
    "one_frame": (3, 1, 8, 4, 64, False, "thw", torch.bfloat16),
    "one_frame_causal": (3, 1, 8, 4, 64, True, "bhw_t", torch.bfloat16),
    "one_position": (3, 5, 1, 1, 64, False, "thw", torch.bfloat16),
    "d8": (4, 5, 8, 4, 8, False, "thw", torch.bfloat16),
    "f32_d128": (4, 3, 8, 8, 128, False, "thw", torch.float32),
    "f32_d12": (2, 4, 3, 5, 12, True, "bhw_t", torch.float32),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the PEG kernel runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid_input(b, t, h, w, d, layout, dtype, gen, device):
    """x (b, t, h, w, d) as PEG reads it: contiguous for 'thw', the permuted
    view of a flat (b h w) t d tensor for 'bhw_t'."""
    if layout == "thw":
        return torch.randn(b, t, h, w, d, generator=gen).to(device, dtype)
    flat = torch.randn(b * h * w, t, d, generator=gen).to(device, dtype)
    return flat.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)


def _bf16_plain_bound(x, weight, bias, causal, ref):
    """Element by element, how far the plain version in bf16 may lie from
    the f32 result: 2^-8 of each value it rounds (the 27 products, their sum,
    the sum plus the bias, the output)."""
    x32, w32, b32 = x.float(), weight.to(x.dtype).float(), bias.to(x.dtype).float()
    frame_pad = (2, 0) if causal else (1, 1)
    grid = x.shape[:4]
    products = pos._stencil(pos._pad(x32.abs(), frame_pad), pos._taps(w32.abs(), torch.float32), grid)
    s = pos._stencil(pos._pad(x32, frame_pad), pos._taps(w32, torch.float32), grid)
    return 2.0**-8 * (products + s.abs() + (s + b32).abs() + ref.abs())


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_plain_version(card, case):
    b, t, h, w, d, causal, layout, dtype = CARD_CASES[case]
    gen = torch.Generator().manual_seed(list(CARD_CASES).index(case))
    x = _grid_input(b, t, h, w, d, layout, dtype, gen, card)
    weight, bias = (p.to(card) for p in _weights(d, gen))
    before = peg_stencil.launches
    got = peg_stencil(x, weight, bias, causal)
    torch.cuda.synchronize()
    assert peg_stencil.launches == before + 1
    assert got.stride() == x.stride()  # written in x's layout
    if dtype == torch.float32:
        torch.testing.assert_close(got, peg_stencil_plain(x, weight, bias, causal), atol=1e-5, rtol=1e-5)
        return
    ref = peg_stencil_plain(x.float(), weight.to(dtype).float(), bias.to(dtype).float(), causal)
    torch.testing.assert_close(got.float(), ref, atol=1e-4, rtol=2.0**-8)
    plain = peg_stencil_plain(x, weight, bias, causal).float()
    err = (got.float() - plain).abs()
    allowed = _bf16_plain_bound(x, weight, bias, causal, ref) + 2.0**-8 * ref.abs() + 1e-4
    assert bool((err <= allowed).all()), f"max excess {(err - allowed).max().item()}"


@pytest.mark.card
@pytest.mark.parametrize("d", [13, 20])
def test_d_off_16_bytes_raises_on_the_card(card, d):
    """A d that is no multiple of 8 in bf16: the wrapper raises, and nothing
    is launched."""
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(2, 3, 8, 4, d, generator=gen).to(card, torch.bfloat16)
    weight, bias = (p.to(card) for p in _weights(d, gen))
    before = peg_stencil.launches
    with pytest.raises(ValueError, match="16 bytes"):
        peg_stencil(x, weight, bias, False)
    assert peg_stencil.launches == before


@pytest.mark.card
def test_weights_in_bf16_are_read_as_such(card):
    """The served models keep PEG's weight and bias in bf16."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 5, 8, 4, 64, generator=gen).to(card, torch.bfloat16)
    weight, bias = (p.to(card, torch.bfloat16) for p in _weights(64, gen))
    got = peg_stencil(x, weight, bias, False)
    ref = peg_stencil_plain(x.float(), weight.float(), bias.float(), False)
    torch.testing.assert_close(got.float(), ref, atol=1e-4, rtol=2.0**-8)


@pytest.mark.card
def test_a_tiny_sample_launches_the_kernel_once_a_peg_layer(card):
    """depth x steps MaskGit launches (one guided forward a step) and one a
    decoder temporal layer; the greedy ids equal the CPU's."""
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    depth, steps, temporal_depth = 2, 6, 1
    gen = torch.Generator().manual_seed(3)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, temporal_depth, dim_head=64, heads=2), gen)
    mg = init_parameters(MaskGit(128, 512, 192, depth=depth, heads=2, dim_head=64, dim_context=64), gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    ids = {}
    for device in ("cpu", "cuda"):
        ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=steps,
                     max_text_len=16)
        kw = dict(num_frames=5, text_embeds=emb, cond_scale=5.0, starting_temperature=0.0,
                  generator=torch.Generator().manual_seed(0))
        before = peg_stencil.launches
        with torch.no_grad():
            ids[device] = ph.sample_ids(**kw).cpu()
            ph.sample(**kw)
        launched = peg_stencil.launches - before
        if device == "cuda":
            assert launched == 2 * depth * steps + temporal_depth
        else:
            assert launched == 0
    assert torch.equal(ids["cuda"], ids["cpu"])
