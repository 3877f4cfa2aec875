"""The port's fused vocab cross-entropy (phenaki_tpu_torch/ops/fused_ce.py)
against the JAX package's Pallas kernels (ops/pallas_ce.py), run in
interpret mode on the CPU.

On a CPU tensor the port's autograd Function takes the plain forward and
the plain versions of the two backward kernels, so these tests pin the math
contract the CUDA kernels are held to on the card (chip_smoke.py): the loss
and the gradients of h, the weight and the bias against
`fused_vocab_cross_entropy` and `jax.value_and_grad` of a weighted mean, the
-1 pad label, the shape gate over d up to 2560, the kernels reached for
every gated d on a CUDA tensor (entry points stubbed), the bf16 forward's
and backward's launch geometry (vocab splits, padded rows and partials,
aligned operands), and `Phenaki.loss`
through the fused branch (d = 128 and d = 768) against the JAX loss with
its fused branch on. Tolerances, fp32: the JAX tests' own, atol
and rtol 1e-4 on the loss and 2e-4 on the gradients (blockwise online
log-sum-exp against one-shot); `Phenaki.loss` as in test_torch_train.py.
"""

import ctypes

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.models.phenaki as jphenaki_module  # noqa: E402
import phenaki_tpu.ops.pallas_attention as pa  # noqa: E402
import phenaki_tpu.ops.pallas_ce as pce  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
import phenaki_tpu_torch.ops.fused_ce as fce  # noqa: E402
from phenaki_tpu_torch import _build  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models import phenaki as phenaki_module
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.fused_ce import can_fuse_ce, fused_vocab_cross_entropy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pce, "_INTERPRET", True)
    monkeypatch.setattr(pa, "_INTERPRET", True)


CASES = {  # name -> (b, n, d, V, bias, pad labels)
    "bias": (2, 12, 128, 2048, True, False),
    "ragged_rows_no_bias": (1, 9, 128, 1024, False, False),
    "labels_across_blocks_pad": (1, 16, 128, 4096, True, True),
}


def _inputs(name):
    b, n, d, v, with_bias, pad = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    h = (rng.randn(b, n, d) * 0.3).astype(np.float32)
    w = (rng.randn(d, v) * (1.5 / np.sqrt(d))).astype(np.float32)  # the JAX (d, V) layout
    bias = (rng.randn(v) * 0.05).astype(np.float32) if with_bias else None
    labels = rng.randint(0, v, (b, n)).astype(np.int32)
    if name == "labels_across_blocks_pad":
        labels = ((np.arange(b * n) * 257 + 11) % v).reshape(b, n).astype(np.int32)
    if pad:
        labels[0, ::5] = -1  # the TPU kernels' pad label: no logit picked
    wgt = rng.rand(b, n).astype(np.float32)
    return h, w, bias, labels, wgt


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_pallas(name):
    h, w, bias, labels, wgt = _inputs(name)

    def j_loss(h_, w_, b_):
        ce = pce.fused_vocab_cross_entropy(h_, w_, b_, jnp.asarray(labels))
        return jnp.sum(ce * wgt) / jnp.sum(wgt), ce

    args = [jnp.asarray(h), jnp.asarray(w)] + ([jnp.asarray(bias)] if bias is not None else [None])
    argnums = (0, 1, 2) if bias is not None else (0, 1)
    (ref_loss, ref_ce), ref_grads = jax.value_and_grad(j_loss, argnums=argnums, has_aux=True)(*args)

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()  # (V, d), the nn.Linear layout
    tb = torch.from_numpy(bias).requires_grad_() if bias is not None else None
    ce = fused_vocab_cross_entropy(th, tw, tb, torch.from_numpy(labels))
    loss = (ce * torch.from_numpy(wgt)).sum() / float(wgt.sum())
    loss.backward()

    assert ce.shape == labels.shape and ce.dtype == torch.float32
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(ref_ce), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-4, rtol=1e-4)
    got = [th.grad.numpy(), tw.grad.numpy().T] + ([tb.grad.numpy()] if bias is not None else [])
    for key, g, r in zip(("dh", "dw", "dbias"), got, ref_grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=2e-4, rtol=2e-4, err_msg=key)


def test_bf16_compute_keeps_f32_weight_gradient():
    """bf16 h with an f32 weight: the weight is cast at use and its gradient
    comes back in f32 (no bf16 rounding), h's in bf16; close to the f32 CE."""
    h, w, bias, labels, wgt = _inputs("bias")
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    ce = fused_vocab_cross_entropy(th, tw, torch.from_numpy(bias), torch.from_numpy(labels).long())
    (ce * torch.from_numpy(wgt)).sum().backward()
    assert th.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    logits = th.detach().float() @ tw.detach().to(torch.bfloat16).float().t() + torch.from_numpy(bias)
    ref = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                            torch.from_numpy(labels).long().reshape(-1), reduction="none")
    torch.testing.assert_close(ce.detach().reshape(-1), ref, atol=1e-5, rtol=1e-5)


def test_shape_gate_matches_pallas():
    """The port's gate is the TPU wrapper's, d = 2432 the widest it admits."""
    shapes = [(d, v) for d in range(64, 2561, 64) for v in (256, 512, 1000, 1536, 5000, 65536)]
    for d, v in shapes:
        assert can_fuse_ce(d, v) == pce.can_fuse_ce(d, v), (d, v)
    assert can_fuse_ce(2432, 65536) and not can_fuse_ce(2560, 65536)


def _misaligned(t):
    """A contiguous copy of `t` whose data starts one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _read(ptr, n, dtype):
    """n elements of `dtype` at address `ptr`, copied."""
    size = torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer(bytearray(ctypes.string_at(ptr, n * size)), dtype=dtype).clone()


class _StubCELibrary:
    """Records each C call of the CE kernels; writes zeros to its outputs."""

    def __init__(self):
        self.calls, self.geometry = [], []

    def fused_ce_fwd(self, h, w, bias, labels, loss, lse, label_logit, partials, rows, d, v, splits,
                     dtype, stream):
        self.calls.append(("fwd", d, v))
        # what the kernel reads: bf16 h holds whole 128-row tiles
        tdtype = next(t for t, code in _build.DTYPES.items() if code == dtype)
        h_rows = -(-rows // fce.GEMM_ROWS) * fce.GEMM_ROWS if tdtype == torch.bfloat16 else rows
        data = {"h": _read(h.value, h_rows * d, tdtype).view(h_rows, d),
                "w": _read(w.value, v * d, tdtype).view(v, d),
                "labels": _read(labels.value, rows, torch.int32)}
        if bias.value:
            data["bias"] = _read(bias.value, v, torch.float32)
        self.geometry.append(("fwd", dict(rows=rows, splits=splits, partials=partials.value, dtype=dtype,
                                          h=h.value, w=w.value, bias=bias.value, labels=labels.value,
                                          data=data)))
        for out in (loss, lse):
            ctypes.memset(out.value, 0, 4 * rows)
        return 0

    def fused_ce_bwd_dh(self, h, w, bias, labels, lse, g, dh, partials, rows, d, v, splits, rows_pad,
                        dtype, stream):
        self.calls.append(("dh", d, v))
        self.geometry.append(("dh", dict(rows=rows, splits=splits, rows_pad=rows_pad, dh=dh.value,
                                         partials=partials.value, dtype=dtype)))
        ctypes.memset(dh.value, 0, 4 * rows * d)
        return 0

    def fused_ce_bwd_dw(self, h, w, bias, labels, lse, g, dw, db, rows, d, v, dtype, stream):
        self.calls.append(("dw", d, v))
        self.geometry.append(("dw", dict(rows=rows, dw=dw.value, db=db.value, dtype=dtype)))
        ctypes.memset(dw.value, 0, 4 * v * d)
        ctypes.memset(db.value, 0, 4 * v)
        return 0


@pytest.mark.parametrize("d", [128, 512, 640, 1024, 2432])
def test_every_gated_width_launches_the_kernels(monkeypatch, d):
    """On a (stubbed) card every d the gate admits reaches the three kernels;
    d = 2560 is refused, as the TPU wrapper refuses it."""
    lib = _StubCELibrary()
    monkeypatch.setattr(fce, "_on_card", lambda *ts: True)
    monkeypatch.setattr(fce, "_splits", lambda rows, v, device: 4)
    monkeypatch.setattr(fce, "_sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    v = 1024
    h = torch.randn(2, 5, d, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(v, d, requires_grad=True)
    fused_vocab_cross_entropy(h, w, torch.zeros(v), torch.randint(0, v, (2, 5))).sum().backward()
    assert lib.calls == [("fwd", d, v), ("dh", d, v), ("dw", d, v)]
    assert h.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    with pytest.raises(ValueError, match="do not take"):
        fce.fused_ce_fwd(torch.zeros(10, 2560), torch.zeros(v, 2560), None, torch.zeros(10))


def test_bf16_backward_launch_geometry(monkeypatch):
    """On a (stubbed) card with 132 SMs, rows that fill no whole 64-row tile
    (1000) reach the bf16 dh kernel with the split count that fills whole
    waves (16 row blocks x 33 splits = 4 waves) and a (33, 1024, d) f32
    partial buffer, rows padded to 64; dW gets its (V, d) and (V,) f32
    outputs. Both backward kernels refuse d = 2560 before the card."""
    lib = _StubCELibrary()
    monkeypatch.setattr(fce, "_on_card", lambda *ts: True)
    monkeypatch.setattr(fce, "_sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    allocated, empty = [], torch.empty

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append((t.data_ptr(), tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(fce.torch, "empty", spy_empty)
    rows, d, v = 1000, 512, 4096
    h = torch.randn(rows, d).to(torch.bfloat16)
    w = torch.randn(v, d).to(torch.bfloat16)
    labels = torch.randint(0, v, (rows,), dtype=torch.int32)
    lse, g = torch.zeros(rows), torch.ones(rows)
    dh = fce.fused_ce_bwd_dh(h, w, None, labels, lse, g)
    dw, db = fce.fused_ce_bwd_dw(h, w, None, labels, lse, g)
    shapes = {ptr: (shape, dtype) for ptr, shape, dtype in allocated}
    (kind_dh, dh_call), (kind_dw, dw_call) = lib.geometry
    assert (kind_dh, kind_dw) == ("dh", "dw")
    assert fce.dh_splits(rows, v, 132) == 33
    assert dh_call["rows"] == rows and dh_call["splits"] == 33 and dh_call["rows_pad"] == 1024
    assert dh_call["dtype"] == _build.DTYPES[torch.bfloat16]
    assert shapes[dh_call["partials"]] == ((33, 1024, d), torch.float32)
    assert shapes[dh_call["dh"]] == ((rows, d), torch.float32) and dh.shape == (rows, d)
    assert shapes[dw_call["dw"]] == ((v, d), torch.float32) and shapes[dw_call["db"]] == ((v,), torch.float32)
    assert dw.shape == (v, d) and db.shape == (v,)
    wide = torch.zeros(10, 2560, dtype=torch.bfloat16)
    args = (wide, torch.zeros(v, 2560, dtype=torch.bfloat16), None, labels[:10], lse[:10], g[:10])
    for kernel in (fce.fused_ce_bwd_dh, fce.fused_ce_bwd_dw):
        with pytest.raises(ValueError, match="do not take"):
            kernel(*args)
    assert len(lib.geometry) == 2


def test_bf16_forward_launch_geometry(monkeypatch):
    """On a (stubbed) card with 132 SMs, 1000 rows (no whole 128-row tile)
    of misaligned bf16 h, weight, bias and labels reach the bf16 forward
    16-byte aligned, h zero-padded to 1024 rows, with the vocab splits that
    fill whole waves of one block an SM (8 row tiles x 16 splits = 128
    blocks, one wave) and a (1000, 16, 2) f32 partial buffer. The flagship
    train rows (4608, 36 tiles) take 11 splits (3 waves) and no padding
    copy. The kernels take a vocab of 512-wide blocks (csrc/fused_ce.cu
    `shape_ok`): V = 1088, a multiple of 64 (what its C entry once took)
    but not of 512, is refused before the card."""
    lib = _StubCELibrary()
    monkeypatch.setattr(fce, "_on_card", lambda *ts: True)
    monkeypatch.setattr(fce, "_sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    allocated, empty = [], torch.empty

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append((t.data_ptr(), tuple(t.shape), t.dtype))
        return t

    rows, d, v = 1000, 256, 4096
    rng = np.random.RandomState(7)
    h = torch.from_numpy(rng.randn(rows, d).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(v, d).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.randn(v).astype(np.float32))
    labels = torch.from_numpy(rng.randint(-1, v, rows).astype(np.int32))
    monkeypatch.setattr(fce.torch, "empty", spy_empty)
    loss = fused_vocab_cross_entropy(*(_misaligned(t) for t in (h, w, bias, labels)))
    assert loss.shape == (rows,) and loss.dtype == torch.float32
    (kind, call), = lib.geometry
    assert kind == "fwd" and call["dtype"] == _build.DTYPES[torch.bfloat16]
    assert fce.wave_splits(rows, v, 132) == 16 and call["rows"] == rows and call["splits"] == 16
    assert {ptr: (shape, dtype) for ptr, shape, dtype in allocated}[call["partials"]] == (
        (rows, 16, 2), torch.float32)
    assert all(call[key] % 16 == 0 for key in ("h", "w", "bias", "labels"))
    staged = call["data"]
    assert staged["h"].shape == (1024, d) and torch.equal(staged["h"][:rows], h)
    assert not staged["h"][rows:].any()
    for key, want in (("w", w), ("bias", bias), ("labels", labels)):
        assert torch.equal(staged[key], want), key

    flagship = torch.zeros(4608, d, dtype=torch.bfloat16)
    fce.fused_ce_fwd(flagship, w, None, torch.zeros(4608, dtype=torch.int32))
    assert lib.geometry[-1][1]["splits"] == fce.wave_splits(4608, v, 132)
    assert fce.wave_splits(4608, 65536, 132) == 11
    assert lib.geometry[-1][1]["h"] == flagship.data_ptr()  # whole tiles: no padding copy
    wide_vocab = torch.zeros(1088, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not take"):
        fce.fused_ce_fwd(h, wide_vocab, None, labels)
    assert len(lib.geometry) == 2


@pytest.mark.parametrize("rows,v,sms", [(4608, 65536, 132), (1000, 1024, 132), (1152, 65536, 132),
                                        (64, 512, 132), (4608, 65536, 114)])
def test_dh_splits_fill_whole_waves(rows, v, sms):
    """The bf16 dh grid's vocab splits: between 1 and the vocab's 64-id
    tiles, and no split count in the searched range leaves less of its last
    wave empty; 11 at the flagship train shape (6 full waves on 132 SMs)."""
    s = fce.dh_splits(rows, v, sms)
    tiles, row_blocks = v // 64, -(-rows // 64)
    assert 1 <= s <= tiles

    def waste(n):
        return (-(-row_blocks * n // sms) * sms - row_blocks * n) / (row_blocks * n)

    lo, hi = -(-2 * sms // row_blocks), -(-8 * sms // row_blocks)
    assert all(waste(s) <= waste(n) for n in range(min(lo, tiles), min(hi, tiles) + 1))
    if (rows, v, sms) == (4608, 65536, 132):
        assert s == 11 and waste(s) == 0


# ---------------------------------------------------------------------------
# Phenaki.loss through the fused branch, against the JAX loss with its fused
# branch on (`use_fused_ce()` is True only on a TPU: patched for the test)

TEXT_DIM, STEPS = 16, 4
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=128, num_tokens=512, max_seq_len=128, depth=1, heads=2, dim_head=32,
               dim_context=TEXT_DIM)
GRID = (2, 8, 8)


def _check_phenaki_loss_fused_branch(monkeypatch, maskgit):
    assert can_fuse_ce(maskgit["dim"], maskgit["num_tokens"])
    monkeypatch.setattr(jphenaki_module, "use_fused_ce", lambda: True)
    jcv = JCViViT(**CVIVIT, scan_layers=True)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**maskgit, scan_layers=True), cvivit=jcv, cvivit_vars=cv_vars,
                   steps=STEPS, text_embed_dim=TEXT_DIM, max_text_len=8)
    jph.init(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jph.params["maskgit"]))

    rng_np = np.random.RandomState(6)
    ids = rng_np.randint(0, 512, size=(2, *GRID)).astype(np.int32)
    emb = rng_np.randn(2, 6, TEXT_DIM).astype(np.float32)
    emb[1, 3:] = 0.0
    rng = jax.random.PRNGKey(8)

    def j_loss(mg_params):
        loss, _ = jph.loss({"maskgit": mg_params, "critic": None}, rng,
                           video_codebook_ids=jnp.asarray(ids), text_embeds=jnp.asarray(emb),
                           cond_drop_prob=0.0)
        return loss

    ref_loss, ref_grads = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, params))

    rng_mask, rng_step = jax.random.split(rng, 7)[:2]
    step = np.asarray(jax.random.randint(rng_step, (2,), 0, STEPS))
    noise = np.asarray(jax.random.uniform(rng_mask, (2, ids[0].size)))
    tph = Phenaki(maskgit=load_flax_params(MaskGit(**maskgit), params), cvivit=CViViT(**CVIVIT),
                  text_embed_dim=TEXT_DIM, steps=STEPS, max_text_len=8)
    monkeypatch.setattr(tph, "_loss_draws", lambda b, n, gen, device: (
        torch.from_numpy(step.copy()).long(), torch.from_numpy(noise.copy())))
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fused_vocab_cross_entropy(*args)

    monkeypatch.setattr(phenaki_module, "fused_vocab_cross_entropy", spy)
    loss, _ = tph.loss(video_codebook_ids=torch.from_numpy(ids), text_embeds=torch.from_numpy(emb),
                       cond_drop_prob=0.0)
    loss.backward()
    assert calls == [(2, 128, maskgit["dim"])]
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(ref_grads)))
    named = dict(tph.maskgit.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-5),
                                   rtol=0, err_msg=name)


def test_phenaki_loss_fused_branch_matches_jax(monkeypatch):
    _check_phenaki_loss_fused_branch(monkeypatch, MASKGIT)


def test_phenaki_loss_fused_branch_at_d768_matches_jax(monkeypatch):
    """d = 768 takes the fused branch, as on the TPU (the gate admits d up
    to 2432; the kernels walk d in slices)."""
    _check_phenaki_loss_fused_branch(monkeypatch, dict(MASKGIT, dim=768))
