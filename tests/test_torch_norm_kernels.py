"""The trunk's norm kernels (csrc/norms.cu) and their wrappers
`ops.norms.layer_norm` (LayerNorm and StandardLayerNorm) and
`ops.attention.qk_norm_split` (the attention's head split with its q/k
l2norm).

On the CPU, the card's route runs with the C library stubbed
(tests/_torch_card_stub.py): the stub reads the operands through the pointers
and strides the wrapper hands it and writes the plain version's result, so
the tests hold what the wrapper passes (column slices of the fused [q | k | v]
product read in place, row strides, dtype codes, the null key/values), its
launch counter, the gradients under autograd (the kernel's forward, the plain
version's backward, to the second order) and the operands it refuses.

Tests marked `card` need a CUDA device, decide so inside the test, and skip
without one; the file imports no JAX, so on the card it runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_norm_kernels.py -q`.
Tolerances of the kernels against the plain version, and why:
* LayerNorm in bf16 or f16: both round one f32 value to x's dtype; the f32
  values differ only by the order of the sums (well under a bf16 ulp), so the
  results differ by at most one ulp of x's dtype: 2^-7 (bf16) or 2^-10 (f16)
  of the larger magnitude, plus 1e-6 where the values are near zero; against
  the plain version in f32 on the same values, half an ulp (the kernel's one
  rounding) plus 1e-5 (f32 sums in another order, amplified by rsqrt);
* the q/k normalisation in bf16 or f16: the plain version rounds twice (after
  the l2norm, after the scale), the kernel once, so they differ by at most one
  ulp of the larger magnitude; v is copied bit for bit;
* f32: atol and rtol 1e-5 (sums in another order);
* gradients under autograd (`_grads_close`): the kernel route's backward is
  the plain version's derivative written out in f32; autograd's of the plain
  version takes the same terms in another order, and where the operands are
  bf16 or f16 it rounds some of them to that dtype (the scale's product and
  its gradient's products). So in f32 they agree to 1e-5 of the element and
  of the tensor's largest value; from bf16 or f16 operands to one ulp of
  that dtype of each (up to 0.37% of the largest was seen in bf16 against
  the 0.78% allowed).
"""

import ctypes

import pytest
import torch
from _torch_card_stub import StubLibrary

import phenaki_tpu_torch.ops.norms as norms
from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops.attention import Attention, qk_norm_split, qk_norm_split_plain
from phenaki_tpu_torch.ops.norms import LayerNorm, StandardLayerNorm, l2norm_scaled, layer_norm, layer_norm_plain

ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _params(d, gen, dtype=torch.float32, beta=True):
    gamma = (1 + 0.5 * torch.randn(d, generator=gen)).to(dtype)
    return gamma, (0.5 * torch.randn(d, generator=gen)).to(dtype) if beta else None


def _qkv(b, n, m, heads, d, gen, dtype, fused):
    """q (b, n, h*d), k and v (b, m, h*d): column slices of one fused product
    (self-attention), or q and a [k | v] product apart (cross-attention)."""
    inner = heads * d
    if fused:
        qkv = torch.randn(b, n, 3 * inner, generator=gen).to(dtype)
        return qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
    q = torch.randn(b, n, inner, generator=gen).to(dtype)
    kv = torch.randn(b, m, 2 * inner, generator=gen).to(dtype)
    return q, kv[..., :inner], kv[..., inner:]


def _scales(d, gen, dtype=torch.float32):
    return [(1 + 0.25 * torch.randn(d, generator=gen)).to(dtype) for _ in range(2)]


def _grads_close(got, want, dtype):
    """Each gradient the plain route's within `dtype`'s rounding (the
    operands' dtype; see the module docstring): of the element and of the
    tensor's largest value."""
    assert len(got) == len(want)
    tol = ULP.get(dtype, 1e-5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g32, w32 = g.float(), w.float()
        allowed = tol * (torch.maximum(g32.abs(), w32.abs()) + w32.abs().max())
        excess = ((g32 - w32).abs() - allowed).max().item()
        assert excess <= 0, f"a {tuple(w.shape)} gradient off the plain route's by {excess} beyond its tolerance"


# ---------------------------------------------------------------------------
# the plain versions against the formulas they replace in the modules


def _layer_norm_before(x, gamma, beta):
    """The LayerNorm modules' forward before the kernel, verbatim."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + 1e-5) * gamma.float()
    return (out + beta.float()).to(x.dtype) if beta is not None else out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("module", [LayerNorm, StandardLayerNorm])
def test_the_modules_compute_the_plain_version_on_the_cpu(module, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (3 * torch.randn(2, 7, 48, generator=gen) + 1).to(dtype)
    ln = module(48)
    gamma, beta = _params(48, gen)
    with torch.no_grad():
        ln.gamma.copy_(gamma)
        if module is StandardLayerNorm:
            ln.beta.copy_(beta)
        before = layer_norm.launches
        got = ln(x)
    assert layer_norm.launches == before
    assert torch.equal(got, _layer_norm_before(x, ln.gamma, getattr(ln, "beta", None)))
    assert torch.equal(got, layer_norm_plain(x, ln.gamma, getattr(ln, "beta", None)))


@pytest.mark.parametrize("null", [0, 2])
def test_qk_norm_split_plain_is_the_attention_s_split_and_l2norm(null):
    """The split, the null key/values' concatenation and `l2norm_scaled`, as
    `Attention.forward` wrote them."""
    gen = torch.Generator().manual_seed(1)
    b, n, m, heads, d = 2, 5, 3, 4, 16
    q, k, v = _qkv(b, n, m, heads, d, gen, torch.bfloat16, fused=False)
    qs, ks = _scales(d, gen)
    null_kv = torch.randn(heads, 2 * null, d, generator=gen).to(torch.bfloat16) if null else None
    got = qk_norm_split_plain(q, k, v, heads, qs, ks, null_kv)

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    wq, wk, wv = map(split, (q, k, v))
    if null:
        nk, nv = null_kv.split(null, dim=-2)
        wk = torch.cat([nk.expand(b, -1, -1, -1), wk], dim=-2)
        wv = torch.cat([nv.expand(b, -1, -1, -1), wv], dim=-2)
    for g, w in zip(got, (l2norm_scaled(wq, qs), l2norm_scaled(wk, ks), wv)):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert all(torch.equal(g, w) for g, w in zip(qk_norm_split(q, k, v, heads, qs, ks, null_kv), got))


# ---------------------------------------------------------------------------
# the card's route on the CPU, with the library stubbed


@pytest.fixture
def stub(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(norms, "_on_card", lambda *t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("beta", [False, True], ids=["gamma", "gamma_beta"])
def test_layer_norm_card_route_reads_rows_in_place(stub, dtype, beta):
    """The rows of a column slice (every other 512 columns of a wider
    buffer) are read through their stride; the output is contiguous."""
    gen = torch.Generator().manual_seed(2)
    d = 512
    wide = torch.randn(3, 4, 2 * d, generator=gen).to(dtype)
    x = wide[..., d:]
    gamma, b = _params(d, gen, torch.bfloat16, beta)
    with torch.no_grad():
        before = layer_norm.launches
        got = layer_norm(x, gamma, b)
    assert layer_norm.launches == before + 1
    ((name, call),) = stub.calls
    assert name == "layer_norm" and call["x"] == x.data_ptr()
    assert (call["rows"], call["d"], call["x_stride"], call["out_stride"]) == (12, d, 2 * d, d)
    assert call["beta"] == beta and call["eps"] == pytest.approx(1e-5)
    assert call["dtype"] == norms.DTYPES[dtype] and call["param_dtype"] == norms.DTYPES[torch.bfloat16]
    assert got.shape == x.shape and got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, layer_norm_plain(x, gamma, b))


@pytest.mark.parametrize("case", ["transposed", "address_off_16_bytes", "stride_off_16_bytes"])
def test_layer_norm_copies_rows_that_are_not_on_16_bytes(stub, case):
    gen = torch.Generator().manual_seed(3)
    d = 64
    if case == "transposed":
        x = torch.randn(2, d, 5, generator=gen).to(torch.bfloat16).transpose(1, 2)
    elif case == "address_off_16_bytes":
        x = torch.randn(1 + 10 * d, generator=gen).to(torch.bfloat16)[1:].view(10, d)
    else:
        x = torch.randn(10, d + 4, generator=gen).to(torch.bfloat16)[:, :d]
    gamma, _ = _params(d, gen, beta=False)
    with torch.no_grad():
        got = layer_norm(x, gamma)
    ((_, call),) = stub.calls
    assert call["x"] != x.data_ptr() and call["x_stride"] == d
    assert torch.equal(got, layer_norm_plain(x, gamma))


@pytest.mark.parametrize("d, dtype", [(3072, torch.bfloat16), (6144, torch.bfloat16), (6144, torch.float32),
                                      (8192, torch.float32), (2048, torch.bfloat16)],
                         ids=["patch_norm_3072_bf16", "patch_norm_6144_bf16", "patch_norm_6144_f32", "f32_32_kb",
                              "bf16_4_kb"])
def test_layer_norm_launches_on_rows_up_to_32_kb(stub, d, dtype):
    """The C-ViViT's patch norms at patch 32 (3072 and 6144 wide) and the
    widest row the kernel takes (32 KB)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, d, generator=gen).to(dtype)
    gamma, beta = _params(d, gen)
    with torch.no_grad():
        got = layer_norm(x, gamma, beta)
    ((_, call),) = stub.calls
    assert call["d"] == d and torch.equal(got, layer_norm_plain(x, gamma, beta))


@pytest.mark.parametrize("d, dtype", [(8200, torch.float32), (16392, torch.bfloat16), (4, torch.bfloat16),
                                      (6, torch.float32)],
                         ids=["f32_over_32_kb", "bf16_over_32_kb", "d4_bf16", "d6_f32"])
def test_layer_norm_widths_the_kernel_does_not_take_raise(stub, d, dtype):
    """Rows over 32 KB, and rows that are not whole 16-byte vectors: no card
    tensor is sent to the plain version."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, d, generator=gen).to(dtype)
    gamma, beta = _params(d, gen)
    with torch.no_grad(), pytest.raises(ValueError, match="LayerNorm kernel takes rows"):
        layer_norm(x, gamma, beta)
    assert not stub.calls


def _grads(fn, inputs, weight):
    """The output and the gradients of sum(fn(*inputs) * weight) (weights
    fixed, so both routes get one incoming gradient)."""
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weight))
    wanted = [t for t in inputs if isinstance(t, torch.Tensor) and t.requires_grad]
    return outs, torch.autograd.grad(loss, wanted)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_under_autograd_launches_and_takes_the_plain_gradients(stub, dtype):
    """Training: the kernel runs the forward, and x's, gamma's and beta's
    gradients are the plain version's (`_grads_close`)."""
    gen = torch.Generator().manual_seed(5)
    x = (2 * torch.randn(4, 7, 64, generator=gen)).to(dtype).requires_grad_()
    gamma, beta = (p.to(dtype).requires_grad_() for p in _params(64, gen))
    weight = [torch.randn(4, 7, 64, generator=gen)]
    before = layer_norm.launches
    got, got_grads = _grads(layer_norm, (x, gamma, beta), weight)
    assert layer_norm.launches == before + 1 and len(stub.calls) == 1
    assert got[0].requires_grad
    want, want_grads = _grads(layer_norm_plain, (x, gamma, beta), weight)
    assert torch.equal(got[0], want[0])
    _grads_close(got_grads, want_grads, dtype)


def test_layer_norm_second_derivative_is_the_plain_version_s(stub):
    """The R1 penalty differentiates a gradient: the backward's graph reaches
    x, gamma and beta as the plain version's does."""
    gen = torch.Generator().manual_seed(15)
    x = torch.randn(3, 5, 32, generator=gen).requires_grad_()
    gamma, beta = (p.requires_grad_() for p in _params(32, gen))
    weight = torch.randn(3, 5, 32, generator=gen)
    results = []
    for fn in (layer_norm, layer_norm_plain):
        (dx,) = torch.autograd.grad((fn(x, gamma, beta) * weight).sum().sin(), x, create_graph=True)
        results.append(torch.autograd.grad(dx.square().sum(), (x, gamma, beta)))
    assert len(stub.calls) == 1
    for g, w in zip(*results):
        # the derivative written out and differentiated again: f32 terms in another order
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("create_graph", [False, True], ids=["first_order", "graph"])
def test_gradients_when_the_parameters_are_used_upstream_too(stub, create_graph):
    """A pipeline stage runs its layers on microbatch t with microbatch
    t - 1's activations upstream in the graph: the backward stops at its
    operands, and every gradient is the plain route's (the same f32 terms in
    another order)."""
    gen = torch.Generator().manual_seed(19)
    b, n, heads, d = 2, 3, 2, 16
    inner = heads * d
    x = torch.randn(b, n, inner, generator=gen, requires_grad=True)
    gamma, beta = (p.requires_grad_() for p in _params(inner, gen))
    qs, ks = (s.requires_grad_() for s in _scales(d, gen))
    weight = torch.randn(b, heads, n, d, generator=gen)

    def two_layers(ln, split):
        h = x
        for _ in range(2):
            q, k, v = split(ln(h, gamma, beta), ln(2 * h, gamma, beta), h, heads, qs, ks)
            h = h + (q + k + v).transpose(1, 2).reshape(b, n, inner)
        return (h * weight.transpose(1, 2).reshape(b, n, inner)).sum()

    results = []
    for ln, split in ((layer_norm, qk_norm_split), (layer_norm_plain, qk_norm_split_plain)):
        grads = torch.autograd.grad(two_layers(ln, split), (x, gamma, beta, qs, ks), create_graph=create_graph)
        if create_graph:
            grads = torch.autograd.grad(sum(g.square().sum() for g in grads), (x, gamma, beta, qs, ks))
        results.append(grads)
    assert len(stub.calls) == 6
    for g, w in zip(*results):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)  # f32 terms summed in another order


def test_layer_norm_under_remat_takes_the_plain_gradients(stub):
    """`remat` (a non-reentrant checkpoint) launches the kernel again in the
    backward's recompute; the gradients are the plain version's."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator().manual_seed(16)
    ln = StandardLayerNorm(64)
    x = torch.randn(4, 64, generator=gen, requires_grad=True)
    weight = torch.randn(4, 64, generator=gen)
    (checkpoint(ln, x, use_reentrant=False) * weight).sum().backward()
    assert len(stub.calls) == 2
    got = (x.grad, ln.gamma.grad, ln.beta.grad)
    x.grad = ln.gamma.grad = ln.beta.grad = None
    (layer_norm_plain(x, ln.gamma, ln.beta) * weight).sum().backward()
    _grads_close(got, (x.grad, ln.gamma.grad, ln.beta.grad), torch.float32)


@pytest.mark.parametrize("case", ["float64", "gamma_shape", "mixed_gamma_beta"])
def test_layer_norm_operands_the_kernel_cannot_take_raise(stub, case):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(3, 64, generator=gen)
    gamma, beta = _params(64, gen)
    if case == "float64":
        x = x.double()
    elif case == "gamma_shape":
        gamma = gamma[:32]
    else:
        beta = beta.to(torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="LayerNorm kernel"):
        layer_norm(x, gamma, beta)
    assert not stub.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
def test_qk_norm_split_reads_the_fused_product_in_place(stub, dtype):
    """Self-attention: q, k and v are column slices of one (b, n, 3*inner)
    product, passed at their own addresses with its strides; the outputs are
    contiguous (b, h, n, d)."""
    gen = torch.Generator().manual_seed(7)
    b, n, heads, d = 2, 6, 4, 16
    q, k, v = _qkv(b, n, n, heads, d, gen, dtype, fused=True)
    qs, ks = _scales(d, gen)
    with torch.no_grad():
        before = qk_norm_split.launches
        got = qk_norm_split(q, k, v, heads, qs, ks)
    assert qk_norm_split.launches == before + 1
    ((name, call),) = stub.calls
    assert name == "qk_norm_split"
    assert (call["q"], call["k"], call["v"]) == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    inner = heads * d
    assert call["strides"] == ((n * 3 * inner, 3 * inner),) * 3
    assert (call["b"], call["n"], call["m"], call["num_null"], call["h"], call["d"]) == (b, n, n, 0, heads, d)
    assert call["null_k"] == 0 and call["dtype"] == norms.DTYPES[dtype]
    assert call["scale_dtype"] == norms.DTYPES[torch.float32]
    want = qk_norm_split_plain(q, k, v, heads, qs, ks)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape and torch.equal(g, w)


def test_qk_norm_split_puts_the_null_key_values_first(stub):
    """Cross-attention: q and the [k | v] product apart, and 2 null
    key/values (h, 2*2, d) passed as two pointers into the parameter."""
    gen = torch.Generator().manual_seed(8)
    b, n, m, heads, d, null = 3, 5, 7, 2, 64, 2
    q, k, v = _qkv(b, n, m, heads, d, gen, torch.bfloat16, fused=False)
    qs, ks = _scales(d, gen, torch.bfloat16)
    null_kv = torch.randn(heads, 2 * null, d, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        got = qk_norm_split(q, k, v, heads, qs, ks, null_kv)
    ((_, call),) = stub.calls
    assert call["num_null"] == null and call["m"] == m
    assert call["null_k"] == null_kv.data_ptr() and call["null_v"] == null_kv[:, null:].data_ptr()
    assert call["null_strides"] == (2 * null * d, d)
    assert call["strides"] == ((n * heads * d, heads * d), (m * 2 * heads * d, 2 * heads * d),
                               (m * 2 * heads * d, 2 * heads * d))
    want = qk_norm_split_plain(q, k, v, heads, qs, ks, null_kv)
    assert got[1].shape == (b, heads, null + m, d)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("d, dtype", [(4, torch.bfloat16), (256, torch.float32), (6, torch.float32)],
                         ids=["d4_bf16", "d256_f32", "d6_f32"])
def test_qk_head_widths_the_kernel_does_not_take_raise(stub, d, dtype):
    """A head row that is not whole 16-byte vectors, or wider than one warp
    of them (512 bytes): no card tensor is sent to the plain version."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = _qkv(2, 3, 3, 2, d, gen, dtype, fused=True)
    qs, ks = _scales(d, gen)
    with torch.no_grad(), pytest.raises(ValueError, match="q/k norm kernel takes head rows"):
        qk_norm_split(q, k, v, 2, qs, ks)
    assert not stub.calls


@pytest.mark.parametrize("null", [0, 2])
def test_qk_norm_split_under_autograd_launches_and_takes_the_plain_gradients(stub, null):
    """Training: the kernel runs the forward; the gradients of the fused
    product (through its three column slices), the scales and the null
    key/values are the plain version's (`_grads_close`)."""
    gen = torch.Generator().manual_seed(10)
    b, n, heads, d = 2, 3, 2, 16
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen).requires_grad_()
    inner = heads * d
    qs, ks = (s.requires_grad_() for s in _scales(d, gen))
    null_kv = torch.randn(heads, 2 * null, d, generator=gen).requires_grad_() if null else None
    weight = [torch.randn(b, heads, m, d, generator=gen) for m in (n, null + n, null + n)]

    def route(fn):
        return _grads(lambda t, *rest: fn(t[..., :inner], t[..., inner:2 * inner], t[..., 2 * inner:], heads, *rest),
                      (qkv, qs, ks) + ((null_kv,) if null else ()), weight)

    before = qk_norm_split.launches
    got, got_grads = route(qk_norm_split)
    assert qk_norm_split.launches == before + 1 and len(stub.calls) == 1
    want, want_grads = route(qk_norm_split_plain)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(got_grads) == 3 + bool(null)
    _grads_close(got_grads, want_grads, torch.float32)


def test_qk_norm_split_gradients_of_q_alone(stub):
    """k and v that autograd does not record (a frozen context's projection):
    only q's and the scales' gradients, still the plain version's."""
    gen = torch.Generator().manual_seed(17)
    q, k, v = _qkv(2, 4, 5, 2, 16, gen, torch.float32, fused=False)
    q.requires_grad_()
    qs, ks = (s.requires_grad_() for s in _scales(16, gen))
    weight = [torch.randn(2, 2, m, 16, generator=gen) for m in (4, 5, 5)]
    got = _grads(lambda *a: qk_norm_split(*a[:3], 2, *a[3:]), (q, k, v, qs, ks), weight)[1]
    want = _grads(lambda *a: qk_norm_split_plain(*a[:3], 2, *a[3:]), (q, k, v, qs, ks), weight)[1]
    assert len(stub.calls) == 1 and len(got) == 3
    _grads_close(got, want, torch.float32)


@pytest.mark.parametrize("case", ["k_dtype", "mixed_scales", "heads", "null_kv_dtype", "float64"])
def test_qk_operands_the_kernel_cannot_take_raise(stub, case):
    gen = torch.Generator().manual_seed(11)
    q, k, v = _qkv(2, 3, 4, 2, 16, gen, torch.bfloat16, fused=False)
    qs, ks = _scales(16, gen)
    null_kv, heads = None, 2
    if case == "k_dtype":
        k = k.float()
    elif case == "mixed_scales":
        ks = ks.to(torch.bfloat16)
    elif case == "heads":
        heads = 3  # 32 columns are no 3 heads of whole width
    elif case == "null_kv_dtype":
        null_kv = torch.randn(2, 4, 16, generator=gen)
    else:
        q, k, v = q.double(), k.double(), v.double()
    with torch.no_grad(), pytest.raises(ValueError, match="q/k norm kernel"):
        qk_norm_split(q, k, v, heads, qs, ks, null_kv)
    assert not stub.calls


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross_null_kv"])
def test_attention_on_the_stubbed_card_matches_the_cpu(stub, monkeypatch, cross):
    """A whole Attention block: the norms (the input's, and the context's in
    cross-attention) and the head split go down the card's route, each once,
    and the block's output equals the CPU's."""
    gen = torch.Generator().manual_seed(12)
    dim, heads, dim_head, ctx_dim = 64, 2, 32, 48
    attn = Attention(dim, dim_context=ctx_dim if cross else None, dim_head=dim_head, heads=heads,
                     num_null_kv=2 if cross else 0, cross=cross)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    x = torch.randn(2, 9, dim, generator=gen)
    context = torch.randn(2, 5, ctx_dim, generator=gen) if cross else None
    mask = torch.rand(2, 5, generator=gen) > 0.3 if cross else None
    with torch.no_grad():
        ln_before, qk_before = layer_norm.launches, qk_norm_split.launches
        got = attn(x, mask=mask, context=context)
        assert layer_norm.launches - ln_before == (2 if cross else 1)
        assert qk_norm_split.launches - qk_before == 1
        monkeypatch.undo()
        want = attn(x, mask=mask, context=context)
    assert [name for name, _ in stub.calls] == ["layer_norm"] * (2 if cross else 1) + ["qk_norm_split"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross_null_kv"])
def test_attention_trains_on_the_stubbed_card_as_on_the_cpu(stub, monkeypatch, cross):
    """A whole Attention block under autograd: the norms and the head split
    launch (their forward), and the output and every parameter's gradient
    equal the CPU's."""
    gen = torch.Generator().manual_seed(18)
    dim, heads, dim_head, ctx_dim = 64, 2, 32, 48
    attn = Attention(dim, dim_context=ctx_dim if cross else None, dim_head=dim_head, heads=heads,
                     num_null_kv=2 if cross else 0, cross=cross)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    x = torch.randn(2, 9, dim, generator=gen)
    context = torch.randn(2, 5, ctx_dim, generator=gen) if cross else None
    weight = torch.randn(2, 9, dim, generator=gen)

    def run():
        attn.zero_grad()
        out = attn(x, context=context)
        (out * weight).sum().backward()
        return out.detach(), {name: p.grad.clone() for name, p in attn.named_parameters()}

    got, got_grads = run()
    assert [name for name, _ in stub.calls] == ["layer_norm"] * (2 if cross else 1) + ["qk_norm_split"]
    monkeypatch.undo()
    want, want_grads = run()
    assert torch.equal(got, want)
    assert got_grads.keys() == want_grads.keys()
    _grads_close([got_grads[k] for k in want_grads], list(want_grads.values()), torch.float32)


# ---------------------------------------------------------------------------
# the kernels on the card

# LayerNorm rows (shape, dtype, beta): the MaskGit's and the TokenCritic's
# guided forward (2b = 128 rows of 288 tokens, d = 512; the attention's norms
# without beta, the feedforward's with); the text context (128 x 128 at
# 768); the C-ViViT decoder's temporal (64 x 32 rows of 9 frames) and spatial
# (64 x 9 frames of 32 positions) layers; f16; f32 as the small models run
# it; the widest row a warp takes (2048 bf16) and a ragged one (40 bf16,
# five vectors: lanes past the row masked); the C-ViViT's patch norms at
# patch 32, a block a row (3072 and 6144 wide, 6144 in f32), and the widest
# row a block takes (32 KB, 16384 bf16).
LN_CASES = {
    "maskgit": ((128, 288, 512), torch.bfloat16, False),
    "maskgit_ff": ((128, 288, 512), torch.bfloat16, True),
    "text_context": ((128, 128, 768), torch.bfloat16, False),
    "decoder_temporal": ((2048, 9, 512), torch.bfloat16, True),
    "decoder_spatial": ((576, 32, 512), torch.bfloat16, False),
    "f16": ((64, 33, 512), torch.float16, True),
    "f32_d512": ((16, 40, 512), torch.float32, True),
    "bf16_d2048": ((4, 33, 2048), torch.bfloat16, True),
    "bf16_d40": ((7, 13, 40), torch.bfloat16, True),
    "patch_norm_3072": ((32, 8, 3072), torch.bfloat16, True),
    "patch_norm_6144": ((32, 8, 6144), torch.bfloat16, True),
    "patch_norm_6144_f32": ((8, 9, 6144), torch.float32, True),
    "bf16_d16384": ((3, 5, 16384), torch.bfloat16, False),
}

# q/k normalisation (b, n, m, heads, d, null, fused, dtype): the MaskGit's
# self-attention (the fused product) and cross-attention (128 + 2 keys); the
# decoder's spatial (576 x 32) and temporal (2048 x 9) self-attention; the
# 4 x 128 heads; f16; f32 at d = 64 and d = 128 (a head row a whole warp).
QK_CASES = {
    "maskgit_self": (128, 288, 288, 8, 64, 0, True, torch.bfloat16),
    "maskgit_cross": (128, 288, 128, 8, 64, 2, False, torch.bfloat16),
    "decoder_spatial": (576, 32, 32, 8, 64, 0, True, torch.bfloat16),
    "decoder_temporal": (2048, 9, 9, 8, 64, 0, True, torch.bfloat16),
    "heads_4x128_cross": (4, 288, 128, 4, 128, 2, False, torch.bfloat16),
    "f16_self": (8, 100, 100, 8, 64, 0, True, torch.float16),
    "f32_cross": (4, 50, 20, 8, 64, 2, False, torch.float32),
    "f32_d128": (4, 50, 50, 4, 128, 0, True, torch.float32),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the norm kernels run on the card only")
    return torch.device("cuda")


def _within_one_ulp(got, want, dtype):
    """|got - want| <= one ulp of x's dtype at the larger magnitude (1e-6 at
    least, for values near zero)."""
    g, w = got.float(), want.float()
    allowed = (ULP[dtype] * torch.maximum(g.abs(), w.abs())).clamp_min(1e-6)
    return bool(((g - w).abs() <= allowed).all()), ((g - w).abs() - allowed).max().item()


@pytest.mark.card
@pytest.mark.parametrize("case", list(LN_CASES))
def test_layer_norm_kernel_matches_the_plain_version(card, case):
    shape, dtype, beta = LN_CASES[case]
    gen = torch.Generator().manual_seed(list(LN_CASES).index(case))
    x = (2 * torch.randn(*shape, generator=gen) + 0.5).to(card, dtype)
    gamma, b = (p.to(card) if p is not None else None for p in _params(shape[-1], gen, torch.bfloat16, beta))
    with torch.no_grad():
        before = layer_norm.launches
        got = layer_norm(x, gamma, b)
        torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, layer_norm_plain(x, gamma, b), atol=1e-5, rtol=1e-5)
        return
    ref = layer_norm_plain(x.float(), gamma, b)
    torch.testing.assert_close(got.float(), ref, atol=1e-5, rtol=ULP[dtype] / 2)
    ok, excess = _within_one_ulp(got, layer_norm_plain(x, gamma, b), dtype)
    assert ok, f"more than one ulp off the plain version, by {excess}"


@pytest.mark.card
@pytest.mark.parametrize("case", list(QK_CASES))
def test_qk_norm_split_kernel_matches_the_plain_version(card, case):
    b, n, m, heads, d, null, fused, dtype = QK_CASES[case]
    gen = torch.Generator().manual_seed(100 + list(QK_CASES).index(case))
    q, k, v = (t.to(card) for t in _qkv(b, n, m, heads, d, gen, dtype, fused))
    qs, ks = (s.to(card) for s in _scales(d, gen, torch.bfloat16))
    null_kv = torch.randn(heads, 2 * null, d, generator=gen).to(card, dtype) if null else None
    with torch.no_grad():
        before = qk_norm_split.launches
        got = qk_norm_split(q, k, v, heads, qs, ks, null_kv)
        torch.cuda.synchronize()
    assert qk_norm_split.launches == before + 1
    want = qk_norm_split_plain(q, k, v, heads, qs, ks, null_kv)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape
    assert torch.equal(got[2], want[2])  # v: copied
    for g, w in zip(got[:2], want[:2]):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        else:
            ok, excess = _within_one_ulp(g, w, dtype)
            assert ok, f"more than one ulp off the plain version, by {excess}"


@pytest.mark.card
@pytest.mark.parametrize("null", [0, 2])
def test_the_kernels_under_autograd_take_the_plain_gradients_on_the_card(card, null):
    """Training on the card: the kernels' forward, and the plain version's
    derivative written out, so every gradient agrees with the plain route's
    (`_grads_close`; one incoming gradient for both routes)."""
    gen = torch.Generator().manual_seed(200 + null)
    b, n, heads, d = 16, 288, 8, 64
    inner = heads * d
    x = (2 * torch.randn(b, n, inner, generator=gen)).to(card, torch.bfloat16).requires_grad_()
    gamma, beta = (p.to(card).requires_grad_() for p in _params(inner, gen))
    qkv = torch.randn(b, n, 3 * inner, generator=gen).to(card, torch.bfloat16).requires_grad_()
    qs, ks = (s.to(card).requires_grad_() for s in _scales(d, gen))
    null_kv = torch.randn(heads, 2 * null, d, generator=gen).to(card, torch.bfloat16).requires_grad_() if null else None
    ln_weight = [torch.randn(b, n, inner, generator=gen).to(card)]
    qk_weight = [torch.randn(b, heads, m, d, generator=gen).to(card) for m in (n, null + n, null + n)]

    def split(fn):
        return lambda t, *rest: fn(t[..., :inner], t[..., inner:2 * inner], t[..., 2 * inner:], heads, *rest)

    ln_before, qk_before = layer_norm.launches, qk_norm_split.launches
    ln_got = _grads(layer_norm, (x, gamma, beta), ln_weight)[1]
    qk_got = _grads(split(qk_norm_split), (qkv, qs, ks) + ((null_kv,) if null else ()), qk_weight)[1]
    torch.cuda.synchronize()
    assert (layer_norm.launches - ln_before, qk_norm_split.launches - qk_before) == (1, 1)
    ln_want = _grads(layer_norm_plain, (x, gamma, beta), ln_weight)[1]
    qk_want = _grads(split(qk_norm_split_plain), (qkv, qs, ks) + ((null_kv,) if null else ()), qk_weight)[1]
    _grads_close(ln_got + qk_got, ln_want + qk_want, torch.bfloat16)


@pytest.mark.card
def test_a_tiny_sample_launches_the_norm_kernels_once_a_norm(card):
    """Each MaskGit layer's four LayerNorms (its attention's, its
    cross-attention's and the context's, its feedforward's) and its two head
    splits, the stack's final norm, at each step; each decoder layer's two
    norms and one head split and each decoder stack's final norm; the greedy
    ids equal the CPU's."""
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
        ln_before, qk_before = layer_norm.launches, qk_norm_split.launches
        with torch.no_grad():
            ids[device] = ph.sample_ids(**kw).cpu()
            ph.sample(**kw)
        ln, qk = layer_norm.launches - ln_before, qk_norm_split.launches - qk_before
        if device == "cuda":
            decoder_ln = 2 * (spatial_depth + temporal_depth) + 2
            assert ln == 2 * steps * (4 * depth + 1) + decoder_ln
            assert qk == 2 * steps * 2 * depth + spatial_depth + temporal_depth
        else:
            assert ln == qk == 0
    assert torch.equal(ids["cuda"], ids["cpu"])
