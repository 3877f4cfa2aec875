"""The port's reference-checkpoint converters (phenaki_tpu_torch/convert.py)
and its reference-quirk flags against the JAX package, fp32 on the CPU.

No reference checkpoint is in the repository, and the reference package is
not installed here: the reference-layout state_dicts are built from the
flax parameters of a seeded JAX model by `_to_reference`, a test-only
inverse of JAX's layout rules (phenaki_tpu/convert.py; interleaved null
K/V, (out, in) Linear weights, the PEG's (dim, 1, kt, kh, kw) weight, the
reference's module indices, frozen zero betas, the self-attention's unused
context norm, and keys both converters ignore). The JAX converter is the
yardstick; tests/test_reference_parity.py holds it against the reference.

* the JAX converter applied to the inverse gives back the JAX parameters
  exactly (which checks the inverse);
* the port's converter equals the bridge applied to the JAX converter's
  tree, bit for bit: a MaskGit, a TokenCritic, a C-ViViT with LFQ and one
  with a cosine VQ;
* both converters raise on the same stray key, the same non-zero beta and
  the same model built without the flags;
* with `reference_attention_kv` (and the C-ViViT's `peg_reference_layout`)
  the port's MaskGit logits hold JAX's within 1e-5 and the C-ViViT's
  encode and decode within 1e-4; the flags change what the port computes.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu import convert as jconvert  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.maskgit import TokenCritic as JTokenCritic  # noqa: E402
from phenaki_tpu_torch import convert
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_cvivit_variables
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic

torch.set_num_threads(1)

FLAGS = dict(reference_attention_kv=True)
CV_FLAGS = dict(peg_reference_layout=True, reference_attention_kv=True)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=32, depth=2, heads=2, dim_head=16, dim_context=16)
CRITIC = dict(MASKGIT, has_cross_attn=True)
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=2, temporal_depth=2, dim_head=16, heads=2)
IDS_SHAPE = (2, 2, 2, 2)  # (b, t, h, w)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# the test-only inverse of JAX's layout rules


def _reference_attention(p, out, prefix, cross):
    out[prefix + "to_q.weight"] = p["to_q"]["kernel"].T
    out[prefix + "to_kv.weight"] = p["to_kv"]["kernel"].T
    out[prefix + "to_out.weight"] = p["to_out"]["kernel"].T
    out[prefix + "q_scale"] = p["q_scale"]
    out[prefix + "k_scale"] = p["k_scale"]
    out[prefix + "norm.gamma"] = p["norm"]["gamma"]
    out[prefix + "norm.beta"] = np.zeros_like(p["norm"]["gamma"])
    if "null_kv" in p:  # keys then values -> interleaved (k, v) pairs
        h, two_n, d = p["null_kv"].shape
        k, v = p["null_kv"][:, : two_n // 2], p["null_kv"][:, two_n // 2:]
        out[prefix + "null_kv"] = np.stack([k, v], axis=2).reshape(h, two_n, d)
    else:
        dim_head = p["q_scale"].shape[0]
        heads = p["to_q"]["kernel"].shape[1] // dim_head
        out[prefix + "null_kv"] = np.zeros((heads, 0, dim_head), np.float32)
    if cross:
        gamma = p["context_norm"]["gamma"]
    else:  # the reference's self-attention checkpoints an unused context norm
        gamma = np.ones_like(p["norm"]["gamma"])
    out[prefix + "context_norm.gamma"] = gamma
    out[prefix + "context_norm.beta"] = np.zeros_like(gamma)


def _reference_transformer(p, out, prefix):
    layers = sorted((k for k in p if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    for name in layers:
        layer, pre = p[name], f"{prefix}layers.{name.split('_')[1]}."
        if "peg" in layer:  # (kt, kh, kw, 1, dim) -> (dim, 1, kt, kh, kw)
            out[pre + "0.dsconv.weight"] = layer["peg"]["kernel"].transpose(4, 3, 0, 1, 2)
            out[pre + "0.dsconv.bias"] = layer["peg"]["bias"]
        _reference_attention(layer["self_attn"], out, pre + "1.", cross=False)
        if "cross_attn" in layer:
            _reference_attention(layer["cross_attn"], out, pre + "2.", cross=True)
        ff = layer["ff"]
        out[pre + "3.0.weight"] = ff["norm"]["gamma"]
        out[pre + "3.0.bias"] = ff["norm"]["beta"]
        out[pre + "3.1.weight"] = ff["proj_in"]["kernel"].T
        out[pre + "3.4.weight"] = ff["proj_out"]["kernel"].T
    out[prefix + "norm_out.gamma"] = p["norm_out"]["gamma"]
    out[prefix + "norm_out.beta"] = np.zeros_like(p["norm_out"]["gamma"])


def _reference_cpb(p, out, prefix):
    out[prefix + "net.0.0.weight"] = p["net_in"]["kernel"].T
    out[prefix + "net.0.0.bias"] = p["net_in"]["bias"]
    out[prefix + "net.1.0.weight"] = p["net_hidden_0"]["kernel"].T
    out[prefix + "net.1.0.bias"] = p["net_hidden_0"]["bias"]
    out[prefix + "net.2.weight"] = p["net_out"]["kernel"].T
    out[prefix + "net.2.bias"] = p["net_out"]["bias"]


def _to_reference(kind, params, vq_stats=None):
    """A reference-layout state_dict (torch tensors) from a JAX param tree."""
    out = {}
    if kind in ("maskgit", "critic"):
        out["token_emb.weight"] = params["token_emb"]["embedding"]
        out["pos_emb.weight"] = params["pos_emb"]["embedding"]
        if kind == "maskgit":
            _reference_cpb(params["continuous_pos_bias"], out, "continuous_pos_bias.")
        _reference_transformer(params["transformer"], out, "transformer.")
        head = "to_logits." if kind == "maskgit" else "to_logits.0."
        out[head + "weight"] = params["to_logits"]["kernel"].T
        out[head + "bias"] = params["to_logits"]["bias"]
    else:
        _reference_cpb(params["spatial_rel_pos_bias"], out, "spatial_rel_pos_bias.")
        for ref, ours in (("to_patch_emb_first_frame.", "first"), ("to_patch_emb.", "rest")):
            out[ref + "1.weight"] = params[f"patch_norm_in_{ours}"]["gamma"]
            out[ref + "1.bias"] = params[f"patch_norm_in_{ours}"]["beta"]
            out[ref + "2.weight"] = params[f"patch_proj_{ours}"]["kernel"].T
            out[ref + "2.bias"] = params[f"patch_proj_{ours}"]["bias"]
            out[ref + "3.weight"] = params[f"patch_norm_out_{ours}"]["gamma"]
            out[ref + "3.bias"] = params[f"patch_norm_out_{ours}"]["beta"]
        for name in ("enc_spatial_transformer", "enc_temporal_transformer",
                     "dec_spatial_transformer", "dec_temporal_transformer"):
            _reference_transformer(params[name], out, name + ".")
        out["to_pixels_first_frame.0.weight"] = params["to_pixels_first"]["kernel"].T
        out["to_pixels_first_frame.0.bias"] = params["to_pixels_first"]["bias"]
        out["to_pixels.0.weight"] = params["to_pixels_rest"]["kernel"].T
        out["to_pixels.0.bias"] = params["to_pixels_rest"]["bias"]
        if "vq" in params:  # LFQ projections; the reference's carry a bias neither port reads
            out["vq.project_in.weight"] = params["vq"]["project_in"]["kernel"].T
            out["vq.project_in.bias"] = np.zeros(params["vq"]["project_in"]["kernel"].shape[1], np.float32)
            out["vq.project_out.weight"] = params["vq"]["project_out"]["kernel"].T
        if vq_stats is not None:  # the cosine VQ's codebook and its EMA buffers
            out["vq._codebook.embed"] = vq_stats["codebook"][None]
            out["vq._codebook.cluster_size"] = np.ones(vq_stats["codebook"].shape[0], np.float32)
            out["vq._codebook.initted"] = np.ones(1, np.float32)
        out["discr.to_logits.0.weight"] = np.ones((1, 4), np.float32)  # the GAN's, ignored
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def test_package_exports_the_jax_names():
    import phenaki_tpu
    import phenaki_tpu_torch

    assert sorted(phenaki_tpu_torch.__all__) == sorted(phenaki_tpu.__all__)
    assert phenaki_tpu_torch.convert_cvivit_state_dict is convert.convert_cvivit_state_dict
    for name in phenaki_tpu_torch.__all__:
        assert getattr(phenaki_tpu_torch, name).__module__.startswith("phenaki_tpu_torch."), name


# the models


def _jax_maskgit(kind):
    if kind == "maskgit":
        mod = JMaskGit(**MASKGIT, **FLAGS)
    else:
        mod = JTokenCritic(**CRITIC, **FLAGS)
    variables = mod.init(jax.random.PRNGKey(3), jnp.zeros(IDS_SHAPE, jnp.int32),
                         context=jnp.zeros((2, 4, 16)))
    return mod, _numpy_tree(variables["params"])


def _port(kind, **flags):
    if kind == "maskgit":
        return MaskGit(**MASKGIT, **flags)
    if kind == "critic":
        return TokenCritic(**CRITIC, **flags)
    return CViViT(**CVIVIT, lookup_free_quantization=(kind == "cvivit_lfq"), **flags)


def _jax_cvivit(kind):
    mod = JCViViT(**CVIVIT, lookup_free_quantization=(kind == "cvivit_lfq"), **CV_FLAGS)
    variables = _numpy_tree(mod.init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 16, 16, 3))))
    return mod, variables


@pytest.fixture(scope="module", params=["maskgit", "critic", "cvivit_lfq", "cvivit_vq"])
def case(request):
    """(kind, the JAX module, its variables, the reference state_dict)."""
    kind = request.param
    if kind.startswith("cvivit"):
        mod, variables = _jax_cvivit(kind)
        stats = variables["vq_stats"]["vq"] if "vq_stats" in variables else None
        return kind, mod, variables, _to_reference(kind, variables["params"], stats)
    mod, params = _jax_maskgit(kind)
    return kind, mod, {"params": params}, _to_reference(kind, params)


JAX_CONVERTERS = {"maskgit": jconvert.convert_maskgit_state_dict,
                  "critic": jconvert.convert_token_critic_state_dict,
                  "cvivit_lfq": jconvert.convert_cvivit_state_dict,
                  "cvivit_vq": jconvert.convert_cvivit_state_dict}
PORT_CONVERTERS = {"maskgit": convert.convert_maskgit_state_dict,
                   "critic": convert.convert_token_critic_state_dict,
                   "cvivit_lfq": convert.convert_cvivit_state_dict,
                   "cvivit_vq": convert.convert_cvivit_state_dict}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


def test_jax_converter_inverts_the_reference_layout(case):
    kind, mod, variables, sd = case
    got = _flat(JAX_CONVERTERS[kind](sd, mod))
    expected = dict(variables["params"])
    if kind == "cvivit_vq":  # JAX's converter puts the codebook beside the params
        expected["vq"] = {"codebook": variables["vq_stats"]["vq"]["codebook"]}
    expected = _flat(expected)
    assert sorted(got) == sorted(expected)
    for key, arr in expected.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def _bridged(kind, tree, port_module):
    """The bridge applied to the JAX converter's tree: a port state_dict."""
    if kind != "cvivit_vq":
        return flax_to_state_dict(tree)
    params = {k: v for k, v in tree.items() if k != "vq"}
    stats = {"codebook": tree["vq"]["codebook"], "cluster_size": port_module.vq.cluster_size.numpy()}
    fresh = _port(kind, **CV_FLAGS)
    return load_cvivit_variables(fresh, {"params": params, "vq_stats": {"vq": stats}}).state_dict()


def test_port_converter_equals_bridged_jax_converter(case):
    kind, mod, _, sd = case
    flags = CV_FLAGS if kind.startswith("cvivit") else FLAGS
    module = _port(kind, **flags)
    got = PORT_CONVERTERS[kind](sd, module)
    expected = _bridged(kind, JAX_CONVERTERS[kind](sd, mod), module)
    assert sorted(got) == sorted(expected) == sorted(module.state_dict())
    for key, t in expected.items():
        assert torch.equal(got[key], t.float()), key
    module.load_state_dict(got)  # strict: every key of the module, no other


@pytest.mark.parametrize("fault", ["stray_key", "nonzero_beta", "unflagged"])
def test_both_converters_refuse_the_same_input(case, fault):
    kind, mod, _, sd = case
    flags = CV_FLAGS if kind.startswith("cvivit") else FLAGS
    module = _port(kind, **flags)
    sd = dict(sd)
    if fault == "stray_key":
        sd["transformer.layers.0.bogus"] = torch.zeros(1)
    elif fault == "nonzero_beta":
        key = next(k for k in sd if k.endswith("norm_out.beta"))
        sd[key] = torch.full_like(sd[key], 0.5)
    else:
        mod = mod.clone(reference_attention_kv=False)
        module = _port(kind, **dict(flags, reference_attention_kv=False))
    with pytest.raises((AssertionError, ValueError)):
        JAX_CONVERTERS[kind](sd, mod)
    with pytest.raises(ValueError):
        PORT_CONVERTERS[kind](sd, module)


def test_unflagged_cvivit_peg_layout_is_refused():
    _, variables = _jax_cvivit("cvivit_lfq")
    sd = _to_reference("cvivit_lfq", variables["params"])
    with pytest.raises(ValueError, match="peg_reference_layout"):
        convert.convert_cvivit_state_dict(sd, _port("cvivit_lfq", reference_attention_kv=True))


def test_non_strict_ignores_stray_keys_and_keeps_the_module_values():
    """strict=False converts what it can: a stray key is ignored, and a
    cosine VQ's codebook the reference lacks keeps the module's own."""
    _, variables = _jax_cvivit("cvivit_vq")
    sd = _to_reference("cvivit_vq", variables["params"])  # no vq._codebook.embed
    sd["bogus"] = torch.zeros(1)
    module = _port("cvivit_vq", **CV_FLAGS)
    with pytest.raises(ValueError, match="bogus"):
        convert.convert_cvivit_state_dict(sd, module)
    got = convert.convert_cvivit_state_dict(sd, module, strict=False)
    assert torch.equal(got["vq.embed"], module.vq.embed)


# the flags against JAX on the converted weights


def _converted(kind):
    mod, params = _jax_maskgit(kind)
    sd = _to_reference(kind, params)
    port = _port(kind, **FLAGS)
    port.load_state_dict(PORT_CONVERTERS[kind](sd, port))
    return mod, JAX_CONVERTERS[kind](sd, mod), port.eval()


@pytest.mark.parametrize("kind", ["maskgit", "critic"])
def test_flagged_maskgit_matches_jax(kind):
    mod, params, port = _converted(kind)
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 65, size=IDS_SHAPE)
    ctx = rs.randn(2, 4, 16).astype(np.float32)
    tmask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], dtype=bool)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(ids), context=jnp.asarray(ctx),
                               text_mask=jnp.asarray(tmask), deterministic=True))
    kw = dict(context=torch.from_numpy(ctx), text_mask=torch.from_numpy(tmask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), **kw).numpy()
        unflagged = _port(kind)
        unflagged.load_state_dict(port.state_dict())
        plain = unflagged.eval()(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert np.abs(plain - ref).max() > 1e-3, "the flag must change what the model computes"


@pytest.mark.parametrize("kind", ["cvivit_lfq", "cvivit_vq"])
def test_flagged_cvivit_matches_jax(kind):
    mod, variables = _jax_cvivit(kind)
    sd = _to_reference(kind, variables["params"],
                       variables["vq_stats"]["vq"] if "vq_stats" in variables else None)
    port = _port(kind, **CV_FLAGS)
    port.load_state_dict(convert.convert_cvivit_state_dict(sd, port))
    port.eval()
    video = np.random.RandomState(6).rand(2, 5, 16, 16, 3).astype(np.float32)

    def run(m, v):
        enc = m.encode(m._to_patch_tokens(v))
        return enc, m.decode(enc)

    enc_ref, recon_ref = mod.apply(variables, jnp.asarray(video), method=run)
    with torch.no_grad():
        enc, recon = run(port, torch.from_numpy(video))
        unflagged = _port(kind)
        unflagged.load_state_dict(port.state_dict())
        enc_plain, _ = run(unflagged.eval(), torch.from_numpy(video))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_ref), atol=1e-4, rtol=0)
    assert np.abs(enc_plain.numpy() - np.asarray(enc_ref)).max() > 1e-3
