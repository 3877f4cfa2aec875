"""The flax -> PyTorch parameter bridge (phenaki_tpu_torch/bridge.py), and the
rule that the port imports no JAX.

The bridge must give the same state_dict for an unrolled tree and for its
`scan_layers` stacked form, map each leaf to its port layout (Dense
transposes, the fused [k | v] projection, null_kv, the PEG stencil), and
refuse a tree that lacks a parameter or has the wrong shape. It also maps a
JAX gradient tree to the port's parameter names and layouts (the training
tests compare gradients through it), and loads unconditional MaskGit trees.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.transformer import stack_layer_params  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models.maskgit import MaskGit

torch.set_num_threads(1)

CFG = dict(dim=32, num_tokens=64, max_seq_len=64, depth=2, heads=2, dim_head=16, dim_context=16)
PORT_ROOTS = [Path(__file__).resolve().parents[1] / "phenaki_tpu_torch",
              Path(__file__).resolve().parents[1] / "chip_smoke.py"]


@pytest.fixture(scope="module")
def unrolled_params():
    mod = JMaskGit(**CFG)
    variables = jit_init(mod, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         video_patch_shape=(2, 2, 2), context=jnp.zeros((1, 4, 16)))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables["params"]))


def test_scan_tree_gives_the_unrolled_state_dict(unrolled_params):
    scan = dict(unrolled_params)
    scan["transformer"] = jax.tree_util.tree_map(
        np.asarray, stack_layer_params(unrolled_params["transformer"], CFG["depth"]))
    sd_unrolled = flax_to_state_dict(unrolled_params)
    sd_scan = flax_to_state_dict(scan)
    assert sorted(sd_unrolled) == sorted(sd_scan)
    for name in sd_unrolled:
        assert torch.equal(sd_unrolled[name], sd_scan[name]), name
    assert sorted(sd_unrolled) == sorted(MaskGit(**CFG).state_dict())


def test_leaf_layouts(unrolled_params):
    sd = flax_to_state_dict(unrolled_params)
    layer = unrolled_params["transformer"]["layers_1"]
    inner = CFG["heads"] * CFG["dim_head"]
    to_kv = sd["transformer.layers.1.cross_attn.to_kv.weight"].numpy()
    kernel = layer["cross_attn"]["to_kv"]["kernel"]  # (dim_context, 2 * inner)
    np.testing.assert_array_equal(to_kv[:inner], kernel[:, :inner].T)  # k
    np.testing.assert_array_equal(to_kv[inner:], kernel[:, inner:].T)  # v
    np.testing.assert_array_equal(sd["transformer.layers.1.cross_attn.null_kv"].numpy(),
                                  layer["cross_attn"]["null_kv"])
    peg = sd["transformer.layers.1.peg.weight"].numpy()
    np.testing.assert_array_equal(peg[5, 0, 2, 1, 0], layer["peg"]["kernel"][2, 1, 0, 0, 5])
    np.testing.assert_array_equal(sd["token_emb.weight"].numpy(),
                                  unrolled_params["token_emb"]["embedding"])
    np.testing.assert_array_equal(sd["continuous_pos_bias.net_hidden.0.weight"].numpy(),
                                  unrolled_params["continuous_pos_bias"]["net_hidden_0"]["kernel"].T)

    mod = load_flax_params(MaskGit(**CFG), unrolled_params)
    np.testing.assert_array_equal(mod.to_logits.weight.detach().numpy(),
                                  unrolled_params["to_logits"]["kernel"].T)


def test_incomplete_or_misshapen_tree_raises(unrolled_params):
    missing = {k: v for k, v in unrolled_params.items() if k != "pos_emb"}
    with pytest.raises(KeyError):
        load_flax_params(MaskGit(**CFG), missing)
    with pytest.raises(ValueError):
        load_flax_params(MaskGit(**{**CFG, "max_seq_len": 32}), unrolled_params)


def test_gradient_tree_maps_to_port_grads(unrolled_params):
    """jax.grad of a MaskGit forward, mapped through the bridge, equals the
    port's autograd gradients of the same forward (fp32, 8 tokens: the plain
    attention path on both sides)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 65, size=(2, 8))
    ctx = rng.randn(2, 4, 16).astype(np.float32)
    cot = rng.randn(2, 8, 64).astype(np.float32)
    mod = JMaskGit(**CFG)

    def f(params):
        logits = mod.apply({"params": params}, jnp.asarray(ids), video_patch_shape=(2, 2, 2),
                           context=jnp.asarray(ctx))
        return jnp.sum(logits * cot)

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.grad(f)(unrolled_params)))
    port = load_flax_params(MaskGit(**CFG), unrolled_params)
    logits = port(torch.from_numpy(ids), video_patch_shape=(2, 2, 2), context=torch.from_numpy(ctx))
    (logits * torch.from_numpy(cot)).sum().backward()
    named = dict(port.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, p in named.items():
        assert p.grad.shape == ref[name].shape, name
        torch.testing.assert_close(p.grad, ref[name], atol=1e-4 * max(ref[name].abs().max().item(), 1.0),
                                   rtol=0, msg=name)


def test_unconditional_tree_loads():
    cfg = {**CFG, "dim_context": None}
    jmod = JMaskGit(**cfg, unconditional=True)
    variables = jit_init(jmod, jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                         video_patch_shape=(2, 2, 2))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["params"]))
    port = load_flax_params(MaskGit(**cfg, unconditional=True), params)
    assert not any("cross_attn" in name for name in port.state_dict())
    ids = np.random.RandomState(2).randint(0, 65, size=(2, 8))
    ref = jmod.apply(variables, jnp.asarray(ids), video_patch_shape=(2, 2, 2))
    with torch.no_grad():
        out = port(torch.from_numpy(ids), video_patch_shape=(2, 2, 2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [p for root in PORT_ROOTS for p in ([root] if root.is_file() else root.rglob("*.py"))
             if "_build" not in p.parts]  # build output, not the package's sources
    assert len(files) > 10
    banned = ("jax", "flax", "optax", "phenaki_tpu")
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in banned, f"{path} imports {name}"


@pytest.mark.parametrize("name", ["test_torch_ring_attention.py", "test_torch_seq_parallel.py"])
def test_rank_test_modules_import_no_jax_at_module_level(name):
    """A spawned rank imports its test module by name: the module's own
    imports (module level) must pull no JAX; the tests import it inside."""
    tree = ast.parse((Path(__file__).resolve().parent / name).read_text())
    banned = ("jax", "flax", "optax", "phenaki_tpu")
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        for mod in names:
            assert mod.split(".")[0] not in banned, f"{name} imports {mod} at module level"
