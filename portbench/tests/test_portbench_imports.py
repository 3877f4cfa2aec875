"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names: `phenaki_tpu_torch` passes, `phenaki_tpu` does not."""

import ast

import pytest

from portbench.common import BENCH, forbidden_loaded


@pytest.mark.parametrize("modules, found", [
    ({"phenaki_tpu_torch", "phenaki_tpu_torch.models.maskgit", "torch"}, []),
    ({"phenaki_tpu", "torch"}, ["phenaki_tpu"]),
    ({"phenaki_tpu.ops.pallas_attention"}, ["phenaki_tpu.ops.pallas_attention"]),
    ({"jax.numpy", "jaxtyping"}, ["jax.numpy"]),
    ({"jaxlib", "flax.linen", "flaxible"}, ["flax.linen", "jaxlib"]),
])
def test_forbidden_names_are_whole_top_level_names(modules, found):
    assert forbidden_loaded(modules) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert forbidden_loaded(set(_imports(path))) == [], path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"phenaki_tpu_torch", "phenaki_tpu", "jax", "jaxlib", "flax"}, path
