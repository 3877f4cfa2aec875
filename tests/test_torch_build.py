"""The port's build and device rules that hold on a machine without a card:
a missing nvcc is an error (never a silent CPU run), the library is keyed by
its sources, and `flagship_phenaki` refuses a CUDA device it cannot see."""

import pytest
import torch

from phenaki_tpu_torch import _build
from phenaki_tpu_torch.presets import flagship_phenaki, flagship_train_phenaki

torch.set_num_threads(1)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    key = _build._source_key(["nvcc", "-O3"])
    assert _build._source_key(["nvcc", "-O3"]) == key
    assert _build._source_key(["nvcc", "-O2"]) != key
    (tmp_path / "a.cu").write_text("// two")
    assert _build._source_key(["nvcc", "-O3"]) != key


@pytest.mark.parametrize("preset", [flagship_phenaki, flagship_train_phenaki])
def test_flagship_on_cuda_needs_a_card(preset):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        preset(seed=0, device="cuda")


def test_concurrent_loaders_build_once(monkeypatch, tmp_path):
    """Two loaders that start together (the ranks of a process group) build
    the library once: the second waits for the first's lock, then finds the
    library built. Mocked: the compile writes the file, the loader is a stub."""
    import threading
    import time
    from types import SimpleNamespace

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// kernel")
    monkeypatch.setattr(_build, "_CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_lib", None)
    builds, inside = [], []

    def compile_(base, sources, so):
        inside.append(1)
        assert len(inside) == 1, "two builds ran at once"
        time.sleep(0.3)
        so.write_text("library")
        builds.append(so)
        inside.pop()

    class _Lib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    loaded, errors = [], []

    def loader():
        try:
            loaded.append(_build.load_library())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=loader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(loaded) == 2
    assert len(builds) == 1 and builds[0].read_text() == "library"
