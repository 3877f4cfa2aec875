"""The repository's conftest.py builds the native IO library before the
test workers collect. Where the build tools exist, the library must then be
on disk and load: a broken pre-build fails here instead of skipping every
test of tests/test_native_io.py without a word."""

import ctypes
import shutil
from pathlib import Path

import pytest

LIB = Path(__file__).resolve().parents[1] / "native" / "libphenaki_io.so"


def test_native_io_library_is_prebuilt_and_loads():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("make or g++ is not on PATH: nothing could build the library")
    assert LIB.exists(), f"{LIB} was not built before the tests ran"
    lib = ctypes.CDLL(str(LIB))
    assert hasattr(lib, "io_gif_decode") and hasattr(lib, "io_gif_encode")
