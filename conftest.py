"""Repository-wide pytest setup: build the native IO library once, before
any test module is collected.

`phenaki_tpu.data.native` builds `native/libphenaki_io.so` with `make` on
first use. Under pytest-xdist every worker imports `tests/test_native_io.py`
while collecting, so on a tree without the library several workers ran
`make` on the same output file at once, and a worker that loaded a
half-written file skipped that module's tests. Building here, on the
controller (or the only process without xdist), hands every worker a whole
library.

This file imports neither jax nor phenaki_tpu: `tests/conftest.py` sets
XLA_FLAGS before JAX loads.
"""

import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_TIMEOUT_S = 300


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    if not (NATIVE_DIR / "Makefile").exists() or shutil.which("make") is None:
        return
    # a failed build leaves no library: tests/test_torch_native_prebuilt.py
    # then fails and says so, rather than test_native_io.py skipping quietly
    try:
        subprocess.run(["make", "-C", str(NATIVE_DIR)], capture_output=True, timeout=BUILD_TIMEOUT_S,
                       check=False)
    except subprocess.TimeoutExpired:
        pass
