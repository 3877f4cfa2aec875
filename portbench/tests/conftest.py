"""The benchmark's own tests (`python -m pytest portbench/tests -q` from the
checkout's root). They run on the CPU at tiny sizes; those marked `card`
need a CUDA device, decide so inside the test, and skip without one."""

import os

# the port's text encoder may import transformers, which must load no JAX here either
for key, value in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"), ("HF_HUB_OFFLINE", "1"),
                   ("TRANSFORMERS_OFFLINE", "1")):
    os.environ.setdefault(key, value)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
