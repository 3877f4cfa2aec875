"""The benchmark of `phenaki_tpu_torch`, the PyTorch and CUDA port: a harness
driven by data. `run.py` is the entry; see `README.md` for how a cell, a
configuration, a traffic mix and a per-layer metric are added as files."""
