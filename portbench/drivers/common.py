"""Set-up and read-out the drivers share."""

from __future__ import annotations

import gc
import importlib.util
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench.common import BENCH, Check, metric


def setup_torch(spec):
    """torch, with the port's kernels loaded on the card (built at first use
    into the checkout's `phenaki_tpu_torch/_build/`, found there after)."""
    import torch

    if spec.device == "cuda":
        torch.cuda.set_device(0)
        from phenaki_tpu_torch import _build

        _build.load_library()
    return torch


def peak_bytes(torch, device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def free_program(torch, device: str) -> None:
    """Free what the caller dropped of the program before the reference runs."""
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def limits_checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    return [Check(k, float(numbers[k]), float(limits[k])) for k in limits if k in numbers]


def per_layer(spec, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell (BENCHMARK.json lists them) read by
    its own reader, `metrics/<name>.py`; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in spec.traffic["_per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


class Clock:
    """Host seconds since the process started (`spec.t_start`)."""

    def __init__(self, spec):
        self.t0 = spec.t_start

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


class Ctx:
    """What a per-layer reader reads: the cell's files, the parsed trace (a
    traced run) and what the cell's `drivers/<kind>.py` counted."""

    def __init__(self, config: dict, traffic: dict, trace, **counted):
        self.config, self.traffic, self.trace = config, traffic, trace
        self.__dict__.update(counted)

    def get(self, name: str, default=None):
        return self.__dict__.get(name, default)


def device_trace_record(trace) -> Optional[dict]:
    if trace is None or trace.window_s <= 0:
        return None
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s}


def scratch_cleanup(path: Path) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
