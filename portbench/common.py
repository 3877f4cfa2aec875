"""What every driver shares: the checkout's paths, seeds, the import check,
the device record and the comparison record that decides `correct`."""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "phenaki_tpu")
GB = 1e9


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed and keys."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *keys]).generate_state(1, np.uint64)[0] % 2**63)


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN_MODULES, compared whole: `phenaki_tpu_torch` passes,
    `phenaki_tpu` and `jax.numpy` do not."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation; inf counts."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclass
class Check:
    """One number the comparison holds to a limit (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back to `run.py`."""

    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    checks: List[Check]
    device: Dict[str, Any]
    breakdown: Optional[dict] = None
    notes: Dict[str, Any] = field(default_factory=dict)  # printed on an earlier line

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


@dataclass
class Spec:
    """One run: the cell's parts as read from the files, and the run's
    arguments. `control` also reads the control's numbers after the
    window (for setting limits; never in a benchmark run)."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1
    control: bool = False
    t_start: float = field(default_factory=time.perf_counter)

    def scratch(self) -> Path:
        """A folder under the run's TMPDIR for what the program writes."""
        base = Path(os.environ.get("TMPDIR") or "/tmp")
        path = base / f"portbench-{self.workload}-{os.getpid()}"
        path.mkdir(parents=True, exist_ok=True)
        return path


def metric(value: float, unit: str) -> Dict[str, Any]:
    return {"value": float(value), "unit": unit}


def device_record(torch, device: str, chips: int, peak_bytes: int) -> Dict[str, Any]:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
