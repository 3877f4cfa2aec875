"""Metric logging and trace capture (counterpart of
phenaki_tpu/utils/logging.py): `accum_log`, a rank-0 JSONL `MetricLogger`,
`profile_trace`, a `torch.profiler` capture of a region written as a
Chrome trace (`chrome://tracing`, Perfetto) in place of `jax.profiler`'s,
and `span`, the program's named ranges inside such a capture.

The spans, each a fixed name under `phenaki.` (no name a prefix of
another): `phenaki.sample` (a whole `Phenaki.sample` call) holds
`phenaki.tokenize_prime`, `phenaki.prepare` (the text, the position bias,
the head's cast), one `phenaki.decode_step` a decoding step and
`phenaki.cvivit_decode`; a step holds `phenaki.remask`,
`phenaki.maskgit_forward`, `phenaki.pick_tokens` and, with a critic,
`phenaki.critic_forward` and `phenaki.critic_noise`. A trainer step holds
`phenaki.train_data`, `phenaki.train_loss_backward`,
`phenaki.train_optimizer` and, when due, `phenaki.train_milestone`.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from phenaki_tpu_torch.utils.results_folder import process_rank


def accum_log(log: Dict, new_logs: Dict) -> Dict:
    """Add each of `new_logs` into `log`."""
    for key, new_value in new_logs.items():
        log[key] = log.get(key, 0.0) + new_value
    return log


class MetricLogger:
    """Appends one JSON line a `log` call to `path` (rank 0 only), with
    the seconds since the logger was made. Without a path it does nothing,
    so it never reads a device scalar back."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._t0 = time.time()
        if self.path and process_rank() == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.path is None or process_rank() != 0:
            return
        record = {"step": step, "t": time.time() - self._t0, **{k: float(v) for k, v in metrics.items()}}
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the region under it `name` in a running
    `torch.profiler` capture, on the clock of the device's kernels; with no
    capture running, one shared context that does nothing (no profiler call)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def start_trace() -> profile:
    """Start a `torch.profiler` capture of the host and, where there is a
    card, the device."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: profile, log_dir: str) -> Path:
    """Stop `prof` and write its Chrome trace into `log_dir`; returns the file."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    folder = Path(log_dir)
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Capture the region under the `with` into a Chrome trace in `log_dir`."""
    if not enabled:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)
