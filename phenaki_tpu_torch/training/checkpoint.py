"""Checkpoints (counterpart of phenaki_tpu/training/checkpoint.py, without
Orbax): a tree of dicts, lists and tensors (state dicts, an optimizer's
state, a generator's state) saved with `torch.save`, one file a milestone,
written under a temporary name and renamed, so a crash mid-write leaves the
previous file whole. Loads use `torch.load(weights_only=True)`, which
unpickles tensors and plain containers only. The writes are synchronous:
`CheckpointManager.wait` and `close` exist so that a trainer reads as the
TPU package's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, List, Optional

import torch

SUFFIX = ".pt"


def save_pytree(path: str | os.PathLike, tree: Any) -> None:
    """Write `tree` to `path` through a temporary file in the same folder."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_pytree(path: str | os.PathLike, map_location="cpu") -> Any:
    """The tree saved at `path`, its tensors on `map_location`."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_meta(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


class CheckpointManager:
    """Trees saved and restored by integer milestone, `{step}.pt` in
    `directory`; with `max_to_keep`, the oldest beyond it are deleted."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.directory / f"{step}{SUFFIX}"

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write `state` as milestone `step` (synchronously: `wait` changes nothing)."""
        save_pytree(self.path(step), state)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                self.path(old).unlink()

    def _step(self, step: Optional[int]) -> int:
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """Milestone `step`'s tree (the latest when None)."""
        return load_pytree(self.path(self._step(step)), map_location)

    def metadata(self, step: Optional[int] = None) -> Any:
        """Milestone `step`'s tree with each tensor as a "meta" tensor (shape
        and dtype, no data); the file is memory-mapped, not read."""
        return _to_meta(torch.load(self.path(self._step(step)), mmap=True, weights_only=True))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem) for p in self.directory.glob(f"*{SUFFIX}") if p.stem.isdigit())

    def wait(self) -> None:
        """Nothing to wait for: every save has finished when it returns."""

    def close(self) -> None:
        """Nothing to release."""
