"""Checkpoints (counterpart of phenaki_tpu/training/checkpoint.py, without
Orbax): a tree of dicts, lists and tensors (state dicts, an optimizer's
state, a generator's state) saved with `torch.save`, one file a milestone,
written under a temporary name and renamed, so a crash mid-write leaves the
previous file whole. Loads use `torch.load(weights_only=True)`, which
unpickles tensors and plain containers only. The writes are synchronous:
`CheckpointManager.wait` and `close` exist so that a trainer reads as the
TPU package's.

A checkpoint always holds the global (consolidated) state, as one process
would: `consolidate` turns a rank's tensor-parallel and FSDP-sharded
tensors (parameters, and an optimizer's or an EMA's state of the same
layout) into the global ones, collectively over the mesh, and
`parallel.mesh.place_like` cuts global tensors back to a rank's layout,
so a checkpoint written on one mesh loads on any other
(`parallel.tp_inference`, `global_value` and `local_value`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

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


def consolidate(tensors: Dict[str, torch.Tensor], mesh, shapes: Dict[str, Sequence[int]]
                ) -> Dict[str, torch.Tensor]:
    """Each rank-local tensor by its parameter name, as the global tensor of
    global shape `shapes[name]`, on the CPU; collective over `mesh` (every
    rank calls it with the same names, in the same order)."""
    from phenaki_tpu_torch.parallel.tp_inference import global_value

    return {name: global_value(name, t, mesh, shapes[name]).cpu() for name, t in tensors.items()}


def consolidate_optimizer(opt: torch.optim.Optimizer, names: List[str], mesh,
                          shapes: Dict[str, Sequence[int]]) -> dict:
    """An optimizer's state_dict with every per-parameter tensor of the
    parameter's shape (Adam's moments) consolidated; `names` are the
    optimizer's parameters' names in its order."""
    sd = opt.state_dict()
    state = {}
    for i, per in sd["state"].items():
        name = names[i]
        state[i] = {k: consolidate({name: v}, mesh, shapes)[name]
                    if isinstance(v, torch.Tensor) and v.ndim else v for k, v in per.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


@torch.no_grad()
def load_sharded(module_params: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor], mesh) -> None:
    """Copy global `values` into this rank's tensors `module_params` (a
    module's `state_dict()` or named parameters) in place."""
    from phenaki_tpu_torch.parallel.mesh import place_like

    for name, local in place_like(module_params, values, mesh).items():
        target = module_params[name]
        if hasattr(target, "to_local"):
            target.to_local().copy_(local.to_local())
        else:
            target.copy_(local)


def shard_optimizer_state(sd: dict, params: List[torch.Tensor], names: List[str], mesh) -> dict:
    """A consolidated optimizer state_dict cut to this rank's parameters."""
    from phenaki_tpu_torch.parallel.mesh import place_like

    state = {}
    for i, per in sd["state"].items():
        name, p = names[i], params[i]
        state[i] = {k: place_like({name: p}, {name: v}, mesh)[name]
                    if isinstance(v, torch.Tensor) and v.ndim else v for k, v in per.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


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
