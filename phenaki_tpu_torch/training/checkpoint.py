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
(`parallel.tp_inference`, `global_value` and `local_value`). On a mesh
with a 'pp' axis each stage holds only its own trunk layers: `consolidate`
also gathers those over the pp group, and an optimizer's state is written
in the order of the whole model's optimizer (`consolidate_optimizer`'s
`groups`), which `shard_optimizer_state` reads back by name.
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


def _gather_stages(tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """`tree` (by parameter name) with the other pipeline stages' trunk
    layers added: each rank sends its entries of trunk layers over the pp
    group (one collective); a replicated entry stays this rank's own."""
    from phenaki_tpu_torch.parallel.collectives import group_size
    from phenaki_tpu_torch.parallel.mesh import TRUNK_LAYER

    group = mesh.pp_group if mesh is not None else None
    if group_size(group) == 1:
        return tree
    import torch.distributed as dist

    mine = {k: v for k, v in tree.items() if TRUNK_LAYER.match(k)}
    parts: List[Any] = [None] * group_size(group)
    dist.all_gather_object(parts, mine, group=group)
    merged = dict(tree)
    for part in parts:
        for k, v in part.items():
            merged.setdefault(k, v)
    return merged


def consolidate(tensors: Dict[str, torch.Tensor], mesh, shapes: Dict[str, Sequence[int]]
                ) -> Dict[str, torch.Tensor]:
    """Each rank-local tensor by its parameter name, as the global tensor of
    global shape `shapes[name]`, on the CPU, and on a pipeline mesh the
    other stages' trunk layers too; collective over `mesh` (every rank calls
    it with the same names, in the same order, as its stage holds them)."""
    from phenaki_tpu_torch.parallel.tp_inference import global_value

    local = {name: global_value(name, t, mesh, shapes[name]).cpu() for name, t in tensors.items()}
    return _gather_stages(local, mesh)


def optimizer_groups(opt: torch.optim.Optimizer, named_params) -> List[List[str]]:
    """The names of an optimizer's parameters, group by group, in its
    state_dict's index order, from (name, parameter) pairs."""
    name_of = {id(p): n for n, p in named_params}
    return [[name_of[id(p)] for p in g["params"]] for g in opt.param_groups]


def consolidate_optimizer(opt: torch.optim.Optimizer, names: List[str], mesh,
                          shapes: Dict[str, Sequence[int]], groups: List[List[str]]) -> dict:
    """An optimizer's state_dict with every per-parameter tensor of the
    parameter's shape (Adam's moments) consolidated; `names` are the
    optimizer's parameters' names in its index order. The written state
    follows `groups`, the whole model's optimizer's groups by name: the
    optimizer's own (`optimizer_groups`), unless it holds a pipeline
    stage's part of them."""
    from phenaki_tpu_torch.parallel.tp_inference import global_value

    sd = opt.state_dict()
    if len(groups) != len(sd["param_groups"]):
        raise ValueError(f"{len(groups)} groups given, the optimizer has {len(sd['param_groups'])}")
    by_name = {}
    for i, per in sd["state"].items():
        name = names[i]
        by_name[name] = {k: global_value(name, v, mesh, shapes[name]).cpu()
                         if isinstance(v, torch.Tensor) and v.ndim else v for k, v in per.items()}
    by_name = _gather_stages(by_name, mesh)
    order = [n for g in groups for n in g]
    param_groups, start = [], 0
    for group, own in zip(groups, sd["param_groups"]):
        param_groups.append({**own, "params": list(range(start, start + len(group)))})
        start += len(group)
    return {"state": {i: by_name[n] for i, n in enumerate(order) if n in by_name},
            "param_groups": param_groups}


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


def shard_optimizer_state(sd: dict, opt: torch.optim.Optimizer, names: List[str], mesh,
                          written: List[str]) -> dict:
    """A consolidated optimizer state_dict cut to the parameters of `opt`,
    this rank's optimizer (`names`: its parameters' names in its index
    order); `written` names the written state's parameters in its index
    order (`consolidate_optimizer`'s `groups`, flattened)."""
    from phenaki_tpu_torch.parallel.mesh import place_like

    params = [p for g in opt.param_groups for p in g["params"]]
    index = {n: i for i, n in enumerate(written)}
    state = {}
    for i, (name, p) in enumerate(zip(names, params)):
        per = sd["state"].get(index[name])
        if per is None:
            continue
        state[i] = {k: place_like({name: p}, {name: v}, mesh)[name]
                    if isinstance(v, torch.Tensor) and v.ndim else v for k, v in per.items()}
    own_groups = opt.state_dict()["param_groups"]
    return {"state": state, "param_groups": [{**written_group, "params": own["params"]}
                                             for written_group, own in zip(sd["param_groups"], own_groups)]}


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
