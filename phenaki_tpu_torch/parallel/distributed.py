"""Multi-process initialisation over `torch.distributed` (counterpart of
phenaki_tpu/parallel/distributed.py).

Every rank runs the same program. `init_distributed` joins the process
group; the backend and the rendezvous are explicit, as nothing on a machine
tells a program of its cluster:

* backend: NCCL when every rank has a GPU of its own (`torch.cuda.device_count()
  >= world_size`), gloo otherwise (CPU ranks, or several ranks sharing one
  GPU: NCCL refuses two ranks on one device). `backend=` overrides it.
* rendezvous: `init_method` is a URL (`tcp://localhost:<port>`,
  `file:///path`), or `store` a `torch.distributed.Store` (a `FileStore`
  in the tests); with neither, the `env://` variables (`MASTER_ADDR`,
  `MASTER_PORT`, `RANK`, `WORLD_SIZE`).

With NCCL the rank's current CUDA device is set to `cuda:<rank % count>`.

`spawn_ranks(fn, world_size, ...)` runs `fn(rank, world_size, *args)` in
that many spawned processes joined to one group, and returns what each
returned, in rank order; the tests and `chip_smoke.py` run their rings so.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist


def default_backend(world_size: int) -> str:
    """'nccl' when every rank can own a GPU, else 'gloo'."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(rank: Optional[int] = None, world_size: Optional[int] = None, *,
                     init_method: Optional[str] = None, store: Optional[dist.Store] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the default process group and return (process_index,
    process_count). A no-op when the group exists already; a single process
    with no rendezvous given is rank 0 of 1 and starts no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None and store is None and world_size in (None, 1):
        return 0, 1
    if world_size is None:
        raise ValueError("world_size must be given with a rendezvous")
    backend = backend or default_backend(world_size)
    kw = dict(backend=backend, world_size=world_size)
    if rank is not None:
        kw["rank"] = rank
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 predicate (the reference's `accelerator.is_main_process`)."""
    return process_index() == 0


def _rank_main(fn, rank, world_size, store_path, backend, results, args):
    try:
        init_distributed(rank, world_size, store=dist.FileStore(store_path, world_size),
                         backend=backend)
        # pickled here, by value: the queue's own pickler would send a tensor's
        # storage as a file descriptor, which the parent can only fetch while
        # this process is still alive
        results.put((rank, True, pickle.dumps(fn(rank, world_size, *args))))
    except BaseException:  # report every failure to the parent, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world_size: int, *args, backend: Optional[str] = None,
                timeout: float = 600.0) -> List[Any]:
    """Run `fn(rank, world_size, *args)` in `world_size` processes started
    with the `spawn` method, each joined to one process group (`backend` as
    `init_distributed` chooses it; a FileStore rendezvous in a temporary
    directory). Returns the ranks' results in rank order; they travel
    pickled by value (tensors included), so a rank may exit as soon as it
    has returned.

    Raises RuntimeError, after stopping every rank, when a rank raises,
    exits non-zero, or has not finished `timeout` seconds after the start.
    `fn` must be importable by name (a module-level function)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, store, backend, results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got, failure = {}, None
        try:
            while len(got) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        failure = f"rank exited with code {dead[0].exitcode}"
                    elif time.monotonic() > deadline:
                        failure = f"ranks did not finish within {timeout} s"
                    continue
                if ok:
                    got[rank] = pickle.loads(value)
                else:
                    failure = f"rank {rank} failed:\n{value}"
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()) if failure is None else 1.0)
                if failure is None and p.exitcode != 0:
                    failure = f"rank exited with code {p.exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}): {failure}")
    return [got[r] for r in range(world_size)]
