"""Repeat the data-parallel train step of the mesh paths on one card, to
catch a fault that shows only now and then (an illegal memory access, a
non-finite loss, ranks that disagree).

Two ranks are spawned (gloo with both on cuda:0 when there is one GPU, as
`chip_smoke.py`'s mesh paths run them; NCCL with a GPU each otherwise).
Each run builds a fresh `PhenakiTrainer(mesh=make_mesh(dp=2))` and takes
`--steps` steps (the first is the milestone: a sample and a checkpoint),
synchronising the card after each, so that a fault is raised at the step
that made it. `--flagship` runs the flagship (f32 parameters, bf16 compute)
at a global batch of 8, as the mesh paths' "dp train" does; the default is
a small fp32 model. Run it under `CUDA_LAUNCH_BLOCKING=1` to make every
launch synchronous, or under `compute-sanitizer --tool memcheck` where that
works.

Run:  python examples/mesh_dp_probe.py [--runs 5] [--steps 2] [--flagship]
The last line is a JSON summary; the exit code is 0 when no run failed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _small_phenaki(torch):
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(5)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, 1, dim_head=64, heads=2), gen)
    mg = init_parameters(MaskGit(128, 512, 128, depth=2, heads=2, dim_head=64, dim_context=64), gen)
    return Phenaki(maskgit=mg.cuda(), cvivit=cv.cuda(), text_embed_dim=64, steps=6, max_text_len=16)


def _data(torch, flagship):
    gen = torch.Generator().manual_seed(21)
    if flagship:
        return torch.utils.data.TensorDataset(torch.randint(0, 65536, (16, 9, 16, 8), generator=gen),
                                              torch.randn(16, 50, 768, generator=gen))
    return torch.utils.data.TensorDataset(torch.randint(0, 512, (16, 2, 8, 8), generator=gen),
                                          torch.randn(16, 8, 64, generator=gen))


def probe_rank(rank, world, runs, steps, flagship):
    import torch
    import torch.distributed as dist

    from phenaki_tpu_torch.parallel.mesh import make_mesh
    from phenaki_tpu_torch.presets import flagship_train_phenaki
    from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

    if dist.get_backend() != "nccl":
        torch.cuda.set_device(0)  # every gloo rank computes on the one card
    torch.set_num_threads(2)
    dp = make_mesh(dp=world)
    data = _data(torch, flagship)
    out = []
    for run in range(runs):
        ph = flagship_train_phenaki(seed=0, device="cuda") if flagship else _small_phenaki(torch)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = PhenakiTrainer(ph, dataset=data, batch_size=8, seed=run, log_every=10**9, num_samples=1,
                                     num_frames=17 if flagship else 3, sample_texts=["a red ball"],
                                     results_folder=tmp, mesh=dp)
            losses, seconds = [], []
            for _ in range(steps):
                t = time.perf_counter()
                losses.append(trainer.train_step().item())
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
            if not all(map(math.isfinite, losses)):
                raise RuntimeError(f"run {run}: non-finite loss {losses}")
            out.append(dict(run=run, losses=losses, step_seconds=seconds))
            del trainer
        del ph
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--flagship", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from phenaki_tpu_torch import _build
    from phenaki_tpu_torch.parallel.distributed import default_backend, spawn_ranks

    if not torch.cuda.is_available():
        print("mesh_dp_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    _build.load_library()
    backend = default_backend(2)
    t = time.perf_counter()
    try:
        results = spawn_ranks(probe_rank, 2, args.runs, args.steps, args.flagship, backend=backend, timeout=1200)
    except RuntimeError as exc:
        print(json.dumps({"ok": False, "backend": backend, "flagship": args.flagship, "error": str(exc)[-2000:]}))
        return 1
    same = all(a["losses"] == b["losses"] for a, b in zip(*results))
    print(json.dumps({"ok": same, "backend": backend, "flagship": args.flagship, "runs": args.runs,
                      "steps": args.steps, "losses_equal_across_ranks": same, "wall_s": time.perf_counter() - t,
                      "ranks": results}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
