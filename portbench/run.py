"""The benchmark of phenaki_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device` (with `--trace 1` also
`busy_s` and `window_s`), with `--trace 1` `breakdown`, with `--control 1`
`control` (each control's numbers held to the same limits, and its own
`correct`), and last `checks`, each number the comparison held to its limit. Those numbers are also the
last lines on standard error. Without the chips, or in a directory without
the port, or if JAX or the JAX package was loaded, it exits non-zero and
prints no result.

Everything is found by name from `BENCHMARK.json`:

* a cell (`workloads[]`) names its configuration and its traffic mix;
* `configs/<config>.json` holds the model's widths (`file` in the
  configuration's entry), its source, what was reduced and assumed, and the
  precision it is served and trained in; `reference/` holds its plain
  float32 reference;
* `traffic/<traffic>.json` holds the driver it runs (`sample`, `train` or
  `serve`), batch, lengths, rate, the calls a traced run profiles, the
  calls the comparison keeps, the limits of the comparison, and its why;
* `drivers/<driver>.py` runs the entry of one kind;
* `metrics/<metric>.py` reads one per-layer metric (`read(ctx)`: the number,
  or None where the run has nothing to read) from the trace and the
  driver's counts, with the kernel names it times and its FLOP and byte
  counts from `flops.py`.

To add a configuration, a traffic mix or a metric, add its file and its
entry in BENCHMARK.json; no existing file changes. `README.md` says more.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# libraries the port may use load no JAX, and nothing is fetched
for key, value in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"), ("HF_HUB_OFFLINE", "1"),
                   ("TRANSFORMERS_OFFLINE", "1")):
    os.environ.setdefault(key, value)
# every build and kernel cache of the program stays inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "portbench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "portbench_cache", "torch_extensions"))


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def cell_spec(workload: str, seed: int, seconds: float, trace: bool, control: bool = False):
    """The run's Spec, every part of the cell read from its files."""
    from portbench.common import BENCH, ROOT as CHECKOUT, Spec, load_json

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(CHECKOUT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    reports = {m["name"] for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
    traffic["_per_layer"] = [m for m in bench["per_layer"]
                             if workload in m.get("workloads", [workload] if m["moves"] in reports else [])]
    return Spec(workload=workload, config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                chips=cell["chips"], control=control, t_start=T_START)


def result_line(out, controls=None) -> str:
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": out.metrics, "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    if controls:
        line["control"] = {name: {"correct": all(c.ok for c in held),
                                  "checks": {c.name: {"value": c.value, "limit": c.limit} for c in held}}
                           for name, held in controls.items()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return json.dumps(line)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control's numbers (for setting limits)")
    args = ap.parse_args(argv)

    from portbench.common import ROOT as CHECKOUT, forbidden_loaded

    try:
        import phenaki_tpu_torch
    except ImportError as e:
        fail(f"the port is not in this checkout ({e})")
    if not os.path.abspath(phenaki_tpu_torch.__file__).startswith(str(CHECKOUT) + os.sep):
        fail(f"phenaki_tpu_torch comes from {phenaki_tpu_torch.__file__}, not from this checkout")

    spec = cell_spec(args.workload, args.seed, args.seconds, bool(args.trace), bool(args.control))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        fail(f"the cell needs {spec.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)

    driver = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    out = driver.run(spec)

    found = forbidden_loaded()
    if found:
        fail(f"JAX or the JAX package was loaded: {', '.join(found)}", 4)
    controls = control_verdicts(out, spec.traffic["limits"])
    print(json.dumps({"notes": out.notes, "launches": launch_counts()}), flush=True)
    for name, held in controls.items():
        for c in held:
            print(f"control {name} check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
                  file=sys.stderr)
        print(f"control {name} correct: {all(c.ok for c in held)}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out, controls), flush=True)


def control_verdicts(out, limits) -> dict:
    """With `--control 1`: each control's (or planted fault's) numbers held
    to the cell's own limits, as the program's are; each is expected to
    come out not correct. {name: [Check]}."""
    from portbench.drivers.common import limits_checks

    held = {name: limits_checks(numbers, limits) for name, numbers in out.notes.get("control", {}).items()}
    return {name: checks for name, checks in held.items() if checks}


def launch_counts() -> dict:
    """The port's kernel launch counters (`fn.launches`), a record of what
    ran; not a metric."""
    import phenaki_tpu_torch.ops.flash_attention as fa
    import phenaki_tpu_torch.ops.fused_ce as ce
    import phenaki_tpu_torch.ops.fused_sampling as fs

    fns = {"flash_fwd": fa.flash_attention, "flash_chunk": fa.flash_attend_chunk,
           "flash_dq": fa.flash_attention_bwd_dq, "flash_dkv": fa.flash_attention_bwd_dkv,
           "flash_dbias": fa.flash_attention_bwd_dbias, "ce_fwd": ce.fused_ce_fwd,
           "ce_dh": ce.fused_ce_bwd_dh, "ce_dw": ce.fused_ce_bwd_dw, "proj_sample": fs.project_sample,
           "gumbel_sample": fs.gumbel_sample_with_score}
    return {k: getattr(f, "launches", None) for k, f in fns.items()}


if __name__ == "__main__":
    main()
