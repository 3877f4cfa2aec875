"""BENCHMARK.json against the contract it is written to, the files it
names, and the result line's schema."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.common import BENCH, ROOT, Check, Outcome, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys_and_paths():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells = len(BENCHMARK["workloads"])
    # a full check of 24 cells fits its 12 hours
    assert (2 + 14 * 24) * (BENCHMARK["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_entries():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCHMARK[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]


def test_every_cell_reports_what_it_must_and_finds_its_files():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    for w in BENCHMARK["workloads"]:
        reports = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reports and len(reports) >= 2
        layer = [m for m in BENCHMARK["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in reports for m in layer)
        assert (ROOT / configs[w["config"]]["file"]).exists()
        traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists() and traffic["limits"]
    for m in BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == set(configs)


def test_the_result_line_schema():
    from portbench import run

    out = Outcome(attempted=3, failed=0, metrics={"frames_per_s": {"value": 1.5, "unit": "frames/s"}},
                  checks=[Check("pick_gap", 0.1, 0.5)], device={"platform": "gpu", "kind": "x", "count": 1,
                                                               "memory_peak_bytes": 5},
                  breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.01]]})
    line = json.loads(run.result_line(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["correct"] is True and line["checks"] == {"pick_gap": {"value": 0.1, "limit": 0.5}}
    out.checks.append(Check("frame_err", float("nan"), 1.0))
    assert json.loads(run.result_line(out))["correct"] is False


def test_no_card_no_result():
    """Without a CUDA device (this CPU) the command exits non-zero and
    prints nothing on standard output."""
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "sample-b64", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_port_no_result(tmp_path: Path):
    """In a directory holding only BENCHMARK.json and portbench/, it exits
    non-zero and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sample-b64", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout == ""
