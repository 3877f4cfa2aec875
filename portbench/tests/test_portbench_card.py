"""One short run of each cell on the card, end to end through `run.py`:
`python -m pytest portbench/tests -q -m card` on a machine with an H100."""

import json
import subprocess
import sys

import pytest

from portbench.common import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card only")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483901",
                           "--seconds", "5", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
