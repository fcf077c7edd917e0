"""On the card: each cell's command runs end to end with a short window
and prints a correct result line (``gpu``: skips without a CUDA
device)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 17), "--seconds", "3", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "compared"
