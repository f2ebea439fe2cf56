"""On the card: each cell served by the node's W8A8 encoder (K4,
`--control`) must come out not correct, on its own seed, at the cell's
own size with a 10 s window. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "10",
                        "--trace", "0", "--control"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out["checks"]
