"""On the card: each cell of BENCHMARK.json runs end to end through
run.py, short, and comes out correct with its metrics.  Run there with

    python3 -m pytest portbench/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def cells():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_run_on_the_card(card, trace):
    for cell in cells():
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483777",
             "--seconds", "3", "--trace", str(trace)],
            cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
        assert out["metrics"], out
