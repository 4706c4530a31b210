"""On the card: one short run of each cell through ``run.py``, in a process
of its own, prints a correct result line. Marked ``cuda``; skips without a
card (decided in the fixture, not at import)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness.bench import ROOT, benchmark


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_a_short_run_is_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
