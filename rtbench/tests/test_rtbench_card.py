"""On the card: one short run of every cell through the command the driver
runs, correct, with the keys the driver reads (``-m cuda``; skips without a
card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from rtbench.tests.conftest import REPO, SEED

with open(f"{REPO}/BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                          cell, "--seed", str(SEED), "--seconds", "1",
                          "--trace", str(trace)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "breakdown" in res
