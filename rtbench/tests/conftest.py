"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files at sizes the CPU renders in seconds."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# each configuration at a size a CPU test can hold; widths and depths of
# the scene are kept, the frame is cut
TINY = {"cornell_1024": {"render": {"width": 16, "height": 16}},
        "dense_8192": {"render": {"width": 8, "height": 8},
                       "scene": {"n_tri": 300}}}
SEED = 2**31 + 977


def make_root(path) -> str:
    """A checkout-shaped directory: ``BENCHMARK.json`` and the benchmark's
    data files, with every configuration cut to its ``TINY`` size and every
    cell that has limits in the manifest (the cells kept out of the
    benchmark's manifest too, so that their files stay tested)."""
    root = str(path)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    have = {w["name"] for w in manifest["workloads"]}
    for name in cells():
        if name not in have:
            config, traffic = name.split(".")
            manifest["workloads"].append(
                {"name": name, "config": config, "traffic": traffic,
                 "chips": 1, "why": "kept out of the manifest"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    shutil.copytree(os.path.join(REPO, "rtbench"),
                    os.path.join(root, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        p = os.path.join(root, "rtbench", "configs", f"{name}.json")
        with open(p) as f:
            cfg = json.load(f)
        for key, sub in cut.items():
            cfg[key].update(sub)
        with open(p, "w") as f:
            json.dump(cfg, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def cells():
    """Every cell with a limits file: those of the manifest and those kept
    out of it until their rates hold (``PERF.md``)."""
    return sorted(f[:-5] for f in os.listdir(
        os.path.join(REPO, "rtbench", "limits")) if f.endswith(".json"))
