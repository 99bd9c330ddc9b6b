"""The harness finds every configuration, mix, metric and limit by name, a
new mix runs without an edit to any file there, and a run's last line has
the keys the driver reads."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from rtbench import harness
from rtbench.tests.conftest import REPO, SEED, cells

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def _run(root, cell, trace=False, seconds=0.3):
    run = harness.Run(root, cell, SEED, seconds, trace, torch.device("cpu"))
    return run, harness.run_cell(run, 0.0)


def test_every_name_resolves_to_a_file():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    here = os.path.join(REPO, "rtbench")
    for c in b["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
    assert {w["name"] for w in b["workloads"]} <= set(cells())
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(here, "limits",
                                           f"{w['name']}.json"))
        with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
            loop = json.load(f)["loop"]
        assert os.path.exists(os.path.join(here, "loops", f"{loop}.py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           f"{m['name']}.py"))


@pytest.mark.parametrize("cell", cells())
def test_cell_runs_and_reports(tiny_root, cell):
    run, res = _run(tiny_root, cell)
    assert list(res) == RESULT_KEYS
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in run.manifest["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    assert set(res["checks"]) == set(run.limits)


def test_trace_run_reports_per_layer_metrics(tiny_root):
    run, res = _run(tiny_root, "dense_8192.fit", trace=True)
    # without a card the device readers find nothing and stay silent
    assert set(res["metrics"]) == {"step_enqueue_ms.fit"}
    assert list(res)[-1] == "checks"
    assert run.stats[0] == 8 * 8 * 4 and run.stats[2] > 0


@pytest.mark.parametrize("name", ["tick_host_ms.view", "fetch_ms.view",
                                  "frame_p95_ms.host", "frames_per_s"])
def test_view_readers_read_the_live_window(tiny_root, name):
    """The viewer's readers, kept for the cell kept out of the manifest."""
    run, _ = _run(tiny_root, "cornell_1024.view")
    assert harness._reader(tiny_root, name).read(run) > 0


def test_a_new_mix_runs_without_editing_a_file(tiny_root):
    """A later PR adds a mix and a cell: new files and a new entry only."""
    here = os.path.join(tiny_root, "rtbench")
    before = {}
    for d, _, files in os.walk(here):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    with open(os.path.join(here, "traffic", "fit.json")) as f:
        mix = json.load(f)
    mix.update(lr=0.005, trainable=["tri_rgb", "light_pos"],
               perturb={"light_pos_sigma": 0.1, "rgb_rel": 0.2})
    with open(os.path.join(here, "traffic", "fit_light.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(here, "limits", "cornell_1024.fit_light.json"),
              "w") as f:
        json.dump({"first_loss_gap": 1.0, "grad_gap": 1.0,
                   "median_change_gap": 1.0}, f)
    bpath = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bpath) as f:
        b = json.load(f)
    b["workloads"].append({"name": "cornell_1024.fit_light",
                           "config": "cornell_1024", "traffic": "fit_light",
                           "chips": 1, "why": "a test"})
    fits = {w["name"] for w in b["workloads"] if w["traffic"] == "fit"}
    for m in b["end_to_end"] + b["per_layer"]:
        if fits & set(m.get("workloads", [])):
            m["workloads"].append("cornell_1024.fit_light")
    with open(bpath, "w") as f:
        json.dump(b, f)
    run, res = _run(tiny_root, "cornell_1024.fit_light")
    assert res["correct"] is True
    assert run.params.width == 16 and run.mix["lr"] == 0.005
    assert set(res["metrics"]) == {"steps_per_s", "setup_s"}
    for p, data in before.items():
        with open(p, "rb") as fh:
            assert fh.read() == data, p


def _first_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)["workloads"][0]["name"]


def test_cli_refuses_a_host_without_the_card():
    out = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                          _first_cell(), "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_cli_fails_without_the_program(tmp_path):
    """In a directory holding only the benchmark, a run fails."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "rtbench"), tmp_path / "rtbench")
    code = ("import sys, torch; sys.path.insert(0, '.'); "
            "from rtbench import harness; "
            f"r = harness.Run('.', '{_first_cell()}', 1, 0.1, False, "
            "torch.device('cpu')); harness.run_cell(r, 0.0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "uob_raytracer_tpu_torch" in out.stderr
