"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by the name the manifest gives:

- ``configs/<config>.json``: the scene recipe (``scenes/<recipe>.py``), the
  render parameters, the source and the cuts;
- ``traffic/<mix>.json``: the mix's parameters, read by the loop it names
  (``loops/<loop>.py``: set-up, one call, the window, the check);
- ``metrics/<metric>.py``: a reader, ``read(run)``, that returns the
  metric's value or None where the run holds nothing to read;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares.

A run: set-up (the port imported, the card's context, the kernels' library
from ``build/``, the inputs from the seed, warm-up through the window's own
call), then ``--seconds`` of the window, then (with ``--trace 1``) a traced
window, the host's waits and the host spans, then the comparison with the
plain reference once the program's state is freed. The last line of
standard output is the result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import scenes
from .reference import render as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HERE_REL = os.path.relpath(HERE, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "uob_raytracer_tpu")


class Run:
    """What one run knows: the cell, its files, the state of its loop and
    what the window and the trace measured. Metric readers read it."""

    def __init__(self, root, workload, seed, seconds, trace, device):
        self.root, self.seed, self.seconds = root, seed, seconds
        self.trace, self.device = trace, device
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.config = _json(root, "configs", self.cell["config"])
        self.mix = _json(root, "traffic", self.cell["traffic"])
        self.limits = _json(root, "limits", workload)
        self.loop = importlib.import_module(
            f"{__package__}.loops.{self.mix['loop']}")
        self.params = ref.Params(**self.config["render"])
        self.setup_s = None
        self.window = {}       # what the loop's window measured
        self.traced = None     # trace.traced_window's summary
        self.spans = {}        # host spans and counts read after the window
        self.stats = None      # the reference's ray statistics
        self.peak = None       # the card's data-sheet peaks

    @property
    def name(self) -> str:
        return self.cell["name"]

    def leaves(self) -> dict:
        """The configuration's scene from the seed, on the run's device."""
        host = scenes.build(self.config["scene"], self.seed)
        return {k: torch.from_numpy(np.array(host[k], np.float32))
                .to(self.device) for k in scenes.LEAVES}

    def generator(self, stream: int) -> torch.Generator:
        """A torch generator on the run's device, seeded from the seed and a
        stream number."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + stream) % (2**63))
        return g

    def rng(self, stream: int) -> np.random.Generator:
        """A numpy generator seeded from the seed and a stream number."""
        return np.random.default_rng([self.seed % 2**63, stream])

    def metrics(self, kind: str) -> dict:
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"):
        those whose ``workloads`` name it, or that name none."""
        out = {}
        for m in self.manifest[kind]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            value = _reader(self.root, m["name"]).read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def _json(root, kind, name):
    with open(os.path.join(root, HERE_REL, kind, f"{name}.json")) as f:
        return json.load(f)


def _reader(root, name):
    path = os.path.join(root, HERE_REL, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is one the
    benchmark may not load, compared whole: the port's name begins with the
    JAX package's."""
    return sorted(m for m in list(sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_power_limit() -> str | None:
    """nvidia-smi's power limit of the card in use, or None."""
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={card}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(run: Run, t_start: float) -> dict:
    """Set up, measure and check one run; returns the result line."""
    dev = run.device
    on_card = dev.type == "cuda"
    state = run.loop.setup(run)
    synchronize(dev)
    run.setup_s = time.perf_counter() - t_start
    run.window = run.loop.window(state, run.seconds)
    mem_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if run.trace:
        run.loop.layer_spans(state, run)
        if on_card:
            from . import trace, work
            run.spans["host_waits"] = trace.host_waits(
                lambda: run.loop.call(state))
            run.traced = trace.traced_window(
                lambda: run.loop.call(state),
                float(run.mix["trace_seconds"]))
            run.peak = work.peaks(torch.cuda.get_device_name(dev))
        run.stats = run.loop.ray_stats(state, run)
    readings = run.loop.check(state, run)   # frees the program's state
    del state
    gc.collect()
    checks, correct = {}, True
    for name, value in readings.items():
        limit = run.limits.get(name)
        ok = limit is not None and np.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": float(value), "limit": limit}
    for name in run.limits:
        if name not in readings:
            correct = False
            checks[name] = {"value": None, "limit": run.limits[name]}
    kind = "per_layer" if run.trace else "end_to_end"
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(mem_peak)}
    if run.trace and run.traced is not None:
        device["busy_s"] = run.traced["busy_s"]
        device["window_s"] = run.traced["window_s"]
    if on_card:
        device["power_limit"] = card_power_limit()
    result = {"correct": bool(correct),
              "attempted": int(run.window["calls"]), "failed": 0,
              "metrics": run.metrics(kind), "device": device}
    if run.trace and run.traced is not None:
        result["breakdown"] = run.traced["breakdown"]
    result["checks"] = checks
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="rtbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    run = Run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    chips = int(run.cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"rtbench: {args.workload} needs {chips} CUDA device(s); this "
              f"host has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(run, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
