"""The program's own spans and counters (``uob_raytracer_tpu_torch.tracing``)
in a traced run on the card, for the readers of the per-layer metrics that
split a step by layer.

The harness reads the per-layer metrics once the check has freed the loop's
state, so the first of these readers builds a fresh state with the loop's
own set-up (the same seed, so the same scene, target and warm-up) and runs
three passes on it:

- the span pass: ``PASS_STEPS`` calls with program tracing on, each begun
  after a ``synchronize()``, so the queue is empty and a span times the
  host's own work, not a block on a full launch queue;
- the waits pass: ``PASS_STEPS`` calls back to back with
  ``tracing.enable(waits=True)``: the host's waits on the card by the span
  they happened in and the file:line that waited;
- a profiled window of its own (program tracing off): the spans are then
  ``user_annotation`` events on the device trace's clock, and
  ``idle_by_span`` puts each idle stretch of the card down to the innermost
  program span open on the host. It is not ``device_idle.*``'s window, so
  no metric reads it: it goes to standard error only.

The reduced tables go to ``run.spans["program"]`` for the readers, and to
standard error as one line. Off the card, in an untraced run, or where the
program has no ``tracing`` module (the commits before it), this stores an
empty table and the readers stay silent.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
import time

import torch

from . import trace

PASS_STEPS = 50
PREFIX = "rt."            # the program's span names
OUTSIDE = "outside"       # idle under no program span


def tracing_module(run):
    """The program's tracing module where this run can use it, else None."""
    if not run.trace or run.device.type != "cuda":
        return None
    try:
        return importlib.import_module("uob_raytracer_tpu_torch.tracing")
    except ImportError:
        return None


def tables(run) -> dict:
    """The passes' reduced tables, run once a run (empty where there is
    nothing to run them with)."""
    if "program" not in run.spans:
        tracing = tracing_module(run)
        run.spans["program"] = {} if tracing is None else _passes(run, tracing)
    return run.spans["program"]


def _passes(run, tracing) -> dict:
    st = run.loop.setup(run)
    tracing.enable()
    try:
        for _ in range(PASS_STEPS):
            torch.cuda.synchronize()
            run.loop.call(st)
        torch.cuda.synchronize()
        spans = tracing.drain()
    finally:
        tracing.disable()
    tracing.enable(waits=True)
    try:
        for _ in range(PASS_STEPS):
            run.loop.call(st)
        waits = tracing.drain()     # before the synchronise, itself a wait
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    events, calls = _window_events(lambda: run.loop.call(st),
                                   float(run.mix["trace_seconds"]))
    del st
    summary = trace.summarize(events, calls)
    out = {
        "steps": PASS_STEPS,
        "spans": tracing.by_name(spans["spans"]),
        "counts": spans["counts"],
        "orphans": orphans(spans["spans"]),
        "waits": {k: v for k, v in waits["counts"].items()
                  if k.startswith("waits.")},
        "wait_sites": waits["wait_sites"],
    }
    window = {"window_s": summary["window_s"], "busy_s": summary["busy_s"],
              "calls": calls, "idle_by_span": idle_by_span(events)}
    print("rtbench: program spans " + json.dumps(dict(out, window=window)),
          file=sys.stderr)
    return out


def _window_events(call, seconds: float, min_calls: int = 3):
    """The chrome trace's events of ``call`` run back to back for
    ``seconds`` under torch.profiler, as ``trace.traced_window`` runs it,
    and the number of calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            n, t0 = 0, time.perf_counter()
            while n < min_calls or time.perf_counter() - t0 < seconds:
                call()
                n += 1
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], n
    finally:
        os.unlink(path)


def orphans(records) -> int:
    """Backward spans (``rt.bwd*``) with no ``rt.train_step`` among their
    ancestors: the autograd engine's device thread would give them none if
    parents were kept a thread."""
    by_id = {r.id: r for r in records}
    n = 0
    for r in records:
        if not r.name.startswith("rt.bwd"):
            continue
        p = by_id.get(r.parent)
        while p is not None and p.name != "rt.train_step":
            p = by_id.get(p.parent)
        n += p is None
    return n


def idle_stretches(events: list) -> list:
    """The stretches (us) of the trace's window in which no kernel, copy or
    set ran on the card, as ``trace.summarize`` finds the busy time."""
    win = next(e for e in events if e.get("name") == trace.WINDOW
               and e.get("cat") == "user_annotation")
    ws = float(win["ts"])
    we = ws + float(win["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events
           if e.get("cat") in trace.DEVICE_CATS and e.get("ph") == "X"]
    busy = trace._merge((max(s, ws), min(e, we)) for s, e in dev
                        if min(e, we) > max(s, ws))
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(events: list) -> dict:
    """Every idle stretch of the card in the trace's window, each part of it
    put down to the innermost program span (``rt.*`` ``user_annotation``,
    any thread) open on the host then, or to ``outside``: seconds by span
    name. The parts sum to the window's idle time."""
    idle = idle_stretches(events)
    # the span boundaries and the idle stretches swept in time order; the
    # innermost open span is the one that opened last
    points = []
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e.get("name", "").startswith(PREFIX)):
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            points.append((s, 1, s, e["name"]))
            points.append((s + d, 0, s, e["name"]))
    points.sort()
    out: dict = {}
    active: dict = {}       # (start, name) -> how many open
    j = 0
    for s, e in idle:
        t = s
        while t < e:
            while j < len(points) and points[j][0] <= t:
                _, opens, start, name = points[j]
                key = (start, name)
                active[key] = active.get(key, 0) + (1 if opens else -1)
                if not active[key]:
                    del active[key]
                j += 1
            nxt = min(e, points[j][0]) if j < len(points) else e
            name = max(active)[1] if active else OUTSIDE
            out[name] = out.get(name, 0.0) + (nxt - t) * 1e-6
            t = nxt
    return out
