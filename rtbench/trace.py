"""Reading the card's trace: torch.profiler over a traced window, reduced to
device busy time, per-kernel device time, the longest idle stretches by
what the host was doing, and the host's waits on the card.

The profiler method (CUPTI through ``torch.profiler``, every device
activity counted) follows the port's ``bench.py:kernels_ms``; the busy time
is the union of all device intervals (kernels, copies, sets) inside the
window, not a sum of named kernels, so torch's own small kernels count as
busy. The wait count is the port's ``bench.py:host_syncs`` method.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
import warnings

import torch

WINDOW = "rtbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list (the first parenthesis outside template brackets)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            return name[:i]
    return name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """The shortest host event that covers time ``t`` (its name), looking
    back over at most 500 events that start before it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 501), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "no host operation"


def summarize(events: list, calls: int) -> dict:
    """Reduce a chrome trace's events to the window's numbers."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    ws = float(win[0]["ts"])
    we = ws + float(win[0]["dur"])
    dev, per_kernel = [], {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            s0, e0 = max(s, ws), min(s + d, we)
            if e0 <= s0:
                continue
            dev.append((s0, e0))
            k = short_name(e.get("name", "?"))
            per_kernel[k] = per_kernel.get(k, 0.0) + (e0 - s0)
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e.get("name", "?")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by_host: dict = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
        name = _innermost(host, starts, 0.5 * (s + e))
        by_host[name] = by_host.get(name, 0.0) + (e - s)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "calls": calls,
        "window_s": (we - ws) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": {k: v * 1e-6 for k, v in per_kernel.items()},
        "breakdown": {"device_ops": [[k, v * 1e-6] for k, v in top],
                      "idle_gaps": [[k, v * 1e-6] for k, v in idle]},
    }


def traced_window(call, seconds: float, min_calls: int = 3) -> dict:
    """Run ``call`` back to back for ``seconds`` (at least ``min_calls``
    times) under torch.profiler, the window closed by a synchronise, and
    summarize the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
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
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, n)


def kernel_seconds(summary: dict, patterns) -> float:
    """Device seconds of the kernels whose names hold any of ``patterns``."""
    return sum(v for k, v in summary["kernel_s"].items()
               if any(p in k for p in patterns))


def host_waits(call, calls: int = 5) -> float:
    """Host waits on the card per call, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    call()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught) / calls
