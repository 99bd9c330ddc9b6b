"""The readers of the program's own spans (``program_spans``): the idle split
by span on a synthetic trace, each reader on synthetic tables and silent
without them, the passes' plumbing at CPU size, and a run whose program has
no tracing module reporting the metric set it reported before."""
from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from rtbench import harness, program_spans
from rtbench.tests.conftest import SEED

READERS = ("step_host_ms.fit", "fwd_wrap_ms.fit", "bwd_wrap_ms.fit",
           "program_waits.fit")


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


# a 100 us window: the card busy over [10, 20] and [50, 60]; the step on
# thread 1, its backward on thread 2 (the autograd engine's device thread)
EVENTS = [
    _x("rtbench.window", 0.0, 100.0),
    _x("kern_a", 10.0, 10.0, cat="kernel", tid=7),
    _x("Memcpy HtoD", 50.0, 10.0, cat="gpu_memcpy", tid=7),
    _x("kern_b", 95.0, 20.0, cat="kernel", tid=7),      # past the window
    _x("rt.train_step", 0.0, 90.0),
    _x("rt.bwd", 25.0, 30.0, tid=2),
    _x("rt.bwd.launch", 30.0, 5.0, tid=2),
    _x("aten::mul", 36.0, 2.0, cat="cpu_op", tid=2),    # not a span
    _x("other", 40.0, 5.0),                            # not the program's
    _x("rt.bwd", 25.0, 30.0, cat="gpu_user_annotation", tid=7),
]


def test_idle_by_span_splits_every_idle_stretch():
    got = program_spans.idle_by_span(EVENTS)
    want = {"rt.train_step": 10 + 5 + 30, "rt.bwd": 5 + 15,
            "rt.bwd.launch": 5, "outside": 5}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    # the parts sum to the window's idle time: 100 us less 10 + 10 + 5 busy
    assert sum(got.values()) == pytest.approx(75e-6, abs=1e-12)


def _run(tables, loop="sgd"):
    return types.SimpleNamespace(mix={"loop": loop}, trace=True,
                                 device=torch.device("cpu"),
                                 spans={"program": tables})


TABLES = {
    "steps": 4,
    "spans": {"rt.train_step": {"n": 4, "total_ms": 12.0, "self_ms": 2.0},
              "rt.fwd.pack": {"n": 4, "total_ms": 1.0, "self_ms": 1.0},
              "rt.fwd.launch": {"n": 4, "total_ms": 2.0, "self_ms": 2.0},
              "rt.bwd": {"n": 4, "total_ms": 6.0, "self_ms": 1.0},
              "rt.bwd.launch": {"n": 4, "total_ms": 3.0, "self_ms": 3.0}},
    "waits": {"waits.rt.bwd.segment_sum": 2, "waits.rt.train_step": 1},
}
WANT = {"step_host_ms.fit": 3.0, "fwd_wrap_ms.fit": 0.75,
        "bwd_wrap_ms.fit": 1.5, "program_waits.fit": 0.75}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_tables_and_is_silent_without(tiny_root, name):
    reader = harness._reader(tiny_root, name)
    assert reader.read(_run(TABLES)) == pytest.approx(WANT[name])
    assert reader.read(_run({})) is None
    assert reader.read(_run(TABLES, loop="live")) is None


def test_no_tracing_module_means_no_passes(monkeypatch):
    """Where the program has no tracing module, as before it had one, a
    traced run on the card runs nothing and stores an empty table."""
    monkeypatch.setitem(sys.modules, "uob_raytracer_tpu_torch.tracing", None)

    def refuse(run):
        raise AssertionError("the passes ran without a tracing module")
    run = types.SimpleNamespace(trace=True, device=torch.device("cuda"),
                                spans={}, loop=types.SimpleNamespace(
                                    setup=refuse))
    assert program_spans.tracing_module(run) is None
    assert program_spans.tables(run) == {}
    assert run.spans == {"program": {}}


def test_a_run_without_the_tracing_module_reports_the_old_set(
        tiny_root, monkeypatch):
    # the program's modules loaded first: only the readers' import fails
    import uob_raytracer_tpu_torch.parallel.train  # noqa: F401
    monkeypatch.setitem(sys.modules, "uob_raytracer_tpu_torch.tracing", None)
    run = harness.Run(tiny_root, "dense_8192.fit", SEED, 0.3, True,
                      torch.device("cpu"))
    res = harness.run_cell(run, 0.0)
    assert set(res["metrics"]) == {"step_enqueue_ms.fit"}
    assert run.spans["program"] == {}


def test_the_passes_at_cpu_size(tiny_root, monkeypatch, capsys):
    """The passes' plumbing on the CPU (the plain versions; the profiled
    window and the card's synchronise stood in for): the tables every reader
    reads, with the program's real spans, and the window's idle split on
    standard error alone."""
    from uob_raytracer_tpu_torch import tracing
    monkeypatch.setattr(program_spans, "PASS_STEPS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(program_spans, "_window_events",
                        lambda call, s: (EVENTS, 1))
    run = harness.Run(tiny_root, "dense_8192.fit", SEED, 0.3, True,
                      torch.device("cpu"))
    t = program_spans._passes(run, tracing)
    assert t["steps"] == 2 and t["orphans"] == 0
    assert t["spans"]["rt.train_step"]["n"] == 2
    assert {"rt.render", "rt.fwd.launch", "rt.bwd", "rt.bwd.pull_back"} <= (
        set(t["spans"]))
    assert t["waits"] == {} and t["wait_sites"] == []
    assert "idle_by_span" not in t and "window" not in t
    assert tracing.span("rt.x") is tracing.span("rt.y")     # off again
    line = [x for x in capsys.readouterr().err.splitlines()
            if x.startswith("rtbench: program spans ")][-1]
    window = json.loads(line.split(" ", 3)[3])["window"]
    assert window["window_s"] == pytest.approx(100e-6)
    assert sum(window["idle_by_span"].values()) == pytest.approx(
        window["window_s"] - window["busy_s"], abs=1e-12)
    run.spans["program"] = t
    for name in READERS:
        assert harness._reader(tiny_root, name).read(run) >= 0, name
