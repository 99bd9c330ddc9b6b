"""Port tests: ``uob_raytracer_tpu_torch.tracing``, the spans and counters at
the port's layer boundaries. Off, a span is a shared null context that
calls nothing in torch; on, it records its parent, step and times (across
the autograd engine's device thread too); under a ``torch.profiler`` it is a
``user_annotation`` event; with ``waits=True`` the sync-debug warnings count
under the innermost open span. No JAX: the card test runs on the chip."""
import json
import sys
import threading
import warnings

import pytest
import torch

import uob_raytracer_tpu_torch as rt
from uob_raytracer_tpu_torch import tracing
from uob_raytracer_tpu_torch.config import RenderConfig
from uob_raytracer_tpu_torch.kernels import _build, render_bwd, render_fwd
from uob_raytracer_tpu_torch.parallel.train import train_step
from uob_raytracer_tpu_torch.preview import LiveLoop

CFG = RenderConfig(width=16, height=16, shadow_samples=2, bounces=1)


@pytest.fixture(autouse=True)
def off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def tree(spans):
    """Each span as (name, parent's name, step)."""
    by_id = {r.id: r for r in spans}
    return [(r.name, by_id[r.parent].name if r.parent else None, r.step)
            for r in spans]


def refuse_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_is_the_shared_null_context(monkeypatch):
    refuse_record_function(monkeypatch)
    assert tracing.span("rt.a") is tracing.span("rt.b", step=True)
    calls = []

    def watch(frame, event, arg):
        mod = (arg.__module__ if event == "c_call" else
               frame.f_globals.get("__name__")) or ""
        if event in ("call", "c_call") and mod.startswith("torch"):
            calls.append((event, mod))
    sys.setprofile(watch)
    try:
        for _ in range(100):
            with tracing.span("rt.train_step", step=True):
                with tracing.span("rt.render"):
                    tracing.count("bwd.bands", 2)
    finally:
        sys.setprofile(None)
    assert calls == []
    out = tracing.drain()
    assert out["spans"] == [] and out["counts"] == {}


def test_on_records_parents_steps_and_self_time(monkeypatch):
    refuse_record_function(monkeypatch)     # recording alone: no profiler
    tracing.enable()
    for _ in range(2):
        with tracing.span("rt.train_step", step=True):
            with tracing.span("rt.render"):
                with tracing.span("rt.render"):     # re-entered: nothing
                    with tracing.span("rt.fwd.launch"):
                        pass
            with tracing.span("rt.bwd"):
                tracing.count("bwd.bands", 3)
    with tracing.span("rt.build"):
        pass
    out = tracing.drain()
    steps = sorted({r.step for r in out["spans"] if r.step is not None})
    assert len(steps) == 2 and steps[1] == steps[0] + 1
    got = tree(out["spans"])
    assert got == [("rt.train_step", None, steps[0]),
                   ("rt.render", "rt.train_step", steps[0]),
                   ("rt.fwd.launch", "rt.render", steps[0]),
                   ("rt.bwd", "rt.train_step", steps[0]),
                   ("rt.train_step", None, steps[1]),
                   ("rt.render", "rt.train_step", steps[1]),
                   ("rt.fwd.launch", "rt.render", steps[1]),
                   ("rt.bwd", "rt.train_step", steps[1]),
                   ("rt.build", None, None)]
    assert out["counts"] == {"bwd.bands": 6}
    for r in out["spans"]:
        assert 0 <= r.ns and r.thread == threading.get_ident()
    assert tracing.drain()["spans"] == []


def _rec(i, parent, s, e, name="x"):
    r = tracing.Span(name, False)
    r.id, r.parent, r.start_ns, r.end_ns = i, parent, s, e
    return r


def test_self_time_is_the_duration_less_the_union_of_the_children():
    recs = [_rec(1, None, 0, 100, "a"), _rec(2, 1, 10, 40, "b"),
            _rec(3, 1, 30, 60, "b"),            # overlaps the first child
            _rec(4, 1, 50, 55, "c"),            # inside the union already
            _rec(5, 1, 90, 130, "c"),           # runs past the parent
            _rec(6, 2, 15, 20, "d")]            # a grandchild
    own = tracing.self_ns(recs)
    assert own == {1: 100 - 50 - 10, 2: 25, 3: 30, 4: 5, 5: 40, 6: 5}
    names = tracing.by_name(recs)
    assert names["b"] == {"n": 2, "total_ms": pytest.approx(60e-6),
                          "self_ms": pytest.approx(55e-6)}
    assert sum(v["self_ms"] for v in names.values()) == pytest.approx(
        145e-6)


def test_parent_holds_across_the_autograd_worker_thread():
    """A span opened on another thread while the caller blocks inside
    ``rt.train_step`` (as ``torch.autograd.grad`` blocks while the device
    thread runs ``_FusedRender.backward``) nests in it."""
    tracing.enable()
    with tracing.span("rt.train_step", step=True):
        def backward():
            with tracing.span("rt.bwd"):
                with tracing.span("rt.bwd.launch"):
                    pass
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    spans = tracing.drain()["spans"]
    step = spans[0].step
    assert tree(spans) == [("rt.train_step", None, step),
                           ("rt.bwd", "rt.train_step", step),
                           ("rt.bwd.launch", "rt.bwd", step)]
    assert spans[1].thread != spans[0].thread


def test_cpu_train_step_gives_the_layer_tree():
    scene = rt.cornell_box(device="cpu")
    target = torch.zeros((16, 16, 3))
    train_step(scene, target, CFG)           # warm
    tracing.enable()
    train_step(scene, target, CFG)
    out = tracing.drain()
    step = out["spans"][0].step
    assert sorted(tree(out["spans"])) == sorted([
        ("rt.train_step", None, step),
        ("rt.render", "rt.train_step", step),
        ("rt.fwd.launch", "rt.render", step),
        ("rt.bwd", "rt.train_step", step),
        ("rt.bwd.pack", "rt.bwd", step),
        ("rt.bwd.launch", "rt.bwd", step),
        ("rt.bwd.pull_back", "rt.bwd", step)])
    names = tracing.by_name(out["spans"])
    assert names["rt.train_step"]["total_ms"] >= (
        names["rt.render"]["total_ms"] + names["rt.bwd"]["total_ms"])
    # the plain versions launch nothing; a CPU step runs eagerly, and its
    # plain backward sets the chain launch's gauge from the record
    assert set(out["counts"]) == {"train.eager", "bwd.chain_pixels"}
    assert out["counts"]["train.eager"] == 1


def test_render_and_live_loop_spans():
    """``render()`` with a pairing validates it under ``rt.render.quads``;
    a tick of the live loop is a frame."""
    from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
    scene = rt.cornell_box(device="cpu")
    quads = detect_shadow_quads(scene)
    loop = LiveLoop(scene, CFG)
    tracing.enable()
    rt.render(scene, CFG, shadow_quads=quads)
    loop.tick()
    loop.tick()
    spans = tracing.drain()["spans"]
    got = tree(spans)
    assert got[:3] == [("rt.render", None, None),
                       ("rt.render.quads", "rt.render", None),
                       ("rt.fwd.launch", "rt.render", None)]
    ticks = [r for r in spans if r.name == "rt.tick"]
    assert len(ticks) == 2 and ticks[1].step == ticks[0].step + 1
    for t in ticks:
        assert {(n, p) for n, p, s in got if s == t.step} == {
            ("rt.tick", None), ("rt.render", "rt.tick"),
            ("rt.fwd.launch", "rt.render")}


def test_spans_are_profiler_annotations_with_tracing_off(tmp_path):
    scene = rt.cornell_box(device="cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        train_step(scene, torch.zeros((16, 16, 3)), CFG)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rt.train_step", "rt.render", "rt.fwd.launch", "rt.bwd",
            "rt.bwd.pack", "rt.bwd.launch", "rt.bwd.pull_back"} <= names
    assert tracing.drain()["spans"] == []       # nothing recorded
    assert tracing.span("rt.x") is tracing.span("rt.y")  # off again


def test_a_wait_counts_under_the_innermost_span(monkeypatch):
    real = render_bwd.segment_sum_plain

    def waits(*args):
        warnings.warn(tracing.WAIT_TEXT)     # as the sync-debug mode warns
        return real(*args)
    monkeypatch.setattr(render_bwd, "segment_sum_plain", waits)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    ids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    rows = torch.ones((4, 16))
    tracing.enable(waits=True)
    with tracing.span("rt.bwd"):
        out = render_bwd.segment_sum(ids, rows, 3)
    warnings.warn(tracing.WAIT_TEXT)
    warnings.warn("another warning")         # passed on, not counted
    got = tracing.drain()
    assert shown == ["another warning"]
    assert torch.equal(out[:, 0], torch.tensor([1.0, 1.0, 2.0]))
    assert {k: v for k, v in got["counts"].items()
            if k.startswith("waits.")} == {"waits.rt.bwd.segment_sum": 1,
                                           "waits.outside": 1}
    (where, site, n), _ = sorted(got["wait_sites"], reverse=True)
    assert where == "rt.bwd.segment_sum" and n == 1
    assert site.endswith("test_torch_tracing.py:" + str(
        waits.__code__.co_firstlineno + 1))


def test_disable_restores_the_mode_and_the_filters(monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, show = list(warnings.filters), warnings.showwarning
    tracing.enable(waits=True)
    assert modes[-1] == "warn" and warnings.showwarning is not show
    assert warnings.filters[0][0] == "always"
    with pytest.raises(RuntimeError):
        tracing.enable()
    tracing.disable()
    assert modes == [0, "warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show
    tracing.enable()                 # without waits the mode is untouched
    tracing.disable()
    assert modes == [0, "warn", 0]


def test_drain_reads_the_launch_counters(monkeypatch):
    from uob_raytracer_tpu_torch.debug import launch_counts
    tracing.enable()
    before = launch_counts()
    monkeypatch.setattr(render_fwd, "STREAMED_LAUNCHES",
                        render_fwd.STREAMED_LAUNCHES + 5)
    monkeypatch.setattr(render_bwd, "SEGMENT_SUM_LAUNCHES",
                        render_bwd.SEGMENT_SUM_LAUNCHES + 2)
    tracing.count("bwd.bands")
    after = launch_counts()
    counts = tracing.drain()["counts"]
    for k in before:
        assert counts.get(f"launches.{k}", 0) == after[k] - before[k]
    assert counts["launches.K3f render_fwd_streamed_kernel"] == 5
    assert counts["bwd.bands"] == 1 and len(counts) == 3
    assert tracing.drain()["counts"] == {}      # drained: a new base


def test_recorded_keeps_the_callers_recording():
    """``recorded()`` hands over the spans of its block; on its own it
    switches recording on and off again, inside a caller's recording it
    leaves that recording, its records and its counters as they were."""
    with tracing.recorded() as got:
        with tracing.span("rt.tick", step=True):
            pass
    assert [r.name for r in got] == ["rt.tick"]
    assert tracing.span("rt.x") is tracing.span("rt.y")     # off again
    tracing.enable()
    with tracing.span("rt.train_step", step=True):
        pass
    tracing.count("bwd.bands")
    with tracing.recorded() as got:
        with tracing.span("rt.render"):
            pass
    assert [r.name for r in got] == ["rt.render"]
    with tracing.span("rt.bwd"):
        pass
    out = tracing.drain()
    assert [r.name for r in out["spans"]] == ["rt.train_step", "rt.render",
                                              "rt.bwd"]
    assert out["counts"] == {"bwd.bands": 1}


def test_a_build_shows_as_a_span(monkeypatch, tmp_path):
    """``rt.build`` wraps nvcc when the library is missing (here nvcc is
    absent, so the build raises inside its span)."""
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(_build, "tool", lambda name: (_ for _ in ()).throw(
        RuntimeError(f"{name} not found")))
    tracing.enable()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert [r.name for r in tracing.drain()["spans"]] == ["rt.build"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_on_card_nests_the_backward_thread(cuda_device):
    """On the card the autograd engine runs ``_FusedRender.backward`` on its
    device thread: on an eager step (the first call with a key) every
    ``rt.bwd`` span has ``rt.train_step`` as an ancestor, the streamed
    route's spans and launches show, and the spans change nothing the step
    computes. Replayed steps (from the key's third call on) count as
    replays, add the captured step's launches to the kernels' counters,
    open ``rt.train_step`` alone and wait for nothing."""
    from uob_raytracer_tpu_torch.debug import dense_scene
    from uob_raytracer_tpu_torch.parallel import train
    train._graph = None
    scene = dense_scene(600, device=cuda_device)
    cfg = RenderConfig(width=32, height=32, shadow_samples=2, bounces=2)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    plain = train._step(scene, target, cfg, None, 1e-2, train.TRAINABLE,
                        "auto")
    tracing.enable(waits=True)
    traced = train_step(scene, target, cfg)
    out = tracing.drain()        # before the synchronise, itself a wait
    by_id = {r.id: r for r in out["spans"]}

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name
    bwd = [r for r in out["spans"] if r.name.startswith("rt.bwd")]
    assert len({r.thread for r in bwd}) == 1
    assert bwd[0].thread != threading.get_ident()
    for r in bwd:
        assert "rt.train_step" in ancestors(r), r
    names = tracing.by_name(out["spans"])
    for n in ("rt.fwd.pack", "rt.fwd.launch", "rt.bwd.pack",
              "rt.bwd.launch", "rt.bwd.segment_sum", "rt.bwd.pull_back"):
        assert names[n]["n"] == 1, n
    assert out["counts"]["bwd.bands"] == 1
    assert out["counts"]["train.eager"] == 1
    assert out["counts"]["launches.K3f render_fwd_streamed_kernel"] == 1
    assert "waits.outside" not in out["counts"]

    train_step(scene, target, cfg)                # the capture
    assert tracing.drain()["counts"]["train.graph.capture"] == 1
    for _ in range(3):
        replayed = train_step(scene, target, cfg)
    out = tracing.drain()
    tracing.disable()
    torch.cuda.synchronize()
    train._graph = None
    assert {k: v for k, v in out["counts"].items()
            if not k.startswith("launches.")} == {"train.graph.replay": 3}
    assert {k: v for k, v in out["counts"].items()
            if k.startswith("launches.")} == {
        "launches.K3f render_fwd_streamed_kernel": 3,
        "launches.K3b/K3b deep render_bwd_streamed_kernel": 3,
        "launches.segment_sum_tiles_kernel + segment_sum_runs_kernel": 3}
    assert [r.name for r in out["spans"]] == ["rt.train_step"] * 3
    for k in ("tri_v0", "light_pos", "yaw"):
        assert torch.equal(getattr(plain.scene, k), getattr(traced.scene, k))
        assert torch.equal(getattr(traced.scene, k),
                           getattr(replayed.scene, k))


@pytest.mark.cuda
def test_real_waits_on_card_count_under_their_span(cuda_device, monkeypatch):
    """Waits that the sync-debug mode reports on the card count under the
    innermost open span, with the file:line that waited: the quad
    detection's copy of the vertices to the host inside ``render()`` (the
    caller's thread), and a read of one value planted in the segmented sum
    (the autograd engine's device thread, inside ``rt.bwd.segment_sum``)."""
    from uob_raytracer_tpu_torch.debug import dense_scene
    from uob_raytracer_tpu_torch.ops import quads
    from uob_raytracer_tpu_torch.parallel import train
    train._graph = None          # the warm step below is its key's first
    real, planted = render_bwd._check, []

    def check(name, t, *args):
        if name == "segment_sum rows":
            planted.append(threading.get_ident())
            t[0, 0].item()                        # a real wait on the card
        return real(name, t, *args)
    monkeypatch.setattr(render_bwd, "_check", check)
    cfg = RenderConfig(width=32, height=32, shadow_samples=2, bounces=2)
    box = rt.cornell_box(device=cuda_device)
    dense = dense_scene(600, device=cuda_device)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    rt.render(box, cfg)
    train_step(dense, target, cfg)                # warm
    torch.cuda.synchronize()
    tracing.enable(waits=True)
    try:
        rt.render(box, cfg)
        n_quads = tracing.drain()
        planted.clear()
        # another learning rate is another key, whose first step is eager
        # (a wait inside a capture would fail it)
        train_step(dense, target, cfg, lr=2e-2)
        n_bwd = tracing.drain()
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    waits = {k: v for k, v in n_quads["counts"].items()
             if k.startswith("waits.")}
    assert waits.get("waits.rt.render.quads", 0) >= 1, waits
    assert "waits.outside" not in waits
    assert any(w == "rt.render.quads" and site.startswith(quads.__file__)
               for w, site, n in n_quads["wait_sites"]), n_quads
    assert len(planted) == 1 and planted[0] != threading.get_ident()
    waits = {k: v for k, v in n_bwd["counts"].items()
             if k.startswith("waits.")}
    assert waits == {"waits.rt.bwd.segment_sum": 1}, waits
    line = check.__code__.co_firstlineno + 3
    assert n_bwd["wait_sites"] == [[
        "rt.bwd.segment_sum", f"{__file__}:{line}", 1]], n_bwd
