"""Port tests: the reference's own frame fitted on the port's normal path,
the benchmark cell ``cornell_1024.fit`` at a size the CPU runs, and the
counters a replayed step reports.

- ``parallel.train_step`` on the Cornell box at 32x32 with the cell's
  settings (2x2 AA, 10 shadow samples, 10 bounces; ``backend`` auto, which
  on the CPU is the fused route's plain versions) through the benchmark's
  own set-up and check (``rtbench/loops/sgd.py``), against the plain
  reference's SGD steps on the same seeded perturbation, within the cell's
  limits (``rtbench/limits/cornell_1024.fit.json``).
- The gauge ``bwd.chain_pixels`` that the plain backward sets equals the
  pixels the record sends to the chain launch, counted here apart.
- A replayed step adds what its capture counted, with a stand-in for the
  CUDA graph (the CPU has none); ``drain()`` reads a gauge with the
  sync-debug mode set aside.

No JAX."""
import contextlib
import dataclasses
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import uob_raytracer_tpu_torch as rt
from uob_raytracer_tpu_torch import tracing
from uob_raytracer_tpu_torch.config import RenderConfig
from uob_raytracer_tpu_torch.kernels import render_bwd, render_fwd
from uob_raytracer_tpu_torch.parallel import train
from uob_raytracer_tpu_torch.parallel.train import train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cornell_1024.fit"
SIZE = 32
# the cell's settings at SIZE x SIZE
CFG = RenderConfig(width=SIZE, height=SIZE, aa_x=2, aa_y=2,
                   shadow_samples=10, bounces=10)


@pytest.fixture(autouse=True)
def fresh():
    """No recording and no kept graph, before and after."""
    tracing.disable()
    tracing.drain()
    train._graph = None
    yield
    tracing.disable()
    tracing.drain()
    train._graph = None


# --------------------------------------------------------------------------
# The cell at 32x32
# --------------------------------------------------------------------------

def _small_root(path) -> str:
    """A checkout-shaped directory holding the manifest and the cell's data
    files, its configuration cut to SIZE x SIZE (nothing else changed)."""
    root = str(path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for kind, name in (("configs", "cornell_1024"), ("traffic", "fit"),
                       ("limits", CELL)):
        os.makedirs(os.path.join(root, "rtbench", kind), exist_ok=True)
        with open(os.path.join(REPO, "rtbench", kind, f"{name}.json")) as f:
            data = json.load(f)
        if kind == "configs":
            data["render"].update(width=SIZE, height=SIZE)
        with open(os.path.join(root, "rtbench", kind, f"{name}.json"),
                  "w") as f:
            json.dump(data, f)
    return root


# Why each of the cell's limits holds here too. The port's plain versions
# and the reference are two float32 programs of the same arithmetic:
# - first_loss_gap: the first step's loss, a mean over the frame, differs
#   only where a ray falls on the other side of an edge in one of them;
#   on the card that is a few pixels of 2^20, here none of 2^10 on these
#   seeds;
# - grad_gap: the first gradient's norm by leaf is a sum over the frame's
#   rays in another order (the plain backward's autograd against the
#   reference's banded autograd), float32 rounding;
# - median_change_gap: the change after three steps, by the median leaf,
#   the same sums three times.
@pytest.mark.parametrize("seed", [2**31 + 977, 2**32 + 15])
def test_first_steps_are_within_the_cells_limits(tmp_path, seed):
    from rtbench import harness
    run = harness.Run(_small_root(tmp_path), CELL, seed, 0.1, False,
                      torch.device("cpu"))
    assert run.params.width == SIZE and run.params.bounces == 10
    assert run.params.shadow_samples == 10 and run.params.aa_x == 2
    st = run.loop.setup(run)
    assert len(st.first["losses"]) == 3
    got = run.loop.check(st, run)
    assert set(got) == set(run.limits)
    for name, value in got.items():
        assert np.isfinite(value) and value <= run.limits[name], (
            name, value, run.limits[name])


# --------------------------------------------------------------------------
# The gauge of the chain launch's pixels
# --------------------------------------------------------------------------

def _record(scene, cfg):
    _, _, res = render_fwd.render_fused_res(scene, cfg)
    return res


def _chain_pixels_by_hand(scene, cfg, res) -> int:
    """Pixels with an AA ray whose primary hit is on an object of material
    code <= 0 (mirror, glass), when the config bounces: K2f's rule for the
    pixels it lists, counted in numpy."""
    if not cfg.bounces:
        return 0
    mat = np.concatenate([scene.tri_mat.numpy(), scene.sph_mat.numpy()])
    pid = res.prim_id.numpy().reshape(cfg.aa_rays, -1)
    ray = (pid >= 0) & (mat[np.clip(pid, 0, None)] <= 0.0)
    return int(ray.any(axis=0).sum())


@pytest.mark.parametrize("bounces", [10, 0])
def test_plain_backward_gauges_the_records_chain_pixels(bounces):
    scene = rt.cornell_box(device="cpu")
    cfg = dataclasses.replace(CFG, bounces=bounces)
    res = _record(scene, cfg)
    g = torch.full((SIZE, SIZE, 3), 1e-3)
    render_bwd.render_replay_bwd(scene, cfg, res, g)   # off: nothing kept
    tracing.enable()
    render_bwd.render_replay_bwd(scene, cfg, res, g)
    counts = tracing.drain()["counts"]
    want = _chain_pixels_by_hand(scene, cfg, res)
    assert counts["bwd.chain_pixels"] == want
    assert int(render_bwd.chain_pixels(scene, cfg, res)) == want
    if bounces:     # the mirror and the glass sphere are in view
        assert 0 < want < SIZE * SIZE
    assert "bwd.chain_pixels" not in tracing.drain()["counts"]   # read once


def test_a_train_steps_gauge_is_its_last_backwards():
    scene = rt.cornell_box(device="cpu")
    target = torch.full((SIZE, SIZE, 3), 0.25)
    tracing.enable()
    train_step(scene, target, CFG, trainable=("light_pos",))
    counts = tracing.drain()["counts"]
    assert counts["train.eager"] == 1
    assert counts["bwd.chain_pixels"] == _chain_pixels_by_hand(
        scene, CFG, _record(scene, CFG))


# --------------------------------------------------------------------------
# Replays count what their capture counted
# --------------------------------------------------------------------------

class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: capture runs the step eagerly
    (``torch.cuda.graph`` is patched to a null context), a replay does
    nothing."""

    def replay(self):
        pass


def test_a_replay_adds_its_captures_counters(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(train, "graphs", lambda *a: True)
    # the plain backward counts no band and launches nothing: stand in for
    # the wrapper's counter and the chain kernel's launch counter
    monkeypatch.setattr(render_bwd, "LAUNCHES", render_bwd.LAUNCHES)
    real = render_bwd.render_replay_bwd_plain

    def plain(*a, **k):
        tracing.count("bwd.bands", 2)
        render_bwd.LAUNCHES += 1
        return real(*a, **k)
    monkeypatch.setattr(render_bwd, "render_replay_bwd_plain", plain)
    scene = rt.cornell_box(device="cpu")
    target = torch.full((SIZE, SIZE, 3), 0.25)
    cfg = dataclasses.replace(CFG, shadow_samples=2, bounces=2)
    for _ in range(2):                   # eager, capture: not recording
        train_step(scene, target, cfg, trainable=("light_pos",))
    assert train._graph.graph is not None
    kept = train._graph.counted
    assert kept["counts"] == {"bwd.bands": 2}
    assert kept["launches"] == {"K2/K2'/K2 deep render_bwd_kernel": 1}
    want = _chain_pixels_by_hand(scene, cfg, _record(scene, cfg))
    tracing.enable()
    for _ in range(3):
        train_step(scene, target, cfg, trainable=("light_pos",))
    counts = tracing.drain()["counts"]
    assert counts == {"train.graph.replay": 3, "bwd.bands": 6,
                      "launches.K2/K2'/K2 deep render_bwd_kernel": 3,
                      "bwd.chain_pixels": want}
    # not recording: the launch counters still move, nothing else is kept
    tracing.disable()
    before = render_bwd.LAUNCHES
    train_step(scene, target, cfg, trainable=("light_pos",))
    assert render_bwd.LAUNCHES == before + 1
    tracing.enable()
    assert tracing.drain()["counts"] == {}


def test_held_keeps_counts_whether_recording_or_not():
    with tracing.held() as got:
        tracing.count("bwd.bands", 3)
        assert tracing.gauging()
        tracing.gauge("bwd.chain_pixels", [torch.tensor(5), torch.tensor(2)])
    assert not tracing.gauging()
    assert got["counts"] == {"bwd.bands": 3} and got["launches"] == {}
    tracing.count("bwd.bands")          # off and not held: nothing
    tracing.repeat(got)                 # off: nothing kept
    tracing.enable()
    assert tracing.drain()["counts"] == {}
    tracing.repeat(got)
    tracing.repeat(got)
    assert tracing.drain()["counts"] == {"bwd.bands": 6,
                                         "bwd.chain_pixels": 7}


def test_drain_reads_a_gauge_with_the_sync_debug_mode_set_aside(
        monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    seen = []

    class Part:
        """A device element: reading it warns as a wait would, in the
        mode "warn"."""

        def __int__(self):
            seen.append(modes[-1])
            if modes[-1] == "warn":
                warnings.warn(tracing.WAIT_TEXT)
            return 4
    tracing.enable(waits=True)
    tracing.gauge("bwd.chain_pixels", [Part()])
    counts = tracing.drain()["counts"]
    assert counts == {"bwd.chain_pixels": 4}       # no waits.* counted
    assert seen == [0] and modes[-1] == "warn"
    tracing.disable()
    assert modes[-1] == 0

