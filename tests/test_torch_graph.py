"""Port tests: ``train_step`` replaying its step as one CUDA graph
(``uob_raytracer_tpu_torch/parallel/train.py``).

On the CPU: which calls are graphed (``graphs``: a CUDA device, no mesh or
a 1x1 one, the fused path), that the eager routes count ``train.eager``
and never capture, what the key separates, and that a CPU step gives the
eager body's bits.

Tests marked ``cuda`` hold the replayed step bit for bit to the eager body
(``train._step``) over six steps on the three routes a step can take (the
streamed kernels on ``dense_scene(600)``; the whole-table forward and
backward in one launch on the Cornell box at 64x64; the backward split
into the chain-free and the chain launch at 512x512 with 2x2 AA, 2^20
rays, at 3 samples and 2 bounces and at the reference's 10 and 10), and
check that a scene other than the last one returned, and a new target,
give the eager step's answer; that a returned scene never changes
afterwards; that a new key recaptures; that the profiler names the
streamed kernels of a replay; and that a replay reports the gauge
``bwd.chain_pixels`` of the eager step and of the record, which
``tracing.drain()`` reads without counting a wait. They skip without a
card."""
import dataclasses
import json

import pytest
import torch

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import tracing
from uob_raytracer_tpu_torch.config import RenderConfig
from uob_raytracer_tpu_torch.debug import dense_scene
from uob_raytracer_tpu_torch.parallel import train
from uob_raytracer_tpu_torch.parallel.mesh import Mesh
from uob_raytracer_tpu_torch.parallel.train import TRAINABLE, train_step

CFG = RenderConfig(width=16, height=16, shadow_samples=2, bounces=1)
LR = 1e-3


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
# On the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device,mesh,fused,want", [
    ("cuda", None, True, True),
    ("cuda", (1, 1), True, True),
    ("cuda", (1, 2), True, False),
    ("cuda", (2, 1), True, False),
    ("cuda", None, False, False),
    ("cpu", None, True, False),
])
def test_which_steps_are_graphed(device, mesh, fused, want):
    m = None if mesh is None else Mesh(
        dp=mesh[0], tp=mesh[1], dp_index=0, tp_index=0,
        device=torch.device(device))
    assert train.graphs(torch.device(device), m, fused) is want


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_cpu_steps_run_eagerly(backend):
    scene = trt.cornell_box(device="cpu")
    target = torch.zeros((16, 16, 3))
    tracing.enable()
    for _ in range(3):
        scene = train_step(scene, target, CFG, lr=LR,
                           trainable=("light_pos",), backend=backend).scene
    counts = tracing.drain()["counts"]
    # the fused route's plain backward also sets the chain launch's gauge
    assert set(counts) - {"bwd.chain_pixels"} == {"train.eager"}
    assert counts["train.eager"] == 3
    assert train._graph is None


def _key(**change):
    args = dict(scene=trt.cornell_box(device="cpu"),
                target=torch.zeros((16, 16, 3)), cfg=CFG, lr=LR,
                trainable=TRAINABLE, backend="auto")
    args.update(change)
    return train._key(**args)


@pytest.mark.parametrize("change", [
    dict(cfg=dataclasses.replace(CFG, shadow_samples=3)),
    dict(cfg=dataclasses.replace(CFG, width=8)),
    dict(lr=2e-3),
    dict(trainable=("light_pos",)),
    dict(trainable=tuple(reversed(TRAINABLE))),
    dict(backend="cuda"),
    dict(target=torch.zeros((8, 16, 3))),
    dict(target=torch.zeros((16, 16, 3), dtype=torch.float64)),
    dict(scene=dense_scene(40, device="cpu")),
    dict(scene=dataclasses.replace(trt.cornell_box(device="cpu"),
                                   light_pos=torch.zeros(3,
                                                         dtype=torch.float64))),
], ids=["samples", "width", "lr", "trainable", "order", "backend",
        "target_shape", "target_dtype", "triangles", "leaf_dtype"])
def test_the_key_separates(change):
    assert _key(**change) != _key()


def test_the_key_holds_no_values():
    """Another scene and another target of the same shapes share the key:
    the graph copies them in."""
    box = trt.cornell_box(device="cpu")
    moved = dataclasses.replace(box, light_pos=box.light_pos + 0.1,
                                tri_rgb=box.tri_rgb * 0.5)
    assert _key(scene=moved, target=torch.ones((16, 16, 3))) == _key()
    assert _key(trainable=list(TRAINABLE)) == _key()


def _body(scene, target, cfg, lr, names):
    """The step as ``train_step`` computed it before it had a graph."""
    live, params = train._with_params(scene, names)
    loss = train.image_loss(live, target, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    new = {k: (p - lr * g).detach() for (k, p), g in zip(params.items(),
                                                         grads)}
    return dataclasses.replace(scene, **new), loss.detach()


def test_cpu_step_is_the_eager_body():
    scene = trt.cornell_box(device="cpu")
    target = torch.full((16, 16, 3), 0.25)
    live = ref = scene
    for _ in range(3):
        out = train_step(live, target, CFG, lr=LR)
        want, loss = _body(ref, target, CFG, LR, TRAINABLE)
        assert torch.equal(out.loss, loss)
        for k in TRAINABLE:
            assert torch.equal(getattr(out.scene, k), getattr(want, k)), k
        assert out.scene.tri_mat is scene.tri_mat
        live, ref = out.scene, want


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# route: (scene, config, the launch counters that show the route)
ROUTES = {
    "streamed": (lambda d: dense_scene(600, device=d),
                 RenderConfig(width=32, height=32, shadow_samples=2,
                              bounces=2),
                 ("K3f render_fwd_streamed_kernel",
                  "K3b/K3b deep render_bwd_streamed_kernel")),
    "whole": (lambda d: trt.cornell_box(device=d),
              RenderConfig(width=64, height=64, shadow_samples=3, bounces=2),
              ("K1/K1r render_fwd_kernel",
               "K2/K2'/K2 deep render_bwd_kernel")),
    "split": (lambda d: trt.cornell_box(device=d),
              RenderConfig(width=512, height=512, shadow_samples=3,
                           bounces=2),
              ("K1/K1r render_fwd_kernel", "K2f render_bwd_free_kernel",
               "K2/K2'/K2 deep render_bwd_kernel")),
    # the benchmark cell cornell_1024.fit's settings at a quarter of its rays
    "split_s10_b10": (lambda d: trt.cornell_box(device=d),
                      RenderConfig(width=512, height=512, shadow_samples=10,
                                   bounces=10),
                      ("K1/K1r render_fwd_kernel",
                       "K2f render_bwd_free_kernel",
                       "K2/K2'/K2 deep render_bwd_kernel")),
}


def _problem(route, device):
    make, cfg, kernels = ROUTES[route]
    scene = make(device)
    target = torch.full((cfg.height, cfg.width, 3), 0.25, device=device)
    return scene, target, cfg, kernels


def _eager(scene, target, cfg, lr=LR):
    return train._step(scene, target, cfg, None, lr, TRAINABLE, "auto")


def _assert_same(out, want, scene):
    assert torch.equal(out.loss, want.loss)
    assert out.loss.shape == want.loss.shape == ()
    for k in TRAINABLE:
        assert torch.equal(getattr(out.scene, k), getattr(want.scene, k)), k
    assert out.scene.tri_mat is scene.tri_mat


def _steps(counts):
    return {k: v for k, v in counts.items() if k.startswith("train.")}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_is_the_eager_step_bit_for_bit(cuda_device, route):
    scene, target, cfg, kernels = _problem(route, cuda_device)
    tracing.enable()
    live = ref = scene
    for _ in range(6):
        out = train_step(live, target, cfg, lr=LR)
        want = _eager(ref, target, cfg)
        _assert_same(out, want, live)
        live, ref = out.scene, want.scene
    counts = tracing.drain()["counts"]
    torch.cuda.synchronize()
    assert _steps(counts) == {"train.eager": 1, "train.graph.capture": 1,
                              "train.graph.replay": 4}
    # six steps of each kind: the replays count the launches they hold
    for k in kernels:
        assert counts[f"launches.{k}"] == 12, k


@pytest.mark.cuda
def test_replay_takes_any_scene_and_target(cuda_device):
    scene, target, cfg, _ = _problem("streamed", cuda_device)
    live = scene
    for _ in range(3):               # eager, capture, replay
        live = train_step(live, target, cfg, lr=LR).scene
    other = dataclasses.replace(scene, light_pos=scene.light_pos + 0.05,
                                tri_rgb=scene.tri_rgb * 0.9)
    target2 = torch.rand(target.shape, generator=torch.Generator(
        cuda_device).manual_seed(7), device=cuda_device)
    tracing.enable()
    for sc, tg in ((other, target2), (scene, target), (live, target2)):
        _assert_same(train_step(sc, tg, cfg, lr=LR), _eager(sc, tg, cfg), sc)
    assert _steps(tracing.drain()["counts"]) == {"train.graph.replay": 3}


@pytest.mark.cuda
def test_a_returned_scene_never_changes(cuda_device):
    scene, target, cfg, _ = _problem("streamed", cuda_device)
    for _ in range(3):               # eager, capture, replay
        out = train_step(scene, target, cfg, lr=LR)
        scene = out.scene
    kept = {k: getattr(out.scene, k).clone() for k in TRAINABLE}
    loss = out.loss.clone()
    for _ in range(3):
        train_step(out.scene, target, cfg, lr=LR)
    torch.cuda.synchronize()
    for k in TRAINABLE:
        assert torch.equal(getattr(out.scene, k), kept[k]), k
    assert torch.equal(out.loss, loss)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["lr", "size"])
def test_a_new_key_recaptures(cuda_device, change):
    scene, target, cfg, _ = _problem("streamed", cuda_device)
    lr2, cfg2, target2 = LR, cfg, target
    if change == "lr":
        lr2 = 2 * LR
    else:
        cfg2 = dataclasses.replace(cfg, width=48, height=16)
        target2 = torch.full((16, 48, 3), 0.25, device=cuda_device)
    tracing.enable()
    for _ in range(3):
        train_step(scene, target, cfg, lr=LR)
    first = train._graph
    for _ in range(3):
        out = train_step(scene, target2, cfg2, lr=lr2)
    counts = tracing.drain()["counts"]
    assert train._graph is not first and train._graph.key != first.key
    assert _steps(counts) == {"train.eager": 2, "train.graph.capture": 2,
                              "train.graph.replay": 2}
    _assert_same(out, _eager(scene, target2, cfg2, lr2), scene)


@pytest.mark.cuda
def test_profiler_names_the_kernels_of_a_replay(cuda_device, tmp_path):
    """The streamed kernels of a replayed step show in a profiler's trace
    under their names, with device time: what the benchmark's
    ``fwd_roofline.fit`` and ``bwd_roofline.fit`` read."""
    scene, target, cfg, _ = _problem("streamed", cuda_device)
    for _ in range(2):               # eager, capture
        scene = train_step(scene, target, cfg, lr=LR).scene
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tracing.enable()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            scene = train_step(scene, target, cfg, lr=LR).scene
        torch.cuda.synchronize()
    assert _steps(tracing.drain()["counts"]) == {"train.graph.replay": 2}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels = [e for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    for name in ("render_fwd_streamed_kernel", "render_bwd_streamed_kernel"):
        got = [e for e in kernels if name in e.get("name", "")]
        assert len(got) == 2, (name, sorted({e["name"] for e in kernels}))
        assert all(float(e.get("dur", 0)) > 0 for e in got)


def _gauge_of_the_record(scene, cfg) -> int:
    from uob_raytracer_tpu_torch.kernels import render_bwd, render_fwd
    _, _, res = render_fwd.render_fused_res(scene, cfg)
    return int(render_bwd.chain_pixels(scene, cfg, res))


@pytest.mark.cuda
def test_a_replay_gauges_the_eager_steps_chain_pixels(cuda_device):
    """Each call on the same scene: the eager step, the capture and two
    replays all report the chain launch's pixels of that scene's record."""
    from uob_raytracer_tpu_torch.kernels import render_bwd
    scene, target, cfg, _ = _problem("split_s10_b10", cuda_device)
    assert render_bwd.splits(cfg, cfg.height, 28)
    want = _gauge_of_the_record(scene, cfg)
    assert 0 < want < cfg.width * cfg.height
    tracing.enable()
    got = []
    for _ in range(4):               # eager, capture, replay, replay
        train_step(scene, target, cfg, lr=LR)
        counts = tracing.drain()["counts"]
        got.append((counts["bwd.chain_pixels"], counts.get("bwd.bands")))
    assert got == [(want, 1)] * 4
    assert got[0][0] == _gauge_of_the_record(scene, cfg)


@pytest.mark.cuda
def test_reading_the_gauge_counts_no_wait(cuda_device):
    scene, target, cfg, _ = _problem("split_s10_b10", cuda_device)
    for _ in range(2):               # eager, capture
        train_step(scene, target, cfg, lr=LR)
    want = _gauge_of_the_record(scene, cfg)
    tracing.enable(waits=True)
    for _ in range(3):
        train_step(scene, target, cfg, lr=LR)
    out = tracing.drain()            # before any synchronise
    mode = torch.cuda.get_sync_debug_mode()
    tracing.disable()
    assert mode == 1                 # "warn" again after the read
    assert {k for k in out["counts"] if k.startswith("waits.")} == set()
    assert out["wait_sites"] == []
    assert out["counts"]["bwd.chain_pixels"] == want
    assert _steps(out["counts"]) == {"train.graph.replay": 3}
    assert out["counts"]["bwd.bands"] == 3
