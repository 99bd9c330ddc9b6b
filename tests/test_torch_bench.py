"""Port tests: ``uob_raytracer_tpu_torch.bench`` (the port's measurement
entry point, ``bench_torch.py``) against the JAX package's ``bench.py``, and
the bounce count the port's ``trace_specular`` gained for it.

Tolerances: the slope statistics are pure Python and must give equal
tuples; the logical ray counts agree within 0.1% (XLA contracts
multiply-adds into FMAs and the port does not, so a ray at a triangle's
boundary can flip); the bounce count on the same rays is equal; the dense
scene's arrays are bit-equal; the image is bit-equal with and without the
count read."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import bench as jbench
import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.config import baseline_configs as j_baseline_configs
from uob_raytracer_tpu.ops.intersect import intersect as j_intersect
from uob_raytracer_tpu.ops.intersect import prepare_scene as j_prepare_scene
from uob_raytracer_tpu.ops.shading import trace_specular as j_trace_specular
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import bench
from uob_raytracer_tpu_torch.kernels.render_fwd import render_fused_plain
from uob_raytracer_tpu_torch.ops import shading
from uob_raytracer_tpu_torch.ops.camera import gen_primary_rays
from uob_raytracer_tpu_torch.ops.intersect import intersect, prepare_scene

RAY_COUNT_RTOL = 1e-3


@pytest.fixture
def one_thread():
    """The plain pipeline at these sizes is many small ops: one thread runs
    them faster than several, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- robust_slope_stats: the six cases of tests/test_bench_stats.py ---

def _clean(r):
    p50, spread, rej = r
    assert p50 == pytest.approx(1.00) and rej == 0
    assert spread == pytest.approx(0.04, abs=0.005)


def _burst(r):
    p50, spread, rej = r
    assert rej == 2 and p50 == pytest.approx(1.005, abs=0.01)
    assert spread < 0.05


def _floor(r):
    _, spread, rej = r
    assert rej == 0 and spread == pytest.approx(0.06, abs=0.01)


def _degenerate(r):
    p50, _, rej = r
    assert rej == 2 and p50 == pytest.approx(1.0)


def _bimodal(r):
    _, spread, rej = r
    assert rej == 0 and spread > 0.5


def _suspect(r):
    assert r[2] >= 1


@pytest.mark.parametrize("slopes, check", [
    ([1.00, 1.01, 0.99, 1.02, 0.98, 1.00, 1.01], _clean),
    ([1.00, 1.01, 0.99, 3.50, 1.02, 5.00, 1.00], _burst),
    ([1.000, 1.0001, 0.9999, 1.0, 1.03, 0.97, 1.0], _floor),
    ([1.0, 1.0, 5.0], _degenerate),
    ([1.0, 1.0, 2.0, 2.0], _bimodal),
    ([1.0, 9.0, 11.0, 10.0, 10.5, 9.5, 10.2], _suspect),
], ids=["clean", "burst_outliers_rejected", "five_percent_floor",
        "degenerate_zero_mad", "even_bimodal", "suspect_capture"])
def test_robust_slope_stats_cases(slopes, check):
    check(bench.robust_slope_stats(slopes))


def test_robust_slope_stats_equals_jax_bench():
    """50 seeded slope sets (3 to 11 estimates, with bursts and duplicates)
    through both functions: equal tuples."""
    rng = np.random.RandomState(10)
    for _ in range(50):
        n = int(rng.randint(3, 12))
        s = 1e-3 * (1.0 + 0.05 * rng.standard_normal(n))
        burst = rng.uniform(size=n) < 0.2
        s[burst] *= rng.uniform(2.0, 10.0, size=int(burst.sum()))
        if rng.uniform() < 0.2:
            s[: n // 2] = s[0]
        slopes = [float(x) for x in s]
        assert bench.robust_slope_stats(slopes) == jbench.robust_slope_stats(
            slopes)


def test_timing_ms_dict():
    t = bench.Timing(2.5e-3, 0.0412, window_s=1e-3, n_rejected=2)
    assert t.ms_dict() == {"p50": 2.5, "spread": 0.0412,
                           "outliers_rejected": 2, "below_resolution": True}
    assert bench._rate(1000, t) is None
    assert bench._rate(1000, bench.Timing(1e-3, 0.0)) == 1_000_000


# --- logical ray counts against the JAX bench ---

def _small(cfg, width):
    return dataclasses.replace(cfg, width=width, height=width)


RAY_COUNT_CASES = [
    *[(name, 32) for name in trt.baseline_configs()],
    ("dense_600", 16),
]


@pytest.mark.parametrize("name, width", RAY_COUNT_CASES,
                         ids=[c[0] for c in RAY_COUNT_CASES])
def test_logical_ray_count_matches_jax(name, width, one_thread):
    if name == "dense_600":
        tcfg = trt.RenderConfig(width=16, height=16, aa_x=2, aa_y=2,
                                shadow_samples=3, bounces=2)
        jcfg = jrt.RenderConfig(width=16, height=16, aa_x=2, aa_y=2,
                                shadow_samples=3, bounces=2)
        tscene = bench.dense_scene(600, device="cpu")
        jscene = jbench.dense_scene(600)
    else:
        tcfg = _small(trt.baseline_configs()[name], width)
        jcfg = _small(j_baseline_configs()[name], width)
        tscene = trt.cornell_box(device="cpu")
        jscene = jrt.cornell_box()
    got = bench.logical_ray_count(tscene, tcfg)
    want = jbench.logical_ray_count(jscene, jcfg)
    diff = abs(got - want) / want
    print(f"{name} at {width}^2: port {got:,}, JAX {want:,}, "
          f"difference {diff:.3e} (budget {RAY_COUNT_RTOL})")
    assert got > tcfg.width * tcfg.height * tcfg.aa_rays
    assert diff <= RAY_COUNT_RTOL


@pytest.mark.parametrize("name", ["mirror_512", "glass_fresnel_512"])
def test_bounce_rays_equals_jax(name, monkeypatch, one_thread):
    """The bounce count on the same rays equals the JAX trace_specular's,
    and reading it leaves the image bit-equal."""
    tcfg = _small(trt.baseline_configs()[name], 32)
    jcfg = _small(j_baseline_configs()[name], 32)
    scene = trt.cornell_box(device="cpu")
    dirs, _ = gen_primary_rays(tcfg, scene.yaw, scene.pitch)
    d = dirs.reshape(-1, 3)
    ds = prepare_scene(scene)
    start = ds.camera_pos.expand(d.shape[0], 3)
    got = shading.trace_specular(ds, tcfg, intersect(ds, start, d), d)
    jds = j_prepare_scene(jrt.cornell_box())
    jd = d.numpy()
    jstart = np.broadcast_to(np.asarray(jds.camera_pos), jd.shape)
    want = j_trace_specular(jds, jcfg, j_intersect(jds, jstart, jd), jd)
    assert got["bounce_rays"].dtype == torch.int64
    assert got["bounce_rays"].device == d.device
    assert int(got["bounce_rays"]) == int(want["bounce_rays"]) > 0

    img = render_fused_plain(scene, tcfg)[0]
    real = shading.trace_specular
    reads = []

    def read_count(*a, **k):
        out = real(*a, **k)
        reads.append(int(out["bounce_rays"]))
        return out

    monkeypatch.setattr(shading, "trace_specular", read_count)
    img_read = render_fused_plain(scene, tcfg)[0]
    assert reads and torch.equal(img, img_read)


@pytest.mark.parametrize("n_tri", [600, 8192])
def test_dense_scene_bit_equal_to_jax(n_tri):
    got = bench.dense_scene(n_tri, seed=1, device="cpu")
    want = jbench.dense_scene(n_tri, seed=1)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


def test_assert_finite_grads_names_the_leaf(one_thread):
    scene = trt.cornell_box(device="cpu")
    light = scene.light_pos.clone()
    light[0] = float("nan")
    scene = dataclasses.replace(scene, light_pos=light)
    cfg = trt.RenderConfig(width=8, height=8, aa_x=1, aa_y=1,
                           shadow_samples=2, bounces=1)
    with pytest.raises(FloatingPointError, match=r"Scene\.light_pos"):
        bench.assert_finite_grads(bench._image_fn(cfg, None), scene)
    bench.assert_finite_grads(bench._image_fn(cfg, None),
                              trt.cornell_box(device="cpu"))


# --- the entry point on the CPU ---

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "fwd_ms",
              "fwd_bwd_ms", "grads_finite"}
CONFIG_KEYS = {"rays_per_frame", "grads_finite", "fwd_ms", "fwd_rays_s",
               "fwd_bwd_ms", "fwd_bwd_rays_s", "render_ms", "kernels_ms",
               "device_idle", "host_syncs", "card"}


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_main_headline_on_cpu(capsys, one_thread):
    bench.main(["--device", "cpu", "--width", "16", "--headline-only",
                "--iters", "2"])
    out = _last_json(capsys)
    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "BENCH_r05.json")) as f:
        jax_keys = set(json.load(f)["parsed"]) - {"configs"}
    assert jax_keys == BENCH_KEYS
    assert BENCH_KEYS | {"card", "method"} == set(out)
    assert out["metric"] == "rays/s/chip fwd+bwd (Cornell Box 16^2, 1 bounce)"
    assert out["vs_baseline"] is None and out["card"] == "cpu"
    assert out["grads_finite"] is True and out["value"] > 0
    assert out["fwd_ms"]["p50"] > 0 and out["fwd_bwd_ms"]["p50"] > 0


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--width", "16", "--headline-only"])


def test_bench_config_on_cpu_returns_every_key(one_thread):
    cfg = _small(trt.baseline_configs()["cpu_ref_256"], 16)
    out = bench.bench_config("cpu_ref_16", cfg, trt.cornell_box(device="cpu"),
                             2)
    assert set(out) == CONFIG_KEYS
    assert out["rays_per_frame"] == bench.logical_ray_count(
        trt.cornell_box(device="cpu"), cfg)
    for k in ("fwd_ms", "fwd_bwd_ms", "render_ms"):
        assert out[k]["p50"] > 0
    # no device number from a CPU run
    assert out["kernels_ms"] is None and out["device_idle"] is None
    assert out["card"] == "cpu"


def test_failed_config_exits_nonzero_after_printing(monkeypatch, capsys,
                                                    one_thread):
    tiny = trt.RenderConfig(width=8, height=8, aa_x=1, aa_y=1,
                            shadow_samples=1, bounces=0)
    monkeypatch.setattr(bench, "sweep", lambda: [
        ("good", tiny, lambda dev: trt.cornell_box(device=dev)),
        ("bad", tiny, lambda dev: trt.cornell_box(device=dev))])
    monkeypatch.setattr(bench, "time_scalar_fn",
                        lambda fn, scene, iters, n_estimates=7:
                        bench.Timing(1e-3, 0.01))
    real = bench.bench_config

    def bench_config(name, cfg, scene, iters):
        if name == "bad":
            raise RuntimeError("launch failed")
        return real(name, cfg, scene, iters)

    monkeypatch.setattr(bench, "bench_config", bench_config)
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--width", "16", "--iters", "2"])
    assert e.value.code not in (0, None)
    out = _last_json(capsys)
    assert set(out["configs"]["good"]) == CONFIG_KEYS
    assert out["configs"]["bad"] == {"error": "RuntimeError: launch failed"}


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bench_config_on_card(cuda_device):
    cfg = _small(trt.baseline_configs()["mirror_512"], 64)
    out = bench.bench_config("mirror_64", cfg, trt.cornell_box(), 4)
    assert set(out) == CONFIG_KEYS
    assert set(out["kernels_ms"]["fwd"]) == {"render_fwd_kernel"}
    assert {"render_fwd_kernel", "render_bwd_kernel"} <= set(
        out["kernels_ms"]["fwd_bwd"])
    for k in ("fwd", "fwd_bwd"):
        assert 0.0 <= out["device_idle"][k] < 1.0
    assert out["card"] != "cpu"
