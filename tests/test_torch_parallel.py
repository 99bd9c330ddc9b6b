"""Port tests: the sharded path (``uob_raytracer_tpu_torch/parallel``: mesh,
collectives, ``render_image_sharded``, the trainer on a mesh, multihost)
against the JAX package's, on the CPU.

The JAX side runs in this process on its 8 virtual CPU devices, as
``tests/test_parallel.py`` runs it (the Pallas kernels in interpret mode),
on the same scenes and configs. The port's ranks are spawned CPU processes
joined by gloo through a ``file://`` store under ``tmp_path``
(``tests/torch_rank_jobs.py`` is what a rank runs); each writes what it
computed to an ``.npz`` that the test compares here. On the CPU the port's
kernel route (backend 'auto') runs the kernels' plain versions.

Tolerances, the JAX tests' own: tp images within ``assert_images_match(
tight=1e-5, outlier_frac=0.01)``; the nine leaf gradients of ``image_loss``
on the tp mesh rtol 1e-4, atol 1e-6; dp gradients atol 1e-5. Between the
port's own sharded and single-device results: bit for bit where the same
operations run on the same rows (dp images), 1e-6 where a sum over ranks
takes another order.
"""
import dataclasses
import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import parallel as jpar
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import cli
from uob_raytracer_tpu_torch import parallel as tpar
from uob_raytracer_tpu_torch.parallel import collectives, mesh as tmesh
from uob_raytracer_tpu_torch.parallel import multihost
from uob_raytracer_tpu_torch.scene import (save_scene, scene_from_numpy,
                                           scene_to_numpy)
from conftest import assert_images_match
import torch_rank_jobs

GRAD_LEAVES = torch_rank_jobs.GRAD_LEAVES
TP_KW = dict(width=16, height=8, aa_x=1, aa_y=1, shadow_samples=2, bounces=1)
DP_KW = dict(width=32, height=32, aa_x=1, aa_y=1, shadow_samples=2, bounces=1)
CPU = [torch.device("cpu")]
# the port's backend and the JAX backend it is the counterpart of
BACKENDS = [("auto", "pallas"), ("torch", "jnp")]


def to_torch(jscene) -> trt.Scene:
    return scene_from_numpy({k: np.asarray(v) for k, v in
                             dataclasses.asdict(jscene).items()}, "cpu")


def run_ranks(workdir, n: int, job: dict, scene, target=None) -> list[dict]:
    """Spawn n CPU ranks on the job; their outputs, by rank."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump(job, f)
    save_scene(os.path.join(workdir, "scene.npz"), scene)
    if target is not None:
        np.save(os.path.join(workdir, "target.npy"), np.asarray(target))
    multihost.spawn_ranks(torch_rank_jobs.run_job, n,
                          f"file://{workdir}/store", (workdir,), timeout_s=60)
    outs = []
    for r in range(n):
        with np.load(os.path.join(workdir, f"out{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def j_tp_scene():
    """The Cornell box padded to 28 triangles, the camera nudged off the
    axis: with the axis-aligned camera a few rays hit a wall's diagonal
    exactly, a genuine tie between two triangles
    (``tests/test_parallel.py``)."""
    return dataclasses.replace(jpar.pad_triangles(jrt.cornell_box(), 2),
                               yaw=jnp.float32(0.11), pitch=jnp.float32(0.07))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """2x2 ranks on the JAX tests' tp problem: images and gradients through
    both backends."""
    jsc = j_tp_scene()
    outs = run_ranks(tmp_path_factory.mktemp("tp"), 4,
                     dict(dp=2, tp=2, cfg=TP_KW, backends=["auto", "torch"]),
                     to_torch(jsc))
    return jsc, outs


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Four dp ranks: image and gradients through both backends, then five
    training steps towards a frame with the light moved."""
    jsc = jrt.cornell_box()
    tsc = to_torch(jsc)
    cfg = trt.RenderConfig(**DP_KW)
    moved = dataclasses.replace(tsc, light_pos=torch.tensor([0.3, -0.5, -0.7]))
    with torch.no_grad():
        target = trt.render_image(moved, cfg)
    outs = run_ranks(
        tmp_path_factory.mktemp("dp"), 4,
        dict(dp=4, tp=1, cfg=DP_KW, backends=["auto", "torch"],
             train=dict(steps=5, lr=0.5, trainable=["light_pos"]),
             fit=dict(steps=2, lrs={"light_pos": 2e-2})),
        tsc, target.numpy())
    return jsc, tsc, cfg, target, outs


# --------------------------------------------------------------------------
# tp: triangles sharded, 2x2 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_tp_image_matches_jax(tp_run, backend, j_backend):
    jsc, outs = tp_run
    mesh = jpar.make_mesh(dp=2, tp=2)
    run = jax.jit(jpar.render_image_sharded,
                  static_argnames=("cfg", "mesh", "backend"))
    ref = np.asarray(run(jsc, jrt.RenderConfig(**TP_KW), mesh,
                         backend=j_backend))
    assert_images_match(outs[0][f"image_{backend}"], ref, tight=1e-5,
                        outlier_frac=0.01,
                        what=f"tp {backend} vs JAX {j_backend}")
    # every rank returns the whole image, the same one
    for r in range(1, 4):
        np.testing.assert_array_equal(outs[r][f"image_{backend}"],
                                      outs[0][f"image_{backend}"])


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_tp_grads_match_jax(tp_run, backend, j_backend):
    jsc, outs = tp_run
    cfg = jrt.RenderConfig(**TP_KW)
    mesh = jpar.make_mesh(dp=2, tp=2)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    g = jax.jit(jax.grad(jpar.image_loss),
                static_argnames=("cfg", "mesh", "backend"))(
        jsc, target, cfg, mesh, backend=j_backend)
    for name in GRAD_LEAVES:
        np.testing.assert_allclose(
            outs[0][f"grad_{backend}_{name}"], np.asarray(getattr(g, name)),
            rtol=1e-4, atol=1e-6, err_msg=name)
        # one all-reduce: every rank holds the same whole gradient
        for r in range(1, 4):
            np.testing.assert_array_equal(outs[r][f"grad_{backend}_{name}"],
                                          outs[0][f"grad_{backend}_{name}"])
    assert np.abs(outs[0][f"grad_{backend}_tri_v0"]).max() > 0
    assert np.abs(outs[0][f"grad_{backend}_light_pos"]).max() > 0


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_tp_matches_own_single_device(tp_run, backend):
    """The tp image and gradients against the port's own single-device
    plain pipeline on the same scene."""
    jsc, outs = tp_run
    tsc = to_torch(jsc)
    cfg = trt.RenderConfig(**TP_KW)
    with torch.no_grad():
        ref = trt.render_image(tsc, cfg, backend="torch")
    assert_images_match(outs[0][f"image_{backend}"], ref.numpy(), tight=1e-5,
                        outlier_frac=0.01, what="tp vs single device")
    loss, grads = torch_rank_jobs.loss_grads(
        tsc, torch.zeros((cfg.height, cfg.width, 3)), cfg, None, "torch")
    np.testing.assert_allclose(outs[0][f"loss_{backend}"], loss, rtol=1e-5)
    for name in GRAD_LEAVES:
        np.testing.assert_allclose(outs[0][f"grad_{backend}_{name}"],
                                   grads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# --------------------------------------------------------------------------
# dp: row bands, four ranks
# --------------------------------------------------------------------------

def test_dp_image_matches_jax_and_single_device(dp_run):
    jsc, tsc, cfg, _, outs = dp_run
    mesh = jpar.make_mesh(dp=8, tp=1)
    ref = np.asarray(jax.jit(jpar.render_image_sharded,
                             static_argnames=("cfg", "mesh"))(
        jsc, jrt.RenderConfig(**DP_KW), mesh))
    for backend in ("auto", "torch"):
        assert_images_match(outs[0][f"image_{backend}"], ref, tight=1e-6,
                            outlier_frac=0.01, what=f"dp {backend} vs JAX dp")
        # the same operations on the same rows: bit-equal to one device
        with torch.no_grad():
            single = trt.render_image(tsc, cfg, backend=backend)
        for r in range(4):
            np.testing.assert_array_equal(outs[r][f"image_{backend}"],
                                          single.numpy())


def test_dp_grads_match_jax(dp_run):
    """The port's dp gradients against the JAX dp gradients: full autodiff
    ('jnp', 8 shards) for both backends at atol 1e-5, and the fused route
    against the JAX fused route (4 shards) at rtol 1e-4, atol 1e-6."""
    jsc, _, _, _, outs = dp_run
    cfg = jrt.RenderConfig(**DP_KW)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    g_jnp = jax.jit(jax.grad(jpar.image_loss),
                    static_argnames=("cfg", "mesh"))(
        jsc, target, cfg, jpar.make_mesh(dp=8, tp=1))
    g_pallas = jax.jit(jax.grad(jpar.image_loss),
                       static_argnames=("cfg", "mesh", "backend"))(
        jsc, target, cfg, jpar.make_mesh(dp=4, tp=1), backend="pallas")
    for name in ("light_pos", "tri_v0", "tri_rgb", "camera_pos"):
        for backend in ("auto", "torch"):
            np.testing.assert_allclose(
                outs[0][f"grad_{backend}_{name}"],
                np.asarray(getattr(g_jnp, name)), atol=1e-5, err_msg=name)
    for name in ("light_pos", "light_color", "tri_v0", "tri_rgb",
                 "camera_pos", "yaw"):
        np.testing.assert_allclose(
            outs[0][f"grad_auto_{name}"], np.asarray(getattr(g_pallas, name)),
            rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.abs(outs[0]["grad_auto_light_pos"]).max() > 0
    assert np.abs(outs[0]["grad_auto_tri_rgb"]).max() > 0


def test_dp_grads_match_own_single_device(dp_run):
    _, tsc, cfg, _, outs = dp_run
    black = torch.zeros((cfg.height, cfg.width, 3))
    for backend in ("auto", "torch"):
        loss, grads = torch_rank_jobs.loss_grads(tsc, black, cfg, None,
                                                 backend)
        np.testing.assert_allclose(outs[0][f"loss_{backend}"], loss,
                                   rtol=1e-6)
        for name in GRAD_LEAVES:
            np.testing.assert_allclose(
                outs[0][f"grad_{backend}_{name}"], grads[name].numpy(),
                rtol=1e-5, atol=1e-6, err_msg=f"{backend} {name}")
            for r in range(1, 4):
                np.testing.assert_array_equal(
                    outs[r][f"grad_{backend}_{name}"],
                    outs[0][f"grad_{backend}_{name}"])


def test_train_step_on_mesh_reduces_loss(dp_run):
    _, tsc, cfg, target, outs = dp_run
    losses = outs[0]["train_losses"]
    assert losses[-1] < losses[0]
    # the light moved toward the target x = 0.3
    assert outs[0]["trained_light_pos"][0] > 0.02
    # every rank ends with the same scene
    for r in range(1, 4):
        for k in scene_to_numpy(tsc):
            np.testing.assert_array_equal(outs[r][f"trained_{k}"],
                                          outs[0][f"trained_{k}"])
    # and it is the single-device trainer's scene
    live = tsc
    for i in range(5):
        live, loss = tpar.train_step(live, target, cfg, lr=0.5,
                                     trainable=("light_pos",))
        np.testing.assert_allclose(losses[i], loss.item(), rtol=1e-5)
    np.testing.assert_allclose(outs[0]["trained_light_pos"],
                               live.light_pos.numpy(), rtol=1e-5, atol=1e-6)


def test_train_step_on_mesh_runs_eagerly(dp_run):
    """A step on a mesh of several ranks is never captured: every rank
    counts its five steps as eager."""
    outs = dp_run[-1]
    for r in range(4):
        assert outs[r]["train_kinds"].tolist() == [5, 0, 0]


def test_fit_on_mesh(dp_run):
    _, tsc, cfg, target, outs = dp_run
    fitted, losses = tpar.fit(tsc, target, cfg, steps=2,
                              lrs={"light_pos": 2e-2})
    np.testing.assert_allclose(outs[0]["fit_losses"], losses, rtol=1e-5)
    for r in range(4):
        np.testing.assert_allclose(outs[r]["fit_light_pos"],
                                   fitted.light_pos.numpy(), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# one process: no mesh, the 1x1 mesh, argument checks
# --------------------------------------------------------------------------

def test_no_mesh_and_unit_mesh_are_render_image():
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(**TP_KW)
    unit = tpar.make_mesh(devices=CPU)
    assert (unit.dp, unit.tp, unit.world) == (1, 1, 1)
    assert unit.dp_group is None and unit.tp_group is None
    assert tpar.global_mesh.__name__ == "global_mesh"
    black = torch.zeros((cfg.height, cfg.width, 3))
    for backend in ("auto", "torch"):
        with torch.no_grad():
            ref = trt.render_image(sc, cfg, backend=backend)
            for mesh in (None, unit):
                img = tpar.render_image_sharded(sc, cfg, mesh,
                                                backend=backend)
                assert torch.equal(img, ref)
        _, g_none = torch_rank_jobs.loss_grads(sc, black, cfg, None, backend)
        _, g_unit = torch_rank_jobs.loss_grads(sc, black, cfg, unit, backend)
        for k in GRAD_LEAVES:
            assert torch.equal(g_none[k], g_unit[k]), k


def test_render_image_sharded_argument_checks():
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(**TP_KW)
    with pytest.raises(TypeError, match="mesh"):
        tpar.render_image_sharded(sc, cfg, "dp")
    two_dp = tmesh.Mesh(dp=3, tp=1, dp_index=0, tp_index=0,
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        tpar.render_image_sharded(sc, cfg, two_dp)
    four_tp = tmesh.Mesh(dp=1, tp=4, dp_index=0, tp_index=0,
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pad_triangles"):
        tpar.render_image_sharded(sc, cfg, four_tp)      # 26 triangles
    on_card = tmesh.Mesh(dp=2, tp=1, dp_index=0, tp_index=0,
                         device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="scene is on cpu"):
        tpar.render_image_sharded(sc, cfg, on_card)
    with pytest.raises(ValueError, match="unknown backend"):
        tpar.render_image_sharded(sc, cfg, None, backend="pallas")


def test_padding_is_invisible():
    sc = trt.cornell_box(device="cpu")
    padded = tpar.pad_triangles(sc, 16)         # 26 -> 32, degenerate pad
    assert padded.num_triangles == 32
    assert tpar.pad_triangles(sc, 13) is sc
    jpad = jpar.pad_triangles(jrt.cornell_box(), 16)
    for k, v in scene_to_numpy(padded).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jpad, k)), k)
    cfg = trt.RenderConfig(width=32, height=32, aa_x=2, aa_y=2,
                           shadow_samples=4, bounces=3)
    with torch.no_grad():
        for backend in ("auto", "torch"):
            np.testing.assert_allclose(
                trt.render_image(padded, cfg, backend=backend).numpy(),
                trt.render_image(sc, cfg, backend=backend).numpy(), atol=1e-6)


def test_select_devices_and_make_mesh_errors(monkeypatch, capsys):
    """RAYTPU_DEVICES indexes the CUDA devices torch sees: the range and
    duplicate errors of the JAX package's ``select_devices``."""
    n = torch.cuda.device_count()
    monkeypatch.setenv("RAYTPU_DEVICES", str(n + 5))
    with pytest.raises(ValueError, match="out of range"):
        tpar.select_devices()
    with pytest.raises(ValueError, match="out of range"):
        tpar.make_mesh()
    assert tmesh.parse_device_spec("0, 2,1", 3) == [0, 2, 1]
    with pytest.raises(ValueError, match="duplicate device indices \\[0\\]"):
        tmesh.parse_device_spec("0,0", 4)
    with pytest.raises(ValueError, match="out of range"):
        tmesh.parse_device_spec("-1", 4)
    monkeypatch.delenv("RAYTPU_DEVICES")
    assert tpar.select_devices() == [torch.device("cuda", i)
                                     for i in range(n)]
    tpar.select_devices(verbose=True)
    assert ("device 0" in capsys.readouterr().out) == (n > 0)
    if n == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_mesh()
    # one process cannot be a 2x1 mesh
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tpar.make_mesh(dp=2, devices=CPU)
    with pytest.raises(ValueError, match="needs 0 processes"):
        tpar.make_mesh(tp=2, devices=CPU)


def test_transport_is_chosen_from_the_devices_alone():
    assert multihost.transport(4, 4) == "nccl"
    assert multihost.transport(4, 8) == "nccl"
    assert multihost.transport(2, 1) == "gloo"     # ranks sharing one card
    assert multihost.transport(4, 0) == "gloo"     # CPU ranks


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    for fn in (collectives.pmin, collectives.pmax, collectives.psum):
        assert fn(x, None) is x
    assert collectives.gather_rows(x, None, 0) is x
    assert collectives.replicate([x], 1) == (x,)
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# several processes: the collectives, a failing rank, the rendezvous
# --------------------------------------------------------------------------

def test_collectives_values_and_transposes(tmp_path):
    multihost.spawn_ranks(torch_rank_jobs.collectives_job, 4,
                          f"file://{tmp_path}/store", (str(tmp_path),),
                          timeout_s=60)
    assert all(os.path.exists(tmp_path / f"ok{r}") for r in range(4))


def test_failing_rank_fails_the_run(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        multihost.spawn_ranks(torch_rank_jobs.fail_on_rank_one, 2,
                              f"file://{tmp_path}/store", timeout_s=60)
    assert time.monotonic() - t0 < 45


def test_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("RAYTPU_COORDINATOR", raising=False)
    assert tpar.initialize_multihost() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="number of processes"):
        tpar.initialize_multihost("127.0.0.1:9")


def test_rendezvous_with_dead_coordinator_fails_fast(monkeypatch):
    """A rank whose coordinator is absent gets the module's diagnostic
    RuntimeError within the time limit it was given."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RAYTPU_COORDINATOR", f"127.0.0.1:{port}")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rendezvous failed after 3s"):
        tpar.initialize_multihost(num_processes=2, process_id=1, timeout_s=3)
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the CLI: --devices, animate, sweep
# --------------------------------------------------------------------------

def test_cli_devices(monkeypatch, tmp_path, capsys):
    # the CLI stashes --devices in the environment; monkeypatch restores it
    monkeypatch.setenv("RAYTPU_DEVICES", "")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="out of range"):
        cli.main(["render", "--width", "8", "--devices", str(n + 5),
                  "-o", str(tmp_path / "f.bmp")])
    assert os.environ["RAYTPU_DEVICES"] == str(n + 5)
    with pytest.raises(ValueError, match="out of range"):   # on every subcommand
        cli.main(["sweep", "--width", "8", "--devices", f"0,{n + 5}"])
    # --device cpu asks for the CPU whatever --devices lists
    out = tmp_path / "g.bmp"
    cli.main(["render", "--width", "8", "--devices", "0", "--device", "cpu",
              "-o", str(out)])
    assert out.exists() and "(cpu)" in capsys.readouterr().out


def test_cli_animate(tmp_path, capsys):
    outdir = str(tmp_path / "frames")
    cli.main(["animate", "--width", "64", "--height", "8", "--frames", "3",
              "--device", "cpu", "-o", outdir])
    files = sorted(os.listdir(outdir))
    assert files == ["frame_0000.bmp", "frame_0001.bmp", "frame_0002.bmp"]
    assert "steady-state" in capsys.readouterr().out
    # the light moves between frames, so the frames differ
    a = open(os.path.join(outdir, files[0]), "rb").read()
    b = open(os.path.join(outdir, files[-1]), "rb").read()
    assert a[:2] == b"BM" and len(a) == 54 + 64 * 8 * 4 and a != b


def test_cli_sweep(tmp_path, capsys):
    outdir = str(tmp_path / "sweep")
    cli.main(["sweep", "--width", "64", "--height", "8", "--frames", "2",
              "--device", "cpu", "-o", outdir])
    assert sorted(os.listdir(outdir)) == ["light_000.bmp", "light_001.bmp"]
    out = capsys.readouterr().out
    assert "light_x=-0.500" in out and "light_x=+0.500" in out
