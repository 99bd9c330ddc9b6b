"""Port tests: ``uob_raytracer_tpu_torch.debug`` — the counterpart of
``tests/test_checkify.py`` (NaN checks over the forward and the backward,
and a seeded NaN that must be reported), the kernel launch list and the
compute-sanitizer runner. The NaN-checked frames are held to the JAX
package's jnp render through ``assert_images_match``."""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.render import render_image as j_render_image
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import debug
from conftest import assert_images_match

# tests/test_checkify.py:20
CFG = trt.RenderConfig(width=64, height=16, aa_x=2, aa_y=2, shadow_samples=3,
                       bounces=3)
J_CFG = jrt.RenderConfig(width=64, height=16, aa_x=2, aa_y=2,
                         shadow_samples=3, bounces=3)
# 'torch': the plain pipeline under plain autograd; 'auto' on a CPU scene:
# the fused path's plain versions (the record-keeping forward, autograd
# through the replay for the backward)
BACKENDS = ["torch", "auto"]
GRAD_LEAVES = ("light_pos", "light_color", "tri_v0", "tri_rgb", "sph_center",
               "sph_r2", "camera_pos", "yaw")


@pytest.fixture(scope="module")
def jax_image():
    return np.asarray(j_render_image(jrt.cornell_box(), J_CFG, backend="jnp"))


def _scene(grad: bool, device="cpu"):
    scene = trt.cornell_box(device=device)
    if not grad:
        return scene
    return dataclasses.replace(scene, **{
        k: getattr(scene, k).clone().requires_grad_(True)
        for k in GRAD_LEAVES})


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_nan_checks_clean(backend, jax_image):
    """The forward under the NaN checks raises nothing, and the mode
    changes nothing: the frame matches the JAX package's."""
    with debug.nan_checks() as mode:
        img = trt.render_image(_scene(False), CFG, backend=backend)
    assert mode.checked > 100
    assert torch.isfinite(img).all()
    assert_images_match(img.numpy(), jax_image, what=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backward_nan_checks_clean(backend):
    """Forward and backward under the NaN checks: nothing raises, every
    gradient is finite (the double-where guards keep inf * 0 out of the
    cotangents), and the mode saw the backward's operations, which the
    autograd engine runs outside the forward's frame."""
    scene = _scene(True)
    with debug.nan_checks():
        loss = trt.render_image(scene, CFG, backend=backend).mean()
    with debug.nan_checks() as mode:
        loss.backward()
    assert mode.checked > 0
    assert any(name.endswith("_backward") for name in mode.ops), mode.ops
    for k in GRAD_LEAVES:
        g = getattr(scene, k).grad
        assert g is not None and torch.isfinite(g).all(), k
    assert float(scene.light_pos.grad.abs().max()) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_checks_catch_seeded_nan(backend):
    """The checks fire: a NaN smuggled into the scene is reported, not
    silently propagated into a black pixel."""
    scene = _scene(False)
    light = scene.light_pos.clone()
    light[0] = float("nan")
    bad = dataclasses.replace(scene, light_pos=light)
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        with debug.nan_checks():
            trt.render_image(bad, CFG, backend=backend)


def test_nan_checks_flag_nan_only():
    """Infinities pass (a miss is t = inf by design), NaN raises, and the
    uninitialised output of an allocation is not looked at."""
    x = torch.tensor([1.0, 0.0])
    with debug.nan_checks() as mode:
        inf = x[:1] / 0.0 + 1.0
        torch.empty(4).fill_(1.0)
        assert torch.isinf(inf).all()
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
    assert "empty" not in mode.ops and mode.ops["fill_"] == 1


def test_nan_checks_skip_views():
    """A view computes nothing: a slice of memory a kernel has yet to fill
    (the streamed backward's per-site rows, zeroed band by band) passes,
    and so does zeroing it; an operation that reads the NaN raises."""
    buf = torch.full((6, 4), float("nan"))    # made outside the mode
    with debug.nan_checks() as mode:
        band = buf[:4]
        buf.view(-1)
        band.zero_()
        assert float(band.sum()) == 0.0
        with pytest.raises(FloatingPointError, match="aten.add"):
            buf + 1.0
    assert "slice" not in mode.ops and "view" not in mode.ops


# --------------------------------------------------------------------------
# The launch list and the sanitizer runner
# --------------------------------------------------------------------------

def test_launch_list_covers_every_counter():
    """Every launch counter of the kernel modules is in the launch list's
    count, and the list runs through on the CPU (the plain versions,
    which count nothing)."""
    names = set()
    for mod in ("bwd_twin", "partial", "peak", "render_bwd", "render_fwd"):
        m = importlib.import_module(f"uob_raytracer_tpu_torch.kernels.{mod}")
        names |= {(mod, k) for k, v in vars(m).items()
                  if k.endswith("LAUNCHES") and isinstance(v, int)}
    assert len(names) == 13 == len(debug.launch_counts())
    counts = debug.launch_all("cpu", size=8)
    assert counts == {k: 0 for k in debug.launch_counts()}


def test_main_nan_check_cpu(capsys):
    """``python -m uob_raytracer_tpu_torch.debug --nan-check --device cpu``:
    the whole launch list (plain versions) under the NaN checks finds no
    NaN and reports how many outputs it looked at."""
    debug.main(["--nan-check", "--device", "cpu", "--size", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["size"] == 16
    assert out["nan_checked_outputs"] > 1000
    assert out["launches"] == {k: 0 for k in debug.launch_counts()}


def test_main_nan_check_exits_on_nan(monkeypatch):
    """A NaN anywhere in the launch list ends the run with a non-zero
    exit naming the operation."""
    def poisoned(device, size):
        torch.log(torch.tensor([-1.0], device=device))
        return debug.launch_counts()
    monkeypatch.setattr(debug, "launch_all", poisoned)
    with pytest.raises(SystemExit, match="NaN check failed: NaN in the "
                                         "output of aten.log"):
        debug.main(["--nan-check", "--device", "cpu"])


REPORT_CLEAN = """========= COMPUTE-SANITIZER
launches ...
========= ERROR SUMMARY: 0 errors
"""
REPORT_RACES = """========= COMPUTE-SANITIZER
========= Error: Race reported between Write access at render_bwd_kernel
=========     and Read access at render_bwd_kernel [128 hazards]
========= RACECHECK SUMMARY: 2 hazards displayed (2 errors, 0 warnings)
"""
REPORT_REFUSED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
========= ERROR SUMMARY: 3 errors
"""


@pytest.mark.parametrize("text,want", [
    (REPORT_CLEAN, {"errors": 0, "hazards": 0, "unsupported": False}),
    (REPORT_RACES, {"errors": 0, "hazards": 2, "unsupported": False}),
    (REPORT_REFUSED, {"errors": 3, "hazards": 0, "unsupported": True}),
])
def test_parse_report(text, want):
    assert debug.parse_report(text) == want


def test_sanitizer_command(monkeypatch):
    """The command runs the launch list under the tool, checking the
    port's kernels only; an unknown tool raises."""
    from uob_raytracer_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "tool", lambda name: f"/toolkit/bin/{name}")
    cmd = debug.sanitizer_command("racecheck")
    assert cmd[:3] == ["/toolkit/bin/compute-sanitizer", "--tool",
                       "racecheck"]
    assert cmd[-3:] == ["-m", "uob_raytracer_tpu_torch.debug", "--launch-all"]
    filters = [c for c in cmd if c.startswith("--kernel-name=")]
    assert filters == [f"--kernel-name=kns={k}"
                       for k in debug.KERNEL_SUBSTRINGS]
    with pytest.raises(ValueError, match="tool"):
        debug.sanitizer_command("leakcheck")


# --------------------------------------------------------------------------
# On the card (skip without one)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_nan_checks_see_the_backward_on_card(cuda_device, backend):
    """On a CUDA scene the autograd engine runs the backward on its device
    thread: the mode is carried there and sees its operations (the plain
    pipeline's, and the kernel path's packing and pull-back), and a clean
    frame raises nothing."""
    scene = _scene(True, cuda_device)
    with debug.nan_checks():
        loss = trt.render_image(scene, CFG, backend=backend).mean()
    with debug.nan_checks() as mode:
        loss.backward()
    assert mode.checked > 0
    assert any(name.endswith("_backward") for name in mode.ops), mode.ops
    assert torch.isfinite(scene.light_pos.grad).all()


@pytest.mark.cuda
def test_launch_all_on_card(cuda_device):
    counts = debug.launch_all(cuda_device)
    assert all(n >= 1 for n in counts.values()), counts


@pytest.mark.cuda
def test_main_nan_check_on_card(cuda_device, capsys):
    """``--nan-check`` on the card: every kernel launched under the NaN
    checks, none of the operations around them holds a NaN."""
    debug.main(["--nan-check", "--size", "32"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nan_checked_outputs"] > 0
    assert all(n >= 1 for n in out["launches"].values()), out


@pytest.mark.cuda
def test_run_sanitizer_memcheck(cuda_device):
    try:
        report = debug.run_sanitizer("memcheck")
    except debug.SanitizerUnsupported as e:
        pytest.skip(str(e))
    assert report["rc"] == 0 and report["errors"] == 0, report["text"]
