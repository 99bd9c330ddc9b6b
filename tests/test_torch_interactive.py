"""Port tests: ``uob_raytracer_tpu_torch.interactive`` (the camera controller)
and ``uob_raytracer_tpu_torch.preview`` (the live loop and its latency bench)
against the JAX package's ``interactive.py``, ``scene.animate_light`` and
``render``. The controller and the light sequence must equal the JAX
package's exactly; frames are held to ``assert_images_match`` (at most 0.5%
of pixels beyond 3e-4, none beyond 0.45)."""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.interactive import CameraController as JController
from uob_raytracer_tpu.scene import animate_light as j_animate_light
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import preview
from uob_raytracer_tpu_torch.interactive import CameraController
from conftest import assert_images_match

FIELDS = ("yaw", "pitch", "cam_x", "cam_y", "cam_z", "quit")


def test_mouse_motion_increments():
    c = CameraController()
    c.mouse_motion(100, -50)     # xrel=100 px, yrel=-50 px
    assert np.isclose(c.yaw, 100 * 0.0009)      # yaw += xrel * 0.0009
    assert np.isclose(c.pitch, 50 * 0.0009)     # pitch -= yrel * 0.0009


def test_key_increments():
    c = CameraController()
    assert c.key("Up") and np.isclose(c.pitch, -0.1)
    assert c.key("Down") and np.isclose(c.pitch, 0.0)
    assert c.key("Left") and np.isclose(c.yaw, 0.1)
    assert c.key("Right") and np.isclose(c.yaw, 0.0)
    assert c.key("i") and np.isclose(c.cam_z, -3.1)   # from -3.2
    assert c.key("o") and np.isclose(c.cam_z, -3.2)
    assert c.key("k") and np.isclose(c.cam_x, 0.1)
    assert c.key("j") and np.isclose(c.cam_x, 0.0)
    assert not c.key("w")        # unmapped (commented out in the reference)
    assert not c.quit
    assert c.key("Escape") and c.quit


def test_apply_moves_the_render():
    """The applied camera state changes the rendered image (a live loop
    re-rendering per input actually shows movement), and apply puts the
    camera on the scene's device as float32."""
    scene = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=32, aa_x=1, aa_y=1,
                           shadow_samples=1, bounces=0)
    c = CameraController()
    base = trt.render(c.apply(scene), cfg).image
    c.key("Left")
    c.key("i")
    moved = trt.render(c.apply(scene), cfg).image
    assert float((moved - base).abs().max()) > 0.01
    applied = c.apply(scene)
    assert np.isclose(float(applied.yaw), 0.1)
    assert np.isclose(float(applied.camera_pos[2]), -3.1)
    for k in ("yaw", "pitch", "camera_pos"):
        t = getattr(applied, k)
        assert t.dtype == torch.float32 and t.device == scene.device


def _events(seed: int, n: int):
    """A seeded stream of mouse motions and key presses (mapped, unmapped
    and Escape)."""
    rng = np.random.RandomState(seed)
    names = ["Up", "Down", "Left", "Right", "i", "o", "k", "j", "w",
             "Escape"]
    out = []
    for _ in range(n):
        if rng.rand() < 0.5:
            out.append(("mouse", int(rng.randint(-300, 301)),
                        int(rng.randint(-300, 301))))
        else:
            out.append(("key", names[rng.randint(len(names))]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_controller_matches_jax_on_event_stream(seed):
    """64 seeded mouse and key events through both controllers: the same
    floats after every event (exact), and apply() gives the same float32
    camera as the JAX package's."""
    ours, theirs = CameraController(), JController()
    scene_t = trt.cornell_box(device="cpu")
    scene_j = jrt.cornell_box()
    for ev in _events(seed, 64):
        if ev[0] == "mouse":
            ours.mouse_motion(ev[1], ev[2])
            theirs.mouse_motion(ev[1], ev[2])
        else:
            assert ours.key(ev[1]) == theirs.key(ev[1])
        for f in FIELDS:
            assert getattr(ours, f) == getattr(theirs, f), (ev, f)
    a_t, a_j = ours.apply(scene_t), theirs.apply(scene_j)
    for k in ("yaw", "pitch", "camera_pos"):
        np.testing.assert_array_equal(getattr(a_t, k).numpy(),
                                      np.asarray(getattr(a_j, k)))


def test_animate_light_matches_jax():
    """The light oscillation equals the JAX sequence bit for bit over its
    first 100 steps and on, through both turning points (the first flip
    comes after ~135 steps)."""
    x_t = x_j = float(np.asarray(jrt.cornell_box().light_pos)[0])
    lor_t = lor_j = True
    flips = 0
    for _ in range(400):
        x_t, lor_t = trt.animate_light(x_t, lor_t)
        x_j, new_lor = j_animate_light(x_j, lor_j)
        flips += new_lor != lor_j
        lor_j = new_lor
        assert (x_t, lor_t) == (x_j, lor_j)
    assert flips >= 2


def test_live_loop_frame_matches_jax():
    """Ticks of the live loop on the CPU (keys, light steps, the port's
    plain render at 32x32) against the same controller state and light
    sequence through the JAX package's jnp render."""
    cfg_t = trt.RenderConfig(width=32, height=32, shadow_samples=3, bounces=2)
    cfg_j = jrt.RenderConfig(width=32, height=32, shadow_samples=3, bounces=2)
    loop = preview.LiveLoop(trt.cornell_box(device="cpu"), cfg_t)
    scene_j = jrt.cornell_box()
    ctl_j = JController(cam_z=float(np.asarray(scene_j.camera_pos)[2]))
    light_x, lor = float(np.asarray(scene_j.light_pos)[0]), True
    for key in ("Left", "i", "Up"):
        loop.ctl.key(key)
        ctl_j.key(key)
        img_t = loop.tick()
        light_x, lor = j_animate_light(light_x, lor)
        s = ctl_j.apply(scene_j)
        s = dataclasses.replace(s, light_pos=s.light_pos.at[0].set(light_x))
        img_j = np.asarray(jrt.render(s, cfg_j, backend="jnp").image)
        assert img_t.shape == (32, 32, 3) and np.isfinite(img_t).all()
        assert_images_match(img_t, img_j, what=f"live loop after {key}")
    assert loop.light_x == light_x


# the keys of docs/interactive_latency_r05.json, with the fetch floor renamed
R05_KEYS = {"width", "config", "n_events", "keypress_to_frame_ms",
            "fps_at_p50", "fetch_floor_ms", "note"}


def test_latency_bench_on_cpu(capsys):
    """The headless bench at 16x16, 4 events, on the CPU: the JAX record's
    keys plus the card (none here), no device time (not measured on the
    CPU), every frame finite."""
    args = preview.parse_args(["--device", "cpu", "--latency-bench",
                               "--width", "16", "--samples", "2",
                               "--bounces", "1"])
    out = preview.latency_bench(args, events=4)
    assert R05_KEYS | {"card"} <= set(out)
    assert out["n_events"] == 4 and out["config"] == "aa4 s2 b1"
    lat = out["keypress_to_frame_ms"]
    assert set(lat) == {"p50", "p95", "min"}
    assert 0 < lat["min"] <= lat["p50"] <= lat["p95"]
    assert out["card"] is None and out["forward_device_ms"] is None
    assert out["all_frames_finite"] and out["forward_launches"] == 0
    assert set(out["host_split_ms"]) == {"quad_detect",
                                         "light_camera_pack_launch", "fetch"}
    json.dumps(out)
    assert "latency 16^2" in capsys.readouterr().out


def test_main_writes_ppm_frames_without_pillow(tmp_path, monkeypatch):
    """The GIF path without Pillow writes PPM frames, as the JAX script
    does; --show without tkinter or a display prints why and returns."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delenv("DISPLAY", raising=False)
    out = tmp_path / "anim.gif"
    preview.main(["--device", "cpu", "--width", "8", "--frames", "2",
                  "--samples", "1", "--bounces", "0", "--show",
                  "-o", str(out)])
    frames = sorted((tmp_path / "anim").iterdir())
    assert [f.name for f in frames] == ["frame_0000.ppm", "frame_0001.ppm"]
    assert frames[0].read_bytes().startswith(b"P6\n8 8\n255\n")
    assert not out.exists()
    preview.interactive_window(preview.parse_args(["--device", "cpu"]))
