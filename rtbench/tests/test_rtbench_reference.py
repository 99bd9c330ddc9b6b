"""The frozen reference and the frozen scenes against the port's plain
versions at 16x16: the same scenes bit for bit, the same image bit for bit,
the same loss, and each leaf's gradient within 1e-5 of the port's plain
backward (autograd through its replay)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import scenes
from rtbench.reference import live
from rtbench.reference import render as ref
from uob_raytracer_tpu_torch.config import RenderConfig
from uob_raytracer_tpu_torch.debug import dense_scene
from uob_raytracer_tpu_torch.interactive import CameraController
from uob_raytracer_tpu_torch.parallel.train import TRAINABLE, image_loss
from uob_raytracer_tpu_torch.render import render_image
from uob_raytracer_tpu_torch.scene import (Scene, animate_light, cornell_box,
                                           scene_to_numpy)

CASES = {"cornell": ({"recipe": "cornell"}, dict(width=16, height=16)),
         "dense": ({"recipe": "dense", "n_tri": 300},
                   dict(width=16, height=16, shadow_samples=3, bounces=2))}


def _tensors(leaves):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            leaves.items()}


def test_scenes_match_the_port():
    want = scene_to_numpy(cornell_box(device="cpu"))
    got = scenes.build({"recipe": "cornell"}, 5)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    for seed in (1, 2**31 + 3):
        want = scene_to_numpy(dense_scene(8192, seed % 2**32, device="cpu"))
        got = scenes.build({"recipe": "dense", "n_tri": 8192}, seed)
        assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_port_plain_version(case):
    recipe, kw = CASES[case]
    t = _tensors(scenes.build(recipe, 11))
    cfg, p = RenderConfig(**kw), ref.Params(**kw)
    img = ref.render_image(t, p)
    port = Scene(**{k: v.clone() for k, v in t.items()})
    want = render_image(port, cfg, backend="torch").detach()
    assert torch.equal(img, want)
    target = img * 0.9 + 0.01
    loss, g = ref.loss_and_grads(t, target, p, TRAINABLE)
    params = {k: t[k].clone().requires_grad_(True) for k in TRAINABLE}
    live_scene = dataclasses.replace(port, **params)
    want_loss = image_loss(live_scene, target, cfg)
    grads = torch.autograd.grad(want_loss, list(params.values()))
    want_loss = float(want_loss.detach())
    assert abs(float(loss) - want_loss) <= 1e-6 * want_loss
    for k, gw in zip(TRAINABLE, grads):
        assert float((g[k] - gw).norm()) <= 1e-5 * float(gw.norm()), k


def test_band_rows_divide_the_frame():
    for kw, n_tri in ((dict(), 26), (dict(width=128, height=128), 8192)):
        p = ref.Params(**kw)
        r = ref.band_rows(p, n_tri)
        assert p.height % r == 0
        assert r * p.width * p.aa_rays * n_tri <= ref.BAND_PAIRS or r == 1


def test_viewer_follows_the_port_live_loop_state():
    keys = {"Left": {"yaw": 0.1}, "Right": {"yaw": -0.1},
            "Up": {"pitch": -0.1}, "Down": {"pitch": 0.1},
            "i": {"cam_z": 0.1}, "o": {"cam_z": -0.1},
            "k": {"cam_x": 0.1}, "j": {"cam_x": -0.1}}
    leaves = scenes.build({"recipe": "cornell"}, 0)
    v = live.Viewer(leaves, keys)
    ctl = CameraController(cam_z=float(leaves["camera_pos"][2]))
    x, lor = float(leaves["light_pos"][0]), True
    rng = np.random.default_rng(4)
    for _ in range(300):
        k = list(keys)[rng.integers(len(keys))]
        v.frame(k)
        ctl.key(k)
        x, lor = animate_light(x, lor)
        assert (v.light_x, v.left) == (x, lor)
        assert (v.cam["yaw"], v.cam["pitch"], v.cam["cam_x"],
                v.cam["cam_z"]) == (ctl.yaw, ctl.pitch, ctl.cam_x, ctl.cam_z)
