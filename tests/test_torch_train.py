"""Port tests: the trainer (``uob_raytracer_tpu_torch/parallel/train.py``)
and the CLI's ``fit`` subcommand against the JAX package's, on the CPU.

The JAX trainer runs on a one-device mesh with its 'jnp' backend (full
autodiff); the port's runs with ``mesh=None`` through the fused path's
plain versions (path replay). Meshes of several ranks are in
``tests/test_torch_parallel.py``. Tolerances: losses and updated leaves of
three SGD steps within 1e-4 relative; five Adam steps within 1e-3 (Adam
divides by sqrt(v) + eps, which magnifies a gradient difference on leaves
whose gradient is near eps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import parallel as jpar
from uob_raytracer_tpu.parallel import train as jtrain
from uob_raytracer_tpu.render import render_image as j_render_image
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import cli
from uob_raytracer_tpu_torch import parallel as tpar

KW = dict(width=32, height=32, shadow_samples=3, bounces=2)
LIGHT = [0.25, -0.5, -0.7]


def _setup():
    """(torch scene, target, cfg), (JAX scene, target, cfg, mesh): the same
    problem on both sides, the target rendered by the JAX package."""
    cfg_j, cfg_t = jrt.RenderConfig(**KW), trt.RenderConfig(**KW)
    jsc = jrt.cornell_box()
    target = j_render_image(dataclasses.replace(
        jsc, light_pos=jnp.asarray(LIGHT, jnp.float32)), cfg_j, backend="jnp")
    mesh = jpar.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    tsc = trt.cornell_box(device="cpu")
    return ((tsc, torch.from_numpy(np.array(target)), cfg_t),
            (jsc, target, cfg_j, mesh))


def test_train_step_matches_jax():
    (tsc, ttarget, cfg_t), (jsc, jtarget, cfg_j, mesh) = _setup()
    for _ in range(3):
        jout = jpar.train_step(jsc, jtarget, cfg_j, mesh, lr=2.0,
                               trainable=("light_pos",))
        tout = tpar.train_step(tsc, ttarget, cfg_t, lr=2.0,
                               trainable=("light_pos",))
        assert isinstance(tout, tpar.TrainOut)
        np.testing.assert_allclose(tout.loss.item(), float(jout.loss), rtol=1e-4)
        np.testing.assert_allclose(tout.scene.light_pos.numpy(),
                                   np.asarray(jout.scene.light_pos), rtol=1e-4,
                                   atol=1e-6)
        # frozen leaves are untouched, and the step moved the light
        assert tout.scene.tri_v0 is tsc.tri_v0
        assert not torch.equal(tout.scene.light_pos, tsc.light_pos)
        assert not tout.scene.light_pos.requires_grad
        jsc, tsc = jout.scene, tout.scene


def test_fit_matches_jax():
    (tsc, ttarget, cfg_t), (jsc, jtarget, cfg_j, mesh) = _setup()
    lrs = {"light_pos": 2e-2, "tri_rgb": 2e-2}
    jfit, jlosses = jpar.fit(jsc, jtarget, cfg_j, mesh, steps=5, lrs=lrs)
    tfit, tlosses = tpar.fit(tsc, ttarget, cfg_t, steps=5, lrs=lrs)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert tlosses[-1] < tlosses[0]
    for k in lrs:
        np.testing.assert_allclose(getattr(tfit, k).numpy(),
                                   np.asarray(getattr(jfit, k)), rtol=1e-3,
                                   atol=1e-5)
    assert tfit.tri_v0 is tsc.tri_v0 and not tfit.light_pos.requires_grad


def test_trainer_constants_and_mesh():
    assert tpar.TRAINABLE == jtrain.TRAINABLE
    assert tpar.DEFAULT_LRS == jtrain.DEFAULT_LRS
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=8, height=8, shadow_samples=1, bounces=0)
    target = torch.zeros((8, 8, 3))
    for call in (lambda: tpar.image_loss(sc, target, cfg, mesh=object()),
                 lambda: tpar.train_step(sc, target, cfg, mesh="dp"),
                 lambda: tpar.fit(sc, target, cfg, mesh=(2, 1), steps=1)):
        with pytest.raises(TypeError, match="mesh"):
            call()
    with pytest.raises(ValueError, match="not Scene leaves"):
        tpar.train_step(sc, target, cfg, trainable=("light",))
    loss = tpar.image_loss(sc, target, cfg)
    assert loss.shape == () and loss > 0


def test_cli_fit(capsys):
    cli.main(["fit", "--steps", "2", "--width", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[light+color] loss" in out and "[vertices]    loss" in out
    assert "light fitted" in out and "back wall z-shift fitted" in out
    assert out.count("fit step") >= 4
