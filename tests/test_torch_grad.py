"""Port tests: gradients of the port's renderer against central finite
differences — the cases of ``tests/test_grad.py`` with their epsilons and
tolerances (rel 0.02-0.25, camera 0.1) — on both backends: the fused path
('auto' on a CPU scene: the plain versions of K1r and K2, i.e. autograd
through the replay) and the plain pipeline ('torch'). Visibility is
piecewise constant, so the defined gradient is the interior/shading
gradient; the losses are mean-pooled and weighted so boundary flips stay in
the noise (SURVEY.md §7). The autodiff gradients are also held to the JAX
package's ``jax.grad`` of the same loss on the same scene."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.render import render_image as j_render_image
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.ops.camera import gen_primary_rays
from uob_raytracer_tpu_torch.ops.intersect import (
    _sphere_roots, in_shadow, intersect, prepare_scene)
from uob_raytracer_tpu_torch.ops.math3 import dot3
from uob_raytracer_tpu_torch.ops.rng import crush, shadow_seed, xorshift

CFG = trt.RenderConfig(width=24, height=24, aa_x=1, aa_y=1, shadow_samples=2,
                       bounces=2)
J_CFG = jrt.RenderConfig(width=24, height=24, aa_x=1, aa_y=1,
                         shadow_samples=2, bounces=2)
BACKENDS = ["auto", "torch"]
LEAVES = tuple(f.name for f in dataclasses.fields(trt.Scene))
# (field, idx, eps, rtol): tests/test_grad.py:43-50
FD_CASES = [
    ("light_pos", (0,), 1e-3, 0.08),
    ("light_pos", (1,), 1e-3, 0.08),
    ("light_color", (1,), 1e-2, 0.02),
    ("tri_rgb", (9, 2), 1e-2, 0.02),       # back wall blue channel: linear
    ("indirect_light", (0,), 1e-2, 0.02),
    ("tri_v0", (9, 0), 1e-3, 0.25),        # vertex: shading grad only
]


def _weights(shape):
    # the JAX test's weights, in float32 from the same formula
    w = np.linspace(0.5, 1.5, int(np.prod(shape)), dtype=np.float32)
    return w.reshape(shape)


def _loss(scene, backend, cfg=CFG):
    img = trt.render_image(scene, cfg, chunk_rows=cfg.height,
                           backend=backend)
    # mean-pooled scalar; weights break symmetry so gradients are generic
    return torch.mean(img * torch.from_numpy(_weights(tuple(img.shape))))


def _grads(scene, loss_fn):
    """d loss / d every leaf, as a dict. The plain pipeline reads the
    material codes only in comparisons, so autograd leaves their gradient
    None: zeros, as jax.grad and the fused path give."""
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in LEAVES}
    loss_fn(dataclasses.replace(scene, **leaves)).backward()
    none = {k for k, v in leaves.items() if v.grad is None}
    assert none <= {"tri_mat", "sph_mat"}, none
    return {k: torch.zeros_like(v) if v.grad is None else v.grad
            for k, v in leaves.items()}


def _set_at(scene, field, idx, val):
    arr = getattr(scene, field).clone()
    arr[idx] = val
    return dataclasses.replace(scene, **{field: arr})


@pytest.fixture(scope="module")
def scene():
    return trt.cornell_box(device="cpu")


@pytest.fixture(scope="module")
def auto_grads(scene):
    """The autodiff gradient of the weighted loss, per backend."""
    return {b: _grads(scene, lambda s, b=b: _loss(s, b)) for b in BACKENDS}


@pytest.fixture(scope="module")
def jax_grads():
    def loss(s):
        img = j_render_image(s, J_CFG, chunk_rows=J_CFG.height,
                             backend="jnp")
        return jnp.mean(img * jnp.asarray(_weights(img.shape)))
    g = jax.grad(loss)(jrt.cornell_box())
    return {k: np.asarray(getattr(g, k)) for k in LEAVES}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("field,idx,eps,rtol", FD_CASES)
def test_autodiff_matches_fd(scene, auto_grads, jax_grads, backend, field,
                             idx, eps, rtol):
    auto = float(auto_grads[backend][field][idx])
    with torch.no_grad():
        base = float(getattr(scene, field)[idx])
        lp = float(_loss(_set_at(scene, field, idx, base + eps), backend))
        lm = float(_loss(_set_at(scene, field, idx, base - eps), backend))
    fd = (lp - lm) / (2 * eps)
    assert np.isfinite(auto)
    # the same autodiff gradient as the JAX package's, to float32 noise
    assert auto == pytest.approx(float(jax_grads[field][idx]), rel=1e-3,
                                 abs=1e-7), (field, idx)
    if abs(fd) < 1e-7 and abs(auto) < 1e-7:
        return
    assert auto == pytest.approx(fd, rel=rtol, abs=1e-6), (field, idx)


@pytest.mark.parametrize("backend", BACKENDS)
def test_camera_grad_matches_fd_on_stable_pixels(scene, backend):
    """Moving the camera shifts every visibility boundary, so a plain FD of
    the mean image is dominated by edge flips. The FD comparison masks to
    pixels whose primary hit object and shadow-sample occlusion are stable
    at -eps, 0 and +eps (tests/test_grad.py:66-126), on diffuse hits; the
    loss is the masked frame of ``render_image`` at 0 bounces."""
    cfg = trt.RenderConfig(width=24, height=24, aa_x=1, aa_y=1,
                           shadow_samples=1, bounces=0)
    eps = 1e-3

    def moved(s, dz):
        return dataclasses.replace(
            s, camera_pos=s.camera_pos + torch.tensor([0.0, 0.0, dz]))

    @torch.no_grad()
    def state_at(dz):
        """(obj ids, shadow-sample occlusion, diffuse hit) at a camera z
        offset: the discrete decisions whose flips make plain FD
        meaningless."""
        ds = prepare_scene(moved(scene, dz))
        dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch)
        d = dirs.reshape(-1, 3)
        start = ds.camera_pos.expand(d.shape[0], 3)
        h = intersect(ds, start, d)
        sdir = ds.light_pos[None] - h.pos
        sstart = h.pos + float(np.float32(cfg.bias)) * sdir
        r2 = dot3(sdir, sdir)
        st = xorshift(shadow_seed(gid.reshape(-1)))
        occ = in_shadow(ds, sstart, sdir + crush(st, cfg.light_spread), r2)
        return h.obj_id, occ, h.hit & (h.mat > 0)

    i_m, o_m, _ = state_at(-eps)
    i_0, o_0, diffuse = state_at(0.0)
    i_p, o_p, _ = state_at(eps)
    stable = ((i_m == i_0) & (i_0 == i_p) & (o_m == o_0) & (o_0 == o_p)
              & diffuse)
    mask = stable.reshape(cfg.height, cfg.width, 1).float()
    assert stable.float().mean() > 0.5

    def masked_loss(s):
        return torch.mean(trt.render_image(s, cfg, backend=backend) * mask)

    auto = float(_grads(scene, masked_loss)["camera_pos"][2])
    with torch.no_grad():
        fd = (float(masked_loss(moved(scene, eps)))
              - float(masked_loss(moved(scene, -eps)))) / (2 * eps)
    assert auto == pytest.approx(fd, rel=0.1, abs=1e-6)


def _assert_grads_finite(scene, cfg, backend):
    g = _grads(scene, lambda s: torch.mean(trt.render_image(
        s, cfg, chunk_rows=16, backend=backend)))
    for k, v in g.items():
        assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_grads_finite_everywhere(scene, backend):
    """Full-feature config incl. spheres, bounces, fresnel: no NaN/inf
    gradient on any leaf."""
    _assert_grads_finite(scene, trt.RenderConfig(
        width=16, height=16, shadow_samples=3, bounces=4, fresnel=True),
        backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quirk_mode_grads_finite(scene, backend):
    """The reference's NaN-TIR quirk mode: no NaN/inf gradient either."""
    _assert_grads_finite(scene, trt.RenderConfig(
        width=16, height=16, shadow_samples=2, bounces=3,
        quirk_nan_tir=True), backend)


def test_tangent_ray_sphere_grads_finite(scene):
    """An exact-tangent sphere hit (disc == 0) leaks no sqrt'(0) = inf into
    the sphere-quadratic gradients (tests/test_grad.py:151-177)."""
    sc = dataclasses.replace(
        scene, sph_center=torch.tensor([[1.0, 0.0, 0.0]]),
        sph_r2=torch.tensor([1.0], requires_grad=True),
        sph_rgb=torch.ones((1, 3)), sph_mat=torch.ones((1,)))
    start = torch.tensor([[0.0, 0.0, -2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    xmin, _, no_sol = _sphere_roots(prepare_scene(sc), start, d)
    v = torch.sum(torch.where(no_sol, 0.0, xmin))
    v.backward()
    assert torch.isfinite(v) and torch.isfinite(sc.sph_r2.grad).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_vertex_grad_flows_through_normals(auto_grads, backend):
    """Moving a wall vertex changes its normal and thus the Lambert term:
    the vertex gradient is nonzero even for rays that keep hitting the same
    triangle."""
    g = auto_grads[backend]
    assert float(g["tri_v0"].abs().max()) > 1e-6
    assert float(g["tri_v1"].abs().max()) > 1e-6
