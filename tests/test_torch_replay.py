"""Port tests: the decision record and the path replay
(``uob_raytracer_tpu_torch/ops/replay.py`` and the record-keeping plain
forward of ``kernels/render_fwd.py``) against the JAX package's, on the
CPU. The JAX kernel runs in Pallas interpret mode, as its own tests run it.

Tolerances: ids and lit counts may differ on at most 0.5% of rays (the
image budget's boundary pixels: the two forwards round differently at
silhouettes); the replayed image within 2e-5 of the JAX replay and of the
forward image (5e-4 with Fresnel, as tests/test_replay.py); gradients leaf
by leaf as max|a-b| / max(max|ref|, 1) within 1e-4, and within 0.15 on the
glass interior at two and more bounces (the double refraction there is
ill-conditioned in float32, tests/test_bwd_kernel.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import scene as jscene
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res as j_fused_res
from uob_raytracer_tpu.ops import replay as jreplay
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops import replay as treplay
from uob_raytracer_tpu_torch.scene import scene_from_numpy

BASE = dict(width=128, height=16, shadow_samples=4)
MODES = {
    "default": dict(bounces=6),
    "bounces0": dict(bounces=0),
    "quirk_nan_tir": dict(bounces=3, quirk_nan_tir=True),
    "fresnel4": dict(bounces=4, fresnel=True),
    "cpu_ref": dict(cpu_ref=True),
    "no_spheres": dict(bounces=2),
    "row_band": dict(bounces=2, aa_x=1),
}


def _case(mode):
    """(torch scene, JAX scene, torch cfg, JAX cfg, row0, rows)."""
    kw = {**BASE, **MODES[mode]}
    leaves = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jrt.cornell_box(spheres=mode != "no_spheres", as_numpy=True)).items()}
    row0, rows = (8, 8) if mode == "row_band" else (None, None)
    return (scene_from_numpy(leaves, "cpu"),
            jscene.Scene(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            trt.RenderConfig(**kw), jrt.RenderConfig(**kw), row0, rows)


def _jax_record(jsc, cfg_j, row0, rows):
    kw = {} if row0 is None else dict(row0=jnp.int32(row0), rows=rows)
    return j_fused_res(jsc, cfg_j, interpret=True, **kw)


def _leafwise(ref, got):
    """{leaf: max|a-b| / max(max|ref|, 1)} over the non-empty leaves."""
    out = {}
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).detach().numpy()
        assert a.shape == b.shape, f.name
        if a.size:
            assert np.isfinite(b).all(), f.name
            out[f.name] = np.abs(a - b).max() / max(np.abs(a).max(), 1.0)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_record_matches_jax_kernel(mode):
    tsc, jsc, cfg_t, cfg_j, row0, rows = _case(mode)
    _, _, jres = _jax_record(jsc, cfg_j, row0, rows)
    img, packed, res = tfwd.render_fused_res_plain(
        tsc, cfg_t, 0 if row0 is None else row0, rows)
    A, B = cfg_t.aa_rays, cfg_t.bounces
    H = cfg_t.height if rows is None else rows
    T, S = tsc.num_triangles, tsc.num_spheres
    # shapes, types and ranges (tests/test_replay.py:31-43)
    assert res.prim_id.shape == (A, H, 128) and res.prim_id.dtype == torch.int32
    assert res.lit_cnt.shape == (A, H, 128) and res.lit_cnt.dtype == torch.float32
    assert res.bounce_id.shape == (B, A, H, 128)
    assert res.bounce_id.dtype == torch.int32
    assert res.prim_id.min() >= -1 and res.prim_id.max() < T + S
    assert res.lit_cnt.min() >= 0 and res.lit_cnt.max() <= cfg_t.shadow_samples
    if B and S:   # specular primaries exist and leave bounce records
        assert (res.bounce_id[0] >= 0).any()
    # the record-keeping forward renders the plain version's frame
    assert torch.equal(img, tfwd.render_fused_plain(
        tsc, cfg_t, 0 if row0 is None else row0, rows)[0])

    pid_j = np.asarray(jres.prim_id)
    pid_t = res.prim_id.numpy()
    assert (pid_j != pid_t).mean() <= 0.005
    if B:
        assert (np.asarray(jres.bounce_id) != res.bounce_id.numpy()).mean() <= 0.005
    # lit where the ray shades: primary-diffuse rays, and rays this record
    # saw lit (elsewhere the JAX kernel scans a dummy point)
    mat = np.concatenate([tsc.tri_mat.numpy(), tsc.sph_mat.numpy(), [0.0]])
    shades = (((pid_t >= 0) & (mat[pid_t] > 0)) if not cfg_t.cpu_ref
              else pid_t >= 0) | (res.lit_cnt.numpy() > 0)
    assert shades.any()
    lit_differs = (np.asarray(jres.lit_cnt) != res.lit_cnt.numpy()) & shades
    assert lit_differs.sum() <= 0.005 * shades.sum()


def test_wrapper_on_cpu_records_with_plain_version():
    tsc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=8, shadow_samples=2, bounces=2)
    before = tfwd.LAUNCHES
    img, packed, res = tfwd.render_fused_res(tsc, cfg, row0=2, rows=4)
    assert tfwd.LAUNCHES == before
    ref = tfwd.render_fused_res_plain(tsc, cfg, 2, 4)
    assert torch.equal(img, ref[0])
    assert all(torch.equal(a, b) for a, b in zip(res, ref[2]))
    with pytest.raises(ValueError, match="outside"):
        tfwd.render_fused_res(tsc, cfg, row0=6, rows=4)


def test_residuals_cross_numpy():
    """A JAX record feeds the port and the port's record feeds JAX."""
    tsc, jsc, cfg_t, cfg_j, _, _ = _case("fresnel4")
    _, _, jres = _jax_record(jsc, cfg_j, None, None)
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    assert [t.dtype for t in res] == [torch.int32, torch.float32, torch.int32]
    back = treplay.residuals_to_numpy(res)
    for a, b in zip(back, jres):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the port's own record through the JAX replay reproduces its frame
    img, _, tres = tfwd.render_fused_res_plain(tsc, cfg_t)
    jrec = jreplay.Residuals(*(jnp.asarray(x)
                               for x in treplay.residuals_to_numpy(tres)))
    rep = jreplay.replay_forward(jsc, cfg_j, jrec)
    np.testing.assert_allclose(np.asarray(rep), img.numpy(), atol=5e-4)


@pytest.mark.parametrize("mode", ["default", "fresnel4", "cpu_ref", "row_band"])
def test_replay_forward_matches_jax(mode):
    tsc, jsc, cfg_t, cfg_j, row0, rows = _case(mode)
    jimg, _, jres = _jax_record(jsc, cfg_j, row0, rows)
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    rep = treplay.replay_forward(tsc, cfg_t, res, row0, rows)
    kw = {} if row0 is None else dict(row0=jnp.int32(row0), rows=rows)
    jrep = jreplay.replay_forward(jsc, cfg_j, jres, **kw)
    assert rep.shape == jrep.shape
    np.testing.assert_allclose(rep.numpy(), np.asarray(jrep), atol=2e-5)
    np.testing.assert_allclose(rep.numpy(), np.asarray(jimg),
                               atol=5e-4 if cfg_t.fresnel else 2e-5)


def _replay_grads(tsc, jsc, cfg_t, cfg_j, jres, g, row0, rows):
    from uob_raytracer_tpu_torch.kernels.render_bwd import render_replay_bwd_plain
    kw = {} if row0 is None else dict(row0=jnp.int32(row0), rows=rows)
    _, vjp = jax.vjp(lambda s: jreplay.replay_forward(s, cfg_j, jres, **kw), jsc)
    (ref,) = vjp(jnp.asarray(g))
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    got = render_replay_bwd_plain(tsc, cfg_t, res, torch.from_numpy(g), row0, rows)
    return _leafwise(ref, got)


@pytest.mark.parametrize("mode,kw", [
    ("bounces0", {}), ("default", dict(bounces=1)), ("fresnel4", dict(bounces=2)),
    ("quirk_nan_tir", {}), ("cpu_ref", {}), ("row_band", dict(bounces=1)),
])
def test_replay_gradients_match_jax(mode, kw):
    """All 15 leaf gradients of the port's replay against jax.vjp of the
    JAX replay, on the JAX kernel's record and the same seeded cotangent."""
    tsc, jsc, cfg_t, cfg_j, row0, rows = _case(mode)
    cfg_t = dataclasses.replace(cfg_t, **kw)
    cfg_j = dataclasses.replace(cfg_j, **kw)
    jimg, _, jres = _jax_record(jsc, cfg_j, row0, rows)
    g = np.random.RandomState(0).standard_normal(jimg.shape).astype(np.float32)
    if cfg_t.bounces >= 2:
        # exact away from the glass interior; the conditioning budget on
        # the double-refraction pixels
        glass = (np.asarray(jres.bounce_id) >= tsc.num_triangles).any(axis=(0, 1))
        errs = _replay_grads(tsc, jsc, cfg_t, cfg_j, jres,
                             g * ~glass[:, :, None], row0, rows)
        assert max(errs.values()) <= 1e-4, errs
        errs = _replay_grads(tsc, jsc, cfg_t, cfg_j, jres, g, row0, rows)
        assert max(errs.values()) <= 0.15, errs
    else:
        errs = _replay_grads(tsc, jsc, cfg_t, cfg_j, jres, g, row0, rows)
        assert max(errs.values()) <= 1e-4, errs
    assert len(errs) == 15
