"""Port tests: the property-based invariants of ``tests/test_property.py``
(hypothesis) on the port's geometric core — ``ops/intersect.py``
(``_tri_tuv``, ``_sphere_roots``, ``intersect``), ``ops/shading.py``
(``_reflect_dir``, ``_refract_dir``) and ``ops/rng.py`` (``xorshift``) —
with the same strategies, example counts and conditioning guards.

Each example also holds the port's output against the JAX function's on the
same draw: xorshift exactly, the floats within 1e-5 relative (of the
output's scale: |t| for a hit distance, 1 for barycentrics and unit
vectors) wherever the JAX test's guard accepts the lane. XLA contracts
multiply-adds and torch does not, which is why lanes the guard rejects
(near-degenerate, near-tangent, near a threshold) are not compared. XLA on
the CPU also flushes subnormal floats to zero, where torch keeps them (IEEE
gradual underflow): on a lane whose inputs or operands hold a subnormal the
two take different branches (the sign of a dot product of -4e-41) or
differ by a subnormal (a hit distance of 6e-39 against 0), so those lanes
(``_ftz_lanes``) are left out of the comparison with JAX too; the port's
own invariants are still asserted on them."""
import numpy as np
import jax
import jax.numpy as jnp
import torch
from hypothesis import example, given, settings, strategies as st
from hypothesis.extra.numpy import arrays

from uob_raytracer_tpu import RenderConfig as JConfig
from uob_raytracer_tpu.ops import intersect as j_intersect
from uob_raytracer_tpu.ops import prepare_scene as j_prepare
from uob_raytracer_tpu.ops import xorshift as j_xorshift
from uob_raytracer_tpu.ops.intersect import _sphere_roots as j_sphere_roots
from uob_raytracer_tpu.ops.intersect import _tri_tuv as j_tri_tuv
from uob_raytracer_tpu.ops.shading import _reflect_dir as j_reflect
from uob_raytracer_tpu.ops.shading import _refract_dir as j_refract
from uob_raytracer_tpu.reference import oracle as orc
from uob_raytracer_tpu.scene import Scene as JScene
from uob_raytracer_tpu_torch import RenderConfig
from uob_raytracer_tpu_torch.ops import intersect, prepare_scene, xorshift
from uob_raytracer_tpu_torch.ops.intersect import _sphere_roots, _tri_tuv
from uob_raytracer_tpu_torch.ops.shading import _reflect_dir, _refract_dir
from uob_raytracer_tpu_torch.scene import scene_from_numpy

_SETTINGS = dict(max_examples=25, deadline=None)
REL = 1e-5
TINY = np.finfo(np.float32).tiny   # the smallest normal float32

finite = st.floats(-2.0, 2.0, allow_nan=False, width=32)
vec3 = arrays(np.float32, (8, 3), elements=finite)
unit_dir = arrays(np.float32, (8, 3),
                  elements=st.floats(-1.0, 1.0, allow_nan=False, width=32))


def _norm(v, eps=1e-3):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, eps), (n[..., 0] > eps)


def _mini_leaves(v0, v1, v2):
    """8-triangle, no-sphere scene leaves (numpy) from raw vertex arrays."""
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return dict(
        tri_v0=v0, tri_v1=v1, tri_v2=v2,
        tri_rgb=np.full((8, 3), 0.5, np.float32),
        tri_mat=np.ones((8,), np.float32),
        sph_center=z3, sph_r2=z1, sph_rgb=z3, sph_mat=z1,
        light_pos=np.zeros(3, np.float32),
        light_color=np.full((3,), 16.0, np.float32),
        indirect_light=np.full((3,), 0.5, np.float32),
        camera_pos=np.zeros(3, np.float32), yaw=np.float32(0),
        pitch=np.float32(0))


def _scenes(leaves):
    """(the port's DeviceScene on the CPU, the JAX package's Scene)."""
    return (prepare_scene(scene_from_numpy(leaves, "cpu")),
            JScene(**{k: jnp.asarray(v) for k, v in leaves.items()}))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ftz_lanes(shape, *operands):
    """Lanes of ``shape`` where any operand holds a subnormal float32 (XLA
    on the CPU flushes it to zero, torch does not). Each operand is a
    float32 array with a component axis last that broadcasts to ``shape``
    + (k,)."""
    out = np.zeros(shape, bool)
    for x in operands:
        x = np.asarray(x, np.float32)
        sub = ((x != 0) & (np.abs(x) < TINY)).any(axis=-1)
        out |= np.broadcast_to(sub, shape)
    return out


def _det3_operands(a, b, c):
    """Every product, difference and partial sum of ``ops/math3.py:det3``
    (in its order), in float32, stacked on a last axis."""
    with np.errstate(all="ignore"):
        p = [b[..., 1] * c[..., 2], b[..., 2] * c[..., 1],
             b[..., 0] * c[..., 2], b[..., 2] * c[..., 0],
             b[..., 0] * c[..., 1], b[..., 1] * c[..., 0]]
        m = [p[0] - p[1], p[2] - p[3], p[4] - p[5]]
        q = [a[..., 0] * m[0], a[..., 1] * m[1], a[..., 2] * m[2]]
        s = q[0] - q[1]
        return np.stack(np.broadcast_arrays(*p, *m, *q, s, s + q[2]), axis=-1)


def _agree(ours, theirs, mask, scale, what):
    """|ours - theirs| <= REL * max(|theirs|, scale) on the masked lanes."""
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    bound = REL * np.maximum(np.abs(theirs), scale)
    with np.errstate(invalid="ignore"):   # inf - inf off the mask
        bad = mask & ~(np.abs(ours - theirs) <= bound)
    assert not bad.any(), (what, ours[bad], theirs[bad])


# ------------------------------------------------------------- intersection

_ROW4 = np.arange(8)[:, None] == 4


@settings(**_SETTINGS)
@given(v0=vec3, v1=vec3, v2=vec3, start=vec3, d=unit_dir)
# vertices at the smallest normal float32: det3's differences are
# subnormal, t is 6e-39 in torch and 0 in XLA
@example(v0=np.where(_ROW4, np.float32([0.5, 1.0, TINY]),
                     np.full((8, 3), TINY, np.float32)),
         v1=np.zeros((8, 3), np.float32),
         v2=np.where(_ROW4, np.float32([0, 1, 1]),
                     np.ones((8, 3), np.float32)),
         start=np.zeros((8, 3), np.float32),
         d=np.ones((8, 3), np.float32))
def test_triangle_tuv_reconstructs_hit_point(v0, v1, v2, start, d):
    """Accepted (t,u,v) satisfy the reference accept test (kernels.cl:120)
    and reconstruct the same point two ways: v0 + u*e1 + v*e2 == start +
    t*d; on those lanes t, u, v equal the JAX package's, but for the lanes
    with a subnormal operand (``_ftz_lanes``)."""
    ds, js = _scenes(_mini_leaves(v0, v1, v2))
    t, u, v, degen = (x.numpy() for x in _tri_tuv(ds, _t(start), _t(d)))
    jt, ju, jv, _ = (np.asarray(x) for x in jax.jit(j_tri_tuv)(
        j_prepare(js), jnp.asarray(start), jnp.asarray(d)))
    # the JAX test's conditioning guard: |detA| large relative to the
    # operand scale
    e1_np = (v1 - v0).astype(np.float64)
    e2_np = (v2 - v0).astype(np.float64)
    dn = np.asarray(d, np.float64)
    scale = (np.linalg.norm(dn, axis=-1)[:, None]
             * np.linalg.norm(e1_np, axis=-1)[None, :]
             * np.linalg.norm(e2_np, axis=-1)[None, :])
    detA = -dn @ np.cross(e1_np, e2_np).T
    well_cond = np.abs(detA) > 1e-3 * np.maximum(scale, 1e-12)
    acc = ((t >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
           & ~degen & np.isfinite(t) & (np.abs(t) < 1e3) & well_cond)
    if not acc.any():
        return
    e1 = v1 - v0
    e2 = v2 - v0
    p_bary = (v0[None] + u[..., None] * e1[None] + v[..., None] * e2[None])
    p_ray = start[:, None] + t[..., None] * d[:, None]
    np.testing.assert_allclose(p_bary[acc], p_ray[acc], rtol=2e-2, atol=2e-3)
    # every float32 operand of _tri_tuv: the inputs, the edges, b, det3's
    # four expansions and the results
    nd = -d[:, None, :]
    b = start[:, None, :] - v0[None]
    e1f, e2f = e1[None], e2[None]
    ftz = _ftz_lanes(
        t.shape, v0[None], v1[None], v2[None], e1f, e2f, start[:, None],
        d[:, None], b, _det3_operands(nd, e1f, e2f),
        _det3_operands(b, e1f, e2f), _det3_operands(nd, b, e2f),
        _det3_operands(nd, e1f, b), t[..., None], u[..., None], v[..., None])
    cmp = acc & ~ftz
    _agree(t, jt, cmp, 0.0, "t")
    _agree(u, ju, cmp, 1.0, "u")
    _agree(v, jv, cmp, 1.0, "v")


@settings(**_SETTINGS)
@given(c=vec3, start=vec3,
       r2=arrays(np.float32, (8,),
                 # 2^-10: exactly representable in f32
                 elements=st.floats(0.0009765625, 1.0,
                                    allow_nan=False, width=32)))
def test_sphere_roots_lie_on_sphere(c, start, r2):
    """Every finite root x of the stable quadratic (kernels.cl:140-143)
    satisfies |start + x*d - c|^2 == r^2, and equals the JAX package's."""
    d, ok = _norm(c - start)  # aim each ray at its sphere: guaranteed hits
    if not ok.all():
        return
    leaves = _mini_leaves(*(np.zeros((8, 3), np.float32),) * 3)
    leaves.update(sph_center=c, sph_r2=r2,
                  sph_rgb=np.full((8, 3), 0.5, np.float32),
                  sph_mat=np.ones((8,), np.float32))
    ds, js = _scenes(leaves)
    xmin, xmax, no_sol = (x.numpy() for x in _sphere_roots(ds, _t(start),
                                                           _t(d)))
    jmin, jmax, _ = (np.asarray(x) for x in jax.jit(j_sphere_roots)(
        j_prepare(js), jnp.asarray(start), jnp.asarray(d)))
    ar = np.arange(8)
    for roots, jroots in ((xmin, jmin), (xmax, jmax)):
        x = roots[ar, ar]          # ray i against its own sphere i
        m = ~no_sol[ar, ar] & np.isfinite(x) & (np.abs(x) < 1e3)
        if not m.any():
            continue
        p = start[m] + x[m, None] * d[m]
        np.testing.assert_allclose(
            np.sum((p - c[m]) ** 2, axis=-1), r2[m], rtol=5e-2, atol=5e-3)
        # a root is a distance along a unit ray: 1e-5 of it, or of the
        # sphere's size where the root is near 0
        _agree(x, jroots[ar, ar], m, float(np.sqrt(r2.max())), "root")


@settings(**_SETTINGS)
@given(v0=vec3, v1=vec3, v2=vec3, d=unit_dir)
def test_intersect_matches_numpy_oracle(v0, v1, v2, d):
    """The port's nearest hit == the NumPy oracle's nearest hit on random
    scenes (away from ties at f32 resolution), and its t equals the JAX
    package's on the stable lanes both hit."""
    dn, ok = _norm(d)
    if not ok.all():
        return
    leaves = _mini_leaves(v0, v1, v2)
    ds, js = _scenes(leaves)
    start = np.tile(np.float32([0, 0, -3.2]), (8, 1))
    h = intersect(ds, _t(start), _t(dn))
    hj = jax.jit(j_intersect)(j_prepare(js), jnp.asarray(start),
                              jnp.asarray(dn))
    with np.errstate(invalid="ignore", divide="ignore"):
        ho = orc._intersect(orc._to_np_scene(js), start, dn)
    t_o = ho["t"]
    t_p = h.t.numpy()
    hit_p = h.hit.numpy()
    hit_o = ho["hit"]
    # the JAX test's boundary guard: every accept-test margin recomputed in
    # float64, lanes within f32 noise of any threshold dropped
    v064, e164 = v0.astype(np.float64), (v1 - v0).astype(np.float64)
    e264, d64 = (v2 - v0).astype(np.float64), dn.astype(np.float64)
    b64 = start.astype(np.float64)[:, None] - v064[None]
    E = np.cross(e164, e264)[None]                      # [1, T, 3]
    detA = -np.sum(d64[:, None] * E, axis=-1)           # [N, T]
    t_num = np.sum(b64 * E, axis=-1)
    Emag = np.maximum(np.sqrt(np.sum(E * E, axis=-1)), 1e-30)
    with np.errstate(invalid="ignore", divide="ignore"):
        rA = np.where(detA == 0, np.inf, 1.0 / detA)
        t64 = t_num * rA
        u64 = -np.sum(d64[:, None] * np.cross(b64, e264[None]), axis=-1) * rA
        v64 = -np.sum(d64[:, None] * np.cross(e164[None], b64), axis=-1) * rA
    TOL = 1e-4
    near_degen = np.abs(detA) / Emag < TOL
    degen_risky = near_degen & (np.abs(t_num) / Emag < 1e-2)
    tb = np.where(np.isfinite(ho["t"]), ho["t"], np.inf)[:, None]
    crit = np.minimum.reduce([
        np.nan_to_num(np.abs(t64), nan=np.inf),
        np.nan_to_num(np.abs(u64), nan=np.inf),
        np.nan_to_num(np.abs(v64), nan=np.inf),
        np.nan_to_num(np.abs(1.0 - (u64 + v64)), nan=np.inf),
    ])
    relevant = (np.nan_to_num(t64, nan=np.inf) > -1e-2) & \
        (np.nan_to_num(t64, nan=np.inf) < tb + 1e-2)
    reg_risky = ~near_degen & relevant & (crit < TOL)
    stable = ~np.any(degen_risky | reg_risky, axis=1)
    agree = hit_p == hit_o
    assert (agree | ~stable).all() or (np.mean(agree) >= 0.99)
    m = hit_p & hit_o & stable
    if m.any():
        np.testing.assert_allclose(t_p[m], t_o[m], rtol=1e-3, atol=1e-4)
    hit_j = np.asarray(hj.hit)
    assert ((hit_p == hit_j) | ~stable).all()
    _agree(t_p, np.asarray(hj.t), m & hit_j, 0.0, "t")


# ------------------------------------------------------------------ optics

@settings(**_SETTINGS)
@given(d=unit_dir, n=unit_dir)
def test_reflect_involution_and_angle(d, n):
    dn, okd = _norm(d)
    nn, okn = _norm(n)
    if not (okd.all() and okn.all()):
        return
    r = _reflect_dir(_t(dn), _t(nn)).numpy()
    # |r| == |d| and the normal component flips
    np.testing.assert_allclose(np.linalg.norm(r, axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.sum(r * nn, -1), -np.sum(dn * nn, -1),
                               atol=1e-4)
    # reflecting twice returns the original direction
    rr = _reflect_dir(_t(r), _t(nn)).numpy()
    np.testing.assert_allclose(rr, dn, atol=1e-4)
    rj = np.asarray(jax.jit(j_reflect)(jnp.asarray(dn), jnp.asarray(nn)))
    _agree(r, rj, np.ones(r.shape, bool), 1.0, "reflect")


@settings(**_SETTINGS)
@given(d=unit_dir, n=unit_dir)
# a subnormal d.n: its sign flips the normal in torch, XLA flushes it to 0
@example(d=np.where(_ROW4, np.float32([-6.1363e-41, 1, 1]),
                    np.float32([0, 1, 1])),
         n=np.tile(np.float32([1, 0, 0]), (8, 1)))
def test_refract_snell_law(d, n):
    """n1 sin(theta1) == n2 sin(theta2) for non-TIR lanes (kernels.cl:67-88,
    air -> glass entry), and the direction equals the JAX package's but on
    the lanes whose d, n or d.n hold a subnormal (``_ftz_lanes``)."""
    dn, okd = _norm(d)
    nn, okn = _norm(n)
    if not (okd.all() and okn.all()):
        return
    cfg = RenderConfig(width=8, height=8)
    medium = torch.full((8,), cfg.ior_air)
    out, _, tir, _, _, _ = _refract_dir(cfg, _t(dn), _t(nn), medium)
    out, tir = out.numpy(), tir.numpy()
    jcfg = JConfig(width=8, height=8)
    jout, _, jtir, _, _, _ = jax.jit(j_refract, static_argnums=0)(
        jcfg, jnp.asarray(dn), jnp.asarray(nn), jnp.full((8,), jcfg.ior_air))
    m = ~tir
    np.testing.assert_array_equal(tir, np.asarray(jtir))
    if not m.any():
        return
    t = out[m] / np.maximum(np.linalg.norm(out[m], axis=-1, keepdims=True),
                            1e-6)
    sin1 = np.sqrt(np.clip(1 - np.sum(dn[m] * nn[m], -1) ** 2, 0, 1))
    sin2 = np.sqrt(np.clip(1 - np.sum(t * nn[m], -1) ** 2, 0, 1))
    np.testing.assert_allclose(cfg.ior_air * sin1, cfg.ior_glass * sin2,
                               atol=2e-3)
    # the decisive operand is c1 = n.d (its sign picks the normal's side):
    # its products and partial sums, in ops/math3.py:dot3's order
    prod = nn * dn
    part = prod[:, 0] + prod[:, 1]
    ftz = _ftz_lanes((8,), dn, nn, prod, part[:, None],
                     (part + prod[:, 2])[:, None])
    _agree(out, np.asarray(jout),
           np.broadcast_to((m & ~ftz)[:, None], out.shape), 1.0, "refract")


# --------------------------------------------------------------------- RNG

@settings(**_SETTINGS)
@given(seeds=arrays(np.uint32, (16, 3),
                    elements=st.integers(1, 2**32 - 1)))
def test_xorshift_parity_and_nonzero(seeds):
    """The port's xorshift (uint32 values held in int64) matches the
    oracle's and the JAX package's exactly for arbitrary nonzero seeds and
    never maps a nonzero lane to zero."""
    s_t = torch.from_numpy(seeds.astype(np.int64))
    s_j = jnp.asarray(seeds)
    s_n = seeds.copy()
    for _ in range(8):
        s_t = xorshift(s_t)
        s_j = j_xorshift(s_j)
        s_n = orc._xorshift(s_n)
        np.testing.assert_array_equal(s_t.numpy(), s_n.astype(np.int64))
        np.testing.assert_array_equal(np.asarray(s_j), s_n)
        assert (s_n != 0).all()
