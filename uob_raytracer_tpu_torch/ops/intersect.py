"""Ray-scene intersection (triangles + analytic spheres) in plain torch.

The counterpart of ``uob_raytracer_tpu/ops/intersect.py``, and with
``ops/shading.py`` the plain version of the fused render kernel. Semantics
follow ``single_ray_intersections`` / ``batch_ray_intersections``
(``Source/kernels.cl:92-241``): Cramer's-rule Moller-Trumbore over all
triangles with strict nearest-t (ties keep the lowest index), then spheres
via the catastrophic-cancellation-stable quadratic (q/a, c/q root pairing,
``kernels.cl:140-143``) with strict < against the triangle best. Brute
force over the triangle axis: every (ray, triangle) pair is one element of
an [N, T] tensor.

Tensor-parallel mode: when ``tri_axis`` is a process group (the mesh's tp
group), each rank holds a slice of the triangle tensors plus its global
index offset (``DeviceScene.tri_offset``); the local nearest hits are
combined across ranks with a min on t, a lowest-global-index tie-break
(matching the reference's first-triangle-wins scan order), and a masked sum
that gathers the winning shard's hit attributes
(``parallel/collectives.py``). Spheres are replicated on every rank, so the
sphere merge needs no communication. ``tri_pass='kernel'`` runs the
triangle scans through ``kernels/partial.py``: the hand-written CUDA
kernels for tensors on the card, their plain versions for tensors on the
CPU.

Degenerate denominators are routed through guarded values; they are
rejected by the same comparisons that reject them in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import Scene
from .math3 import cross3, det3, dot3, normalize3

_INF = float("inf")
_IMAX = 2**31 - 1


class DeviceScene(NamedTuple):
    """Derived, render-ready scene tensors. Normals are recomputed from the
    vertices here."""

    v0: torch.Tensor    # [T,3]
    e1: torch.Tensor    # [T,3]
    e2: torch.Tensor    # [T,3]
    n: torch.Tensor     # [T,3] unit normals, normalize(cross(e2,e1))
    rgb: torch.Tensor   # [T,3]
    mat: torch.Tensor   # [T]
    sph_c: torch.Tensor   # [S,3]
    sph_r2: torch.Tensor  # [S]
    sph_rgb: torch.Tensor  # [S,3]
    sph_mat: torch.Tensor  # [S]
    light_pos: torch.Tensor
    light_color: torch.Tensor
    indirect: torch.Tensor
    camera_pos: torch.Tensor
    # Global index of this shard's first triangle (0 unless triangle-sharded).
    tri_offset: int = 0

    @property
    def num_spheres(self) -> int:
        return self.sph_c.shape[0]


class Hit(NamedTuple):
    hit: torch.Tensor      # bool [N]
    pos: torch.Tensor      # [N,3]
    normal: torch.Tensor   # [N,3]
    rgb: torch.Tensor      # [N,3]
    mat: torch.Tensor      # [N]
    t: torch.Tensor        # [N]
    obj_id: torch.Tensor   # [N] int64: triangle index, -2 sphere, -1 miss
    sph_id: torch.Tensor   # [N] int64: index of the sphere hit, else -1


def prepare_scene(scene: Scene) -> DeviceScene:
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    n = cross3(e2, e1)
    nn = dot3(n, n)
    n = n / torch.sqrt(torch.where(nn == 0, 1.0, nn))[..., None]
    return DeviceScene(
        v0=scene.tri_v0, e1=e1, e2=e2, n=n,
        rgb=scene.tri_rgb, mat=scene.tri_mat,
        sph_c=scene.sph_center, sph_r2=scene.sph_r2,
        sph_rgb=scene.sph_rgb, sph_mat=scene.sph_mat,
        light_pos=scene.light_pos, light_color=scene.light_color,
        indirect=scene.indirect_light, camera_pos=scene.camera_pos,
    )


def _tri_tuv(ds: DeviceScene, start, d):
    """Per-triangle (t, u, v, degenerate) tensors of shape [N, T]."""
    dN = d[:, None, :]
    b = start[:, None, :] - ds.v0[None]
    e1, e2 = ds.e1[None], ds.e2[None]
    detA = det3(-dN, e1, e2)
    degenerate = detA == 0
    recip = 1.0 / torch.where(degenerate, 1.0, detA)
    t = det3(b, e1, e2) * recip
    u = det3(-dN, b, e2) * recip
    v = det3(-dN, e1, b) * recip
    return t, u, v, degenerate


def _sphere_roots(ds: DeviceScene, start, d):
    """Stable quadratic roots (x_min, x_max, no_solution) of shape [N, S]."""
    L = start[:, None, :] - ds.sph_c[None]
    a = dot3(d, d)[:, None]
    b = 2.0 * dot3(d[:, None, :], L)
    c = dot3(L, L) - ds.sph_r2[None]
    disc = b * b - 4.0 * a * c
    no_sol = disc < 0
    # disc == 0 (an exact tangent) short-circuits the sqrt as well: its
    # value is 0 either way, and the inf derivative of sqrt at 0 would
    # poison every gradient of the quadratic's inputs.
    sq_zero = disc == 0
    sq = torch.sqrt(torch.where(no_sol | sq_zero, 1.0, disc))
    sq = torch.where(sq_zero, 0.0, sq)
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    q_zero = q == 0
    x0 = q / torch.where(a == 0, 1.0, a)  # a = |d|^2 > 0 in practice
    # q == 0 implies c == 0 (ray origin on the sphere): the reference's
    # c/q = 0/0 NaN root collapses to the x0 = 0 candidate.
    x1 = torch.where(q_zero, x0, c / torch.where(q_zero, 1.0, q))
    return torch.minimum(x0, x1), torch.maximum(x0, x1), no_sol


def _best_triangle(ds: DeviceScene, start, d):
    """Nearest accepted triangle: (t [N] (inf if none), idx [N] int64, the
    global triangle index (_IMAX if none), pos, normal, rgb [N,3], mat
    [N])."""
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    valid = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)) & ~degenerate
    t_m = torch.where(valid, t, _INF)
    t_m = torch.where(torch.isnan(t_m), _INF, t_m)
    li = torch.argmin(t_m, dim=1)   # the first minimum: lowest index wins
    tb = t_m.gather(1, li[:, None])[:, 0]
    hit = torch.isfinite(tb)
    u_b = torch.where(hit, u.gather(1, li[:, None])[:, 0], 0.0)
    v_b = torch.where(hit, v.gather(1, li[:, None])[:, 0], 0.0)
    pos = ds.v0[li] + u_b[:, None] * ds.e1[li] + v_b[:, None] * ds.e2[li]
    h3 = hit[:, None]
    return (tb,
            torch.where(hit, li + ds.tri_offset, _IMAX),
            torch.where(h3, pos, 0.0),
            torch.where(h3, ds.n[li], 0.0),
            torch.where(h3, ds.rgb[li], 0.0),
            torch.where(hit, ds.mat[li], 1.0))


def _best_triangle_kernel(ds: DeviceScene, start, d):
    """``_best_triangle`` through the per-shard nearest-hit kernel
    (``kernels/partial.py:nearest_tris``). Differentiable by the wrapper's
    path-replay backward (frozen visibility, like the argmin)."""
    from ..kernels.partial import nearest_tris
    t, pos, nrm, rgb, mat, idx = nearest_tris(
        ds.v0, ds.e1, ds.e2, ds.n, ds.rgb, ds.mat, start, d)
    hit = torch.isfinite(t)
    return (t, torch.where(hit, idx.to(torch.int64) + ds.tri_offset, _IMAX),
            pos, nrm, rgb, torch.where(hit, mat, 1.0))


def _combine_tri_best(best, tri_axis):
    """Cross-shard nearest-hit reduction: min t, ties to the lowest global
    triangle index (the reference's scan order), attributes gathered from
    the winning shard by one masked sum of a [N,10] tensor.

    t goes through the min detached: downstream it only feeds comparisons
    (zero gradient); the differentiable hit attributes travel through the
    sum, whose backward is a sum again. ``best.t == t_g`` compares floats
    across ranks: every rank computes t with the same arithmetic, in the
    same order."""
    from ..parallel.collectives import pmin, psum
    t, idx, pos, normal, rgb, mat = best
    t_g = pmin(t.detach(), tri_axis)
    at_min = t == t_g
    idx_g = pmin(torch.where(at_min, idx, _IMAX), tri_axis)
    win = at_min & (idx == idx_g) & (idx != _IMAX)
    attrs = psum(torch.where(
        win[:, None], torch.cat([pos, normal, rgb, mat[:, None]], dim=1), 0.0),
        tri_axis)
    return (t_g, idx_g, attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9],
            torch.where(torch.isfinite(t_g), attrs[:, 9], 1.0))


def intersect(ds: DeviceScene, start, d, tri_axis=None,
              tri_pass: str = "torch") -> Hit:
    """Nearest hit for rays (start [N,3], d [N,3]).

    tri_pass: 'torch' scans the triangles as an [N, T] tensor; 'kernel'
    runs the scan through ``kernels/partial.py:nearest_tris``. tri_axis:
    the process group the triangles are sharded over, or None."""
    if tri_pass == "kernel":
        best = _best_triangle_kernel(ds, start, d)
    elif tri_pass == "torch":
        best = _best_triangle(ds, start, d)
    else:
        raise ValueError(f"unknown tri_pass {tri_pass!r}: 'torch' or 'kernel'")
    if tri_axis is not None:
        best = _combine_tri_best(best, tri_axis)
    tri_t, idx, pos, normal, rgb, mat = best
    t_best, obj = tri_t, idx
    sph_id = torch.full_like(idx, -1)

    if ds.num_spheres:
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        cand = torch.where(xmin >= 0, xmin, xmax)
        ok = ~no_sol & (cand >= 0)
        st = torch.where(ok, cand, _INF)
        st = torch.where(torch.isnan(st), _INF, st)
        sph_idx = torch.argmin(st, dim=1)
        sph_t = st.gather(1, sph_idx[:, None])[:, 0]
        sphere_wins = sph_t < tri_t
        sph_t_safe = torch.where(torch.isfinite(sph_t), sph_t, 0.0)
        sph_pos = start + d * sph_t_safe[:, None]
        sph_n = normalize3(sph_pos - ds.sph_c[sph_idx], torch.isfinite(sph_t))
        w3 = sphere_wins[:, None]
        pos = torch.where(w3, sph_pos, pos)
        normal = torch.where(w3, sph_n, normal)
        rgb = torch.where(w3, ds.sph_rgb[sph_idx], rgb)
        mat = torch.where(sphere_wins, ds.sph_mat[sph_idx], mat)
        t_best = torch.where(sphere_wins, sph_t, tri_t)
        obj = torch.where(sphere_wins, -2, idx)
        sph_id = torch.where(sphere_wins, sph_idx, -1)

    hit_any = torch.isfinite(t_best)
    obj = torch.where(hit_any, obj, -1)
    return Hit(hit=hit_any, pos=pos, normal=normal, rgb=rgb, mat=mat,
               t=t_best, obj_id=obj, sph_id=sph_id)


def replay_id(ds: DeviceScene, hit: Hit) -> torch.Tensor:
    """The hit's object id in the decision record's encoding
    (``ops/replay.py``): 0..T-1 triangle, T+s sphere s, -1 miss; int32."""
    n_tri = ds.v0.shape[0]
    return torch.where(hit.obj_id == -2, n_tri + hit.sph_id,
                       hit.obj_id).to(torch.int32)


def tris_occlude_rows(ds: DeviceScene, start, d, radius_sq) -> torch.Tensor:
    """[N, T] bool: does triangle j of ``ds``, if it casts a shadow, lie on
    ray i before the light?"""
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    dist = t * t * dot3(d, d)[:, None]
    return ((t >= 0) & (dist < radius_sq[:, None])
            & (u >= 0) & (v >= 0) & ((u + v) <= 1) & ~degenerate
            & (ds.mat[None] != -1.0))


def tris_occlude(ds: DeviceScene, start, d, radius_sq) -> torch.Tensor:
    """The triangle half of ``in_shadow``: does any triangle of ``ds`` that
    casts a shadow lie on the ray before the light? [N] bool."""
    return torch.any(tris_occlude_rows(ds, start, d, radius_sq), dim=1)


def in_shadow(ds: DeviceScene, start, d, radius_sq, tri_axis=None,
              tri_pass: str = "torch") -> torch.Tensor:
    """Occlusion toward the light (``kernels.cl:243-311``): glass (mat == -1)
    casts no shadow; an occluder counts at t >= 0 with |t*d|^2 < radius_sq.
    tri_pass='kernel': the triangle scan through
    ``kernels/partial.py:occluded_tris``. With ``tri_axis`` the bit is the
    max over the ranks of that process group."""
    if tri_pass == "kernel":
        from ..kernels.partial import occluded_tris
        occluded = occluded_tris(ds.v0, ds.e1, ds.e2, ds.mat, start, d,
                                 radius_sq)
    elif tri_pass == "torch":
        occluded = tris_occlude(ds, start, d, radius_sq)
    else:
        raise ValueError(f"unknown tri_pass {tri_pass!r}: 'torch' or 'kernel'")
    if ds.num_spheres:
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        dd = dot3(d, d)[:, None]
        rs = radius_sq[:, None]
        occ_s = (~no_sol & (ds.sph_mat[None] != -1.0)
                 & (((xmin >= 0) & (xmin * xmin * dd < rs))
                    | ((xmax >= 0) & (xmax * xmax * dd < rs))))
        occluded = occluded | torch.any(occ_s, dim=1)
    if tri_axis is not None:
        from ..parallel.collectives import pmax
        occluded = pmax(occluded.to(torch.int32), tri_axis) > 0
    return occluded
