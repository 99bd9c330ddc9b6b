"""Path-replay reconstruction: the differentiable half of the backward.

The counterpart of ``uob_raytracer_tpu/ops/replay.py``. The fused forward
kernel records each ray's *discrete decisions* — primary hit object id,
per-bounce hit object ids, and soft-shadow lit counts — as cheap residuals.
This module rebuilds the pixel radiance as a lean differentiable function
of the scene parameters with those decisions frozen: every ray gathers only
the one object it actually hit (O(1) per bounce, no [rays, triangles]
broadcast) and the occlusion counts enter detached (their true derivative
is zero almost everywhere).

Under the framework's gradient semantics (visibility is piecewise-constant;
the pixel gradient is the interior/shading gradient) the gradient of this
replay equals the gradient of the full pipeline. torch autograd through
``replay_forward`` is the plain version of the path-replay backward kernel
(``csrc/render_bwd.cu``).

Object id encoding: 0..T-1 triangle, T+s sphere s, -1 miss/inactive.
Ray layout follows the kernel: (A, H, W) flattened A-major.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..scene import Scene
from .camera import gen_primary_rays
from .math3 import cross3, det3, dot3


class Residuals(NamedTuple):
    prim_id: torch.Tensor    # int32 [A, H, W]
    lit_cnt: torch.Tensor    # float32 [A, H, W] (number of unoccluded samples)
    bounce_id: torch.Tensor  # int32 [bounces, A, H, W] (empty if bounces == 0)


def residuals_from_numpy(pid, lit, bid, device) -> Residuals:
    """A decision record from numpy arrays (for example ``np.asarray`` of
    each field of the JAX package's ``Residuals``), on ``device``."""
    return Residuals(
        prim_id=torch.from_numpy(np.array(pid, dtype=np.int32)).to(device),
        lit_cnt=torch.from_numpy(np.array(lit, dtype=np.float32)).to(device),
        bounce_id=torch.from_numpy(np.array(bid, dtype=np.int32)).to(device))


def residuals_to_numpy(res: Residuals):
    """(pid int32, lit float32, bid int32) numpy arrays of a record."""
    return tuple(t.detach().cpu().numpy() for t in res)


def build_object_table(scene: Scene):
    """Combined object table [T+S+1, 14] for row gathering.

    Triangle rows: v0(0:3), e1(3:6), e2(6:9), rgb(9:12), mat(12), 0.
    Sphere rows:   c(0:3),  zeros,   zeros,   rgb(9:12), mat(12), r2(13).
    Final row: the miss/inactive target (mat=1, everything else 0).
    Differentiable w.r.t. every Scene leaf it draws from."""
    T, S = scene.num_triangles, scene.num_spheres
    v0 = scene.tri_v0
    kw = dict(dtype=v0.dtype, device=v0.device)
    tri = torch.cat([
        v0, scene.tri_v1 - v0, scene.tri_v2 - v0, scene.tri_rgb,
        scene.tri_mat[:, None], torch.zeros((T, 1), **kw)], dim=1)
    rows = [tri]
    if S:
        rows.append(torch.cat([
            scene.sph_center, torch.zeros((S, 6), **kw), scene.sph_rgb,
            scene.sph_mat[:, None], scene.sph_r2[:, None]], dim=1))
    pad = torch.zeros((1, 14), **kw)
    pad[0, 12] = 1.0
    rows.append(pad)
    return torch.cat(rows, dim=0)


def _gather_rows(table, ids):
    """The table row of each id; -1 reads the final (miss) row."""
    idx = torch.where(ids < 0, table.shape[0] - 1, ids.to(torch.int64))
    return table.index_select(0, idx)


def _hit_from_row(row, n_tri: int, ids, start, d):
    """Differentiable hit reconstruction from a pre-gathered object row.

    Recomputes the reference formulas (Cramer t/u/v for the identified
    triangle, the stable quadratic root for the identified sphere) so values
    match the forward kernel on the smooth branch. Returns
    (pos, normal, rgb, mat, valid)."""
    is_sph = ids >= n_tri
    valid = ids >= 0

    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    rgb = row[:, 9:12]
    mat = row[:, 12]
    b = start - v0
    nd = -d
    detA = det3(nd, e1, e2)
    degen = detA == 0
    recip = 1.0 / torch.where(degen, 1.0, detA)
    u = det3(nd, b, e2) * recip
    v = det3(nd, e1, b) * recip
    tri_pos = v0 + u[:, None] * e1 + v[:, None] * e2
    n_raw = cross3(e2, e1)
    nn = dot3(n_raw, n_raw)
    tri_n = n_raw / torch.sqrt(torch.where(nn == 0, 1.0, nn))[:, None]

    # sphere branch (c lives in the v0 slot, r2 in slot 13). Triangle rows
    # also flow through this arithmetic (their result is masked out), but
    # their r2 = 0 makes disc <= 0 with equality at exact ray-vertex
    # alignment — an inf-grad sqrt(0); gate the sqrt on the lane actually
    # being a sphere hit.
    c = v0
    r2 = row[:, 13]
    L = start - c
    a_q = dot3(d, d)
    b_q = 2.0 * dot3(d, L)
    c_q = dot3(L, L) - r2
    disc = b_q * b_q - 4.0 * a_q * c_q
    no_sol = disc < 0
    # disc == 0 short-circuits the sqrt: its inf derivative would poison
    # the sphere gradients (see ops/intersect._sphere_roots)
    sq_zero = disc == 0
    sq = torch.sqrt(torch.where(no_sol | sq_zero | ~is_sph, 1.0, disc))
    sq = torch.where(sq_zero, 0.0, sq)
    q = torch.where(b_q > 0, -0.5 * (b_q + sq), -0.5 * (b_q - sq))
    qz = q == 0
    x0 = q / torch.where(a_q == 0, 1.0, a_q)
    x1 = torch.where(qz, x0, c_q / torch.where(qz, 1.0, q))
    xmin = torch.minimum(x0, x1)
    xmax = torch.maximum(x0, x1)
    cand = torch.where(xmin >= 0, xmin, xmax)
    cand = torch.where(no_sol, 0.0, cand)
    sph_pos = start + cand[:, None] * d
    pc = sph_pos - c
    pl2 = dot3(pc, pc)
    sph_n = pc / torch.sqrt(torch.where(pl2 == 0, 1.0, pl2))[:, None]

    m = is_sph[:, None]
    pos = torch.where(m, sph_pos, tri_pos)
    normal = torch.where(m, sph_n, tri_n)
    vm = valid[:, None]
    return (torch.where(vm, pos, 0.0), torch.where(vm, normal, 0.0),
            torch.where(vm, rgb, 0.0), torch.where(valid, mat, 1.0), valid)


def replay_forward(scene: Scene, cfg: RenderConfig, res: Residuals,
                   row0=None, rows: int | None = None):
    """Radiance [rows, W, 3] reconstructed from recorded decisions. Matches
    the fused kernel's forward output on the smooth branch; its autograd
    gradient is the framework's pixel gradient. row0/rows replay only a row
    band of the logical image. Runs in the dtype of the scene's leaves."""
    A = cfg.aa_rays
    W = cfg.width
    row0 = 0 if row0 is None else int(row0)
    rows = cfg.height - row0 if rows is None else rows
    dt = scene.tri_v0.dtype
    dirs, _ = gen_primary_rays(cfg, scene.yaw, scene.pitch, row0, rows)
    d = dirs.permute(2, 0, 1, 3).reshape(-1, 3)            # A-major [N,3]
    n = d.shape[0]
    dev = d.device
    start = scene.camera_pos.expand(n, 3)
    air, glass = (float(np.float32(cfg.ior_air)),
                  float(np.float32(cfg.ior_glass)))
    bias = float(np.float32(cfg.bias))

    table = build_object_table(scene)
    n_tri = scene.num_triangles
    prim_id = res.prim_id.reshape(-1)
    pos, normal, rgb, mat, valid = _hit_from_row(
        _gather_rows(table, prim_id), n_tri, prim_id, start, d)
    # CPU-ref shades ANY hit triangle (skeleton.cpp:268 has no material test)
    prim_diffuse = valid if cfg.cpu_ref else valid & (mat > 0)

    # --- bounce chain replay ---
    term_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    term_pos = torch.zeros((n, 3), dtype=dt, device=dev)
    term_nrm = torch.zeros((n, 3), dtype=dt, device=dev)
    term_rgb = torch.zeros((n, 3), dtype=dt, device=dev)
    weight = torch.ones((n,), dtype=dt, device=dev)
    if cfg.bounces > 0 and res.bounce_id.shape[0]:
        cur_d, cur_pos, cur_nrm, cur_mat = d, pos, normal, mat
        medium = torch.full((n,), air, dtype=dt, device=dev)
        active = valid & (mat <= 0)
        for b in range(cfg.bounces):
            ids_b = res.bounce_id[b].reshape(-1)
            # reflect / refract decision recomputed (kernels.cl:54-88)
            dn = dot3(cur_d, cur_nrm)
            refl = cur_d - 2.0 * dn[:, None] * cur_nrm
            c1 = dn
            nflip = torch.where(c1[:, None] < 0, -cur_nrm, cur_nrm)
            c1a = torch.abs(c1)
            in_air = medium == air
            n1 = torch.where(in_air, air, glass).to(dt)
            n2 = torch.where(in_air, glass, air).to(dt)
            nr = n1 / n2
            k = 1.0 - nr * nr * (1.0 - c1a * c1a)
            tir = k < 0
            kz = k == 0   # grazing TIR boundary: kill the inf sqrt grad
            c2 = torch.sqrt(torch.where(tir | kz, 1.0, k))
            c2 = torch.where(kz, 0.0, c2)
            refr = nr[:, None] * cur_d + (nr * c1a - c2)[:, None] * (-nflip)
            is_mirror = cur_mat == 0
            if cfg.quirk_nan_tir:
                dead = tir & ~is_mirror
                use_refl = is_mirror
            else:
                dead = torch.zeros_like(tir)
                use_refl = is_mirror | tir
            ndir = torch.where(use_refl[:, None], refl, refr)
            nmed = torch.where(use_refl, air, n2)
            nstart = cur_pos + bias * ndir
            alive = active & ~dead
            nd2 = dot3(ndir, ndir)
            nd2 = torch.maximum(nd2, torch.full_like(nd2, 1e-30))
            ndir = ndir / torch.sqrt(nd2)[:, None]
            if cfg.fresnel:
                r0f = torch.square((n1 - n2) / (n1 + n2))
                x = 1 - c1a
                x2 = x * x
                refl_w = r0f + (1 - r0f) * (x * (x2 * x2))
                w_step = torch.where(use_refl, 1.0, 1.0 - refl_w)
                weight = torch.where(alive, weight * w_step, weight)

            h_pos, h_nrm, h_rgb, h_mat, h_valid = _hit_from_row(
                _gather_rows(table, ids_b), n_tri, ids_b, nstart, ndir)
            h_valid = h_valid & alive
            diffuse = h_valid & (h_mat > 0)
            km = diffuse[:, None]
            term_valid = term_valid | diffuse
            term_pos = torch.where(km, h_pos, term_pos)
            term_nrm = torch.where(km, h_nrm, term_nrm)
            term_rgb = torch.where(km, h_rgb, term_rgb)
            cont = h_valid & (h_mat <= 0)
            cm = cont[:, None]
            cur_d = torch.where(cm, ndir, cur_d)
            cur_pos = torch.where(cm, h_pos, cur_pos)
            cur_nrm = torch.where(cm, h_nrm, cur_nrm)
            cur_mat = torch.where(cont, h_mat, cur_mat)
            medium = torch.where(cont, nmed, medium)
            active = cont

    # --- unified shading point + frozen-count soft shadow ---
    sp_pos = torch.where(prim_diffuse[:, None], pos, term_pos)
    sp_nrm = torch.where(prim_diffuse[:, None], normal, term_nrm)
    sdir = scene.light_pos[None] - sp_pos
    radius_sq = dot3(sdir, sdir)
    rs = torch.where(radius_sq == 0, 1.0, radius_sq)
    lam = dot3(sdir, sp_nrm)
    lam_base = (torch.maximum(lam, torch.zeros_like(lam))
                / (float(np.float32(4.0 * np.pi)) * rs))
    lam_base = torch.where(radius_sq == 0, 0.0, lam_base)
    lit = res.lit_cnt.reshape(-1).detach().to(dt)
    dl_scale = lit * lam_base / float(cfg.shadow_samples)
    dl = scene.light_color[None] * dl_scale[:, None]

    color = torch.where(prim_diffuse[:, None],
                        rgb * (scene.indirect_light[None] + dl), 0.0)
    color = torch.where(term_valid[:, None],
                        0.9 * (scene.indirect_light[None] + dl)
                        * term_rgb * weight[:, None], color)
    img = color.reshape(A, rows, W, 3)
    return img.sum(dim=0) / float(A)
