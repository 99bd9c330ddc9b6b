"""The plain reference renderer and its gradient: a frozen copy of the port's
plain pipeline (``ops/camera.py``, ``ops/intersect.py``, ``ops/shading.py``,
``ops/rng.py``, ``ops/math3.py`` and the AA mean of
``kernels/render_fwd.py:render_fused_plain``) in plain torch. It imports
nothing of the port and runs on any device, in the dtype of the leaves it
is given (float32 for the reference, bfloat16 for the precision control).

Semantics are those of the reference OpenCL kernel
(harrywaugh/UOB_Raytracer ``Source/kernels.cl``): brute-force Cramer's-rule
nearest hit over every triangle (ties to the lowest index), the stable
sphere quadratic, a wavefront specular bounce loop that shades once at the
terminal diffuse hit, the pixel-seeded xorshift soft-shadow samples and
the 2x2 AA mean.

Three departures from the port's plain version, none of which changes a
value: the [rays, triangles] scans run without autograd and only the
winning triangle's (t, u, v) is computed again with it (the same
elementwise arithmetic on the same operands, so the same bits; the
gradient of a gather through the argmin is that of the winner's row); a
frame is taken in bands of rows, each band's loss differentiated on its
own and the leaves' gradients summed, so that the memory stays bounded at
any frame size; and rows are gathered with ``index_select``, whose
gradient sums by atomic adds, where indexing's sorts hundreds of thousands
of rays onto a few dozen rows (the sums' order, and so their last bits,
may differ from run to run).

A scene is a dict of the 15 leaf tensors keyed by ``scenes.LEAVES``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_UINT_MAX_F = float(np.float32(4294967295.0))
_PI4 = float(np.float32(4.0 * 3.14159265358979323846))
_INF = float("inf")
# [rays, triangles] elements one band may hold in each scan temporary
BAND_PAIRS = 1 << 25


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Params:
    """The render parameters the reference reads (the port's
    ``RenderConfig`` fields of the same names and defaults; ``cpu_ref`` is
    not supported)."""

    width: int = 1024
    height: int = 1024
    aa_x: int = 2
    aa_y: int = 2
    shadow_samples: int = 10
    light_spread: float = 0.05
    bounces: int = 10
    ior_glass: float = 1.52
    ior_air: float = 1.0
    bias: float = 1e-4
    focal_length: float = 2200.0
    quirk_nan_tir: bool = False
    fresnel: bool = False

    @property
    def aa_rays(self) -> int:
        return self.aa_x * self.aa_y

    @property
    def effective_focal(self) -> float:
        return self.focal_length * (self.width * self.aa_x) / 2048.0


# ---------------------------------------------------------------------------
# 3-vectors, one torch op per multiply and per add
# ---------------------------------------------------------------------------

def det3(a, b, c):
    return (a[..., 0] * (b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1])
            - a[..., 1] * (b[..., 0] * c[..., 2] - b[..., 2] * c[..., 0])
            + a[..., 2] * (b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0]))


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize3(v, active=None):
    if active is not None:
        unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
        v = torch.where(active[..., None], v, unit_x)
    return v / torch.sqrt(dot3(v, v))[..., None]


# ---------------------------------------------------------------------------
# The pixel-seeded xorshift stream (kernels.cl:42-52, 319, 331)
# ---------------------------------------------------------------------------

def xorshift(state):
    state = state ^ ((state << 13) & _MASK32)
    state = state ^ (state >> 17)
    return state ^ ((state << 5) & _MASK32)


def crush(state, rng: float, dtype):
    r = _f32(rng)
    return r * state.to(dtype) / _UINT_MAX_F - r / 2.0


def shadow_seed(gid):
    g = gid.to(torch.int64) & _MASK32
    gf = g.to(torch.float32)
    return xorshift(torch.stack(
        [g, (gf * 91.0).to(torch.int64), (gf * 19.0).to(torch.int64)], dim=-1))


# ---------------------------------------------------------------------------
# Camera (skeleton.cpp:149-151, kernels.cl:384-407)
# ---------------------------------------------------------------------------

def primary_rays(p: Params, yaw, pitch, row0: int, rows: int):
    """Directions [rows, W, A, 3] and pixel ids [rows, W] of a row band."""
    W, H = p.width, p.height
    dev, dt = yaw.device, yaw.dtype
    xs = torch.arange(W, dtype=dt, device=dev)[None, :]
    ys = torch.arange(row0, row0 + rows, dtype=dt, device=dev)[:, None]
    ax, ay = p.aa_x, p.aa_y
    bx = xs * float(ax) - _f32(W * ax / 2.0)
    by = ys * float(ay) - _f32(H * ay / 2.0)
    offs = torch.tensor([[dx, dy] for dy in range(ay) for dx in range(ax)],
                        dtype=dt, device=dev)
    a = offs.shape[0]
    dirs = torch.stack([
        bx[:, :, None].expand(rows, W, a) + offs[None, None, :, 0],
        by[:, :, None].expand(rows, W, a) + offs[None, None, :, 1],
        torch.full((rows, W, a), _f32(p.effective_focal), dtype=dt,
                   device=dev)], dim=-1)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    R = torch.stack([torch.stack([cy, sp * sy, sy * cp]),
                     torch.stack([torch.zeros_like(cy), cp, -sp]),
                     torch.stack([-sy, cy * sp, cp * cy])])
    dirs = torch.stack([R[i, 0] * dirs[..., 0] + R[i, 1] * dirs[..., 1]
                        + R[i, 2] * dirs[..., 2] for i in range(3)], dim=-1)
    gid = (torch.arange(row0, row0 + rows, dtype=torch.int64,
                        device=dev)[:, None] * W
           + torch.arange(W, dtype=torch.int64, device=dev)[None, :])
    return normalize3(dirs), gid


# ---------------------------------------------------------------------------
# Intersection (kernels.cl:92-311)
# ---------------------------------------------------------------------------

def prepare(s: dict) -> dict:
    e1 = s["tri_v1"] - s["tri_v0"]
    e2 = s["tri_v2"] - s["tri_v0"]
    n = cross3(e2, e1)
    nn = dot3(n, n)
    n = n / torch.sqrt(torch.where(nn == 0, 1.0, nn))[..., None]
    return dict(s, e1=e1, e2=e2, n=n)


def _tuv(v0, e1, e2, start, d):
    """(t, u, v, degenerate) by Cramer's rule; operands broadcast."""
    b = start - v0
    detA = det3(-d, e1, e2)
    degenerate = detA == 0
    recip = 1.0 / torch.where(degenerate, 1.0, detA)
    return (det3(b, e1, e2) * recip, det3(-d, b, e2) * recip,
            det3(-d, e1, b) * recip, degenerate)


def _scan_tuv(ds, start, d):
    return _tuv(ds["tri_v0"][None], ds["e1"][None], ds["e2"][None],
                start[:, None, :], d[:, None, :])


def _sphere_roots(ds, start, d):
    L = start[:, None, :] - ds["sph_center"][None]
    a = dot3(d, d)[:, None]
    b = 2.0 * dot3(d[:, None, :], L)
    c = dot3(L, L) - ds["sph_r2"][None]
    disc = b * b - 4.0 * a * c
    no_sol = disc < 0
    sq_zero = disc == 0
    sq = torch.sqrt(torch.where(no_sol | sq_zero, 1.0, disc))
    sq = torch.where(sq_zero, 0.0, sq)
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    q_zero = q == 0
    x0 = q / torch.where(a == 0, 1.0, a)
    x1 = torch.where(q_zero, x0, c / torch.where(q_zero, 1.0, q))
    return torch.minimum(x0, x1), torch.maximum(x0, x1), no_sol


def intersect(ds, start, d):
    """Nearest hit of rays (start [N,3], d [N,3]): (hit, pos, normal, rgb,
    mat, obj) with obj the triangle index, T + s for sphere s, -1 for a
    miss."""
    with torch.no_grad():
        t, u, v, deg = _scan_tuv(ds, start, d)
        valid = (t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1) & ~deg
        t_m = torch.where(valid, t, _INF)
        t_m = torch.where(torch.isnan(t_m), _INF, t_m)
        li = torch.argmin(t_m, dim=1)
        del t, u, v, deg, valid, t_m
    v0, e1, e2 = (ds[k].index_select(0, li) for k in ("tri_v0", "e1", "e2"))
    tw, uw, vw, degw = _tuv(v0, e1, e2, start, d)
    okw = (tw >= 0) & (uw >= 0) & (vw >= 0) & ((uw + vw) <= 1) & ~degw
    tri_t = torch.where(okw, tw, _INF)
    tri_t = torch.where(torch.isnan(tri_t), _INF, tri_t)
    hit = torch.isfinite(tri_t)
    u_b = torch.where(hit, uw, 0.0)
    v_b = torch.where(hit, vw, 0.0)
    h3 = hit[:, None]
    pos = torch.where(h3, v0 + u_b[:, None] * e1 + v_b[:, None] * e2, 0.0)
    normal = torch.where(h3, ds["n"].index_select(0, li), 0.0)
    rgb = torch.where(h3, ds["tri_rgb"].index_select(0, li), 0.0)
    mat = torch.where(hit, ds["tri_mat"].index_select(0, li), 1.0)
    obj = torch.where(hit, li, -1)
    t_best = tri_t
    n_tri = ds["tri_v0"].shape[0]
    if ds["sph_center"].shape[0]:
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        cand = torch.where(xmin >= 0, xmin, xmax)
        ok = ~no_sol & (cand >= 0)
        st = torch.where(ok, cand, _INF)
        st = torch.where(torch.isnan(st), _INF, st)
        si = torch.argmin(st, dim=1)
        sph_t = st.gather(1, si[:, None])[:, 0]
        wins = sph_t < tri_t
        sph_t_safe = torch.where(torch.isfinite(sph_t), sph_t, 0.0)
        sph_pos = start + d * sph_t_safe[:, None]
        sph_n = normalize3(sph_pos - ds["sph_center"].index_select(0, si),
                           torch.isfinite(sph_t))
        w3 = wins[:, None]
        pos = torch.where(w3, sph_pos, pos)
        normal = torch.where(w3, sph_n, normal)
        rgb = torch.where(w3, ds["sph_rgb"].index_select(0, si), rgb)
        mat = torch.where(wins, ds["sph_mat"].index_select(0, si), mat)
        t_best = torch.where(wins, sph_t, tri_t)
        obj = torch.where(wins, n_tri + si, obj)
    hit_any = torch.isfinite(t_best)
    return dict(hit=hit_any, pos=pos, normal=normal, rgb=rgb, mat=mat,
                obj=torch.where(hit_any, obj, -1))


@torch.no_grad()
def in_shadow(ds, start, d, radius_sq):
    """Occlusion toward the light (kernels.cl:243-311): glass casts no
    shadow; an occluder counts at t >= 0 with |t d|^2 < radius_sq."""
    t, u, v, deg = _scan_tuv(ds, start, d)
    dist = t * t * dot3(d, d)[:, None]
    occ = torch.any((t >= 0) & (dist < radius_sq[:, None]) & (u >= 0)
                    & (v >= 0) & ((u + v) <= 1) & ~deg
                    & (ds["tri_mat"][None] != -1.0), dim=1)
    if ds["sph_center"].shape[0]:
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        dd = dot3(d, d)[:, None]
        rs = radius_sq[:, None]
        occ = occ | torch.any(
            ~no_sol & (ds["sph_mat"][None] != -1.0)
            & (((xmin >= 0) & (xmin * xmin * dd < rs))
               | ((xmax >= 0) & (xmax * xmax * dd < rs))), dim=1)
    return occ


# ---------------------------------------------------------------------------
# Shading (kernels.cl:313-425)
# ---------------------------------------------------------------------------

def direct_light(ds, p: Params, pos, normal, gid):
    """Soft-shadowed inverse-square Lambert: (light [N,3], lit samples
    [N])."""
    dt = pos.dtype
    sdir = ds["light_pos"][None] - pos
    start = pos + _f32(p.bias) * sdir
    radius_sq = dot3(sdir, sdir)
    rs_safe = torch.where(radius_sq == 0, 1.0, radius_sq)
    lamb = (ds["light_color"][None]
            * torch.clamp(dot3(sdir, normal), min=0.0)[:, None]
            / (_PI4 * rs_safe)[:, None])
    lamb = torch.where((radius_sq == 0)[:, None], 0.0, lamb)
    state = shadow_seed(gid)
    total = torch.zeros_like(pos)
    count = torch.zeros_like(radius_sq)
    for _ in range(p.shadow_samples):
        state = xorshift(state)
        jitter = crush(state, p.light_spread, dt)
        lit = (~in_shadow(ds, start.detach(), (sdir + jitter).detach(),
                          radius_sq.detach())).to(dt)
        total = total + lit[:, None] * lamb
        count = count + lit
    return total / float(p.shadow_samples), count


def _schlick(c1, n1, n2):
    r0 = torch.square((n1 - n2) / (n1 + n2))
    x = 1 - c1
    x2 = x * x
    return r0 + (1 - r0) * (x * (x2 * x2))


def trace_specular(ds, p: Params, primary, d):
    """The specular bounce loop (kernels.cl:342-365), geometry only: the
    terminal diffuse hit of every ray whose primary hit is specular, and
    the live bounce steps (``bounce_rays``)."""
    n = d.shape[0]
    dev, dt = d.device, d.dtype
    air, glass = _f32(p.ior_air), _f32(p.ior_glass)
    s = dict(active=primary["hit"] & (primary["mat"] <= 0),
             term_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
             term_pos=torch.zeros((n, 3), dtype=dt, device=dev),
             term_normal=torch.zeros((n, 3), dtype=dt, device=dev),
             term_rgb=torch.zeros((n, 3), dtype=dt, device=dev),
             weight=torch.ones((n,), dtype=dt, device=dev),
             d=d, pos=primary["pos"], normal=primary["normal"],
             mat=primary["mat"],
             medium=torch.full((n,), air, dtype=dt, device=dev),
             bounce_rays=torch.zeros((), dtype=torch.int64, device=dev))
    for _ in range(p.bounces):
        dd, nrm0 = s["d"], s["normal"]
        refl = dd - 2.0 * dot3(dd, nrm0)[:, None] * nrm0
        c1 = dot3(nrm0, dd)
        nrm = torch.where(c1[:, None] < 0, -nrm0, nrm0)
        c1a = torch.abs(c1)
        in_air = s["medium"] == air
        n1 = torch.where(in_air, air, glass).to(dt)
        n2 = torch.where(in_air, glass, air).to(dt)
        nr = n1 / n2
        k = 1.0 - nr * nr * (1.0 - c1a * c1a)
        tir = k < 0
        c2 = torch.sqrt(torch.where(tir, 1.0, k))
        refr = nr[:, None] * dd + (nr * c1a - c2)[:, None] * (-nrm)
        is_mirror = s["mat"] == 0
        if p.quirk_nan_tir:
            dead = tir & ~is_mirror
            use_refl = is_mirror
        else:
            dead = torch.zeros_like(tir)
            use_refl = is_mirror | tir
        new_dir = torch.where(use_refl[:, None], refl, refr)
        new_medium = torch.where(use_refl, air, n2)
        new_start = s["pos"] + _f32(p.bias) * new_dir
        alive = s["active"] & ~dead
        new_dir = normalize3(new_dir, alive)
        weight = s["weight"]
        if p.fresnel:
            w_step = torch.where(use_refl, 1.0, 1.0 - _schlick(c1a, n1, n2))
            weight = torch.where(alive, weight * w_step, weight)
        hit = intersect(ds, new_start, new_dir)
        diffuse = alive & hit["hit"] & (hit["mat"] > 0)
        cont = alive & hit["hit"] & (hit["mat"] <= 0)
        kt, kc = diffuse[:, None], cont[:, None]
        s = dict(active=cont,
                 term_valid=s["term_valid"] | diffuse,
                 term_pos=torch.where(kt, hit["pos"], s["term_pos"]),
                 term_normal=torch.where(kt, hit["normal"], s["term_normal"]),
                 term_rgb=torch.where(kt, hit["rgb"], s["term_rgb"]),
                 weight=weight,
                 d=torch.where(kc, new_dir, s["d"]),
                 pos=torch.where(kc, hit["pos"], s["pos"]),
                 normal=torch.where(kc, hit["normal"], s["normal"]),
                 mat=torch.where(cont, hit["mat"], s["mat"]),
                 medium=torch.where(cont, new_medium, s["medium"]),
                 bounce_rays=s["bounce_rays"] + alive.sum())
    return s


def shade(ds, p: Params, start, d, gid):
    """Per-ray radiance [N,3] and the ray statistics (live bounce steps,
    shaded rays) as int64 device scalars."""
    primary = intersect(ds, start, d)
    prim_diffuse = primary["hit"] & (primary["mat"] > 0)
    term = None
    sp_pos, sp_normal = primary["pos"], primary["normal"]
    if p.bounces > 0:
        term = trace_specular(ds, p, primary, d)
        sp_pos = torch.where(prim_diffuse[:, None], sp_pos, term["term_pos"])
        sp_normal = torch.where(prim_diffuse[:, None], sp_normal,
                                term["term_normal"])
    dl, _ = direct_light(ds, p, sp_pos, sp_normal, gid)
    color = torch.where(prim_diffuse[:, None],
                        primary["rgb"] * (ds["indirect_light"][None] + dl),
                        0.0)
    shaded = prim_diffuse
    n_bounce = torch.zeros((), dtype=torch.int64, device=d.device)
    if term is not None:
        sec = (0.9 * (ds["indirect_light"][None] + dl) * term["term_rgb"]
               * term["weight"][:, None])
        color = torch.where(term["term_valid"][:, None], sec, color)
        shaded = shaded | term["term_valid"]
        n_bounce = term["bounce_rays"]
    return color, n_bounce, shaded.sum()


# ---------------------------------------------------------------------------
# Frames, bands and the loss's gradient
# ---------------------------------------------------------------------------

def band_rows(p: Params, n_tri: int) -> int:
    """Rows of a band: the largest divisor of the height whose rays times
    triangles stay within ``BAND_PAIRS`` (one row at least)."""
    per_row = p.width * p.aa_rays * max(n_tri, 1)
    want = max(1, BAND_PAIRS // per_row)
    return max(r for r in range(1, p.height + 1)
               if p.height % r == 0 and r <= want)


def render_band(s: dict, p: Params, row0: int, rows: int):
    """(image [rows, W, 3], live bounce steps, shaded rays) of a row band."""
    ds = prepare(s)
    dirs, gid = primary_rays(p, s["yaw"], s["pitch"], row0, rows)
    A = dirs.shape[2]
    d = dirs.reshape(-1, 3)
    start = s["camera_pos"].expand(d.shape[0], 3)
    color, n_bounce, n_shaded = shade(ds, p, start, d,
                                      gid.reshape(-1).repeat_interleave(A))
    colors = color.reshape(rows, p.width, A, 3)
    return colors.sum(dim=2) / float(A), n_bounce, n_shaded


def bands(s: dict, p: Params):
    rows = band_rows(p, s["tri_v0"].shape[0])
    return [(r0, rows) for r0 in range(0, p.height, rows)]


@torch.no_grad()
def render_image(s: dict, p: Params) -> torch.Tensor:
    """The float image [H, W, 3]."""
    return torch.cat([render_band(s, p, r0, n)[0] for r0, n in bands(s, p)])


@torch.no_grad()
def ray_stats(s: dict, p: Params) -> tuple[int, int, int]:
    """(primary rays, live bounce steps, shaded rays) of one frame: the
    logical queries the work count weighs (the port's
    ``bench.py:_ray_count_stats``)."""
    n_b = n_s = 0
    for r0, n in bands(s, p):
        _, b, sh = render_band(s, p, r0, n)
        n_b, n_s = n_b + b, n_s + sh
    return p.width * p.height * p.aa_rays, int(n_b), int(n_s)


def loss_and_grads(s: dict, target: torch.Tensor, p: Params, names):
    """(loss, {name: gradient}) of the mean squared error of the image
    against ``target``, differentiated band by band."""
    params = {k: s[k].detach().clone().requires_grad_(True) for k in names}
    live = dict(s, **params)
    scale = 1.0 / float(target.numel())
    loss = torch.zeros((), dtype=target.dtype, device=target.device)
    for r0, n in bands(s, p):
        img, _, _ = render_band(live, p, r0, n)
        part = torch.sum(torch.square(img - target[r0:r0 + n])) * scale
        part.backward()
        loss = loss + part.detach()
    return loss, {k: params[k].grad.detach() for k in names}
