"""Shading: soft-shadowed direct light, reflection/refraction, and the
wavefront bounce loop, in plain torch.

The counterpart of ``uob_raytracer_tpu/ops/shading.py``. The reference's
per-ray bounce loop (``Source/kernels.cl:342-365``) becomes a masked Python
loop over the whole ray batch: every iteration reflects/refracts the
still-active rays, re-intersects, records rays that landed on a diffuse
surface, and retires rays that escaped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from .intersect import (DeviceScene, Hit, _tri_tuv, in_shadow, intersect,
                        replay_id)
from .math3 import dot3, normalize3
from .rng import crush, shadow_seed, xorshift

_PI4 = float(np.float32(4.0 * 3.14159265358979323846))


def _f32(x: float) -> float:
    """A Python float holding the float32 value nearest to ``x``."""
    return float(np.float32(x))


def direct_light(ds: DeviceScene, cfg: RenderConfig, pos, normal, gid,
                 tri_axis=None, tri_pass: str = "torch"):
    """Soft-shadowed inverse-square Lambert (``kernels.cl:313-340``).

    Reference quirks kept verbatim: the per-sample jitter perturbs only the
    occlusion ray; the Lambert term uses the unperturbed *unnormalized*
    shadow direction in both the cosine and the 1/(4 pi r^2) falloff; the
    RNG stream restarts from the pixel-id seed on every call.

    Returns (light [N,3], lit count [N] float32: the unoccluded samples)."""
    sdir = ds.light_pos[None] - pos
    start = pos + _f32(cfg.bias) * sdir
    radius_sq = dot3(sdir, sdir)
    rs_safe = torch.where(radius_sq == 0, 1.0, radius_sq)
    lamb = (ds.light_color[None] * torch.clamp(dot3(sdir, normal), min=0.0)[:, None]
            / (_PI4 * rs_safe)[:, None])
    lamb = torch.where((radius_sq == 0)[:, None], 0.0, lamb)

    state = shadow_seed(gid)
    total = torch.zeros_like(pos)
    count = torch.zeros_like(radius_sq)
    for _ in range(cfg.shadow_samples):
        state = xorshift(state)
        jitter = crush(state, cfg.light_spread)
        lit = (~in_shadow(ds, start, sdir + jitter, radius_sq, tri_axis,
                          tri_pass)).to(torch.float32)
        total = total + lit[:, None] * lamb
        count = count + lit
    return total / float(cfg.shadow_samples), count


def _reflect_dir(d, n):
    """Mirror direction d - 2(d.n)n (``kernels.cl:54-65``); unnormalized."""
    return d - 2.0 * dot3(d, n)[:, None] * n


def _refract_dir(cfg: RenderConfig, d, n, medium):
    """Snell refraction with medium tracking (``kernels.cl:67-88``).
    Returns (direction (unnormalized), exit medium, tir mask, cos_in, n1, n2).
    TIR lanes go through sqrt(1); their direction is discarded."""
    air, glass = _f32(cfg.ior_air), _f32(cfg.ior_glass)
    c1 = dot3(n, d)
    nrm = torch.where(c1[:, None] < 0, -n, n)
    c1a = torch.abs(c1)
    in_air = medium == air
    n1 = torch.where(in_air, air, glass)
    n2 = torch.where(in_air, glass, air)
    nr = n1 / n2
    k = 1.0 - nr * nr * (1.0 - c1a * c1a)
    tir = k < 0
    c2 = torch.sqrt(torch.where(tir, 1.0, k))
    out = nr[:, None] * d + (nr * c1a - c2)[:, None] * (-nrm)
    return out, n2, tir, c1a, n1, n2


def _schlick(c1, n1, n2):
    r0 = torch.square((n1 - n2) / (n1 + n2))
    x = 1 - c1
    x2 = x * x
    # x**5 as x * (x^2)^2, the multiply order of jax.lax.integer_pow
    return r0 + (1 - r0) * (x * (x2 * x2))


def trace_specular(ds: DeviceScene, cfg: RenderConfig, primary: Hit, d,
                   tri_axis=None, tri_pass: str = "torch"):
    """Wavefront specular bounce loop (``kernels.cl:342-365``) — geometry
    only. A ray stays active while its last hit is specular (mat <= 0); the
    loop records the *terminal* diffuse hit (position, normal, color,
    Fresnel throughput) and leaves shading to the caller, so the soft-shadow
    sampling runs once per ray instead of once per bounce. Escape /
    exhausted budget / quirk-TIR death leave term_valid False (black, as in
    the reference). With ``cfg.quirk_nan_tir`` a total-internal-reflection
    event kills the ray; otherwise TIR reflects. With ``cfg.fresnel``
    refraction is attenuated by Schlick transmittance (extension).
    ``bid`` lists, per step, the object each still-alive ray hit
    (``replay_id`` encoding; -1 for a miss or a ray not alive).
    ``bounce_rays`` is the number of re-intersections the loop ran: the
    alive rays summed over the steps, an int64 tensor on the rays' device
    (no host read, so the render path gains no synchronisation)."""
    n_rays = d.shape[0]
    dev = d.device
    air = _f32(cfg.ior_air)
    s = dict(
        active=primary.hit & (primary.mat <= 0),
        term_valid=torch.zeros((n_rays,), dtype=torch.bool, device=dev),
        term_pos=torch.zeros((n_rays, 3), device=dev),
        term_normal=torch.zeros((n_rays, 3), device=dev),
        term_rgb=torch.zeros((n_rays, 3), device=dev),
        weight=torch.ones((n_rays,), device=dev),
        d=d,
        pos=primary.pos,
        normal=primary.normal,
        mat=primary.mat,
        medium=torch.full((n_rays,), air, device=dev),
        bid=[],
        bounce_rays=torch.zeros((), dtype=torch.int64, device=dev),
    )
    for _ in range(cfg.bounces):
        refl = _reflect_dir(s["d"], s["normal"])
        refr, n2, tir, c1a, n1v, n2v = _refract_dir(cfg, s["d"], s["normal"],
                                                    s["medium"])
        is_mirror = s["mat"] == 0
        if cfg.quirk_nan_tir:
            dead = tir & ~is_mirror            # NaN direction -> black
            use_refl = is_mirror
        else:
            dead = torch.zeros_like(tir)
            use_refl = is_mirror | tir         # correct TIR: reflect
        new_dir = torch.where(use_refl[:, None], refl, refr)
        new_medium = torch.where(use_refl, air, n2)
        new_start = s["pos"] + _f32(cfg.bias) * new_dir
        alive = s["active"] & ~dead
        new_dir = normalize3(new_dir, alive)

        weight = s["weight"]
        if cfg.fresnel:
            w_step = torch.where(use_refl, 1.0, 1.0 - _schlick(c1a, n1v, n2v))
            weight = torch.where(alive, weight * w_step, weight)

        hit = intersect(ds, new_start, new_dir, tri_axis, tri_pass)
        diffuse = alive & hit.hit & (hit.mat > 0)
        keep_t = diffuse[:, None]
        cont = alive & hit.hit & (hit.mat <= 0)
        keep = cont[:, None]
        s = dict(
            active=cont,
            term_valid=s["term_valid"] | diffuse,
            term_pos=torch.where(keep_t, hit.pos, s["term_pos"]),
            term_normal=torch.where(keep_t, hit.normal, s["term_normal"]),
            term_rgb=torch.where(keep_t, hit.rgb, s["term_rgb"]),
            weight=weight,
            d=torch.where(keep, new_dir, s["d"]),
            pos=torch.where(keep, hit.pos, s["pos"]),
            normal=torch.where(keep, hit.normal, s["normal"]),
            mat=torch.where(cont, hit.mat, s["mat"]),
            medium=torch.where(cont, new_medium, s["medium"]),
            bid=s["bid"] + [torch.where(alive, replay_id(ds, hit), -1)],
            bounce_rays=s["bounce_rays"] + alive.sum(),
        )
    return s


def shade(ds: DeviceScene, cfg: RenderConfig, start, d, gid,
          record: bool = False, tri_axis=None, tri_pass: str = "torch"):
    """Full per-ray radiance (``kernels.cl:411-425``): nearest hit, bounce
    loop for specular rays, then ONE soft-shadow evaluation at the unified
    shading point (the primary hit for diffuse rays, the bounce-terminal
    hit for specular rays — both use the same pixel-seeded RNG stream, so
    the result is identical to shading inside the loop as the reference
    does).

    With ``record`` it returns (color, (pid [N] int32, lit [N] float32,
    bid [bounces, N] int32)): the ray's decisions, as the fused kernel
    records them for the path-replay backward. ``lit`` is 0 on a ray that
    shades nothing. The record is a single-device feature.

    tri_axis / tri_pass: the process group the triangles are sharded over
    and the route of the triangle scans (``ops/intersect.py``)."""
    if record and tri_axis is not None:
        raise ValueError("shade: the decision record is kept on a single "
                         "device only (record=True with tri_axis)")
    primary = intersect(ds, start, d, tri_axis, tri_pass)
    prim_diffuse = primary.hit & (primary.mat > 0)

    if cfg.bounces > 0:
        term = trace_specular(ds, cfg, primary, d, tri_axis, tri_pass)
        sp_pos = torch.where(prim_diffuse[:, None], primary.pos, term["term_pos"])
        sp_normal = torch.where(prim_diffuse[:, None], primary.normal,
                                term["term_normal"])
    else:
        term = None
        sp_pos, sp_normal = primary.pos, primary.normal

    dl, lit = direct_light(ds, cfg, sp_pos, sp_normal, gid, tri_axis,
                           tri_pass)
    color = torch.where(prim_diffuse[:, None],
                        primary.rgb * (ds.indirect[None] + dl), 0.0)
    shades = prim_diffuse
    if term is not None:
        sec = (0.9 * (ds.indirect[None] + dl) * term["term_rgb"]
               * term["weight"][:, None])
        color = torch.where(term["term_valid"][:, None], sec, color)
        shades = shades | term["term_valid"]
    if not record:
        return color
    bid = (torch.stack(term["bid"]) if term is not None else torch.zeros(
        (0, d.shape[0]), dtype=torch.int32, device=d.device))
    return color, (replay_id(ds, primary), torch.where(shades, lit, 0.0), bid)


# ---------------------------------------------------------------------------
# CPU-reference semantics (the vestigial scalar renderer)
# ---------------------------------------------------------------------------

def shade_cpu_ref(ds: DeviceScene, cfg: RenderConfig, start, d,
                  record: bool = False):
    """``skeleton.cpp:184-279`` semantics: triangles only, unnormalized rays,
    distances measured as |t*d|, one hard shadow ray with relative bias 1e-3,
    no material logic (every triangle occludes). With ``record`` it also
    returns the decision record, as ``shade`` does."""
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    valid = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)) & ~degenerate
    t_m = torch.where(valid, t, float("inf"))
    t_m = torch.where(torch.isnan(t_m), float("inf"), t_m)
    idx = torch.argmin(t_m, dim=1)
    tb = t_m.gather(1, idx[:, None])[:, 0]
    hit = torch.isfinite(tb)
    u_b = torch.where(hit, u.gather(1, idx[:, None])[:, 0], 0.0)
    v_b = torch.where(hit, v.gather(1, idx[:, None])[:, 0], 0.0)
    pos = ds.v0[idx] + u_b[:, None] * ds.e1[idx] + v_b[:, None] * ds.e2[idx]
    normal = ds.n[idx]
    rgb = ds.rgb[idx]

    # Hard shadow (skeleton.cpp:220-241): nearest occluder toward the light,
    # shadowed if its unnormalized-units distance is below the light radius.
    r = ds.light_pos[None] - pos
    radius = torch.sqrt(dot3(r, r))
    s_start = pos + _f32(cfg.cpu_ref_bias) * r
    ts, us, vs, degs = _tri_tuv(ds, s_start, r)
    valid_s = ((ts >= 0) & (us >= 0) & (vs >= 0) & ((us + vs) <= 1)) & ~degs
    dist = torch.sqrt(ts * ts * dot3(r, r)[:, None])
    shadowed = torch.any(valid_s & (dist < radius[:, None])
                         & ~torch.isnan(dist), dim=1)

    rad_safe = torch.where(radius == 0, 1.0, radius)
    lamb = (ds.light_color[None] * torch.clamp(dot3(r, normal), min=0.0)[:, None]
            / (_PI4 * rad_safe * rad_safe)[:, None])
    dl = torch.where(shadowed[:, None], 0.0, lamb)
    color = torch.where(hit[:, None], rgb * (dl + ds.indirect[None]), 0.0)
    if not record:
        return color
    pid = torch.where(hit, idx, -1).to(torch.int32)
    lit = (hit & ~shadowed).to(torch.float32)
    return color, (pid, lit, torch.zeros((0, d.shape[0]), dtype=torch.int32,
                                         device=d.device))
