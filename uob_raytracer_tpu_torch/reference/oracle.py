"""NumPy oracle renderer — the port's copy of
``uob_raytracer_tpu/reference/oracle.py``, the same float32 NumPy arithmetic
in the same order, reading the port's ``Scene`` (on any device) and
``RenderConfig``, so that the machine with the card holds the kernels to it
without jax. Torch does no arithmetic here: the leaves are read once through
``scene_to_numpy``.

Pure float32 NumPy reimplementation of the reference pipeline, used as the
ground truth that the kernels must match. Two semantic modes:

* GPU path (default): the live device kernel ``Source/kernels.cl:368-428`` —
  2x2 supersampled AA, nearest-hit over triangles then spheres, 10 jittered
  soft-shadow samples with a per-pixel xorshift stream, specular bounce loop
  with mirror reflection and medium-tracked refraction.
* CPU-ref mode (``cfg.cpu_ref``): the vestigial scalar CPU renderer
  ``Source/skeleton.cpp:184-279`` — one unnormalized primary ray per pixel,
  a single hard shadow ray with relative bias 1e-3, host shading constants,
  no spheres / AA / bounces.

Everything is computed with the reference's exact formulas (cofactor-expansion
determinants, reciprocal-then-multiply Cramer solves, the stable quadratic's
q/a, c/q root pairing) so the float32 results are directly comparable.
This file is deliberately independent of the port's ops modules; a scalar
C++ oracle (reference/cpp) cross-checks it in turn.
"""
from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..scene import Scene, scene_to_numpy

F32 = np.float32
_UINT_MAX_F = np.float32(4294967295.0)  # rounds to 2^32 in f32, as in OpenCL


# --------------------------------------------------------------------------
# Small math helpers (exact reference formulas)
# --------------------------------------------------------------------------

def _det3(a, b, c):
    """Cofactor-expansion 3x3 determinant of rows (a, b, c), the exact
    expression of ``kernels.cl:31-35``. Inputs broadcast; last axis is xyz."""
    return (
        a[..., 0] * (b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1])
        - a[..., 1] * (b[..., 0] * c[..., 2] - b[..., 2] * c[..., 0])
        + a[..., 2] * (b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0])
    )


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v):
    return v / np.sqrt(_dot(v, v))[..., None]


def _xorshift(state: np.ndarray) -> np.ndarray:
    """3-lane xorshift on uint32 (``kernels.cl:42-47``)."""
    state = state ^ (state << np.uint32(13))
    state = state ^ (state >> np.uint32(17))
    state = state ^ (state << np.uint32(5))
    return state


def _crush(state: np.ndarray, rng: float) -> np.ndarray:
    """uint3 -> float3 in (-range/2, range/2) (``kernels.cl:49-52``)."""
    r = F32(rng)
    return r * (state.astype(np.float32)) / _UINT_MAX_F - r / F32(2.0)


def _shadow_seed(gid: np.ndarray) -> np.ndarray:
    """Per-pixel RNG seed ``(gid, gid*91.0f, gid*19.0f)`` including the
    float-multiply-then-truncate quirk (``kernels.cl:319``)."""
    g = gid.astype(np.uint32)
    gf = gid.astype(np.float32)
    s = np.stack([
        g,
        (gf * F32(91.0)).astype(np.uint32),
        (gf * F32(19.0)).astype(np.uint32),
    ], axis=-1)
    return _xorshift(s)


def rotation_matrix(yaw: float, pitch: float) -> np.ndarray:
    """Row-major yaw*pitch camera rotation (``skeleton.cpp:149-151``).
    Applied to a direction d as (r0.d, r1.d, r2.d) (``kernels.cl:398-400``)."""
    cy, sy = F32(np.cos(yaw)), F32(np.sin(yaw))
    cp, sp = F32(np.cos(pitch)), F32(np.sin(pitch))
    return np.array([
        [cy, sp * sy, sy * cp],
        [0.0, cp, -sp],
        [-sy, cy * sp, cp * cy],
    ], dtype=np.float32)


# --------------------------------------------------------------------------
# Intersection
# --------------------------------------------------------------------------

def _to_np_scene(scene: Scene) -> dict:
    d = scene_to_numpy(scene)
    # Normals recomputed from vertices with the reference formula
    # normalize(cross(e2, e1)) (TestModelH.h:26-35).
    e1 = d["tri_v1"] - d["tri_v0"]
    e2 = d["tri_v2"] - d["tri_v0"]
    n = np.cross(e2, e1)
    d["tri_n"] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return d


def _intersect(sc: dict, start: np.ndarray, direction: np.ndarray) -> dict:
    """Nearest hit over triangles then spheres for rays (start[N,3], dir[N,3]).

    Semantics of ``single_ray_intersections`` (``kernels.cl:168-241``):
    triangles scanned first with strict nearest-t (ties keep the lowest
    index), then spheres with strict < against the triangle best; a sphere's
    candidate root is x_min if x_min >= 0, else x_max.
    """
    v0 = sc["tri_v0"]                      # [T,3]
    e1 = sc["tri_v1"] - v0
    e2 = sc["tri_v2"] - v0
    d = direction[:, None, :]              # [N,1,3]
    b = start[:, None, :] - v0[None]       # [N,T,3]

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        recip = F32(1.0) / _det3(-d, e1[None], e2[None])
        t = _det3(b, e1[None], e2[None]) * recip
        u = _det3(-d, b, e2[None]) * recip
        v = _det3(-d, e1[None], b) * recip
        valid = (t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)
        t_m = np.where(valid, t, np.float32(np.inf))
        t_m = np.where(np.isnan(t_m), np.float32(np.inf), t_m)
        tri_idx = np.argmin(t_m, axis=1)                      # [N]
        ar = np.arange(start.shape[0])
        tri_t = t_m[ar, tri_idx]
        uu, vv = u[ar, tri_idx], v[ar, tri_idx]
        tri_pos = v0[tri_idx] + uu[:, None] * e1[tri_idx] + vv[:, None] * e2[tri_idx]

        # Spheres (stable quadratic per kernels.cl:208-238).
        sph_t = np.full_like(tri_t, np.inf)
        sph_idx = np.zeros_like(tri_idx)
        if sc["sph_center"].shape[0]:
            L = start[:, None, :] - sc["sph_center"][None]    # [N,S,3]
            a_q = _dot(direction, direction)[:, None]
            b_q = F32(2.0) * _dot(direction[:, None, :], L)
            c_q = _dot(L, L) - sc["sph_r2"][None]
            disc = b_q * b_q - F32(4.0) * a_q * c_q
            sq = np.sqrt(np.maximum(disc, 0))
            q = np.where(b_q > 0, F32(-0.5) * (b_q + sq), F32(-0.5) * (b_q - sq))
            x0, x1 = q / a_q, c_q / q
            xmin, xmax = np.minimum(x0, x1), np.maximum(x0, x1)
            cand = np.where(xmin >= 0, xmin, xmax)
            okay = (disc >= 0) & (cand >= 0)
            st = np.where(okay, cand, np.float32(np.inf))
            st = np.where(np.isnan(st), np.float32(np.inf), st)
            sph_idx = np.argmin(st, axis=1)
            sph_t = st[ar, sph_idx]

    sphere_wins = sph_t < tri_t
    hit_any = np.isfinite(np.where(sphere_wins, sph_t, tri_t))

    if sc["sph_center"].shape[0]:
        sph_t_safe = np.where(np.isfinite(sph_t), sph_t, np.float32(0.0))
        pos = np.where(sphere_wins[:, None],
                       start + direction * sph_t_safe[:, None], tri_pos)
        sph_n = _normalize(pos - sc["sph_center"][sph_idx])
        normal = np.where(sphere_wins[:, None], sph_n, sc["tri_n"][tri_idx])
        rgb = np.where(sphere_wins[:, None], sc["sph_rgb"][sph_idx],
                       sc["tri_rgb"][tri_idx])
        mat = np.where(sphere_wins, sc["sph_mat"][sph_idx], sc["tri_mat"][tri_idx])
    else:
        pos = tri_pos
        normal = sc["tri_n"][tri_idx]
        rgb = sc["tri_rgb"][tri_idx]
        mat = sc["tri_mat"][tri_idx]
    hit_id = np.where(sphere_wins, -2, tri_idx).astype(np.int32)
    hit_id = np.where(hit_any, hit_id, -1)
    return {"hit": hit_any, "pos": pos, "normal": normal, "rgb": rgb,
            "mat": mat, "id": hit_id,
            "t": np.where(sphere_wins, sph_t, tri_t)}


def _in_shadow(sc: dict, start: np.ndarray, direction: np.ndarray,
               radius_sq: np.ndarray) -> np.ndarray:
    """Occlusion query toward the light (``kernels.cl:243-311``): glass
    objects (mat == -1) cast no shadow; an occluder counts if it lies at
    t >= 0 with |t*dir|^2 < radius_sq."""
    v0 = sc["tri_v0"]
    e1 = sc["tri_v1"] - v0
    e2 = sc["tri_v2"] - v0
    d = direction[:, None, :]
    b = start[:, None, :] - v0[None]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        recip = F32(1.0) / _det3(-d, e1[None], e2[None])
        t = _det3(b, e1[None], e2[None]) * recip
        dist = t * t * _dot(direction, direction)[:, None]
        u = _det3(-d, b, e2[None]) * recip
        v = _det3(-d, e1[None], b) * recip
        occ_t = ((t >= 0) & (dist < radius_sq[:, None])
                 & (u >= 0) & (v >= 0) & ((u + v) <= 1)
                 & (sc["tri_mat"][None] != F32(-1.0)))
        occluded = np.any(occ_t, axis=1)

        if sc["sph_center"].shape[0]:
            L = start[:, None, :] - sc["sph_center"][None]
            a_q = _dot(direction, direction)[:, None]
            b_q = F32(2.0) * _dot(direction[:, None, :], L)
            c_q = _dot(L, L) - sc["sph_r2"][None]
            disc = b_q * b_q - F32(4.0) * a_q * c_q
            sq = np.sqrt(np.maximum(disc, 0))
            q = np.where(b_q > 0, F32(-0.5) * (b_q + sq), F32(-0.5) * (b_q - sq))
            x0, x1 = q / a_q, c_q / q
            xmin, xmax = np.minimum(x0, x1), np.maximum(x0, x1)
            dd = _dot(direction, direction)[:, None]
            occ_s = ((disc >= 0) & (sc["sph_mat"][None] != F32(-1.0))
                     & (((xmin >= 0) & (xmin * xmin * dd < radius_sq[:, None]))
                        | ((xmax >= 0) & (xmax * xmax * dd < radius_sq[:, None]))))
            occluded |= np.any(occ_s, axis=1)
    return occluded


# --------------------------------------------------------------------------
# Shading
# --------------------------------------------------------------------------

def _direct_light(sc: dict, cfg: RenderConfig, pos: np.ndarray,
                  normal: np.ndarray, gid: np.ndarray) -> np.ndarray:
    """Soft-shadowed inverse-square Lambert (``kernels.cl:313-340``).

    The per-sample jitter perturbs only the occlusion test direction; the
    Lambert term uses the unperturbed, *unnormalized* shadow direction both
    in the dot product and the 1/(4 pi r^2) falloff — kept verbatim."""
    sdir = sc["light_pos"][None] - pos                      # unnormalized
    start = pos + F32(cfg.bias) * sdir
    radius_sq = _dot(sdir, sdir)
    with np.errstate(invalid="ignore"):
        lamb = (sc["light_color"][None]
                * np.maximum(_dot(sdir, normal), 0)[:, None]
                / (F32(4.0) * F32(np.pi) * radius_sq)[:, None])
    state = _shadow_seed(gid)
    total = np.zeros_like(pos)
    for _ in range(cfg.shadow_samples):
        state = _xorshift(state)
        jitter = _crush(state, cfg.light_spread)
        lit = ~_in_shadow(sc, start, sdir + jitter, radius_sq)
        total += lit[:, None].astype(np.float32) * lamb
    return total / F32(cfg.shadow_samples)


def _schlick(c1: np.ndarray, n1: np.ndarray, n2: np.ndarray) -> np.ndarray:
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1 - r0) * (1 - c1) ** 5


def _secondary_light(sc: dict, cfg: RenderConfig, primary: dict,
                     direction: np.ndarray, gid: np.ndarray) -> np.ndarray:
    """Specular bounce loop (``kernels.cl:342-365``) vectorized with masks.

    State per ray mirrors the reference Ray record; rays stay active while
    the last hit is specular (mat <= 0); on a diffuse hit the contribution
    is 0.9 * (indirect + direct) * color; a miss (or an exhausted bounce
    budget) is black."""
    n = direction.shape[0]
    active = primary["hit"] & (primary["mat"] <= 0)
    result = np.zeros((n, 3), dtype=np.float32)
    weight = np.ones((n,), dtype=np.float32)     # Fresnel throughput (ext.)

    cur_dir = direction.copy()
    cur_pos = primary["pos"].copy()
    cur_normal = primary["normal"].copy()
    cur_mat = primary["mat"].copy()
    medium = np.full((n,), F32(cfg.ior_air), dtype=np.float32)

    for _ in range(cfg.bounces):
        if not active.any():
            break
        # --- reflect (mat == 0), kernels.cl:54-65 ---
        dn = _dot(cur_dir, cur_normal)
        refl_dir = cur_dir - F32(2.0) * dn[:, None] * cur_normal

        # --- refract (mat < 0), kernels.cl:67-88 ---
        c1 = _dot(cur_normal, cur_dir)
        nrm = np.where(c1[:, None] < 0, -cur_normal, cur_normal)
        c1a = np.abs(c1)
        in_air = medium == F32(cfg.ior_air)
        n1 = np.where(in_air, F32(cfg.ior_air), F32(cfg.ior_glass))
        n2 = np.where(in_air, F32(cfg.ior_glass), F32(cfg.ior_air))
        nr = n1 / n2
        with np.errstate(invalid="ignore"):
            k = F32(1.0) - nr * nr * (F32(1.0) - c1a * c1a)
            c2 = np.sqrt(k)  # NaN when k < 0 (TIR) — the reference quirk
        refr_dir = nr[:, None] * cur_dir + (nr * c1a - c2)[:, None] * (-nrm)
        tir = k < 0

        is_refl = cur_mat == 0
        if cfg.quirk_nan_tir:
            # Reproduce the reference: TIR rays keep NaN directions, so every
            # later intersection test fails and the ray goes black.
            new_dir = np.where(is_refl[:, None], refl_dir, refr_dir)
            new_medium = np.where(is_refl, F32(cfg.ior_air), n2)
        else:
            # Fixed TIR: reflect instead (medium reset to AIR, matching what
            # the reference's reflect_ray would have done had its TIR branch
            # been reachable).
            use_refl = is_refl | tir
            new_dir = np.where(use_refl[:, None], refl_dir, refr_dir)
            new_medium = np.where(use_refl, F32(cfg.ior_air), n2)
        if cfg.fresnel:
            # Deterministic single-path Fresnel: follow refraction with
            # Schlick transmittance as a throughput weight (TIR/mirror
            # reflections keep weight 1).
            refl_w = _schlick(c1a, n1, n2)
            w_step = np.where(is_refl | tir, F32(1.0), F32(1.0) - refl_w)
            weight = np.where(active, weight * w_step, weight)

        new_start = cur_pos + F32(cfg.bias) * new_dir
        with np.errstate(invalid="ignore"):
            new_dir = _normalize(new_dir)

        hit = _intersect(sc, new_start, new_dir)
        diffuse = active & hit["hit"] & (hit["mat"] > 0)
        if diffuse.any():
            dl = _direct_light(sc, cfg, hit["pos"][diffuse],
                               hit["normal"][diffuse], gid[diffuse])
            shade = F32(0.9) * (sc["indirect_light"][None] + dl) * hit["rgb"][diffuse]
            result[diffuse] = shade * weight[diffuse, None]
        missed = active & ~hit["hit"]
        # miss -> stays black; update state for rays still specular
        cont = active & hit["hit"] & (hit["mat"] <= 0)
        cur_dir = np.where(cont[:, None], new_dir, cur_dir)
        cur_pos = np.where(cont[:, None], hit["pos"], cur_pos)
        cur_normal = np.where(cont[:, None], hit["normal"], cur_normal)
        cur_mat = np.where(cont, hit["mat"], cur_mat)
        medium = np.where(cont, new_medium, medium)
        active = cont
        del missed
    return result


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def render_oracle(scene: Scene, cfg: RenderConfig,
                  chunk_rows: int = 64) -> np.ndarray:
    """Render the float image [H, W, 3] with oracle (NumPy f32) semantics."""
    if cfg.cpu_ref:
        return _render_cpu_ref(scene, cfg, chunk_rows)
    return _render_gpu_path(scene, cfg, chunk_rows)


def _render_gpu_path(scene: Scene, cfg: RenderConfig, chunk_rows: int) -> np.ndarray:
    sc = _to_np_scene(scene)
    W, H = cfg.width, cfg.height
    ax, ay = cfg.aa_x, cfg.aa_y
    R = rotation_matrix(float(sc["yaw"]), float(sc["pitch"]))
    out = np.zeros((H, W, 3), dtype=np.float32)

    for y0 in range(0, H, chunk_rows):
        y1 = min(y0 + chunk_rows, H)
        ys, xs = np.mgrid[y0:y1, 0:W]
        gid_pix = (ys * W + xs).reshape(-1)               # [P]
        # Virtual supersample grid ray directions (kernels.cl:384-407).
        base = np.stack([
            (xs * ax - (W * ax) / 2.0).astype(np.float32),
            (ys * ay - (H * ay) / 2.0).astype(np.float32),
            np.full_like(xs, cfg.effective_focal, dtype=np.float32),
        ], axis=-1).reshape(-1, 1, 3)                     # [P,1,3]
        offs = np.array([[dx, dy, 0.0] for dy in range(ay) for dx in range(ax)],
                        dtype=np.float32)                 # [A,3]
        d = base + offs[None]                             # [P,A,3]
        d = d @ R.T                                       # rows dotted: (r0.d, r1.d, r2.d)
        d = _normalize(d).reshape(-1, 3)                  # [P*A,3]
        n_rays = d.shape[0]
        start = np.broadcast_to(sc["camera_pos"], (n_rays, 3)).astype(np.float32)
        gid = np.repeat(gid_pix, ax * ay)

        hit = _intersect(sc, start, d)
        color = np.zeros((n_rays, 3), dtype=np.float32)
        diffuse = hit["hit"] & (hit["mat"] > 0)
        if diffuse.any():
            dl = _direct_light(sc, cfg, hit["pos"][diffuse],
                               hit["normal"][diffuse], gid[diffuse])
            color[diffuse] = hit["rgb"][diffuse] * (sc["indirect_light"][None] + dl)
        specular = hit["hit"] & (hit["mat"] <= 0)
        if specular.any() and cfg.bounces > 0:
            sub = {k: v[specular] for k, v in hit.items()}
            color[specular] = _secondary_light(sc, cfg, sub, d[specular],
                                               gid[specular])
        acc = color.reshape(y1 - y0, W, ax * ay, 3)
        out[y0:y1] = acc.sum(axis=2) / F32(cfg.aa_rays)
    return out


def _render_cpu_ref(scene: Scene, cfg: RenderConfig, chunk_rows: int) -> np.ndarray:
    """The vestigial CPU renderer (``skeleton.cpp:184-279``): unnormalized
    primary rays, distance measured as |t*d|, hard shadows with relative bias,
    precomputed normals, host shading constants, triangles only.

    Deviation (documented): the commented-out reference code builds its 4x4
    rotation via a transposed memcpy with junk in the w column; we apply the
    same 3x3 yaw-pitch rotation as the GPU path, which is the obvious intent
    and is the identity at yaw = pitch = 0 (the only configuration the
    baseline config exercises)."""
    sc = _to_np_scene(scene)
    W, H = cfg.width, cfg.height
    R = rotation_matrix(float(sc["yaw"]), float(sc["pitch"]))
    out = np.zeros((H, W, 3), dtype=np.float32)

    for y0 in range(0, H, chunk_rows):
        y1 = min(y0 + chunk_rows, H)
        ys, xs = np.mgrid[y0:y1, 0:W]
        d = np.stack([
            (xs - W / 2.0).astype(np.float32),
            (ys - H / 2.0).astype(np.float32),
            np.full_like(xs, cfg.effective_focal, dtype=np.float32),
        ], axis=-1).reshape(-1, 3)
        d = (d @ R.T).astype(np.float32)   # NOT normalized (skeleton.cpp:259)
        n_rays = d.shape[0]
        start = np.broadcast_to(sc["camera_pos"], (n_rays, 3)).astype(np.float32)

        hit = _tri_only_intersect(sc, start, d)
        color = np.zeros((n_rays, 3), dtype=np.float32)
        m = hit["hit"]
        if m.any():
            dl = _cpu_direct_light(sc, cfg, hit["pos"][m], hit["normal"][m])
            color[m] = hit["rgb"][m] * (dl + sc["indirect_light"][None])
        out[y0:y1] = color.reshape(y1 - y0, W, 3)
    return out


def _tri_only_intersect(sc: dict, start: np.ndarray, d_in: np.ndarray) -> dict:
    """``closest_intersection`` (``skeleton.cpp:184-218``): triangles only;
    distance recorded as length(t*d) in unnormalized-direction units."""
    v0 = sc["tri_v0"]
    e1 = sc["tri_v1"] - v0
    e2 = sc["tri_v2"] - v0
    d = d_in[:, None, :]
    b = start[:, None, :] - v0[None]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        detA = _det3(-d, e1[None], e2[None])
        t = _det3(b, e1[None], e2[None]) / detA
        u = _det3(-d, b, e2[None]) / detA
        v = _det3(-d, e1[None], b) / detA
        valid = (t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)
        t_m = np.where(valid, t, np.float32(np.inf))
        t_m = np.where(np.isnan(t_m), np.float32(np.inf), t_m)
    idx = np.argmin(t_m, axis=1)
    ar = np.arange(start.shape[0])
    tb = t_m[ar, idx]
    hit_any = np.isfinite(tb)
    uu, vv = u[ar, idx], v[ar, idx]
    pos = v0[idx] + uu[:, None] * e1[idx] + vv[:, None] * e2[idx]
    tb_safe = np.where(hit_any, tb, np.float32(0.0))
    dist = np.sqrt(_dot(tb_safe[:, None] * d_in, tb_safe[:, None] * d_in))
    return {"hit": hit_any, "pos": pos, "normal": sc["tri_n"][idx],
            "rgb": sc["tri_rgb"][idx], "id": np.where(hit_any, idx, -1),
            "t": tb, "dist": dist}


def _cpu_direct_light(sc: dict, cfg: RenderConfig, pos: np.ndarray,
                      normal: np.ndarray) -> np.ndarray:
    """``direct_light`` (``skeleton.cpp:220-241``): one hard shadow ray with
    start biased by r*1e-3; occluded if the nearest hit's unnormalized-units
    distance is below the light radius."""
    r = sc["light_pos"][None] - pos
    radius = np.sqrt(_dot(r, r))
    shadow_start = pos + F32(cfg.cpu_ref_bias) * r
    occ = _tri_only_intersect(sc, shadow_start, r)
    shadowed = occ["hit"] & (occ["dist"] < radius)
    lamb = (sc["light_color"][None] * np.maximum(_dot(r, normal), 0)[:, None]
            / (F32(4.0) * F32(np.pi) * radius * radius)[:, None])
    return np.where(shadowed[:, None], F32(0.0), lamb)


def pack_argb_np(img: np.ndarray) -> np.ndarray:
    """Pack a float image [H,W,3] to ARGB8888 uint32 exactly as
    ``color_pixel`` (``kernels.cl:37-40``): trunc(clamp(255*c, 0, 255)),
    alpha 255."""
    rgb = np.clip(F32(255.0) * img, 0.0, 255.0).astype(np.uint32)
    return ((np.uint32(255) << np.uint32(24))
            + (rgb[..., 0] << np.uint32(16))
            + (rgb[..., 1] << np.uint32(8))
            + rgb[..., 2])
