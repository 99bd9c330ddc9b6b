"""Operation counts and roofline instruments for the port on the card.

Two kinds of count live here, and they are not interchangeable:

* The TPU kernels' counts, copied from the JAX package
  (``uob_raytracer_tpu/flops.py``): ``forward_ops`` and ``backward_ops``
  count VPU vector ops per (8,128) tile lane by that package's rules
  (mul/add/compare/select = 1, FMA = 1, the scalar unit free), and
  ``bounce_tile_fracs_from_residuals`` weighs the bounce steps by the
  (8,128) tiles still live. They describe the Pallas kernels.
* The card's counts: ``fwd_work``, ``bwd_work``, ``segment_sum_work``,
  ``nearest_work`` and ``occluded_work`` give (bytes, float32 operations)
  of one launch of the port's CUDA kernels per ray, row and executed step,
  hand-counted from the formulas of ``csrc/*.cu`` (no FMA: the build is
  ``--fmad=false``, so a multiply-add is two operations; good to about
  +-30%), scaled by what a run's decision record says ran. ``bound`` turns
  them into the least time the card could take: the larger of bytes over
  ``PEAK_BYTES`` and operations over ``PEAK_FP32`` (the data sheet's), or
  over a measured rate. ``chain_share``, ``scatter_work``,
  ``first_occluder`` and ``occluded_lanes`` count, from a record or a ray
  batch, what sets K2's and K5's gaps (chain rays, warp shuffles, the rows
  a ray tests before its first occluder, the lane-rows a warp issues);
  they stay out of ``bound``.

The instruments, the counterparts of the JAX package's roofline machinery:

* ``measure_fp32_peak`` times K6 (``kernels/peak.py``, ``csrc/peak.cu``),
  the FP32 calibration chains, on the card: the counterpart of
  ``measure_vpu_peak``.
* ``sass_census`` and ``kernel_resources`` read what the compiler made of a
  kernel (the SASS of the built library through ``cuobjdump``; the ptxas
  report in the build log): the counterparts of ``census_kernel_ops`` and
  ``census_occupancy``, which read JAX IR and have no port. The critical
  path stays an input of the twin, as in the JAX package.
* ``build_bwd_structure_twin`` sizes K7 (``kernels/bwd_twin.py``,
  ``csrc/bwd_twin.cu``), the structure twin of the backward kernel K2,
  launch for launch (K2's chain-free launch and its chain launch, by K2's
  own rule), each to that launch's operation count, dependency depth and
  registers, with the operation counts of the twin's body stated analytically
  (``twin_ops_per_ray``, ``twin_depth_per_ray``) and checked against its
  SASS on the card.
"""
from __future__ import annotations

import functools
import re
import subprocess

import numpy as np
import torch

from .config import RenderConfig
from .kernels import _build, bwd_twin, peak, render_bwd
from .ops.replay import Residuals

# ---------------------------------------------------------------------------
# The TPU kernels' vector-op counts (uob_raytracer_tpu/flops.py:31-115),
# per (8,128) tile lane by the JAX package's rules
# ---------------------------------------------------------------------------

PRIMARY_PER_TRI = 29       # shared-origin fast path (_nearest_hit_primary)
PRIMARY_PER_SPH = 28
PRIMARY_GATHER_PER_TRI = 8  # winner reconstruction (1 cmp + 7 selects)
SHADOW_FIXED_PER_TRI = 20  # per-triangle invariants (b, t_num, B2, B1)
SHADOW_PER_TRI_SAMPLE = 25  # division-free accept test per jittered ray
SHADOW_PER_SPH_SAMPLE = 30
SHADOW_JITTER_PER_SAMPLE = 38  # xorshift3 + crush3 + dir add + |d|^2
BOUNCE_PER_TRI = 100       # general-origin Cramer scan (_nearest_hit body)
BOUNCE_PER_SPH = 60
BOUNCE_FIXED = 90          # reflect + refract + renormalize + bookkeeping
RAYGEN_SHADE_FIXED = 80    # ray gen, Lambert, combine, AA mean, pack


def forward_ops(cfg: RenderConfig, n_tri: int, n_sph: int,
                bounce_tile_fracs=None) -> dict:
    """Vector-op breakdown of the TPU forward kernel for one frame.

    bounce_tile_fracs: per-bounce-step fraction of (8,128) tiles still
    active (``bounce_tile_fracs_from_residuals``); defaults to the
    Cornell-like estimate (~14% of tiles hold a specular object, halving
    per step)."""
    lanes = cfg.width * cfg.height * cfg.aa_rays
    S = cfg.shadow_samples
    primary = (n_tri * PRIMARY_PER_TRI + n_sph * PRIMARY_PER_SPH
               + n_tri * PRIMARY_GATHER_PER_TRI)
    shadow = (n_tri * (SHADOW_FIXED_PER_TRI + SHADOW_PER_TRI_SAMPLE * S)
              + n_sph * SHADOW_PER_SPH_SAMPLE * S
              + SHADOW_JITTER_PER_SAMPLE * S)
    if bounce_tile_fracs is None:
        bounce_tile_fracs = [0.14 * 0.5 ** b for b in range(cfg.bounces)]
    per_bounce = (BOUNCE_FIXED + n_tri * BOUNCE_PER_TRI
                  + n_sph * BOUNCE_PER_SPH)
    bounce = per_bounce * float(np.sum(bounce_tile_fracs[:cfg.bounces]))
    per_lane = primary + shadow + bounce + RAYGEN_SHADE_FIXED
    return {
        "lanes": lanes,
        "per_lane": {"primary": primary, "shadow": shadow,
                     "bounce": round(bounce, 1),
                     "fixed": RAYGEN_SHADE_FIXED},
        "total": lanes * per_lane,
    }


# the TPU replay backward (dynamic-depth chain design), same rules;
# reverse-mode factors: a vjp over a straight-line block costs ~3x its primal
BWD_GATHER_PER_TRI = 17      # per-object select-accumulate (_gather_row)
BWD_GATHER_PER_SPH = 8
BWD_F1 = 480                 # ray gen + _hit_from_row primal + vjp (3x ~160)
BWD_F3 = 240                 # _shade_tile primal + vjp (3x ~80)
BWD_SCATTER_PER_TRI = 2      # per-object any() test (masked-sum gate)
BWD_SCATTER_HIT = 150        # ~5 hit objects x 15 masked sums x ~2 ops/lane
BWD_STEP_FWD = 255           # _bounce_step + _hit_from_row + carry store
BWD_STEP_BWD = 760           # step vjp (3x) + carry load
BWD_FIXED = 80               # residual loads, id casts, liveness, img store


def backward_ops(cfg: RenderConfig, n_tri: int, n_sph: int,
                 bounce_tile_fracs=None) -> dict:
    """Vector-op breakdown of the TPU backward kernel for one pass: each
    bounce step runs only on tiles still live there, in the forward replay
    and the reverse sweep alike."""
    lanes = cfg.width * cfg.height * cfg.aa_rays
    gather = n_tri * BWD_GATHER_PER_TRI + n_sph * BWD_GATHER_PER_SPH
    scatter = n_tri * BWD_SCATTER_PER_TRI + BWD_SCATTER_HIT
    if bounce_tile_fracs is None:
        bounce_tile_fracs = [0.14 * 0.5 ** b for b in range(cfg.bounces)]
    live = float(np.sum(bounce_tile_fracs[:cfg.bounces]))
    per_step = (2 * gather              # regathered in fwd and reverse
                + BWD_STEP_FWD + BWD_STEP_BWD + scatter)
    per_lane = (gather + BWD_F1 + BWD_F3 + scatter   # primary site
                + live * per_step + BWD_FIXED)
    return {
        "lanes": lanes,
        "per_lane": {"prim": gather + BWD_F1 + BWD_F3 + scatter,
                     "chain": round(live * per_step, 1),
                     "fixed": BWD_FIXED},
        "total": lanes * per_lane,
    }


def bounce_tile_fracs_from_residuals(res, bounces: int):
    """Per-step fractions of (8,128) tiles live in the TPU kernel: a tile
    runs bounce step b iff any of its lanes is active there. ``res.bounce_id``
    [B, A, H, W] may be a torch tensor or a numpy array."""
    if bounces == 0:
        return []
    bid = res.bounce_id
    bid = bid.cpu().numpy() if isinstance(bid, torch.Tensor) else np.asarray(bid)
    B, A, H, W = bid.shape
    hp, wp = -(-H // 8) * 8, -(-W // 128) * 128
    pad = np.full((B, A, hp, wp), -1, bid.dtype)
    pad[:, :, :H, :W] = bid
    tiles = pad.reshape(B, A, hp // 8, 8, wp // 128, 128)
    active = (tiles >= 0).any(axis=(1, 3, 5))     # [B, th, tw]
    return [float(a.mean()) for a in active]


# ---------------------------------------------------------------------------
# The card's counts: bytes and float32 operations of the work these inputs
# need. One operation = one add, multiply, divide, sqrt or compare on
# float32, counted from the formulas of csrc/*.cu (no FMA: a multiply-add is
# two). The per-item constants are hand counts, good to about +-30%.
# ---------------------------------------------------------------------------

# H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor cores
# (an FMA counts two there)
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


# The shadow pass of the whole-table forward kernel (csrc/render_fwd.cu,
# fwd_common.cuh): per occluder row and shading ray the row's invariants
# (occ_row_invariants: the "casts a shadow" test, b, t_num, t_num^2, b x e2,
# e1 x b), per row and sample ray still unoccluded the sample part
# (occ_row_sample: three dot products and the accept test); per sphere the
# same split (occ_sph_invariants: L and c_q; occ_sph_sample: the roots).
# A scan that takes one sample at a time pays both parts per sample: 55
# and 30 per test.
OCC_ROW_INV, OCC_ROW_SAMPLE = 27, 28
OCC_SPH_INV, OCC_SPH_SAMPLE = 9, 21


def fwd_work(cfg, scene, quads, res: Residuals, record: bool,
             per_sample: bool = False):
    """(bytes, operations) of one forward frame. Operations: per ray the
    primary scan; per executed bounce step a general nearest-hit scan; per
    shading ray the occlusion scan: the invariants of every row and sphere
    (the record shows a lit sample, which the scan takes to the last row),
    the sample part of every row for a lit sample (the record's lit count)
    and of one row for an occluded one (its scan stops at the first
    occluder). Shading rays whose samples are all occluded do not show in
    the record (lit 0) and are not counted, so this is a lower bound.
    ``per_sample``: the count of a scan that takes one sample at a time,
    every sample paying the invariants too (the kernel's count before it
    hoisted them; kept so that shares stay comparable)."""
    n_tri = scene.num_triangles
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    n_rows = n_tri if quads is None else len(quads[0]) + len(quads[1])
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    shading = int((res.lit_cnt > 0).sum())   # lower bound: lit 0 not seen
    lit = float(res.lit_cnt.sum())
    occluded = shading * cfg.shadow_samples - lit
    row, sph = OCC_ROW_INV + OCC_ROW_SAMPLE, OCC_SPH_INV + OCC_SPH_SAMPLE
    if per_sample:
        shadow = lit * (row * n_rows + sph * n_sph) + occluded * row
    else:
        shadow = (shading * (OCC_ROW_INV * n_rows + OCC_SPH_INV * n_sph)
                  + lit * (OCC_ROW_SAMPLE * n_rows + OCC_SPH_SAMPLE * n_sph)
                  + occluded * OCC_ROW_SAMPLE)
    ops = (rays * (30 + 26 * n_tri + 40 * n_sph)
           + steps * (90 + 70 * n_tri + 45 * n_sph)
           + shading * 60 + (lit + occluded) * 30 + shadow)
    pix = cfg.width * cfg.height
    nbytes = (16 * pix + (rays * (8 + 4 * cfg.bounces) if record else 0)
              + 4 * (19 * n_tri + (13 * n_rows if quads is not None else 0)))
    return nbytes, ops


def pixels_of(res: Residuals, pixels) -> Residuals:
    """The record of the pixels of ``pixels`` (bool [rows * W]) only, each
    array's pixel axes flattened: what one launch of K2's split runs."""
    keep = pixels.reshape(-1).to(res.prim_id.device)
    return Residuals(*(t.reshape(*t.shape[:-2], -1)[..., keep]
                       if t.numel() else t for t in res))


def bwd_work(cfg, scene, res: Residuals, streamed: bool = False,
             pixels=None):
    """(bytes, operations) of one backward pass: the primary id, the lit
    count and the cotangent read once, the per-block partial sums written
    once (the whole-table kernel's hold every object, the streamed kernel's
    the spheres and the camera), and of the per-step ids only those the
    replay reads: one per executed step, and one more per chain for the
    entry that ends it; the streamed kernel also reads a 76 B row and
    writes a 64 B cotangent row per site that hit a triangle; per ray the
    primary hit's replay and adjoint and the shading adjoint, per executed
    bounce step its replay, the step's adjoint and the hit's. ``pixels``
    (bool [rows * W]): the rays, steps and pixels of those pixels only (the
    partial rows stay the whole grid's), as one launch of K2's split runs
    them."""
    n_tri = scene.num_triangles
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    if pixels is not None:
        res = pixels_of(res, pixels)
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    chains = int((res.bounce_id[0] >= 0).sum()) if cfg.bounces else 0
    pix = (cfg.width * cfg.height if pixels is None
           else int(pixels.reshape(-1).sum()))
    blocks = render_bwd.launch_blocks(
        pix, render_bwd.pixels_per_block(cfg.aa_rays) if streamed
        else render_bwd.THREADS)
    nbytes = rays * 8 + 4 * (steps + chains) + 12 * pix
    if streamed:
        ids = render_bwd.site_ids(res)
        live = int(((ids >= 0) & (ids < n_tri)).sum())
        nbytes += (76 + 64) * live + 4 * blocks * (n_sph * 16 + 21)
    else:
        nbytes += 4 * blocks * ((n_tri + n_sph) * render_bwd.GRAD_COLS + 21)
    ops = rays * 450 + steps * 650
    return nbytes, ops


def segment_sum_work(n_tri: int, ids):
    """(bytes, operations) of the segmented sum after one streamed backward:
    per site that hit a triangle its 8 B position and its 64 B row read and
    16 additions; the bounds read and the sums written once per triangle."""
    live = int(((ids >= 0) & (ids < n_tri)).sum())
    return (8 + 64) * live + (8 + 64) * n_tri, 16 * live


# Operations of one nearest-hit row test, hand counted from
# csrc/partial.cu:near_tile_row (each +, -, *, / and comparison one): b =
# start - v0 (3); detA and the t numerator from the row's cofactors (5 each:
# three products, two sums); u and v by det3 (14 each: three cofactors of
# 3, three products, two sums); the reciprocal (1) and t, u, v times it (3);
# u + v (1); the tests degen, t >= 0, u >= 0, v >= 0, u + v <= 1, t < best
# (6). tri_test (fwd_common.cuh), which takes detA and the t numerator by
# det3 too, takes 70.
NEAREST_ROW_OPS = 52


def nearest_work(n_tri: int, n_rays: int):
    """(bytes, operations) of one nearest-hit launch: the 64 B rows and the
    rays' 24 B read once, 48 B written per ray; per ray and row
    ``NEAREST_ROW_OPS``, per row its cofactors once (9), per ray the
    winner's position (about 20)."""
    return 64 * n_tri + 72 * n_rays, (n_rays * (NEAREST_ROW_OPS * n_tri + 20)
                                      + 9 * n_tri)


def occluded_work(n_tri: int, bits):
    """(bytes, operations) of one occlusion launch on these rays: a ray
    that is lit needs every row (about 55 operations each), an occluded one
    the row that occludes it."""
    n, dark = bits.numel(), int(bits.sum())
    return (52 * n_tri + 29 * n,
            (n - dark) * 55 * n_tri + dark * 55 + 10 * n)


def bound(nbytes, ops, peak_fp32: float = PEAK_FP32) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations"): the larger of bytes
    over ``PEAK_BYTES`` and operations over ``peak_fp32`` (the data sheet's
    67 TFLOP/s unless a measured rate is given)."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / peak_fp32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# What sets K2's and K5's gaps to their bounds: the records' own counts,
# printed beside the bounds and kept out of them (so that the shares stay
# comparable from PR to PR)
# ---------------------------------------------------------------------------

WARP = 32


def chain_rays(scene, cfg: RenderConfig, res: Residuals) -> torch.Tensor:
    """[A, rows, W] bool: the rays with a bounce chain, those whose primary
    object is valid and specular (material code <= 0) when the config
    bounces at all; every other ray runs only the primary replay, the
    shading adjoint and the primary hit's adjoint."""
    if not cfg.bounces:
        return torch.zeros_like(res.prim_id, dtype=torch.bool)
    mats = [scene.tri_mat] + ([] if cfg.cpu_ref else [scene.sph_mat])
    mat = torch.cat(mats).detach().to(res.prim_id.device)
    pid = res.prim_id
    return (pid >= 0) & (mat[pid.clamp(min=0).long()] <= 0.0)


def chain_share(scene, cfg: RenderConfig, res: Residuals) -> dict:
    """The share of rays with a bounce chain, of pixels with at least one
    (those K2's chain launch takes whole), and of warps of 32 consecutive
    pixels with at least one; and the chain steps per ray."""
    ray = chain_rays(scene, cfg, res)
    pix = ray.reshape(ray.shape[0], -1).any(dim=0)
    n = pix.numel()
    pad = -n % WARP
    warps = torch.cat([pix, pix.new_zeros(pad)]).reshape(-1, WARP).any(dim=1)
    return {"rays": ray.float().mean().item(),
            "pixels": pix.float().mean().item(),
            "warps": warps.float().mean().item(),
            "steps_per_ray": chain_steps(scene, cfg, res) / ray.numel()}


def _distinct_valid(ids: np.ndarray) -> np.ndarray:
    """Per row of ids [..., 32]: how many distinct ids >= 0 it holds."""
    s = np.sort(ids, axis=-1)
    new = np.concatenate([np.ones_like(s[..., :1], dtype=bool),
                          s[..., 1:] != s[..., :-1]], axis=-1)
    return ((s >= 0) & new).sum(axis=-1)


def _warps_of(x: np.ndarray, fill) -> np.ndarray:
    """[..., n] -> [..., ceil(n / 32), 32], the last warp padded."""
    pad = -x.shape[-1] % WARP
    if pad:
        x = np.concatenate([x, np.full(x.shape[:-1] + (pad,), fill, x.dtype)],
                           axis=-1)
    return x.reshape(x.shape[:-1] + (-1, WARP))


# SHFL instructions a call makes: per distinct id at a site, the id's
# broadcast and a 5-level butterfly for each of the 16 columns; per warp a
# 5-level butterfly for each of the 21 camera columns
# (bwd_common.cuh:warp_scatter, warp_camera).
SCATTER_SHFL = 1 + 16 * 5
CAMERA_SHFL = 21 * 5


def scatter_work(scene, cfg: RenderConfig, res: Residuals,
                 scheme: str = "pr7") -> dict:
    """SHFL instructions that K2's warp scatter and camera sums issue on
    this record, counting each warp's distinct object ids per site.

    "pr6": one launch; warps of 32 consecutive pixels; every AA ray's
    primary site and every bounce site scattered at once. "pr7": the
    chain-free launch over every pixel (a pixel with a chain ray carries
    nothing there) and the chain launch over those pixels, compacted in
    order into warps of their own; in the chain-free launch a lane carries
    its primary site's row across its AA rays while the object repeats, so
    the warp scatters only when a lane's object changes and once at the
    pixel's end.

    Returns {"scatter", "camera", "total", "per_ray", "sites", "distinct"}:
    the shuffles, the warp-sites that scattered, and their distinct ids."""
    if scheme not in ("pr6", "pr7"):
        raise ValueError(f"scheme {scheme!r}: 'pr6' or 'pr7'")
    A = res.prim_id.shape[0]
    pid = res.prim_id.reshape(A, -1).cpu().numpy()
    n_pix = pid.shape[1]
    bid = (res.bounce_id.reshape(res.bounce_id.shape[0], A, -1).cpu().numpy()
           if cfg.bounces else np.zeros((0, A, n_pix), np.int32))
    chain = chain_rays(scene, cfg, res).reshape(A, -1).any(dim=0).cpu().numpy()
    counts = []                       # distinct ids per warp-site

    def sites(ids):                   # ids [..., warps, 32]
        d = _distinct_valid(ids).reshape(-1)
        counts.append(d[d > 0])

    if scheme == "pr6":
        sites(_warps_of(pid, -1))
        sites(_warps_of(bid, -1))
        warps = -(-n_pix // WARP)
    else:
        # the chain-free launch: deferred pixels carry nothing
        free = _warps_of(np.where(chain[None], -1, pid), -1)
        carry = np.full(free.shape[1:], -1, np.int32)
        for a in range(A):
            new = free[a]
            change = (carry >= 0) & (new >= 0) & (new != carry)
            sites(np.where(change, carry, -1))
            carry = np.where(new >= 0, new, carry)
        sites(carry)
        # the chain launch over the chain pixels, compacted in order; each
        # ray's sites scattered as it runs them
        sites(_warps_of(pid[:, chain], -1))
        sites(_warps_of(bid[:, :, chain], -1))
        warps = free.shape[1] + -(-int(chain.sum()) // WARP)
    d = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    scatter = int(d.sum()) * SCATTER_SHFL
    camera = warps * CAMERA_SHFL
    return {"scatter": scatter, "camera": camera, "total": scatter + camera,
            "per_ray": (scatter + camera) / (A * n_pix),
            "sites": int(d.size), "distinct": int(d.sum())}


def first_occluder(v0, e1, e2, mat, start, d, radius_sq) -> torch.Tensor:
    """int64 [N]: each ray's first occluding row of the shard (the plain
    test of ``ops/intersect.py:tris_occlude``, a chunk of rays at a time),
    n_tri where the ray is lit."""
    from .kernels.partial import _ray_chunks, _shard
    from .ops.intersect import tris_occlude_rows
    n_tri = v0.shape[0]
    ds = _shard(v0, e1, e2, v0, v0, mat)
    out = []
    with torch.no_grad():
        for c in _ray_chunks(start.shape[0], n_tri):
            occ = tris_occlude_rows(ds, start[c], d[c], radius_sq[c])
            first = torch.argmax(occ.to(torch.uint8), dim=1)
            out.append(torch.where(occ.any(dim=1), first, n_tri))
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=start.device)
    return torch.cat(out)


def occluded_lanes(first_row, n_tri: int, scheme: str = "pr6",
                   tile: int = 128, group: int = 4) -> dict:
    """How K5's threads spend their lane-rows on rays whose first occluding
    rows are ``first_row`` (``first_occluder``; n_tri: lit), one thread
    per ray in warps of 32 consecutive rays. A ray needs first_row + 1
    rows (n_tri when lit); a warp issues 32 lanes for as long as its
    slowest lane.

    "pr6": each lane stops at its occluder. "pr7": tiles of ``tile`` rows,
    ``group`` rows tested a step, a lane stopping at the end of the step
    that holds its occluder; a warp whose lanes have all stopped tests
    nothing more.

    Returns {"used": rows needed / lane-rows issued, "row_order": rows
    needed / the rows ``occluded_work`` counts (n_tri for a lit ray, 1 for
    an occluded one), "rows": rows needed, "issued": lane-rows issued}."""
    f = np.asarray(torch.as_tensor(first_row).cpu(), dtype=np.int64)
    lit = f >= n_tri
    need = np.where(lit, n_tri, f + 1)
    counted = int(lit.sum()) * n_tri + int((~lit).sum())
    if scheme == "pr6":
        issued = int(_warps_of(need, 0).max(axis=-1).sum()) * WARP
    elif scheme == "pr7":
        warps = _warps_of(f, -1)          # a padded lane carries no ray
        issued = 0
        for base in range(0, n_tri, tile):
            n_rows = min(tile, n_tri - base)
            # rows each lane still seeking tests in this tile, in whole steps
            rows = np.minimum(warps - base + 1, n_rows)
            rows = np.where(warps >= base, -(-rows // group) * group, 0)
            issued += int(rows.max(axis=-1).sum()) * WARP
    else:
        raise ValueError(f"scheme {scheme!r}: 'pr6' or 'pr7'")
    rows = int(need.sum())
    return {"used": rows / max(issued, 1), "row_order": rows / max(counted, 1),
            "rows": rows, "issued": issued}


# ---------------------------------------------------------------------------
# What the compiler made of a kernel: its SASS and its ptxas report
# ---------------------------------------------------------------------------

FP32_OPS = frozenset({"FADD", "FADD32I", "FMUL", "FMUL32I", "FFMA", "FFMA32I",
                      "FMNMX", "FSETP", "FSEL", "FSET", "MUFU", "FCHK",
                      "FRND", "FSWZADD"})
MEM_OPS = frozenset({"LD", "LDG", "LDS", "LDL", "LDC", "LDSM", "LDGSTS",
                     "ST", "STG", "STS", "STL", "SHFL", "ATOM", "ATOMG",
                     "ATOMS", "RED", "MEMBAR", "CCTL", "ULDC"})
CONTROL_OPS = frozenset({"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT",
                         "BSSY", "BSYNC", "BAR", "WARPSYNC", "BREAK", "BPT",
                         "KILL", "NOP", "YIELD", "VOTE", "VOTEU", "ELECT",
                         "ENDCOLLECTIVE"})
INT_OPS = frozenset({"LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "PRMT", "SEL",
                     "POPC", "FLO", "BREV", "BMSK", "SGXT", "PLOP3", "PSETP",
                     "P2R", "R2P", "VIADD", "VIMNMX", "VABSDIFF"})
CONVERT_OPS = frozenset({"I2F", "F2I", "F2F", "I2I", "F2FP", "I2FP"})
SASS_CLASSES = ("fp32", "int", "mem", "control", "other")

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L[\w.]+):")
_INSTR = re.compile(r"/\*([0-9a-fA-F]+)\*/\s+([^;]*?)\s*;")
_TARGET = re.compile(r"`\((\.L[\w.]+)\)|\b(0x[0-9a-fA-F]+)\s*$")


def sass_class(opcode: str) -> str:
    """The census class of one SASS opcode (modifiers after the first dot
    are ignored; a uniform-datapath U opcode counts as its vector twin)."""
    op = opcode.split(".")[0]
    if op in FP32_OPS:
        return "fp32"
    if op in MEM_OPS:
        return "mem"
    if op in CONTROL_OPS:
        return "control"
    if op in CONVERT_OPS:
        return "other"
    if op.startswith("I") or op in INT_OPS:
        return "int"
    if op.startswith("U") and len(op) > 1:
        return sass_class(op[1:])
    return "other"


def parse_sass(listing: str) -> dict:
    """{function name: {"instrs": [(address, opcode, branch target label or
    None)], "labels": {label: address}}} from a ``cuobjdump -sass``
    listing."""
    funcs, cur, pending = {}, None, []
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"instrs": [], "labels": {}})
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        if text.startswith("@"):
            text = text.split(None, 1)[1] if " " in text else ""
        if not text:
            continue
        for lab in pending:
            cur["labels"][lab] = addr
        pending = []
        op = text.split()[0]
        t = _TARGET.search(text) if op.startswith(("BRA", "BRX", "JMP")) else None
        if t and t.group(2):                   # a target given as an address
            cur["labels"].setdefault(t.group(2), int(t.group(2), 16))
        cur["instrs"].append((addr, op, (t.group(1) or t.group(2)) if t else None))
    return funcs


def sass_counts(instrs) -> dict:
    """Static instruction counts by class and by opcode (without its
    modifiers)."""
    out = {c: 0 for c in SASS_CLASSES}
    ops: dict = {}
    for _, opcode, _ in instrs:
        out[sass_class(opcode)] += 1
        base = opcode.split(".")[0]
        ops[base] = ops.get(base, 0) + 1
    out["total"] = len(instrs)
    out["opcodes"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out


def sass_loops(func: dict) -> list[dict]:
    """The loops of one parsed function: every backward branch, with the
    counts of the instructions from its target to itself (the SASS of one
    trip), innermost first. Loops of control instructions alone (the
    padding after EXIT) are left out."""
    loops = []
    for addr, _, target in func["instrs"]:
        start = func["labels"].get(target) if target else None
        if start is None or start > addr:
            continue
        body = [i for i in func["instrs"] if start <= i[0] <= addr]
        counts = sass_counts(body)
        if counts["total"] > counts["control"]:
            loops.append({"start": start, "end": addr, **counts})
    return sorted(loops, key=lambda lp: lp["end"] - lp["start"])


def mangled_fragment(kernel: str) -> str:
    """The piece of the Itanium-mangled name that identifies ``kernel``:
    "census_probe_kernel" -> "19census_probe_kernelE", "peak_chain<2, 16>"
    -> "10peak_chainILi2ELi16EE", "render_bwd_kernel<false>" ->
    "17render_bwd_kernelILb0EE" (int and bool template arguments only)."""
    m = re.fullmatch(r"\s*(\w+)\s*(?:<([^>]*)>)?\s*", kernel)
    if not m:
        raise ValueError(f"kernel name {kernel!r}: name or name<int, ...>")
    name, args = m.group(1), m.group(2)
    head = f"{len(name)}{name}"
    if args is None:
        return head + "E"

    def arg(a: str) -> str:
        a = a.strip()
        if a in ("false", "true"):
            return f"Lb{int(a == 'true')}E"
        return f"Li{int(a)}E" if int(a) >= 0 else f"Lin{-int(a)}E"

    return head + "I" + "".join(arg(a) for a in args.split(",")) + "E"


@functools.lru_cache(maxsize=2)
def _library_sass(library: str) -> dict:
    """``parse_sass`` of ``cuobjdump -sass`` of a built library (its name
    carries the hash of its sources, so an entry never goes stale)."""
    proc = subprocess.run([_build.tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {library} failed "
                           f"({proc.returncode}): {proc.stderr}")
    return parse_sass(proc.stdout)


def _find(funcs: dict, kernel: str):
    frag = mangled_fragment(kernel)
    hits = [k for k in funcs if frag in k]
    if len(hits) != 1:
        raise LookupError(f"{kernel} ({frag}): {len(hits)} matching functions "
                          f"of {len(funcs)} in the listing")
    return hits[0], funcs[hits[0]]


def sass_census(kernel: str, listing: str | None = None) -> dict:
    """Static SASS census of one kernel of the built library (``listing``:
    a ``cuobjdump -sass`` text instead): counts by class (fp32, int, mem,
    control, other) and by opcode, and the same for each of its loops
    (``sass_loops``). Without ``cuobjdump`` it raises."""
    funcs = (_library_sass(_build.build()[0]) if listing is None
             else parse_sass(listing))
    name, func = _find(funcs, kernel)
    return {"function": name, **sass_counts(func["instrs"]),
            "loops": sass_loops(func)}


def parse_ptxas(log: str) -> dict:
    """{function name: {"registers", "spill_stores", "spill_loads",
    "stack_bytes", "shared_bytes"}} from ptxas -v output."""
    funcs: dict = {}
    cur, props = None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            props.update(stack_bytes=int(m.group(1)),
                         spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["shared_bytes"] = int(s.group(1)) if s else 0
            cur = None
    return funcs


def kernel_resources(kernel: str) -> dict:
    """Registers, spill bytes, stack frame and static shared memory of one
    kernel of the built library, from the ptxas report in its build log."""
    path, _ = _build.build()
    with open(path[:-3] + ".log") as f:
        funcs = parse_ptxas(f.read())
    name, r = _find(funcs, kernel)
    return {"function": name, "registers": r.get("registers"),
            "spill_stores": r.get("spill_stores", 0),
            "spill_loads": r.get("spill_loads", 0),
            "stack_bytes": r.get("stack_bytes", 0),
            "shared_bytes": r.get("shared_bytes", 0)}


# ---------------------------------------------------------------------------
# K6: the FP32 peak of this card
# ---------------------------------------------------------------------------

PEAK_SHAPE = (512, 512)


def device_ms(fn, n: int) -> float:
    """Device milliseconds per call of fn over n back-to-back calls (CUDA
    events; a sleep queued first keeps the host's enqueue out of the
    window)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def measure_fp32_peak(iters: int = 20, ks=()) -> dict:
    """FP32 rates of this card from K6, the counterpart of the JAX
    package's ``measure_vpu_peak``: chains of K independent accumulators
    per element of a 512x512 input (one thread each), ``peak.INNER``
    iterations. Rates are in source operations per second (an FMA is one,
    a mix or bwdmix body ``peak.MIX_OPS_PER_ITER``), each with the rate of
    the FP32 instructions that its SASS loop body holds beside it.

    The headline {"fma", "add", "mix", "bwdmix"} entries use K=16 (with
    "sass" the matching instruction rates); with ``ks``, "<mode>_k" maps
    each K to {"rate", "P", "instrs", "fp32_instrs", "sass_rate",
    "issue_rate", "ms", "slope_ms"}. P = K: the accumulators are
    independent by construction (the JAX package reads P from its jaxpr).
    "instrs" and "fp32_instrs" are the SASS instructions of one iteration
    (all K accumulators; a trip of the loop over ``peak.UNROLL[K]``, its
    counter and branch included); "sass_rate" counts the FP32 ones a
    second, "issue_rate" all.
    A launch's time is the mean over ``iters`` launches queued behind a
    sleep; "slope_ms" is (time of 2n launches - time of n) / n, which drops
    any per-call overhead, kept as a check. Every build here is
    ``--fmad=false``: only the fma chain issues FFMA, so the add chain at
    K=16 is the ceiling of the port's kernels."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_fp32_peak: no CUDA device")
    n_el = PEAK_SHAPE[0] * PEAK_SHAPE[1]

    def point(mode: str, k: int) -> dict:
        x = torch.full(PEAK_SHAPE, 0.001 if mode == "add" else 0.99999,
                       dtype=torch.float32, device="cuda")

        def run():
            return peak.peak_chain(mode, k, x)

        run()
        run()
        ms = device_ms(run, iters)
        slope = 2 * device_ms(run, 2 * iters) - ms
        loop = max(sass_census(peak.symbol(mode, k))["loops"],
                   key=lambda lp: lp["fp32"])
        trips = peak.INNER // peak.UNROLL[k]
        ops = n_el * peak.INNER * k * peak.ops_per_iter(mode)
        return {"rate": ops / (ms * 1e-3), "P": k,
                "instrs": loop["total"] / peak.UNROLL[k],
                "fp32_instrs": loop["fp32"] / peak.UNROLL[k],
                "sass_rate": n_el * trips * loop["fp32"] / (ms * 1e-3),
                "issue_rate": n_el * trips * loop["total"] / (ms * 1e-3),
                "ms": ms, "slope_ms": slope}

    out: dict = {"sass": {}}
    for mode in peak.MODES:
        p = point(mode, 16)
        out[mode] = p["rate"]
        out["sass"][mode] = p["sass_rate"]
    if ks:
        for mode in peak.MODES:
            out[f"{mode}_k"] = {k: point(mode, k) for k in ks}
    return out


# ---------------------------------------------------------------------------
# K7: the structure twin of the backward kernel K2
# ---------------------------------------------------------------------------

# K2's dependency depth and slow operations (divides, square roots), hand
# counted from csrc/bwd_ray.cuh and bwd_common.cuh along a triangle hit
# (good to about +-30%). Per ray: ray generation with its normalisation
# (9: dot, sqrt, divide), the primary hit_fwd (8: det3, reciprocal, u,
# position), the shading adjoint (about 30 from the position: the light
# vector, two dots, max, the Lambert divide, the dl_scale and its adjoint's
# three divides) and the primary adjoint (19: hit_bwd's cotangent chain and
# the ray generation's). Per executed bounce step: the forward
# step_geometry and hit_fwd (21 on the direction chain) and the reverse
# step's cotangent chain (about 34: hit_bwd, the renormalisation's and the
# refraction's adjoints). Slow operations on that path: 6 per ray, 5 per
# step; in all: 13 per ray, 17 per step.
K2_DEPTH_RAY, K2_DEPTH_STEP = 66, 55
K2_SLOW_PATH_RAY, K2_SLOW_PATH_STEP = 6, 5
K2_SLOW_RAY, K2_SLOW_STEP = 13, 17

TWIN_ITER_OPS = 17     # one bwdmix body


def chain_steps(scene, cfg: RenderConfig, res: Residuals) -> int:
    """Bounce steps K2 and the twin run on this record: a ray's chain goes
    on while the object it hit is specular (material code <= 0) and its
    budget lasts; a step that misses ends it and counts."""
    mats = [scene.tri_mat] + ([] if cfg.cpu_ref else [scene.sph_mat])
    mat = torch.cat(mats).to(res.prim_id.device)

    def specular(ids):
        return (ids >= 0) & (mat[ids.clamp(min=0).long()] <= 0.0)

    active, n = specular(res.prim_id), 0
    for k in range(cfg.bounces):
        n += int(active.sum())
        active = active & specular(res.bounce_id[k])
    return n


def bwd_twin_targets(scene, cfg: RenderConfig, res: Residuals,
                     slow_cost: float = 16.0, pixels=None) -> dict:
    """The twin's targets from the port's own counts of K2 on this record:
    operations per ray (``bwd_work``), dependency depth and its
    slow-weighted form (the K2_* hand counts), slow operations per ray, and
    ``live``, the bounce steps per ray that both run. ``pixels`` (bool
    [rows * W]): the rays of those pixels only, as one launch of K2's split
    runs them (the chain-free launch's have no step: ``live`` 0 and K2's
    per-ray depth)."""
    sub = res if pixels is None else pixels_of(res, pixels)
    rays = max(sub.prim_id.numel(), 1)
    live = chain_steps(scene, cfg, sub) / rays
    _, ops = bwd_work(cfg, scene, res, pixels=pixels)
    depth = K2_DEPTH_RAY + live * K2_DEPTH_STEP
    return {"target_per_lane": ops / rays, "target_depth": depth,
            "target_wdepth": depth + (slow_cost - 1.0) * (
                K2_SLOW_PATH_RAY + live * K2_SLOW_PATH_STEP),
            "slow_per_lane": K2_SLOW_RAY + live * K2_SLOW_STEP, "live": live}


def twin_ops_per_ray(n_step: int, slots, n_pool: int, live: float,
                     aa: int) -> float:
    """Float32 operations of the twin per ray, counted from
    ``csrc/bwd_twin.cu``: the primary x (2 multiplies, 2 adds), the other
    15 accumulators' starts, 17 per slot-iteration of the main chain, the
    second half's start, 21 camera columns of 2 adds, the pool's fold (one
    add per snapshot), the image (1 multiply, 3 x 2 adds, 3 divides per
    pixel); per executed step 1 add forward and, in reverse, the step
    chain's start (1 add, 4 multiplies), 17 per accumulator-iteration and
    12 multiplies of its row. The butterflies are structure, as in K2's
    count (``bwd_work``), and are not counted."""
    fixed = 4 + (bwd_twin.MAX_SLOTS - 1) + 1 + 2 * 21 + 7 + 3.0 / aa
    per_step = 1 + 5 + TWIN_ITER_OPS * bwd_twin.STEP_ACCS * n_step + 12
    return fixed + TWIN_ITER_OPS * sum(slots) + n_pool + live * per_step


def twin_depth_per_ray(n_main: int, n_step: int, live: float) -> float:
    """Longest dependent chain of the twin per ray: the primary x (3), 17
    per main iteration on slot 0, the second half's start (1), the image
    tail (pool sum, scale, add, accumulate: 4); per executed step 1
    forward and, in reverse, 2 + 17 per step-chain iteration (its slot 0
    carries the chain)."""
    return 3 + TWIN_ITER_OPS * n_main + 1 + 4 + live * (
        1 + 2 + TWIN_ITER_OPS * n_step)


def _twin_slots(total: int, n_main: int) -> list[int]:
    total = int(np.clip(total, n_main, n_main * bwd_twin.MAX_SLOTS))
    base, extra = divmod(total, n_main)
    return [base + (1 if i < extra else 0) for i in range(n_main)]


TWIN_TARGETS = ("target_per_lane", "target_depth", "target_wdepth",
                "slow_per_lane", "live")
# Each twin launch's K2 launch, by the twin kernel's kind.
K2_OF_TWIN = {"free": render_bwd.FREE_SYMBOL,
              "chain": "render_bwd_kernel<false>"}


def size_bwd_twin(aa: int, kind: str, *, target_per_lane: float,
                  target_depth: float, target_wdepth: float,
                  slow_per_lane: float, live: float, target_registers: int,
                  slow_cost: float = 16.0,
                  main_step_ratio: float = 1380.0 / 233.0) -> dict:
    """One twin launch's sizing (``kind`` "free" or "chain", at ``aa``
    rays a pixel), the counterpart of the JAX package's sizing
    (``flops.py:950-1007``): bwdmix calibration chains sized, per ray, to
    K2's operation count (``target_per_lane``), dependency depth
    (``target_depth``), slow-op weighted depth (``target_wdepth``, a divide
    costing ``slow_cost``) and slow operations (``slow_per_lane``); ``live``
    is the bounce steps per ray the launch runs (``bwd_twin_targets``).
    ``target_registers``: that K2 launch's ptxas registers; the smallest
    pool instance of ``kind`` whose registers reach them without spilling
    is taken (0: no pool).

    The step chain's share of the operations comes from
    ``main_step_ratio``, the main chain's iterations from the depth, its
    accumulators from the rest of the operations, the divides on slot 0's
    chain for the slow-weighted depth (less those the step chain already
    carries) and the rest on the other slots, then the pool, whose fold is
    paid back out of the slots. The twin's own operations and depth are
    counted analytically (``twin_ops_per_ray``, ``twin_depth_per_ray``;
    there is no jaxpr), and ``sass_census`` checks them on the card.

    Returns the JAX dict (n_main, n_step, slots, n_pool, divs,
    census_per_lane, depth, wdepth, the targets, census_match, depth_match)
    plus "kind", "symbol" (the instance), "registers" (its registers, None
    without a register target) and "target_registers"."""
    def ops(n_step, slots, n_pool):
        return twin_ops_per_ray(n_step, slots, n_pool, live, aa)

    # the step chain's iterations from the hand counts' main:step share
    f0 = ops(1, [], 0)
    c2 = (ops(3, [], 0) - f0) / 2.0             # per step-chain iteration
    budget = max(target_per_lane - f0, float(TWIN_ITER_OPS))
    share_step = 1.0 / (1.0 + main_step_ratio)
    n_step = max(1, round(budget * share_step / c2)) if c2 > 1e-9 else 1
    budget = max(target_per_lane - ops(n_step, [], 0), float(TWIN_ITER_OPS))
    # main iterations from the depth target (17 of depth each)
    d0 = twin_depth_per_ray(0, n_step, live)
    n_main = int(np.clip(round((target_depth - d0) / TWIN_ITER_OPS), 2,
                         bwd_twin.MAX_MAIN))
    # never more than 10% under the depth target (the JAX test's bound;
    # the chain-free launch's 66 would round to 59)
    if (twin_depth_per_ray(n_main, n_step, live) < 0.9 * target_depth
            and n_main < bwd_twin.MAX_MAIN):
        n_main += 1
    slots = _twin_slots(round(budget / TWIN_ITER_OPS), n_main)
    # slow operations: the on-path count rides slot 0 (less the step
    # chain's slot-0 divides), the rest goes to the parallel slots
    on_path_step = live * n_step
    on_path = int(np.clip(round((target_wdepth - target_depth)
                                / max(slow_cost - 1.0, 1.0) - on_path_step),
                          0, n_main))
    n_slow = int(max(round(slow_per_lane
                           - len(bwd_twin.STEP_DIV_SLOTS) * on_path_step),
                     on_path))
    divs = [set() for _ in range(n_main)]
    for i in range(on_path):
        divs[(i * n_main) // max(on_path, 1)].add(0)
    left, it = n_slow - on_path, 0
    while left > 0 and it <= 4 * n_main:
        for s in range(1, slots[it % n_main]):
            if left <= 0:
                break
            if s not in divs[it % n_main]:
                divs[it % n_main].add(s)
                left -= 1
        it += 1
    # the working set: the smallest pool that reaches K2's registers
    pools = bwd_twin.FREE_POOLS if kind == "free" else bwd_twin.POOLS
    n_pool, registers = 0, None
    if target_registers > 0:
        found = {n: kernel_resources(bwd_twin.symbol(n, kind)) for n in pools}
        clean = [n for n in pools
                 if found[n]["spill_stores"] == 0 and found[n]["spill_loads"] == 0]
        reach = [n for n in clean if found[n]["registers"] >= target_registers]
        n_pool = reach[0] if reach else (clean[-1] if clean else 0)
        registers = found[n_pool]["registers"]
        slots = _twin_slots(round((budget - n_pool) / TWIN_ITER_OPS), n_main)
        divs = [{s for s in d if s < slots[i]} for i, d in enumerate(divs)]
    sizing = {"n_main": n_main, "n_step": int(n_step), "slots": slots,
              "divs": [sorted(d) for d in divs], "n_pool": n_pool}
    bwd_twin.check_sizing(sizing, pools)
    n_div_path = sum(1 for d in divs if 0 in d)
    census = ops(n_step, slots, n_pool)
    depth = twin_depth_per_ray(n_main, n_step, live)
    wdepth = depth + (slow_cost - 1.0) * (n_div_path + on_path_step)
    return {**sizing,
            "census_per_lane": round(census, 1),
            "target_per_lane": round(target_per_lane, 1),
            "depth": round(depth, 1), "target_depth": round(target_depth, 1),
            "wdepth": round(wdepth, 1),
            "target_wdepth": round(target_wdepth, 1),
            "slow_per_lane": round(sum(len(d) for d in divs) + len(
                bwd_twin.STEP_DIV_SLOTS) * on_path_step, 1),
            "target_slow_per_lane": round(slow_per_lane, 1),
            "census_match": round(census / max(target_per_lane, 1e-9), 4),
            "depth_match": round(depth / max(target_depth, 1e-9), 4),
            "live": live, "kind": kind,
            "symbol": bwd_twin.symbol(n_pool, kind),
            "registers": registers, "target_registers": target_registers}


def build_bwd_structure_twin(scene, cfg: RenderConfig, res: Residuals, *,
                             target_registers: int | None = None,
                             slow_cost: float = 16.0,
                             main_step_ratio: float = 1380.0 / 233.0,
                             **targets) -> dict:
    """Structure twin of K2 (``csrc/render_bwd.cu``), the counterpart of
    the JAX package's ``build_bwd_structure_twin``: K2's launches and their
    loop and memory structure on the record ``res`` (see
    ``csrc/bwd_twin.cu``), each launch's calibration chains sized by
    ``size_bwd_twin`` to that K2 launch. On a frame K2 splits
    (``render_bwd.splits``) there are two: the free twin over the pixels
    none of whose rays bounces (their targets: ``bwd_twin_targets`` of
    those pixels) and the chain twin over the others
    (``bwd_twin.chain_pixels``); otherwise the chain twin alone over every
    pixel. ``target_registers``: None takes each K2 launch's ptxas
    registers (``K2_OF_TWIN``: 128 for the free launch, 168 for the chain
    launch, from the built library); a number holds every launch to it (0:
    no pool). ``targets`` (the five names of ``TWIN_TARGETS``), given, size
    the one launch of a frame K2 does not split in place of the record's
    counts.

    Returns {"split", "free" (the free twin's ``size_bwd_twin`` dict, None
    where there is no split), "chain" (the chain twin's), "run" (one run of
    the twin on the whole frame: (sums, img); ``run(parts=True)`` as
    ``bwd_twin.bwd_twin`` gives it), "run_plain" (its plain version on the
    same inputs)}; on a frame without the split also the chain twin's keys
    at the top, one sizing over every pixel as before the split."""
    table = bwd_twin.twin_table(scene, cfg)
    split = render_bwd.splits(cfg, cfg.height, table.shape[0])
    if targets:
        if split or set(targets) != set(TWIN_TARGETS):
            raise ValueError(f"build_bwd_structure_twin: explicit targets "
                             f"({', '.join(TWIN_TARGETS)}) size the one "
                             f"launch of a frame K2 does not split; got "
                             f"{sorted(targets)}, split {split}")
        per = {"chain": targets}
    elif split:
        on = bwd_twin.chain_pixels(table, res, cfg)
        per = {kind: bwd_twin_targets(scene, cfg, res, slow_cost, pixels=m)
               for kind, m in (("free", ~on), ("chain", on))}
    else:
        per = {"chain": bwd_twin_targets(scene, cfg, res, slow_cost)}
    launches = {}
    for kind, t in per.items():
        regs = (kernel_resources(K2_OF_TWIN[kind])["registers"]
                if target_registers is None else target_registers)
        launches[kind] = size_bwd_twin(
            cfg.aa_rays, kind, **t, target_registers=regs,
            slow_cost=slow_cost, main_step_ratio=main_step_ratio)
    chain, free = launches["chain"], launches.get("free")
    g = torch.full((cfg.height, cfg.width, 3), 1e-3, dtype=torch.float32,
                   device=table.device)
    out = {"split": split, "free": free, "chain": chain,
           "run": lambda parts=False: bwd_twin.bwd_twin(
               table, g, res, cfg, chain, free, parts=parts),
           "run_plain": lambda: bwd_twin.bwd_twin_plain(table, g, res, cfg,
                                                        chain, free)}
    return out if split else {**chain, **out}
