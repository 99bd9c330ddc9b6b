"""The kernels' work count and the card's peaks: the yardstick of every
``*_roofline`` metric.

The operation count is a frozen copy of the JAX package's analytic count
(``uob_raytracer_tpu/flops.py:forward_ops`` / ``backward_ops``, copied into
the port's ``flops.py``), with one change: where that count weighs lanes by
estimated fractions, this one weighs each logical query by what the frozen
reference says the frame asks for (``reference.render.ray_stats``): every
primary ray, every shadow sample of a shaded ray and every live bounce
step is counted against every row of the scene in the forward, and as
one site of the replay in the backward. Nothing depends on how a
kernel is built: no quad pairing, no hoisting across samples, no early
exit. Bytes count each table read once and each output written once.
The bound is the larger of bytes over the card's bandwidth and operations
over its float32 rate, both from the data sheet (``peaks.json``).
"""
from __future__ import annotations

import json
import os

# uob_raytracer_tpu/flops.py:31-115, per ray query and per row
PRIMARY_PER_TRI = 29
PRIMARY_PER_SPH = 28
PRIMARY_GATHER_PER_TRI = 8
SHADOW_FIXED_PER_TRI = 20
SHADOW_PER_TRI_SAMPLE = 25
SHADOW_PER_SPH_SAMPLE = 30
SHADOW_JITTER_PER_SAMPLE = 38
BOUNCE_PER_TRI = 100
BOUNCE_PER_SPH = 60
BOUNCE_FIXED = 90
RAYGEN_SHADE_FIXED = 80
BWD_GATHER_PER_TRI = 17
BWD_F1 = 480
BWD_F3 = 240
BWD_SCATTER_HIT = 150
BWD_STEP_FWD = 255
BWD_STEP_BWD = 760
BWD_FIXED = 80

TRI_COLS, SPH_COLS, CAM_COLS, GRAD_COLS = 19, 12, 21, 16
F32 = 4


def forward_ops(p, n_tri: int, n_sph: int, stats) -> float:
    """Operations of one forward frame: ``stats`` = (primary rays, live
    bounce steps, shaded rays)."""
    n_prim, n_bounce, n_shaded = stats
    S = p.shadow_samples
    primary = (n_tri * (PRIMARY_PER_TRI + PRIMARY_GATHER_PER_TRI)
               + n_sph * PRIMARY_PER_SPH)
    shadow = (n_tri * (SHADOW_FIXED_PER_TRI + SHADOW_PER_TRI_SAMPLE * S)
              + n_sph * SHADOW_PER_SPH_SAMPLE * S
              + SHADOW_JITTER_PER_SAMPLE * S)
    bounce = BOUNCE_FIXED + n_tri * BOUNCE_PER_TRI + n_sph * BOUNCE_PER_SPH
    return float(n_prim * (primary + RAYGEN_SHADE_FIXED)
                 + n_shaded * shadow + n_bounce * bounce)


def backward_ops(p, n_tri: int, n_sph: int, stats) -> float:
    """Operations of one path-replay backward of a frame. The replay reads
    the one object each site recorded, so a site costs one row's gather and
    one row's scatter: the JAX count's per-object terms
    (``BWD_GATHER_PER_TRI`` times every row, ``BWD_SCATTER_PER_TRI``) are
    its TPU kernel's select-accumulate over the whole table, a design and
    not the work, and are left out."""
    del n_tri, n_sph
    n_prim, n_bounce, _ = stats
    gather = BWD_GATHER_PER_TRI
    scatter = BWD_SCATTER_HIT
    per_step = 2 * gather + BWD_STEP_FWD + BWD_STEP_BWD + scatter
    return float(n_prim * (gather + BWD_F1 + BWD_F3 + scatter + BWD_FIXED)
                 + n_bounce * per_step)


def _tables(n_tri: int, n_sph: int) -> int:
    return F32 * (n_tri * TRI_COLS + max(n_sph, 1) * SPH_COLS + CAM_COLS)


def forward_bytes(p, n_tri: int, n_sph: int, record: bool) -> float:
    """Tables read once; image (float RGB and packed ARGB) written once,
    and the decision record when the forward keeps it."""
    px = p.width * p.height
    out = px * (3 * F32 + 4)
    if record:
        out += px * p.aa_rays * (4 + 4 + 4 * p.bounces)
    return float(_tables(n_tri, n_sph) + out)


def backward_bytes(p, n_tri: int, n_sph: int) -> float:
    """Tables, record and image cotangent read once; one cotangent row per
    object and the camera's written once."""
    px = p.width * p.height
    reads = (_tables(n_tri, n_sph) + px * p.aa_rays * (8 + 4 * p.bounces)
             + px * 3 * F32)
    writes = F32 * ((n_tri + n_sph) * GRAD_COLS + CAM_COLS)
    return float(reads + writes)


def peaks(device_name: str) -> dict | None:
    """The data sheet's peaks of a card by its name (``peaks.json``), or
    None for a card the table does not hold."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f).get(device_name)


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least seconds the card could take."""
    return max(ops / peak["fp32_flops_per_s"], nbytes / peak["bytes_per_s"])


def roofline_pct(run, patterns, kind: str) -> float | None:
    """A kernel group's share (%) of its bound in one call of the traced
    window: the bound of one call's count over the device seconds a call
    of the named kernels took. None without a trace, a peak or a launch."""
    from .trace import kernel_seconds
    t = run.traced
    if t is None or run.peak is None or run.stats is None:
        return None
    dev_s = kernel_seconds(t, patterns) / t["calls"]
    if dev_s <= 0:
        return None
    p = run.params
    n_tri = run.inputs["tri_v0"].shape[0]
    n_sph = run.inputs["sph_center"].shape[0]
    if kind == "fwd":
        ops = forward_ops(p, n_tri, n_sph, run.stats)
        nbytes = forward_bytes(p, n_tri, n_sph, run.mix["loop"] == "sgd")
    else:
        ops = backward_ops(p, n_tri, n_sph, run.stats)
        nbytes = backward_bytes(p, n_tri, n_sph)
    return 100.0 * bound_s(ops, nbytes, run.peak) / dev_s
