"""The path-replay backward kernels: the launch wrapper and plain version.

``render_replay_bwd`` turns an image cotangent into a Scene gradient in ONE
launch of a CUDA kernel, the Hopper counterpart of the TPU kernel
``uob_raytracer_tpu/kernels/render_bwd.py:_bwd_kernel``: every ray
re-gathers the objects it hit (the decision record of
``render_fused_res``), replays the lean reconstruction of its radiance
(``ops/replay.py``) and runs the hand-derived adjoint of that replay. This
wrapper turns what the kernel hands back into the cotangents of the packed
tables (``pack_scene``'s tri, sph and cam) and pulls them back onto the 15
Scene leaves through torch autograd of ``pack_scene``, so vertex gradients
include the path through the recomputed normals.

There are two kernels, chosen by ``render_fwd.use_streamed`` as the forward
kernels are. The whole-table kernel (``csrc/render_bwd.cu``) keeps one
accumulator row per object and warp in shared memory and hands back
per-block partial sums of all cotangents, summed here over blocks. The
streamed kernel (``csrc/render_bwd_streamed.cu``, the counterpart of
``_bwd_kernel``'s ``streamed=True`` mode) takes any triangle count: it
reads rows straight from device memory and writes each triangle's cotangent
per ray and site (``dlane``); ``segment_sum`` then adds the sites of each
triangle in a fixed order (a stable sort of the recorded ids and a second
small kernel; no float atomics, so two runs are bit-equal), while the few
spheres and the camera keep per-block partial sums.

The kernel's plain torch version, ``render_replay_bwd_plain`` (torch
autograd through ``ops.replay.replay_forward``), lives here beside it. For
a scene on the CPU the wrapper runs that plain version; for a CUDA scene it
launches the kernel or raises, and never falls back. ``LAUNCHES`` counts
the whole-table kernel's launches, ``STREAMED_LAUNCHES`` the streamed
kernel's, ``SEGMENT_SUM_LAUNCHES`` the segmented sum's.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.replay import Residuals, replay_forward
from ..scene import Scene
from . import _build
from .render_fwd import (  # noqa: F401  (shared_bytes etc.: public names)
    CAM_COLS, GRAD_COLS, OBJ_COLS, SMEM_BUDGET_BYTES, SPH_COLS, THREADS,
    TRI_COLS, _band, _check, pack_scene, pick_kernel)
from .render_fwd import bwd_shared_bytes as shared_bytes

# Kernel launches since import: the whole-table kernel, the streamed kernel,
# and the segmented sum that follows the streamed kernel.
LAUNCHES = 0
STREAMED_LAUNCHES = 0
SEGMENT_SUM_LAUNCHES = 0

# Per-thread storage of the bounce chain is sized at compile time
# (kMaxBounces in csrc/bwd_common.cuh); deeper configs are refused.
MAX_BOUNCES = 16
# The whole-table kernel's per-block partial sums grow with the object
# count times the pixel count; past this size the call is refused (row
# bands are the caller's way down).
MAX_PARTIAL_BYTES = 1 << 30
# The streamed kernel's per-site cotangent rows: 64 B for every ray and
# site, (1 + bounces) * A * rows * W of them. 128x128 with 2x2 AA and 2
# bounces needs 12.6 MB, 1024x1024 with 2x2 AA and 10 bounces 2.9 GB; past
# this size the call is refused (row bands are the caller's way down).
MAX_DLANE_BYTES = 1 << 31

_F = np.float32
_LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


def _detached(scene: Scene) -> Scene:
    return Scene(**{k: getattr(scene, k).detach().requires_grad_(True)
                    for k in _LEAVES})


def _pull_back(outputs, leaves: Scene, cotangents) -> Scene:
    """Scene of gradients: ``cotangents`` of ``outputs`` pulled back onto
    every leaf; a leaf no output depends on (the material codes) gets
    zeros."""
    # an output no leaf feeds (the zero row that stands for "no spheres")
    # carries no graph
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs],
                                [getattr(leaves, k) for k in _LEAVES],
                                [c for _, c in pairs], allow_unused=True)
    return Scene(**{k: torch.zeros_like(getattr(leaves, k)) if g is None else g
                    for k, g in zip(_LEAVES, grads)})


# --------------------------------------------------------------------------
# The plain torch version
# --------------------------------------------------------------------------

def render_replay_bwd_plain(scene: Scene, cfg: RenderConfig, res: Residuals,
                            g, row0=None, rows: int | None = None,
                            return_primal: bool = False):
    """The plain torch version of ``render_replay_bwd``, on the scene's
    device: torch autograd through ``replay_forward``."""
    with torch.enable_grad():
        leaves = _detached(scene)
        img = replay_forward(leaves, cfg, res, row0, rows)
        bar = _pull_back([img], leaves, [g.to(img.dtype)])
    return (bar, img.detach()) if return_primal else bar


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

def launch_params(cfg: RenderConfig, row0: int, rows: int, n_tri: int,
                  n_sph: int, want_img: bool):
    """The launcher's host parameter arrays (ints, floats); float32
    constants as the forward kernel's."""
    ints = (cfg.width, cfg.height, row0, rows, cfg.aa_x, cfg.aa_y,
            cfg.shadow_samples, cfg.bounces, n_tri, n_sph, int(cfg.cpu_ref),
            int(cfg.fresnel), int(cfg.quirk_nan_tir), int(want_img))
    floats = (_F(cfg.width * cfg.aa_x / 2.0), _F(cfg.height * cfg.aa_y / 2.0),
              _F(cfg.effective_focal), _F(cfg.bias), _F(cfg.ior_glass),
              _F(cfg.ior_air), _F(4.0 * np.pi))
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*[float(f) for f in floats]))


def _declare(lib: ctypes.CDLL, streamed: bool):
    """The launcher of the whole-table kernel (one output buffer: the
    partials) or of the streamed kernel (two: dlane and the partials)."""
    fn = lib.render_bwd_streamed_launch if streamed else lib.render_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * (10 if streamed else 9)
                   + [ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _spread(obj_tri, obj_sph, dcam, sph_rows: int):
    """Cotangent rows of 16 (v0 e1 e2 n rgb | r2) per triangle and per
    sphere, spread into the layouts of ``pack_scene``'s tables: (dtri
    [T,19] with columns 0..14 filled, dsph [sph_rows,12], dcam [21])."""
    dtri = obj_tri.new_zeros((obj_tri.shape[0], TRI_COLS))
    dtri[:, :15] = obj_tri[:, :15]
    dsph = obj_tri.new_zeros((sph_rows, SPH_COLS))
    n_sph = obj_sph.shape[0]
    if n_sph:
        dsph[:n_sph, 0:3] = obj_sph[:, 0:3]       # center
        dsph[:n_sph, 3] = obj_sph[:, 15]          # r2
        dsph[:n_sph, 4:7] = obj_sph[:, 12:15]     # rgb
    return dtri, dsph, dcam


def table_cotangents(partial, n_tri: int, n_sph: int, sph_rows: int):
    """The whole-table kernel's result as table cotangents: sum its
    per-block partials [blocks, n_obj*16 + 21] and spread them (``_spread``)."""
    sums = partial.sum(dim=0)
    n_obj = n_tri + n_sph
    obj = sums[:n_obj * GRAD_COLS].reshape(n_obj, GRAD_COLS)
    return _spread(obj[:n_tri], obj[n_tri:], sums[n_obj * GRAD_COLS:],
                   sph_rows)


def segment_sum_plain(ids, rows, n_seg: int):
    """The plain torch version of ``segment_sum``: ``index_add_`` of the
    rows whose id is in [0, n_seg)."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < n_seg)
    out = rows.new_zeros((n_seg, rows.shape[1]))
    return out.index_add_(0, ids[keep], rows[keep])


def segment_sum(ids, rows, n_seg: int):
    """out [n_seg, 16]: out[t] is the sum of rows[i] over the i with
    ids[i] == t; ids outside [0, n_seg) are ignored. ids: int32 [n],
    rows: float32 [n, 16].

    On a CUDA tensor: a stable sort of the ids (equal ids keep their
    order), the bounds of each id's run, and one launch of
    ``segment_sum_kernel`` (``csrc/render_bwd_streamed.cu``), which gives
    each run to one warp and adds its rows in a fixed order. Unlike
    ``index_add_`` on the card, which adds with float atomics, two calls
    on the same inputs give the same bits. A CPU tensor takes
    ``segment_sum_plain``."""
    global SEGMENT_SUM_LAUNCHES
    if rows.device.type == "cpu":
        return segment_sum_plain(ids, rows, n_seg)
    dev = rows.device
    ids = ids.reshape(-1)
    _check("segment_sum ids", ids, (rows.shape[0],), torch.int32)
    _check("segment_sum rows", rows, (ids.shape[0], GRAD_COLS))
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(n_seg + 1, dtype=torch.int32, device=dev))
    out = torch.empty((n_seg, GRAD_COLS), dtype=torch.float32, device=dev)
    fn = _build.load().segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), order.data_ptr(), bounds.data_ptr(),
                 out.data_ptr(), n_seg,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    SEGMENT_SUM_LAUNCHES += 1
    return out


def site_ids(res: Residuals):
    """The object id of every (site, ray) in the streamed kernel's order:
    int32 [(1 + bounces) * A * rows * W], site 0 the primary hit, site
    1 + k bounce step k."""
    pid = res.prim_id.reshape(1, -1)
    if not res.bounce_id.shape[0]:
        return pid.reshape(-1)
    return torch.cat([pid, res.bounce_id.reshape(res.bounce_id.shape[0], -1)
                      ]).reshape(-1)


def streamed_table_cotangents(partial, dlane, ids, n_tri: int, n_sph: int,
                              sph_rows: int):
    """The streamed kernel's result as table cotangents (the counterpart of
    ``table_cotangents``): the per-site triangle rows dlane [sites, 16]
    summed per triangle over the recorded ids (``segment_sum``), the
    per-block sphere and camera partials [blocks, n_sph*16 + 21] summed
    over blocks, and both spread (``_spread``)."""
    sums = partial.sum(dim=0)
    return _spread(segment_sum(ids, dlane, n_tri),
                   sums[:n_sph * GRAD_COLS].reshape(n_sph, GRAD_COLS),
                   sums[n_sph * GRAD_COLS:], sph_rows)


def render_replay_bwd(scene: Scene, cfg: RenderConfig, res: Residuals, g,
                      row0=None, rows: int | None = None,
                      return_primal: bool = False, _kernel=None):
    """Scene cotangent of the fused forward render: the path-replay
    backward. ``res`` is the record from ``render_fused_res``; ``g`` is the
    image cotangent [rows, W, 3]. Returns a Scene of gradients (zeros for
    the material codes), equal to float tolerance to autograd through
    ``replay_forward``; with ``return_primal`` also the replayed radiance
    [rows, W, 3]. A CPU scene runs ``render_replay_bwd_plain``. ``_kernel``
    pins the whole-table or the streamed kernel (``render_fwd.pick_kernel``)."""
    global LAUNCHES, STREAMED_LAUNCHES
    row0, rows = _band(cfg, row0, rows)
    dev = scene.device
    if dev.type == "cpu":
        return render_replay_bwd_plain(scene, cfg, res, g, row0, rows,
                                       return_primal)
    if dev.type != "cuda":
        raise ValueError(f"render_bwd: scene on {dev}; the kernel needs a "
                         f"CUDA device (its plain version the CPU)")
    if cfg.bounces > MAX_BOUNCES:
        raise ValueError(f"render_bwd: {cfg.bounces} bounces; the kernel "
                         f"keeps at most {MAX_BOUNCES} steps per ray")

    n_tri = scene.num_triangles
    # CPU-ref ignores spheres entirely, as the forward kernel does
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    n_obj = n_tri + n_sph
    W, A, B = cfg.width, cfg.aa_rays, cfg.bounces
    n_blocks = (rows * W + THREADS - 1) // THREADS
    streamed = pick_kernel(n_tri, scene.num_spheres, _kernel)
    n_sites = (1 + B) * A * rows * W
    if streamed:
        cols = n_sph * GRAD_COLS + CAM_COLS
        if 4 * GRAD_COLS * n_sites > MAX_DLANE_BYTES:
            raise ValueError(
                f"render_bwd: the streamed backward kernel writes one "
                f"{4 * GRAD_COLS} B cotangent row per ray and site; "
                f"{n_sites} sites ({rows}x{W} pixels, {A} AA rays, 1 + {B} "
                f"sites) need {4 * GRAD_COLS * n_sites} B, above the limit "
                f"of {MAX_DLANE_BYTES} B: take the gradient in row bands "
                f"(row0/rows) and add them")
    else:
        cols = n_obj * GRAD_COLS + CAM_COLS
        if (shared_bytes(n_obj) > SMEM_BUDGET_BYTES
                or 4 * n_blocks * cols > MAX_PARTIAL_BYTES):
            raise ValueError(
                f"render_bwd: {n_obj} objects over {n_blocks} blocks: the "
                f"whole-table backward kernel needs {shared_bytes(n_obj)} B "
                f"of shared memory (limit {SMEM_BUDGET_BYTES}) and "
                f"{4 * n_blocks * cols} B of partial sums (limit "
                f"{MAX_PARTIAL_BYTES}): take the gradient in row bands "
                f"(row0/rows) and add them")

    with torch.enable_grad():
        leaves = _detached(scene)
        tables = pack_scene(leaves)
    tri, sph, cam = (t.detach() for t in tables)
    g = g.to(torch.float32).contiguous()
    _check("tri", tri, (n_tri, TRI_COLS))
    _check("sph", sph, (max(scene.num_spheres, 1), SPH_COLS))
    _check("cam", cam, (CAM_COLS,))
    _check("g", g, (rows, W, 3))
    _check("res.prim_id", res.prim_id, (A, rows, W), torch.int32)
    _check("res.lit_cnt", res.lit_cnt, (A, rows, W))
    if B:
        _check("res.bounce_id", res.bounce_id, (B, A, rows, W), torch.int32)

    partial = torch.empty((n_blocks, cols), dtype=torch.float32, device=dev)
    # the streamed kernel writes only the sites that hit a triangle: the
    # rest of dlane must read zero
    outs = ([torch.zeros((n_sites, GRAD_COLS), dtype=torch.float32,
                         device=dev)] if streamed else []) + [partial]
    img = (torch.empty((rows, W, 3), dtype=torch.float32, device=dev)
           if return_primal else None)
    ints, floats = launch_params(cfg, row0, rows, n_tri, n_sph, return_primal)
    launch = _declare(_build.load(), streamed)
    with torch.cuda.device(dev):
        err = launch(tri.data_ptr(), sph.data_ptr(), cam.data_ptr(),
                     g.data_ptr(), res.prim_id.data_ptr(),
                     res.lit_cnt.data_ptr(),
                     res.bounce_id.data_ptr() if B else 0,
                     *(t.data_ptr() for t in outs),
                     0 if img is None else img.data_ptr(),
                     ints, floats,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_bwd kernel launch failed: CUDA error "
                           f"{err}")
    if streamed:
        STREAMED_LAUNCHES += 1
        cotangents = streamed_table_cotangents(
            partial, outs[0], site_ids(res), n_tri, n_sph, sph.shape[0])
    else:
        LAUNCHES += 1
        cotangents = table_cotangents(partial, n_tri, n_sph, sph.shape[0])

    bar = _pull_back(list(tables), leaves, list(cotangents))
    return (bar, img) if return_primal else bar
