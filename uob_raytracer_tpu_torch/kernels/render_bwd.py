"""The path-replay backward kernels: the launch wrapper and plain version.

``render_replay_bwd`` turns an image cotangent into a Scene gradient by
CUDA kernels, the Hopper counterparts of the TPU kernel
``uob_raytracer_tpu/kernels/render_bwd.py:_bwd_kernel``: every ray
re-gathers the objects it hit (the decision record of
``render_fused_res``), replays the lean reconstruction of its radiance
(``ops/replay.py``) and runs the hand-derived adjoint of that replay. This
wrapper turns what the kernel hands back into the cotangents of the packed
tables (``pack_scene``'s tri, sph and cam) and pulls them back onto the 15
Scene leaves through torch autograd of ``pack_scene``, so vertex gradients
include the path through the recomputed normals.

There are two designs, chosen by ``render_fwd.use_streamed`` as the forward
kernels are. The whole-table kernels (``csrc/render_bwd.cu``) keep one
accumulator row per object and warp in shared memory and hand back
per-block partial sums of all cotangents, summed here over blocks. Up to
``SPLIT_OBJECTS`` objects, on a frame that bounces and holds at least
``SPLIT_RAYS`` rays (``splits``), a gradient is two launches split by the
record:
the chain-free kernel runs every pixel none of whose rays bounces (no chain
storage, so more blocks an SM) and lists the others, and the chain kernel
runs the listed pixels, compacted, one thread per AA ray (``torch.cumsum`` of
the per-block counts on the device turns the lists into offsets; nothing
waits for the host). While ``tracing`` keeps gauges, the gauge
``bwd.chain_pixels`` holds the last offset of each band, the pixels the
chain launch walked, on the device: nothing reads it in the step. Past that
one launch of the chain kernel runs every pixel. The streamed kernel
(``csrc/render_bwd_streamed.cu``, the counterpart of ``_bwd_kernel``'s
``streamed=True`` mode) takes any triangle count: it reads rows straight
from device memory and writes each triangle's cotangent per ray and site
(``dlane``); ``segment_sum`` then adds the sites of each triangle in a
fixed order (a stable sort of the recorded ids and two small
kernels; no float atomics, so two runs are bit-equal), while the few
spheres and the camera keep per-block partial sums.

Both kernels come in two instances. Up to ``REG_BOUNCES`` bounces a ray's
bounce chain lives in a per-thread array (the register instance); a deeper
config launches the deep instance, whose chain lives in a device buffer
that the wrapper allocates, so any bounce count runs. A frame whose
per-block partials, per-site rows or chain would pass their byte limits
(``MAX_PARTIAL_BYTES``, ``MAX_DLANE_BYTES``, ``MAX_CHAIN_BYTES``) is taken
in row bands (``_row_bands``): the same kernel once per band, each band's
table cotangents added in band order, one pull-back at the end.

The kernel's plain torch version, ``render_replay_bwd_plain`` (torch
autograd through ``ops.replay.replay_forward``), lives here beside it; it
sets the same gauge to ``chain_pixels``, the pixels the chain launch would
walk by the record. For
a scene on the CPU the wrapper runs that plain version; for a CUDA scene it
launches the kernel or raises, and never falls back. ``LAUNCHES`` counts
the whole-table chain kernel's launches (one per row band),
``FREE_LAUNCHES`` the chain-free kernel's, ``STREAMED_LAUNCHES`` the streamed
kernel's (one per row band), ``SEGMENT_SUM_LAUNCHES`` the segmented sum's
calls (each launches its two passes).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import tracing
from ..config import RenderConfig
from ..ops.replay import Residuals, replay_forward
from ..scene import Scene
from . import _build
from .render_fwd import (  # noqa: F401  (shared_bytes etc.: public names)
    CAM_COLS, GRAD_COLS, OBJ_COLS, SMEM_BUDGET_BYTES, SPH_COLS, THREADS,
    TRI_COLS, _band, _check, pack_scene, pick_kernel, pixels_per_block)
from .render_fwd import bwd_shared_bytes as shared_bytes

# Kernel launches since import: the whole-table kernel, the streamed kernel,
# and the segmented sum that follows the streamed kernel.
LAUNCHES = 0
FREE_LAUNCHES = 0
STREAMED_LAUNCHES = 0
SEGMENT_SUM_LAUNCHES = 0

# The whole-table gradient is split by the record into the chain-free
# launch and the chain launch up to SPLIT_OBJECTS objects, when the config
# bounces, and from SPLIT_RAYS AA rays a frame; otherwise the chain kernel
# alone runs every pixel. Past 32 objects the staged table and the
# accumulators (hundreds of KB a block) would be staged, zeroed and written
# out twice. Below a million rays the chain launch's floor (a few waves of
# blocks, each as slow as its deepest chain) costs more than the chain-free
# launch saves: on the H100, 512x512 with one ray a pixel and 2-4 bounces
# took 0.050 ms split against 0.042-0.044 in one launch, full_1024 (4.2 M
# rays) 0.35 against 0.41 (PERF.md, PR 7).
SPLIT_OBJECTS = 32
SPLIT_RAYS = 1 << 20


def splits(cfg: RenderConfig, rows: int, n_obj: int) -> bool:
    """Whether the whole-table gradient of a frame of ``rows`` rows is
    split into the chain-free and the chain launch (see SPLIT_RAYS)."""
    return (n_obj <= SPLIT_OBJECTS and cfg.bounces > 0
            and rows * cfg.width * cfg.aa_rays >= SPLIT_RAYS)
# The chain-free kernel as ``flops.kernel_resources`` and
# ``flops.sass_census`` take it (the chain kernel's register instance is
# "render_bwd_kernel<false>").
FREE_SYMBOL = "render_bwd_free_kernel"

# The most tiles of THREADS pixels a block of the chain-free kernel takes
# (kFreeMaxTiles in csrc/render_bwd.cu), and the waves its grid fills: two
# waves let the card's scheduler balance the blocks' uneven work, which
# one wave of longer blocks cannot (on the H100 two waves ran 6% faster
# than one at full_1024 and alike at the headline, four 2-18% slower than
# two; PERF.md §6).
FREE_MAX_TILES = 1024
FREE_WAVES = 2

# The register instance keeps a ray's bounce chain in a per-thread array of
# this many steps (kRegBounces in csrc/bwd_common.cuh); deeper configs
# launch the deep instance, whose chain is a device buffer of CHAIN_FLOATS
# floats per step and thread of the grid (kChainFloats: 12 floats and the
# id).
REG_BOUNCES = 16
CHAIN_FLOATS = 13
# Byte limits of one band's buffers; a frame past any of them is taken in
# row bands. The whole-table kernel's per-block partial sums grow with the
# object count times the pixel count. The streamed kernel's per-site
# cotangent rows take 64 B for every ray and site, (1 + bounces) * A * rows
# * W of them: 128x128 with 2x2 AA and 2 bounces needs 12.6 MB, 1024x1024
# with 2x2 AA and 10 bounces 2.9 GB (two bands). The deep chain takes 52 B
# per thread and bounce.
MAX_PARTIAL_BYTES = 1 << 30
MAX_DLANE_BYTES = 1 << 31
MAX_CHAIN_BYTES = 1 << 31
# The segmented sum's tile of sorted positions (kSegTile in
# csrc/render_bwd_streamed.cu).
SEGMENT_TILE = 128

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
    with tracing.span("rt.bwd.pull_back"):
        pairs = [(o, c) for o, c in zip(outputs, cotangents)
                 if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    [getattr(leaves, k) for k in _LEAVES],
                                    [c for _, c in pairs], allow_unused=True)
        return Scene(**{k: torch.zeros_like(getattr(leaves, k))
                        if g is None else g for k, g in zip(_LEAVES, grads)})


# --------------------------------------------------------------------------
# The plain torch version
# --------------------------------------------------------------------------

def chain_pixels(scene: Scene, cfg: RenderConfig, res: Residuals):
    """How many pixels of the record's rows the chain launch takes (0-d
    int64): those with at least one AA ray whose bounce chain it replays
    (``flops.chain_rays``: a primary hit on a specular or glass object, in
    a config that bounces), the pixels the chain-free launch lists."""
    from ..flops import chain_rays
    ray = chain_rays(scene, cfg, res)
    return ray.reshape(ray.shape[0], -1).any(dim=0).sum()


def render_replay_bwd_plain(scene: Scene, cfg: RenderConfig, res: Residuals,
                            g, row0=None, rows: int | None = None,
                            return_primal: bool = False):
    """The plain torch version of ``render_replay_bwd``, on the scene's
    device: torch autograd through ``replay_forward``. While ``tracing``
    keeps gauges, sets ``bwd.chain_pixels`` to ``chain_pixels``."""
    if tracing.gauging():
        tracing.gauge("bwd.chain_pixels", [chain_pixels(scene, cfg, res)])
    with torch.enable_grad():
        with tracing.span("rt.bwd.pack"):
            leaves = _detached(scene)
        with tracing.span("rt.bwd.launch"):
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


_INTS, _FLOATS = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)


def _declare(lib: ctypes.CDLL, streamed: bool):
    """The launchers: the streamed kernel's (tables, g, record, dlane, the
    partials, the image, the deep chain, params, pixels a block); or the
    whole-table kernels' as a dict: "chain" (tables, g, record, the
    partials, the image, the deep chain, list, offsets, params) and "free"
    (tables, g, pid, lit, the partials, the image, list, counts, params,
    blocks, tiles a block)."""
    if streamed:
        fn = lib.render_bwd_streamed_launch
        fn.argtypes = ([ctypes.c_void_p] * 11
                       + [_INTS, _FLOATS, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn
    chain, free = lib.render_bwd_launch, lib.render_bwd_free_launch
    chain.argtypes = [ctypes.c_void_p] * 12 + [_INTS, _FLOATS, ctypes.c_void_p]
    free.argtypes = ([ctypes.c_void_p] * 10
                     + [_INTS, _FLOATS, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
    for fn in (chain, free):
        fn.restype = ctypes.c_int
    return {"chain": chain, "free": free}


def free_blocks_per_sm(n_obj: int) -> int:
    """How many blocks of the chain-free kernel one SM of the current CUDA
    device holds in a scene of ``n_obj`` objects (the runtime's occupancy
    count at ``FREE_MAX_TILES`` tiles a block, the most shared memory a
    block takes): with the SM count, the slots ``free_grid`` fills."""
    fn = _build.load().render_bwd_free_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(n_obj, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"render_bwd_free_blocks_per_sm: CUDA error {err}")
    return out.value


def free_slots(device: torch.device, n_obj: int) -> int:
    """The blocks of the chain-free kernel that CUDA ``device`` holds at
    once in a scene of ``n_obj`` objects: ``free_blocks_per_sm`` times its
    SMs (528 on an H100 SXM), asked once per device and object count."""
    return _slots(torch.cuda.current_device() if device.index is None
                  else device.index, n_obj)


@functools.lru_cache(maxsize=None)
def _slots(index: int, n_obj: int) -> int:
    with torch.cuda.device(index):
        return free_blocks_per_sm(n_obj) * torch.cuda.get_device_properties(
            index).multi_processor_count


def chain_blocks_per_sm(cfg: RenderConfig, n_tri: int, n_sph: int) -> int:
    """How many blocks of the whole-table chain kernel one SM of the
    current CUDA device holds at ``cfg`` (the runtime's occupancy count for
    the instance the config launches): an instrument, beside
    ``streamed_blocks_per_sm``."""
    ints, floats = launch_params(cfg, 0, cfg.height, n_tri, n_sph, False)
    fn = _build.load().render_bwd_blocks_per_sm
    fn.argtypes = [_INTS, _FLOATS, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(ints, floats, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"render_bwd_blocks_per_sm: CUDA error {err}")
    return out.value


def streamed_blocks_per_sm(cfg: RenderConfig, n_tri: int, n_sph: int) -> int:
    """How many blocks of the streamed backward kernel one SM of the
    current CUDA device holds at ``cfg`` (the runtime's occupancy count for
    the instance and the block the config launches): an instrument, beside
    ``flops.kernel_resources``."""
    ints, floats = launch_params(cfg, 0, cfg.height, n_tri, n_sph, False)
    ppb = pixels_per_block(cfg.aa_rays)
    fn = _build.load().render_bwd_streamed_blocks_per_sm
    fn.argtypes = [_INTS, _FLOATS, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(ints, floats, ppb, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"render_bwd_streamed_blocks_per_sm: CUDA error "
                           f"{err}")
    return out.value


def launch_blocks(n_pix: int, ppb: int) -> int:
    """Blocks of one backward launch over n_pix pixels, ppb a block (each
    has a partial row, and each of its THREADS threads a slot of the deep
    chain)."""
    return -(-n_pix // ppb)


def chain_blocks(n_pix: int, aa_rays: int, listed: bool) -> int:
    """The grid of the whole-table chain kernel over a band of n_pix pixels
    (``chain_blocks`` in csrc/render_bwd.cu): with the chain-free launch's
    list, that launch's block count (a block walks the listed pixels'
    chunks of ``pixels_per_block(aa_rays)``: blocks b, b + grid, ...);
    without it, one block a chunk of every pixel."""
    return launch_blocks(n_pix, THREADS if listed else
                         pixels_per_block(aa_rays))


def free_grid(n_pix: int, slots: int) -> tuple[int, int]:
    """The chain-free kernel's grid over a band of n_pix pixels on a device
    that holds ``slots`` of its blocks at once: (blocks, T), block b taking
    the contiguous tiles b * T ... (b + 1) * T - 1 of ``THREADS`` pixels
    (the last block fewer). T is the fewest tiles that put the grid in
    ``FREE_WAVES`` waves (at most ``FREE_MAX_TILES``; a larger band takes
    more blocks), and the grid the fewest blocks of T tiles that cover the
    band: full_1024's 8,192 tiles are 1,024 blocks of 8 on an H100's 528
    slots. (0, 0) for no pixel."""
    tiles = launch_blocks(n_pix, THREADS)
    if not tiles:
        return 0, 0
    t = min(-(-tiles // (FREE_WAVES * slots)), FREE_MAX_TILES)
    return -(-tiles // t), t


def free_shared_bytes(n_obj: int, tiles_per_block: int) -> int:
    """Shared memory one block of the chain-free kernel uses (must match
    ``free_smem`` in csrc/render_bwd.cu): the object table, the camera row,
    one cotangent accumulator per warp, and for each of its tiles its
    warps' ballots of the pixels left out."""
    warps = THREADS // 32
    return 4 * (n_obj * OBJ_COLS + CAM_COLS
                + warps * (n_obj * GRAD_COLS + CAM_COLS)
                + tiles_per_block * warps)


def band_bytes(n: int, W: int, A: int, B: int, cols: int,
               streamed: bool) -> dict:
    """{name: (bytes, limit)} of the buffers one launch over a band of n
    rows needs: the per-block partials (whole-table: the chain kernel's
    grid over every pixel, which no buffer of the split's two launches
    passes, since the chain-free launch's grid of tile ranges and the chain
    launch's grid over the list take at most a block a tile) or the
    per-site rows (streamed),
    and the deep chain when B > REG_BOUNCES: a slot per thread of the grid,
    whose block takes ``pixels_per_block(A)`` pixels, one thread per AA ray
    (the streamed kernel, and the whole-table chain kernel without the
    chain-free launch's list; with it the grid is smaller,
    ``chain_blocks``)."""
    threads = launch_blocks(n * W, pixels_per_block(A)) * THREADS
    out = ({"dlane": (4 * GRAD_COLS * (1 + B) * A * n * W, MAX_DLANE_BYTES)}
           if streamed else
           {"partials": (4 * (threads // THREADS) * cols, MAX_PARTIAL_BYTES)})
    if B > REG_BOUNCES:
        out["chain"] = (4 * CHAIN_FLOATS * B * threads, MAX_CHAIN_BYTES)
    return out


def _fits(n, W, A, B, cols, streamed) -> bool:
    return all(b <= lim for b, lim in
               band_bytes(n, W, A, B, cols, streamed).values())


def _row_bands(rows: int, W: int, A: int, B: int, cols: int,
               streamed: bool) -> list[tuple[int, int]]:
    """The row bands a backward over ``rows`` rows is taken in: consecutive
    (offset, n) covering [0, rows) in order, each within the byte limits of
    ``band_bytes``, as few as there can be, of near-equal height (all but
    the last of the same height). Raises if one row is past a limit."""
    if not rows:
        return []
    if not _fits(1, W, A, B, cols, streamed):
        over = {k: v for k, v in band_bytes(1, W, A, B, cols,
                                            streamed).items() if v[0] > v[1]}
        raise ValueError(
            f"render_bwd: one row of {W} pixels ({A} AA rays, {B} bounces) "
            f"needs more than a launch may hold: " + ", ".join(
                f"{k} {b} B (limit {lim} B)" for k, (b, lim) in over.items()))
    lo, hi = 1, rows              # the tallest band that fits: lo
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _fits(mid, W, A, B, cols, streamed) else (lo,
                                                                        mid - 1)
    h = -(-rows // -(-rows // lo))  # the fewest bands, of near-equal height
    return [(o, min(h, rows - o)) for o in range(0, rows, h)]


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
    return _sums_cotangents(partial.sum(dim=0), n_tri, n_sph, sph_rows)


def _sums_cotangents(sums, n_tri: int, n_sph: int, sph_rows: int):
    """``table_cotangents`` of the partials' sums [n_obj*16 + 21]."""
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
    order), the bounds of each id's run, and one call of
    ``segment_sum_launch`` (``csrc/render_bwd_streamed.cu``), whose two
    passes sum aligned tiles of 128 sorted positions that lie inside one
    run, then each run's head, tiles and tail in order, so that a long run
    is split over warps. Unlike ``index_add_`` on the card, which adds with
    float atomics, two calls on the same inputs give the same bits. A CPU
    tensor takes ``segment_sum_plain``."""
    global SEGMENT_SUM_LAUNCHES
    with tracing.span("rt.bwd.segment_sum"):
        if rows.device.type == "cpu":
            return segment_sum_plain(ids, rows, n_seg)
        dev = rows.device
        ids = ids.reshape(-1)
        _check("segment_sum ids", ids, (rows.shape[0],), torch.int32)
        _check("segment_sum rows", rows, (ids.shape[0], GRAD_COLS))
        if rows.data_ptr() % 16:      # the kernels read rows as float4
            rows = rows.clone()
        n = ids.shape[0]
        sorted_ids, order = torch.sort(ids, stable=True)
        bounds = torch.searchsorted(
            sorted_ids,
            torch.arange(n_seg + 1, dtype=torch.int32, device=dev))
        tiles = torch.empty((n // SEGMENT_TILE, GRAD_COLS),
                            dtype=torch.float32, device=dev)
        out = torch.empty((n_seg, GRAD_COLS), dtype=torch.float32,
                          device=dev)
        fn = _build.load().segment_sum_launch
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            err = fn(rows.data_ptr(), order.data_ptr(), sorted_ids.data_ptr(),
                     bounds.data_ptr(), tiles.data_ptr(), out.data_ptr(), n,
                     n_seg, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"segment_sum kernel launch failed: CUDA "
                               f"error {err}")
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
    [rows, W, 3]. Any bounce count and any frame size: a frame past the
    byte limits is taken in the row bands of ``_row_bands`` (one launch
    each, the bands' table cotangents added in band order, so two calls
    give the same bits). A CPU scene runs ``render_replay_bwd_plain``.
    ``_kernel`` pins the whole-table or the streamed kernel
    (``render_fwd.pick_kernel``)."""
    with tracing.span("rt.bwd"):
        row0, rows = _band(cfg, row0, rows)
        dev = scene.device
        if dev.type == "cpu":
            return render_replay_bwd_plain(scene, cfg, res, g, row0, rows,
                                           return_primal)
        if dev.type != "cuda":
            raise ValueError(f"render_bwd: scene on {dev}; the kernel needs a "
                             f"CUDA device (its plain version the CPU)")
        return _launch(scene, cfg, res, g, row0, rows, return_primal,
                       _kernel)


def _launch(scene: Scene, cfg: RenderConfig, res: Residuals, g, row0: int,
            rows: int, return_primal: bool, pin):
    """``render_replay_bwd`` on a CUDA scene. Spans: ``rt.bwd.pack`` (the
    tables packed under autograd, the checks, the buffers), then for each
    row band ``rt.bwd.launch`` (its launch or launches) and, on the
    streamed route, ``segment_sum``'s; ``_pull_back``'s last."""
    global LAUNCHES, FREE_LAUNCHES, STREAMED_LAUNCHES
    dev = scene.device
    with tracing.span("rt.bwd.pack"):
        n_tri = scene.num_triangles
        # CPU-ref ignores spheres entirely, as the forward kernel does
        n_sph = 0 if cfg.cpu_ref else scene.num_spheres
        n_obj = n_tri + n_sph
        W, A, B = cfg.width, cfg.aa_rays, cfg.bounces
        streamed = pick_kernel(n_tri, scene.num_spheres, pin)
        if streamed:
            cols = n_sph * GRAD_COLS + CAM_COLS
        else:
            cols = n_obj * GRAD_COLS + CAM_COLS
            if shared_bytes(n_obj, A) > SMEM_BUDGET_BYTES:
                raise ValueError(
                    f"render_bwd: {n_obj} objects: the whole-table backward "
                    f"kernel needs {shared_bytes(n_obj, A)} B of shared "
                    f"memory (limit {SMEM_BUDGET_BYTES})")
        bands = _row_bands(rows, W, A, B, cols, streamed)

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
            _check("res.bounce_id", res.bounce_id, (B, A, rows, W),
                   torch.int32)

        # one set of buffers, of the tallest band, reused band after band
        h = max((n for _, n in bands), default=0)
        split = not streamed and splits(cfg, rows, n_obj)
        # the streamed kernel and the chain kernel take one thread per AA ray
        # (the chain kernel over the chain-free launch's list walks it on that
        # launch's grid)
        ppb = pixels_per_block(A)
        threads = (chain_blocks(h * W, A, split) if not streamed
                   else launch_blocks(h * W, ppb)) * THREADS
        partial = torch.empty((threads // THREADS, cols), dtype=torch.float32,
                              device=dev)
        dlane = (torch.empty(((1 + B) * A * h * W, GRAD_COLS),
                             dtype=torch.float32, device=dev)
                 if streamed else None)
        chain = (torch.empty((CHAIN_FLOATS * B * threads,),
                             dtype=torch.float32, device=dev)
                 if B > REG_BOUNCES else None)
        img = (torch.empty((rows, W, 3), dtype=torch.float32, device=dev)
               if return_primal else None)
        launch = _declare(_build.load(), streamed)
        if split:
            # the chain-free launch's grid of tile ranges for each band, its
            # partial rows and its lists of the pixels it leaves out (one a
            # tile); the chain launch's partial rows are ``partial``
            slots = free_slots(dev, n_obj)
            grids = {n: free_grid(n * W, slots) for _, n in bands}
            partial_free = torch.empty(
                (max(b for b, _ in grids.values()), cols), dtype=torch.float32,
                device=dev)
            lists = torch.empty((threads,), dtype=torch.int32, device=dev)
            counts = torch.empty((threads // THREADS,), dtype=torch.int32,
                                 device=dev)
    totals = None
    walked = [] if split and tracing.gauging() else None
    tracing.count("bwd.bands", len(bands))
    for o, n in bands:
        with tracing.span("rt.bwd.launch"):
            if (o, n) == (0, rows):
                g_b, res_b = g, res
            else:
                g_b = g[o:o + n].contiguous()
                res_b = Residuals(*(t[..., o:o + n, :].contiguous()
                                    for t in res))
            partial_b = partial[:launch_blocks(n * W, ppb) if streamed
                                else chain_blocks(n * W, A, split)]
            outs = [partial_b]
            if streamed:
                # the kernel writes only the sites that hit a triangle: the
                # rest of the band's rows must read zero
                outs.insert(0, dlane[:(1 + B) * A * n * W].zero_())
            ints, floats = launch_params(cfg, row0 + o, n, n_tri, n_sph,
                                         return_primal)
            tables_g = (tri.data_ptr(), sph.data_ptr(), cam.data_ptr(),
                        g_b.data_ptr(), res_b.prim_id.data_ptr(),
                        res_b.lit_cnt.data_ptr())
            bid_ptr = res_b.bounce_id.data_ptr() if B else 0
            img_ptr = 0 if img is None else img[o:o + n].data_ptr()
            chain_ptr = 0 if chain is None else chain.data_ptr()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                if streamed:
                    err = launch(*tables_g, bid_ptr,
                                 *(t.data_ptr() for t in outs), img_ptr,
                                 chain_ptr, ints, floats, ppb, stream)
                elif split:
                    free_b, per_block = grids[n]
                    err = launch["free"](*tables_g, partial_free.data_ptr(),
                                         img_ptr, lists.data_ptr(),
                                         counts.data_ptr(), ints, floats,
                                         free_b, per_block, stream)
                    if err == 0:
                        FREE_LAUNCHES += 1
                        # one count a tile: as many as the chain launch's
                        # blocks
                        off = torch.cumsum(counts[:partial_b.shape[0]], 0,
                                           dtype=torch.int32)
                        if walked is not None:
                            walked.append(off[-1])
                        err = launch["chain"](
                            *tables_g, bid_ptr, partial_b.data_ptr(), img_ptr,
                            chain_ptr, lists.data_ptr(), off.data_ptr(), ints,
                            floats, stream)
                else:
                    err = launch["chain"](*tables_g, bid_ptr,
                                          partial_b.data_ptr(), img_ptr,
                                          chain_ptr, 0, 0, ints, floats,
                                          stream)
            if err != 0:
                raise RuntimeError(f"render_bwd kernel launch failed: CUDA "
                                   f"error {err}")
        if streamed:
            STREAMED_LAUNCHES += 1
            cot = streamed_table_cotangents(
                partial_b, outs[0], site_ids(res_b), n_tri, n_sph,
                sph.shape[0])
        else:
            LAUNCHES += 1
            sums = partial_b.sum(dim=0)
            if split:
                sums = partial_free[:grids[n][0]].sum(dim=0) + sums
            cot = _sums_cotangents(sums, n_tri, n_sph, sph.shape[0])
        totals = cot if totals is None else tuple(
            t + c for t, c in zip(totals, cot))
    if totals is None:      # no rows: nothing reaches the tables
        totals = tuple(torch.zeros_like(t) for t in (tri, sph, cam))
    if walked is not None:
        tracing.gauge("bwd.chain_pixels", walked)

    bar = _pull_back(list(tables), leaves, list(totals))
    return (bar, img) if return_primal else bar
