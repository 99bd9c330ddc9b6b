"""The path-replay backward kernel: its launch wrapper and plain version.

``render_replay_bwd`` turns an image cotangent into a Scene gradient in ONE
launch of the CUDA kernel in ``csrc/render_bwd.cu``, the Hopper counterpart
of the TPU kernel ``uob_raytracer_tpu/kernels/render_bwd.py:_bwd_kernel``:
every ray re-gathers the objects it hit (the decision record of
``render_fused_res``), replays the lean reconstruction of its radiance
(``ops/replay.py``) and runs the hand-derived adjoint of that replay. The
kernel hands back per-block partial sums of the packed tables' cotangents
(``pack_scene``'s tri, sph and cam); this wrapper sums them over blocks and
pulls them back onto the 15 Scene leaves through torch autograd of
``pack_scene``, so vertex gradients include the path through the recomputed
normals.

The kernel's plain torch version, ``render_replay_bwd_plain`` (torch
autograd through ``ops.replay.replay_forward``), lives here beside it. For
a scene on the CPU the wrapper runs that plain version; for a CUDA scene it
launches the kernel or raises, and never falls back. ``LAUNCHES`` counts
the launches.
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
from .render_fwd import (CAM_COLS, SMEM_BUDGET_BYTES, SPH_COLS, TRI_COLS,
                         _band, _check, pack_scene)

# Kernel launches since import.
LAUNCHES = 0

THREADS = 128          # threads per block (must match csrc/render_bwd.cu)
OBJ_COLS = 17          # staged object row: v0 e1 e2 n rgb mat r2
GRAD_COLS = 16         # cotangent row: v0 e1 e2 n rgb r2
# Per-thread storage of the bounce chain is sized at compile time
# (kMaxBounces in csrc/render_bwd.cu); deeper configs are refused.
MAX_BOUNCES = 16
# The per-block partial sums grow with the object count; past this size
# the scene belongs to the streamed kernels, which are not ported.
MAX_PARTIAL_BYTES = 1 << 30

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

def shared_bytes(n_obj: int) -> int:
    """Shared memory one block of the kernel uses (must match the launcher
    in csrc/render_bwd.cu): the object table, the camera row, and one
    cotangent accumulator per warp."""
    warps = THREADS // 32
    return 4 * (n_obj * OBJ_COLS + CAM_COLS
                + warps * (n_obj * GRAD_COLS + CAM_COLS))


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


def _declare(lib: ctypes.CDLL):
    fn = lib.render_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def table_cotangents(partial, n_tri: int, n_sph: int, sph_rows: int):
    """Sum the kernel's per-block partials [blocks, n_obj*16 + 21] and
    spread them into the layouts of ``pack_scene``'s tables: (dtri [T,19]
    with columns 0..14 filled, dsph [sph_rows,12], dcam [21])."""
    sums = partial.sum(dim=0)
    n_obj = n_tri + n_sph
    obj = sums[:n_obj * GRAD_COLS].reshape(n_obj, GRAD_COLS)
    dtri = partial.new_zeros((n_tri, TRI_COLS))
    dtri[:, :15] = obj[:n_tri, :15]
    dsph = partial.new_zeros((sph_rows, SPH_COLS))
    if n_sph:
        s = obj[n_tri:]
        dsph[:n_sph, 0:3] = s[:, 0:3]       # center
        dsph[:n_sph, 3] = s[:, 15]          # r2
        dsph[:n_sph, 4:7] = s[:, 12:15]     # rgb
    return dtri, dsph, sums[n_obj * GRAD_COLS:]


def render_replay_bwd(scene: Scene, cfg: RenderConfig, res: Residuals, g,
                      row0=None, rows: int | None = None,
                      return_primal: bool = False):
    """Scene cotangent of the fused forward render: the path-replay
    backward. ``res`` is the record from ``render_fused_res``; ``g`` is the
    image cotangent [rows, W, 3]. Returns a Scene of gradients (zeros for
    the material codes), equal to float tolerance to autograd through
    ``replay_forward``; with ``return_primal`` also the replayed radiance
    [rows, W, 3]. A CPU scene runs ``render_replay_bwd_plain``."""
    global LAUNCHES
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
    cols = n_obj * GRAD_COLS + CAM_COLS
    if (shared_bytes(n_obj) > SMEM_BUDGET_BYTES
            or 4 * n_blocks * cols > MAX_PARTIAL_BYTES):
        raise NotImplementedError(
            f"{n_obj} objects over {n_blocks} blocks: the whole-table "
            f"backward kernel needs {shared_bytes(n_obj)} B of shared memory "
            f"(limit {SMEM_BUDGET_BYTES}) and {4 * n_blocks * cols} B of "
            f"partial sums (limit {MAX_PARTIAL_BYTES}); larger scenes need "
            f"the streamed kernel, which is not ported yet")

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
    img = (torch.empty((rows, W, 3), dtype=torch.float32, device=dev)
           if return_primal else None)
    ints, floats = launch_params(cfg, row0, rows, n_tri, n_sph, return_primal)
    launch = _declare(_build.load())
    with torch.cuda.device(dev):
        err = launch(tri.data_ptr(), sph.data_ptr(), cam.data_ptr(),
                     g.data_ptr(), res.prim_id.data_ptr(),
                     res.lit_cnt.data_ptr(),
                     res.bounce_id.data_ptr() if B else 0,
                     partial.data_ptr(), 0 if img is None else img.data_ptr(),
                     ints, floats,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_bwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1

    bar = _pull_back(list(tables), leaves, list(table_cotangents(
        partial, n_tri, n_sph, sph.shape[0])))
    return (bar, img) if return_primal else bar
