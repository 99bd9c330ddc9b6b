"""The per-shard partial-scan kernels: wrappers and plain versions.

Tensor-parallel rendering shards the triangle table across ranks; each
rank computes a LOCAL nearest hit / occlusion answer for a batch of rays
and ``ops/intersect.py`` combines the winners across ranks outside the
kernel. ``nearest_tris`` and ``occluded_tris`` are those per-shard scans,
each ONE launch of a CUDA kernel of ``csrc/partial.cu``: the Hopper
counterparts of the TPU kernels
``uob_raytracer_tpu/kernels/partial.py:_nearest_kernel`` and
``_occluded_kernel``. Rays are ``[N, 3]`` float32 tensors as they come; the
shard's table is packed here (``[T, 16]`` for the nearest hit, ``[T, 13]``
for the occlusion scan) and nothing is padded.

``nearest_tris`` is differentiable by path replay, as the JAX wrapper is:
the forward records each ray's LOCAL winning triangle, and the backward
gathers the winning rows, replays the Cramer solve and the attribute pick
in torch under autograd (``_nearest_replay``) and adds the per-ray
cotangents of the gathered rows into the shard's tables with the
deterministic ``segment_sum`` of ``kernels/render_bwd.py`` (no float
atomics: two runs give the same bits). Visibility (which triangle wins, the
occlusion bits) is frozen, the gradient convention of the whole package.
``occluded_tris`` returns booleans and takes its inputs detached.

The kernels' plain torch versions, ``nearest_tris_plain`` and
``occluded_tris_plain`` (``ops/intersect.py``'s ``[N, T]`` scans, in chunks
of rays), live here beside them. For tensors on the CPU the wrappers run
those plain versions; for CUDA tensors they launch the kernels or raise,
and never fall back. ``NEAREST_LAUNCHES`` and ``OCCLUDED_LAUNCHES`` count
the launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..ops.intersect import DeviceScene, _best_triangle, tris_occlude
from ..ops.math3 import cross3, det3
from . import _build
from .render_bwd import GRAD_COLS, segment_sum
from .render_fwd import SHD_COLS, THREADS, _check

# Kernel launches since import (plain counters, as the render kernels'),
# and the grid of the last nearest-hit launch (blocks).
NEAREST_LAUNCHES = 0
OCCLUDED_LAUNCHES = 0
LAST_NEAREST_GRID = 0

# The nearest-hit kernel (csrc/partial.cu): its table's row (v0 e1 e2 n rgb
# mat) and its thread groups a ray (kNearCols, kNearGroups there).
NEAR_COLS = 16
NEAR_GROUPS = 4

# The plain versions hold at most this many (ray, triangle) pairs in one
# [rays, triangles] intermediate (34 MB each in float32), as
# ``render_fused_plain`` does.
PLAIN_PAIRS = 1 << 23


def _shard(v0, e1, e2, n, rgb, mat) -> DeviceScene:
    """The shard as the [N, T] scans of ``ops/intersect.py`` take it: the
    triangle fields of a DeviceScene and nothing else."""
    none = v0.new_zeros((0,))
    return DeviceScene(v0, e1, e2, n, rgb, mat, *([none] * 8))


def _ray_chunks(n_rays: int, n_tri: int):
    step = max(1, PLAIN_PAIRS // max(n_tri, 1))
    return [slice(i, min(i + step, n_rays)) for i in range(0, n_rays, step)]


# --------------------------------------------------------------------------
# The plain torch versions
# --------------------------------------------------------------------------

def nearest_tris_plain(v0, e1, e2, n, rgb, mat, start, d):
    """The plain torch version of ``nearest_tris``:
    ``ops.intersect._best_triangle`` on the shard, a chunk of rays at a
    time; differentiable by plain autograd."""
    ds = _shard(v0, e1, e2, n, rgb, mat)
    parts = [_best_triangle(ds, start[c], d[c])
             for c in _ray_chunks(start.shape[0], v0.shape[0])]
    if not parts:
        parts = [_best_triangle(ds, start, d)]
    t, li, pos, nrm, rgb_o, mat_o = (torch.cat(p) for p in zip(*parts))
    idx = torch.where(torch.isfinite(t), li, -1).to(torch.int32)
    return t, pos, nrm, rgb_o, mat_o, idx


def occluded_tris_plain(v0, e1, e2, mat, start, d, radius_sq):
    """The plain torch version of ``occluded_tris``: the triangle half of
    ``ops.intersect.in_shadow`` on the shard, a chunk of rays at a time."""
    ds = _shard(v0, e1, e2, v0, v0, mat)
    with torch.no_grad():
        parts = [tris_occlude(ds, start[c], d[c], radius_sq[c])
                 for c in _ray_chunks(start.shape[0], v0.shape[0])]
    if not parts:
        return torch.zeros((0,), dtype=torch.bool, device=start.device)
    return torch.cat(parts)


# --------------------------------------------------------------------------
# The nearest hit: launch, replay, autograd
# --------------------------------------------------------------------------

def _rays(name: str, start, d):
    """The ray batch as the kernels read it: contiguous float32 [N, 3]."""
    start = start.detach().to(torch.float32).contiguous()
    d = d.detach().to(torch.float32).contiguous()
    n_rays = start.shape[0]
    _check(f"{name} start", start, (n_rays, 3))
    _check(f"{name} d", d, (n_rays, 3))
    return start, d, n_rays


def nearest_grid(n_rays: int) -> int:
    """Blocks of the nearest-hit kernel for a batch of n_rays: ``THREADS //
    NEAR_GROUPS`` rays a block."""
    return -(-n_rays * NEAR_GROUPS // THREADS)


def nearest_blocks_per_sm() -> int:
    """How many blocks of the nearest-hit kernel one SM of the current CUDA
    device holds (the runtime's occupancy count): an instrument."""
    fn = _build.load().nearest_tris_blocks_per_sm
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"nearest_tris_blocks_per_sm: CUDA error {err}")
    return out.value


def _nearest_launch(v0, e1, e2, n, rgb, mat, start, d):
    """One launch of ``nearest_tris_kernel`` on CUDA tensors."""
    global NEAREST_LAUNCHES, LAST_NEAREST_GRID
    dev = start.device
    n_tri = v0.shape[0]
    start, d, n_rays = _rays("nearest_tris", start, d)
    tri = torch.cat([v0, e1, e2, n, rgb, mat[:, None]],
                    dim=1).detach().to(torch.float32).contiguous()
    _check("nearest_tris table", tri, (n_tri, NEAR_COLS))
    blocks = nearest_grid(n_rays)

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    t, pos, nrm, rgb_o = out(n_rays), out(n_rays, 3), out(n_rays, 3), out(n_rays, 3)
    mat_o, idx = out(n_rays), out(n_rays, dtype=torch.int32)
    fn = _build.load().nearest_tris_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(tri.data_ptr(), start.data_ptr(), d.data_ptr(), t.data_ptr(),
                 pos.data_ptr(), nrm.data_ptr(), rgb_o.data_ptr(),
                 mat_o.data_ptr(), idx.data_ptr(), n_tri, n_rays, blocks,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nearest_tris kernel launch failed: CUDA error "
                           f"{err}")
    NEAREST_LAUNCHES += 1
    LAST_NEAREST_GRID = blocks
    return t, pos, nrm, rgb_o, mat_o, idx


class _GatherTableRows(torch.autograd.Function):
    """rows = table[idx] for idx >= 0 (row 0 stands in on a miss). The
    pull-back adds each ray's cotangent row into its triangle's row with
    ``segment_sum``: a fixed order, no atomics."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx.clamp(min=0).to(torch.int64)]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(idx, g.contiguous(), ctx.n_rows), None


def _nearest_replay(idx, v0, e1, e2, n, rgb, start, d):
    """Differentiable reconstruction of the kernel's outputs from the
    recorded winning ids: gather the winning rows and replay the Cramer
    solve + attribute pick (kernels.cl:92-130) per ray. Denominators carry
    the usual guards so miss and degenerate rays stay NaN-free in both
    directions; visibility (idx) is frozen. Returns (t, pos, normal, rgb)."""
    hit = idx >= 0
    table = torch.cat([v0, e1, e2, n, rgb, v0.new_zeros((v0.shape[0], 1))],
                      dim=1)                      # [T, 16], a GRAD_COLS row
    rows = _GatherTableRows.apply(table, idx)
    V0, E1, E2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    b = start - V0
    nd = -d
    detA = det3(nd, E1, E2)
    degen = detA == 0
    recip = 1.0 / torch.where(degen, 1.0, detA)
    t = det3(b, E1, E2) * recip
    u = det3(nd, b, E2) * recip
    v = det3(nd, E1, b) * recip
    h3 = hit[:, None]
    t_o = torch.where(hit, torch.where(degen, 0.0, t), float("inf"))
    pos = torch.where(h3, V0 + u[:, None] * E1 + v[:, None] * E2, 0.0)
    return (t_o, pos, torch.where(h3, rows[:, 9:12], 0.0),
            torch.where(h3, rows[:, 12:15], 0.0))


class _NearestTris(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) forward, the replay
    backward: the counterpart of the JAX wrapper's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, v0, e1, e2, n, rgb, mat, start, d):
        if start.device.type == "cpu":
            out = nearest_tris_plain(v0, e1, e2, n, rgb, mat, start, d)
        else:
            out = _nearest_launch(v0, e1, e2, n, rgb, mat, start, d)
        ctx.save_for_backward(v0, e1, e2, n, rgb, start, d, out[5])
        ctx.mark_non_differentiable(out[4], out[5])   # mat, idx: frozen
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dt, dpos, dnrm, drgb, _dmat, _didx):
        *saved, idx = ctx.saved_tensors
        # t = inf on a miss: its cotangent (and any non-finite one) is void
        dt = torch.where((idx >= 0) & torch.isfinite(dt), dt, 0.0)
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(True) for x in saved]
            outs = _nearest_replay(idx, *ins)
            dv0, de1, de2, dn, drgb_t, dstart, dd = torch.autograd.grad(
                outs, ins, (dt, dpos, dnrm, drgb))
        return dv0, de1, de2, dn, drgb_t, None, dstart, dd


def nearest_tris(v0, e1, e2, n, rgb, mat, start, d):
    """Local nearest triangle hit over this shard's table.

    v0, e1, e2, n, rgb [T,3] and mat [T]: the shard; start, d [N,3]: the
    rays. Returns (t [N] with inf for a miss, pos [N,3], normal [N,3], rgb
    [N,3], mat [N], idx [N] local int32 with -1 for a miss): the per-shard
    inputs of ``ops.intersect._combine_tri_best``. Ties go to the lowest
    row. Differentiable in v0, e1, e2, n, rgb, start and d by the
    path-replay backward (see the module docstring). CUDA tensors launch
    ``nearest_tris_kernel``; CPU tensors run ``nearest_tris_plain``."""
    if start.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nearest_tris: rays on {start.device}; the kernel "
                         f"needs a CUDA device (its plain version the CPU)")
    return _NearestTris.apply(v0, e1, e2, n, rgb, mat, start, d)


# --------------------------------------------------------------------------
# The occlusion scan
# --------------------------------------------------------------------------

def occluded_tris(v0, e1, e2, mat, start, d, radius_sq):
    """Local triangle occlusion (any hit within the light radius) over this
    shard's table: the triangle half of ``ops.intersect.in_shadow``.
    Returns occluded [N] bool. The boolean's gradient is identically zero
    (it is built from comparisons alone), so the inputs are detached. CUDA
    tensors launch ``occluded_tris_kernel``; CPU tensors run
    ``occluded_tris_plain``."""
    global OCCLUDED_LAUNCHES
    dev = start.device
    if dev.type == "cpu":
        return occluded_tris_plain(v0.detach(), e1.detach(), e2.detach(),
                                   mat.detach(), start.detach(), d.detach(),
                                   radius_sq.detach())
    if dev.type != "cuda":
        raise ValueError(f"occluded_tris: rays on {dev}; the kernel needs a "
                         f"CUDA device (its plain version the CPU)")
    n_tri = v0.shape[0]
    start, d, n_rays = _rays("occluded_tris", start, d)
    radius_sq = radius_sq.detach().to(torch.float32).contiguous()
    _check("occluded_tris radius_sq", radius_sq, (n_rays,))
    # the occlusion scan's row (``pack_shadow``): v0 e1 e2 E=cross(e1,e2) mat
    shd = torch.cat([v0, e1, e2, cross3(e1, e2), mat[:, None]],
                    dim=1).detach().to(torch.float32).contiguous()
    _check("occluded_tris table", shd, (n_tri, SHD_COLS))
    out = torch.empty((n_rays,), dtype=torch.uint8, device=dev)
    fn = _build.load().occluded_tris_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(shd.data_ptr(), start.data_ptr(), d.data_ptr(),
                 radius_sq.data_ptr(), out.data_ptr(), n_tri, n_rays,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"occluded_tris kernel launch failed: CUDA error "
                           f"{err}")
    OCCLUDED_LAUNCHES += 1
    return out.to(torch.bool)
