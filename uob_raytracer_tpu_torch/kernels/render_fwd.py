"""The fused forward render kernels: scene tables and the launch wrappers.

``render_fused_raw`` renders a frame in ONE launch of a CUDA kernel, the
Hopper counterpart of the TPU kernel
``uob_raytracer_tpu/kernels/render_fwd.py:_render_kernel``: AA ray
generation, brute-force nearest hit, the specular bounce loop, one
soft-shadow pass at the unified shading point, the AA mean and the ARGB
pack. ``render_fused_res`` is the same launch with the kernel's three
residual outputs switched on: the decision record (``ops/replay.py``)
that the path-replay backward consumes. The scene goes to the kernel as
the flat tables ``pack_scene`` and ``pack_shadow`` build, with the same
layouts as the JAX package's.

There are two kernels, which give the same frame and record bit for bit on
a scene both can run: the whole-table kernel (``csrc/render_fwd.cu``)
stages the tables in shared memory, and the streamed kernel
(``csrc/render_fwd_streamed.cu``, the counterpart of ``_render_kernel``'s
``streamed=True`` mode) leaves them in device memory and stages them tile
by tile, for any triangle count. ``use_streamed`` decides between them
from the scene's size alone, for the forward and the backward alike.

The kernel's plain torch versions, ``render_fused_plain`` and
``render_fused_res_plain`` (``render_flat`` and the AA mean), live here
beside it. For a scene on the CPU the wrappers run those plain versions;
for a CUDA scene they launch the kernel or raise, and never fall back.
``LAUNCHES`` counts the whole-table kernel's launches,
``STREAMED_LAUNCHES`` the streamed kernel's.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import tracing
from ..config import RenderConfig
from ..ops.camera import gen_primary_rays
from ..ops.image import pack_argb
from ..ops.intersect import prepare_scene
from ..ops.math3 import cross3, dot3
from ..ops.replay import Residuals
from ..ops.shading import shade, shade_cpu_ref
from ..scene import Scene
from . import _build

# Kernel launches since import (plain counters: a run can show that its
# main path went through a kernel): the whole-table and the streamed kernel.
LAUNCHES = 0
STREAMED_LAUNCHES = 0

TRI_COLS, PRIM_COLS, SPH_COLS, CAM_COLS, SHD_COLS = 19, 7, 12, 21, 13
OBJ_COLS = 17          # the whole-table backward's staged row
GRAD_COLS = 16         # a cotangent row: v0 e1 e2 n rgb r2
THREADS = 128          # threads per block of every render kernel
# Dynamic shared memory one block may opt into on an H100 (227 KB).
SMEM_BUDGET_BYTES = 232448
# The whole-table kernels take a scene of at most this many triangles even
# where its tables would fit shared memory. Set from the forward cut-over
# curve that chip_smoke.py measures on the H100 (PERF.md, "cut-over"): the
# largest measured size at which the whole-table forward is at least as
# fast at both image sizes. At 128x128 (one block per SM either way) it is
# 2-4% faster at every size it fits; at 512x512 its tables (156 B per
# triangle with a shadow table) leave room for fewer blocks per SM than the
# streamed kernel's registers allow from 384 triangles on, and it loses by
# 7% there, 27% at 512 and 57% at 1,024.
STREAM_ABOVE_TRIANGLES = 320

_F = np.float32


# --------------------------------------------------------------------------
# Scene packing: SoA Scene -> flat float32 tables
# --------------------------------------------------------------------------

def pack_scene(scene: Scene):
    """Flatten the scene into (tri [T,19], sph [S',12], cam [21]) float32
    tables. tri row: v0, e1, e2, n(unit), rgb, mat, E=cross(e1,e2).
    sph row: c, r2, rgb, mat, pad (one zero row when there are no spheres).
    cam: rot rows r0 r1 r2, camera, light, light_color, indirect."""
    v0 = scene.tri_v0
    e1 = scene.tri_v1 - v0
    e2 = scene.tri_v2 - v0
    n = cross3(e2, e1)
    nn = dot3(n, n)[:, None]
    n = n / torch.sqrt(torch.where(nn == 0, 1.0, nn))
    tri = torch.cat([v0, e1, e2, n, scene.tri_rgb, scene.tri_mat[:, None],
                     cross3(e1, e2)], dim=1)

    S = scene.num_spheres
    if S:
        sph = torch.cat([
            scene.sph_center, scene.sph_r2[:, None], scene.sph_rgb,
            scene.sph_mat[:, None],
            torch.zeros((S, 4), dtype=torch.float32, device=v0.device)], dim=1)
    else:
        sph = torch.zeros((1, SPH_COLS), dtype=torch.float32, device=v0.device)

    cy, sy = torch.cos(scene.yaw), torch.sin(scene.yaw)
    cp, sp = torch.cos(scene.pitch), torch.sin(scene.pitch)
    cam = torch.cat([
        torch.stack([cy, sp * sy, sy * cp, torch.zeros_like(cy), cp, -sp,
                     -sy, cy * sp, cp * cy]),
        scene.camera_pos, scene.light_pos, scene.light_color,
        scene.indirect_light,
    ])
    return tri.contiguous(), sph.contiguous(), cam.contiguous()


def pack_shadow(scene: Scene, quads):
    """Pack the occlusion-scan geometry for a quad pairing from
    ``ops.quads.detect_shadow_quads``: ``n_quads`` parallelogram rows
    (spanned from triangle a's off-diagonal corner p by its two shared
    vertices) followed by the unpaired triangles' rows. Row: v0 0:3,
    e1 3:6, e2 6:9, E=cross(e1,e2) 9:12, mat 12."""
    pairs, leftover = quads
    dev = scene.device
    v = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], dim=1)
    rows = []
    if pairs:
        pa = torch.tensor([p[0] for p in pairs], device=dev)
        pc = torch.tensor([p[1] for p in pairs], device=dev)
        P = v[pa, pc]
        e1 = v[pa, (pc + 1) % 3] - P
        e2 = v[pa, (pc + 2) % 3] - P
        rows.append(torch.cat(
            [P, e1, e2, cross3(e1, e2), scene.tri_mat[pa][:, None]], dim=1))
    if leftover:
        li = torch.tensor(leftover, device=dev)
        P = scene.tri_v0[li]
        e1 = scene.tri_v1[li] - P
        e2 = scene.tri_v2[li] - P
        rows.append(torch.cat(
            [P, e1, e2, cross3(e1, e2), scene.tri_mat[li][:, None]], dim=1))
    return torch.cat(rows, dim=0).contiguous()


def pixels_per_block(aa_rays: int) -> int:
    """Pixels one block of the whole-table forward kernel takes (must match
    ``pixels_per_block`` in csrc/render_fwd.cu): 32 * 4 / gcd(A, 4), the
    fewest whole warps of pixels whose A rays fill whole rounds of
    ``THREADS`` threads, one thread per ray."""
    return 32 * 4 // math.gcd(aa_rays, 4)


def shared_bytes(n_tri: int, n_sph: int, n_shd: int, aa_rays: int = 1) -> int:
    """Shared memory one block of the whole-table forward kernel uses (must
    match the launcher in csrc/render_fwd.cu): the tables, the primary
    hit's invariants and the colours of the block's rays."""
    return 4 * (n_tri * (TRI_COLS + PRIM_COLS) + n_sph * SPH_COLS + CAM_COLS
                + n_shd * SHD_COLS + pixels_per_block(aa_rays) * aa_rays * 3)


def bwd_shared_bytes(n_obj: int, aa_rays: int = 1) -> int:
    """Shared memory one block of the whole-table backward's chain kernel
    uses (must match ``chain_smem`` in csrc/render_bwd.cu): the object
    table, the camera row, one cotangent accumulator per warp, and the
    radiance of a chunk's ``pixels_per_block(aa_rays) * aa_rays`` rays and
    its pixels' indices (the chain-free kernel uses all but the last two)."""
    warps = THREADS // 32
    return 4 * (n_obj * OBJ_COLS + CAM_COLS
                + warps * (n_obj * GRAD_COLS + CAM_COLS)
                + pixels_per_block(aa_rays) * (3 * aa_rays + 1))


def use_streamed(n_tri: int, n_sph: int) -> bool:
    """Whether a scene of this size goes to the streamed kernels rather
    than the whole-table ones: decided from the scene alone, once for the
    forward and the backward. Whole-table while the triangle count is
    within ``STREAM_ABOVE_TRIANGLES`` (where the measured curve says the
    whole-table forward is at least as fast) and the tables fit one
    block's shared memory both ways: the forward's with a shadow table as
    long as the triangle table (104 + 52 B per triangle), the backward's
    object table and per-warp accumulators (324 B per object)."""
    return (n_tri > STREAM_ABOVE_TRIANGLES
            or shared_bytes(n_tri, n_sph, n_tri) > SMEM_BUDGET_BYTES
            or bwd_shared_bytes(n_tri + n_sph) > SMEM_BUDGET_BYTES)


def pick_kernel(n_tri: int, n_sph: int, pin) -> bool:
    """True for the streamed kernels. ``pin`` is the wrappers' private
    ``_kernel`` argument: None (``use_streamed`` decides), or "whole" /
    "streamed" to pin one for a measurement."""
    if pin not in (None, "whole", "streamed"):
        raise ValueError(f"_kernel={pin!r}: None, 'whole' or 'streamed'")
    return use_streamed(n_tri, n_sph) if pin is None else pin == "streamed"


def launch_params(cfg: RenderConfig, row0: int, rows: int, n_tri: int,
                  n_sph: int, n_quads: int, n_shd: int):
    """The launcher's host parameter arrays (ints, floats). The float32
    constants are computed exactly as the JAX kernel computes them."""
    A = cfg.aa_rays
    ints = (cfg.width, cfg.height, row0, rows, cfg.aa_x, cfg.aa_y,
            cfg.shadow_samples, cfg.bounces, n_tri, n_sph, n_quads, n_shd,
            int(cfg.cpu_ref), int(cfg.fresnel), int(cfg.quirk_nan_tir))
    shadow_bias = cfg.cpu_ref_bias if cfg.cpu_ref else cfg.bias
    floats = (_F(cfg.width * cfg.aa_x / 2.0), _F(cfg.height * cfg.aa_y / 2.0),
              _F(cfg.effective_focal), _F(cfg.light_spread), _F(shadow_bias),
              _F(cfg.bias), _F(cfg.ior_glass), _F(cfg.ior_air), _F(1.0 / A),
              _F(4.0 * np.pi))
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*[float(f) for f in floats]))


def _declare(lib: ctypes.CDLL, streamed: bool):
    fn = lib.render_fwd_streamed_launch if streamed else lib.render_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32):
    if t.dtype != dtype or t.device.type != "cuda" or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(
            f"render_fwd: {name} must be a contiguous {dtype} CUDA tensor of "
            f"shape {shape}; got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


# --------------------------------------------------------------------------
# The plain torch version (the kernel's semantic twin)
# --------------------------------------------------------------------------

def _pick_chunk_rows(cfg: RenderConfig, rows: int | None = None,
                     target_rays: int = 1 << 18, n_tri: int = 0) -> int:
    """Largest divisor of the row count (H by default) keeping
    rows*W*A near the target ray count per chunk. The target bounds the
    peak memory of the [rays, triangles] broadcast, so it shrinks in
    proportion to the triangle count above 32: at most 2^23 (ray,
    triangle) pairs, 34 MB per float32 intermediate, until one row alone
    is more."""
    rows = cfg.height if rows is None else rows
    per_row = cfg.width * cfg.aa_rays
    want = max(1, target_rays * 32 // max(n_tri, 32) // per_row)
    divs = [d for d in range(1, rows + 1) if rows % d == 0]
    return max(d for d in divs if d <= want) if any(d <= want for d in divs) else 1


def render_flat(scene: Scene, cfg: RenderConfig, chunk_rows: int | None = None,
                row0: int = 0, rows: int | None = None, record: bool = False,
                tri_axis=None, tri_pass: str = "torch", tri_offset: int = 0):
    """Float radiance per AA ray, shaped [rows, W, A, 3], for the row band
    [row0, row0 + rows) of the cfg-sized image (the whole image by
    default). Chunks of ``chunk_rows`` rows run one after another. With
    ``record`` it returns (radiance, Residuals): every ray's decisions in
    the kernel's A-major layout.

    tri_axis / tri_pass / tri_offset: the triangle-sharded wavefront
    pipeline (``parallel/render.py``). ``scene`` then holds this rank's
    slice of the triangles, whose first has the global index
    ``tri_offset``; ``tri_axis`` is the process group the slices are
    combined over and ``tri_pass`` the route of the triangle scans
    (``ops/intersect.py``). With ``tri_pass='kernel'`` a band is one chunk:
    the scans hold no [rays, triangles] intermediate."""
    ds = prepare_scene(scene)._replace(tri_offset=tri_offset)
    if cfg.cpu_ref and (tri_axis is not None or tri_pass != "torch"):
        raise ValueError("cpu_ref shading scans the whole triangle table "
                         "in torch: no tri_axis, tri_pass='torch'")
    rows = cfg.height - row0 if rows is None else rows
    dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch, row0, rows)
    W = cfg.width
    A = dirs.shape[2]
    if chunk_rows is None:
        chunk_rows = (rows if tri_pass == "kernel" else
                      _pick_chunk_rows(cfg, rows, n_tri=scene.num_triangles))
    if rows % chunk_rows:
        raise ValueError(
            f"chunk_rows={chunk_rows} must divide the {rows} rows rendered")
    rays_per_chunk = chunk_rows * W * A

    d_flat = dirs.reshape(-1, rays_per_chunk, 3)
    gid_flat = gid.reshape(-1).repeat_interleave(A).reshape(-1, rays_per_chunk)
    start = scene.camera_pos.expand(rays_per_chunk, 3)
    colors, records = [], []
    for d_c, gid_c in zip(d_flat, gid_flat):
        if cfg.cpu_ref:
            out = shade_cpu_ref(ds, cfg, start, d_c, record)
        else:
            out = shade(ds, cfg, start, d_c, gid_c, record, tri_axis,
                        tri_pass)
        if record:
            out, rec = out
            records.append(rec)
        colors.append(out)
    colors = torch.stack(colors).reshape(rows, W, A, 3)
    if not record:
        return colors
    pid, lit, bid = (torch.cat(parts, dim=-1) for parts in zip(*records))
    return colors, Residuals(
        prim_id=pid.reshape(rows, W, A).permute(2, 0, 1).contiguous(),
        lit_cnt=lit.reshape(rows, W, A).permute(2, 0, 1).contiguous(),
        bounce_id=bid.reshape(-1, rows, W, A).permute(0, 3, 1, 2).contiguous())


def render_fused_plain(scene: Scene, cfg: RenderConfig, row0: int = 0,
                       rows: int | None = None,
                       chunk_rows: int | None = None):
    """The plain torch version of ``render_fused_raw``, on the scene's
    device: the AA mean of ``render_flat`` (``kernels.cl:427``) and its
    ARGB pack. It scans triangles one by one (no quad merging)."""
    colors = render_flat(scene, cfg, chunk_rows, row0, rows)
    img = colors.sum(dim=2) / float(colors.shape[2])
    return img, pack_argb(img)


def render_fused_res_plain(scene: Scene, cfg: RenderConfig, row0: int = 0,
                           rows: int | None = None,
                           chunk_rows: int | None = None):
    """The plain torch version of ``render_fused_res``: (image, packed,
    Residuals). The image is ``render_fused_plain``'s, bit for bit."""
    colors, res = render_flat(scene, cfg, chunk_rows, row0, rows, record=True)
    img = colors.sum(dim=2) / float(colors.shape[2])
    return img, pack_argb(img), res


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------

def _band(cfg: RenderConfig, row0, rows) -> tuple[int, int]:
    row0 = 0 if row0 is None else int(row0)
    rows = cfg.height - row0 if rows is None else int(rows)
    if row0 < 0 or rows < 0 or row0 + rows > cfg.height:
        raise ValueError(f"row band [{row0}, {row0 + rows}) is outside the "
                         f"{cfg.height}-row image")
    return row0, rows


def render_fused_raw(scene: Scene, cfg: RenderConfig, row0=None,
                     rows: int | None = None, quads=None, _kernel=None):
    """Forward render of one frame: (image [rows, W, 3] float32, packed
    [rows, W] uint32), on the scene's device.

    row0/rows render only a row band of the logical cfg-sized image (ray
    centering and pixel-id RNG stay global). quads: optional static
    pairing from ``ops.quads.detect_shadow_quads`` — quad-merged occlusion
    scan (the plain version scans triangles and ignores it). cfg.cpu_ref
    runs the same kernel in CPU-ref semantics (skeleton.cpp:184-279).
    A CPU scene runs ``render_fused_plain``. Not differentiable by itself:
    ``render.render_image`` wires the path-replay backward. ``_kernel``
    pins the whole-table or the streamed kernel (``pick_kernel``)."""
    row0, rows = _band(cfg, row0, rows)
    if scene.device.type == "cpu":
        with torch.no_grad():
            return render_fused_plain(scene, cfg, row0, rows)
    return _launch(scene, cfg, row0, rows, quads, False, _kernel)[:2]


def render_fused_res(scene: Scene, cfg: RenderConfig, row0=None,
                     rows: int | None = None, quads=None, _kernel=None):
    """Forward render that also returns the decision residuals consumed by
    the path-replay backward: (image, packed, Residuals). The same single
    kernel launch as ``render_fused_raw`` with its residual outputs on. A
    CPU scene runs ``render_fused_res_plain``."""
    row0, rows = _band(cfg, row0, rows)
    if scene.device.type == "cpu":
        with torch.no_grad():
            return render_fused_res_plain(scene, cfg, row0, rows)
    return _launch(scene, cfg, row0, rows, quads, True, _kernel)


def blocks_per_sm(scene: Scene, cfg: RenderConfig, quads=None) -> int:
    """How many blocks of the whole-table forward kernel one SM of the
    current CUDA device holds when it renders ``scene`` at ``cfg`` (the
    runtime's occupancy count at that launch's registers, shared memory and
    threads): an instrument, beside ``flops.kernel_resources``."""
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    n_shd = 0 if quads is None else len(quads[0]) + len(quads[1])
    n_quads = 0 if quads is None else len(quads[0])
    ints, floats = launch_params(cfg, 0, cfg.height, scene.num_triangles,
                                 n_sph, n_quads, n_shd)
    fn = _build.load().render_fwd_blocks_per_sm
    fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(ints, floats, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"render_fwd_blocks_per_sm: CUDA error {err}")
    return out.value


def _launch(scene: Scene, cfg: RenderConfig, row0: int, rows: int, quads,
            record: bool, pin=None):
    """One launch of the whole-table or the streamed forward kernel on the
    scene's CUDA device: (image, packed, Residuals or None). Spans:
    ``rt.fwd.pack`` (the tables, their checks and the outputs' buffers),
    then ``rt.fwd.launch``."""
    global LAUNCHES, STREAMED_LAUNCHES
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"render_fwd: scene on {dev}; the kernel needs a "
                         f"CUDA device (its plain version the CPU)")

    with tracing.span("rt.fwd.pack"):
        n_tri = scene.num_triangles
        # CPU-ref ignores spheres entirely (the vestigial path predates them)
        n_sph = 0 if cfg.cpu_ref else scene.num_spheres
        streamed = pick_kernel(n_tri, scene.num_spheres, pin)
        # the tables feed the kernel's raw pointers; the backward pulls its
        # cotangents through pack_scene again (render.py), so no graph here
        with torch.no_grad():
            tri, sph, cam = pack_scene(scene)
            shd = None if quads is None else pack_shadow(scene, quads)
        n_shd = 0 if shd is None else shd.shape[0]
        n_quads = 0 if quads is None else len(quads[0])
        smem = shared_bytes(n_tri, n_sph, n_shd, cfg.aa_rays)
        if not streamed and smem > SMEM_BUDGET_BYTES:
            # only a pinned whole-table kernel gets here: use_streamed sends
            # such a scene to the streamed kernel
            raise ValueError(
                f"scene tables need {smem} B of shared memory, above the "
                f"{SMEM_BUDGET_BYTES} B a block of the whole-table kernel may "
                f"use")
        _check("tri", tri, (n_tri, TRI_COLS))
        _check("sph", sph, (max(scene.num_spheres, 1), SPH_COLS))
        _check("cam", cam, (CAM_COLS,))
        if shd is not None:
            _check("shd", shd, (n_shd, SHD_COLS))

        W, A = cfg.width, cfg.aa_rays
        img = torch.empty((rows, W, 3), dtype=torch.float32, device=dev)
        packed = torch.empty((rows, W), dtype=torch.uint32, device=dev)
        res = None
        if record:
            # every element is written by the kernel: steps a ray never ran
            # get -1, a ray that shades nothing gets lit 0
            res = Residuals(
                prim_id=torch.empty((A, rows, W), dtype=torch.int32,
                                    device=dev),
                lit_cnt=torch.empty((A, rows, W), dtype=torch.float32,
                                    device=dev),
                bounce_id=torch.empty((cfg.bounces, A, rows, W),
                                      dtype=torch.int32, device=dev))
    with tracing.span("rt.fwd.launch"):
        ints, floats = launch_params(cfg, row0, rows, n_tri, n_sph, n_quads,
                                     n_shd)
        launch = _declare(_build.load(), streamed)
        with torch.cuda.device(dev):
            err = launch(tri.data_ptr(), sph.data_ptr(), cam.data_ptr(),
                         0 if shd is None else shd.data_ptr(), img.data_ptr(),
                         packed.data_ptr(),
                         *((0, 0, 0) if res is None else
                           (t.data_ptr() for t in res)),
                         ints, floats,
                         torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"render_fwd kernel launch failed: CUDA error "
                               f"{err}")
        if streamed:
            STREAMED_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return img, packed, res
