"""Camera model: yaw/pitch rotation and supersampled primary-ray generation.

The counterpart of ``uob_raytracer_tpu/ops/camera.py``. The rotation matrix
is built from the scene's yaw/pitch tensors, on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from .math3 import normalize3


def rotation_matrix(yaw, pitch):
    """Row-major yaw*pitch rotation, rows r0..r2 as ``skeleton.cpp:149-151``;
    a direction d maps to (r0.d, r1.d, r2.d) (``kernels.cl:398-400``)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    z = torch.zeros_like(cy)
    return torch.stack([
        torch.stack([cy, sp * sy, sy * cp]),
        torch.stack([z, cp, -sp]),
        torch.stack([-sy, cy * sp, cp * cy]),
    ])


def gen_primary_rays(cfg: RenderConfig, yaw, pitch, row0: int = 0,
                     rows: int | None = None):
    """Primary ray directions [rows, W, A, 3] (normalized unless cpu_ref)
    and pixel ids [rows, W] (int64), on the device of ``yaw``.

    GPU path (``kernels.cl:384-407``): the pixel grid is virtually
    supersampled by the AA grid — base = (x*ax - W*ax/2, y*ay - H*ay/2,
    focal), AA ray (dx, dy) adds (dx, dy, 0) — then rotated and normalized.
    CPU-ref mode (``skeleton.cpp:259``): one ray (x - W/2, y - H/2, focal),
    rotated, left unnormalized.

    row0/rows select a row band of the cfg-sized image; ray centering and
    pixel ids stay those of the whole image.
    """
    W, H = cfg.width, cfg.height
    rows = H - row0 if rows is None else rows
    dev, f32 = yaw.device, yaw.dtype   # float32 scenes: float32 rays
    xs = torch.arange(W, dtype=f32, device=dev)[None, :]
    ys = torch.arange(row0, row0 + rows, dtype=f32, device=dev)[:, None]
    focal = float(np.float32(cfg.effective_focal))
    if cfg.cpu_ref:
        bx = xs - float(np.float32(W / 2.0))
        by = ys - float(np.float32(H / 2.0))
        offs = torch.zeros((1, 2), dtype=f32, device=dev)
    else:
        ax, ay = cfg.aa_x, cfg.aa_y
        bx = xs * float(ax) - float(np.float32(W * ax / 2.0))
        by = ys * float(ay) - float(np.float32(H * ay / 2.0))
        offs = torch.tensor([[dx, dy] for dy in range(ay) for dx in range(ax)],
                            dtype=f32, device=dev)
    # [rows, W, A, 3] before rotation
    a = offs.shape[0]
    dirs = torch.stack([
        bx[:, :, None].expand(rows, W, a) + offs[None, None, :, 0],
        by[:, :, None].expand(rows, W, a) + offs[None, None, :, 1],
        torch.full((rows, W, a), focal, dtype=f32, device=dev),
    ], dim=-1)
    R = rotation_matrix(yaw, pitch)
    # Rotate with explicit multiply-adds, summed in order (as the JAX
    # package does; it avoids the matrix unit's reduced-precision path).
    dirs = torch.stack([
        R[i, 0] * dirs[..., 0] + R[i, 1] * dirs[..., 1] + R[i, 2] * dirs[..., 2]
        for i in range(3)
    ], dim=-1)
    if not cfg.cpu_ref:
        dirs = normalize3(dirs)
    gid = (torch.arange(row0, row0 + rows, dtype=torch.int64,
                        device=dev)[:, None] * W
           + torch.arange(W, dtype=torch.int64, device=dev)[None, :])
    return dirs, gid
