"""Counter-based RNG with exact parity to the reference's xorshift stream.

The reference seeds a 3-lane xorshift from the pixel id — including a
float-multiply-then-truncate quirk — and advances it once per shadow sample
(``Source/kernels.cl:42-52,319,331``). Because the seed depends only on the
pixel id, the noise is deterministic, and this module reproduces the
stream of ``uob_raytracer_tpu/ops/rng.py`` bit for bit. No
``torch.Generator`` is involved.

States are int64 tensors holding uint32 values: torch has no shifts on
``torch.uint32``, so each left shift is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
# 4294967295 rounds to 2^32 in float32, as in the OpenCL source.
_UINT_MAX_F = float(np.float32(4294967295.0))


def xorshift(state):
    """3-lane (or any-shape) uint32 xorshift: ^=<<13, ^=>>17, ^=<<5."""
    state = state ^ ((state << 13) & _MASK32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _MASK32)
    return state


def crush(state, rng: float):
    """uint32 state -> float32 in (-range/2, range/2) (``kernels.cl:49-52``).
    The int64 -> float32 conversion rounds to nearest, as the uint32 ->
    float32 conversion of the reference does, states >= 2^31 included."""
    r = float(np.float32(rng))
    return r * state.to(torch.float32) / _UINT_MAX_F - r / 2.0


def shadow_seed(gid):
    """Initial RNG state for pixel id ``gid``: one xorshift step applied to
    ``(gid, (uint)(gid*91.0f), (uint)(gid*19.0f))`` (``kernels.cl:319``).
    The products are rounded to float32 and then truncated. ``gid`` is an
    integer tensor; returns int64 [..., 3] holding uint32 values."""
    g = gid.to(torch.int64) & _MASK32
    gf = g.to(torch.float32)
    seed = torch.stack([
        g,
        (gf * 91.0).to(torch.int64),
        (gf * 19.0).to(torch.int64),
    ], dim=-1)
    return xorshift(seed)
