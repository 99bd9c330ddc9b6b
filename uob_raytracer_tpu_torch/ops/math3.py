"""3-vector helpers for the torch render path.

Vectors carry a trailing xyz axis of size 3. Every sum of products is
written out term by term, one torch op per multiply and per add, so each
intermediate rounds to float32 in the same order as the JAX package's
(``uob_raytracer_tpu/ops/math3.py``) with its FMA contraction off: the
determinant uses the exact cofactor expansion of the reference
(``Source/kernels.cl:31-35``).
"""
from __future__ import annotations

import torch


def det3(a, b, c):
    """3x3 determinant of rows (a, b, c); last axis is xyz. Cofactor
    expansion exactly as ``kernels.cl:31-35``."""
    return (
        a[..., 0] * (b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1])
        - a[..., 1] * (b[..., 0] * c[..., 2] - b[..., 2] * c[..., 0])
        + a[..., 2] * (b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0])
    )


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """a x b over the last axis, one op per term (``jnp.cross``'s order)."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize3(v, active=None):
    """Unit vector along v. If ``active`` is given, inactive lanes are
    replaced with a unit x vector *before* the norm, so no NaN or inf
    enters the result."""
    if active is not None:
        unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
        v = torch.where(active[..., None], v, unit_x)
    return v / torch.sqrt(dot3(v, v))[..., None]
