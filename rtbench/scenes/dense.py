"""The Cornell box plus small random diffuse triangles: a frozen copy of the
port's ``debug.dense_scene`` (the numpy recipe of the JAX package's
``bench.py:dense_scene``).
"""
from __future__ import annotations

import numpy as np

from . import cornell


def build(seed: int, n_tri: int) -> dict:
    """The Cornell box plus small random diffuse triangles inside it,
    ``n_tri`` triangles in all, drawn from ``seed`` (reduced modulo 2^32,
    the range numpy's ``RandomState`` takes): the JAX package's
    ``bench.py:dense_scene`` recipe."""
    leaves = cornell.build(seed)
    rng = np.random.RandomState(seed % 2**32)
    extra = n_tri - leaves["tri_v0"].shape[0]
    if extra <= 0:
        return leaves
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    for i, k in enumerate(("tri_v0", "tri_v1", "tri_v2")):
        leaves[k] = np.concatenate([leaves[k], verts[:, i]])
    leaves["tri_rgb"] = np.concatenate(
        [leaves["tri_rgb"], np.full((extra, 3), 0.6, np.float32)])
    leaves["tri_mat"] = np.concatenate(
        [leaves["tri_mat"], np.ones((extra,), np.float32)])
    return leaves
