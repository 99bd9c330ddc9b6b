"""Frozen scene recipes: the inputs that the benchmark makes and hands to
both the program and the reference. A configuration's ``scene`` entry,
``{"recipe": name, ...arguments}``, names a module of this package whose
``build(seed, **arguments)`` returns the scene's 15 leaves as float32 numpy
arrays keyed by ``LEAVES``; a new recipe is a new module.
"""
from __future__ import annotations

import importlib

LEAVES = ("tri_v0", "tri_v1", "tri_v2", "tri_rgb", "tri_mat", "sph_center",
          "sph_r2", "sph_rgb", "sph_mat", "light_pos", "light_color",
          "indirect_light", "camera_pos", "yaw", "pitch")


def build(recipe: dict, seed: int) -> dict:
    """The leaves of a configuration's ``scene`` entry."""
    args = {k: v for k, v in recipe.items() if k != "recipe"}
    mod = importlib.import_module(f"{__name__}.{recipe['recipe']}")
    leaves = mod.build(seed, **args)
    missing = set(LEAVES) - set(leaves)
    if missing:
        raise ValueError(f"recipe {recipe['recipe']!r} lacks "
                         f"{sorted(missing)}")
    return leaves
