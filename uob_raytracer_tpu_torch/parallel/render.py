"""Sharded rendering: pixel rows over 'dp', optionally triangles over 'tp'.

The counterpart of ``uob_raytracer_tpu/parallel/render.py``. One process is
one mesh position (``parallel/mesh.py``): it renders the row band of its
``dp`` index, against the triangle slice of its ``tp`` index when the
triangles are sharded, and the collectives of ``parallel/collectives.py``
put the pieces together, so that every rank returns the whole image. The
scene is replicated: every rank holds all of it, on its own device, and
slices its shard.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tracing
from ..config import RenderConfig
from ..kernels.render_fwd import render_flat
from ..ops.quads import detect_shadow_quads, validate_shadow_quads
from ..render import _LEAVES, _resolve_backend, render_image
from ..scene import Scene
from .collectives import gather_rows, replicate
from .mesh import Mesh

_TRI_LEAVES = ("tri_v0", "tri_v1", "tri_v2", "tri_rgb", "tri_mat")


def _check_mesh(mesh, scene: Scene) -> Mesh | None:
    """None for no mesh or a 1x1 mesh (the same thing), else the mesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh from make_mesh() or "
                        f"None, not {type(mesh).__name__}")
    if mesh.device.type != scene.device.type:
        raise ValueError(f"the mesh computes on {mesh.device} but the scene "
                         f"is on {scene.device} (move it with scene.to(...))")
    return None if mesh.world == 1 else mesh


def render_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh | None,
                         chunk_rows: int | None = None,
                         backend: str = "auto",
                         shadow_quads=None) -> torch.Tensor:
    """Render the float image [H, W, 3] sharded over ``mesh``; every rank
    returns the whole image.

    Rows are split over 'dp'; if the mesh's 'tp' axis is larger than 1 each
    rank scans its slice of the triangles (pad first with
    ``mesh.pad_triangles``) and nearest-hit/occlusion results are combined
    over the tp process group. Differentiable: after a backward pass every
    rank holds the whole gradient of its loss on the scene's leaves (the
    scheme is set out in ``parallel/collectives.py``).

    backend 'auto' / 'cuda' with tp == 1 runs the fused kernels per rank,
    each rank rendering its row band (path-replay backward included). With
    tp > 1 it runs the per-shard wavefront pipeline with the triangle scans
    in the partial-scan kernels (``kernels/partial.py``), also
    differentiable: the nearest-hit wrapper carries a path-replay backward.
    backend 'torch' runs the plain pipeline per rank either way. As
    everywhere, tensors on the CPU take the kernels' plain versions.

    shadow_quads: static quad pairing for the fused kernel's occlusion
    scan, as in ``render.render_image`` ("auto" detects on the scene); the
    tp pipeline scans triangles and ignores it.

    ``mesh=None`` and a 1x1 mesh are ``render.render_image``."""
    with tracing.span("rt.render"):
        fused = _resolve_backend(backend, scene) == "fused"
        if shadow_quads == "auto" and not fused:
            shadow_quads = None
        if shadow_quads is not None:
            with tracing.span("rt.render.quads"):
                if shadow_quads == "auto":
                    shadow_quads = detect_shadow_quads(scene)
                validate_shadow_quads(scene, shadow_quads)
        mesh = _check_mesh(mesh, scene)
        if mesh is None:
            return render_image(scene, cfg, chunk_rows, backend, shadow_quads)
        if cfg.height % mesh.dp:
            raise ValueError(f"height {cfg.height} not divisible by "
                             f"dp={mesh.dp}")
        if mesh.tp > 1 and scene.num_triangles % mesh.tp:
            raise ValueError("triangle count not divisible by tp; use "
                             "pad_triangles")
        rows = cfg.height // mesh.dp
        row0 = mesh.dp_index * rows
        scene = Scene(**dict(zip(_LEAVES, replicate(
            [getattr(scene, k) for k in _LEAVES], mesh.world))))
        if mesh.tp == 1:
            band = render_image(scene, cfg, chunk_rows, backend,
                                shadow_quads, row0, rows)
        else:
            t_local = scene.num_triangles // mesh.tp
            lo = mesh.tp_index * t_local
            shard = dataclasses.replace(scene, **{
                k: getattr(scene, k)[lo:lo + t_local] for k in _TRI_LEAVES})
            colors = render_flat(shard, cfg, chunk_rows, row0, rows,
                                 tri_axis=mesh.tp_group,
                                 tri_pass="kernel" if fused else "torch",
                                 tri_offset=lo)
            band = colors.sum(dim=2) / float(colors.shape[2])
        return gather_rows(band, mesh.dp_group, mesh.dp_index)
