"""Top-level render API (forward frame).

The counterpart of ``uob_raytracer_tpu/render.py``. Two backends render the
same frame:

- ``'cuda'``: the fused CUDA kernel (``kernels/render_fwd.py``), one launch
  per frame that writes both the float image and the packed ARGB buffer;
- ``'torch'``: the kernel's plain torch version (``render_flat`` and the AA
  mean, ``kernels/render_fwd.py:render_fused_plain``), its semantic twin
  and its reference in the tests.

``'auto'`` picks ``'cuda'`` for a scene on a CUDA device and ``'torch'`` for
a scene on the CPU. ``'torch'`` on a CUDA scene runs only when asked for by
name. Everything runs eagerly on the device of the scene's tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RenderConfig
from .kernels.render_fwd import (  # noqa: F401  (render_flat: public name)
    render_flat, render_fused_plain, render_fused_raw)
from .ops.quads import detect_shadow_quads, validate_shadow_quads
from .scene import Scene


class RenderResult(NamedTuple):
    image: torch.Tensor   # float32 [H, W, 3]
    packed: torch.Tensor  # uint32 [H, W] ARGB8888


def _resolve_backend(backend: str, scene: Scene) -> str:
    on_cuda = scene.device.type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "torch"
    if backend == "cuda" and not on_cuda:
        raise ValueError(
            f"backend='cuda' needs a scene on a CUDA device; this one is on "
            f"{scene.device} (move it with scene.to('cuda'))")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or "
                         f"'torch'")
    return backend


def render_image(scene: Scene, cfg: RenderConfig,
                 chunk_rows: int | None = None,
                 backend: str = "auto", shadow_quads=None) -> torch.Tensor:
    """Float image [H, W, 3].

    backend: 'cuda' (the fused kernel), 'torch' (the plain pipeline), or
    'auto' ('cuda' for a CUDA scene, 'torch' for a CPU scene). Every cfg
    mode — including cpu_ref — runs on either backend.

    shadow_quads: optional static pairing from
    ``ops.quads.detect_shadow_quads`` — merges paired triangles into
    parallelogram rows for the kernel's occlusion scan (~2x fewer shadow
    rows on Cornell). Affects only boundary-epsilon sample rays vs the
    per-triangle scan; the torch backend ignores it."""
    backend = _resolve_backend(backend, scene)
    if backend == "cuda":
        return render_fused_raw(scene, cfg, quads=shadow_quads)[0]
    return render_fused_plain(scene, cfg, chunk_rows=chunk_rows)[0]


def render(scene: Scene, cfg: RenderConfig,
           chunk_rows: int | None = None,
           backend: str = "auto",
           shadow_quads="auto") -> RenderResult:
    """Render a frame. Returns the float image and the packed ARGB8888
    screen buffer, on the scene's device.

    shadow_quads: "auto" detects parallelogram pairs on the scene and uses
    the quad-merged occlusion scan (cuda backend only); None disables; or
    pass a pairing from ``ops.quads.detect_shadow_quads``. An explicitly
    passed pairing is re-validated against the scene's current vertices
    (``ops.quads.validate_shadow_quads``): a stale pairing on moved
    geometry raises instead of silently corrupting shadows. Detection and
    validation read the vertices to the host and run in Python on every
    call; a caller that renders one scene many times detects once and
    passes the pairing to ``render_image``."""
    backend = _resolve_backend(backend, scene)
    if shadow_quads == "auto":
        if backend == "cuda" and not cfg.cpu_ref:
            shadow_quads = detect_shadow_quads(scene)
        else:
            shadow_quads = None
    elif shadow_quads is not None:
        validate_shadow_quads(scene, shadow_quads)
    if backend == "cuda":
        # one launch writes both outputs; the packed buffer equals
        # pack_argb of the image (chip_smoke.py checks it on the card)
        img, packed = render_fused_raw(scene, cfg, quads=shadow_quads)
    else:
        img, packed = render_fused_plain(scene, cfg, chunk_rows=chunk_rows)
    return RenderResult(image=img, packed=packed)


def render_packed(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    return render(scene, cfg).packed
