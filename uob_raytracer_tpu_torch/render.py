"""Top-level render API: a differentiable frame.

The counterpart of ``uob_raytracer_tpu/render.py``. Two backends render the
same frame:

- ``'cuda'``: the fused path. Forward: the fused CUDA kernel
  (``kernels/render_fwd.py``), one launch per frame that writes both the
  float image and the packed ARGB buffer, and, when a gradient is wanted,
  each ray's decision record. Backward: the path-replay backward kernel
  (``kernels/render_bwd.py``), one launch that turns the image cotangent
  into the packed tables' cotangents, pulled back onto the Scene leaves
  through ``pack_scene``. The two are tied together by a
  ``torch.autograd.Function``. Each is a pair of kernels, whole-table for
  small scenes and streamed for any triangle count; the wrappers choose
  from the scene's size (``kernels/render_fwd.py:use_streamed``);
- ``'torch'``: the plain torch pipeline (``render_flat`` and the AA mean),
  differentiated by plain autograd: the kernels' semantic twin and their
  reference in the tests.

``'auto'`` is the fused path: on a CUDA scene the two kernels, on a CPU
scene their plain versions (the record-keeping plain forward, then autograd
through the replay), as every kernel wrapper does for tensors on the CPU.
``'cuda'`` by name insists on a CUDA scene. ``'torch'`` on a CUDA scene runs
only when asked for by name. Everything runs eagerly on the device of the
scene's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import tracing
from .config import RenderConfig
from .kernels.render_bwd import render_replay_bwd
from .kernels.render_fwd import (  # noqa: F401  (render_flat: public name)
    _band, render_flat, render_fused_plain, render_fused_raw,
    render_fused_res, render_fused_res_plain)
from .ops.quads import detect_shadow_quads, validate_shadow_quads
from .ops.replay import Residuals
from .scene import Scene

_LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


class RenderResult(NamedTuple):
    image: torch.Tensor   # float32 [H, W, 3]; carries the autograd graph
    packed: torch.Tensor  # uint32 [H, W] ARGB8888


def _resolve_backend(backend: str, scene: Scene) -> str:
    """'torch' (the plain pipeline) or 'fused' (the kernels' path, which
    'auto' and 'cuda' both name; 'cuda' insists on a CUDA scene)."""
    if backend == "cuda" and scene.device.type != "cuda":
        raise ValueError(
            f"backend='cuda' needs a scene on a CUDA device; this one is on "
            f"{scene.device} (move it with scene.to('cuda'))")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or "
                         f"'torch'")
    return "torch" if backend == "torch" else "fused"


class _FusedRender(torch.autograd.Function):
    """The fused forward with the path-replay backward: the counterpart of
    ``_render_image_pallas`` / ``render_image_pallas_rows`` and their
    ``custom_vjp`` rules. Inputs after the static arguments are the 15
    Scene leaves; outputs are (image, packed)."""

    @staticmethod
    def forward(ctx, cfg, quads, row0, rows, chunk_rows, record, *leaves):
        scene = Scene(**dict(zip(_LEAVES, leaves)))
        on_cpu = scene.device.type == "cpu"
        if record:
            if on_cpu:
                # the plain version stands in for the kernel's launch
                with tracing.span("rt.fwd.launch"):
                    img, packed, res = render_fused_res_plain(
                        scene, cfg, row0, rows, chunk_rows)
            else:
                img, packed, res = render_fused_res(scene, cfg, row0, rows,
                                                    quads)
            ctx.save_for_backward(*leaves, *res)
            ctx.cfg, ctx.band = cfg, (row0, rows)
        elif on_cpu:
            with tracing.span("rt.fwd.launch"):
                img, packed = render_fused_plain(scene, cfg, row0, rows,
                                                 chunk_rows)
        else:
            img, packed = render_fused_raw(scene, cfg, row0, rows, quads)
        ctx.mark_non_differentiable(packed)
        return img, packed

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_packed):
        # quads affect only the forward occlusion scan; the backward replays
        # with the recorded lit counts frozen
        saved = ctx.saved_tensors
        scene = Scene(**dict(zip(_LEAVES, saved[:len(_LEAVES)])))
        res = Residuals(*saved[len(_LEAVES):])
        bar = render_replay_bwd(scene, ctx.cfg, res, g, *ctx.band)
        return (None,) * 6 + tuple(
            getattr(bar, k) if need else None
            for k, need in zip(_LEAVES, ctx.needs_input_grad[6:]))


def _fused(scene: Scene, cfg: RenderConfig, quads=None, row0=None, rows=None,
           chunk_rows=None):
    row0, rows = _band(cfg, row0, rows)
    leaves = [getattr(scene, k) for k in _LEAVES]
    # the record is kept only when autograd is on and some leaf wants a
    # gradient
    record = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    return _FusedRender.apply(cfg, quads, row0, rows, chunk_rows, record,
                              *leaves)


def render_image(scene: Scene, cfg: RenderConfig,
                 chunk_rows: int | None = None,
                 backend: str = "auto", shadow_quads=None,
                 row0=None, rows: int | None = None) -> torch.Tensor:
    """Differentiable float image [H, W, 3] (or the row band [rows, W, 3]
    when row0/rows are given; ray centering and pixel ids stay global).

    backend: 'cuda' (the fused kernels: forward, and the path-replay
    backward), 'torch' (the plain pipeline under plain autograd), or 'auto'
    (the fused path: the kernels for a CUDA scene, their plain versions for
    a CPU scene). Every cfg mode — including cpu_ref — runs on either
    backend. The gradient reaches every Scene leaf; the material codes get
    zeros.

    shadow_quads: optional static pairing from
    ``ops.quads.detect_shadow_quads`` — merges paired triangles into
    parallelogram rows for the kernel's occlusion scan (~2x fewer shadow
    rows on Cornell). Affects only boundary-epsilon sample rays vs the
    per-triangle scan; the torch backend ignores it."""
    with tracing.span("rt.render"):
        if _resolve_backend(backend, scene) == "torch":
            row0, rows = _band(cfg, row0, rows)
            return render_fused_plain(scene, cfg, row0, rows, chunk_rows)[0]
        return _fused(scene, cfg, shadow_quads, row0, rows, chunk_rows)[0]


def render(scene: Scene, cfg: RenderConfig,
           chunk_rows: int | None = None,
           backend: str = "auto",
           shadow_quads="auto") -> RenderResult:
    """Render a frame. Returns the float image and the packed ARGB8888
    screen buffer, on the scene's device.

    shadow_quads: "auto" detects parallelogram pairs on the scene and uses
    the quad-merged occlusion scan (on a CUDA scene's fused path); None
    disables; or pass a pairing from ``ops.quads.detect_shadow_quads``. An explicitly
    passed pairing is re-validated against the scene's current vertices
    (``ops.quads.validate_shadow_quads``): a stale pairing on moved
    geometry raises instead of silently corrupting shadows. Detection and
    validation read the vertices to the host and run in Python on every
    call; a caller that renders one scene many times detects once and
    passes the pairing to ``render_image``."""
    with tracing.span("rt.render"):
        backend = _resolve_backend(backend, scene)
        if shadow_quads == "auto":
            # only the kernel reads a pairing; its plain versions scan
            # triangles
            if (backend == "fused" and scene.device.type == "cuda"
                    and not cfg.cpu_ref):
                with tracing.span("rt.render.quads"):
                    shadow_quads = detect_shadow_quads(scene)
            else:
                shadow_quads = None
        elif shadow_quads is not None:
            with tracing.span("rt.render.quads"):
                validate_shadow_quads(scene, shadow_quads)
        if backend == "torch":
            img, packed = render_fused_plain(scene, cfg,
                                             chunk_rows=chunk_rows)
        else:
            # one launch writes both outputs; the packed buffer equals
            # pack_argb of the image (chip_smoke.py checks it on the card)
            img, packed = _fused(scene, cfg, shadow_quads,
                                 chunk_rows=chunk_rows)
        return RenderResult(image=img, packed=packed)


def render_packed(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    return render(scene, cfg).packed
