"""Differentiable rendering as a training loop: fits scene parameters
(vertices, materials, light, camera) to a target image by gradient descent
through the renderer.

The counterpart of ``uob_raytracer_tpu/parallel/train.py``. Every entry
point takes a ``Mesh`` (``parallel/mesh.py``) and renders through
``render_image_sharded``: pixel rows sharded over the ranks of 'dp',
triangles over those of 'tp', the scene replicated, and the leaves'
gradients summed over the ranks by one all-reduce
(``parallel/collectives.py``), so that every rank takes the same step.
``mesh=None`` is the one device the scene lives on. There, and on every
rank of a dp mesh, a step on a CUDA scene is one launch of a fused forward
kernel (with its decision record) and one of a path-replay backward
kernel, followed on a large scene by its segmented sum.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import tracing
from ..config import RenderConfig
from ..scene import Scene
from .render import render_image_sharded

# Scene leaves that may receive gradient updates in the demo optimizer.
# (Vertices, materials, light and camera — the BASELINE config-5 parameter
# set. Pass a subset to train_step for well-conditioned fits: a single SGD
# learning rate across parameter types is rarely appropriate.)
TRAINABLE = ("tri_v0", "tri_v1", "tri_v2", "tri_rgb", "light_pos",
             "light_color", "camera_pos", "yaw", "pitch")


def image_loss(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               mesh=None, backend: str = "auto",
               shadow_quads=None) -> torch.Tensor:
    """MSE against a target image through the sharded renderer.

    shadow_quads: static quad pairing for the kernel's occlusion scan.
    Training paths that move vertices must NOT pass a pairing detected on
    the pre-update geometry (``render_image_sharded`` validates a pairing
    against the scene's vertices and raises on a stale one) —
    light/material-only fits may pass one safely. ``train_step`` and
    ``fit`` pass none."""
    img = render_image_sharded(scene, cfg, mesh, backend=backend,
                               shadow_quads=shadow_quads)
    return torch.mean(torch.square(img - target))


class TrainOut(NamedTuple):
    scene: Scene
    loss: torch.Tensor


def _with_params(scene: Scene, names) -> tuple[Scene, dict]:
    """The scene with the named leaves replaced by fresh leaf tensors that
    require a gradient, and those tensors by name."""
    unknown = [k for k in names if not hasattr(scene, k)]
    if unknown:
        raise ValueError(f"not Scene leaves: {unknown}")
    params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in names}
    return dataclasses.replace(scene, **params), params


def train_step(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               mesh=None, lr: float = 1e-2,
               trainable: tuple[str, ...] = TRAINABLE,
               backend: str = "auto") -> TrainOut:
    """One SGD step on the selected scene leaves. On a mesh every rank
    calls it with the same arguments and returns the same scene."""
    with tracing.span("rt.train_step", step=True):
        live, params = _with_params(scene, trainable)
        loss = image_loss(live, target, cfg, mesh, backend)
        grads = torch.autograd.grad(loss, list(params.values()))
        new = {k: (p - lr * g).detach()
               for (k, p), g in zip(params.items(), grads)}
        return TrainOut(scene=dataclasses.replace(scene, **new),
                        loss=loss.detach())


# The BASELINE config-5 parameter set with per-leaf Adam learning rates:
# a single global SGD rate cannot fit vertices (grads ~1e-3), materials
# (~1e-1) and light intensity (~1e-3, scale 16) at once.
DEFAULT_LRS = {
    "light_pos": 2e-2,
    "tri_rgb": 2e-2,
    "tri_v0": 5e-3,
    "tri_v1": 5e-3,
    "tri_v2": 5e-3,
}


def fit(scene: Scene, target: torch.Tensor, cfg: RenderConfig, mesh=None,
        steps: int = 60, lrs: dict[str, float] | None = None,
        backend: str = "auto", log_every: int = 0, eps: float = 1e-3):
    """Multi-parameter scene recovery: per-leaf Adam on the selected Scene
    leaves through the sharded differentiable renderer (gradients summed
    over the mesh's ranks). Returns (fitted scene, loss history).

    ``lrs`` maps leaf name -> Adam learning rate; leaves not named are
    frozen. The default set is the BASELINE config-5 parameters (vertices +
    materials + light). ``eps`` is deliberately large (1e-3, not Adam's
    1e-8): leaves with near-zero gradients (e.g. vertices of triangles the
    loss barely sees) would otherwise get full-size normalized steps in
    noise directions and walk the geometry apart."""
    lrs = dict(DEFAULT_LRS if lrs is None else lrs)
    live, params = _with_params(scene, lrs)
    opt = torch.optim.Adam(
        [{"params": [params[k]], "lr": lr} for k, lr in lrs.items()], eps=eps)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = image_loss(live, target, cfg, mesh, backend)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"fit step {i:3d}  loss {losses[-1]:.6f}")
    fitted = {k: p.detach() for k, p in params.items()}
    return dataclasses.replace(scene, **fitted), losses
