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

On one CUDA device (``mesh=None`` or 1x1) with the fused backend,
``train_step`` replays its step as one CUDA graph: the host then spends
under a millisecond a step where the eager step's ~330 operations, driven
by Python and the autograd engine, took 6-12 ms and set the pace of the
card. The first call with a key (``_key``: the config, the learning
rate, the trainable leaves, the backend, and the shape, dtype and device
of every leaf and of the target) runs eagerly, which warms up what the
step initialises lazily; the second captures the whole step body
(``_step``: the forward kernel, the loss, ``torch.autograd.grad`` with the
backward on the autograd engine's device thread, the SGD update) on a side
stream with its own memory pool and replays it; later calls replay. Each
call copies the scene's 15 leaves and the target into the graph's inputs,
and the updated leaves and the loss out into fresh tensors, so any scene
of the key's shapes gives the eager step's answer, bit for bit (the same
kernels on the same inputs in the same order), and a returned scene never
changes afterwards. One graph is kept: a new key drops the old one and its
pool. A capture that fails raises. Meshes of several ranks (whose
collectives run eagerly), CPU scenes and ``backend='torch'`` run eagerly,
as does ``fit``. The counters ``train.eager``, ``train.graph.capture`` and
``train.graph.replay`` (``tracing.count``) say which a step took. The
capture runs inside ``tracing.held()``, so a replay, which runs no Python,
counts what the captured step counted (``tracing.repeat``): its kernels'
launches on the launch counters, and while recording its counters
(``bwd.bands``) and its gauges (``bwd.chain_pixels``, which names the
graph's own tensor of the chain launch's offsets: a replay writes it anew,
and only ``tracing.drain()`` reads it).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import tracing
from ..config import RenderConfig
from ..render import _LEAVES, _resolve_backend
from ..scene import Scene
from .render import _check_mesh, render_image_sharded

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


def _step(scene: Scene, target: torch.Tensor, cfg: RenderConfig, mesh,
          lr: float, trainable, backend: str) -> TrainOut:
    """The body of one SGD step, eager or under capture."""
    live, params = _with_params(scene, trainable)
    loss = image_loss(live, target, cfg, mesh, backend)
    grads = torch.autograd.grad(loss, list(params.values()))
    new = {k: (p - lr * g).detach()
           for (k, p), g in zip(params.items(), grads)}
    return TrainOut(scene=dataclasses.replace(scene, **new),
                    loss=loss.detach())


def graphs(device: torch.device, mesh, fused: bool) -> bool:
    """Whether ``train_step`` replays a CUDA graph for a scene on
    ``device``: a CUDA device, no mesh (or a 1x1 one), the fused path."""
    return (device.type == "cuda" and (mesh is None or mesh.world == 1)
            and fused)


def _key(scene: Scene, target: torch.Tensor, cfg: RenderConfig, lr: float,
         trainable, backend: str) -> tuple:
    """What a captured step is valid for."""
    return (cfg, lr, tuple(trainable), backend,
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in [getattr(scene, k) for k in _LEAVES] + [target]))


class _Graph:
    """One key's step: after its eager first call (``graph`` None), the
    captured step, its static inputs (the 15 leaves and the target), its
    outputs (the updated leaves and the loss, flat) and what it counted
    (``tracing.held``)."""

    def __init__(self, key: tuple):
        self.key = key
        self.graph = None

    def capture(self, scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                lr: float, trainable, backend: str) -> None:
        self.inputs = [getattr(scene, k).clone() for k in _LEAVES]
        self.inputs.append(target.clone())
        static = Scene(**dict(zip(_LEAVES, self.inputs)))
        graph = torch.cuda.CUDAGraph()
        with tracing.held() as self.counted, torch.cuda.graph(graph):
            out = _step(static, self.inputs[-1], cfg, None, lr, trainable,
                        backend)
            parts = [getattr(out.scene, k) for k in trainable] + [out.loss]
            self.flat = torch.cat([t.reshape(-1) for t in parts])
        self.names = tuple(trainable)
        self.shapes = [t.shape for t in parts]
        self.sizes = [t.numel() for t in parts]
        self.graph = graph

    def replay(self, scene: Scene, target: torch.Tensor) -> TrainOut:
        torch._foreach_copy_(self.inputs,
                             [getattr(scene, k) for k in _LEAVES] + [target])
        self.graph.replay()
        parts = [t.view(shape) for t, shape in zip(
            self.flat.clone().split(self.sizes), self.shapes)]
        return TrainOut(scene=dataclasses.replace(
            scene, **dict(zip(self.names, parts))), loss=parts[-1])


_graph: _Graph | None = None     # the one key whose step is kept


def train_step(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               mesh=None, lr: float = 1e-2,
               trainable: tuple[str, ...] = TRAINABLE,
               backend: str = "auto") -> TrainOut:
    """One SGD step on the selected scene leaves. On a mesh every rank
    calls it with the same arguments and returns the same scene. On one
    CUDA device with the fused backend the step is a CUDA graph from the
    second call with the same key on (see the module's docstring)."""
    global _graph
    with tracing.span("rt.train_step", step=True):
        if not graphs(scene.device, _check_mesh(mesh, scene),
                      _resolve_backend(backend, scene) == "fused"):
            out = _step(scene, target, cfg, mesh, lr, trainable, backend)
            tracing.count("train.eager")
            return out
        key = _key(scene, target, cfg, lr, trainable, backend)
        if _graph is None or _graph.key != key:
            _graph = None           # frees the old graph's pool first
            out = _step(scene, target, cfg, None, lr, trainable, backend)
            _graph = _Graph(key)
            tracing.count("train.eager")
            return out
        if _graph.graph is None:        # raises where the capture fails
            _graph.capture(scene, target, cfg, lr, trainable, backend)
            tracing.count("train.graph.capture")
        else:
            tracing.repeat(_graph.counted)
            tracing.count("train.graph.replay")
        return _graph.replay(scene, target)


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
