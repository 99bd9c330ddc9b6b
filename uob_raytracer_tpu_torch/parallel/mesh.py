"""Process meshes for the ray tracer.

The counterpart of ``uob_raytracer_tpu/parallel/mesh.py``. The JAX package
describes scaling as a device ``Mesh`` inside one program; here one process
is one mesh position, and the mesh a process holds says where it stands:

* ``dp`` (data parallel): pixel rows sharded across ranks; the scene is
  replicated, mirroring the reference's per-work-group local-memory copy of
  the whole scene (``kernels.cl:374-376``).
* ``tp`` (tensor parallel): the triangle axis sharded across ranks for
  scenes too large to replicate; nearest-hit results are combined with
  min/sum collectives over the tp process group (see ops/intersect.py).

Rank ``r`` of the ``dp * tp`` processes stands at ``(r // tp, r % tp)``, the
row-major layout of the JAX package's device array. Without an initialised
process group the only mesh is 1x1, which is the same as no mesh.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from ..scene import Scene


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (dp, tp) mesh of processes. A process
    group is None where its axis has size 1."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    device: torch.device
    dp_group: Any = None   # the ranks that share this tp_index
    tp_group: Any = None   # the ranks that share this dp_index

    @property
    def world(self) -> int:
        return self.dp * self.tp


def parse_device_spec(spec: str, n_devices: int) -> list[int]:
    """The indices a ``--devices`` / ``RAYTPU_DEVICES`` spec names, checked
    against ``n_devices``: out-of-range and repeated indices fail fast, as
    the reference's device-index validation does."""
    idx = [int(s) for s in spec.split(",") if s.strip() != ""]
    bad = [i for i in idx if not 0 <= i < n_devices]
    if bad:
        raise ValueError(f"device indices {bad} out of range "
                         f"(have {n_devices} devices)")
    if len(set(idx)) != len(idx):
        dup = sorted({i for i in idx if idx.count(i) > 1})
        raise ValueError(f"duplicate device indices {dup} in spec {spec!r}")
    return idx


def select_devices(spec: str | None = None,
                   verbose: bool = False) -> list[torch.device]:
    """Device selection — the ``OCL_DEVICE`` analogue
    (``Source/skeleton.cpp:549-558``): ``spec`` (or the ``RAYTPU_DEVICES``
    env var) is a comma-separated list of indices into the CUDA devices
    torch sees; unset selects all. ``verbose`` prints the enumerated device
    list like the reference's ``selectOpenCLDevice``
    (``skeleton.cpp:541-547``)."""
    n = torch.cuda.device_count()
    if verbose:
        for i in range(n):
            print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    spec = spec if spec is not None else os.environ.get("RAYTPU_DEVICES")
    idx = parse_device_spec(spec, n) if spec else range(n)
    return [torch.device("cuda", i) for i in idx]


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """This process's place in a ('dp', 'tp') mesh over all processes of
    the initialised process group (one process without one). Defaults:
    every process on dp. ``devices`` (default: ``select_devices()``, which
    honors the RAYTPU_DEVICES env var) are shared out in turn: rank r
    computes on ``devices[r % len(devices)]``; pass
    ``[torch.device("cpu")]`` to run on the CPU. Every process must call
    this at the same point: it creates the axes' process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = world // tp
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} processes, "
                         f"have {world}")
    if devices is None:
        devices = select_devices()
    if not devices:
        raise RuntimeError("make_mesh: no CUDA device; pass "
                           "devices=[torch.device('cpu')] to run on the CPU")
    dp_index, tp_index = divmod(rank, tp)
    dp_group = tp_group = None
    # every process creates every group, in the same order
    if dp > 1:
        for j in range(tp):
            g = dist.new_group([i * tp + j for i in range(dp)])
            if j == tp_index:
                dp_group = g
    if tp > 1:
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if i == dp_index:
                tp_group = g
    return Mesh(dp=dp, tp=tp, dp_index=dp_index, tp_index=tp_index,
                device=torch.device(devices[rank % len(devices)]),
                dp_group=dp_group, tp_group=tp_group)


def pad_triangles(scene: Scene, multiple: int) -> Scene:
    """Pad the triangle axis to a multiple (for even tp sharding) with
    degenerate triangles: zero-area (all vertices coincident) so every
    intersection test rejects them (detA == 0), diffuse material so the
    glass-skip shadow rule is unaffected."""
    pad = (-scene.num_triangles) % multiple
    if pad == 0:
        return scene
    zpad3 = scene.tri_v0.new_zeros((pad, 3))
    return dataclasses.replace(
        scene,
        tri_v0=torch.cat([scene.tri_v0, zpad3]),
        tri_v1=torch.cat([scene.tri_v1, zpad3]),
        tri_v2=torch.cat([scene.tri_v2, zpad3]),
        tri_rgb=torch.cat([scene.tri_rgb, zpad3]),
        tri_mat=torch.cat([scene.tri_mat, scene.tri_mat.new_ones((pad,))]),
    )
