"""What one spawned rank of the port's sharded tests runs
(``tests/test_torch_parallel.py``). It imports torch and the port only, so a
rank starts in the time torch takes to import.

A job is a directory: ``job.json`` says what to run, ``scene.npz`` holds the
scene's leaves and ``target.npy`` the target image of the training part (the
gradients are those of the loss against a black target, as in the JAX
package's tests); rank ``r`` writes what it computed to ``out<r>.npz`` and
the test compares, in its own process, with the JAX package's results.
"""
import dataclasses
import json
import os

import numpy as np
import torch

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import parallel as tpar
from uob_raytracer_tpu_torch import tracing
from uob_raytracer_tpu_torch.scene import load_scene, scene_to_numpy

GRAD_LEAVES = ("light_pos", "light_color", "tri_v0", "tri_v1", "tri_v2",
               "tri_rgb", "camera_pos", "yaw", "pitch")
CPU = [torch.device("cpu")]


def loss_grads(scene, target, cfg, mesh, backend):
    """(loss, {leaf: gradient}) of ``image_loss`` on the nine leaves."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in GRAD_LEAVES}
    loss = tpar.image_loss(dataclasses.replace(scene, **leaves), target, cfg,
                           mesh, backend)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(GRAD_LEAVES, grads))


def run_job(rank: int, workdir: str) -> None:
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    mesh = tpar.make_mesh(dp=job["dp"], tp=job["tp"], devices=CPU)
    assert (mesh.dp_index, mesh.tp_index) == divmod(rank, job["tp"])
    scene = load_scene(os.path.join(workdir, "scene.npz"), "cpu")
    cfg = trt.RenderConfig(**job["cfg"])
    black = torch.zeros((cfg.height, cfg.width, 3))
    out = {}
    for backend in job.get("backends", ()):
        with torch.no_grad():
            img = tpar.render_image_sharded(scene, cfg, mesh, backend=backend)
        out[f"image_{backend}"] = img.numpy()
        loss, grads = loss_grads(scene, black, cfg, mesh, backend)
        out[f"loss_{backend}"] = np.float32(loss)
        for k, g in grads.items():
            out[f"grad_{backend}_{k}"] = g.numpy()
    if "train" in job or "fit" in job:
        target = torch.from_numpy(np.load(os.path.join(workdir,
                                                       "target.npy")))
    if "train" in job:
        tr = job["train"]
        live, losses = scene, []
        tracing.enable()
        for _ in range(tr["steps"]):
            live, loss = tpar.train_step(live, target, cfg, mesh, lr=tr["lr"],
                                         trainable=tuple(tr["trainable"]))
            losses.append(loss.item())
        counts = tracing.drain()["counts"]
        tracing.disable()
        out["train_losses"] = np.float32(losses)
        # how the steps ran: (eager, captured, replayed)
        out["train_kinds"] = np.int64([counts.get(f"train.{k}", 0) for k in
                                       ("eager", "graph.capture",
                                        "graph.replay")])
        for k, v in scene_to_numpy(live).items():
            out[f"trained_{k}"] = v
    if "fit" in job:
        fitted, losses = tpar.fit(scene, target, cfg, mesh,
                                  steps=job["fit"]["steps"],
                                  lrs=job["fit"]["lrs"])
        out["fit_losses"] = np.float32(losses)
        out["fit_light_pos"] = fitted.light_pos.numpy()
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 dies; the others wait on a collective that never completes."""
    if rank == 1:
        raise SystemExit(3)
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1))


def collectives_job(rank: int, workdir: str) -> None:
    """The collectives alone on a 2x2 mesh: values and transposes."""
    from uob_raytracer_tpu_torch.parallel import collectives as col
    mesh = tpar.make_mesh(dp=2, tp=2, devices=CPU)
    x = torch.tensor([float(rank), -float(rank)])
    # tp groups are {0,1} and {2,3}; dp groups {0,2} and {1,3}
    lo = 2 * mesh.dp_index
    assert col.pmin(x, mesh.tp_group).tolist() == [lo, -(lo + 1.0)]
    assert col.pmax(x, mesh.tp_group).tolist() == [lo + 1.0, -float(lo)]
    assert torch.equal(x, torch.tensor([float(rank), -float(rank)]))
    v = x.clone().requires_grad_(True)
    y = col.psum(v * (rank + 1.0), mesh.tp_group)
    assert y.tolist() == [sum(r * (r + 1.0) for r in (lo, lo + 1)),
                          -sum(r * (r + 1.0) for r in (lo, lo + 1))]
    (g,) = torch.autograd.grad(y.sum(), v)
    # each of the 2 ranks seeds 1: the cotangents sum to 2
    assert g.tolist() == [2.0 * (rank + 1.0)] * 2
    band = torch.full((1, 2), float(rank), requires_grad=True)
    full = col.gather_rows(band, mesh.dp_group, mesh.dp_index)
    assert full[:, 0].tolist() == [float(mesh.tp_index),
                                   float(2 + mesh.tp_index)]
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    (gb,) = torch.autograd.grad((full * w).sum(), band)
    assert gb.tolist() == [(2 * w[mesh.dp_index]).tolist()]
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor(3.0, requires_grad=True)
    ra, rb, _ = col.replicate([a, b, torch.tensor(0.0)], mesh.world)
    ga, gb = torch.autograd.grad((ra * (rank + 1.0)).sum() + rb, [a, b])
    # (1 + 2 + 3 + 4) / 4 and 4 / 4
    assert ga.tolist() == [2.5, 2.5] and gb.item() == 1.0
    open(os.path.join(workdir, f"ok{rank}"), "w").close()
