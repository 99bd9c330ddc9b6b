"""Inverse rendering by SGD: the closed loop of ``parallel.train_step``.

Set-up draws a perturbation of the configuration's scene from the seed
(the mix's ``perturb``: the light moved, the triangles' colours scaled),
renders the target from it with the plain reference, and drives
``train_step`` from the unperturbed scene through its first steps: the
first ``first_steps`` are the ones the check follows, the rest warm up.
The window calls ``train_step`` back to back on the scene the previous
call returned, with no wait on the card inside; it ends with a synchronise,
so every counted step has finished.

The check follows the first steps with the reference (SGD on its own
autograd gradient, band by band) and compares: the first step's loss; the
norm of each leaf's first gradient as the update got it, ``(p0 - p1) /
lr``, by the worst leaf; and the norm of each leaf's change after the first
steps, by the median leaf, leaving out leaves whose reference gradient is
under a thousandth of the median leaf's. A leaf's gap is measured against
the larger of its reference norm and the median leaf's. The later steps'
losses and the worst leaf's change are not compared: once the scene has
moved, a ray that passes a triangle's edge on one side and not on the
other changes a pixel whole, so they swing from seed to seed with the
visibility of single pixels (PERF.md).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from ..reference import render as ref

STILL = 1e-3   # a leaf whose gradient is under this share of the median's


@dataclasses.dataclass
class State:
    scene: object          # the program's Scene
    target: torch.Tensor
    cfg: object            # the program's RenderConfig
    lr: float
    names: tuple
    first: dict            # the first steps: losses, p0, p1, p_last


def perturb(leaves: dict, spec: dict, gen: torch.Generator) -> dict:
    """The target's scene: the light moved by ``light_pos_sigma`` times a
    normal draw per axis, each triangle colour channel scaled by 1 plus a
    uniform draw in +-``rgb_rel``, clamped to [0, 1]."""
    dev = leaves["light_pos"].device
    n = leaves["tri_rgb"].shape[0]
    z = torch.randn(3, generator=gen, device=dev)
    u = torch.rand((n, 3), generator=gen, device=dev)
    return dict(leaves,
                light_pos=leaves["light_pos"] + spec["light_pos_sigma"] * z,
                tri_rgb=torch.clamp(
                    leaves["tri_rgb"] * (1.0 + spec["rgb_rel"] * (2 * u - 1)),
                    0.0, 1.0))


def setup(run) -> State:
    from uob_raytracer_tpu_torch.config import RenderConfig
    from uob_raytracer_tpu_torch.scene import Scene
    mix = run.mix
    leaves = run.leaves()
    target = ref.render_image(perturb(leaves, mix["perturb"],
                                      run.generator(1)), run.params)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.inputs = {k: v.clone() for k, v in leaves.items()}
    st = State(scene=Scene(**leaves), target=target,
               cfg=RenderConfig(**run.config["render"]), lr=float(mix["lr"]),
               names=tuple(mix["trainable"]), first={})

    def keep():
        return {k: getattr(st.scene, k).detach().clone() for k in st.names}
    n_first = int(mix["first_steps"])
    st.first = {"p0": keep(), "losses": []}
    for k in range(n_first + int(mix["warmup_steps"])):
        loss = call(st)
        if k < n_first:
            st.first["losses"].append(loss)
        if k == 0:
            st.first["p1"] = keep()
        if k == n_first - 1:
            st.first["p_last"] = keep()
    return st


def call(st: State):
    """One step of the program; returns its loss (on the card)."""
    from uob_raytracer_tpu_torch.parallel.train import train_step
    out = train_step(st.scene, st.target, st.cfg, lr=st.lr,
                     trainable=st.names)
    st.scene = out.scene
    return out.loss


def window(st: State, seconds: float) -> dict:
    enqueue, n = 0.0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        call(st)
        enqueue += time.perf_counter() - t
        n += 1
    if st.target.is_cuda:
        torch.cuda.synchronize()
    return {"calls": n, "elapsed_s": time.perf_counter() - t0,
            "enqueue_s": enqueue}


def layer_spans(st: State, run) -> None:
    """Nothing beyond the window's own spans."""


def ray_stats(st: State, run):
    return ref.ray_stats(run.inputs, run.params)


def reference_steps(leaves: dict, target, p, names, lr: float, steps: int):
    """The reference's first ``steps`` SGD steps: the same record as the
    program's (losses, p0, p1, p_last), and its first gradient."""
    s = dict(leaves)
    out = {"p0": {k: s[k].clone() for k in names}, "losses": []}
    for k in range(steps):
        loss, g = ref.loss_and_grads(s, target, p, names)
        out["losses"].append(loss)
        if k == 0:
            out["grad"] = g
        s = dict(s, **{n: (s[n] - lr * g[n]).detach() for n in names})
        if k == 0:
            out["p1"] = {n: s[n].clone() for n in names}
    out["p_last"] = {n: s[n].clone() for n in names}
    return out


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _gaps(prog: dict, refv: dict, names) -> list:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    rn = {k: _norm(refv[k]) for k in names}
    med = statistics.median(rn.values())
    return [abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
            for k in names]


def readings(first: dict, reference: dict, lr: float, names) -> dict:
    """The check's numbers for a record of the first steps (the program's,
    or the control's) against the reference's."""
    def d(rec, k, later):
        return rec[later][k].double() - rec["p0"][k].double()
    g_ref = reference["grad"]
    g_med = statistics.median(_norm(g_ref[k]) for k in names)
    moving = [k for k in names if _norm(g_ref[k]) >= STILL * g_med]
    loss, want = (float(r["losses"][0]) for r in (first, reference))
    return {
        "first_loss_gap": abs(loss - want) / max(abs(want), 1e-30),
        "grad_gap": max(_gaps({k: -d(first, k, "p1") / lr for k in names},
                              g_ref, names)),
        "median_change_gap": statistics.median(_gaps(
            {k: d(first, k, "p_last") for k in moving},
            {k: d(reference, k, "p_last") for k in moving}, moving)),
    }


def check(st: State, run) -> dict:
    first, target, lr, names = st.first, st.target, st.lr, st.names
    st.scene = None
    gc_device(run.device)
    reference = reference_steps(run.inputs, target, run.params, names, lr,
                                len(first["losses"]))
    return readings(first, reference, lr, names)


def gc_device(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
