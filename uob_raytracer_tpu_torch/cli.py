"""Command-line driver of the port — the counterpart of
``uob_raytracer_tpu/cli.py``, with the same subcommands and flags. No
window: frames go to BMP/PPM files; the light animation reproduces the
reference's oscillation (``skeleton.cpp:290-298``).

Usage:
    python -m uob_raytracer_tpu_torch.cli render  [--config full_1024] [-o out.bmp]
    python -m uob_raytracer_tpu_torch.cli animate [--frames 60] [-o frames/]
    python -m uob_raytracer_tpu_torch.cli fit     [--steps 30]   # differentiable demo
    python -m uob_raytracer_tpu_torch.cli sweep   [--frames 60] [-o sweep/]
    python -m uob_raytracer_tpu_torch.cli configs

The scene lives on the first CUDA device that ``--devices`` (or the
``RAYTPU_DEVICES`` env var) names, device 0 without either; a machine
without a CUDA device raises. ``--device cpu`` asks for the CPU by name.
``--backend`` is 'auto' (the kernels on the card, their plain versions on
the CPU), 'cuda' or 'torch'.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    if args.device is not None:
        return torch.device(args.device)
    if os.environ.get("RAYTPU_DEVICES"):
        from .parallel import select_devices
        return select_devices()[0]
    return torch.device("cuda:0")


def _build(args):
    from . import (RenderConfig, ShadingModel, add_triangles,
                   baseline_configs, cornell_box, load_obj)

    configs = baseline_configs()
    cfg = configs.get(args.config, RenderConfig())
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width,
                                  height=args.height or args.width)
    dev = _device(args)
    scene = cornell_box(
        spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE,
        device=dev)
    if args.obj:
        scene = add_triangles(scene, *load_obj(args.obj))
    if args.yaw or args.pitch:
        scene = dataclasses.replace(
            scene, yaw=torch.tensor(np.float32(args.yaw), device=dev),
            pitch=torch.tensor(np.float32(args.pitch), device=dev))
    return scene, cfg


def _sync(scene) -> None:
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)


def cmd_render(args):
    from .ops.image import save_bmp, save_ppm
    from .render import render

    scene, cfg = _build(args)
    t0 = time.time()
    out = render(scene, cfg, backend=args.backend)
    _sync(scene)
    dt = time.time() - t0
    # reference prints per-frame time + FPS (skeleton.cpp:131-132)
    print(f"Rendertime: {dt*1e6:.0f} microseconds (includes the kernel build "
          f"on a first run)")
    t0 = time.time()
    out = render(scene, cfg, backend=args.backend)
    _sync(scene)
    dt = time.time() - t0
    print(f"Rendertime: {dt*1e6:.0f} microseconds")
    print(f"Frame Rate: {1.0/dt:.1f} FPS")
    path = args.out or "screenshot.bmp"
    if path.endswith(".ppm"):
        save_ppm(path, out.image)
    else:
        save_bmp(path, out.packed)
    print(f"saved {path} ({scene.device})")


def _light_at(scene, x: float):
    light = scene.light_pos.clone()
    light[0] = x
    return dataclasses.replace(scene, light_pos=light)


def cmd_animate(args):
    from .ops.image import save_bmp
    from .render import render
    from .scene import animate_light

    scene, cfg = _build(args)
    outdir = args.out or "frames"
    os.makedirs(outdir, exist_ok=True)
    light_x, lor = scene.light_pos[0].item(), True
    t_total = 0.0
    for f in range(args.frames):
        light_x, lor = animate_light(light_x, lor)
        t0 = time.time()
        out = render(_light_at(scene, light_x), cfg, backend=args.backend)
        _sync(scene)
        if f > 0:
            t_total += time.time() - t0
        save_bmp(os.path.join(outdir, f"frame_{f:04d}.bmp"), out.packed)
    if args.frames > 1:
        dt = t_total / (args.frames - 1)
        print(f"{args.frames} frames; steady-state {dt*1e3:.2f} ms/frame "
              f"= {1.0/dt:.1f} FPS")


def cmd_fit(args):
    """Differentiable-rendering demo: recover light position, a wall color,
    AND a vertex block from a target image with per-leaf Adam — the
    BASELINE config-5 parameter set — through the sharded renderer."""
    from .parallel import fit, make_mesh, render_image_sharded

    scene, cfg = _build(args)
    cfg = dataclasses.replace(cfg, width=min(cfg.width, 256),
                              height=min(cfg.height, 256))
    backend = args.backend
    dev = scene.device
    # every process on dp: one process, the 1x1 mesh of the scene's device
    mesh = make_mesh(tp=1, devices=[dev])
    # --lr scales every per-leaf Adam rate (1.0 = the tuned defaults).
    s_lr = args.lr

    def np_(t):
        return t.detach().cpu().numpy()

    # Round 1: light position + left-wall color, jointly.
    rgb = scene.tri_rgb.clone()
    rgb[2:4] = torch.tensor([0.9, 0.5, 0.2], device=dev)
    t1 = dataclasses.replace(
        scene, light_pos=torch.tensor([0.25, -0.5, -0.7], device=dev),
        tri_rgb=rgb)
    with torch.no_grad():
        target1 = render_image_sharded(t1, cfg, mesh, backend=backend)
    s1, l1 = fit(scene, target1, cfg, mesh, steps=args.steps,
                 lrs={"light_pos": 2e-2 * s_lr, "tri_rgb": 2e-2 * s_lr},
                 backend=backend, log_every=max(args.steps // 5, 1))
    print(f"[light+color] loss {l1[0]:.6f} -> {l1[-1]:.6f}")
    print(f"  light fitted {np_(s1.light_pos).round(4)} "
          f"(target {np_(t1.light_pos).round(4)})")
    print(f"  left wall rgb fitted {np_(s1.tri_rgb[2]).round(3)} "
          f"(target {np_(t1.tri_rgb[2]).round(3)})")

    # Round 2: vertex recovery — back wall pushed along z (shading-coupled,
    # so the interior gradient identifies it; pure silhouette slides are
    # invisible under frozen-visibility gradients).
    dv = torch.zeros_like(scene.tri_v0)
    dv[8:10] += torch.tensor([0.0, 0.0, 0.15], device=dev)
    t2 = dataclasses.replace(scene, tri_v0=scene.tri_v0 + dv,
                             tri_v1=scene.tri_v1 + dv,
                             tri_v2=scene.tri_v2 + dv)
    with torch.no_grad():
        target2 = render_image_sharded(t2, cfg, mesh, backend=backend)
    s2, l2 = fit(scene, target2, cfg, mesh, steps=args.steps,
                 lrs={"tri_v0": 5e-3 * s_lr, "tri_v1": 5e-3 * s_lr,
                      "tri_v2": 5e-3 * s_lr},
                 backend=backend, log_every=max(args.steps // 5, 1))
    dz = float((s2.tri_v0[8:10, 2] - scene.tri_v0[8:10, 2]).mean())
    print(f"[vertices]    loss {l2[0]:.6f} -> {l2[-1]:.6f}")
    print(f"  back wall z-shift fitted {dz:+.4f} (target +0.15)")


def cmd_sweep(args):
    """Parameter sweep: render a grid of light x positions (the axis
    the reference's update loop animates) and report per-frame stats."""
    from .ops.image import save_bmp
    from .render import render

    scene, cfg = _build(args)
    outdir = args.out or "sweep"
    os.makedirs(outdir, exist_ok=True)
    xs = np.linspace(-0.5, 0.5, args.frames, dtype=np.float32)
    for i, x in enumerate(xs):
        out = render(_light_at(scene, float(x)), cfg, backend=args.backend)
        save_bmp(os.path.join(outdir, f"light_{i:03d}.bmp"), out.packed)
        print(f"light_x={x:+.3f} mean={out.image.mean().item():.4f} "
              f"max={out.image.max().item():.4f}")


def cmd_configs(_args):
    from . import baseline_configs
    for name, cfg in baseline_configs().items():
        print(f"{name}: {cfg}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uob_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("animate", cmd_animate),
                     ("fit", cmd_fit), ("sweep", cmd_sweep),
                     ("configs", cmd_configs)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--config", default="full_1024")
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--backend", default="auto",
                        help="auto | cuda | torch")
        sp.add_argument("--obj", default=None)
        sp.add_argument("--yaw", type=float, default=0.0)
        sp.add_argument("--pitch", type=float, default=0.0)
        sp.add_argument("--devices", default=None, metavar="IDX[,IDX...]",
                        help="CUDA device indices to use (default: all; "
                             "also settable via RAYTPU_DEVICES — the "
                             "OCL_DEVICE analogue, skeleton.cpp:549-558); "
                             "one process renders on the first")
        sp.add_argument("--device", default=None, choices=["cpu"],
                        help="'cpu' runs on the CPU (the kernels' plain "
                             "versions); default: the CUDA device of "
                             "--devices")
        sp.add_argument("-o", "--out", default=None)
        if name in ("animate", "sweep"):
            sp.add_argument("--frames", type=int, default=60)
        if name == "fit":
            sp.add_argument("--steps", type=int, default=30)
            sp.add_argument("--lr", type=float, default=1.0,
                            help="scale factor on the per-leaf Adam rates")
    args = p.parse_args(argv)
    if args.devices is not None:
        # stash in the env so every make_mesh() call in the command path
        # (and any worker subprocess) sees the same selection
        os.environ["RAYTPU_DEVICES"] = args.devices
    args.fn(args)


if __name__ == "__main__":
    main()
