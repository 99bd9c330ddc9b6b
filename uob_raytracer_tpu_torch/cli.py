"""Command-line driver of the port — the counterpart of
``uob_raytracer_tpu/cli.py`` for the ``render``, ``fit`` and ``configs``
subcommands, with the same flags. No window: frames go to BMP/PPM files.

Usage:
    python -m uob_raytracer_tpu_torch.cli render  [--config full_1024] [-o out.bmp]
    python -m uob_raytracer_tpu_torch.cli fit     [--steps 30]   # differentiable demo
    python -m uob_raytracer_tpu_torch.cli configs

The scene lives on ``cuda:<first index of --devices>`` (``--devices``
defaults to 0); a machine without a CUDA device raises. ``--device cpu``
asks for the CPU by name. ``--backend`` is 'auto' (the kernels on the card,
their plain versions on the CPU), 'cuda' or 'torch'.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    if args.device is not None:
        return torch.device(args.device)
    first = (args.devices or "0").split(",")[0]
    return torch.device(f"cuda:{int(first)}")


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


def cmd_fit(args):
    """Differentiable-rendering demo: recover light position, a wall color,
    AND a vertex block from a target image with per-leaf Adam — the
    BASELINE config-5 parameter set."""
    from .parallel import fit
    from .render import render_image

    scene, cfg = _build(args)
    cfg = dataclasses.replace(cfg, width=min(cfg.width, 256),
                              height=min(cfg.height, 256))
    backend = args.backend
    dev = scene.device
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
        target1 = render_image(t1, cfg, backend=backend)
    s1, l1 = fit(scene, target1, cfg, steps=args.steps,
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
        target2 = render_image(t2, cfg, backend=backend)
    s2, l2 = fit(scene, target2, cfg, steps=args.steps,
                 lrs={"tri_v0": 5e-3 * s_lr, "tri_v1": 5e-3 * s_lr,
                      "tri_v2": 5e-3 * s_lr},
                 backend=backend, log_every=max(args.steps // 5, 1))
    dz = float((s2.tri_v0[8:10, 2] - scene.tri_v0[8:10, 2]).mean())
    print(f"[vertices]    loss {l2[0]:.6f} -> {l2[-1]:.6f}")
    print(f"  back wall z-shift fitted {dz:+.4f} (target +0.15)")


def cmd_configs(_args):
    from . import baseline_configs
    for name, cfg in baseline_configs().items():
        print(f"{name}: {cfg}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uob_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("fit", cmd_fit),
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
                        help="CUDA device indices; the frame renders on the "
                             "first (the OCL_DEVICE analogue, "
                             "skeleton.cpp:549-558)")
        sp.add_argument("--device", default=None, choices=["cpu"],
                        help="'cpu' runs on the CPU (the kernels' plain "
                             "versions); default: the CUDA device of "
                             "--devices")
        sp.add_argument("-o", "--out", default=None)
        if name == "fit":
            sp.add_argument("--steps", type=int, default=30)
            sp.add_argument("--lr", type=float, default=1.0,
                            help="scale factor on the per-leaf Adam rates")
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
