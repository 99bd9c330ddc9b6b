"""Command-line driver of the port — the counterpart of
``uob_raytracer_tpu/cli.py`` for the ``render`` and ``configs`` subcommands,
with the same flags. No window: frames go to BMP/PPM files.

Usage:
    python -m uob_raytracer_tpu_torch.cli render  [--config full_1024] [-o out.bmp]
    python -m uob_raytracer_tpu_torch.cli configs

The scene lives on ``cuda:<first index of --devices>`` when a CUDA device is
present (``--devices`` defaults to 0) and on the CPU otherwise; ``--backend``
is 'auto' (the kernel on the card, the plain pipeline on the CPU), 'cuda'
or 'torch'.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    if not torch.cuda.is_available():
        return torch.device("cpu")
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


def cmd_configs(_args):
    from . import baseline_configs
    for name, cfg in baseline_configs().items():
        print(f"{name}: {cfg}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uob_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("configs", cmd_configs)]:
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
        sp.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
