#!/usr/bin/env python
"""Where the port's fused backward's time goes as bounces grow: the
counterpart of ``scripts/bwd_sweep.py``.

Times the forward (``render_image``), the forward with the decision record
(``render_fused_res``, what the differentiable frame's forward runs), and
forward+backward (the gradient of the mean image to every Scene leaf) for
the full_1024 workload at bounces 0, 1, 2, 4 and 10, with the bench's
slope timing (``uob_raytracer_tpu_torch.bench.time_scalar_fn``; the quad
pairing detected once). Prints a table to stderr and one JSON line.

    python scripts/bwd_sweep_torch.py                 # on the card
    python scripts/bwd_sweep_torch.py --device cpu --width 16
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uob_raytracer_tpu_torch import RenderConfig, bench, cornell_box  # noqa: E402
from uob_raytracer_tpu_torch.kernels.render_fwd import render_fused_res  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bwd_sweep_torch.py")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = bench._device(args.device)
    scene = cornell_box(device=device)
    rows = []
    for b in (0, 1, 2, 4, 10):
        cfg = RenderConfig(width=args.width, height=args.width, bounces=b)
        quads = bench._quads_for(scene, cfg)
        image_fn = bench._image_fn(cfg, quads)
        dt_f = bench.time_scalar_fn(bench._fwd_scalar(image_fn), scene, 6)

        def res_scalar(s, cfg=cfg, quads=quads):
            # the record's outputs are written by the same launch; the
            # image's sum keeps the call scalar-valued for the timer
            with torch.no_grad():
                return render_fused_res(s, cfg, quads=quads)[0].sum()

        dt_r = bench.time_scalar_fn(res_scalar, scene, 6)
        dt_s = bench.time_scalar_fn(bench._step_scalar(image_fn), scene, 4)
        row = {"bounces": b, "fwd_ms": dt_f.ms_dict(),
               "fwd_record_ms": dt_r.ms_dict(), "fwd_bwd_ms": dt_s.ms_dict(),
               "bwd_ms": round((dt_s - dt_r) * 1e3, 4)}
        rows.append(row)
        print(f"b={b:2d}: fwd {dt_f*1e3:7.3f} ms | fwd+record "
              f"{dt_r*1e3:7.3f} ms | fwd+bwd {dt_s*1e3:7.3f} ms | bwd-only "
              f"~{(dt_s - dt_r)*1e3:7.3f} ms", file=sys.stderr, flush=True)
    print(json.dumps({"config": f"{args.width}x{args.width} aa4 s10",
                      "card": bench.card(device), "method": bench.METHOD,
                      "rows": rows}))


if __name__ == "__main__":
    main()
