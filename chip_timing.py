"""Device times of the large-scene path's kernels on one NVIDIA GPU.

    python3 chip_timing.py [--tag NAME] [--out FILE]

Times, on the scene and configs of ``chip_smoke.py`` (the JAX package's
``bench.py:dense_scene(8192)`` at 128x128, 2x2 AA, 3 samples, 2 bounces;
at 512x512 with 1 AA ray; the Cornell box at full_1024):

- the streamed forward kernel (K3f) as ``render()`` launches it (quads)
  and as ``train_step`` launches it (the record, no quads), and at 512x512;
- the streamed backward kernel (K3b) and the whole-table backward kernel
  (K2, at full_1024) at their default depth;
- the segmented sum: its wrapper (CUDA events), and within one call each
  device kernel it launches (the sort's, ``searchsorted``'s and its own)
  beside the host's share, and ``index_add_`` on the same rows;
- a dense_8192 ``train_step``.

It imports ``uob_raytracer_tpu_torch`` from the directory it sits in and
uses only wrapper calls that every version of the port has, so the same
file copied into a checkout of an earlier commit times that commit's
kernels: run parent, change, change, parent on one card, one after
another, to compare them. Prints the card's name and power limit, then one JSON line;
``--out`` writes that line to a file too. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import uob_raytracer_tpu_torch as rt
from uob_raytracer_tpu_torch import RenderConfig
from uob_raytracer_tpu_torch.kernels import render_bwd, render_fwd
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
from uob_raytracer_tpu_torch.parallel import train_step

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG_BIG = RenderConfig(width=128, height=128, aa_x=2, aa_y=2,
                       shadow_samples=3, bounces=2)
CFG_512 = RenderConfig(width=512, height=512, aa_x=1, aa_y=1,
                       shadow_samples=3, bounces=2)


def dense_scene(n_tri: int, seed: int = 1):
    """``chip_smoke.dense_scene``: the Cornell box plus random small diffuse
    triangles (the JAX package's ``bench.py:dense_scene`` recipe)."""
    base = rt.cornell_box()
    rng = np.random.RandomState(seed)
    extra = n_tri - base.num_triangles
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    return rt.add_triangles(base, verts, np.full((extra, 3), 0.6, np.float32),
                            np.ones((extra,), np.float32))


def seeded(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32)).cuda()


def event_ms(fn, warmup: int = 2, n: int = 5) -> float:
    """Median CUDA-event milliseconds of one call (host work included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def device_kernels(fn, n: int = 10) -> dict:
    """{kernel name: mean device ms per call of fn} over n calls, from
    torch.profiler (the names of the device kernels it launched)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for k in prof.key_averages():
        if (getattr(k, "device_type", None) == torch.autograd.DeviceType.CUDA
                and k.self_device_time_total > 0):
            out[k.key] = k.self_device_time_total / n / 1000.0
    return out


def kernel_ms(kernels: dict, name: str) -> float:
    """Device ms per call of the kernels whose name holds ``name``."""
    hits = [v for k, v in kernels.items() if name in k]
    if not hits:
        raise AssertionError(f"no {name} kernel among {sorted(kernels)}")
    return sum(hits)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default=os.path.basename(ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_timing: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"tag": args.tag, "card": card, "source": ROOT}

    big = dense_scene(8192)
    q_big = detect_shadow_quads(big)
    res_t = render_fwd.render_fused_res(big, CFG_BIG, quads=None)[2]
    g_big = seeded((128, 128, 3), 51)
    k = device_kernels(lambda: render_fwd.render_fused_raw(
        big, CFG_BIG, quads=q_big))
    out["k3f_ms"] = kernel_ms(k, "render_fwd_streamed_kernel")
    k = device_kernels(lambda: render_fwd.render_fused_res(
        big, CFG_BIG, quads=None))
    out["k3f_train_ms"] = kernel_ms(k, "render_fwd_streamed_kernel")
    k = device_kernels(lambda: render_fwd.render_fused_raw(
        big, CFG_512, quads=q_big), n=4)
    out["k3f_512_ms"] = kernel_ms(k, "render_fwd_streamed_kernel")

    k = device_kernels(lambda: render_bwd.render_replay_bwd(
        big, CFG_BIG, res_t, g_big))
    out["k3b_ms"] = kernel_ms(k, "render_bwd_streamed_kernel")
    out["k3b_segment_sum_ms"] = kernel_ms(k, "segment_sum")

    # the segmented sum on the sites of that record, split
    ids = render_bwd.site_ids(res_t)
    rows = seeded((ids.numel(), 16), 52)
    n_tri = big.num_triangles
    seg = lambda: render_bwd.segment_sum(ids, rows, n_tri)  # noqa: E731
    k = device_kernels(seg)
    out["segment_sum_kernels_ms"] = k
    out["segment_sum_own_ms"] = kernel_ms(k, "segment_sum")
    out["segment_sum_device_ms"] = sum(k.values())
    out["segment_sum_wrapper_ms"] = event_ms(seg, 3, 9)
    out["segment_sum_host_ms"] = (out["segment_sum_wrapper_ms"]
                                  - out["segment_sum_device_ms"])
    out["sort_ms"] = event_ms(lambda: torch.sort(ids, stable=True), 3, 9)
    sorted_ids = torch.sort(ids, stable=True)[0]
    out["searchsorted_ms"] = event_ms(lambda: torch.searchsorted(
        sorted_ids, torch.arange(n_tri + 1, dtype=torch.int32,
                                 device="cuda")), 3, 9)
    out["index_add_ms"] = event_ms(lambda: render_bwd.segment_sum_plain(
        ids, rows, n_tri), 3, 9)
    out["sites"] = ids.numel()
    out["live_sites"] = int(((ids >= 0) & (ids < n_tri)).sum())
    out["longest_run"] = int(torch.bincount(
        ids[(ids >= 0) & (ids < n_tri)].long()).max())

    target = rt.render_image(big, CFG_BIG) * 0.9
    out["train_step_ms"] = event_ms(lambda: train_step(
        big, target, CFG_BIG, lr=1e-3, trainable=("light_pos", "tri_rgb")))

    cornell = rt.cornell_box()
    cfg = RenderConfig()
    res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
    g = seeded((1024, 1024, 3), 11)
    k = device_kernels(lambda: render_bwd.render_replay_bwd(
        cornell, cfg, res, g))
    out["k2_full_1024_ms"] = kernel_ms(k, "render_bwd_kernel")
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    sys.exit(main())
