"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``uob_raytracer_tpu_torch/csrc``, holds the
fused render kernel against its plain torch version on the card, checks
the 64x64 goldens, drives the port's main path once —
``uob_raytracer_tpu_torch.render(cornell_box(device="cuda"),
RenderConfig())``, the full_1024 configuration — checks a row band of that
frame, and times the main path, the kernel and the plain version on every
baseline config. Every phase raises on failure; none is caught. The last
line of standard output is a JSON object with the device; the line before
it lists each kernel with its launches on the main path, its worst
deviation from the plain version at full_1024, and the full_1024 frame
time through the kernel's wrapper with the shadow quads detected once
("ms", table packing included), through the plain version ("plain_ms"), of
the kernel alone on the device ("device_ms") and through ``render()``,
which detects the quads on every call ("render_ms").

Imports neither jax nor the JAX package. Runs on one CUDA card: the first
of those CUDA_VISIBLE_DEVICES lists, or device 0. Exits non-zero without
printing a result where there is none.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# One card: torch sees only the first visible device (set before CUDA
# initialises, so that device_count() is 1).
DEVICE_ID = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = DEVICE_ID

import numpy as np  # noqa: E402
import torch  # noqa: E402

import uob_raytracer_tpu_torch as rt  # noqa: E402
from uob_raytracer_tpu_torch import RenderConfig, ShadingModel, baseline_configs  # noqa: E402
from uob_raytracer_tpu_torch.kernels import _build, render_fwd  # noqa: E402
from uob_raytracer_tpu_torch.ops.image import pack_argb, save_bmp  # noqa: E402
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")

# The JAX package's image-parity budget (tests/conftest.py:assert_images_match),
# copied because that file imports jax: at most 0.5% of pixels beyond 3e-4,
# and no pixel beyond 0.45 (one flipped shadow sample at the brightest
# shaded points; a larger deviation is a structural error).
TIGHT, OUTLIER_FRAC, OUTLIER_BOUND = 3e-4, 0.005, 0.45


def images_match(img, ref, what: str) -> tuple[float, float]:
    """Raise unless img is within the parity budget of ref; return the
    worst per-pixel deviation and the fraction of pixels beyond TIGHT."""
    diff = (img.float() - ref.float()).abs().amax(dim=-1)
    frac = (diff > TIGHT).float().mean().item()
    worst = diff.max().item()
    if frac > OUTLIER_FRAC or worst > OUTLIER_BOUND:
        raise AssertionError(
            f"{what}: {frac:.3%} of pixels beyond {TIGHT} (budget "
            f"{OUTLIER_FRAC:.1%}), worst {worst:.4g} (budget {OUTLIER_BOUND})")
    return worst, frac


def packed_equal(packed, img, what: str) -> None:
    """The kernel's packed buffer must equal pack_argb of its own image."""
    if not torch.equal(packed.view(torch.int32), pack_argb(img).view(torch.int32)):
        raise AssertionError(f"{what}: packed != pack_argb(image)")


def unpack(packed) -> torch.Tensor:
    """uint32 ARGB -> float RGB in [0, 1] (for comparing packed goldens)."""
    p = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255],
                       dim=-1).float() / 255.0


def scene_for(cfg: RenderConfig, device: str):
    """The scene the CLI renders for a config: cpu_ref gets the sphere-free
    box with the HOST constants."""
    return rt.cornell_box(
        spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE,
        device=device)


def time_frames(fn, warmup: int, n: int) -> list[float]:
    """CUDA-event milliseconds of n frames after warmup frames."""
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
    return out


def kernel_device_ms(fn, n: int = 10) -> float:
    """Mean device time of one render_fwd_kernel launch over n frames, from
    torch.profiler (the frame time above also holds the host-side table
    packing)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [k for k in prof.key_averages() if "render_fwd_kernel" in k.key]
    if not rows or rows[0].count != n:
        raise AssertionError(f"profiler saw {[k.count for k in rows]} "
                             f"render_fwd_kernel launches, not {n}")
    return rows[0].self_device_time_total / n / 1000.0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"torch sees {torch.cuda.device_count()} devices "
                             f"with CUDA_VISIBLE_DEVICES={DEVICE_ID}")

    # --- 1. setup ---
    card = subprocess.run(
        ["nvidia-smi", f"--id={DEVICE_ID}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    lib_path, build_s = _build.build()
    print(f"build: {build_s:.2f} s -> {os.path.relpath(lib_path, ROOT)}",
          flush=True)
    with open(lib_path[:-3] + ".log") as f:
        print("".join(line for line in f if "ptxas info    : Used" in line
                      or "spill" in line), end="", flush=True)
    dev = "cuda"

    # --- 2. kernel against its plain version on the card ---
    cornell = rt.cornell_box(device=dev)
    q_cornell = detect_shadow_quads(cornell)
    no_sph = rt.cornell_box(spheres=False, device=dev)
    q_no_sph = detect_shadow_quads(no_sph)
    small = RenderConfig(width=128, height=16)
    cases = [
        ("default", cornell, q_cornell, small),
        ("bounces=0", cornell, q_cornell, dataclasses.replace(small, bounces=0)),
        ("quirk_nan_tir", cornell, q_cornell,
         dataclasses.replace(small, quirk_nan_tir=True)),
        ("fresnel,bounces=4", cornell, q_cornell,
         dataclasses.replace(small, fresnel=True, bounces=4)),
        ("cpu_ref", cornell, q_cornell, dataclasses.replace(small, cpu_ref=True)),
        ("no spheres", no_sph, q_no_sph, small),
    ]
    for name, scene, quads, cfg in cases:
        ref = rt.render_image(scene, cfg, backend="torch")
        for q in (None, quads):
            out = rt.render(scene, cfg, backend="cuda", shadow_quads=q)
            torch.cuda.synchronize()
            what = f"128x16 {name} quads={q is not None}"
            worst, frac = images_match(out.image, ref, what)
            packed_equal(out.packed, out.image, what)
            print(f"parity {what}: worst {worst:.3g}, beyond {TIGHT}: "
                  f"{frac:.3%}", flush=True)

    scenes, worst_by_cfg = {}, {}
    for name, cfg in baseline_configs().items():
        scene = scene_for(cfg, dev)
        quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
        scenes[name] = (scene, quads)
        out = rt.render(scene, cfg, backend="cuda", shadow_quads=quads)
        ref = rt.render_image(scene, cfg, backend="torch")
        torch.cuda.synchronize()
        worst_by_cfg[name], frac = images_match(out.image, ref, name)
        packed_equal(out.packed, out.image, name)
        print(f"parity {name} {cfg.width}x{cfg.height}: worst "
              f"{worst_by_cfg[name]:.3g}, beyond {TIGHT}: {frac:.3%}",
              flush=True)

    # --- 3. goldens (the NumPy oracle's 64x64 renders) ---
    for fname, scene, cfg in [
        ("cornell_64_full.npz", cornell, RenderConfig(width=64, height=64)),
        ("cornell_64_cpuref.npz",
         rt.cornell_box(spheres=False, shading=ShadingModel.HOST, device=dev),
         RenderConfig(width=64, height=64, cpu_ref=True)),
    ]:
        with np.load(os.path.join(GOLDENS, fname)) as z:
            g_img = torch.from_numpy(z["image"]).to(dev)
            g_packed = torch.from_numpy(z["packed"].view(np.int32)).to(dev)
        quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
        out = rt.render(scene, cfg, backend="cuda", shadow_quads=quads)
        w_img, _ = images_match(out.image, g_img, f"golden {fname} image")
        w_pk, _ = images_match(unpack(out.packed), unpack(g_packed),
                               f"golden {fname} packed")
        print(f"golden {fname}: image worst {w_img:.3g}, packed worst "
              f"{w_pk:.3g}", flush=True)

    # --- 4. the main path: render() at full_1024 through the kernel ---
    scene = rt.cornell_box(device=dev)
    cfg = RenderConfig()
    render_fwd.LAUNCHES = 0
    out = rt.render(scene, cfg)
    torch.cuda.synchronize()
    launches = render_fwd.LAUNCHES
    if launches != 1:
        raise AssertionError(f"main path launched the kernel {launches} times")
    if tuple(out.image.shape) != (1024, 1024, 3):
        raise AssertionError(f"main path image shape {tuple(out.image.shape)}")
    if not torch.isfinite(out.image).all():
        raise AssertionError("main path image is not finite")
    packed_equal(out.packed, out.image, "main path")
    bmp = os.path.join(ROOT, "build", "chip_smoke_full_1024.bmp")
    os.makedirs(os.path.dirname(bmp), exist_ok=True)
    save_bmp(bmp, out.packed)
    print(f"main path: render(cornell_box(), RenderConfig()) -> "
          f"{tuple(out.image.shape)}, {launches} launch, mean "
          f"{out.image.mean().item():.4f}, wrote {os.path.relpath(bmp, ROOT)}",
          flush=True)

    # A row band of that frame through the kernel: bit for bit the same
    # rows (row0 enters the pixel id and the ray offset), and within the
    # budget of the plain version's band. Rows 333..432 cross block edges.
    r0, n = 333, 100
    band, band_p = render_fwd.render_fused_raw(
        scene, cfg, row0=r0, rows=n, quads=detect_shadow_quads(scene))
    torch.cuda.synchronize()
    if not (torch.equal(band, out.image[r0:r0 + n]) and torch.equal(
            band_p.view(torch.int32), out.packed[r0:r0 + n].view(torch.int32))):
        raise AssertionError(f"row band [{r0}, {r0 + n}) differs from the "
                             f"full frame's rows")
    worst, frac = images_match(
        band, render_fwd.render_fused_plain(scene, cfg, row0=r0, rows=n)[0],
        f"full_1024 row band [{r0}, {r0 + n})")
    print(f"row band [{r0}, {r0 + n}) of full_1024: equal to the full "
          f"frame's rows; vs plain band worst {worst:.3g}, beyond {TIGHT}: "
          f"{frac:.3%}", flush=True)

    # --- 5. timing: CUDA events around one frame — the main path render()
    # (quads detected on every call), the kernel's wrapper with the quads
    # detected once, and the plain version; the kernel's own device time
    # from the profiler ---
    times = {}
    for name, cfg in baseline_configs().items():
        scene, quads = scenes[name]

        def kernel_frame():
            return rt.render_image(scene, cfg, backend="cuda",
                                   shadow_quads=quads)

        main = time_frames(lambda: rt.render(scene, cfg), warmup=3, n=9)
        kern = time_frames(kernel_frame, warmup=3, n=9)
        plain = time_frames(lambda: rt.render_image(
            scene, cfg, backend="torch"), warmup=1, n=5)
        dev_ms = kernel_device_ms(kernel_frame)
        times[name] = (statistics.median(kern), statistics.median(plain),
                       dev_ms, statistics.median(main))
        rays = cfg.width * cfg.height * cfg.aa_rays
        print(f"time {name} [{card}]: render() frame median "
              f"{times[name][3]:.4f} ms (min {min(main):.4f}, max "
              f"{max(main):.4f}, n={len(main)}); kernel-path frame median "
              f"{times[name][0]:.4f} ms (min {min(kern):.4f}, max "
              f"{max(kern):.4f}, n={len(kern)}); kernel device "
              f"{dev_ms:.4f} ms = {rays / dev_ms / 1e6:.3f} G primary "
              f"rays/s; plain frame median {times[name][1]:.2f} ms (min "
              f"{min(plain):.2f}, max {max(plain):.2f}, n={len(plain)})",
              flush=True)

    kernels = [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "uob_raytracer_tpu_torch/csrc/render_fwd.cu",
        "replaces": "uob_raytracer_tpu/kernels/render_fwd.py:649",
        "launches": launches,
        "max_abs_err": worst_by_cfg["full_1024"],
        "ms": times["full_1024"][0],
        "plain_ms": times["full_1024"][1],
        "device_ms": times["full_1024"][2],
        "render_ms": times["full_1024"][3],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
