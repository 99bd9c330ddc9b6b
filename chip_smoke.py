"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``uob_raytracer_tpu_torch/csrc`` (one nvcc call,
one library) and then, every phase raising on failure and none caught:

1. holds the fused forward kernel against its plain torch version on the
   card (twelve 128x16 mode cases, the five baseline configs, the 64x64
   goldens), and its residual outputs against the plain decision record,
   with the shadow quads and, as the trainer launches it, without them;
2. holds the path-replay backward kernel against its plain version (torch
   autograd through the replay) on the 128x16 mode cases;
3. drives the port's two main paths at the full_1024 configuration:
   ``render(cornell_box(), RenderConfig())`` (one forward launch, a row band
   checked against it), and five ``train_step``s on light_pos and tri_rgb
   towards a target rendered with the light moved (one forward and one
   backward launch per step, finite gradients, a falling loss);
4. holds the backward kernel against its plain version at full width (the
   plain version run in eight row bands, its gradients summed), and checks
   that two runs give bit-equal gradients;
5. times, per baseline config, ``render()``, the forward wrapper with and
   without the record, the backward wrapper, ``train_step`` and the plain
   versions (CUDA events; each kernel's device time from torch.profiler).

The line before the last lists each kernel with its launches on its main
path, its worst deviation from the plain version at full_1024, its times
and its bound: the least time the card could take for the same work, the
larger of bytes / 3.35 TB/s (inputs read once, outputs written once) and
float32 operations / 67 TFLOP/s (NVIDIA's H100 SXM data sheet), with the
operations counted analytically from this run's decision record (see
``fwd_work`` and ``bwd_work``). No single PyTorch call computes either
kernel's function, so ``library_ms`` is null. The last line of standard
output is a JSON object with the device.

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
from uob_raytracer_tpu_torch.kernels import _build, render_bwd, render_fwd  # noqa: E402
from uob_raytracer_tpu_torch.ops.image import pack_argb, save_bmp  # noqa: E402
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads  # noqa: E402
from uob_raytracer_tpu_torch.ops.replay import Residuals  # noqa: E402
from uob_raytracer_tpu_torch.parallel import train_step  # noqa: E402
from uob_raytracer_tpu_torch.scene import Scene  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")

# The JAX package's image-parity budget (tests/conftest.py:assert_images_match),
# copied because that file imports jax: at most 0.5% of pixels beyond 3e-4,
# and no pixel beyond 0.45 (one flipped shadow sample at the brightest
# shaded points; a larger deviation is a structural error).
TIGHT, OUTLIER_FRAC, OUTLIER_BOUND = 3e-4, 0.005, 0.45
# Gradients, leaf by leaf, as max|a-b| / max(max|ref|, 1): float32 noise
# away from the glass interior; pixels whose path re-enters a sphere after
# the first bounce cross a double refraction whose derivative holds
# 1/(2 sqrt(k)) terms near total internal reflection, so two valid float32
# evaluations of the same formulas differ there more than elsewhere. The
# kernel follows its plain version operation by operation, so here that
# budget is 1e-3 (this script's runs read 2e-6 to 4e-5 there); the 0.15 of
# the JAX package's tests is for two differently ordered evaluations.
GRAD_TOL, GRAD_TOL_GLASS = 1e-4, 1e-3
# H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


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


def record_matches(res, ref, what: str) -> tuple[float, float, float]:
    """Raise unless the kernel's decision record differs from the plain
    record on at most 0.5% of rays (boundary pixels); return the fractions
    of differing pid, bid and lit entries."""
    fr = [(a != b).float().mean().item() if a.numel() else 0.0
          for a, b in zip(res, ref)]
    pid, lit, bid = fr
    if max(fr) > OUTLIER_FRAC:
        raise AssertionError(f"{what}: record differs from the plain one on "
                             f"pid {pid:.3%}, bid {bid:.3%}, lit {lit:.3%} of "
                             f"entries (budget {OUTLIER_FRAC:.1%})")
    return pid, bid, lit


def grad_errors(ref: Scene, got: Scene) -> tuple[float, float, str]:
    """(worst leaf-wise relative error, worst absolute error, its leaf)."""
    rel, ab, leaf = 0.0, 0.0, ""
    for k in LEAVES:
        a, b = getattr(ref, k), getattr(got, k)
        if not a.numel():
            continue
        if not torch.isfinite(b).all():
            raise AssertionError(f"gradient of {k} is not finite")
        err = (a - b).abs().max().item()
        r = err / max(a.abs().max().item(), 1.0)
        ab = max(ab, err)
        if r >= rel:
            rel, leaf = r, k
    return rel, ab, leaf


def scene_for(cfg: RenderConfig):
    """The scene the CLI renders for a config: cpu_ref gets the sphere-free
    box with the HOST constants."""
    return rt.cornell_box(
        spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE)


def seeded_cotangent(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32)).cuda()


def plain_bwd_banded(scene, cfg, res: Residuals, g, bands: int) -> Scene:
    """The plain backward over ``bands`` row bands, gradients summed: the
    same function as one call (the image is a sum over rows), with the
    autograd graph of one band alive at a time."""
    rows = cfg.height // bands
    total = None
    for i in range(bands):
        sl = slice(i * rows, (i + 1) * rows)
        band = Residuals(res.prim_id[:, sl].contiguous(),
                         res.lit_cnt[:, sl].contiguous(),
                         res.bounce_id[:, :, sl].contiguous())
        bar = render_bwd.render_replay_bwd_plain(scene, cfg, band, g[sl],
                                                 i * rows, rows)
        total = bar if total is None else Scene(**{
            k: getattr(total, k) + getattr(bar, k) for k in LEAVES})
    return total


def check_backward(scene, cfg, res, seed: int, what: str, bands: int = 1):
    """K2 against its plain version on one record: float32 noise with the
    glass-interior pixels' cotangent zeroed, the conditioning budget with
    all of it. Returns (worst relative, worst absolute) of the full run."""
    g = seeded_cotangent((cfg.height, cfg.width, 3), seed)
    runs = [(g, GRAD_TOL_GLASS if cfg.bounces >= 2 else GRAD_TOL)]
    if cfg.bounces >= 2:
        glass = (res.bounce_id >= scene.num_triangles).any(dim=0).any(dim=0)
        runs.append((g * ~glass[:, :, None], GRAD_TOL))
    out = None
    for g_run, tol in runs:
        ref = plain_bwd_banded(scene, cfg, res, g_run, bands)
        got = render_bwd.render_replay_bwd(scene, cfg, res, g_run)
        torch.cuda.synchronize()
        rel, ab, leaf = grad_errors(ref, got)
        if rel > tol:
            raise AssertionError(f"backward {what}: {leaf} off by {rel:.3g} "
                                 f"relative (budget {tol})")
        out = out or (rel, ab)
        print(f"backward {what} (budget {tol}): worst {leaf} {rel:.3g} "
              f"relative, {ab:.3g} absolute", flush=True)
    return out


def time_frames(fn, warmup: int, n: int) -> list[float]:
    """CUDA-event milliseconds of n calls after warmup calls."""
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


def kernel_device_ms(fn, kernel: str, n: int = 10) -> float:
    """Mean device time of one launch of ``kernel`` over n calls of fn,
    from torch.profiler (a wrapper's time also holds its host-side work).
    The tracer may drop the records of some launches: the mean is over the
    launches it kept, at least half of them, in at most three sessions. It
    never keeps more than were made."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [k for k in prof.key_averages() if kernel in k.key]
        count = sum(k.count for k in rows)
        seen.append(count)
        if count > n:
            raise AssertionError(f"profiler saw {count} {kernel} launches "
                                 f"in {n} calls")
        if 2 * count >= n:
            if count != n:
                print(f"profiler kept {count} of {n} {kernel} launches",
                      flush=True)
            return sum(k.self_device_time_total for k in rows) / count / 1000.0
    raise AssertionError(f"profiler kept {seen} of {n} {kernel} launches "
                         f"in three sessions")


# ---------------------------------------------------------------------------
# The kernels' bounds: bytes and float32 operations of the work these inputs
# need. One operation = one add, multiply, divide, sqrt or compare on
# float32, counted from the formulas of csrc/*.cu (no FMA: a multiply-add is
# two). The per-item constants are hand counts, good to about +-30%.
# ---------------------------------------------------------------------------

def fwd_work(cfg, scene, quads, res: Residuals, record: bool):
    """(bytes, operations) of one forward frame. Operations: per ray the
    primary scan; per executed bounce step a general nearest-hit scan; per
    shading ray the occlusion scan, in full for every lit sample (the
    record's lit count) and one row for an occluded one (its scan stops at
    the first occluder)."""
    n_tri = scene.num_triangles
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    n_rows = n_tri if quads is None else len(quads[0]) + len(quads[1])
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    shading = int((res.lit_cnt > 0).sum())   # lower bound: lit 0 not seen
    lit = float(res.lit_cnt.sum())
    occluded = shading * cfg.shadow_samples - lit
    ops = (rays * (30 + 26 * n_tri + 40 * n_sph)
           + steps * (90 + 70 * n_tri + 45 * n_sph)
           + shading * 60 + (lit + occluded) * 30
           + lit * (55 * n_rows + 30 * n_sph) + occluded * 55)
    pix = cfg.width * cfg.height
    nbytes = 16 * pix + (rays * (8 + 4 * cfg.bounces) if record else 0)
    return nbytes, ops


def bwd_work(cfg, scene, res: Residuals):
    """(bytes, operations) of one backward pass: the primary id, the lit
    count and the cotangent read once, the per-block partial sums written
    once, and of the per-step ids only those the replay reads: one per
    executed step, and one more per chain for the entry that ends it; per
    ray the primary hit's replay and adjoint and the shading adjoint, per
    executed bounce step its replay, the step's adjoint and the hit's."""
    n_obj = scene.num_triangles + (0 if cfg.cpu_ref else scene.num_spheres)
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    chains = int((res.bounce_id[0] >= 0).sum()) if cfg.bounces else 0
    pix = cfg.width * cfg.height
    blocks = -(-pix // render_bwd.THREADS)
    nbytes = (rays * 8 + 4 * (steps + chains) + 12 * pix
              + 4 * blocks * (n_obj * render_bwd.GRAD_COLS + 21))
    ops = rays * 450 + steps * 650
    return nbytes, ops


def bound(nbytes, ops) -> tuple[float, str]:
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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
    t0 = time.perf_counter()
    lib_path, seconds = _build.build()
    print(f"build: nvcc {seconds:.2f} s ({time.perf_counter() - t0:.2f} s in "
          f"all) -> {os.path.relpath(lib_path, ROOT)}", flush=True)
    with open(lib_path[:-3] + ".log") as f:
        print("".join(line for line in f if "ptxas info    : Used" in line
                      or "spill" in line), end="", flush=True)

    # --- 2. kernels against their plain versions on the card ---
    cornell = rt.cornell_box()
    q_cornell = detect_shadow_quads(cornell)
    no_sph = rt.cornell_box(spheres=False)
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
    for i, (name, scene, quads, cfg) in enumerate(cases):
        ref, _, ref_res = render_fwd.render_fused_res_plain(scene, cfg)
        for q in (None, quads):
            out = rt.render(scene, cfg, backend="cuda", shadow_quads=q)
            torch.cuda.synchronize()
            what = f"128x16 {name} quads={q is not None}"
            worst, frac = images_match(out.image, ref, what)
            packed_equal(out.packed, out.image, what)
            # the same launch with its residual outputs on: the same image
            # bit for bit, and the plain version's decisions
            img_r, packed_r, res = render_fwd.render_fused_res(scene, cfg,
                                                               quads=q)
            torch.cuda.synchronize()
            if not (torch.equal(img_r, out.image) and torch.equal(
                    packed_r.view(torch.int32), out.packed.view(torch.int32))):
                raise AssertionError(f"{what}: recording changed the frame")
            pid, bid, lit = record_matches(res, ref_res, what)
            print(f"parity {what}: worst {worst:.3g}, beyond {TIGHT}: "
                  f"{frac:.3%}; record vs plain differs on pid {pid:.3%}, "
                  f"bid {bid:.3%}, lit {lit:.3%}", flush=True)
        check_backward(scene, cfg, res, seed=i, what=f"128x16 {name}")

    # a scene past 32 objects (the JAX kernel's whole-table mode without
    # the presence bits): the Cornell box with a 20-triangle icosahedron
    verts, rgb, mat = rt.load_obj(os.path.join(ROOT, "assets", "ico.obj"),
                                  mat_code=1.0)
    ico = rt.add_triangles(cornell, verts, rgb, mat)
    cfg = dataclasses.replace(small, bounces=1)
    check_backward(ico, cfg, render_fwd.render_fused_res(ico, cfg)[2], seed=9,
                   what=f"128x16 {ico.num_triangles + 2} objects")

    scenes, worst_by_cfg, records = {}, {}, {}
    for name, cfg in baseline_configs().items():
        scene = scene_for(cfg)
        quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
        scenes[name] = (scene, quads)
        out = rt.render(scene, cfg, backend="cuda", shadow_quads=quads)
        img_r, _, res = render_fwd.render_fused_res(scene, cfg, quads=quads)
        ref, _, ref_res = render_fwd.render_fused_res_plain(scene, cfg)
        torch.cuda.synchronize()
        worst_by_cfg[name], frac = images_match(out.image, ref, name)
        packed_equal(out.packed, out.image, name)
        if not torch.equal(img_r, out.image):
            raise AssertionError(f"{name}: recording changed the frame")
        pid, bid, lit = record_matches(res, ref_res, name)
        records[name] = res
        # the launch a training step makes: the record on, no quads (a
        # trainer must not reuse a pairing), all triangle rows scanned
        img_t, _, res_t = render_fwd.render_fused_res(scene, cfg, quads=None)
        torch.cuda.synchronize()
        images_match(img_t, ref, f"{name} without quads")
        record_matches(res_t, ref_res, f"{name} without quads")
        print(f"parity {name} {cfg.width}x{cfg.height}: worst "
              f"{worst_by_cfg[name]:.3g}, beyond {TIGHT}: {frac:.3%}; record "
              f"vs plain differs on pid {pid:.3%}, bid {bid:.3%}, lit "
              f"{lit:.3%}", flush=True)

    # --- 3. goldens (the NumPy oracle's 64x64 renders) ---
    for fname, scene, cfg in [
        ("cornell_64_full.npz", cornell, RenderConfig(width=64, height=64)),
        ("cornell_64_cpuref.npz",
         rt.cornell_box(spheres=False, shading=ShadingModel.HOST),
         RenderConfig(width=64, height=64, cpu_ref=True)),
    ]:
        with np.load(os.path.join(GOLDENS, fname)) as z:
            g_img = torch.from_numpy(z["image"]).cuda()
            g_packed = torch.from_numpy(z["packed"].view(np.int32)).cuda()
        quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
        out = rt.render(scene, cfg, backend="cuda", shadow_quads=quads)
        w_img, _ = images_match(out.image, g_img, f"golden {fname} image")
        w_pk, _ = images_match(unpack(out.packed), unpack(g_packed),
                               f"golden {fname} packed")
        print(f"golden {fname}: image worst {w_img:.3g}, packed worst "
              f"{w_pk:.3g}", flush=True)

    # --- 4. main path one: render() at full_1024 through the kernel ---
    scene = rt.cornell_box()
    if scene.device.type != "cuda":
        raise AssertionError(f"cornell_box() built the scene on {scene.device}")
    cfg = RenderConfig()
    render_fwd.LAUNCHES = render_bwd.LAUNCHES = 0
    out = rt.render(scene, cfg)
    torch.cuda.synchronize()
    launches = render_fwd.LAUNCHES
    if launches != 1 or render_bwd.LAUNCHES != 0:
        raise AssertionError(f"render() launched the forward kernel {launches} "
                             f"times and the backward {render_bwd.LAUNCHES}")
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

    # --- 5. main path two: train_step at full_1024, forward kernel with its
    # record and backward kernel, five SGD steps on light and colours
    # towards a frame rendered with the light moved ---
    moved = dataclasses.replace(
        scene, light_pos=torch.tensor([0.25, -0.5, -0.7], device="cuda"))
    with torch.no_grad():
        target = rt.render_image(moved, cfg)
    render_fwd.LAUNCHES = render_bwd.LAUNCHES = 0
    live, losses = scene, []
    for step in range(5):
        step_out = train_step(live, target, cfg, lr=2.0,
                              trainable=("light_pos", "tri_rgb"))
        live = step_out.scene
        losses.append(step_out.loss.item())
        if (render_fwd.LAUNCHES, render_bwd.LAUNCHES) != (step + 1, step + 1):
            raise AssertionError(
                f"train_step {step}: {render_fwd.LAUNCHES} forward and "
                f"{render_bwd.LAUNCHES} backward launches so far")
        for k in ("light_pos", "tri_rgb"):
            if not torch.isfinite(getattr(live, k)).all():
                raise AssertionError(f"train_step {step}: {k} is not finite")
    torch.cuda.synchronize()
    train_launches = (render_fwd.LAUNCHES, render_bwd.LAUNCHES)
    if not losses[4] < losses[0]:
        raise AssertionError(f"loss did not fall over 5 steps: {losses}")
    print(f"training path: 5 train_steps at full_1024 on light_pos, tri_rgb: "
          f"{train_launches[0]} forward and {train_launches[1]} backward "
          f"launches, loss {losses[0]:.6g} -> {losses[4]:.6g}, light "
          f"{[round(v, 4) for v in live.light_pos.tolist()]}", flush=True)

    # --- 6. the backward kernel at full width against its plain version in
    # eight row bands; two runs give bit-equal gradients; the replayed
    # radiance is the forward frame ---
    quads = scenes["full_1024"][1]
    res = records["full_1024"]
    bwd_rel, bwd_abs = check_backward(scene, cfg, res, seed=11,
                                      what="full_1024 (plain in 8 bands)", bands=8)
    g = seeded_cotangent((1024, 1024, 3), 11)
    one, primal = render_bwd.render_replay_bwd(scene, cfg, res, g,
                                               return_primal=True)
    two = render_bwd.render_replay_bwd(scene, cfg, res, g)
    torch.cuda.synchronize()
    for k in LEAVES:
        if not torch.equal(getattr(one, k), getattr(two, k)):
            raise AssertionError(f"two backward runs differ in {k}")
    if any(getattr(one, k).abs().max() != 0 for k in ("tri_mat", "sph_mat")):
        raise AssertionError("material codes got a gradient")
    worst = (primal - out.image).abs().max().item()
    if worst > 1e-4:
        raise AssertionError(f"replayed radiance off the forward frame by "
                             f"{worst:.3g}")
    print(f"backward full_1024: two runs bit-equal on every leaf; replayed "
          f"radiance within {worst:.3g} of the forward frame", flush=True)

    # --- 7. timing: CUDA events around one call — render() (quads detected
    # on every call), the forward wrapper with the quads detected once,
    # with and without the record, the backward wrapper, train_step, and
    # the plain versions; each kernel's own device time from the profiler.
    # (5 and 3 timed calls where this script took 9 and 5 before it grew
    # the backward phases, so that the whole stays in its time.) ---
    times = {}
    for name, cfg in baseline_configs().items():
        scene, quads = scenes[name]
        res = records[name]
        g = seeded_cotangent((cfg.height, cfg.width, 3), 3)
        target = rt.render_image(scene, cfg, shadow_quads=quads) * 0.9

        def fwd_frame():
            return rt.render_image(scene, cfg, backend="cuda",
                                   shadow_quads=quads)

        def fwd_rec():
            return render_fwd.render_fused_res(scene, cfg, quads=quads)

        def fwd_rec_train():
            return render_fwd.render_fused_res(scene, cfg, quads=None)

        def bwd():
            return render_bwd.render_replay_bwd(scene, cfg, res, g)

        def step():
            return train_step(scene, target, cfg, lr=1e-3,
                              trainable=("light_pos", "tri_rgb"))

        def plain_bwd():
            return plain_bwd_banded(scene, cfg, res, g,
                                    8 if name == "full_1024" else 1)

        t = {
            "render": time_frames(lambda: rt.render(scene, cfg), 3, 5),
            "fwd": time_frames(fwd_frame, 3, 5),
            "fwd_rec": time_frames(fwd_rec, 3, 5),
            "bwd": time_frames(bwd, 3, 5),
            "step": time_frames(step, 2, 5),
            "plain": time_frames(lambda: rt.render_image(
                scene, cfg, backend="torch"), 1, 3),
            "plain_bwd": time_frames(plain_bwd, 1, 3),
        }
        med = {k: statistics.median(v) for k, v in t.items()}
        med["fwd_dev"] = kernel_device_ms(fwd_frame, "render_fwd_kernel")
        med["fwd_rec_dev"] = kernel_device_ms(fwd_rec, "render_fwd_kernel")
        med["fwd_train_dev"] = kernel_device_ms(fwd_rec_train,
                                                "render_fwd_kernel")
        med["bwd_dev"] = kernel_device_ms(bwd, "render_bwd_kernel")
        med["fwd_bound"] = bound(*fwd_work(cfg, scene, quads, res, False))
        med["fwd_rec_bound"] = bound(*fwd_work(cfg, scene, quads, res, True))
        med["fwd_train_bound"] = bound(*fwd_work(cfg, scene, None, res, True))
        med["bwd_bound"] = bound(*bwd_work(cfg, scene, res))
        times[name] = med
        rays = cfg.width * cfg.height * cfg.aa_rays
        print(f"time {name} [{card}]: render() median {med['render']:.4f} ms "
              f"(min {min(t['render']):.4f}, max {max(t['render']):.4f}, n=5); "
              f"forward wrapper {med['fwd']:.4f} ms (min {min(t['fwd']):.4f}, "
              f"max {max(t['fwd']):.4f}), device {med['fwd_dev']:.4f} ms = "
              f"{rays / med['fwd_dev'] / 1e6:.3f} G primary rays/s, bound "
              f"{med['fwd_bound'][0]:.4f} ms by {med['fwd_bound'][1]}; with "
              f"the record: wrapper {med['fwd_rec']:.4f} ms, device "
              f"{med['fwd_rec_dev']:.4f} ms, bound {med['fwd_rec_bound'][0]:.4f}"
              f" ms by {med['fwd_rec_bound'][1]}; with the record and no "
              f"quads, as train_step launches it: device "
              f"{med['fwd_train_dev']:.4f} ms, bound "
              f"{med['fwd_train_bound'][0]:.4f} ms by "
              f"{med['fwd_train_bound'][1]}; backward wrapper "
              f"{med['bwd']:.4f} ms (min {min(t['bwd']):.4f}, max "
              f"{max(t['bwd']):.4f}), device {med['bwd_dev']:.4f} ms, bound "
              f"{med['bwd_bound'][0]:.4f} ms by {med['bwd_bound'][1]}; "
              f"train_step {med['step']:.4f} ms (min {min(t['step']):.4f}, max "
              f"{max(t['step']):.4f}); plain forward {med['plain']:.2f} ms, "
              f"plain backward {med['plain_bwd']:.2f} ms"
              f"{' (in 8 row bands)' if name == 'full_1024' else ''} (n=3)",
              flush=True)

    full = times["full_1024"]
    kernels = [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "uob_raytracer_tpu_torch/csrc/render_fwd.cu",
        "replaces": "uob_raytracer_tpu/kernels/render_fwd.py:649",
        "launches": launches,
        "launches_5_train_steps": train_launches[0],
        "max_abs_err": worst_by_cfg["full_1024"],
        "ms": full["fwd"],
        "plain_ms": full["plain"],
        "bound_ms": full["fwd_bound"][0],
        "bound_by": full["fwd_bound"][1],
        "library_ms": None,
        "device_ms": full["fwd_dev"],
        "device_ms_residuals": full["fwd_rec_dev"],
        "bound_ms_residuals": full["fwd_rec_bound"][0],
        "device_ms_train_step": full["fwd_train_dev"],
        "bound_ms_train_step": full["fwd_train_bound"][0],
        "render_ms": full["render"],
    }, {
        "name": "render_bwd",
        "route": "cuda",
        "source": "uob_raytracer_tpu_torch/csrc/render_bwd.cu",
        "replaces": "uob_raytracer_tpu/kernels/render_bwd.py:366",
        "launches": train_launches[1],
        "launches_per_step": train_launches[1] // 5,
        "max_abs_err": bwd_abs,
        "max_rel_err": bwd_rel,
        "ms": full["bwd"],
        "plain_ms": full["plain_bwd"],
        "bound_ms": full["bwd_bound"][0],
        "bound_by": full["bwd_bound"][1],
        "library_ms": None,
        "device_ms": full["bwd_dev"],
        "train_step_ms": full["step"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
