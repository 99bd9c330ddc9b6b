"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``uob_raytracer_tpu_torch/csrc`` (one nvcc call,
one library) and then, every phase raising on failure and none caught:

1. holds the whole-table forward kernel against its plain torch version on
   the card (twelve 128x16 mode cases, the five baseline configs, the 64x64
   goldens), and its residual outputs against the plain decision record,
   with the shadow quads and, as the trainer launches it, without them;
2. holds the whole-table path-replay backward kernel against its plain
   version (torch autograd through the replay) on the 128x16 mode cases;
3. drives the port's main paths at the full_1024 configuration:
   ``render(cornell_box(), RenderConfig())`` (one forward launch, a row band
   checked against it), and five ``train_step``s on light_pos and tri_rgb
   towards a target rendered with the light moved (one forward and one
   backward launch per step, finite gradients, a falling loss);
4. holds the backward kernel against its plain version at full width (the
   plain version run in eight row bands, its gradients summed), and checks
   that two runs give bit-equal gradients;
5. the large-scene path (the Cornell box plus random small triangles, the
   JAX package's ``bench.py:dense_scene``): holds the streamed forward
   kernel against its plain version at 600 triangles (128x16 mode cases,
   with and without quads, a row band) and at 8,192 (128x128, 2x2 AA, 3
   samples, 2 bounces), and bit for bit against the whole-table kernel on
   the scenes both run; the streamed backward kernel with its segmented
   sum against its plain version at 600 and 8,192 triangles, against the
   whole-table kernel at 600, two runs bit-equal; then drives ``render()``
   on the 8,192-triangle scene at 128x128 and at 512x512, and five
   ``train_step``s on it (one streamed forward, one streamed backward and
   one segmented sum per step, a falling loss);
6. measures the forward of both kernels on dense scenes of 26 to 8,192
   triangles, each kernel wherever it fits (the cut-over curve);
7. times, per baseline config and on the large scene, ``render()``, the
   forward wrapper with and without the record, the backward wrapper,
   ``train_step`` and the plain versions (CUDA events; each kernel's device
   time from torch.profiler).

The line before the last lists each kernel with its launches on its main
path, its worst deviation from the plain version at full width, its times
and its bound: the least time the card could take for the same work, the
larger of bytes / 3.35 TB/s (inputs read once, outputs written once) and
float32 operations / 67 TFLOP/s (NVIDIA's H100 SXM data sheet), with the
operations counted analytically from this run's decision record (see
``fwd_work`` and ``bwd_work``). No single PyTorch call computes a render
kernel's function, so their ``library_ms`` is null; the segmented sum's is
``index_add_``. The last line of standard output is a JSON object with the
device.

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


def dense_scene(n_tri: int, seed: int = 1):
    """The large-scene workload of the JAX package (``bench.py:dense_scene``,
    the same numpy recipe from the same seed): the Cornell box plus random
    small diffuse triangles inside it, ``n_tri`` triangles in all."""
    base = rt.cornell_box()
    rng = np.random.RandomState(seed)
    extra = n_tri - base.num_triangles
    if extra <= 0:
        return base
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    return rt.add_triangles(base, verts, np.full((extra, 3), 0.6, np.float32),
                            np.ones((extra,), np.float32))


def same_frame(a, b) -> bool:
    """Two (image, packed, Residuals) results equal bit for bit."""
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def check_streamed_forward(what, scene, cfg, quads, row0=None, rows=None,
                           against_whole=False):
    """The streamed forward kernel against the plain version (image budget,
    exact pack, record within 0.5%), and, where asked, bit for bit against
    the whole-table kernel. Returns (record, worst pixel deviation)."""
    out = render_fwd.render_fused_res(scene, cfg, row0, rows, quads,
                                      _kernel="streamed")
    ref, _, ref_res = render_fwd.render_fused_res_plain(scene, cfg,
                                                        row0 or 0, rows)
    torch.cuda.synchronize()
    worst, frac = images_match(out[0], ref, what)
    packed_equal(out[1], out[0], what)
    pid, bid, lit = record_matches(out[2], ref_res, what)
    raw = render_fwd.render_fused_raw(scene, cfg, row0, rows, quads,
                                      _kernel="streamed")
    if not torch.equal(raw[0], out[0]):
        raise AssertionError(f"{what}: recording changed the streamed frame")
    tail = ""
    if against_whole:
        whole = render_fwd.render_fused_res(scene, cfg, row0, rows, quads,
                                            _kernel="whole")
        torch.cuda.synchronize()
        if not same_frame(out, whole):
            raise AssertionError(f"{what}: the streamed and the whole-table "
                                 f"kernel differ")
        tail = "; equal to the whole-table kernel bit for bit"
    print(f"streamed forward {what}: worst {worst:.3g}, beyond {TIGHT}: "
          f"{frac:.3%}; record vs plain differs on pid {pid:.3%}, bid "
          f"{bid:.3%}, lit {lit:.3%}{tail}", flush=True)
    return out[2], worst


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


def check_backward(scene, cfg, res, seed: int, what: str, bands: int = 1,
                   kernel=None):
    """A backward kernel (the one the scene routes to, or the one pinned by
    ``kernel``) against its plain version on one record: float32 noise with
    the glass-interior pixels' cotangent zeroed, the conditioning budget
    with all of it. Returns (worst relative, worst absolute) of the full
    run."""
    g = seeded_cotangent((cfg.height, cfg.width, 3), seed)
    runs = [(g, GRAD_TOL_GLASS if cfg.bounces >= 2 else GRAD_TOL)]
    if cfg.bounces >= 2:
        glass = (res.bounce_id >= scene.num_triangles).any(dim=0).any(dim=0)
        runs.append((g * ~glass[:, :, None], GRAD_TOL))
    out = None
    for g_run, tol in runs:
        ref = plain_bwd_banded(scene, cfg, res, g_run, bands)
        got = render_bwd.render_replay_bwd(scene, cfg, res, g_run,
                                           _kernel=kernel)
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
    nbytes = (16 * pix + (rays * (8 + 4 * cfg.bounces) if record else 0)
              + 4 * (19 * n_tri + (13 * n_rows if quads is not None else 0)))
    return nbytes, ops


def bwd_work(cfg, scene, res: Residuals, streamed: bool = False):
    """(bytes, operations) of one backward pass: the primary id, the lit
    count and the cotangent read once, the per-block partial sums written
    once (the whole-table kernel's hold every object, the streamed kernel's
    the spheres and the camera), and of the per-step ids only those the
    replay reads: one per executed step, and one more per chain for the
    entry that ends it; the streamed kernel also reads a 76 B row and
    writes a 64 B cotangent row per site that hit a triangle; per ray the
    primary hit's replay and adjoint and the shading adjoint, per executed
    bounce step its replay, the step's adjoint and the hit's."""
    n_tri = scene.num_triangles
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    chains = int((res.bounce_id[0] >= 0).sum()) if cfg.bounces else 0
    pix = cfg.width * cfg.height
    blocks = -(-pix // render_bwd.THREADS)
    nbytes = rays * 8 + 4 * (steps + chains) + 12 * pix
    if streamed:
        ids = render_bwd.site_ids(res)
        live = int(((ids >= 0) & (ids < n_tri)).sum())
        nbytes += (76 + 64) * live + 4 * blocks * (n_sph * 16 + 21)
    else:
        nbytes += 4 * blocks * ((n_tri + n_sph) * render_bwd.GRAD_COLS + 21)
    ops = rays * 450 + steps * 650
    return nbytes, ops


def segment_sum_work(n_tri: int, ids):
    """(bytes, operations) of the segmented sum after one streamed backward:
    per site that hit a triangle its 8 B position and its 64 B row read and
    16 additions; the bounds read and the sums written once per triangle."""
    live = int(((ids >= 0) & (ids < n_tri)).sum())
    return (8 + 64) * live + (8 + 64) * n_tri, 16 * live


def bound(nbytes, ops) -> tuple[float, str]:
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    render_fwd.LAUNCHES = render_fwd.STREAMED_LAUNCHES = 0
    render_bwd.LAUNCHES = render_bwd.STREAMED_LAUNCHES = 0
    render_bwd.SEGMENT_SUM_LAUNCHES = 0


def counts() -> tuple[int, int, int, int, int]:
    """Launches since the last reset: whole-table forward, streamed forward,
    whole-table backward, streamed backward, segmented sum."""
    return (render_fwd.LAUNCHES, render_fwd.STREAMED_LAUNCHES,
            render_bwd.LAUNCHES, render_bwd.STREAMED_LAUNCHES,
            render_bwd.SEGMENT_SUM_LAUNCHES)


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
    reset_counts()
    out = rt.render(scene, cfg)
    torch.cuda.synchronize()
    launches = render_fwd.LAUNCHES
    if counts() != (1, 0, 0, 0, 0):
        raise AssertionError(f"render(): launch counts {counts()} (whole fwd, "
                             f"streamed fwd, whole bwd, streamed bwd, "
                             f"segmented sum)")
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
    reset_counts()
    live, losses = scene, []
    for step in range(5):
        step_out = train_step(live, target, cfg, lr=2.0,
                              trainable=("light_pos", "tri_rgb"))
        live = step_out.scene
        losses.append(step_out.loss.item())
        if counts() != (step + 1, 0, step + 1, 0, 0):
            raise AssertionError(f"train_step {step}: launch counts "
                                 f"{counts()} so far")
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

    # --- 7. the large-scene path: the streamed kernels ---
    # 7a. the streamed forward equals the whole-table forward bit for bit on
    # the Cornell cases, with and without quads (and holds to the plain one)
    for name, sc, quads, cfg in cases:
        for q in (None, quads):
            res_c, _ = check_streamed_forward(
                f"128x16 cornell {name} quads={q is not None}", sc, cfg, q,
                against_whole=True)
        check_backward(sc, cfg, res_c, seed=20,
                       what=f"128x16 cornell {name}, streamed",
                       kernel="streamed")

    # 7b. 600 triangles, 128x16: the mode cases, quads and no quads, a band
    d600 = dense_scene(600)
    q600 = detect_shadow_quads(d600)
    if q600 is None or not q600[0]:
        raise AssertionError("the dense scene's Cornell walls did not pair")
    mid = dataclasses.replace(small, aa_x=2, aa_y=2, shadow_samples=3,
                              bounces=2)
    cases600 = [
        ("s3 b2", mid),
        ("default", small),
        ("bounces=0", dataclasses.replace(mid, bounces=0)),
        ("quirk_nan_tir", dataclasses.replace(mid, quirk_nan_tir=True)),
        ("fresnel,bounces=4", dataclasses.replace(mid, fresnel=True, bounces=4)),
        ("cpu_ref", dataclasses.replace(mid, cpu_ref=True)),
    ]
    for i, (name, cfg) in enumerate(cases600):
        for q in (None, q600):
            res6, _ = check_streamed_forward(
                f"128x16 600 triangles {name} quads={q is not None}", d600,
                cfg, q, against_whole=True)
        check_backward(d600, cfg, res6, seed=30 + i,
                       what=f"128x16 600 triangles {name}, streamed",
                       kernel="streamed")
    check_streamed_forward("128x16 600 triangles rows [5, 12)", d600, mid,
                           q600, row0=5, rows=7, against_whole=True)

    # the streamed backward against the whole-table backward on the same
    # record: the same per-ray cotangents, summed in another order
    res6 = render_fwd.render_fused_res(d600, mid, _kernel="streamed")[2]
    g6 = seeded_cotangent((mid.height, mid.width, 3), 41)
    by_stream = render_bwd.render_replay_bwd(d600, mid, res6, g6,
                                             _kernel="streamed")
    by_whole = render_bwd.render_replay_bwd(d600, mid, res6, g6,
                                            _kernel="whole")
    torch.cuda.synchronize()
    rel, _, leaf = grad_errors(by_whole, by_stream)
    equal_leaves = [k for k in LEAVES if torch.equal(getattr(by_whole, k),
                                                     getattr(by_stream, k))]
    if rel > 1e-5:
        raise AssertionError(f"streamed vs whole-table backward: {leaf} off "
                             f"by {rel:.3g} relative (budget 1e-5)")
    print(f"streamed vs whole-table backward at 600 triangles: worst {leaf} "
          f"{rel:.3g} relative (budget 1e-5); bit-equal leaves: "
          f"{', '.join(equal_leaves)}", flush=True)

    # 7c. 8,192 triangles at the JAX package's large-scene size
    big = dense_scene(8192)
    q_big = detect_shadow_quads(big)
    cfg_big = RenderConfig(width=128, height=128, aa_x=2, aa_y=2,
                           shadow_samples=3, bounces=2)
    if not render_fwd.use_streamed(big.num_triangles, big.num_spheres):
        raise AssertionError("an 8,192-triangle scene must route to the "
                             "streamed kernels")
    res_big, worst_big = check_streamed_forward(
        "128x128 8192 triangles", big, cfg_big, q_big)
    res_big_t, _ = check_streamed_forward(
        "128x128 8192 triangles without quads", big, cfg_big, None)
    k3b_rel, k3b_abs = check_backward(big, cfg_big, res_big_t, seed=51,
                                      what="128x128 8192 triangles, streamed")
    g_big = seeded_cotangent((128, 128, 3), 51)
    one = render_bwd.render_replay_bwd(big, cfg_big, res_big_t, g_big)
    two = render_bwd.render_replay_bwd(big, cfg_big, res_big_t, g_big)
    torch.cuda.synchronize()
    for k in LEAVES:
        if not torch.equal(getattr(one, k), getattr(two, k)):
            raise AssertionError(f"two streamed backward runs differ in {k}")
    print("streamed backward 8192 triangles: two runs bit-equal on every "
          "leaf", flush=True)

    # the segmented sum against index_add_ (its plain version) on that
    # record's sites, two runs bit-equal
    ids_big = render_bwd.site_ids(res_big_t)
    rows_big = seeded_cotangent((ids_big.numel(), 16), 52)
    seg_one = render_bwd.segment_sum(ids_big, rows_big, big.num_triangles)
    seg_two = render_bwd.segment_sum(ids_big, rows_big, big.num_triangles)
    seg_ref = render_bwd.segment_sum_plain(ids_big, rows_big,
                                           big.num_triangles)
    torch.cuda.synchronize()
    if not torch.equal(seg_one, seg_two):
        raise AssertionError("two segmented sums differ")
    seg_abs = (seg_one - seg_ref).abs().max().item()
    seg_rel = seg_abs / max(seg_ref.abs().max().item(), 1.0)
    if seg_rel > 1e-5:
        raise AssertionError(f"segmented sum off index_add_ by {seg_rel:.3g} "
                             f"relative (budget 1e-5)")
    print(f"segmented sum over {ids_big.numel()} sites into "
          f"{big.num_triangles} rows: two runs bit-equal, {seg_rel:.3g} "
          f"relative off index_add_ (budget 1e-5)", flush=True)

    # 7d. main path three: render() on the 8,192-triangle scene, 128x128 and
    # 512x512 (a 16-row band of the latter held to the plain version)
    reset_counts()
    out_big = rt.render(big, cfg_big)
    torch.cuda.synchronize()
    if counts() != (0, 1, 0, 0, 0):
        raise AssertionError(f"render() on 8,192 triangles: launch counts "
                             f"{counts()} (whole fwd, streamed fwd, whole "
                             f"bwd, streamed bwd, segmented sum)")
    k3f_launches = render_fwd.STREAMED_LAUNCHES
    if tuple(out_big.image.shape) != (128, 128, 3) or not torch.isfinite(
            out_big.image).all():
        raise AssertionError("large-scene frame has the wrong shape or is "
                             "not finite")
    packed_equal(out_big.packed, out_big.image, "large-scene main path")
    bmp = os.path.join(ROOT, "build", "chip_smoke_dense_8192.bmp")
    save_bmp(bmp, out_big.packed)
    cfg_512 = RenderConfig(width=512, height=512, aa_x=1, aa_y=1,
                           shadow_samples=3, bounces=2)
    reset_counts()
    out_512 = rt.render(big, cfg_512)
    torch.cuda.synchronize()
    if counts() != (0, 1, 0, 0, 0):
        raise AssertionError(f"render() at 512x512: launch counts {counts()}")
    r0, n = 248, 16
    band_ref = render_fwd.render_fused_plain(big, cfg_512, row0=r0, rows=n)[0]
    worst, frac = images_match(out_512.image[r0:r0 + n], band_ref,
                               "512x512 8192 triangles rows [248, 264)")
    packed_equal(out_512.packed, out_512.image, "512x512 8192 triangles")
    print(f"large-scene main path: render(dense_scene(8192), 128x128 aa4 s3 "
          f"b2) -> {tuple(out_big.image.shape)}, 1 streamed forward launch, "
          f"mean {out_big.image.mean().item():.4f}, wrote "
          f"{os.path.relpath(bmp, ROOT)}; at 512x512 aa1 1 streamed launch, "
          f"rows [{r0}, {r0 + n}) vs plain worst {worst:.3g}, beyond "
          f"{TIGHT}: {frac:.3%}", flush=True)

    # 7e. main path four: five train_steps on the 8,192-triangle scene
    moved = dataclasses.replace(
        big, light_pos=torch.tensor([0.25, -0.5, -0.7], device="cuda"))
    with torch.no_grad():
        target_big = rt.render_image(moved, cfg_big)
    reset_counts()
    live, losses_big = big, []
    for step in range(5):
        step_out = train_step(live, target_big, cfg_big, lr=2.0,
                              trainable=("light_pos", "tri_rgb"))
        live = step_out.scene
        losses_big.append(step_out.loss.item())
        if counts() != (0, step + 1, 0, step + 1, step + 1):
            raise AssertionError(f"large-scene train_step {step}: launch "
                                 f"counts {counts()}")
        for k in ("light_pos", "tri_rgb"):
            if not torch.isfinite(getattr(live, k)).all():
                raise AssertionError(f"train_step {step}: {k} is not finite")
    torch.cuda.synchronize()
    big_train_launches = counts()
    if not losses_big[4] < losses_big[0]:
        raise AssertionError(f"loss did not fall over 5 steps: {losses_big}")
    print(f"large-scene training path: 5 train_steps at 8192 triangles on "
          f"light_pos, tri_rgb: {big_train_launches[1]} streamed forward, "
          f"{big_train_launches[3]} streamed backward and "
          f"{big_train_launches[4]} segmented-sum launches, no whole-table "
          f"launch, loss {losses_big[0]:.6g} -> {losses_big[4]:.6g}, light "
          f"{[round(v, 4) for v in live.light_pos.tolist()]}", flush=True)

    # --- 8. the cut-over curve: forward device time of both kernels on
    # dense scenes of growing size, each kernel wherever its tables fit, as
    # render() launches it (quads detected); 128x128 aa4 s3 b2 (the sizes and
    # the config of the JAX package's docs/crossover_r05.json), and seven
    # sizes at 512x512 aa1, where many blocks share an SM ---
    def curve(cfg, sizes):
        points = []
        for n_tri in sizes:
            sc = dense_scene(n_tri)
            quads = detect_shadow_quads(sc)
            n_shd = len(quads[0]) + len(quads[1])
            point = {"triangles": n_tri, "whole_ms": None}
            if (render_fwd.shared_bytes(n_tri, sc.num_spheres, n_shd)
                    <= render_fwd.SMEM_BUDGET_BYTES):
                point["whole_ms"] = kernel_device_ms(
                    lambda: render_fwd.render_fused_raw(
                        sc, cfg, quads=quads, _kernel="whole"),
                    "render_fwd_kernel", n=4)
            point["streamed_ms"] = kernel_device_ms(
                lambda: render_fwd.render_fused_raw(
                    sc, cfg, quads=quads, _kernel="streamed"),
                "render_fwd_streamed_kernel", n=4)
            point["routes_to"] = ("streamed" if render_fwd.use_streamed(
                n_tri, sc.num_spheres) else "whole")
            points.append(point)
        return points

    cutover = {
        "128x128 aa4 s3 b2": curve(
            cfg_big, (26, 128, 256, 512, 768, 1024, 2048, 4096, 8192)),
        "512x512 aa1 s3 b2": curve(cfg_512, (256, 320, 384, 448, 512, 768,
                                             1024)),
    }
    print(json.dumps({"cutover_curve_ms": cutover, "card": card}), flush=True)

    # --- 9. timing: CUDA events around one call — render() (quads detected
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

    # the large scene: the same measurements on the streamed path
    def big_fwd():
        return rt.render_image(big, cfg_big, shadow_quads=q_big)

    def big_fwd_train():
        return render_fwd.render_fused_res(big, cfg_big, quads=None)

    def big_bwd():
        return render_bwd.render_replay_bwd(big, cfg_big, res_big_t, g_big)

    def big_step():
        return train_step(big, target_big, cfg_big, lr=1e-3,
                          trainable=("light_pos", "tri_rgb"))

    def big_segsum():
        return render_bwd.segment_sum(ids_big, rows_big, big.num_triangles)

    def median_ms(fn, warmup, n):
        return statistics.median(time_frames(fn, warmup, n))

    detect_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        detect_shadow_quads(big)
        detect_ms.append((time.perf_counter() - t0) * 1e3)
    detect_ms = statistics.median(detect_ms)
    lg = {
        "render": median_ms(lambda: rt.render(big, cfg_big), 2, 5),
        "render_512": median_ms(lambda: rt.render(big, cfg_512), 1, 3),
        "fwd": median_ms(big_fwd, 2, 5),
        "fwd_train": median_ms(big_fwd_train, 2, 5),
        "bwd": median_ms(big_bwd, 2, 5),
        "step": median_ms(big_step, 2, 5),
        "segsum": median_ms(big_segsum, 2, 5),
        "index_add": median_ms(lambda: render_bwd.segment_sum_plain(
            ids_big, rows_big, big.num_triangles), 2, 5),
        "plain": median_ms(lambda: rt.render_image(big, cfg_big,
                                                   backend="torch"), 1, 2),
        "plain_bwd": median_ms(lambda: render_bwd.render_replay_bwd_plain(
            big, cfg_big, res_big_t, g_big), 1, 3),
        "fwd_dev": kernel_device_ms(big_fwd, "render_fwd_streamed_kernel"),
        "fwd_train_dev": kernel_device_ms(big_fwd_train,
                                          "render_fwd_streamed_kernel"),
        "fwd_512_dev": kernel_device_ms(
            lambda: rt.render_image(big, cfg_512, shadow_quads=q_big),
            "render_fwd_streamed_kernel", n=4),
        "bwd_dev": kernel_device_ms(big_bwd, "render_bwd_streamed_kernel"),
        "segsum_dev": kernel_device_ms(big_bwd, "segment_sum_kernel"),
    }
    res_512 = render_fwd.render_fused_res(big, cfg_512, quads=q_big)[2]
    lg["fwd_bound"] = bound(*fwd_work(cfg_big, big, q_big, res_big, False))
    lg["fwd_train_bound"] = bound(*fwd_work(cfg_big, big, None, res_big_t, True))
    lg["fwd_512_bound"] = bound(*fwd_work(cfg_512, big, q_big, res_512, False))
    lg["bwd_bound"] = bound(*bwd_work(cfg_big, big, res_big_t, streamed=True))
    lg["segsum_bound"] = bound(*segment_sum_work(big.num_triangles,
                                                 render_bwd.site_ids(res_big_t)))
    print(f"time dense_8192 128x128 aa4 s3 b2 [{card}]: render() "
          f"{lg['render']:.4f} ms, of which detect_shadow_quads on the host "
          f"{detect_ms:.2f} ms (host clock, median of 3); forward wrapper "
          f"{lg['fwd']:.4f} ms, streamed forward device {lg['fwd_dev']:.4f} "
          f"ms, bound {lg['fwd_bound'][0]:.4f} ms by {lg['fwd_bound'][1]}; as "
          f"train_step launches it (record, no quads): wrapper "
          f"{lg['fwd_train']:.4f} ms, device {lg['fwd_train_dev']:.4f} ms, "
          f"bound {lg['fwd_train_bound'][0]:.4f} ms by "
          f"{lg['fwd_train_bound'][1]}; backward wrapper {lg['bwd']:.4f} ms, "
          f"streamed backward device {lg['bwd_dev']:.4f} ms, bound "
          f"{lg['bwd_bound'][0]:.4f} ms by {lg['bwd_bound'][1]}; segmented "
          f"sum wrapper (sort, bounds, kernel) {lg['segsum']:.4f} ms, kernel "
          f"device {lg['segsum_dev']:.4f} ms, bound "
          f"{lg['segsum_bound'][0]:.4f} ms by {lg['segsum_bound'][1]}, "
          f"index_add_ {lg['index_add']:.4f} ms; train_step {lg['step']:.4f} "
          f"ms; plain forward {lg['plain']:.2f} ms, plain backward "
          f"{lg['plain_bwd']:.2f} ms; at 512x512 aa1: render() "
          f"{lg['render_512']:.4f} ms, streamed forward device "
          f"{lg['fwd_512_dev']:.4f} ms, bound {lg['fwd_512_bound'][0]:.4f} ms "
          f"by {lg['fwd_512_bound'][1]}", flush=True)

    # the whole-table backward past 32 objects at a real size: 600
    # triangles at the large-scene config, beside the streamed backward on
    # the same record
    res6b = render_fwd.render_fused_res(d600, cfg_big, _kernel="whole")[2]
    g6b = seeded_cotangent((128, 128, 3), 61)
    k2p_rel, k2p_abs = check_backward(
        d600, cfg_big, res6b, seed=61,
        what="128x128 600 triangles, whole-table", kernel="whole")

    def bwd600(kernel):
        return lambda: render_bwd.render_replay_bwd(d600, cfg_big, res6b, g6b,
                                                    _kernel=kernel)

    k2p = {
        "ms": median_ms(bwd600("whole"), 2, 5),
        "dev": kernel_device_ms(bwd600("whole"), "render_bwd_kernel"),
        "bound": bound(*bwd_work(cfg_big, d600, res6b)),
        "streamed_ms": median_ms(bwd600("streamed"), 2, 5),
        "streamed_dev": kernel_device_ms(bwd600("streamed"),
                                         "render_bwd_streamed_kernel"),
        "streamed_segsum_dev": kernel_device_ms(bwd600("streamed"),
                                                "segment_sum_kernel"),
        "streamed_bound": bound(*bwd_work(cfg_big, d600, res6b, streamed=True)),
        "plain": median_ms(lambda: render_bwd.render_replay_bwd_plain(
            d600, cfg_big, res6b, g6b), 1, 3),
    }
    print(f"time dense_600 128x128 aa4 s3 b2 backward [{card}]: whole-table "
          f"wrapper {k2p['ms']:.4f} ms, device {k2p['dev']:.4f} ms, bound "
          f"{k2p['bound'][0]:.4f} ms by {k2p['bound'][1]}; streamed wrapper "
          f"{k2p['streamed_ms']:.4f} ms, device {k2p['streamed_dev']:.4f} ms "
          f"+ segmented sum {k2p['streamed_segsum_dev']:.4f} ms, bound "
          f"{k2p['streamed_bound'][0]:.4f} ms by {k2p['streamed_bound'][1]}; "
          f"plain {k2p['plain']:.2f} ms", flush=True)

    full = times["full_1024"]
    src = "uob_raytracer_tpu_torch/csrc/"
    jax_fwd = "uob_raytracer_tpu/kernels/render_fwd.py"
    jax_bwd = "uob_raytracer_tpu/kernels/render_bwd.py"

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd,
              device_ms, library_ms=None, **more):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, "device_ms": device_ms, **more}

    kernels = [
        entry("K1 render_fwd (whole-table)", "render_fwd.cu",
              f"{jax_fwd}:649", launches, worst_by_cfg["full_1024"],
              full["fwd"], full["plain"], full["fwd_bound"], full["fwd_dev"],
              at="full_1024, render()", render_ms=full["render"]),
        entry("K1r render_fwd with residuals", "render_fwd.cu",
              f"{jax_fwd}:670", train_launches[0], worst_by_cfg["full_1024"],
              full["fwd_rec"], full["plain"], full["fwd_train_bound"],
              full["fwd_train_dev"], at="full_1024, 5 train_steps (record, "
              "no quads)", device_ms_with_quads=full["fwd_rec_dev"],
              bound_ms_with_quads=full["fwd_rec_bound"][0]),
        entry("K2 render_bwd (whole-table)", "render_bwd.cu",
              f"{jax_bwd}:366", train_launches[1], bwd_abs, full["bwd"],
              full["plain_bwd"], full["bwd_bound"], full["bwd_dev"],
              at="full_1024, 5 train_steps", max_rel_err=bwd_rel,
              train_step_ms=full["step"]),
        entry("K2' render_bwd past 32 objects", "render_bwd.cu",
              f"{jax_bwd}:126", train_launches[1], k2p_abs, k2p["ms"],
              k2p["plain"], k2p["bound"], k2p["dev"],
              at="the same kernel and count as K2; timed at 600 triangles "
              "128x128 aa4 s3 b2", max_rel_err=k2p_rel,
              streamed_device_ms_same_record=k2p["streamed_dev"],
              streamed_segment_sum_device_ms=k2p["streamed_segsum_dev"]),
        entry("K3f render_fwd_streamed", "render_fwd_streamed.cu",
              f"{jax_fwd}:263", k3f_launches, worst_big, lg["fwd"],
              lg["plain"], lg["fwd_bound"], lg["fwd_dev"],
              at="dense_8192 128x128 aa4 s3 b2, render()",
              render_ms=lg["render"], detect_shadow_quads_host_ms=detect_ms,
              launches_5_train_steps=big_train_launches[1],
              device_ms_train_step=lg["fwd_train_dev"],
              bound_ms_train_step=lg["fwd_train_bound"][0],
              device_ms_512=lg["fwd_512_dev"],
              bound_ms_512=lg["fwd_512_bound"][0],
              render_ms_512=lg["render_512"]),
        entry("K3b render_bwd_streamed", "render_bwd_streamed.cu",
              f"{jax_bwd}:381", big_train_launches[3], k3b_abs, lg["bwd"],
              lg["plain_bwd"], lg["bwd_bound"], lg["bwd_dev"],
              at="dense_8192 128x128 aa4 s3 b2, 5 train_steps",
              max_rel_err=k3b_rel, train_step_ms=lg["step"]),
        entry("segment_sum (K3b's triangle cotangents)",
              "render_bwd_streamed.cu", f"{jax_bwd}:990",
              big_train_launches[4], seg_abs, lg["segsum"], lg["index_add"],
              lg["segsum_bound"], lg["segsum_dev"],
              library_ms=lg["index_add"],
              at="dense_8192 128x128 aa4 s3 b2, 5 train_steps; plain version "
              "= index_add_"),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']}: no launch on its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
