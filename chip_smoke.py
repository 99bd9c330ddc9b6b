"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``uob_raytracer_tpu_torch/csrc`` (one nvcc per
source, all started together, linked into one library) and then, every
phase raising on failure and none caught:

1. holds the whole-table forward kernel against its plain torch version on
   the card (twelve 128x16 mode cases, the five baseline configs, the 64x64
   goldens), and its residual outputs against the plain decision record,
   with the shadow quads and, as the trainer launches it, without them;
   then ``render()`` on the five baseline configs at 256x256 against the
   port's NumPy oracle (``reference.render_oracle``) within PARITY.md's
   budget (``parity_torch.py``'s statistics: % of pixels beyond 3e-4, the
   worst pixel, % of packed words different);
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
   the scenes both run (image, packed image and record: the Cornell mode
   cases; the five baseline configs at 256x256 with the quads and without;
   at 64x64 1, 16 and 33 shadow samples, 1, 4 and 9 AA rays, a width of 50
   and a row band); the streamed backward kernel with its segmented
   sum against its plain version at 600 and 8,192 triangles, against the
   whole-table kernel at 600, two runs bit-equal; then drives ``render()``
   on the 8,192-triangle scene at 128x128 and at 512x512, and five
   ``train_step``s on it (one streamed forward, one streamed backward and
   one segmented sum per step, a falling loss); the segmented sum against
   its float64 value, on that record and on one run of 100,000 equal ids;
   past 16 bounce steps, the deep instances of both backward kernels (the
   chain in a device buffer) on the mirror box (the five walls mirrored,
   the camera inside the box) at 512x512 and on the 600-triangle scene's
   at 256x256, 32 bounces, against the plain version in row bands, timed
   beside the register instance, and ``render_image``'s gradient through
   each; the banded full-size gradient: ``render_image(...)``'s backward on
   the 8,192-triangle scene at full_1024's config (two row bands at the
   2 GiB limit, two runs bit-equal, within 1e-5 of four bands);
6. measures the forward of both kernels on dense scenes of 26 to 8,192
   triangles, each kernel wherever it fits (the cut-over curve);
7. times, per baseline config and on the large scene, ``render()``, the
   forward wrapper with and without the record, the backward wrapper,
   ``train_step`` and the plain versions (CUDA events; each kernel's device
   time from torch.profiler);
8. the sharded path, at 8,192 triangles, 128x128, 2x2 AA, 3 samples, 2
   bounces (the JAX package's ``bench.py:bench_tp`` frame): holds the
   per-shard partial-scan kernels (nearest hit, occlusion) against their
   plain versions on the ray batches that frame gives them, and on a
   600-triangle shard, the nearest-hit ids against the streamed forward
   kernel's record, and the nearest hit's replay backward against
   autograd through the plain version (two runs bit-equal); drives the
   frame on one process (``shade`` with the kernel route and no sharded
   axis: three launches of each kernel), forward and forward+backward,
   against the plain pipeline and the streamed forward kernel's frame;
   then spawns two ranks that share the card (gloo between them: NCCL
   refuses two ranks on one device), ``tp=2`` (4,096 triangles a rank)
   and ``dp=2`` (64 rows a rank, the fused kernels), each through
   ``render_image_sharded`` and five ``train_step``s, and holds rank 0's
   image and gradients to the single-process ones and the ranks' trained
   scenes to each other;
9. the roofline (``flops.py``): holds K6, the FP32 peak chains of
   ``csrc/peak.cu``, to their plain versions in every mode (fma, add, mix,
   bwdmix) and K (1 to 32), the census probe (the JAX test fixture's
   counterpart) to its plain version and its SASS to 5 FMUL + 3 FADD, and
   K7, the structure twin of the backward kernel (``csrc/bwd_twin.cu``),
   sized to the backward's counts on its record, to its plain version at
   the JAX package's roofline config (512x512, 2x2 AA, 10 samples, 1
   bounce) and at full_1024; then, counts from 0, drives
   ``flops.measure_fp32_peak`` over every mode and K with the SM clock
   sampled beside it, the probe, and the twin on both records, and times
   each twin beside the backward kernel on the same record (their ratio,
   registers, spills and SASS census);
10. the live loop (``preview.py``): ``latency_bench``, the headless drive
   of the reference's event loop (key -> camera controller -> light step ->
   ``render()`` -> fetch of the float image to the host), 32 key events at
   256x256 and 512x512 (2x2 AA, 10 samples, 1 bounce: the JAX package's
   record, ``docs/interactive_latency_r05.json``) and at full_1024, with
   K1's device time per frame and the host split (quad detection, the rest
   up to the launch, the fetch); one K1 launch per frame, every frame
   finite, the last frame's scene within the parity budget of the plain
   version, the frame moved by a key; writes
   ``docs/interactive_latency_h100.json``;
11. the bench (``uob_raytracer_tpu_torch/bench.py``): the logical ray
   counts of its seven configs within 0.1% of those ``ROADMAP.md`` records,
   ``bench_config`` on mirror_512 and streamed_8192 (finite gradients,
   every key, finite times), and the headline's JSON line.

The line before the last lists each kernel with its launches on its main
path, its worst deviation from the plain version at full width, its times
and its bound: the least time the card could take for the same work, the
larger of bytes / 3.35 TB/s (inputs read once, outputs written once) and
float32 operations / 67 TFLOP/s (NVIDIA's H100 SXM data sheet), with the
operations counted analytically from this run's decision record
(``flops.fwd_work``, ``flops.bwd_work`` and the rest), and beside it the
same bound against the measured no-FMA peak (the add chain of K6 at K=16:
every kernel is built ``--fmad=false``). No single PyTorch call computes a
render kernel's function, nor K6's or K7's, so their ``library_ms`` is
null; the segmented sum's is ``index_add_``. The last line of standard
output is a JSON object with the device.

Imports neither jax nor the JAX package. Runs on one CUDA card: the first
of those CUDA_VISIBLE_DEVICES lists, or device 0. Every rank it spawns is
joined with a time limit and killed if another fails. Exits non-zero without
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
from uob_raytracer_tpu_torch import bench, flops, preview  # noqa: E402
# the profiler's device times, shared with the bench
from uob_raytracer_tpu_torch.bench import (  # noqa: E402
    k2_device_ms, kernel_device_ms)
# the tp pipeline on one process (the frame of bench.py --tp-bench)
from uob_raytracer_tpu_torch.bench import partial_image as partial_frame  # noqa: E402
# the large-scene workload (the JAX package's bench.py:dense_scene) and the
# mirror box, where chains pass 16 bounce steps
from uob_raytracer_tpu_torch.debug import (  # noqa: E402
    MIRROR_FOCAL, dense_scene, mirror_box)
from uob_raytracer_tpu_torch.flops import (  # noqa: E402
    bound, bwd_work, fwd_work, nearest_work, occluded_work, segment_sum_work)
from uob_raytracer_tpu_torch.kernels import (  # noqa: E402
    _build, bwd_twin, partial, peak, render_bwd, render_fwd)
from uob_raytracer_tpu_torch.ops.image import pack_argb, save_bmp  # noqa: E402
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads  # noqa: E402
from uob_raytracer_tpu_torch.ops.replay import Residuals  # noqa: E402
from uob_raytracer_tpu_torch.parallel import (  # noqa: E402
    make_mesh, multihost, render_image_sharded, train_step)
from uob_raytracer_tpu_torch.reference import pack_argb_np, render_oracle  # noqa: E402
from uob_raytracer_tpu_torch.scene import Scene  # noqa: E402

# the oracle-parity statistics and budget, beside this script
import parity_torch as parity  # noqa: E402

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
LEAVES = tuple(f.name for f in dataclasses.fields(Scene))
# the sharded path's frame (the JAX package's bench.py:streamed_bench_cfg)
CFG_BIG = RenderConfig(width=128, height=128, aa_x=2, aa_y=2,
                       shadow_samples=3, bounces=2)
GRAD_LEAVES = ("light_pos", "light_color", "tri_v0", "tri_v1", "tri_v2",
               "tri_rgb", "camera_pos", "yaw", "pitch")


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


def with_grad(scene, names=GRAD_LEAVES):
    """The scene with fresh leaves ``names`` that require a gradient."""
    return dataclasses.replace(scene, **{
        k: getattr(scene, k).detach().clone().requires_grad_(True)
        for k in names})


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


def median_ms(fn, warmup: int, n: int) -> float:
    return statistics.median(time_frames(fn, warmup, n))


def segment_sum_device_ms(fn, n: int = 10) -> float:
    """Device time of one segmented sum (both of its passes) in each of n
    calls of fn, which makes one."""
    return 2 * kernel_device_ms(fn, "segment_sum_", n=n, per_call=2)


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    render_fwd.LAUNCHES = render_fwd.STREAMED_LAUNCHES = 0
    render_bwd.LAUNCHES = render_bwd.STREAMED_LAUNCHES = 0
    render_bwd.FREE_LAUNCHES = 0
    render_bwd.SEGMENT_SUM_LAUNCHES = 0
    partial.NEAREST_LAUNCHES = partial.OCCLUDED_LAUNCHES = 0
    peak.LAUNCHES = peak.PROBE_LAUNCHES = bwd_twin.LAUNCHES = 0


def partial_counts() -> tuple[int, int]:
    """Launches since the last reset: nearest-hit scan, occlusion scan."""
    return partial.NEAREST_LAUNCHES, partial.OCCLUDED_LAUNCHES


def counts() -> tuple[int, int, int, int, int]:
    """Launches since the last reset: whole-table forward, streamed forward,
    whole-table backward, streamed backward, segmented sum."""
    return (render_fwd.LAUNCHES, render_fwd.STREAMED_LAUNCHES,
            render_bwd.LAUNCHES, render_bwd.STREAMED_LAUNCHES,
            render_bwd.SEGMENT_SUM_LAUNCHES)


# ---------------------------------------------------------------------------
# The sharded path: the wavefront pipeline with its triangle scans in the
# partial-scan kernels, on one process and across ranks
# ---------------------------------------------------------------------------

def loss_and_grads(render_fn, scene, target):
    """(loss, {leaf: gradient}) of the MSE of ``render_fn(scene)`` against
    ``target`` on the nine trainable leaves."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in GRAD_LEAVES}
    img = render_fn(dataclasses.replace(scene, **leaves))
    loss = torch.mean(torch.square(img - target))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(GRAD_LEAVES, grads))


def leaf_errors(ref: dict, got: dict) -> tuple[float, str]:
    """(worst leaf-wise relative error, its leaf) of two gradient dicts."""
    rel, leaf = 0.0, ""
    for k, a in ref.items():
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"gradient of {k} is not finite")
        r = ((a - got[k]).abs().max().item()
             / max(a.abs().max().item(), 1.0))
        if r >= rel:
            rel, leaf = r, k
    return rel, leaf


def recorded_frame(scene, cfg):
    """``partial_frame`` with every call of the two wrappers recorded: the
    image and the argument tuples, in call order, of ``nearest_tris`` (the
    primary batch, then one batch per bounce step) and ``occluded_tris``
    (one batch per shadow sample)."""
    calls = {"nearest": [], "occluded": []}
    real = partial.nearest_tris, partial.occluded_tris

    def keep(name, fn):
        def wrapper(*args):
            calls[name].append(tuple(a.detach() for a in args))
            return fn(*args)
        return wrapper

    partial.nearest_tris = keep("nearest", real[0])
    partial.occluded_tris = keep("occluded", real[1])
    try:
        with torch.no_grad():
            img = partial_frame(scene, cfg)
    finally:
        partial.nearest_tris, partial.occluded_tris = real
    torch.cuda.synchronize()
    return img, calls


def check_partial(what: str, calls):
    """Both partial-scan kernels against their plain versions on recorded
    batches. Winner ids and occlusion bits may differ on at most 0.5% of
    rays (rays on a triangle's edge, or with two hits at one t); where the
    ids agree, t and pos within the image budget's 3e-4 and the gathered
    attributes equal. Returns (worst |t|/|pos| error, worst fraction of
    differing ids, of differing bits, the occlusion outputs)."""
    worst, frac_id, frac_occ, bits = 0.0, 0.0, 0.0, []
    for i, args in enumerate(calls["nearest"]):
        out = partial.nearest_tris(*args)
        torch.cuda.synchronize()
        ref = partial.nearest_tris_plain(*args)
        same = out[5] == ref[5]
        frac_id = max(frac_id, 1.0 - same.float().mean().item())
        hit = same & (ref[5] >= 0)
        err = max((out[0][hit] - ref[0][hit]).abs().max().item(),
                  (out[1][same] - ref[1][same]).abs().max().item())
        worst = max(worst, err)
        if not all(torch.equal(a[same], b[same])
                   for a, b in zip(out[2:5], ref[2:5])):
            raise AssertionError(f"{what}: nearest batch {i}: gathered "
                                 f"attributes differ where the ids agree")
        if not torch.isinf(out[0][out[5] < 0]).all() or (out[5] < -1).any():
            raise AssertionError(f"{what}: nearest batch {i}: a miss is not "
                                 f"t = inf, id -1")
    for i, args in enumerate(calls["occluded"]):
        out = partial.occluded_tris(*args)
        torch.cuda.synchronize()
        ref = partial.occluded_tris_plain(*args)
        frac_occ = max(frac_occ, (out != ref).float().mean().item())
        bits.append(out)
    if max(frac_id, frac_occ) > OUTLIER_FRAC or worst > TIGHT:
        raise AssertionError(
            f"{what}: ids differ on {frac_id:.3%}, bits on {frac_occ:.3%} of "
            f"rays (budget {OUTLIER_FRAC:.1%}); worst t/pos error "
            f"{worst:.3g} (budget {TIGHT})")
    rays = [a[6].shape[0] for a in calls["nearest"]]
    print(f"partial scans {what}: {len(calls['nearest'])} nearest-hit and "
          f"{len(calls['occluded'])} occlusion batches of {rays[0]} rays x "
          f"{calls['nearest'][0][0].shape[0]} triangles vs plain: ids differ "
          f"on {frac_id:.4%}, bits on {frac_occ:.4%} of rays, worst t/pos "
          f"error {worst:.3g}", flush=True)
    return worst, frac_id, frac_occ, bits


def rank_main(rank: int, workdir: str, dp: int, tp: int) -> None:
    """What one spawned rank runs: the frame and five training steps on
    the (dp, tp) mesh, at full width, on the card it shares with the other
    ranks. Writes what it computed to ``rank<r>.pt`` in ``workdir``."""
    mesh = make_mesh(dp=dp, tp=tp)
    scene = dense_scene(8192)
    target = torch.load(os.path.join(workdir, "target.pt")).to(mesh.device)
    _build.load()

    def frame(sc=scene):
        return render_image_sharded(sc, CFG_BIG, mesh)

    def clock(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        frame()                                   # warm-up
        reset_counts()
        img = frame()
        torch.cuda.synchronize()
        frame_counts = counts() + partial_counts()
        frame_ms = clock(frame, 5)
    loss, grads = loss_and_grads(frame, scene, target)
    reset_counts()
    state = {"live": scene, "losses": []}

    def step():
        out = train_step(state["live"], target, CFG_BIG, mesh, lr=2.0,
                         trainable=("light_pos", "tri_rgb"))
        state["live"] = out.scene
        state["losses"].append(out.loss.item())

    step_ms = clock(step, 5)
    live = state["live"]
    torch.save({
        "image": img.cpu(), "loss": loss.cpu(),
        "grads": {k: g.cpu() for k, g in grads.items()},
        "frame_counts": frame_counts,
        "step_counts": counts() + partial_counts(),
        "losses": state["losses"], "frame_ms": frame_ms, "step_ms": step_ms,
        "light_pos": live.light_pos.cpu(), "tri_rgb": live.tri_rgb.cpu(),
    }, os.path.join(workdir, f"rank{rank}.pt"))


def run_ranks(workdir: str, name: str, dp: int, tp: int) -> list[dict]:
    """Two ranks on the (dp, tp) mesh, sharing the card; what each wrote."""
    n = dp * tp
    multihost.spawn_ranks(rank_main, n, f"file://{workdir}/store_{name}",
                          (workdir, dp, tp), timeout_s=300)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(n)]


def same_counts(got, want) -> bool:
    """Launch counts equal wherever ``want`` names one (None: any)."""
    return all(w is None or g == w for g, w in zip(got, want))


def check_ranks(what, outs, ref_img, ref_loss, ref_grads, frame_counts,
                step_counts):
    """Rank 0's image and gradients against the single-process ones, the
    ranks against each other, the launch counts, a falling loss. Returns
    (worst pixel deviation, whether the image is bit-equal, worst gradient
    error)."""
    dev = ref_img.device
    img = outs[0]["image"].to(dev)
    worst, _ = images_match(img, ref_img, what)
    rel, leaf = leaf_errors(ref_grads, {k: g.to(dev) for k, g in
                                        outs[0]["grads"].items()})
    if rel > GRAD_TOL_GLASS:
        raise AssertionError(f"{what}: gradient of {leaf} off the "
                             f"single-process one by {rel:.3g} relative "
                             f"(budget {GRAD_TOL_GLASS})")
    if abs(outs[0]["loss"].item() - ref_loss.item()) > 1e-5 * ref_loss.item():
        raise AssertionError(f"{what}: loss {outs[0]['loss'].item()} vs "
                             f"{ref_loss.item()} on one process")
    for r, o in enumerate(outs):
        if not torch.equal(o["image"], outs[0]["image"]):
            raise AssertionError(f"{what}: rank {r} returned another image")
        for k in ("light_pos", "tri_rgb"):
            if not torch.equal(o[k], outs[0][k]):
                raise AssertionError(f"{what}: rank {r} trained another {k}")
            if not torch.isfinite(o[k]).all():
                raise AssertionError(f"{what}: rank {r}: {k} is not finite")
        if not (same_counts(o["frame_counts"], frame_counts)
                and same_counts(o["step_counts"], step_counts)):
            raise AssertionError(
                f"{what}: rank {r} launched {o['frame_counts']} for a frame "
                f"and {o['step_counts']} in five steps (whole fwd, streamed "
                f"fwd, whole bwd, streamed bwd, segmented sum, nearest hit, "
                f"occlusion); expected {frame_counts} and {step_counts}")
    losses = outs[0]["losses"]
    if not losses[4] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    return worst, torch.equal(img, ref_img), rel


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

    # --- 3b. the five baseline configs at 256x256 against the port's NumPy
    # oracle, PARITY.md's budget (parity_torch.py records every case) ---
    t_oracle = 0.0
    for name, cfg in baseline_configs().items():
        cfg = dataclasses.replace(cfg, width=256, height=256)
        scene = scene_for(cfg)
        out = rt.render(scene, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = render_oracle(scene, cfg)
        t_oracle += time.perf_counter() - t1
        case = {"pct_over_tol": parity.pct_over(out.image, ref),
                "max_dev": parity.max_dev(out.image, ref),
                "packed_mismatch_pct": parity.packed_mismatch_pct(
                    out.packed, pack_argb_np(ref))}
        bad = parity.breaches(case)
        if bad:
            raise AssertionError(f"oracle parity {name} 256x256: "
                                 f"{'; '.join(bad)}")
        print(f"oracle parity {name} 256x256: {case['pct_over_tol']:.4f}% "
              f"beyond {TIGHT}, worst {case['max_dev']:.4g}, packed "
              f"{case['packed_mismatch_pct']:.4f}% differ", flush=True)
    print(f"oracle phase: the NumPy oracle took {t_oracle:.1f} s", flush=True)

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
    train_free = render_bwd.FREE_LAUNCHES
    if train_free != 5:
        raise AssertionError(f"5 train_steps made {train_free} chain-free "
                             f"backward launches")
    if not losses[4] < losses[0]:
        raise AssertionError(f"loss did not fall over 5 steps: {losses}")
    print(f"training path: 5 train_steps at full_1024 on light_pos, tri_rgb: "
          f"{train_launches[0]} forward and {train_launches[1]} + {train_free} "
          f"backward launches (chain, chain-free), loss {losses[0]:.6g} -> {losses[4]:.6g}, light "
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

    # 7a'. the whole-table forward kernel (one thread per AA ray, the
    # hoisted shadow scan) bit for bit against the streamed one: the five
    # baseline configs at 256x256, and at 64x64 the shadow scan's chunks of
    # samples (1, 16, 33), AA counts 1, 4 and 9, a width that is not a
    # multiple of 32 and a row band; each with the quads and without
    c64 = RenderConfig(width=64, height=64)
    k1_cases = [(f"{name} 256x256", *scenes[name],
                 dataclasses.replace(cfg, width=256, height=256), None, None)
                for name, cfg in baseline_configs().items()]
    k1_cases += [(f"64x64 {kw}", cornell, q_cornell,
                  dataclasses.replace(c64, **kw), None, None)
                 for kw in (dict(shadow_samples=1), dict(shadow_samples=16),
                            dict(shadow_samples=33), dict(aa_x=1, aa_y=1),
                            dict(aa_x=3, aa_y=3), dict(width=50))]
    k1_cases.append(("50x64 rows [13, 40)", cornell, q_cornell,
                     dataclasses.replace(c64, width=50), 13, 27))
    for what, sc, quads, cfg, row0, rows in k1_cases:
        for q in (quads, None):
            whole, streamed = (render_fwd.render_fused_res(
                sc, cfg, row0, rows, q, _kernel=k) for k in ("whole", "streamed"))
            torch.cuda.synchronize()
            if not (same_frame(whole, streamed) and torch.equal(
                    whole[0].view(torch.int32), streamed[0].view(torch.int32))):
                raise AssertionError(f"K1 vs K3f {what} quads={q is not None}: "
                                     f"image, packed image or record differ")
    print(f"K1 vs K3f: image, packed image and record bit for bit on "
          f"{2 * len(k1_cases)} frames ({', '.join(c[0] for c in k1_cases)}; "
          f"each with the quads and without)", flush=True)

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
    cfg_big = CFG_BIG
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
    # and against the float64 sum (index_add_ in float64), on this record
    # and on one run of 100,000 equal ids (split over warps in tiles)
    seg64 = render_bwd.segment_sum_plain(ids_big, rows_big.double(),
                                         big.num_triangles)
    ids_run = torch.full((100_000,), 3, dtype=torch.int32, device="cuda")
    rows_run = seeded_cotangent((100_000, 16), 53)
    run_one = render_bwd.segment_sum(ids_run, rows_run, 8)
    run_two = render_bwd.segment_sum(ids_run, rows_run, 8)
    run64 = render_bwd.segment_sum_plain(ids_run, rows_run.double(), 8)
    torch.cuda.synchronize()
    seg_rel64 = ((seg_one.double() - seg64).abs().max()
                 / seg64.abs().max()).item()
    run_rel64 = ((run_one.double() - run64).abs().max()
                 / run64.abs().max()).item()
    if not torch.equal(run_one, run_two) or max(seg_rel64, run_rel64) > 1e-6:
        raise AssertionError(f"segmented sum off its float64 value by "
                             f"{seg_rel64:.3g} (record) and {run_rel64:.3g} "
                             f"(100,000 equal ids) of the sums' magnitude "
                             f"(budget 1e-6), or two runs differ")
    print(f"segmented sum over {ids_big.numel()} sites into "
          f"{big.num_triangles} rows: two runs bit-equal, {seg_rel:.3g} "
          f"relative off index_add_ (budget 1e-5), {seg_rel64:.3g} off the "
          f"float64 sum (budget 1e-6); one run of 100,000 equal ids: two "
          f"runs bit-equal, {run_rel64:.3g} off the float64 sum", flush=True)

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

    # 7f. past 16 bounce steps: the mirror box at 512x512, 32 bounces, the
    # deep instance of the whole-table backward (its chain in a device
    # buffer) against the plain version in eight row bands, timed beside the
    # register instance at 16 bounces on the same scene; the 600-triangle
    # scene's mirror box at 256x256 through the streamed backward's deep
    # instance; and render_image's gradient through each, counts from 0
    def deep_device_ms(fn, kname):
        """The backward's device ms: both launches of the whole-table
        kernels, the streamed kernel alone."""
        if kname == "render_bwd_kernel":
            return sum(k2_device_ms(fn, n=5))
        return kernel_device_ms(fn, kname, n=5)

    deep = {}
    for name, sc, size, bands, kname in (
            ("mirror box", mirror_box(cornell), 512, 8, "render_bwd_kernel"),
            ("600-triangle mirror box", mirror_box(d600), 256, 4,
             "render_bwd_streamed_kernel")):
        cfg_d = RenderConfig(width=size, height=size, aa_x=1, aa_y=1,
                             shadow_samples=2, bounces=32,
                             focal_length=MIRROR_FOCAL)
        res_d = render_fwd.render_fused_res(sc, cfg_d)[2]
        hits = (res_d.bounce_id >= 0).sum(dim=(1, 2, 3))
        past = int(hits[render_bwd.REG_BOUNCES:].sum())
        if not past:
            raise AssertionError(f"{name}: no chain past "
                                 f"{render_bwd.REG_BOUNCES} bounce steps")
        rel_d, abs_d = check_backward(
            sc, cfg_d, res_d, seed=71,
            what=f"{size}x{size} {name}, 32 bounces (deep instance; plain "
            f"in {bands} bands)", bands=bands)
        g_d = seeded_cotangent((size, size, 3), 71)
        cfg_r = dataclasses.replace(cfg_d, bounces=render_bwd.REG_BOUNCES)
        res_r = render_fwd.render_fused_res(sc, cfg_r)[2]
        d = {"rel": rel_d, "abs": abs_d, "hits": int(hits.sum()),
             "cfg": cfg_d, "scene": sc,
             "past": past, "hits_reg": int((res_r.bounce_id >= 0).sum()),
             "dev": deep_device_ms(lambda: render_bwd.render_replay_bwd(
                 sc, cfg_d, res_d, g_d), kname),
             "dev_reg": deep_device_ms(lambda: render_bwd.render_replay_bwd(
                 sc, cfg_r, res_r, g_d), kname),
             "ms": median_ms(lambda: render_bwd.render_replay_bwd(
                 sc, cfg_d, res_d, g_d), 1, 3),
             "plain": median_ms(lambda: plain_bwd_banded(
                 sc, cfg_d, res_d, g_d, bands), 0, 1),
             "work": bwd_work(cfg_d, sc, res_d,
                              streamed=kname != "render_bwd_kernel")}
        live = with_grad(sc, ("light_pos", "tri_rgb"))
        reset_counts()
        grads = torch.autograd.grad(
            (rt.render_image(live, cfg_d) * g_d).sum(),
            [live.light_pos, live.tri_rgb])
        torch.cuda.synchronize()
        d["counts"] = counts()
        d["free"] = render_bwd.FREE_LAUNCHES
        want = ((1, 0, 1, 0, 0) if kname == "render_bwd_kernel"
                else (0, 1, 0, 1, 1))
        want_free = int(kname == "render_bwd_kernel" and render_bwd.splits(
            cfg_d, size, sc.num_triangles + sc.num_spheres))
        if (d["counts"] != want or d["free"] != want_free or not all(
                    torch.isfinite(t).all()
                                          for t in grads)):
            raise AssertionError(f"{name}: render_image's gradient at 32 "
                                 f"bounces: launch counts {d['counts']}, "
                                 f"chain-free {d['free']}, "
                                 f"finite {[bool(torch.isfinite(t).all()) for t in grads]}")
        deep[name] = d
        print(f"deep bounces {name} {size}x{size} 32 bounces [{card}]: "
              f"{d['hits']} bounce-step hits, {past} past step "
              f"{render_bwd.REG_BOUNCES}; deep {kname} device "
              f"{d['dev']:.4f} ms = {d['dev'] * 1e6 / d['hits']:.2f} ns per "
              f"bounce-step hit (the register instance at 16 bounces on the "
              f"same scene {d['dev_reg']:.4f} ms, {d['hits_reg']} hits, "
              f"{d['dev_reg'] * 1e6 / d['hits_reg']:.2f} ns per hit); "
              f"wrapper {d['ms']:.4f} ms; render_image gradient: launch "
              f"counts {d['counts']}, finite", flush=True)

    # 7g. the banded full-size gradient: dense_8192 at full_1024's config
    # (1024x1024, 2x2 AA, 10 samples, 10 bounces: 2.95 GB of per-site rows,
    # two bands at the 2 GiB limit) through render_image's backward, counts
    # from 0; then on the same record two banded runs bit-equal, and the
    # limit lowered to force four bands, within 1e-5
    cfg_full = RenderConfig()
    g_full = seeded_cotangent((1024, 1024, 3), 81)
    bands_full = render_bwd._row_bands(1024, 1024, 4, 10, 2 * 16 + 21, True)
    if len(bands_full) != 2:
        raise AssertionError(f"dense_8192 at full_1024: bands {bands_full}")
    live = with_grad(big)
    reset_counts()
    t_full = time.perf_counter()
    img_full = rt.render_image(live, cfg_full)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t_full
    grads_full = torch.autograd.grad((img_full * g_full).sum(),
                                     [getattr(live, k) for k in GRAD_LEAVES])
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t_full - t_fwd
    full_counts = counts()
    if full_counts != (0, 1, 0, 2, 2) or not all(
            torch.isfinite(t).all() for t in grads_full):
        raise AssertionError(f"dense_8192 at full_1024: launch counts "
                             f"{full_counts} (want one forward, two bands), "
                             f"finite {[bool(torch.isfinite(t).all()) for t in grads_full]}")
    del img_full, grads_full
    res_full = render_fwd.render_fused_res(big, cfg_full, quads=None)[2]
    banded = [render_bwd.render_replay_bwd(big, cfg_full, res_full, g_full)
              for _ in range(2)]
    limit = render_bwd.MAX_DLANE_BYTES
    render_bwd.MAX_DLANE_BYTES = 4 * 16 * 11 * 4 * 1024 * 256
    try:
        four = render_bwd.render_replay_bwd(big, cfg_full, res_full, g_full)
        bands_four = render_bwd._row_bands(1024, 1024, 4, 10, 2 * 16 + 21,
                                           True)
    finally:
        render_bwd.MAX_DLANE_BYTES = limit
    torch.cuda.synchronize()
    if len(bands_four) != 4:
        raise AssertionError(f"forced bands: {bands_four}")
    for k in LEAVES:
        if not torch.equal(getattr(banded[0], k), getattr(banded[1], k)):
            raise AssertionError(f"two banded full-size gradients differ in "
                                 f"{k}")
    full_rel, _, full_leaf = grad_errors(four, banded[0])
    if full_rel > 1e-5:
        raise AssertionError(f"two bands vs four at full size: {full_leaf} "
                             f"off by {full_rel:.3g} (budget 1e-5)")
    full_bwd_ms = median_ms(lambda: render_bwd.render_replay_bwd(
        big, cfg_full, res_full, g_full), 0, 2)
    del res_full, banded, four
    print(f"banded full-size gradient [{card}]: dense_8192 at full_1024's "
          f"config, render_image forward {t_fwd * 1e3:.1f} ms and backward "
          f"{t_full * 1e3:.1f} ms (host clock, first call), launch counts "
          f"{full_counts}, bands {bands_full}, finite; two banded runs "
          f"bit-equal; four bands {bands_four} vs two: worst {full_leaf} "
          f"{full_rel:.3g} relative (budget 1e-5); backward wrapper "
          f"{full_bwd_ms:.1f} ms (CUDA events, median of 2)", flush=True)

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
        med["bwd_chain_dev"], med["bwd_free_dev"] = k2_device_ms(bwd)
        med["bwd_dev"] = med["bwd_chain_dev"] + med["bwd_free_dev"]
        med["fwd_work"] = fwd_work(cfg, scene, quads, res, False)
        med["fwd_bound"] = bound(*med["fwd_work"])
        med["fwd_rec_work"] = fwd_work(cfg, scene, quads, res, True)
        med["fwd_rec_bound"] = bound(*med["fwd_rec_work"])
        med["fwd_train_work"] = fwd_work(cfg, scene, None, res, True)
        med["fwd_train_bound"] = bound(*med["fwd_train_work"])
        med["bwd_work"] = bwd_work(cfg, scene, res)
        med["bwd_bound"] = bound(*med["bwd_work"])
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
              f"{max(t['bwd']):.4f}), device {med['bwd_dev']:.4f} ms (chain "
              f"launch {med['bwd_chain_dev']:.4f}, chain-free launch "
              f"{med['bwd_free_dev']:.4f}), bound "
              f"{med['bwd_bound'][0]:.4f} ms by {med['bwd_bound'][1]}; "
              f"train_step {med['step']:.4f} ms (min {min(t['step']):.4f}, max "
              f"{max(t['step']):.4f}); plain forward {med['plain']:.2f} ms, "
              f"plain backward {med['plain_bwd']:.2f} ms"
              f"{' (in 8 row bands)' if name == 'full_1024' else ''} (n=3)",
              flush=True)

    # K1 at the bench's headline (512x512, 2x2 AA, 10 samples, 1 bounce),
    # as render() launches it
    hcfg = bench.ROOFLINE_CFG
    res_h = render_fwd.render_fused_res(cornell, hcfg, quads=q_cornell)[2]
    k1_head = {"dev": kernel_device_ms(lambda: render_fwd.render_fused_raw(
        cornell, hcfg, quads=q_cornell), "render_fwd_kernel"),
               "work": fwd_work(hcfg, cornell, q_cornell, res_h, False),
               "work_per_sample": fwd_work(hcfg, cornell, q_cornell, res_h,
                                           False, per_sample=True)}
    print(f"time K1 at the headline 512x512 aa4 s10 b1 [{card}]: device "
          f"{k1_head['dev']:.4f} ms, bound {bound(*k1_head['work'])[0]:.4f} "
          f"ms ({bound(*k1_head['work_per_sample'])[0]:.4f} at the per-sample "
          f"count)", flush=True)

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
        "segsum_dev": segment_sum_device_ms(big_bwd),
    }
    res_512 = render_fwd.render_fused_res(big, cfg_512, quads=q_big)[2]
    lg["fwd_work"] = fwd_work(cfg_big, big, q_big, res_big, False)
    lg["fwd_bound"] = bound(*lg["fwd_work"])
    lg["fwd_train_work"] = fwd_work(cfg_big, big, None, res_big_t, True)
    lg["fwd_train_bound"] = bound(*lg["fwd_train_work"])
    lg["fwd_512_work"] = fwd_work(cfg_512, big, q_big, res_512, False)
    lg["fwd_512_bound"] = bound(*lg["fwd_512_work"])
    lg["bwd_work"] = bwd_work(cfg_big, big, res_big_t, streamed=True)
    lg["bwd_bound"] = bound(*lg["bwd_work"])
    lg["segsum_work"] = segment_sum_work(big.num_triangles,
                                                 render_bwd.site_ids(res_big_t))
    lg["segsum_bound"] = bound(*lg["segsum_work"])
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
        "work": bwd_work(cfg_big, d600, res6b),
        "streamed_ms": median_ms(bwd600("streamed"), 2, 5),
        "streamed_dev": kernel_device_ms(bwd600("streamed"),
                                         "render_bwd_streamed_kernel"),
        "streamed_segsum_dev": segment_sum_device_ms(bwd600("streamed")),
        "streamed_work": bwd_work(cfg_big, d600, res6b, streamed=True),
        "plain": median_ms(lambda: render_bwd.render_replay_bwd_plain(
            d600, cfg_big, res6b, g6b), 1, 3),
    }
    k2p["bound"] = bound(*k2p["work"])
    k2p["streamed_bound"] = bound(*k2p["streamed_work"])
    print(f"time dense_600 128x128 aa4 s3 b2 backward [{card}]: whole-table "
          f"wrapper {k2p['ms']:.4f} ms, device {k2p['dev']:.4f} ms, bound "
          f"{k2p['bound'][0]:.4f} ms by {k2p['bound'][1]}; streamed wrapper "
          f"{k2p['streamed_ms']:.4f} ms, device {k2p['streamed_dev']:.4f} ms "
          f"+ segmented sum {k2p['streamed_segsum_dev']:.4f} ms, bound "
          f"{k2p['streamed_bound'][0]:.4f} ms by {k2p['streamed_bound'][1]}; "
          f"plain {k2p['plain']:.2f} ms", flush=True)

    # --- 10. the sharded path: the partial-scan kernels (nearest hit,
    # occlusion), the frame through them on one process, and two ranks
    # sharing the card ---
    # 10a. the kernels against their plain versions on the batches the
    # full-width frame gives them, and on a 600-triangle shard
    img_p, calls = recorded_frame(big, CFG_BIG)
    if (len(calls["nearest"]), len(calls["occluded"])) != (3, 3):
        raise AssertionError("the frame made "
                             f"{len(calls['nearest'])} nearest-hit and "
                             f"{len(calls['occluded'])} occlusion calls")
    k4_err, k4_frac, k5_frac, bits_big = check_partial(
        "8192 triangles 128x128 aa4 s3 b2", calls)
    _, calls600 = recorded_frame(d600, mid)
    check_partial("600 triangles 128x16 aa4 s3 b2", calls600)
    # the primary batch's winners against the streamed forward kernel's
    # record of the same frame (its shared-origin primary test rounds
    # differently from the general test; a sphere in front wins there)
    pid = res_big_t.prim_id                               # [A, H, W]
    idx_prim = partial.nearest_tris(*calls["nearest"][0])[5].reshape(
        CFG_BIG.height, CFG_BIG.width, CFG_BIG.aa_rays).permute(2, 0, 1)
    tri_won = pid < big.num_triangles                     # a triangle or a miss
    pid_frac = (idx_prim[tri_won] != pid[tri_won]).float().mean().item()
    if pid_frac > OUTLIER_FRAC:
        raise AssertionError(f"nearest-hit ids differ from the streamed "
                             f"forward kernel's record on {pid_frac:.3%} of "
                             f"primary rays (budget {OUTLIER_FRAC:.1%})")
    print(f"nearest-hit ids of the primary batch vs the streamed forward "
          f"kernel's record: differ on {pid_frac:.4%} of the "
          f"{int(tri_won.sum())} rays no sphere wins", flush=True)

    # 10b. the nearest hit's replay backward against autograd through the
    # plain version (4,096 rays of the first bounce batch: the plain
    # version keeps every [rays, triangles] intermediate for its backward),
    # and two runs on the whole batch bit-equal
    def nearest_grads(fn, args, n_rays, seed):
        ins = [a[:n_rays].clone().requires_grad_(True) if i >= 6
               else a.clone().requires_grad_(True) for i, a in enumerate(args)]
        out = fn(*ins)
        cts = [seeded_cotangent(o.shape, seed + j) for j, o in
               enumerate(out[:4])]
        t_hit = torch.where(out[5] >= 0, out[0], 0.0)     # t is inf on a miss
        loss = sum((o * c).sum() for o, c in zip((t_hit, *out[1:4]), cts))
        names = ("v0", "e1", "e2", "n", "rgb", "start", "d")
        return dict(zip(names, torch.autograd.grad(
            loss, [x for i, x in enumerate(ins) if i != 5])))

    bounce = calls["nearest"][1]
    k4_bwd_rel, leaf = leaf_errors(
        nearest_grads(partial.nearest_tris_plain, bounce, 4096, 71),
        nearest_grads(partial.nearest_tris, bounce, 4096, 71))
    if k4_bwd_rel > GRAD_TOL:
        raise AssertionError(f"nearest-hit backward: {leaf} off the plain "
                             f"version's by {k4_bwd_rel:.3g} (budget "
                             f"{GRAD_TOL})")
    n_all = bounce[6].shape[0]
    one = nearest_grads(partial.nearest_tris, bounce, n_all, 72)
    two = nearest_grads(partial.nearest_tris, bounce, n_all, 72)
    torch.cuda.synchronize()
    for k in one:
        if not torch.equal(one[k], two[k]):
            raise AssertionError(f"two nearest-hit backward runs differ in {k}")
    print(f"nearest-hit backward vs autograd through the plain version "
          f"(4096 rays x 8192 triangles): worst {leaf} {k4_bwd_rel:.3g} "
          f"relative (budget {GRAD_TOL}); two runs on {n_all} rays bit-equal "
          f"(the row sum is the segmented sum, no atomics)", flush=True)

    # 10c. main path five: the frame on one process, shade with the kernel
    # route and no sharded axis (the JAX package's bench_tp), forward and
    # forward+backward
    reset_counts()
    with torch.no_grad():
        img_one = partial_frame(big, CFG_BIG)
    torch.cuda.synchronize()
    k4_launches, k5_launches = partial_counts()
    if (k4_launches, k5_launches) != (1 + CFG_BIG.bounces,
                                      CFG_BIG.shadow_samples) or any(counts()):
        raise AssertionError(f"one-process frame: {partial_counts()} "
                             f"nearest-hit and occlusion launches, {counts()} "
                             f"of the fused kernels")
    if not torch.equal(img_one, img_p) or not torch.isfinite(img_one).all():
        raise AssertionError("two runs of the one-process frame differ")
    with torch.no_grad():
        plain_big = render_fwd.render_fused_plain(big, CFG_BIG)[0]
        k3f_big = rt.render_image(big, CFG_BIG)           # no quads
    w_plain, f_plain = images_match(img_one, plain_big,
                                    "one-process frame vs plain pipeline")
    w_k3f, f_k3f = images_match(img_one, k3f_big, "one-process frame vs the "
                                "streamed forward kernel's frame")
    loss_one, grads_one = loss_and_grads(
        lambda sc: partial_frame(sc, CFG_BIG), big, target_big)
    loss_fused, grads_fused = loss_and_grads(
        lambda sc: rt.render_image(sc, CFG_BIG), big, target_big)
    rel_fused, leaf = leaf_errors(grads_fused, grads_one)
    if rel_fused > GRAD_TOL_GLASS:
        raise AssertionError(f"one-process frame: gradient of {leaf} off the "
                             f"fused path's by {rel_fused:.3g} (budget "
                             f"{GRAD_TOL_GLASS})")
    print(f"sharded path on one process: shade(kernel route) on "
          f"dense_scene(8192) 128x128 aa4 s3 b2 -> {tuple(img_one.shape)}, "
          f"{k4_launches} nearest-hit and {k5_launches} occlusion launches; "
          f"vs plain pipeline worst {w_plain:.3g}, beyond {TIGHT}: "
          f"{f_plain:.3%}; vs the streamed forward kernel's frame worst "
          f"{w_k3f:.3g}, beyond {TIGHT}: {f_k3f:.3%}; gradients of the nine "
          f"leaves vs the fused path (streamed backward kernel): worst "
          f"{leaf} {rel_fused:.3g} relative", flush=True)

    # 10d. main path six: two ranks sharing this card, tp=2 through the
    # partial-scan kernels and the combine, then dp=2 through the fused
    # kernels on row bands; five train_steps each
    workdir = os.path.join(ROOT, "build", "chip_smoke_ranks")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        os.remove(os.path.join(workdir, name))
    torch.save(target_big.cpu(), os.path.join(workdir, "target.pt"))
    via = multihost.transport(2, torch.cuda.device_count())
    t0 = time.perf_counter()
    tp_outs = run_ranks(workdir, "tp", dp=1, tp=2)
    tp_s = time.perf_counter() - t0
    tp_worst, tp_equal, tp_rel = check_ranks(
        "tp=2", tp_outs, img_one, loss_one, grads_one,
        (0, 0, 0, 0, 0, 3, 3), (0, 0, 0, 0, None, 15, 15))
    t0 = time.perf_counter()
    dp_outs = run_ranks(workdir, "dp", dp=2, tp=1)
    dp_s = time.perf_counter() - t0
    dp_worst, dp_equal, dp_rel = check_ranks(
        "dp=2", dp_outs, k3f_big, loss_fused, grads_fused,
        (0, 1, 0, 0, 0, 0, 0), (0, 5, 0, 5, 5, 0, 0))
    ranks = {}
    for name, outs, worst, equal, rel, secs in (
            ("tp=2", tp_outs, tp_worst, tp_equal, tp_rel, tp_s),
            ("dp=2", dp_outs, dp_worst, dp_equal, dp_rel, dp_s)):
        o = outs[0]
        ranks[name] = {"frame_ms": statistics.median(o["frame_ms"]),
                       "step_ms": statistics.median(o["step_ms"][1:])}
        print(f"sharded path across ranks [{card}]: {name}, two processes "
              f"sharing the one card, {via} between them (staged through "
              f"the host): rank 0's image vs the single-process frame worst "
              f"{worst:.3g}{' (bit-equal)' if equal else ''}, gradients "
              f"worst {rel:.3g} relative; launches per frame "
              f"{o['frame_counts']}, in five steps {o['step_counts']} (whole "
              f"fwd, streamed fwd, whole bwd, streamed bwd, segmented sum, "
              f"nearest hit, occlusion); loss {o['losses'][0]:.6g} -> "
              f"{o['losses'][4]:.6g}, both ranks' light_pos and tri_rgb "
              f"equal; frame {ranks[name]['frame_ms']:.2f} ms, train_step "
              f"{ranks[name]['step_ms']:.2f} ms (host clock, medians; they "
              f"say nothing of two cards); {secs:.1f} s with the spawn",
              flush=True)

    # 10e. timing the partial scans and the one-process frame
    def one_fwd():
        with torch.no_grad():
            return partial_frame(big, CFG_BIG)

    def one_fwd_bwd():
        return loss_and_grads(lambda sc: partial_frame(sc, CFG_BIG), big,
                              target_big)

    prim, shadow = calls["nearest"][0], calls["occluded"][0]
    n_rays = prim[6].shape[0]
    pt = {
        "fwd": median_ms(one_fwd, 2, 5),
        "fwd_bwd": median_ms(one_fwd_bwd, 1, 5),
        "fused_fwd_bwd": median_ms(lambda: loss_and_grads(
            lambda sc: rt.render_image(sc, CFG_BIG), big, target_big), 1, 5),
        "k4": median_ms(lambda: partial.nearest_tris(*prim), 2, 5),
        "k5": median_ms(lambda: partial.occluded_tris(*shadow), 2, 5),
        "k4_plain": median_ms(lambda: partial.nearest_tris_plain(*prim), 1, 2),
        "k5_plain": median_ms(lambda: partial.occluded_tris_plain(*shadow),
                              1, 2),
        "k4_dev": kernel_device_ms(one_fwd, "nearest_tris_kernel", n=4,
                                   per_call=3),
        "k5_dev": kernel_device_ms(one_fwd, "occluded_tris_kernel", n=4,
                                   per_call=3),
    }
    pt["k4_work"] = nearest_work(big.num_triangles, n_rays)
    pt["k4_bound"] = bound(*pt["k4_work"])
    k5_works = [occluded_work(big.num_triangles, b) for b in bits_big]
    pt["k5_work"] = (sum(w[0] for w in k5_works) / len(k5_works),
                     sum(w[1] for w in k5_works) / len(k5_works))
    pt["k5_bound"] = bound(*pt["k5_work"])
    lit_share = 1.0 - torch.stack(bits_big).float().mean().item()
    # what one thread per ray spends its lane-rows on (flops.occluded_lanes)
    firsts = [flops.first_occluder(*a) for a in calls["occluded"]]
    k5_lanes = {s: [flops.occluded_lanes(f, big.num_triangles, s)
                    for f in firsts] for s in ("pr6", "pr7")}
    print("K5 lanes on the three occlusion batches: "
          + "; ".join(f"{s}: used {[round(x['used'], 4) for x in v]}, row "
                      f"order {[round(x['row_order'], 4) for x in v]}"
                      for s, v in k5_lanes.items()), flush=True)
    print(f"time sharded path on one process, dense_8192 128x128 aa4 s3 b2 "
          f"[{card}]: frame (3 nearest-hit + 3 occlusion launches and the "
          f"torch shading between them) {pt['fwd']:.4f} ms, forward+backward "
          f"on nine leaves {pt['fwd_bwd']:.4f} ms (the fused path's, "
          f"streamed kernels: {pt['fused_fwd_bwd']:.4f} ms); nearest-hit "
          f"kernel device {pt['k4_dev']:.4f} ms a launch ({n_rays} rays x "
          f"{big.num_triangles} rows), bound {pt['k4_bound'][0]:.4f} ms by "
          f"{pt['k4_bound'][1]}, wrapper {pt['k4']:.4f} ms, plain "
          f"{pt['k4_plain']:.2f} ms; occlusion kernel device "
          f"{pt['k5_dev']:.4f} ms a launch ({lit_share:.1%} of the shadow "
          f"rays lit, which scan every row), bound {pt['k5_bound'][0]:.4f} ms "
          f"by {pt['k5_bound'][1]}, wrapper {pt['k5']:.4f} ms, plain "
          f"{pt['k5_plain']:.2f} ms", flush=True)

    # --- 11. the roofline: K6, the FP32 peak chains (every mode and K held
    # to its plain version, then timed: the card's no-FMA ceiling), the
    # census probe (the JAX test fixture's counterpart), and K7, the
    # structure twin of K2, at the JAX package's roofline config
    # (bench.py:837-838) and at full_1024, held to its plain version and
    # timed beside K2 ---
    # 11a. K6 against its plain version on a seeded input of the timed shape
    jitter = 1.0 - 1e-4 * np.random.RandomState(81).uniform(
        size=flops.PEAK_SHAPE)
    k6_match, k6_err = {}, 0.0
    for mode in peak.MODES:
        x = torch.from_numpy(((0.001 if mode == "add" else 0.99999) * jitter)
                             .astype(np.float32)).cuda()
        for k in peak.KS:
            got = peak.peak_chain(mode, k, x)
            want = peak.peak_chain_plain(mode, k, x)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"K6 {mode} K={k}: not finite")
            ulps = int((got.view(torch.int32) - want.view(torch.int32))
                       .abs().max())
            if ulps > (1 if mode == "fma" else 0):
                raise AssertionError(f"K6 {mode} K={k}: {ulps} ulp off its "
                                     f"plain version (budget "
                                     f"{1 if mode == 'fma' else 0})")
            k6_err = max(k6_err, (got - want).abs().max().item())
            k6_match[mode, k] = "bit-equal" if ulps == 0 else f"{ulps} ulp"
    print(f"K6 peak chains vs plain, {len(k6_match)} instances on 512x512: "
          f"fma within 1 ulp (plain in float64, rounded once), add, mix and "
          f"bwdmix bit-equal; worst {k6_err:.3g}", flush=True)

    # 11b. the census probe: its values, and 5 FMUL + 3 FADD in its SASS,
    # the 8 operations the JAX census counts for the same body
    xp = torch.from_numpy(np.linspace(0.5, 1.5, 8 * 128, dtype=np.float32)
                          ).cuda()
    probe_out = peak.census_probe(xp)
    if not torch.equal(probe_out, peak.census_probe_plain(xp)):
        raise AssertionError("census probe differs from its plain version")
    probe = flops.sass_census("census_probe_kernel")
    if (probe["opcodes"].get("FMUL"), probe["opcodes"].get("FADD"),
            probe["fp32"]) != (5, 3, 8):
        raise AssertionError(f"census probe SASS: {probe['opcodes']}")
    print(f"census probe: bit-equal to its plain version; SASS {probe['fp32']} "
          f"FP32 instructions (FMUL {probe['opcodes']['FMUL']}, FADD "
          f"{probe['opcodes']['FADD']}) = the JAX census's 8.0 ops per lane; "
          f"int {probe['int']}, mem {probe['mem']}, control "
          f"{probe['control']}, other {probe['other']}", flush=True)

    # 11c. K7 against its plain version, sized to K2's counts on each record
    cfg_roof = RenderConfig(width=512, height=512, aa_x=2, aa_y=2,
                            shadow_samples=10, bounces=1)
    res_roof = render_fwd.render_fused_res(cornell, cfg_roof, quads=None)[2]
    k2_res = flops.kernel_resources("render_bwd_kernel<false>")
    n_obj = cornell.num_triangles + cornell.num_spheres
    twins = {}
    for tname, tcfg, tres in (("512x512 aa4 s10 b1", cfg_roof, res_roof),
                              ("full_1024", RenderConfig(),
                               records["full_1024"])):
        targets = flops.bwd_twin_targets(cornell, tcfg, tres)
        twin = flops.build_bwd_structure_twin(
            cornell, tcfg, tres, **targets,
            target_registers=k2_res["registers"])
        sums, img = twin["run"]()
        ref = twin["run_plain"]()
        torch.cuda.synchronize()
        rel = ((sums.double() - ref["sums"]).abs()
               / ref["abs_sums"].clamp(min=1e-30)).max().item()
        visits = sums[:n_obj * 16].reshape(n_obj, 16)[:, 15].round().long()
        img_rel = ((img - ref["img"]).abs()
                   / ref["img"].abs().clamp(min=1e-30)).max().item()
        if (rel > 1e-5 or img_rel > 1e-5 or not torch.equal(
                visits, ref["visits"]) or not torch.isfinite(sums).all()):
            raise AssertionError(
                f"K7 at {tname}: sums off the plain version by {rel:.3g} of "
                f"their terms' magnitudes (budget 1e-5), image by "
                f"{img_rel:.3g}, visits equal: "
                f"{torch.equal(visits, ref['visits'])}")
        g_t = seeded_cotangent((tcfg.height, tcfg.width, 3), 91)
        twins[tname] = {
            "twin": twin, "cfg": tcfg, "res": tres, "rel": rel,
            "abs": (sums.double() - ref["sums"]).abs().max().item(),
            "img_equal": torch.equal(img, ref["img"]), "targets": targets,
            "resources": flops.kernel_resources(bwd_twin.symbol(
                twin["n_pool"])),
            "k2": lambda c=tcfg, r=tres, gg=g_t: render_bwd.render_replay_bwd(
                cornell, c, r, gg)}
        print(f"K7 structure twin at {tname}: vs plain, sums within {rel:.3g} "
              f"of their terms' magnitudes (budget 1e-5), visits exact "
              f"({int(visits.sum())} sites), image "
              f"{'bit-equal' if twins[tname]['img_equal'] else f'within {img_rel:.3g}'}"
              f"; sizing n_main {twin['n_main']}, n_step {twin['n_step']}, "
              f"slots {twin['slots']}, divs {twin['divs']}, pool "
              f"{twin['n_pool']}; per ray {twin['census_per_lane']} ops "
              f"(K2 {twin['target_per_lane']}), depth {twin['depth']} "
              f"(K2 {twin['target_depth']}), weighted depth {twin['wdepth']} "
              f"(K2 {twin['target_wdepth']}), slow {twin['slow_per_lane']} "
              f"(K2 {twin['target_slow_per_lane']}), bounce steps per ray "
              f"{targets['live']:.4f}", flush=True)

    # 11d. the roofline's main path, counts from 0: the peak curve (every
    # mode and K), the census probe, the twin on both records; the SM clock
    # and the power sampled beside it
    smi = subprocess.Popen(
        ["nvidia-smi", f"--id={DEVICE_ID}", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        reset_counts()
        t_roof = time.perf_counter()
        peaks = flops.measure_fp32_peak(iters=20, ks=peak.KS)
        peak.census_probe(xp)
        for t in twins.values():
            t["twin"]["run"]()
        torch.cuda.synchronize()
        t_roof = time.perf_counter() - t_roof
        roof_counts = (peak.LAUNCHES, peak.PROBE_LAUNCHES, bwd_twin.LAUNCHES)
    finally:
        smi.terminate()
        smi_out = smi.communicate(timeout=30)[0]
    if min(roof_counts) < 1:
        raise AssertionError(f"roofline: launches {roof_counts} (K6, census "
                             f"probe, K7)")
    samples = [[float(v) for v in line.split(",")]
               for line in smi_out.splitlines() if line.count(",") == 1]
    sm_mhz = [s[0] for s in samples]
    watts = [s[1] for s in samples]
    clock = (f"SM clock {min(sm_mhz):.0f}-{max(sm_mhz):.0f} MHz (median "
             f"{statistics.median(sm_mhz):.0f}), power up to {max(watts):.1f} "
             f"W, {len(samples)} samples over {t_roof:.1f} s" if samples
             else "SM clock not sampled")
    add_peak = peaks["add"]
    print(f"roofline main path [{card}; {clock}]: launches K6 {roof_counts[0]}, "
          f"census probe {roof_counts[1]}, K7 {roof_counts[2]}; peaks at K=16 "
          f"(T source ops/s, FMA = 1): fma {peaks['fma'] / 1e12:.3f}, add "
          f"{add_peak / 1e12:.3f}, mix {peaks['mix'] / 1e12:.3f}, bwdmix "
          f"{peaks['bwdmix'] / 1e12:.3f}; the build is --fmad=false, so the "
          f"add chain is the ceiling of the port's kernels", flush=True)
    for mode in peak.MODES:
        for k, v in peaks[f"{mode}_k"].items():
            print(f"K6 {mode} K={k} [{card}]: {k6_match[mode, k]}; "
                  f"{v['rate'] / 1e12:.4f} T source ops/s, "
                  f"{v['sass_rate'] / 1e12:.4f} T FP32 SASS instructions/s, "
                  f"{v['issue_rate'] / 1e12:.4f} T SASS instructions/s "
                  f"({v['fp32_instrs']:.2f} FP32 of {v['instrs']:.2f} SASS "
                  f"instructions an iteration for {k * peak.ops_per_iter(mode)}"
                  f" source ops); {v['ms']:.4f} ms a launch (slope "
                  f"{v['slope_ms']:.4f})", flush=True)

    # 11e. timings: K6's headline fma chain and its plain version, the
    # probe, each twin beside K2 on the same record
    x16 = torch.full(flops.PEAK_SHAPE, 0.99999, device="cuda")
    # K6's device time by CUDA events around 10 launches queued behind a
    # sleep (one launch a call; the profiler has kept as few as 4 of its 10
    # records in all three of kernel_device_ms's sessions)
    k6 = {"ms": median_ms(lambda: peak.peak_chain("fma", 16, x16), 2, 5),
          "dev": flops.device_ms(lambda: peak.peak_chain("fma", 16, x16), 10),
          "plain": median_ms(lambda: peak.peak_chain_plain("fma", 16, x16),
                             0, 2)}
    # the probe runs for about a microsecond, too short for the profiler to
    # keep its records: 50 launches queued behind a sleep, CUDA events
    probe_t = {"ms": median_ms(lambda: peak.census_probe(xp), 3, 5),
               "dev": flops.device_ms(lambda: peak.census_probe(xp), 50),
               "plain": median_ms(lambda: peak.census_probe_plain(xp), 1, 3)}
    k2_sass = flops.sass_census("render_bwd_kernel<false>")
    for tname, t in twins.items():
        tw, tcfg, tres = t["twin"], t["cfg"], t["res"]
        over = bench.twin_over_k2(tw["run"], t["k2"])
        t["dev"], t["k2_dev"] = over["twin_ms"], over["k2_ms"]
        t["ms"] = median_ms(tw["run"], 2, 5)
        t["plain"] = median_ms(tw["run_plain"], 0, 2)
        rays = tres.prim_id.numel()
        pix = tcfg.width * tcfg.height
        t["work"] = (bwd_work(tcfg, cornell, tres)[0] + 12 * pix
                     + 4 * n_obj * 17, tw["census_per_lane"] * rays)
        t["k2_bound"] = bound(*bwd_work(tcfg, cornell, tres))
        sass = flops.sass_census(bwd_twin.symbol(tw["n_pool"]))
        # the step chain: the innermost loop with FP32 work that touches no
        # memory but the constant bank
        step_loop = next(
            lp for lp in sass["loops"] if lp["fp32"] and all(
                op in ("LDC", "ULDC") for op in lp["opcodes"]
                if flops.sass_class(op) == "mem"))
        r, kr = t["resources"], k2_res
        print(f"K7 vs K2 at {tname} [{card}]: twin device {t['dev']:.4f} ms, "
              f"K2 device {t['k2_dev']:.4f} ms, twin / K2 = "
              f"{t['dev'] / t['k2_dev']:.4f}; registers twin {r['registers']} "
              f"(pool {tw['n_pool']}, spills {r['spill_stores']}/"
              f"{r['spill_loads']} B, stack {r['stack_bytes']} B), K2 "
              f"{kr['registers']} (spills {kr['spill_stores']}/"
              f"{kr['spill_loads']} B, stack {kr['stack_bytes']} B); static "
              f"SASS fp32/int/mem/control twin {sass['fp32']}/{sass['int']}/"
              f"{sass['mem']}/{sass['control']}, K2 {k2_sass['fp32']}/"
              f"{k2_sass['int']}/{k2_sass['mem']}/{k2_sass['control']}; the "
              f"twin's innermost loop (the step chain, "
              f"{17 * bwd_twin.STEP_ACCS} source ops an iteration) holds "
              f"{step_loop['fp32']} FP32 of {step_loop['total']} SASS "
              f"instructions; wrapper {t['ms']:.4f} ms, plain "
              f"{t['plain']:.2f} ms; K2 bound {t['k2_bound'][0]:.4f} ms by "
              f"{t['k2_bound'][1]} (data sheet), "
              f"{bound(*bwd_work(tcfg, cornell, tres), peak_fp32=add_peak)[0]:.4f}"
              f" ms at the measured no-FMA peak", flush=True)

    # --- 12. the live loop (preview.py): the headless keypress -> frame
    # bench on the card at the JAX record's configs (256x256 and 512x512,
    # 2x2 AA, 10 samples, 1 bounce) and at the reference's own window,
    # full_1024; each driven with the counts at 0 and read just after ---
    t_live = time.perf_counter()
    live = []
    for width, bounces in ((256, 1), (512, 1), (1024, 10)):
        args = preview.parse_args(["--latency-bench", "--width", str(width),
                                   "--samples", "10", "--bounces",
                                   str(bounces)])
        loop = preview.LiveLoop(preview.build_scene(args), preview.config(args))
        if width == 1024 and loop.cfg != RenderConfig():
            raise AssertionError(f"live loop at 1024: {loop.cfg}")
        reset_counts()
        out = preview.latency_bench(args, loop)
        torch.cuda.synchronize()
        got = counts()
        # one K1 launch per tick (warm-up, events, profiled ticks), nothing
        # else
        if (out["forward_launches"] != out["n_events"]
                or got[0] < 1 + out["n_events"] or got[1:] != (0, 0, 0, 0)
                or partial_counts() != (0, 0)):
            raise AssertionError(f"live loop {width}: {out['forward_launches']} "
                                 f"launches in {out['n_events']} events, "
                                 f"counts {got}, {partial_counts()}")
        if not out["all_frames_finite"]:
            raise AssertionError(f"live loop {width}: a frame is not finite")
        # the last frame's scene against the plain version
        s, cfg = loop.frame_scene, loop.cfg
        img = rt.render(s, cfg).image
        worst, frac = images_match(img, render_fwd.render_fused_plain(s, cfg)[0],
                                   f"live loop {width}")
        # the image moves after a key (tests/test_interactive.py)
        loop.ctl.key("Left")
        loop.ctl.key("i")
        moved = rt.render(loop.ctl.apply(s), cfg).image
        shift = (moved - img).abs().max().item()
        if shift <= 0.01:
            raise AssertionError(f"live loop {width}: the frame moved by "
                                 f"{shift:.3g} after Left, i")
        out["launches_in_run"] = got[0]
        out["vs_plain_worst"], out["vs_plain_beyond_tight"] = worst, frac
        out["moved_after_keys"] = shift
        live.append(out)
        print(f"live loop {width}x{width} {out['config']} [{card}]: p50 "
              f"{out['keypress_to_frame_ms']['p50']:.3f} ms, p95 "
              f"{out['keypress_to_frame_ms']['p95']:.3f} ms, min "
              f"{out['keypress_to_frame_ms']['min']:.3f} ms over "
              f"{out['n_events']} key events ({out['fps_at_p50']:.1f} FPS at "
              f"p50); K1 device {out['forward_device_ms']:.4f} ms a frame; "
              f"host split {out['host_split_ms']}; fetch floor "
              f"{out['fetch_floor_ms']:.4f} ms; {got[0]} K1 launches; last "
              f"frame vs plain worst {worst:.3g}, beyond {TIGHT} {frac:.3%}; "
              f"moved {shift:.3g} after Left, i", flush=True)
    latency_json = os.path.join(ROOT, "docs", "interactive_latency_h100.json")
    with open(latency_json, "w") as f:
        json.dump({"method": "chip_smoke.py phase 12: "
                   "uob_raytracer_tpu_torch.preview.latency_bench, the "
                   "headless drive of the live loop (CameraController key "
                   "-> light step -> render() -> fetch of the float image "
                   "to the host) on one card; 32 keypress round trips each, "
                   "the warm-up frame left out", "card": card,
                   "configs": live}, f, indent=1)
        f.write("\n")
    print(f"live loop phase: {time.perf_counter() - t_live:.1f} s, wrote "
          f"{os.path.relpath(latency_json, ROOT)}", flush=True)

    # --- 13. the bench (bench.py): the logical ray counts of its seven
    # configs against the counts ROADMAP.md records for them (a property of
    # scene and config), bench_config on mirror_512 and streamed_8192, and
    # the headline's JSON line ---
    t_bench = time.perf_counter()
    ray_counts = {"cpu_ref_256": 120_670, "soft_shadows_512": 3_998_064,
                  "mirror_512": 2_772_702, "glass_fresnel_512": 2_773_715,
                  "full_1024": 44_337_413, "streamed_8192": 258_432,
                  "headline": 10_646_319}
    bench_cases = {name: (c, build) for name, c, build in bench.sweep()}
    bench_cases["headline"] = (bench.ROOFLINE_CFG,
                               lambda dev: rt.cornell_box(device=dev))
    bench_scenes = {}
    for name, want in ray_counts.items():
        c, build = bench_cases[name]
        bench_scenes[name] = build(torch.device("cuda"))
        got = bench.logical_ray_count(bench_scenes[name], c)
        diff = (got - want) / want
        print(f"bench ray count {name}: {got:,} (ROADMAP.md {want:,}, "
              f"difference {diff:+.3e}, budget 1e-3)", flush=True)
        if abs(diff) > 1e-3:
            raise AssertionError(f"bench ray count {name}: {got} against "
                                 f"{want}")
    for name in ("mirror_512", "streamed_8192"):
        out = bench.bench_config(name, bench_cases[name][0],
                                 bench_scenes[name], 4)
        p50s = [out[k]["p50"] for k in ("fwd_ms", "fwd_bwd_ms", "render_ms")]
        if (not out["grads_finite"] or None in out.values()
                or not all(np.isfinite(p) and p > 0 for p in p50s)):
            raise AssertionError(f"bench_config {name}: {out}")
        print(f"bench {name} [{card}]: {json.dumps(out)}", flush=True)
    bench.main(["--headline-only"])
    print(f"bench phase: {time.perf_counter() - t_bench:.1f} s", flush=True)

    full = times["full_1024"]
    # K2's split on the full_1024 record: the chain-free launch's pixels,
    # the chain share and the scatter's shuffles (flops.py)
    cfg_full, sc_full = RenderConfig(), scenes["full_1024"][0]
    res_full = records["full_1024"]
    chain_pix = flops.chain_rays(sc_full, cfg_full, res_full).reshape(
        cfg_full.aa_rays, -1).any(dim=0)
    free_work = bwd_work(cfg_full, sc_full, res_full, pixels=~chain_pix)
    share_full = flops.chain_share(sc_full, cfg_full, res_full)
    scatter_full = {s: flops.scatter_work(sc_full, cfg_full, res_full, s)
                    for s in ("pr6", "pr7")}
    print(f"K2 split at full_1024: chain share {share_full}; scatter "
          f"shuffles {scatter_full}", flush=True)
    src = "uob_raytracer_tpu_torch/csrc/"
    jax_fwd = "uob_raytracer_tpu/kernels/render_fwd.py"
    jax_bwd = "uob_raytracer_tpu/kernels/render_bwd.py"

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, work,
              device_ms, library_ms=None, measured_work=None, **more):
        """One kernel's row. ``work`` is (bytes, operations) as
        ``flops.bound`` takes it; the bound is stated against the data
        sheet and against the measured no-FMA peak (the add chain at K=16,
        one instruction per operation; ``measured_work`` where the
        operations there are counted otherwise)."""
        row = bench.roofline_row(work, device_ms, add_peak, measured_work)
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": library_ms, "device_ms": device_ms,
                "bound_ms_measured_peak": row["bound_ms_measured_peak"],
                "bound_by_measured_peak": row["bound_by_measured_peak"],
                **more}

    def k3b_more(deep, cfg, scene):
        """K3b's instance: ptxas registers and spills, the blocks an SM
        holds and the grid at this config."""
        res = flops.kernel_resources(
            f"render_bwd_streamed_kernel<{str(deep).lower()}>")
        n_pix = cfg.width * cfg.height
        ppb = render_bwd.pixels_per_block(cfg.aa_rays)
        return {"registers": res["registers"],
                "spill_stores": res["spill_stores"],
                "spill_loads": res["spill_loads"],
                "blocks_per_sm": render_bwd.streamed_blocks_per_sm(
                    cfg, scene.num_triangles, scene.num_spheres),
                "pixels_per_block": ppb,
                "grid_blocks": render_bwd.launch_blocks(n_pix, ppb)}

    k1_res = flops.kernel_resources("render_fwd_kernel")
    k1_more = {"registers": k1_res["registers"],
               "spill_stores": k1_res["spill_stores"],
               "spill_loads": k1_res["spill_loads"]}
    full_quads = scenes["full_1024"][1]

    def per_sample(work, device_ms):
        """The share against the count of a scan that takes one sample at
        a time (the kernel's before it hoisted the row invariants)."""
        row = bench.roofline_row(work, device_ms, add_peak)
        return {k: row[k] for k in ("operations", "bound_ms",
                                    "bound_ms_measured_peak")}

    head = bench.roofline_row(k1_head["work"], k1_head["dev"], add_peak)
    kernels = [
        entry("K1 render_fwd (whole-table)", "render_fwd.cu",
              f"{jax_fwd}:649", launches, worst_by_cfg["full_1024"],
              full["fwd"], full["plain"], full["fwd_work"], full["fwd_dev"],
              at="full_1024, render()", render_ms=full["render"], **k1_more,
              blocks_per_sm=render_fwd.blocks_per_sm(sc_full, cfg_full,
                                                     full_quads),
              per_sample_count=per_sample(
                  fwd_work(cfg_full, sc_full, full_quads, res_full, False,
                           per_sample=True), full["fwd_dev"]),
              headline={"at": "512x512 aa4 s10 b1, render_fused_raw with "
                        "the quads", "device_ms": k1_head["dev"],
                        **{k: head[k] for k in (
                            "operations", "bound_ms", "bound_ms_measured_peak")},
                        "blocks_per_sm": render_fwd.blocks_per_sm(
                            cornell, hcfg, q_cornell),
                        "per_sample_count": per_sample(
                            k1_head["work_per_sample"], k1_head["dev"])}),
        entry("K1r render_fwd with residuals", "render_fwd.cu",
              f"{jax_fwd}:670", train_launches[0], worst_by_cfg["full_1024"],
              full["fwd_rec"], full["plain"], full["fwd_train_work"],
              full["fwd_train_dev"], at="full_1024, 5 train_steps (record, "
              "no quads)", device_ms_with_quads=full["fwd_rec_dev"],
              bound_ms_with_quads=full["fwd_rec_bound"][0], **k1_more,
              blocks_per_sm=render_fwd.blocks_per_sm(sc_full, cfg_full),
              per_sample_count=per_sample(
                  fwd_work(cfg_full, sc_full, None, res_full, True,
                           per_sample=True), full["fwd_train_dev"])),
        entry("K2 render_bwd (whole-table)", "render_bwd.cu",
              f"{jax_bwd}:366", train_launches[1], bwd_abs, full["bwd"],
              full["plain_bwd"], full["bwd_work"], full["bwd_dev"],
              at="full_1024, 5 train_steps; device_ms: both launches (the "
              "chain launch render_bwd_kernel, whose launches are counted "
              "here, and the chain-free launch, row K2f)",
              max_rel_err=bwd_rel, train_step_ms=full["step"],
              chain_device_ms=full["bwd_chain_dev"],
              free_device_ms=full["bwd_free_dev"], chain_share=share_full,
              scatter_shuffles=scatter_full,
              chain_resources=k2_res,
              free_resources=flops.kernel_resources(render_bwd.FREE_SYMBOL)),
        entry("K2f render_bwd chain-free launch", "render_bwd.cu",
              f"{jax_bwd}:366", train_free, bwd_abs, full["bwd"],
              full["plain_bwd"], free_work, full["bwd_free_dev"],
              at="full_1024, 5 train_steps: the pixels none of whose rays "
              "bounces; ms, plain_ms and max_abs_err are the whole "
              "backward's (one wrapper call launches both)",
              pixels=1.0 - share_full["pixels"]),
        entry("K2' render_bwd past 32 objects", "render_bwd.cu",
              f"{jax_bwd}:126", train_launches[1], k2p_abs, k2p["ms"],
              k2p["plain"], k2p["work"], k2p["dev"],
              at="the same kernel and count as K2; timed at 600 triangles "
              "128x128 aa4 s3 b2", max_rel_err=k2p_rel,
              streamed_device_ms_same_record=k2p["streamed_dev"],
              streamed_segment_sum_device_ms=k2p["streamed_segsum_dev"]),
        entry("K3f render_fwd_streamed", "render_fwd_streamed.cu",
              f"{jax_fwd}:263", k3f_launches, worst_big, lg["fwd"],
              lg["plain"], lg["fwd_work"], lg["fwd_dev"],
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
              lg["plain_bwd"], lg["bwd_work"], lg["bwd_dev"],
              at="dense_8192 128x128 aa4 s3 b2, 5 train_steps",
              max_rel_err=k3b_rel, train_step_ms=lg["step"],
              **k3b_more(False, cfg_big, big)),
        entry("segment_sum (K3b's triangle cotangents)",
              "render_bwd_streamed.cu", f"{jax_bwd}:1003",
              big_train_launches[4], seg_abs, lg["segsum"], lg["index_add"],
              lg["segsum_work"], lg["segsum_dev"],
              library_ms=lg["index_add"],
              at="dense_8192 128x128 aa4 s3 b2, 5 train_steps; plain version "
              "= index_add_"),
        *(entry(f"{kn} deep instance (bounces > {render_bwd.REG_BOUNCES})",
                src_file, f"{jax_bwd}:{line}", d["counts"][ci], d["abs"],
                d["ms"], d["plain"], d["work"], d["dev"],
                at=f"{name} {size}x{size} aa1 s2 b32, render_image's "
                "gradient; plain_ms in row bands", max_rel_err=d["rel"],
                bounce_step_hits=d["hits"], hits_past_16=d["past"],
                ns_per_bounce_step_hit=d["dev"] * 1e6 / d["hits"],
                register_instance_device_ms_16_bounces=d["dev_reg"],
                register_instance_ns_per_hit=d["dev_reg"] * 1e6
                / d["hits_reg"],
                **(k3b_more(True, d["cfg"], d["scene"]) if kn == "K3b"
                   else {}))
          for kn, src_file, line, ci, name, size in (
              ("K2", "render_bwd.cu", 366, 2, "mirror box", 512),
              ("K3b", "render_bwd_streamed.cu", 381, 3,
               "600-triangle mirror box", 256))
          for d in (deep[name],)),
        entry("K4 nearest_tris (per-shard nearest hit)", "partial.cu",
              "uob_raytracer_tpu/kernels/partial.py:64", k4_launches, k4_err,
              pt["k4"], pt["k4_plain"], pt["k4_work"], pt["k4_dev"],
              at="dense_8192 128x128 aa4 s3 b2, the frame on one process "
              "(shade, kernel route); ms and plain_ms on its primary batch",
              ids_differ_from_plain=k4_frac, backward_max_rel_err=k4_bwd_rel,
              primary_ids_differ_from_streamed_fwd_record=pid_frac,
              frame_ms=pt["fwd"], frame_fwd_bwd_ms=pt["fwd_bwd"],
              launches_rank0_tp2_frame=tp_outs[0]["frame_counts"][5],
              launches_rank0_tp2_5_train_steps=tp_outs[0]["step_counts"][5],
              tp2_two_ranks_one_card_frame_ms=ranks["tp=2"]["frame_ms"],
              tp2_two_ranks_one_card_train_step_ms=ranks["tp=2"]["step_ms"],
              transport=via),
        entry("K5 occluded_tris (per-shard occlusion)", "partial.cu",
              "uob_raytracer_tpu/kernels/partial.py:194", k5_launches,
              1.0 if k5_frac else 0.0,
              pt["k5"], pt["k5_plain"], pt["k5_work"], pt["k5_dev"],
              at="dense_8192 128x128 aa4 s3 b2, the frame on one process "
              "(shade, kernel route); ms and plain_ms on its first shadow "
              "batch; max_abs_err is over bits: 1 if any differs",
              bits_differ_from_plain=k5_frac, lit_share=lit_share,
              lanes_used={s: [x["used"] for x in v]
                          for s, v in k5_lanes.items()},
              row_order=[x["row_order"] for x in k5_lanes["pr6"]],
              launches_rank0_tp2_frame=tp_outs[0]["frame_counts"][6],
              launches_rank0_tp2_5_train_steps=tp_outs[0]["step_counts"][6],
              dp2_two_ranks_one_card_frame_ms=ranks["dp=2"]["frame_ms"],
              dp2_two_ranks_one_card_train_step_ms=ranks["dp=2"]["step_ms"]),
        entry("K6 peak_chain (FP32 peak chains)", "peak.cu",
              "uob_raytracer_tpu/flops.py:489", roof_counts[0], k6_err,
              k6["ms"], k6["plain"],
              (8 * x16.numel(), 2 * x16.numel() * peak.INNER * 16), k6["dev"],
              measured_work=(8 * x16.numel(), x16.numel() * peak.INNER * 16),
              at="the fma chain at K=16 on 512x512 (an FMA is two operations "
              "against the data sheet, one instruction against the measured "
              "peak); launches: every mode and K, 20 + 2 x 20 timed and 2 "
              "warm-up each; max_abs_err over all 24 instances",
              peak_ops_s={m: peaks[m] for m in peak.MODES},
              sass_instr_s=peaks["sass"],
              curve={m: {k: {f: v[f] for f in ("rate", "sass_rate",
                                                "issue_rate", "instrs",
                                                "fp32_instrs", "ms",
                                                "slope_ms")}
                         for k, v in peaks[f"{m}_k"].items()}
                     for m in peak.MODES},
              clock=clock),
        entry("census probe (the test fixture's counterpart)", "peak.cu",
              "tests/test_flops.py:19", roof_counts[1], 0.0, probe_t["ms"],
              probe_t["plain"], (8 * xp.numel(), 8 * xp.numel()),
              probe_t["dev"], at="one (8,128) tile of float32",
              sass_fp32=probe["fp32"], sass_opcodes=probe["opcodes"]),
        entry("K7 bwd_twin (structure twin of K2)", "bwd_twin.cu",
              "uob_raytracer_tpu/flops.py:743", roof_counts[2],
              twins["full_1024"]["abs"], twins["full_1024"]["ms"],
              twins["full_1024"]["plain"], twins["full_1024"]["work"],
              twins["full_1024"]["dev"],
              at="full_1024 (K2's record); launches: one at each of the two "
              "configs; max_abs_err over the summed partials",
              twin_over_k2={n: t["dev"] / t["k2_dev"] for n, t in twins.items()},
              k2_device_ms={n: t["k2_dev"] for n, t in twins.items()},
              twin_device_ms={n: t["dev"] for n, t in twins.items()},
              sums_rel_err={n: t["rel"] for n, t in twins.items()},
              sizing={n: {f: t["twin"][f] for f in (
                  "n_main", "n_step", "slots", "divs", "n_pool",
                  "census_per_lane", "target_per_lane", "depth",
                  "target_depth", "wdepth", "target_wdepth", "registers",
                  "target_registers")} for n, t in twins.items()},
              resources={n: t["resources"] for n, t in twins.items()},
              k2_resources=k2_res),
    ]
    for k in kernels:
        print(f"bound of {k['name']}: device {k['device_ms']:.4f} ms; "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} at the data sheet "
              f"({k['bound_ms'] / k['device_ms']:.1%}), "
              f"{k['bound_ms_measured_peak']:.4f} ms by "
              f"{k['bound_by_measured_peak']} at the measured no-FMA peak "
              f"({k['bound_ms_measured_peak'] / k['device_ms']:.1%})",
              flush=True)
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
