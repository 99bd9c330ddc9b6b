"""Device times of the port's kernels on one NVIDIA GPU, old beside new.

    python3 chip_timing.py [--tag NAME] [--out FILE] [--npz FILE]
    python3 chip_timing.py --split [k1|k2k5|k3b|k2c|k2f|k4|all] [--tag NAME] [--out FILE]
    python3 chip_timing.py --k3b-ms [--tag NAME] [--out FILE]
    python3 chip_timing.py --k2c-ms [--tag NAME] [--out FILE]
    python3 chip_timing.py --k2f-ms [--tag NAME] [--out FILE]
    python3 chip_timing.py --k4-ms [--npz FILE] [--tag NAME] [--out FILE]
    python3 chip_timing.py --k7 [--tag NAME] [--out FILE]
    python3 chip_timing.py --compare A.npz B.npz
    python3 chip_timing.py --sass A.so B.so

The default pass times, on the scenes and configs of ``chip_smoke.py``
(the JAX package's ``bench.py:dense_scene(8192)`` at 128x128, 2x2 AA, 3
samples, 2 bounces; at 512x512 with 1 AA ray; the Cornell box at
full_1024; the mirror boxes past 16 bounces):

- the whole-table forward kernel (K1) on the Cornell box at the five
  baseline configs at full size and at the bench's headline (512x512, 2x2
  AA, 10 samples, 1 bounce), as ``render()`` launches it (the quads) and as
  ``train_step`` launches it (the record, no quads), each beside the
  streamed forward kernel (K3f) pinned on the same frame;
- the streamed forward kernel (K3f) as ``render()`` launches it (quads)
  and as ``train_step`` launches it (the record, no quads), and at 512x512;
- the whole-table backward (K2) at full_1024, its deep instance on the
  mirror box at 512x512 and 32 bounces, and the whole-table backward past
  32 objects (K2', 600 triangles at the dense config); the streamed
  backward (K3b) at dense_8192 and its deep instance on the 600-triangle
  mirror box at 256x256; each as the kernels' device time and as every
  device kernel of one backward call;
- K7, the structure twin of K2, at full_1024 (both its launches);
- the partial-scan kernels K4 (nearest hit) and K5 (occlusion) on the ray
  batches of the dense_8192 frame through the kernel route;
- the segmented sum: its wrapper (CUDA events), and within one call each
  device kernel it launches beside the host's share, and ``index_add_`` on
  the same rows;
- a dense_8192 ``train_step``;
- the backward's routing: K2 against K3b and its segmented sum, each
  pinned by ``_kernel``, on the Cornell box at the five baseline configs.

``--npz`` saves K1's image, packed image and record (pid, lit, bid) on
those Cornell frames, K4's outputs (t, pos, nrm, rgb, mat, idx) on the
dense_8192 frame's three nearest-hit batches, K5's bits on the frame's
three occlusion batches,
K2's gradients and replayed image at full_1024 and on the mirror box, and
K3b's at dense_8192 and on the 600-triangle mirror box, so that two runs
(parent and change) can be compared bit for bit with ``--compare``, which
needs no card.

``--split`` measures what sets the kernels' gaps to their bounds instead.
Its K1 part (``--split k1``), at the headline and at full_1024, as
``render()`` and as ``train_step`` launch K1: K1's ptxas registers and
spills, the blocks an SM holds and the waves of the grid, and K1's device
time at the config, with 1 shadow sample and with no bounce (what the
shadow pass and the bounce loop take). Its K2 and K5 part (``--split
k2k5``), on full_1024 and on the headline (``twin_split``): K2's two
launches beside their twins (the free twin over K2f, the chain twin over
K2c) and the chain twin's split instances on the chain launch (no warp
shuffles in the scatter and the camera sums; no chain storage, every step
in one slot; no binary search, the listed pixels read from a compacted
array; ptxas held to 4 blocks an SM), each with its ptxas registers,
spills and stack and its blocks an SM (null in a checkout whose twin is
one launch), and the record's chain share and scatter shuffles
(``flops.chain_share``, ``flops.scatter_work``) at full_1024; and on the three occlusion batches, each ray's first occluding
row (``flops.first_occluder``), the lane-rows a thread per ray uses
(``flops.occluded_lanes``) and K5's device time beside K4's on the same
rays. Its K3b part (``--split k3b``), for both instances of the streamed
backward (dense_8192 128x128 aa4 s3 b2; the 600-triangle mirror box
256x256 aa1 s2 b32): the kernel's device time, the same launch without
its per-site stores, the wrapper's zeroing of the per-site rows as a
device kernel of its own, every device kernel of one backward call, the
ptxas registers and spills, the blocks an SM holds and the grid, the
record's sites and hits, and the lane-steps of the bounce sweeps a warp of
32 rays runs against the steps its rays need; for the deep instance also
the register instance on the same scene at 16 bounces, and each one's ns
per bounce-step hit. The time without the stores comes from a copy of the
package under ``build/k3b_nostore/`` whose ``render_bwd_streamed.cu`` has
the stores' guard replaced by ``false`` (``NOSTORE``), built there and
timed by ``--k3b-ms`` in a process of its own; the package itself has no
such instance. Its K2 chain-kernel part (``--split k2c``), on each frame
the routing sends to ``render_bwd_kernel<Deep>`` (``k2c_frames``:
mirror_512 and glass_fresnel_512, one launch over every pixel;
full_1024 and the headline, the chain launch over the chain-free
launch's list; dense_256 at 128x128 aa4 s3 b2, past 32 objects; the
mirror box at 512x512 b32, the deep instance): the chain kernel's device
time (and the chain-free kernel's where the frame is split), the same
launch with the chain's stores and loads cut (``K2C_NOSTORE``), with the
register instance's step read at the top of the step as the deep
instance reads its (``K2C_EAGER``), with the deep instance reading step
k - 1 while step k's adjoint runs (``K2C_PREFETCH``), and with the camera
row loaded once a thread (``K2C_CAMERA_ONCE``), each from a patched copy
under ``build/k2c_<name>/`` timed by ``--k2c-ms`` in a process of its own
(a patch whose text an older checkout lacks reads null); on the frames
of up to 32 objects, the chain and
chain-free kernels with the split taken the other way (``SPLIT_RAYS``
moved past or below the frame), for the crossover; the ptxas registers,
stack and spills, the blocks an SM holds (the runtime's count, or the
occupancy rule in a checkout without the query) and the waves of the
grid, the listed pixels, the rays a thread replays, and the lane-steps of
the reverse sweeps against the steps the rays need. Its K2 chain-free
part (``--split k2f``), at full_1024 and at the headline (``k2f_frames``):
the chain-free kernel's device time less each of its pieces
(``K2F_PIECES``: (a) no camera shuffles, (b) no object scatter and no
carry, (c) the table staged a row a warp, (d) no pre-pass, the chain flags
read from the list buffer where the wrapper put them, (e) a partial row
only for the first 528 blocks), each from a patched copy under
``build/k2f_<piece>/`` timed by ``--k2f-ms`` in a process of its own,
with an unpatched copy (``build/k2f_base/``) timed before the first piece
and after each; then the kernel's registers, spills and stack, its blocks
an SM, grid, waves and listed pixels, and how evenly a grid of contiguous
or dealt tiles shares the chain-free pixels (``free_balance``).
Its K4 part (``--split k4``), on ``k4_frames`` (the dense_8192 frame's
three nearest-hit batches, 65,536 rays x 8,192 rows; the same rays
against each tp=2 rank's 4,096-row shard; the 600-triangle frame's three
batches at 128x16, 8,192 rays x 600 rows): K4's device time with each of
its pieces (``K4_PIECES``: (c) one and two thread groups a ray in place
of four, (d) no division), each from a patched copy under
``build/k4_<piece>/`` timed by ``--k4-ms`` in a process of its own, an
unpatched copy (``build/k4_base/``) before the first piece and after
each; then the kernel's registers and spills, its blocks an SM, the grid
and warps an SM, its row loop's SASS, and its share of the bound at
``flops.NEAREST_ROW_OPS`` and at the parent's 70 operations a row,
against the data sheet and against K6's add chain measured in the same
process.
``--split`` alone runs every part.

``--k4-ms`` times K4 alone on ``k4_frames`` (device ms of each batch);
with ``--npz`` it saves K4's outputs on every batch there.
``--k2c-ms`` times K2's chain kernel alone on the split's frames,
``--k2f-ms`` K2's chain-free and chain kernels and every device kernel of
one backward call on ``k2f_frames``.
``--k7`` times K7 beside K2 (``k7_frames``: full_1024, the headline,
mirror_512): every device kernel of one twin run and of one backward,
and, in a checkout whose twin mirrors K2 launch for launch, each twin
launch over its K2 launch with its sizing, registers and blocks an SM,
and on a split frame the grids of both free launches (blocks, tiles a
block: K2f's ``render_bwd.free_grid``, the free twin's as its wrapper
reports it, or one block a tile in a checkout whose wrapper does not); it
runs in an older checkout too (its one-launch twin against all of K2).
``--k3b-ms`` times K3b alone (device ms of its kernel in one backward call)
on the split's two configs and on the same two scenes at 512x512 (2,048
blocks of one thread per AA ray, where the card holds several waves).

``--sass`` compares two built kernel libraries (parent and change) kernel
by kernel: each function's static SASS instruction count and opcode counts
(``flops.parse_sass`` of ``cuobjdump -sass``), and whether they are equal;
it needs the toolkit's ``cuobjdump`` but no card.

It imports ``uob_raytracer_tpu_torch`` from the directory it sits in and
uses only wrapper calls that the port has had since its deep backward
instances and row bands (the K1 split's blocks per SM and waves need
``render_fwd.blocks_per_sm`` and ``pixels_per_block`` as well, the K3b
split's ``render_bwd.streamed_blocks_per_sm``, and read null in a checkout
without them), so the same file copied into a checkout
of an earlier commit times that commit's kernels: run parent, change,
change, parent on one card, one after another, to compare them. Prints
the card's name and power limit, then one JSON line; ``--out`` appends
that line to a file too. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

import uob_raytracer_tpu_torch as rt
from uob_raytracer_tpu_torch import (RenderConfig, ShadingModel,
                                     baseline_configs, flops)
from uob_raytracer_tpu_torch.kernels import (_build, bwd_twin, partial,
                                             render_bwd, render_fwd)
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
from uob_raytracer_tpu_torch.parallel import train_step

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG_BIG = RenderConfig(width=128, height=128, aa_x=2, aa_y=2,
                       shadow_samples=3, bounces=2)
CFG_512 = RenderConfig(width=512, height=512, aa_x=1, aa_y=1,
                       shadow_samples=3, bounces=2)
MIRROR_FOCAL = 4400.0
# the bench's headline (bench_torch.py; the JAX package's roofline config)
HEADLINE = RenderConfig(width=512, height=512, aa_x=2, aa_y=2,
                        shadow_samples=10, bounces=1)
K1_RECORD = ("pid", "lit", "bid")


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


def mirror_box(scene):
    """``chip_smoke.mirror_box``: the five walls mirrored, the camera inside
    at (0, -0.3, 0) looking along x."""
    mat = scene.tri_mat.clone()
    mat[:10] = 0.0
    return dataclasses.replace(
        scene, tri_mat=mat,
        camera_pos=torch.tensor([0.0, -0.3, 0.0], device=mat.device),
        yaw=torch.tensor(np.pi / 2, dtype=torch.float32, device=mat.device))


def mirror_cfg(size: int) -> RenderConfig:
    return RenderConfig(width=size, height=size, aa_x=1, aa_y=1,
                        shadow_samples=2, bounces=32, focal_length=MIRROR_FOCAL)


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
    torch.profiler (the names of the device kernels it launched); a
    session in which the tracer kept no device record is run again, up to
    three times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for k in prof.key_averages():
            if (getattr(k, "device_type", None) == torch.autograd.DeviceType.CUDA
                    and k.self_device_time_total > 0):
                out[k.key] = k.self_device_time_total / n / 1000.0
        if out:
            break
    return out


def kernel_ms(kernels: dict, *names: str) -> float:
    """Device ms per call of the kernels whose name holds one of ``names``."""
    hits = [v for k, v in kernels.items() if any(n in k for n in names)]
    if not hits:
        raise AssertionError(f"no {names} kernel among {sorted(kernels)}")
    return sum(hits)


# the whole-table backward's kernels: since PR 7 the chain-free launch too
K2_NAMES = ("render_bwd_kernel", "render_bwd_free_kernel")


def recorded_batches(scene, cfg):
    """The argument tuples of every ``nearest_tris`` and ``occluded_tris``
    call of one frame through the kernel route (``chip_smoke.py``'s
    ``recorded_frame``)."""
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
            render_fwd.render_flat(scene, cfg, tri_pass="kernel")
    finally:
        partial.nearest_tris, partial.occluded_tris = real
    torch.cuda.synchronize()
    return calls


def backward_times(out: dict, key: str, fn, names, n: int = 10) -> None:
    """The kernels' device ms (their sum, and each), and every device
    kernel of one call."""
    k = device_kernels(fn, n)
    out[f"{key}_ms"] = kernel_ms(k, *names)
    out[f"{key}_kernels_ms"] = {name: v for name, v in k.items()
                                if any(n in name for n in names)}
    out[f"{key}_all_device_ms"] = sum(k.values())


def twin_for(scene, cfg, res):
    """K7 sized to K2 on this record (as ``chip_smoke.py``): launch for
    launch, each twin to its own K2 launch, where the checkout's twin
    mirrors K2's split (``flops.size_bwd_twin``); else the one-launch twin
    sized to K2's chain kernel."""
    if hasattr(flops, "size_bwd_twin"):
        return flops.build_bwd_structure_twin(scene, cfg, res)
    k2 = flops.kernel_resources("render_bwd_kernel<false>")
    targets = flops.bwd_twin_targets(scene, cfg, res)
    return flops.build_bwd_structure_twin(scene, cfg, res, **targets,
                                          target_registers=k2["registers"])


def k7_frames():
    """The records K7 is timed on beside K2: full_1024 and the headline
    (K2 split into its chain-free and chain launches), mirror_512 (one
    launch), each with the seed of K2's image cotangent."""
    return (("full_1024", RenderConfig(), 11), ("headline_512", HEADLINE, 12),
            ("mirror_512", baseline_configs()["mirror_512"], 81))


def free_grids(twin, cfg, n_obj: int) -> dict:
    """The grids (blocks, tiles a block) of K2f and of the free twin on a
    frame K2 splits: K2f's as ``render_replay_bwd`` takes it for one band
    (one block a tile in a checkout without ``render_bwd.free_grid``), the
    twin's as its wrapper reports it (one block a tile in a checkout whose
    wrapper reports none)."""
    n_pix = cfg.height * cfg.width
    tiles = -(-n_pix // render_fwd.THREADS)
    k2f = (render_bwd.free_grid(n_pix, render_bwd.free_slots(
        torch.device("cuda"), n_obj))
        if hasattr(render_bwd, "free_grid") else (tiles, 1))
    parts, _ = twin["run"](parts=True)
    return {"k2f": list(k2f), "k7f": list(parts.get("grid", (tiles, 1)))}


def k7_pass(out: dict) -> None:
    """K7 beside K2 on ``k7_frames``: every device kernel of one twin run
    and of one K2 backward, their sums and ratio, and, where the twin
    mirrors K2 launch for launch, each twin launch over its K2 launch with
    its sizing, registers and blocks an SM."""
    cornell = rt.cornell_box()
    n_obj = cornell.num_triangles + cornell.num_spheres
    rows = {}
    for name, cfg, seed in k7_frames():
        res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
        g = seeded((cfg.height, cfg.width, 3), seed)
        twin = twin_for(cornell, cfg, res)
        tk = device_kernels(twin["run"])
        kk = device_kernels(lambda: render_bwd.render_replay_bwd(
            cornell, cfg, res, g))
        row = {"twin_kernels_ms": {k: v for k, v in tk.items()
                                   if "bwd_twin" in k},
               "k2_kernels_ms": {k: v for k, v in kk.items()
                                 if any(n in k for n in K2_NAMES)},
               "twin_ms": kernel_ms(tk, "bwd_twin"),
               "k2_ms": kernel_ms(kk, *K2_NAMES)}
        row["ratio"] = row["twin_ms"] / row["k2_ms"]
        if "chain" in twin:
            row["split"] = twin["split"]
            if twin["split"]:
                row["grids"] = free_grids(twin, cfg, n_obj)
            for kind, k2_name in (("chain", "render_bwd_kernel"),
                                  ("free", "render_bwd_free_kernel")):
                if twin[kind] is None:
                    continue
                t_ms = kernel_ms(tk, f"bwd_twin_{kind}_kernel")
                k_ms = kernel_ms(kk, k2_name)
                row[kind] = {
                    "twin_ms": t_ms, "k2_ms": k_ms, "ratio": t_ms / k_ms,
                    **{f: twin[kind][f] for f in (
                        "n_main", "n_step", "slots", "n_pool", "census_match",
                        "depth_match", "live", "registers",
                        "target_registers")},
                    "resources": flops.kernel_resources(twin[kind]["symbol"]),
                    "blocks_per_sm": bwd_twin.blocks_per_sm(
                        kind, twin[kind]["n_pool"], cfg, n_obj)}
        else:
            row["n_pool"], row["registers"] = twin["n_pool"], twin["registers"]
        rows[name] = row
    out["k7"] = rows


def k1_frames():
    """The Cornell frames K1 is timed on: (name, scene, config, quads) for
    the five baseline configs at full size and the headline; cpu_ref gets
    the sphere-free box with the host constants and no quads, as
    ``chip_smoke.py`` renders it."""
    frames = []
    for name, cfg in {**baseline_configs(), "headline_512": HEADLINE}.items():
        scene = rt.cornell_box(
            spheres=not cfg.cpu_ref,
            shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE)
        quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
        frames.append((name, scene, cfg, quads))
    return frames


def k1_launch(scene, cfg, quads, train: bool, kernel: str = "whole"):
    """K1 (or K3f with ``kernel="streamed"``) as ``render()`` launches it
    (the quads, no record) or, with ``train``, as ``train_step`` does (the
    record, no quads)."""
    if train:
        return render_fwd.render_fused_res(scene, cfg, quads=None,
                                           _kernel=kernel)
    return render_fwd.render_fused_raw(scene, cfg, quads=quads, _kernel=kernel)


def k1_times(out: dict, saved: dict | None) -> None:
    """K1's and K3f's device times on the Cornell frames (module
    docstring); ``saved`` gets K1's outputs on each."""
    rows = {}
    for name, scene, cfg, quads in k1_frames():
        row = {}
        for launch, train in (("render", False), ("train", True)):
            for kern, sym in (("k1", "render_fwd_kernel"),
                              ("k3f", "render_fwd_streamed_kernel")):
                row[f"{kern}_{launch}_ms"] = kernel_ms(device_kernels(
                    lambda t=train, k=kern: k1_launch(
                        scene, cfg, quads, t,
                        "whole" if k == "k1" else "streamed")), sym)
            if saved is not None:
                img, packed, res = render_fwd.render_fused_res(
                    scene, cfg, quads=None if train else quads)
                key = f"k1_{name}_{launch}"
                saved[f"{key}_image"] = img.cpu().numpy()
                saved[f"{key}_packed"] = packed.view(torch.int32).cpu().numpy()
                for field, t in zip(K1_RECORD, res):
                    saved[f"{key}_{field}"] = t.cpu().numpy()
        rows[name] = row
    out["k1"] = rows
    out["k1_resources"] = flops.kernel_resources("render_fwd_kernel")


def k1_split(out: dict) -> None:
    """K1's resources, occupancy and device time at one shadow sample and
    at no bounce, at the headline and at full_1024 (module docstring)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy = getattr(render_fwd, "blocks_per_sm", None)
    ppb = getattr(render_fwd, "pixels_per_block", None)
    scene = rt.cornell_box()
    quads = detect_shadow_quads(scene)
    rows = {"resources": flops.kernel_resources("render_fwd_kernel"),
            "sms": sms}
    for name, cfg in (("headline_512", HEADLINE), ("full_1024", RenderConfig())):
        for launch, train in (("render", False), ("train", True)):
            q = None if train else quads
            grid = -(-cfg.width * cfg.height
                     // (ppb(cfg.aa_rays) if ppb else render_fwd.THREADS))
            per_sm = occupancy(scene, cfg, q) if occupancy else None
            row = {"blocks": grid, "blocks_per_sm": per_sm,
                   "waves": grid / (per_sm * sms) if per_sm else None}
            for var, c in (("ms", cfg),
                           ("s1_ms", dataclasses.replace(cfg, shadow_samples=1)),
                           ("b0_ms", dataclasses.replace(cfg, bounces=0))):
                row[var] = kernel_ms(device_kernels(
                    lambda c=c, t=train: k1_launch(scene, c, quads, t)),
                    "render_fwd_kernel")
            rows[f"{name}_{launch}"] = row
    out["k1_split"] = rows


def resized(sizing: dict, n_main: int | None = None,
            divides: bool = True) -> dict:
    """A twin sizing with its slot-iterations spread over ``n_main``
    iterations (``flops._twin_slots``) and its divides kept in number
    (slot 0's on the path first, one an iteration, then the other slots in
    turn) or, without ``divides``, dropped."""
    n = sizing["n_main"] if n_main is None else n_main
    slots = flops._twin_slots(sum(sizing["slots"]), n)
    divs = [set() for _ in range(n)]
    if divides:
        on_path = min(sum(1 for d in sizing["divs"] if 0 in d), n)
        for i in range(on_path):
            divs[(i * n) // on_path].add(0)
        left = sum(len(d) for d in sizing["divs"]) - on_path
        it = 0
        while left > 0 and it <= 4 * n:
            for s_ in range(1, slots[it % n]):
                if left > 0 and s_ not in divs[it % n]:
                    divs[it % n].add(s_)
                    left -= 1
            it += 1
    return dict(sizing, n_main=n, slots=slots,
                divs=[sorted(d) for d in divs])


def structure_only(sizing: dict) -> dict:
    """A twin sizing with no calibration chain: no slot, no step-chain
    iteration, no pool; what is left is the twin's structure (the record's
    reads, the row gathers, the sweeps, the scatters, the camera and image
    sums)."""
    n = sizing["n_main"]
    return dict(sizing, slots=[0] * n, divs=[[] for _ in range(n)],
                n_step=0, n_pool=0)


def twin_split(scene, cfg, res, g) -> dict:
    """K2's launches beside their twins on a record K2 splits, and the
    chain twin's split instances (``bwd_twin.SPLITS``: no shuffles, no
    chain storage, no binary search, 4 blocks an SM) on the chain launch,
    each with its device ms, ptxas registers, spills and stack, and blocks
    an SM (the runtime's count for K2c and the twins, the occupancy rule
    for K2f and the split instances). The instances share the pool
    SPLIT_POOL; where the chain twin took another, the chain twin at that
    pool is timed beside them too, and each twin with its calibration
    chains cut (``structure_only``). Beside them the free twin with its
    sizing changed one piece at a time (``resized``: no pool, no divides,
    its slot-iterations over 2, 3 or 6 main iterations; ``structure_only``
    the free twin's structure alone), each over K2f (``over_k2f``), and the
    grids of both free launches (``free_grids``)."""
    n_obj = scene.num_triangles + scene.num_spheres
    twin = flops.build_bwd_structure_twin(scene, cfg, res)
    if not twin["split"]:
        raise AssertionError(f"twin_split: K2 takes {cfg} in one launch")
    table = bwd_twin.twin_table(scene, cfg)
    g_t = torch.full((cfg.height, cfg.width, 3), 1e-3, device="cuda")
    k2k = device_kernels(lambda: render_bwd.render_replay_bwd(
        scene, cfg, res, g))
    # both free launches take the frame's grid of tile ranges, and with it
    # each tile's ballots in shared memory
    grids = free_grids(twin, cfg, n_obj)
    smem = {"free": render_bwd.free_shared_bytes(n_obj, grids["k2f"][1]),
            "chain": render_fwd.bwd_shared_bytes(n_obj, cfg.aa_rays)}

    def row(ms, symbol, per_sm=None, kind="chain"):
        r = flops.kernel_resources(symbol)
        return {"ms": ms, "symbol": symbol, "registers": r["registers"],
                "spill_stores": r["spill_stores"],
                "spill_loads": r["spill_loads"],
                "stack_bytes": r["stack_bytes"],
                "blocks_per_sm": per_sm or blocks_per_sm_formula(
                    r["registers"], smem[kind])}

    tk = device_kernels(twin["run"])
    rows = {
        "K2c": row(kernel_ms(k2k, "render_bwd_kernel"),
                   "render_bwd_kernel<false>", render_bwd.chain_blocks_per_sm(
                       cfg, scene.num_triangles, scene.num_spheres)),
        "K2f": row(kernel_ms(k2k, "render_bwd_free_kernel"),
                   render_bwd.FREE_SYMBOL, kind="free")}
    for kind in ("chain", "free"):
        rows[f"K7{kind[0]}"] = row(
            kernel_ms(tk, f"bwd_twin_{kind}_kernel"), twin[kind]["symbol"],
            bwd_twin.blocks_per_sm(kind, twin[kind]["n_pool"], cfg, n_obj),
            kind)
    rows["K7c structure only"] = row(kernel_ms(device_kernels(
        lambda: bwd_twin.bwd_twin(table, g_t, res, cfg,
                                  structure_only(twin["chain"]),
                                  twin["free"])), "bwd_twin_chain_kernel"),
        bwd_twin.symbol(0), bwd_twin.blocks_per_sm("chain", 0, cfg, n_obj))
    chain = dict(twin["chain"], n_pool=bwd_twin.SPLIT_POOL)
    if twin["chain"]["n_pool"] != bwd_twin.SPLIT_POOL:
        rows[f"K7c pool {bwd_twin.SPLIT_POOL}"] = row(kernel_ms(
            device_kernels(lambda: bwd_twin.bwd_twin(
                table, g_t, res, cfg, chain, twin["free"])),
            "bwd_twin_chain_kernel"), bwd_twin.symbol(bwd_twin.SPLIT_POOL),
            bwd_twin.blocks_per_sm("chain", bwd_twin.SPLIT_POOL, cfg, n_obj))
    for name, (_, symbol) in bwd_twin.SPLITS.items():
        def run(s=name):
            return bwd_twin.bwd_twin(table, g_t, res, cfg, chain, twin["free"],
                                     _split=s)
        sums, _ = run()
        if not torch.isfinite(sums).all():
            raise AssertionError(f"K7 split {name}: sums not finite")
        rows[f"K7c {name}"] = row(
            kernel_ms(device_kernels(run), "bwd_twin_split_kernel"), symbol)
    for name, r in rows.items():
        other = {"K7c": "K2c", "K7f": "K2f"}.get(name)
        if other:
            r["over_k2"] = r["ms"] / rows[other]["ms"]
    # what sets the free twin's time: its sizing changed one piece at a
    # time, the same slot-iterations (operations) each
    free = twin["free"]
    variants = {"as_sized": free, "pool_0": dict(free, n_pool=0),
                "no_divides": resized(free, divides=False),
                "structure_only": structure_only(free)}
    for n in (2, 3, 6):
        if n != free["n_main"] and sum(free["slots"]) <= n * bwd_twin.MAX_SLOTS:
            variants[f"n_main_{n}"] = resized(free, n_main=n)
    free_variants = {}
    for name, sz in variants.items():
        ms = kernel_ms(device_kernels(lambda z=sz: bwd_twin.bwd_twin(
            table, g_t, res, cfg, twin["chain"], z)), "bwd_twin_free_kernel")
        free_variants[name] = {
            "ms": ms, "n_main": sz["n_main"], "slots": sz["slots"],
            "divs": sz["divs"], "n_pool": sz["n_pool"],
            "depth": flops.twin_depth_per_ray(sz["n_main"], sz["n_step"], 0.0),
            "ops": flops.twin_ops_per_ray(sz["n_step"], sz["slots"],
                                          sz["n_pool"], 0.0, cfg.aa_rays)}
    for v in free_variants.values():
        v["over_k2f"] = v["ms"] / rows["K2f"]["ms"]
    return {"rows": rows, "free_variants": free_variants, "grids": grids,
            "listed_pixels": int(bwd_twin.chain_pixels(
        table, res, cfg).sum()), "sizing": {
            k: {f: twin[k][f] for f in ("n_main", "n_step", "slots", "n_pool",
                                        "census_match", "depth_match", "live")}
            for k in ("free", "chain")}}


def split_pass(out: dict) -> None:
    """What sets the gaps of K2 and K5 (see the module docstring)."""
    cornell = rt.cornell_box()
    cfg = RenderConfig()
    res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
    g = seeded((1024, 1024, 3), 11)
    out["k2_split"] = (twin_split(cornell, cfg, res, g)
                       if hasattr(flops, "size_bwd_twin") else None)
    res_h = render_fwd.render_fused_res(cornell, HEADLINE, quads=None)[2]
    out["k2_split_headline"] = (
        twin_split(cornell, HEADLINE, res_h, seeded((512, 512, 3), 12))
        if hasattr(flops, "size_bwd_twin") else None)
    out["chain_share"] = flops.chain_share(cornell, cfg, res)
    out["scatter_work"] = {s: flops.scatter_work(cornell, cfg, res, s)
                           for s in ("pr6", "pr7")}

    big = dense_scene(8192)
    calls = recorded_batches(big, CFG_BIG)
    table4 = calls["nearest"][0][:6]
    k5 = []
    for i, args in enumerate(calls["occluded"]):
        v0, e1, e2, mat, start, d, r2 = args
        first = flops.first_occluder(v0, e1, e2, mat, start, d, r2)
        bits = partial.occluded_tris(*args)
        lit = first >= v0.shape[0]
        row = {
            "rays": int(start.shape[0]),
            "occluded_share_plain": 1.0 - lit.float().mean().item(),
            "bits_differ_from_first_occluder": (
                bits != ~lit).float().mean().item(),
            "mean_first_row_occluded": first[~lit].float().mean().item(),
            "lanes_pr6": flops.occluded_lanes(first, v0.shape[0], "pr6"),
            "lanes_pr7": flops.occluded_lanes(first, v0.shape[0], "pr7"),
            "k5_ms": kernel_ms(device_kernels(
                lambda a=args: partial.occluded_tris(*a)),
                "occluded_tris_kernel"),
            "k4_same_rays_ms": kernel_ms(device_kernels(
                lambda s=start, dd=d: partial.nearest_tris(*table4, s, dd)),
                "nearest_tris_kernel"),
        }
        row["bound_ms_measured_peak_28.32T"] = flops.bound(
            *flops.occluded_work(v0.shape[0], bits), peak_fp32=28.32e12)[0]
        k5.append(row)
    out["k5_split"] = k5


def k3b_cases():
    """The two instances of K3b on their configs: (name, scene, config,
    seed of the image cotangent)."""
    return (("dense_8192", dense_scene(8192), CFG_BIG, 51),
            ("mirror_600", mirror_box(dense_scene(600)), mirror_cfg(256), 71))


def k3b_frames():
    """The K3b cases and the same scenes at 512x512 (``--k3b-ms``)."""
    cases = k3b_cases()
    (_, dense, cfg, _), (_, mirror, _, _) = cases
    return cases + (
        ("dense_8192_512", dense, dataclasses.replace(cfg, width=512,
                                                      height=512), 53),
        ("mirror_600_512", mirror, mirror_cfg(512), 73))


def k3b_ms() -> dict:
    """K3b's device ms in one backward call on each of ``k3b_frames``."""
    out = {}
    for name, scene, cfg, seed in k3b_frames():
        res = render_fwd.render_fused_res(scene, cfg)[2]
        g = seeded((cfg.height, cfg.width, 3), seed)
        out[name] = kernel_ms(device_kernels(
            lambda: render_bwd.render_replay_bwd(scene, cfg, res, g), 5),
            "render_bwd_streamed_kernel")
    return out


# The stores' guard in StreamedTables::scatter and what K3b's no-store copy
# (``patched_ms``) puts in its place.
NOSTORE = ("if (id >= 0 && id < n_tri) {", "if (false) {")


def sweep_lane_steps(res, cfg, ppw: int = 32, pixels=None) -> dict:
    """The bounce steps each ray's replay needs (the recorded hits) against
    the lane-steps a warp of ``ppw`` adjacent pixels of one AA index runs
    (its deepest ray's, on every lane); with ``pixels`` (bool [rows * W])
    the warps of those pixels alone, in order (K2's chain launch over its
    list)."""
    hits = (res.bounce_id >= 0).sum(dim=0).reshape(cfg.aa_rays, -1)
    if pixels is not None:
        hits = hits[:, pixels.reshape(-1).to(hits.device)]
    n = hits.shape[1]
    pad = -n % ppw
    if pad:
        hits = torch.cat([hits, hits.new_zeros((hits.shape[0], pad))], 1)
    warps = hits.reshape(hits.shape[0], -1, ppw)
    run = int(warps.max(dim=2).values.sum()) * ppw
    need = int(hits.sum())
    return {"steps_needed": need, "lane_steps_run": run,
            "used": need / run if run else None}


def k3b_split(out: dict) -> None:
    """K3b's split on both instances (see the module docstring)."""
    occupancy = getattr(render_bwd, "streamed_blocks_per_sm", None)
    nostore = patched_ms("k3b_nostore", {"render_bwd_streamed.cu": (NOSTORE,)},
                         False, "--k3b-ms") or {}
    rows = {"sms": torch.cuda.get_device_properties(0).multi_processor_count}
    for name, scene, cfg, seed in k3b_cases():
        res = render_fwd.render_fused_res(scene, cfg)[2]
        g = seeded((cfg.height, cfg.width, 3), seed)
        deep = cfg.bounces > render_bwd.REG_BOUNCES
        n = 5 if deep else 10
        k = device_kernels(lambda: render_bwd.render_replay_bwd(
            scene, cfg, res, g), n)
        ids = render_bwd.site_ids(res)
        n_tri = scene.num_triangles
        # one thread per AA ray, or the parent's one per pixel
        px = (render_fwd.pixels_per_block(cfg.aa_rays) if occupancy
              else render_bwd.THREADS)
        row = {"ms": kernel_ms(k, "render_bwd_streamed_kernel"),
               "all_device_ms": sum(k.values()), "kernels_ms": k,
               "nostore_ms": nostore.get(name),
               "grid_blocks": -(-cfg.width * cfg.height // px),
               "blocks_per_sm": occupancy(cfg, scene.num_triangles,
                                          scene.num_spheres)
               if occupancy else None,
               "sites": int(ids.numel()),
               "triangle_sites": int(((ids >= 0) & (ids < n_tri)).sum()),
               "bounce_step_hits": int((res.bounce_id >= 0).sum()),
               "hits_past_16": int((res.bounce_id[render_bwd.REG_BOUNCES:]
                                    >= 0).sum()),
               "sweeps": sweep_lane_steps(res, cfg)}
        dlane = torch.empty((ids.numel(), render_bwd.GRAD_COLS),
                            device="cuda")
        row["dlane_bytes"] = dlane.numel() * 4
        row["zero_ms"] = sum(device_kernels(dlane.zero_, n).values())
        del dlane
        row["resources"] = flops.kernel_resources(
            f"render_bwd_streamed_kernel<{str(deep).lower()}>")
        row["ns_per_hit"] = (row["ms"] * 1e6 / row["bounce_step_hits"]
                             if row["bounce_step_hits"] else None)
        if deep:
            c16 = dataclasses.replace(cfg, bounces=render_bwd.REG_BOUNCES)
            r16 = render_fwd.render_fused_res(scene, c16)[2]
            hits16 = int((r16.bounce_id >= 0).sum())
            ms16 = kernel_ms(device_kernels(
                lambda: render_bwd.render_replay_bwd(scene, c16, r16, g), n),
                "render_bwd_streamed_kernel")
            row["register_16"] = {"ms": ms16, "bounce_step_hits": hits16,
                                  "ns_per_hit": ms16 * 1e6 / hits16,
                                  "sweeps": sweep_lane_steps(r16, c16)}
        rows[name] = row
    out["k3b_split"] = rows


def k2c_frames():
    """The frames the routing sends to K2's chain kernel
    (``render_bwd_kernel<Deep>``): (name, scene, config, seed of the image
    cotangent). One launch over every pixel, one ray a pixel: mirror_512
    and glass_fresnel_512; the chain launch over the chain-free launch's
    list: full_1024 and the headline; past 32 objects, whole-table (256
    triangles, within STREAM_ABOVE_TRIANGLES): dense_256 at 128x128 aa4 s3
    b2; the deep instance, one launch below SPLIT_RAYS: the mirror box at
    512x512 b32."""
    cfgs = baseline_configs()
    cornell = rt.cornell_box()
    return (("mirror_512", cornell, cfgs["mirror_512"], 81),
            ("glass_fresnel_512", cornell, cfgs["glass_fresnel_512"], 82),
            ("full_1024", cornell, RenderConfig(), 11),
            ("headline_512", cornell, HEADLINE, 12),
            ("dense_256", dense_scene(256), CFG_BIG, 61),
            ("mirror_box_512", mirror_box(cornell), mirror_cfg(512), 71))


def k2c_ms(other_route: bool = False) -> dict:
    """The chain kernel's (and, where the frame is split, the chain-free
    kernel's) device ms in one backward call on each of ``k2c_frames``;
    with ``other_route``, on the frames of up to 32 objects that bounce
    also both kernels' ms with the split the other way (``SPLIT_RAYS`` set
    to 0 or past the frame), for the crossover."""
    out = {}
    for name, scene, cfg, seed in k2c_frames():
        res = render_fwd.render_fused_res(scene, cfg, quads=None)[2]
        g = seeded((cfg.height, cfg.width, 3), seed)
        n = 5 if cfg.bounces > render_bwd.REG_BOUNCES else 10

        def times():
            k = device_kernels(lambda: render_bwd.render_replay_bwd(
                scene, cfg, res, g), n)
            return {"ms": kernel_ms(k, "render_bwd_kernel"),
                    "free_ms": sum(v for kk, v in k.items()
                                   if "render_bwd_free_kernel" in kk),
                    "all_device_ms": sum(k.values())}
        out[name] = times()
        n_obj = scene.num_triangles + scene.num_spheres
        if (other_route and n_obj <= render_bwd.SPLIT_OBJECTS
                and not cfg.bounces > render_bwd.REG_BOUNCES):
            split = render_bwd.splits(cfg, cfg.height, n_obj)
            keep = render_bwd.SPLIT_RAYS
            render_bwd.SPLIT_RAYS = 1 << 62 if split else 0
            try:
                out[name]["other_route"] = {"split": not split, **times()}
            finally:
                render_bwd.SPLIT_RAYS = keep
    return out


# The chain's stores and loads cut (K2C_NOSTORE): every index of the chain
# storage in bwd_ray.cuh made 0, so the register instance keeps one step in
# registers, and the deep instance's storage made the same per-thread
# array (its buffer never touched). The arithmetic runs on step 0's values
# at every step: a time, not a result.
K2C_NOSTORE = {
    "bwd_common.cuh": (
        ("using ChainSteps = std::conditional_t<Deep, DeepSteps, "
         "float[kRegBounces][kStepFloats]>;",
         "using ChainSteps = float[kRegBounces][kStepFloats];"),
        ("using ChainIds = std::conditional_t<Deep, DeepIds, int[kRegBounces]>;",
         "using ChainIds = int[kRegBounces];"),
        ("    saved = DeepSteps{chain + p, stride};\n", ""),
        ("    saved_id = DeepIds{reinterpret_cast<int*>(chain + kStepFloats * "
         "stride) + p, stride};\n", "")),
}
# The deep instance reading step k - 1 of its chain while step k's adjoint
# runs, in place of reading step k at the top of step k.
K2C_PREFETCH = {
    "bwd_ray.cuh": (
        ("      for (int k = k_max - 1; k >= 0; --k) {\n",
         "      float nxt[kStepFloats];\n      int nxt_id = -1;\n"
         "      if constexpr (Deep) {\n        if (n_exec > 0) {\n"
         "          const auto s_n = saved[n_exec - 1];\n"
         "          for (int j = 0; j < kStepFloats; ++j) nxt[j] = s_n[j];\n"
         "          nxt_id = saved_id[n_exec - 1];\n        }\n      }\n"
         "      for (int k = k_max - 1; k >= 0; --k) {\n"),
        ("          if constexpr (Deep) {\n            const auto s_k = saved[k];\n"
         "#pragma unroll\n"
         "            for (int j = 0; j < kStepFloats; ++j) sv_deep[j] = s_k[j];\n"
         "            sv = sv_deep;\n          } else {\n            sv = saved[k];\n"
         "          }\n          const int sid_k = saved_id[k];\n",
         "          int sid_k;\n          if constexpr (Deep) {\n"
         "            for (int j = 0; j < kStepFloats; ++j) sv_deep[j] = nxt[j];\n"
         "            sv = sv_deep;\n            sid_k = nxt_id;\n"
         "            if (k > 0) {\n              const auto s_k = saved[k - 1];\n"
         "              for (int j = 0; j < kStepFloats; ++j) nxt[j] = s_k[j];\n"
         "              nxt_id = saved_id[k - 1];\n            }\n"
         "          } else {\n            sv = saved[k];\n            sid_k = saved_id[k];\n"
         "          }\n")),
}
# The chain kernel loading the camera row once a thread, before its walk,
# in place of once a ray.
K2C_CAMERA_ONCE = {
    "render_bwd.cu": (
        ("  const float fA = (float)A;\n  float dcam[kCamCols];\n",
         "  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);\n"
         "  const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);\n"
         "  const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);\n"
         "  const float fA = (float)A, fS = (float)P.shadow_samples;\n"
         "  float dcam[kCamCols];\n"),
        ("      const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);\n"
         "      const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);\n"
         "      const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);\n"
         "      const float fS = (float)P.shadow_samples;\n", "")),
}
# The register instance reading its step at the top of the step, as the
# deep instance does (where both read the step where it is used, as in an
# older checkout, the patch does not apply).
K2C_EAGER = {
    "bwd_ray.cuh": (("          } else {\n            sv = saved[k];\n",
                     "          } else {\n            const auto s_k = saved[k];\n"
                     "            for (int j = 0; j < kStepFloats; ++j) "
                     "sv_deep[j] = s_k[j];\n            sv = sv_deep;\n"),),
}


def patched_ms(tag: str, patches: dict, chain_index: bool, flag: str):
    """``flag``'s JSON (``--k2c-ms``, ``--k2f-ms`` or ``--k3b-ms``) from a
    copy of the package under ``build/<tag>/`` with ``patches`` ({source:
    ((old, new), ...)}; a source of ``csrc/``, or a path under the package
    such as ``kernels/render_bwd.py``) applied, and with ``chain_index``
    every chain index of
    bwd_ray.cuh made 0; run in a process of its own. None where a patch's
    text is not in the source exactly once (an older checkout)."""
    dst = os.path.join(ROOT, "build", tag)
    shutil.rmtree(dst, ignore_errors=True)
    pkg = os.path.join(dst, "uob_raytracer_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "uob_raytracer_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.abspath(__file__), dst)
    csrc = os.path.join(pkg, "csrc")
    for name, subs in patches.items():
        # a source of csrc/, or a path under the package ("kernels/x.py")
        path = os.path.join(pkg if "/" in name else csrc, name)
        with open(path) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                return None
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    if chain_index:
        path = os.path.join(csrc, "bwd_ray.cuh")
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(re.sub(r"\b(saved(?:_id)?)\[([^\]]+)\]", r"\1[0 * (\2)]",
                           text))
    run = subprocess.run([sys.executable, "chip_timing.py", flag],
                         cwd=dst, stdout=subprocess.PIPE, text=True,
                         check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])[flag[2:].replace(
        "-", "_")]


def blocks_per_sm_formula(registers: int, smem: int) -> int:
    """Blocks of 128 threads an H100 SM holds by registers (65,536, a
    warp's allocated in units of 256) and shared memory (228 KB, 1 KB
    reserved a block), at most 16: the occupancy rule, for a checkout whose
    library has no occupancy query."""
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = 65536 // (render_bwd.THREADS // 32 * warp_regs)
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 16)


def k2c_split(out: dict) -> None:
    """K2's chain kernel on the frames the routing sends to it (module
    docstring)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = {name: patched_ms(f"k2c_{name}", patch, name == "nostore",
                                 "--k2c-ms") or {}
                for name, patch in (("nostore", K2C_NOSTORE),
                                    ("eager", K2C_EAGER),
                                    ("prefetch", K2C_PREFETCH),
                                    ("camera_once", K2C_CAMERA_ONCE))}
    own = k2c_ms(other_route=True)
    per_ray = hasattr(render_bwd, "chain_blocks")  # one thread per AA ray
    rows = {"sms": sms, "one_thread_per_aa_ray": per_ray}
    for name, scene, cfg, _ in k2c_frames():
        res = render_fwd.render_fused_res(scene, cfg, quads=None)[2]
        n_obj = scene.num_triangles + scene.num_spheres
        A, n_pix = cfg.aa_rays, cfg.width * cfg.height
        deep = cfg.bounces > render_bwd.REG_BOUNCES
        split = render_bwd.splits(cfg, cfg.height, n_obj)
        chain_pix = flops.chain_rays(scene, cfg, res).reshape(A, -1).any(dim=0)
        listed = int(chain_pix.sum()) if split else n_pix
        resources = flops.kernel_resources(
            f"render_bwd_kernel<{str(deep).lower()}>")
        try:
            smem = render_fwd.bwd_shared_bytes(n_obj, A)
        except TypeError:          # a checkout without the chunk buffers
            smem = render_fwd.bwd_shared_bytes(n_obj)
        formula = blocks_per_sm_formula(resources["registers"], smem)
        per_sm = (render_bwd.chain_blocks_per_sm(cfg, scene.num_triangles,
                                                 scene.num_spheres)
                  if hasattr(render_bwd, "chain_blocks_per_sm") else formula)
        ppb = render_fwd.pixels_per_block(A) if per_ray else render_bwd.THREADS
        grid = (render_bwd.chain_blocks(n_pix, A, split) if per_ray
                else -(-n_pix // render_bwd.THREADS))
        chunks = -(-listed // ppb)
        row = {**own[name],
               **{f"{v}_ms": t.get(name, {}).get("ms")
                  for v, t in variants.items()},
               "split": split, "pixels": n_pix, "aa_rays": A,
               "chain_pixels": int(chain_pix.sum()), "listed_pixels": listed,
               "chain_rays": int(flops.chain_rays(scene, cfg, res).sum()),
               "resources": resources, "shared_bytes": smem,
               "blocks_per_sm": per_sm, "blocks_per_sm_formula": formula,
               "pixels_per_block": ppb, "grid_blocks": grid,
               "blocks_with_work": min(grid, chunks),
               "rays_a_thread": -(-chunks // grid) * ppb * A // render_bwd.THREADS,
               "waves": min(grid, chunks) / (per_sm * sms),
               "bounce_step_hits": int((res.bounce_id >= 0).sum()),
               "sweeps": sweep_lane_steps(res, cfg, pixels=chain_pix
                                          if split else None)}
        # the chain launch's work (the listed pixels' rays and steps): its
        # bound against the data sheet
        row["work"] = flops.bwd_work(cfg, scene, res, pixels=chain_pix
                                     if split else None)
        row["bound_ms"], row["bound_by"] = flops.bound(*row["work"])
        rows[name] = row
    out["k2c_split"] = rows


def k2f_frames():
    """The frames K2's chain-free launch (``render_bwd_free_kernel``) is
    split on: (name, config, seed of the image cotangent), the Cornell box
    at full_1024 and at the headline, both split by the record."""
    return (("full_1024", RenderConfig(), 11), ("headline_512", HEADLINE, 12))


def k2f_ms() -> dict:
    """The chain-free kernel's device ms, the chain kernel's and every
    device kernel's (the wrapper's sums of the partial rows among them) in
    one backward call on each of ``k2f_frames``."""
    cornell = rt.cornell_box()
    out = {}
    for name, cfg, seed in k2f_frames():
        res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
        g = seeded((cfg.height, cfg.width, 3), seed)
        k = device_kernels(lambda: render_bwd.render_replay_bwd(
            cornell, cfg, res, g))
        out[name] = {"ms": kernel_ms(k, "render_bwd_free_kernel"),
                     "chain_ms": kernel_ms(k, "render_bwd_kernel"),
                     "all_device_ms": sum(k.values()), "kernels_ms": k}
    return out


# The pieces of the chain-free kernel with one block a tile of 128 pixels
# (15.5 waves at full_1024), each cut from a patched copy timed by ``--k2f-ms``
# (``k2f_split``); each is a time, not a result, and reads null in a
# checkout whose sources lack its text.
# (a) No camera sums: lane 0 adds its own 21 camera terms, no shuffles.
K2F_NO_CAMERA = {
    "bwd_body.cuh": (
        ("  // --- camera cotangents: the warp's 21 sums ---\n"
         "  warp_camera(REPLAY_WCAM, dcam);",
         "  if ((threadIdx.x & 31) == 0)\n"
         "    for (int i = 0; i < kCamCols; ++i) REPLAY_WCAM[i] += dcam[i];"),),
}
# (b) No object scatter and no carry: a lane folds each primary row's
# cotangent into one float, and lane 0 adds it to the accumulator at the
# pixel's end.
K2F_NO_SCATTER = {
    "render_bwd.cu": (
        ("  int carry_id;\n", "  int carry_id;\n  float sink;\n"),
        ("    tb.carry_id = -1;\n",
         "    tb.carry_id = -1;\n    tb.sink = 0.0f;\n"),
        ("    if (Carry && site == 0) {\n"
         "      const bool change = carry_id >= 0 && id >= 0 && id != carry_id;\n"
         "      if (__any_sync(kFull, change)) warp_scatter(wacc, change ? "
         "carry_id : -1, carry);\n"
         "      if (id >= 0) {\n"
         "        carry = id == carry_id ? add_grad(carry, g) : g;\n"
         "        carry_id = id;\n"
         "      }\n"
         "    } else {\n",
         "    if (Carry && site == 0) {\n"
         "      if (id >= 0)\n"
         "        sink += g.v0.x + g.v0.y + g.v0.z + g.e1.x + g.e1.y + g.e1.z"
         " + g.e2.x +\n"
         "                g.e2.y + g.e2.z + g.n.x + g.n.y + g.n.z + g.rgb.x"
         " + g.rgb.y +\n"
         "                g.rgb.z + g.r2;\n"
         "    } else {\n"),
        ("    if (Carry) {\n"
         "      warp_scatter(wacc, carry_id, carry);\n"
         "      carry_id = -1;\n"
         "    }\n",
         "    if (Carry && (threadIdx.x & 31) == 0) wacc[0] += sink;\n")),
}
# (c) No staging divide: a warp stages a row, a lane a column (both
# kernels' STAGE_TABLES; only the chain-free kernel is timed).
K2F_ROW_STAGING = {
    "render_bwd.cu": (
        ("  for (int i = threadIdx.x; i < n_obj * kObjCols; i += blockDim.x) {"
         "                       \\\n"
         "    const int o = i / kObjCols, c = i - o * kObjCols;"
         "                                      \\\n",
         "  for (int oc = threadIdx.x; oc < n_obj * 32; oc += blockDim.x) {  \\\n"
         "    const int o = oc >> 5, c = oc & 31;                              \\\n"
         "    if (c >= kObjCols) continue;                                     \\\n"
         "    const int i = o * kObjCols + c;                                  \\\n"),),
}
# (d) No pre-pass: the wrapper puts each pixel's chain flag (from the
# record and the materials, by torch ops before the launch) into the list
# buffer, and the kernel reads it there in place of A ids and their
# materials.
K2F_LISTED = {
    "render_bwd.cu": (
        ("  bool has_chain = false;\n"
         "  if (p < n_pix && P.bounces > 0) {\n"
         "    const int A = P.aa_x * P.aa_y;\n"
         "    for (int a = 0; a < A; ++a) {\n"
         "      const int id = pid[a * n_pix + p];\n"
         "      if (id >= 0) {\n"
         "        const float mat = id < P.n_tri ? g_tri[id * kTriCols + 15]\n"
         "                                       : g_sph[(id - P.n_tri) * "
         "kSphCols + 7];\n"
         "        has_chain = has_chain || mat <= 0.0f;\n"
         "      }\n"
         "    }\n"
         "  }\n",
         "  const bool has_chain = p < n_pix && P.bounces > 0 && list[p] != 0;\n"),),
    "kernels/render_bwd.py": (
        ("                blocks = partial_b.shape[0]\n",
         "                blocks = partial_b.shape[0]\n"
         "                mat_k = torch.cat([tri[:, 15], sph[:, 7]])\n"
         "                pid_k = res_b.prim_id.reshape(A, -1).long()\n"
         "                flag = ((pid_k >= 0)\n"
         "                        & (mat_k[pid_k.clamp(min=0)] <= 0)).any(0)\n"
         "                lists[:flag.numel()] = flag.int()\n"),),
}
# (e) One partial row per SM slot (4 blocks an SM on 132 SMs): blocks past
# the first 528 neither zero their accumulators nor write their row.
K2F_SLOT_ROWS = {
    "render_bwd.cu": (
        ("  if (!__syncthreads_or(in_img)) {\n"
         "    zero_partial_row(partial, P);\n"
         "    return;\n"
         "  }\n",
         "  const bool slot_row = blockIdx.x < 4 * 132;\n"
         "  if (!__syncthreads_or(in_img)) {\n"
         "    if (slot_row) zero_partial_row(partial, P);\n"
         "    return;\n"
         "  }\n"),
        ("  STAGE_TABLES();\n  float* col = acc",
         "  const bool slot_row = true;\n  STAGE_TABLES();\n  float* col = acc"),
        ("  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x)"
         " acc[i] = 0.0f;",
         "  for (int i = threadIdx.x; slot_row && i < kWarps * acc_cols;"
         " i += blockDim.x) acc[i] = 0.0f;"),
        ("  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {",
         "  for (int i = threadIdx.x; slot_row && i < acc_cols;"
         " i += blockDim.x) {")),
}
K2F_PIECES = (("a_no_camera", K2F_NO_CAMERA), ("b_no_scatter", K2F_NO_SCATTER),
              ("c_row_staging", K2F_ROW_STAGING), ("d_listed", K2F_LISTED),
              ("e_slot_rows", K2F_SLOT_ROWS))
# The same cuts on the tile-range grid (a checkout with
# ``render_bwd.free_grid``), and that grid taken over n waves in place of
# ``render_bwd.FREE_WAVES`` (the slots scaled: more waves, fewer tiles a
# block and more fixed work, the card's scheduler balancing the blocks).
K2F_GRID_NO_CAMERA = {
    "render_bwd.cu": (
        ("  tb.flush();\n\n  // --- camera cotangents: the warp's 21 sums ---\n"
         "  warp_camera(wacc + n_obj * kGradCols, dcam);",
         "  tb.flush();\n  if ((threadIdx.x & 31) == 0)\n"
         "    for (int i = 0; i < kCamCols; ++i) wacc[n_obj * kGradCols + i] += "
         "dcam[i];"),),
}
K2F_GRID_NO_SCATTER = {
    "render_bwd.cu": (("  tb.carry_id = -1;\n",
                       "  tb.carry_id = -1;\n  tb.sink = 0.0f;\n"),) + tuple(
        sub for sub in K2F_NO_SCATTER["render_bwd.cu"]
        if not sub[0].startswith("    tb.carry_id")),
}


def _waves(n: int) -> dict:
    return {"kernels/render_bwd.py": (
        ("        slots = free_slots(dev, n_obj)\n",
         f"        slots = free_slots(dev, n_obj) * {n} // FREE_WAVES\n"),)}


K2F_GRID_PIECES = (("a_no_camera", K2F_GRID_NO_CAMERA),
                   ("b_no_scatter", K2F_GRID_NO_SCATTER),
                   ("c_row_staging", K2F_ROW_STAGING),
                   ("f_one_wave", _waves(1)), ("g_four_waves", _waves(4)))


def free_balance(chain_pix, slots: int) -> dict:
    """How evenly a grid of at most ``slots`` blocks, each taking T whole
    tiles of 128 pixels, shares the chain-free pixels (``chain_pix``: bool
    per pixel, True where the pixel is listed): for contiguous ranges of T
    tiles and for tiles dealt out in turn (block b taking b, b + grid,
    ...), the most chain-free pixels a block gets over the mean, with T
    the fewest whole tiles a block that fit ``slots`` blocks."""
    free = (~chain_pix.reshape(-1)).to(torch.int64)
    pad = -free.numel() % render_bwd.THREADS
    per_tile = torch.cat([free, free.new_zeros(pad)]).reshape(
        -1, render_bwd.THREADS).sum(dim=1)
    n = per_tile.numel()
    t = -(-n // slots)
    grid = -(-n // t)
    tiles = torch.cat([per_tile, per_tile.new_zeros(grid * t - n)])
    out = {"tiles_a_block": t, "grid": grid}
    for name, sums in (("contiguous", tiles.reshape(grid, t).sum(dim=1)),
                       ("dealt", tiles.reshape(t, grid).sum(dim=0))):
        out[name] = {"max_over_mean": float(sums.max()) / float(
            sums.float().mean()), "max": int(sums.max()),
            "min": int(sums.min())}
    return out


def k2f_split(out: dict) -> None:
    """K2's chain-free kernel less each of its pieces (``K2F_PIECES``, or
    ``K2F_GRID_PIECES`` on the tile-range grid) on ``k2f_frames``: the
    checkout's own kernel from an unpatched copy (``build/k2f_base/``)
    before the first piece and after each, every
    piece from its patched copy (``build/k2f_<piece>/``), each timed by
    ``--k2f-ms`` in a process of its own; a piece's time beside the mean
    of the two runs around it. Then the kernel's ptxas registers, spills
    and stack, its blocks an SM (the runtime's count where the checkout
    has the query, else the occupancy rule), its grid and waves, and the
    pixels it lists."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(tag, patch):
        try:
            return patched_ms(tag, patch, False, "--k2f-ms")
        except subprocess.CalledProcessError:     # it did not build or run
            return None
    pieces = (K2F_GRID_PIECES if hasattr(render_bwd, "free_grid")
              else K2F_PIECES)
    runs = [("base", timed("k2f_base", {}))]
    for name, patch in pieces:
        runs.append((name, timed(f"k2f_{name}", patch)))
        runs.append(("base", timed("k2f_base", {})))
    cornell = rt.cornell_box()
    n_obj = cornell.num_triangles + cornell.num_spheres
    resources = flops.kernel_resources(render_bwd.FREE_SYMBOL)
    rows = {"sms": sms, "order": [n for n, _ in runs]}
    for frame, cfg, _ in k2f_frames():
        res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
        A, n_pix = cfg.aa_rays, cfg.width * cfg.height
        chain_pix = flops.chain_rays(cornell, cfg, res).reshape(
            A, -1).any(dim=0)
        tiles = -(-n_pix // render_bwd.THREADS)
        if hasattr(render_bwd, "free_grid"):      # the tile-range grid
            per_sm = render_bwd.free_blocks_per_sm(n_obj)
            grid, per_block = render_bwd.free_grid(n_pix, per_sm * sms)
            smem = render_bwd.free_shared_bytes(n_obj, per_block)
        else:
            smem = 4 * (n_obj * 17 + 21 + 4 * (n_obj * 16 + 21))
            per_sm = blocks_per_sm_formula(resources["registers"], smem)
            grid = tiles
        base = [r[frame]["ms"] for n, r in runs if n == "base" and r]
        row = {"base_ms": base, "pieces": {},
               "kernels_ms": runs[0][1][frame]["kernels_ms"]
               if runs[0][1] else None,
               "resources": resources, "shared_bytes": smem,
               "blocks_per_sm": per_sm, "blocks_per_sm_formula":
               blocks_per_sm_formula(resources["registers"], smem),
               "tiles": tiles, "grid_blocks": grid,
               "waves": grid / (per_sm * sms), "pixels": n_pix,
               "listed_pixels": int(chain_pix.sum()),
               "partial_rows": grid,
               "balance": free_balance(chain_pix, per_sm * sms)}
        for i, (name, r) in enumerate(runs):
            if name == "base":
                continue
            around = [x[frame]["ms"] for _, x in (runs[i - 1], runs[i + 1])
                      if x]
            ms = r[frame]["ms"] if r else None
            ref = sum(around) / len(around) if around else None
            row["pieces"][name] = {
                "ms": ms, "base_around_ms": around,
                "saved_ms": None if ms is None or ref is None else ref - ms,
                "saved_share": None if ms is None or ref is None
                else (ref - ms) / ref,
                "all_device_ms": r[frame]["all_device_ms"] if r else None}
        rows[frame] = row
    out["k2f_split"] = rows


# ---------------------------------------------------------------------------
# K4, the tp route's per-shard nearest-hit scan (--split k4, --k4-ms)
# ---------------------------------------------------------------------------

# the 600-triangle shard's frame (chip_smoke.py phase 10a): 128x16 aa4 s3 b2
CFG_MID = RenderConfig(width=128, height=16, aa_x=2, aa_y=2,
                       shadow_samples=3, bounces=2)
K4_OUTS = ("t", "pos", "nrm", "rgb", "mat", "idx")


def k4_frames():
    """{frame: [argument tuple of each ``nearest_tris`` call]}: the three
    batches of the dense_8192 frame through the kernel route (65,536 rays x
    8,192 rows), the same rays against each tp=2 rank's shard (rows 0-4,095
    and 4,096-8,191, as ``render_image_sharded`` slices them), and the three
    batches of the 600-triangle frame at 128x16 (8,192 rays x 600 rows)."""
    calls = recorded_batches(dense_scene(8192), CFG_BIG)["nearest"]
    half = calls[0][0].shape[0] // 2
    return {
        "dense_8192": calls,
        "tp2_rank0": [tuple(x[:half] for x in a[:6]) + a[6:] for a in calls],
        "tp2_rank1": [tuple(x[half:] for x in a[:6]) + a[6:] for a in calls],
        "dense_600": recorded_batches(dense_scene(600), CFG_MID)["nearest"],
    }


def k4_ms(npz: str | None = None) -> dict:
    """K4's device ms on each batch of ``k4_frames`` (torch.profiler, mean
    of 10 launches); with ``npz`` its outputs on every batch saved there."""
    out, saved = {}, {}
    for frame, batches in k4_frames().items():
        ms = [kernel_ms(device_kernels(lambda a=a: partial.nearest_tris(*a)),
                        "nearest_tris_kernel") for a in batches]
        out[frame] = {"ms": ms, "mean_ms": sum(ms) / len(ms),
                      "rays": int(batches[0][6].shape[0]),
                      "rows": int(batches[0][0].shape[0])}
        for i, a in enumerate(batches):
            for name, x in zip(K4_OUTS, partial.nearest_tris(*a)):
                saved[f"k4_{frame}_{i}_{name}"] = x.cpu().numpy()
    if npz:
        os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
        np.savez_compressed(npz, **saved)
        out["npz"] = npz
    return out


# The pieces of K4, each a patch of the sources timed by ``--k4-ms`` in a
# process of its own (``k4_split``): (c) one and two thread groups a ray in
# place of four, (d) the row with its accept test but no 1.0f / detA (a
# time, not a result; it changes which rows are accepted).
def k4_groups_patch(groups: int) -> dict:
    return {"partial.cu": (("constexpr int kNearGroups = 4;",
                            f"constexpr int kNearGroups = {groups};"),),
            "kernels/partial.py": (("NEAR_GROUPS = 4\n",
                                    f"NEAR_GROUPS = {groups}\n"),)}


K4_PIECES = (
    ("c_groups_1", k4_groups_patch(1)),
    ("c_groups_2", k4_groups_patch(2)),
    ("d_no_division", {"partial.cu": (
        ("  const float recip = 1.0f / (degen ? 1.0f : detA);\n"
         "  const float t = cofactor_det(b, C) * recip;",
         "  const float recip = degen ? 1.0f : detA;\n"
         "  const float t = cofactor_det(b, C) * recip;"),)}))

# operations a row test took before the redesign: fwd_common.cuh's
# tri_test, four det3 of 14 (flops.NEAREST_ROW_OPS is the present row's)
K4_PARENT_ROW_OPS = 70


def k4_split(out: dict) -> None:
    """K4's device ms on ``k4_frames`` from an unpatched copy
    (``build/k4_base/``) before the first piece and after each, and each
    piece (``K4_PIECES``) from its patched copy (``build/k4_<piece>/``),
    each timed by ``--k4-ms`` in a process of its own; then, for each
    frame, the kernel's ptxas registers and spills, the blocks an SM (the
    runtime's count), the grid and the warps an SM, its row loop's SASS,
    and its share of the bound at this row's count
    (``flops.nearest_work``) and at the parent's 70 operations a row, at
    the data sheet's 67 TFLOP/s and at K6's add chain measured in this
    process."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(tag, patch):
        try:
            return patched_ms(tag, patch, False, "--k4-ms")
        except subprocess.CalledProcessError:     # it did not build or run
            return None
    runs = [("base", timed("k4_base", {}))]
    for name, patch in K4_PIECES:
        runs.append((name, timed(f"k4_{name}", patch)))
        runs.append(("base", timed("k4_base", {})))
    peak = flops.measure_fp32_peak()
    rows = {"sms": sms, "order": [n for n, _ in runs],
            "k6_add_k16_ops_per_s": peak["add"]}
    res = flops.kernel_resources("nearest_tris_kernel")
    per_sm = partial.nearest_blocks_per_sm()
    try:
        loops = flops.sass_census("nearest_tris_kernel")["loops"]
        loop = max(loops, key=lambda lp: lp["fp32"]) if loops else None
    except Exception as e:  # noqa: BLE001 - no cuobjdump: say so
        loop = f"no census: {e}"
    for frame, batches in k4_frames().items():
        n_rays, n_tri = int(batches[0][6].shape[0]), int(batches[0][0].shape[0])
        grid = partial.nearest_grid(n_rays)
        base = [r[frame]["mean_ms"] for n, r in runs if n == "base" and r]
        ms = sum(base) / len(base) if base else None
        row = {"rays": n_rays, "rows": n_tri, "base_ms": base,
               "base_batch_ms": runs[0][1][frame]["ms"] if runs[0][1] else None,
               "groups": partial.NEAR_GROUPS, "resources": res,
               "blocks_per_sm": per_sm, "grid_blocks": grid,
               "warps_an_sm": grid * 4 / sms,
               "resident_warps_an_sm": min(grid / sms, per_sm) * 4,
               "row_loop_sass": loop, "pieces": {}, "share": {}}
        work = flops.nearest_work(n_tri, n_rays)
        parent_work = (work[0], n_rays * (K4_PARENT_ROW_OPS * n_tri + 20))
        for ops, w in ((flops.NEAREST_ROW_OPS, work),
                       (K4_PARENT_ROW_OPS, parent_work)):
            b_sheet = flops.bound(*w)[0]
            b_peak = flops.bound(*w, peak_fp32=peak["add"])[0]
            row["share"][ops] = {
                "bound_ms_data_sheet": b_sheet, "bound_ms_k6_peak": b_peak,
                "share_data_sheet": b_sheet / ms if ms else None,
                "share_k6_peak": b_peak / ms if ms else None}
        for i, (name, r) in enumerate(runs):
            if name == "base":
                continue
            around = [x[frame]["mean_ms"] for _, x in (runs[i - 1], runs[i + 1])
                      if x]
            p_ms = r[frame]["mean_ms"] if r else None
            ref = sum(around) / len(around) if around else None
            row["pieces"][name] = {
                "ms": p_ms, "batch_ms": r[frame]["ms"] if r else None,
                "base_around_ms": around,
                "saved_share": None if p_ms is None or ref is None
                else (ref - p_ms) / ref}
        rows[frame] = row
    out["k4_split"] = rows


def bwd_routing(out: dict) -> None:
    """K2 against K3b and its segmented sum, pinned by ``_kernel``, on the
    Cornell box at the five baseline configs (device ms per call)."""
    rows = {}
    for name, cfg in baseline_configs().items():
        scene = rt.cornell_box(
            spheres=not cfg.cpu_ref,
            shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE)
        res = render_fwd.render_fused_res(scene, cfg, quads=None)[2]
        g = seeded((cfg.height, cfg.width, 3), 81)
        row = {}
        for kern in ("whole", "streamed"):
            k = device_kernels(lambda kk=kern: render_bwd.render_replay_bwd(
                scene, cfg, res, g, _kernel=kk), 5)
            if kern == "whole":
                row["k2_ms"] = kernel_ms(k, *K2_NAMES)
            else:
                row["k3b_ms"] = kernel_ms(k, "render_bwd_streamed_kernel")
                row["segment_sum_ms"] = kernel_ms(k, "segment_sum")
                row["k3b_plus_sum_ms"] = row["k3b_ms"] + row["segment_sum_ms"]
            row[f"{kern}_all_device_ms"] = sum(k.values())
            row[f"{kern}_wrapper_ms"] = event_ms(
                lambda kk=kern: render_bwd.render_replay_bwd(
                    scene, cfg, res, g, _kernel=kk), 2, 5)
        rows[name] = row
    out["bwd_routing"] = rows


def save_backward(saved: dict, key: str, scene, cfg, res, g) -> None:
    """The gradients and the replayed image of one backward call."""
    bar, img = render_bwd.render_replay_bwd(scene, cfg, res, g,
                                            return_primal=True)
    saved[f"{key}_img"] = img.cpu().numpy()
    for f in dataclasses.fields(bar):
        saved[f"{key}_grad_{f.name}"] = getattr(bar, f.name).cpu().numpy()


def default_pass(out: dict, npz: str | None) -> None:
    """The device times of the kernels old beside new (module docstring)."""
    saved = {}
    k1_times(out, saved if npz else None)
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
    out["k3b_all_device_ms"] = sum(k.values())
    save_backward(saved, "k3b_dense_8192", big, CFG_BIG, res_t, g_big)

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
    out["index_add_ms"] = event_ms(lambda: render_bwd.segment_sum_plain(
        ids, rows, n_tri), 3, 9)

    target = rt.render_image(big, CFG_BIG) * 0.9
    out["train_step_ms"] = event_ms(lambda: train_step(
        big, target, CFG_BIG, lr=1e-3, trainable=("light_pos", "tri_rgb")))

    # the partial scans on the kernel route's batches
    calls = recorded_batches(big, CFG_BIG)
    out["k4_ms"] = [kernel_ms(device_kernels(
        lambda a=a: partial.nearest_tris(*a)), "nearest_tris_kernel")
        for a in calls["nearest"]]
    out["k5_ms"] = [kernel_ms(device_kernels(
        lambda a=a: partial.occluded_tris(*a)), "occluded_tris_kernel")
        for a in calls["occluded"]]
    for i, a in enumerate(calls["occluded"]):
        saved[f"k5_bits_{i}"] = partial.occluded_tris(*a).cpu().numpy()
    for i, a in enumerate(calls["nearest"]):
        for name, x in zip(K4_OUTS, partial.nearest_tris(*a)):
            saved[f"k4_{i}_{name}"] = x.cpu().numpy()

    # the whole-table backward: full_1024, deep on the mirror box, K2'
    cornell = rt.cornell_box()
    cfg = RenderConfig()
    res = render_fwd.render_fused_res(cornell, cfg, quads=None)[2]
    g = seeded((1024, 1024, 3), 11)
    backward_times(out, "k2_full_1024", lambda: render_bwd.render_replay_bwd(
        cornell, cfg, res, g), K2_NAMES)
    out["k2_full_1024_wrapper_ms"] = event_ms(
        lambda: render_bwd.render_replay_bwd(cornell, cfg, res, g), 2, 7)
    mirror = mirror_box(cornell)
    cfg_m = mirror_cfg(512)
    res_m = render_fwd.render_fused_res(mirror, cfg_m)[2]
    g_m = seeded((512, 512, 3), 71)
    backward_times(out, "k2_deep_mirror", lambda: render_bwd.render_replay_bwd(
        mirror, cfg_m, res_m, g_m), K2_NAMES, n=5)
    for key, sc, c, r, gg in (("full_1024", cornell, cfg, res, g),
                              ("mirror", mirror, cfg_m, res_m, g_m)):
        save_backward(saved, f"k2_{key}", sc, c, r, gg)
    if npz:       # the chain kernel's other frames (--split k2c)
        for key, sc, c, seed in k2c_frames():
            if key not in ("full_1024", "mirror_box_512"):
                r = render_fwd.render_fused_res(sc, c, quads=None)[2]
                save_backward(saved, f"k2c_{key}", sc, c, r,
                              seeded((c.height, c.width, 3), seed))
    d600 = dense_scene(600)
    res6 = render_fwd.render_fused_res(d600, CFG_BIG, _kernel="whole")[2]
    g6 = seeded((128, 128, 3), 61)
    backward_times(out, "k2p_600", lambda: render_bwd.render_replay_bwd(
        d600, CFG_BIG, res6, g6, _kernel="whole"), K2_NAMES)
    m600 = mirror_box(d600)
    cfg_m6 = mirror_cfg(256)
    res_m6 = render_fwd.render_fused_res(m600, cfg_m6)[2]
    g_m6 = seeded((256, 256, 3), 71)
    backward_times(out, "k3b_deep_mirror", lambda: render_bwd.render_replay_bwd(
        m600, cfg_m6, res_m6, g_m6), ("render_bwd_streamed_kernel",), n=5)
    save_backward(saved, "k3b_mirror_600", m600, cfg_m6, res_m6, g_m6)
    bwd_routing(out)

    twin = twin_for(cornell, cfg, res)
    out["k7_full_1024_ms"] = kernel_ms(device_kernels(twin["run"]),
                                       "bwd_twin")
    out["k7_pool"] = ({k: twin[k]["n_pool"] for k in ("free", "chain")
                       if twin[k]} if "chain" in twin else twin["n_pool"])
    out["k2_resources"] = flops.kernel_resources("render_bwd_kernel<false>")
    if npz:
        os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
        np.savez_compressed(npz, **saved)
        out["npz"] = npz


def compare(a: str, b: str) -> dict:
    """Per array of two ``--npz`` files: bit-equal, the worst absolute
    difference, and max|a-b| / max(max|a|, 1); and whether all are
    bit-equal."""
    out = {}
    with np.load(a) as za, np.load(b) as zb:
        for k in sorted(set(za.files) & set(zb.files)):
            x, y = np.atleast_1d(za[k]), np.atleast_1d(zb[k])
            diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
            worst = float(diff.max()) if diff.size else 0.0
            scale = max(float(np.abs(x).max()) if x.size else 0.0, 1.0)
            out[k] = {"bit_equal": bool(np.array_equal(
                x.view(np.uint8), y.view(np.uint8))),
                      "max_abs": worst, "rel": worst / scale}
    out["all_bit_equal"] = all(v["bit_equal"] for v in out.values())
    return out


def anonymous_free(name: str) -> str:
    """A mangled function name with each anonymous namespace's identifier
    (which carries a hash of the source's path) cut to its file's name, so
    that two checkouts' builds name a kernel alike."""
    out, i = [], 0
    for m in re.finditer(r"(\d+)_GLOBAL__N__", name):
        if m.start() < i:
            continue
        end = m.start(1) + len(m.group(1)) + int(m.group(1))
        ident = name[m.end(1):end]
        f = re.match(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_[0-9a-f]+$", ident)
        out += [name[i:m.start()], f"<{f.group(1) if f else 'anon'}>"]
        i = end
    return "".join(out) + name[i:]


def sass_compare(a: str, b: str) -> dict:
    """Per kernel function of two built libraries: its SASS instruction
    totals in each and whether its instruction and opcode counts are equal
    (None where one library lacks it); and the functions that differ."""
    def census(lib):
        proc = subprocess.run([_build.tool("cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True)
        return {anonymous_free(name): flops.sass_counts(f["instrs"])
                for name, f in flops.parse_sass(proc.stdout).items()}
    ca, cb = census(a), census(b)
    out = {}
    for name in sorted(set(ca) | set(cb)):
        x, y = ca.get(name), cb.get(name)
        out[name] = {"total": [None if x is None else x["total"],
                               None if y is None else y["total"]],
                     "equal": None if x is None or y is None else x == y}
    return {"kernels": out,
            "differ": [k for k, v in out.items() if v["equal"] is not True]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default=os.path.basename(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--npz", default=None)
    ap.add_argument("--split", nargs="?", const="all", default=None,
                    choices=("k1", "k2k5", "k3b", "k2c", "k2f", "k4", "all"))
    ap.add_argument("--k3b-ms", action="store_true")
    ap.add_argument("--k2c-ms", action="store_true")
    ap.add_argument("--k2f-ms", action="store_true")
    ap.add_argument("--k4-ms", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="NPZ", default=None)
    ap.add_argument("--sass", nargs=2, metavar="LIB", default=None)
    args = ap.parse_args()
    if args.compare:
        out = {"compare": args.compare, **compare(*args.compare)}
    elif args.sass:
        out = {"sass": args.sass, **sass_compare(*args.sass)}
    else:
        if not torch.cuda.is_available():
            raise SystemExit("chip_timing: no CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        out = {"tag": args.tag, "card": card, "source": ROOT,
               "pass": (f"split {args.split}" if args.split
                        else "k3b" if args.k3b_ms
                        else "k2c" if args.k2c_ms
                        else "k2f" if args.k2f_ms
                        else "k4" if args.k4_ms
                        else "k7" if args.k7 else "default")}
        if args.k3b_ms:
            out["k3b_ms"] = k3b_ms()
        if args.k2c_ms:
            out["k2c_ms"] = k2c_ms()
        if args.k2f_ms:
            out["k2f_ms"] = k2f_ms()
        if args.k4_ms:
            out["k4_ms"] = k4_ms(args.npz)
        if args.k7:
            k7_pass(out)
        if args.split in ("k1", "all"):
            k1_split(out)
        if args.split in ("k2k5", "all"):
            split_pass(out)
        if args.split in ("k3b", "all"):
            k3b_split(out)
        if args.split in ("k2c", "all"):
            k2c_split(out)
        if args.split in ("k2f", "all"):
            k2f_split(out)
        if args.split in ("k4", "all"):
            k4_split(out)
        if not (args.split or args.k3b_ms or args.k2c_ms or args.k2f_ms
                or args.k4_ms or args.k7):
            default_pass(out, args.npz)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    sys.exit(main())
