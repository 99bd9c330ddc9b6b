"""Debug layer of the port: NaN checks, the kernel launch list and the
compute-sanitizer runner.

The JAX package is functional, so its data races are impossible by
construction, and its debug tooling is ``checkify.float_checks`` (NaN checks
compiled into the graph) and the ``jax_debug_nans`` mode
(``tests/test_checkify.py``). The port's counterparts:

- ``nan_checks()``: a ``TorchDispatchMode`` that looks at the output of
  every aten operation run under it, forward and backward (the autograd
  engine carries the mode to the threads it runs the backward on), and
  raises ``FloatingPointError`` naming the first operation whose floating
  output holds a NaN. Infinities pass: a miss is ``t = inf`` by design
  (``ops/intersect.py``), and checkify's float checks do not report them
  either. The outputs of the allocating operations (``empty`` and its
  kin) are not values and are not looked at, nor are views (a slice, a
  reshape): they compute nothing, their values were looked at where they
  were made, and a slice of an allocation that a kernel has yet to fill
  (the streamed backward's per-site rows, zeroed band by band) holds
  whatever the memory held. Each checked output costs a
  reduction and, on the card, a synchronisation: a debugging tool, not a
  mode to time.
- ``launch_all()``: every CUDA kernel of the library launched once at a
  small size (``python -m uob_raytracer_tpu_torch.debug --launch-all``;
  ``--nan-check`` runs it under ``nan_checks()`` and exits non-zero at the
  first NaN, on the card or, with ``--device cpu``, through the plain
  versions).
  The port's kernels share memory between threads (the tiles of
  ``csrc/render_fwd.cu``, ``render_bwd.cu``, ``partial.cu``,
  ``twin_body.cuh``) and leave blocks early through ``__syncthreads_or``,
  so races are possible there; this list is the program a sanitizer runs.
- ``run_sanitizer(tool)``: that program under ``compute-sanitizer --tool
  {memcheck, racecheck, synccheck, initcheck}``, with the sanitizer's
  kernel filter limited to the port's kernels, and its report parsed
  (``parse_report``). A sanitizer that refuses the device raises
  ``SanitizerUnsupported``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# aten operations whose outputs are uninitialised memory, not values
_ALLOCATORS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "empty_permuted"})


class NaNChecks(TorchDispatchMode):
    """The dispatch mode of ``nan_checks``. ``checked`` counts the floating
    outputs looked at; ``ops`` counts them by operation name."""

    def __init__(self):
        super().__init__()
        self.checked = 0
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _ALLOCATORS or func.is_view:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.checked += 1
                self.ops[name] = self.ops.get(name, 0) + 1
                if bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in the output of {func} (shape "
                        f"{tuple(t.shape)}, {int(torch.isnan(t).sum())} NaN "
                        f"elements)")
        return out


def nan_checks() -> NaNChecks:
    """``with nan_checks() as mode:`` raises on the first operation whose
    floating output holds a NaN, forward or backward."""
    return NaNChecks()


# --------------------------------------------------------------------------
# The launch list
# --------------------------------------------------------------------------

MIRROR_FOCAL = 4400.0


def dense_scene(n_tri: int, seed: int = 1, device=None):
    """The Cornell box plus random small diffuse triangles inside it,
    ``n_tri`` triangles in all: the numpy recipe of the JAX package's
    ``bench.py:dense_scene``, from the same seed."""
    from . import add_triangles, cornell_box
    base = cornell_box(device=device)
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
    return add_triangles(base, verts, np.full((extra, 3), 0.6, np.float32),
                         np.ones((extra,), np.float32))


def mirror_box(scene):
    """The scene with the Cornell box's five walls (triangles 0-9) mirrored,
    seen from inside the box at (0, -0.3, 0) along the x axis (render it
    through the 2x zoom of ``focal_length=MIRROR_FOCAL``): rays bounce
    between the side walls, and many chains end on a block or a small
    triangle past 16 bounce steps (the mirror box of
    tests/test_torch_render_bwd.py)."""
    mat = scene.tri_mat.clone()
    mat[:10] = 0.0
    dev = mat.device
    return dataclasses.replace(
        scene, tri_mat=mat,
        camera_pos=torch.tensor([0.0, -0.3, 0.0], device=dev),
        yaw=torch.tensor(np.pi / 2, dtype=torch.float32, device=dev))


# Every kernel wrapper's launch counter: (kernel, module under kernels/,
# counter).
_COUNTERS = (
    ("K1/K1r render_fwd_kernel", "render_fwd", "LAUNCHES"),
    ("K3f render_fwd_streamed_kernel", "render_fwd", "STREAMED_LAUNCHES"),
    ("K2/K2'/K2 deep render_bwd_kernel", "render_bwd", "LAUNCHES"),
    ("K2f render_bwd_free_kernel", "render_bwd", "FREE_LAUNCHES"),
    ("K3b/K3b deep render_bwd_streamed_kernel", "render_bwd",
     "STREAMED_LAUNCHES"),
    ("segment_sum_tiles_kernel + segment_sum_runs_kernel", "render_bwd",
     "SEGMENT_SUM_LAUNCHES"),
    ("K4 nearest_tris_kernel", "partial", "NEAREST_LAUNCHES"),
    ("K5 occluded_tris_kernel", "partial", "OCCLUDED_LAUNCHES"),
    ("K6 peak_chain", "peak", "LAUNCHES"),
    ("census_probe_kernel", "peak", "PROBE_LAUNCHES"),
    ("floor_kernel (the launch floor)", "peak", "FLOOR_LAUNCHES"),
    ("K7f bwd_twin_free_kernel", "bwd_twin", "FREE_LAUNCHES"),
    ("K7c bwd_twin_chain_kernel", "bwd_twin", "LAUNCHES"),
)


def _module(name: str):
    return importlib.import_module(f"{__package__}.kernels.{name}")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel."""
    return {k: getattr(_module(m), a) for k, m, a in _COUNTERS}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel, as ``launch_counts`` names them) to the
    wrappers' launch counters: the launches a replayed CUDA graph makes
    without calling the wrappers."""
    for k, m, a in _COUNTERS:
        if counts.get(k):
            mod = _module(m)
            setattr(mod, a, getattr(mod, a) + counts[k])


def _cotangent(cfg, device, seed: int):
    g = np.random.RandomState(seed).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)
    return torch.as_tensor(g, device=device)


@torch.no_grad()
def launch_all(device="cuda", size: int = 64) -> dict[str, int]:
    """Launch every kernel of the library once or a few times at
    ``size`` x ``size`` and return the launches each wrapper counted
    (on the CPU the wrappers run their plain versions and count nothing):

    - K1 and K1r, the Cornell box at 2x2 AA, 10 samples, 10 bounces, with
      and without the shadow quads;
    - K2's one-launch form on that record, and its chain-free plus chain
      launches (the split is forced with ``render_bwd.SPLIT_RAYS = 0``, as
      the card tests do, in place of a frame of 2^20 rays);
    - K2's deep instance on the mirror box at 20 bounces;
    - K2' (the whole-table backward past 32 objects), K3f, K3b, K3b's deep
      instance (the 600-triangle mirror box) and the segmented sum's two
      kernels on the 600-triangle scene;
    - K4 and K5 on that scene's 600 triangles as one shard;
    - K6 at K=16, the census probe, the launch floor, and K7 on a
      1-bounce record, in one launch and split (free and chain twins,
      ``SPLIT_RAYS = 0``).
    """
    from . import RenderConfig, cornell_box
    from . import flops
    from .kernels import peak, render_bwd, render_fwd
    from .ops.camera import gen_primary_rays
    from .ops.intersect import in_shadow, intersect, prepare_scene
    from .ops.math3 import dot3
    from .ops.quads import detect_shadow_quads

    device = torch.device(device)
    before = launch_counts()
    cornell = cornell_box(device=device)
    cfg = RenderConfig(width=size, height=size, shadow_samples=10,
                       bounces=10)
    quads = detect_shadow_quads(cornell)
    for q in (None, quads):
        render_fwd.render_fused_raw(cornell, cfg, quads=q)
        res = render_fwd.render_fused_res(cornell, cfg, quads=q)[2]
    g = _cotangent(cfg, device, 0)
    render_bwd.render_replay_bwd(cornell, cfg, res, g)
    split_rays = render_bwd.SPLIT_RAYS
    render_bwd.SPLIT_RAYS = 0
    try:
        render_bwd.render_replay_bwd(cornell, cfg, res, g)
    finally:
        render_bwd.SPLIT_RAYS = split_rays

    deep = dataclasses.replace(cfg, aa_x=1, aa_y=1, shadow_samples=2,
                               bounces=20, focal_length=MIRROR_FOCAL)
    d600 = dense_scene(600, device=device)
    for scene in (mirror_box(cornell), mirror_box(d600)):
        res = render_fwd.render_fused_res(scene, deep)[2]
        render_bwd.render_replay_bwd(scene, deep, res, _cotangent(deep,
                                                                  device, 1))

    small = dataclasses.replace(cfg, shadow_samples=3, bounces=2)
    g = _cotangent(small, device, 2)
    for kernel in ("whole", "streamed"):
        res = render_fwd.render_fused_res(d600, small, _kernel=kernel)[2]
        render_bwd.render_replay_bwd(d600, small, res, g, _kernel=kernel)

    ds = prepare_scene(d600)
    dirs, _ = gen_primary_rays(small, d600.yaw, d600.pitch)
    d = dirs.reshape(-1, 3)
    hit = intersect(ds, ds.camera_pos.expand_as(d), d, tri_pass="kernel")
    sdir = ds.light_pos[None] - hit.pos
    in_shadow(ds, hit.pos + 1e-4 * sdir, sdir, dot3(sdir, sdir),
              tri_pass="kernel")

    x = torch.linspace(0.5, 1.5, 128 * 128, device=device)
    peak.peak_chain("fma", 16, x)
    peak.census_probe(x[:8 * 128])
    peak.floor_launch(x[:8 * 128])
    roof = dataclasses.replace(cfg, bounces=1)
    res = render_fwd.render_fused_res(cornell, roof)[2]
    flops.build_bwd_structure_twin(cornell, roof, res,
                                   target_registers=0)["run"]()
    render_bwd.SPLIT_RAYS = 0
    try:
        flops.build_bwd_structure_twin(cornell, roof, res,
                                       target_registers=0)["run"]()
    finally:
        render_bwd.SPLIT_RAYS = split_rays
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


# --------------------------------------------------------------------------
# compute-sanitizer
# --------------------------------------------------------------------------

SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# substrings of the port's kernels' mangled names: the sanitizer checks
# these and lets torch's own kernels run unchecked
KERNEL_SUBSTRINGS = ("render_fwd", "render_bwd", "segment_sum",
                     "nearest_tris", "occluded_tris", "peak_chain",
                     "census_probe", "floor_kernel", "bwd_twin")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SanitizerUnsupported(RuntimeError):
    """compute-sanitizer runs but refuses the device."""


def parse_report(text: str) -> dict:
    """Errors and hazards from a compute-sanitizer report: the numbers of
    its "ERROR SUMMARY: N errors" and "RACECHECK SUMMARY: N hazards ..."
    lines (0 where a line is absent), and whether it refused the device."""
    def total(pattern):
        return sum(int(m) for m in re.findall(pattern, text))
    return {"errors": total(r"ERROR SUMMARY:\s+(\d+) error"),
            "hazards": total(r"RACECHECK SUMMARY:\s+(\d+) hazard"),
            "unsupported": "Device not supported" in text}


def sanitizer_command(tool: str) -> list[str]:
    """The command that runs ``launch_all`` on the card under ``tool``."""
    from .kernels import _build
    if tool not in SANITIZER_TOOLS:
        raise ValueError(f"tool {tool!r}: one of {SANITIZER_TOOLS}")
    filters = [f"--kernel-name=kns={k}" for k in KERNEL_SUBSTRINGS]
    return [_build.tool("compute-sanitizer"), "--tool", tool,
            "--error-exitcode", "1", "--show-backtrace", "no", *filters,
            sys.executable, "-m", "uob_raytracer_tpu_torch.debug",
            "--launch-all"]


def run_sanitizer(tool: str, timeout: float = 600.0) -> dict:
    """Run the launch list under ``compute-sanitizer --tool <tool>``.
    Returns the parsed report with the exit code, the seconds and the
    report's text; raises ``SanitizerUnsupported`` where the sanitizer
    refuses the device."""
    from .kernels import _build
    _build.build()   # outside the sanitizer: nvcc need not run under it
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(sanitizer_command(tool), cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    text = proc.stdout + proc.stderr
    report = {"tool": tool, "rc": proc.returncode,
              "seconds": time.perf_counter() - t0, **parse_report(text),
              "text": text}
    if report["unsupported"]:
        raise SanitizerUnsupported(
            f"compute-sanitizer --tool {tool} refuses the device: "
            f"{text.strip().splitlines()[:3]}")
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m uob_raytracer_tpu_torch.debug")
    p.add_argument("--launch-all", action="store_true",
                   help="launch every kernel of the library once at 64x64 "
                        "(the program a sanitizer runs)")
    p.add_argument("--nan-check", action="store_true",
                   help="run the launch list under nan_checks() and exit "
                        "non-zero at the first NaN")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the launch list's plain versions")
    p.add_argument("--size", type=int, default=64,
                   help="the launch list's frame size (default 64)")
    args = p.parse_args(argv)
    if not (args.launch_all or args.nan_check):
        p.print_help()
        return
    mode = nan_checks() if args.nan_check else contextlib.nullcontext()
    try:
        with mode:
            counts = launch_all(args.device, size=args.size)
    except FloatingPointError as e:
        raise SystemExit(f"NaN check failed: {e}") from e
    out = {"device": args.device, "size": args.size, "launches": counts}
    if args.nan_check:
        out["nan_checked_outputs"] = mode.checked
    print(json.dumps(out), flush=True)
    missing = [k for k, n in counts.items() if n < 1]
    if args.device == "cuda" and missing:
        raise SystemExit(f"no launch of {missing}")


if __name__ == "__main__":
    main()
