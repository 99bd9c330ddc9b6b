"""The port's oracle-parity record: the kernels on the card against the
port's NumPy oracle (``uob_raytracer_tpu_torch.reference``).

    python3 parity_torch.py                     # on the card; writes
                                                # docs/port_parity_h100.json
    python3 parity_torch.py --device cpu --size 32 --out f.json
                                                # rehearsal: plain versions

Cases: the five ``baseline_configs()`` at 256x256, the same five at their
own sizes (cpu_ref_256's own size is 256x256, so it is one case), and
``debug.dense_scene(600)`` at 64x64, 2x2 AA, 3 shadow samples, 2 bounces,
which routes to the streamed kernels. For each case:

- the image of ``render()`` (the main path: the forward kernel, shadow quads
  detected) against ``render_oracle`` of the same scene and config: the %
  of pixels whose largest channel deviation exceeds 3e-4, the largest
  deviation, and the % of packed words that differ from
  ``pack_argb_np(oracle)``;
- the decision record of ``render_fused_res`` (the launch a training step
  makes, no quads) against ``render_fused_res_plain`` on the same device:
  the % of ``pid``, ``lit`` and ``bid`` entries that agree;
- the gradient: the worst relative error, max|a - b| / max(max|ref|, 1),
  over the scene's leaves of ``render_replay_bwd`` (the backward kernel)
  against ``render_replay_bwd_plain``, under one seeded cotangent; only up
  to 256x256 (``GRAD_MAX_PIXELS``), where the plain backward is cheap.

Then, at 64x64, the scalar C++ oracle against the NumPy oracle on the
baseline configs but glass_fresnel_512 (the C++ oracle has no Fresnel
weighting), with the tolerance of ``tests/test_oracle.py``.

The budget is PARITY.md's acceptance as the repo's tests apply it
(``tests/conftest.py:assert_images_match``, ``tests/test_render.py``): at
most 0.5% of pixels beyond 3e-4 and none beyond 0.45 (one flipped shadow
sample), at most 0.5% of packed words different, at least 99.5% of record
entries equal; the gradient within ``chip_smoke.py``'s budget (1e-4, 1e-3
where paths bounce twice or more through glass). The record (card name and
power limit, commit, each oracle's seconds) is written even when a case
breaks the budget; the script then prints the case and its numbers and
exits 1. Imports torch, numpy and the port, never jax.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import uob_raytracer_tpu_torch as rt
from uob_raytracer_tpu_torch import RenderConfig, ShadingModel, baseline_configs
from uob_raytracer_tpu_torch.debug import dense_scene
from uob_raytracer_tpu_torch.kernels import render_bwd, render_fwd
from uob_raytracer_tpu_torch.reference import pack_argb_np, render_oracle
from uob_raytracer_tpu_torch.scene import Scene

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "docs", "port_parity_h100.json")

# PARITY.md's acceptance: pixels beyond TIGHT, their share, the bound on any
# one pixel (a single flipped shadow sample at the brightest shaded points)
TIGHT, PCT_BUDGET, OUTLIER_BOUND = 3e-4, 0.5, 0.45
# the decision record: entries that agree, in %
RECORD_BUDGET = 99.5
# gradients (chip_smoke.py's GRAD_TOL, GRAD_TOL_GLASS)
GRAD_TOL, GRAD_TOL_GLASS = 1e-4, 1e-3
GRAD_MAX_PIXELS = 256 * 256
# tests/test_oracle.py: C++ vs NumPy, pixels beyond 1e-6 below 0.2% and none
# beyond 0.35; in cpu_ref mode none beyond 1e-6
CPP_TIGHT, CPP_FRAC, CPP_BOUND = 1e-6, 0.002, 0.35
DENSE = ("dense_600", 600,
         RenderConfig(width=64, height=64, shadow_samples=3, bounces=2))


# --------------------------------------------------------------------------
# Statistics (numpy or torch inputs, any device)
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _channel_dev(img, ref) -> np.ndarray:
    """Per-pixel largest channel deviation of two [H, W, 3] images."""
    a = _np(img).astype(np.float32)
    b = _np(ref).astype(np.float32)
    return np.abs(a - b).max(axis=-1)


def pct_over(img, ref, tol: float = TIGHT) -> float:
    """% of pixels whose largest channel deviation exceeds ``tol``."""
    return 100.0 * float((_channel_dev(img, ref) > tol).mean())


def max_dev(img, ref) -> float:
    """The largest channel deviation over the image."""
    return float(_channel_dev(img, ref).max())


def packed_mismatch_pct(packed, ref_packed) -> float:
    """% of packed ARGB words that differ."""
    a, b = _np(packed).view(np.uint32), _np(ref_packed).view(np.uint32)
    return 100.0 * float((a != b).mean())


def record_agreement_pct(res, ref) -> dict[str, float]:
    """% of the entries of ``pid``, ``lit`` and ``bid`` (two ``Residuals``)
    that agree; 100 for an empty field (no bounce steps)."""
    out = {}
    for name, a, b in zip(("pid", "lit", "bid"), res, ref):
        a, b = _np(a), _np(b)
        out[name] = 100.0 * float((a == b).mean()) if a.size else 100.0
    return out


def worst_leaf_error(ref: Scene, got: Scene) -> tuple[float, str]:
    """(worst relative error over the scene's non-empty leaves, its leaf):
    max|ref - got| / max(max|ref|, 1). A gradient that is not finite is
    reported as inf."""
    rel, leaf = 0.0, ""
    for f in dataclasses.fields(Scene):
        a, b = _np(getattr(ref, f.name)), _np(getattr(got, f.name))
        if not a.size:
            continue
        if not np.isfinite(b).all():
            return float("inf"), f.name
        r = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1.0)
        if r >= rel:
            rel, leaf = r, f.name
    return rel, leaf


def grad_budget(cfg: RenderConfig) -> float:
    return GRAD_TOL_GLASS if cfg.bounces >= 2 else GRAD_TOL


def breaches(case: dict) -> list[str]:
    """What in one case's record breaks the budget (empty when nothing)."""
    out = []
    if not case["pct_over_tol"] <= PCT_BUDGET:
        out.append(f"{case['pct_over_tol']:.4f}% of pixels beyond {TIGHT} "
                   f"(budget {PCT_BUDGET}%)")
    if not case["max_dev"] <= OUTLIER_BOUND:
        out.append(f"worst pixel {case['max_dev']:.4g} (budget "
                   f"{OUTLIER_BOUND})")
    if not case["packed_mismatch_pct"] <= PCT_BUDGET:
        out.append(f"{case['packed_mismatch_pct']:.4f}% of packed words "
                   f"differ (budget {PCT_BUDGET}%)")
    for k, v in case.get("record_agreement_pct", {}).items():
        if not v >= RECORD_BUDGET:
            out.append(f"record {k} agrees on {v:.4f}% (budget "
                       f"{RECORD_BUDGET}%)")
    if case.get("grad_worst_rel") is not None and not (
            case["grad_worst_rel"] <= case["grad_budget"]):
        out.append(f"gradient {case['grad_worst_leaf']} off by "
                   f"{case['grad_worst_rel']:.3g} (budget "
                   f"{case['grad_budget']})")
    return out


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------

def scene_for(cfg: RenderConfig, device) -> Scene:
    """The scene the CLI renders for a config: cpu_ref gets the sphere-free
    box with the HOST constants."""
    return rt.cornell_box(
        spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE,
        device=device)


def cases(size: int | None = None) -> list[tuple[str, int, RenderConfig]]:
    """(name, triangles, config): 0 triangles means the config's Cornell
    scene (``scene_for``). ``size`` renders the five configs and the dense
    scene at size x size (the own-size set would repeat them)."""
    configs = baseline_configs()
    at_256 = [(n, 0, dataclasses.replace(c, width=256, height=256))
              for n, c in configs.items()]
    if size:
        return [(n, t, dataclasses.replace(c, width=size, height=size))
                for n, t, c in at_256 + [DENSE]]
    own = [(n, 0, c) for n, c in configs.items()
           if (c.width, c.height) != (256, 256)]
    return at_256 + own + [DENSE]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cotangent(cfg: RenderConfig, device, seed: int = 0) -> torch.Tensor:
    g = np.random.RandomState(seed).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)
    return torch.from_numpy(g).to(device)


def run_case(name: str, n_tri: int, cfg: RenderConfig, device) -> dict:
    """One case's record (the module docstring's numbers)."""
    scene = (dense_scene(n_tri, device=device) if n_tri
             else scene_for(cfg, device))
    route = ("plain" if torch.device(device).type == "cpu" else
             "streamed" if render_fwd.use_streamed(scene.num_triangles,
                                                   scene.num_spheres)
             else "whole")
    out = rt.render(scene, cfg)
    _sync(device)
    t0 = time.perf_counter()
    oracle = render_oracle(scene, cfg)
    oracle_s = time.perf_counter() - t0
    case = {"case": f"{name} {cfg.width}x{cfg.height}", "config": name,
            "width": cfg.width, "height": cfg.height, "aa_rays": cfg.aa_rays,
            "shadow_samples": cfg.shadow_samples, "bounces": cfg.bounces,
            "triangles": scene.num_triangles, "kernels": route,
            "oracle_s": oracle_s,
            "pct_over_tol": pct_over(out.image, oracle),
            "max_dev": max_dev(out.image, oracle),
            "packed_mismatch_pct": packed_mismatch_pct(
                out.packed, pack_argb_np(oracle))}
    del out, oracle

    _, _, res = render_fwd.render_fused_res(scene, cfg)
    _, _, ref = render_fwd.render_fused_res_plain(scene, cfg)
    _sync(device)
    case["record_agreement_pct"] = record_agreement_pct(res, ref)
    del ref

    case["grad_budget"] = grad_budget(cfg)
    if cfg.width * cfg.height <= GRAD_MAX_PIXELS:
        g = cotangent(cfg, device)
        got = render_bwd.render_replay_bwd(scene, cfg, res, g)
        ref = render_bwd.render_replay_bwd_plain(scene, cfg, res, g)
        _sync(device)
        case["grad_worst_rel"], case["grad_worst_leaf"] = worst_leaf_error(
            ref, got)
    else:
        case["grad_worst_rel"] = case["grad_worst_leaf"] = None
    case["breaches"] = breaches(case)
    return case


def cpp_vs_numpy(size: int = 64) -> list[dict]:
    """The scalar C++ oracle against the NumPy oracle at size x size (CPU
    scenes), with ``tests/test_oracle.py``'s tolerance, on the baseline
    configs it implements: all but glass_fresnel_512, since the C++ oracle
    has no Fresnel weighting (an extension beyond the reference)."""
    from uob_raytracer_tpu_torch.reference.cpp_oracle import render_cpp_oracle
    out = []
    for name, cfg in baseline_configs().items():
        if cfg.fresnel:
            continue
        cfg = dataclasses.replace(cfg, width=size, height=size)
        scene = scene_for(cfg, "cpu")
        a = render_oracle(scene, cfg)
        b = render_cpp_oracle(scene, cfg)
        frac = float((_channel_dev(a, b) > CPP_TIGHT).mean())
        worst = max_dev(a, b)
        ok = (worst <= CPP_TIGHT if cfg.cpu_ref
              else frac < CPP_FRAC and worst <= CPP_BOUND)
        out.append({"config": name, "size": size, "frac_over_1e-6": frac,
                    "max_dev": worst, "ok": ok})
    return out


# --------------------------------------------------------------------------
# The record
# --------------------------------------------------------------------------

def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def git_commit() -> str:
    try:
        proc = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True)
    except OSError:
        return "unknown"
    return proc.stdout.strip() if proc.returncode == 0 else "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 parity_torch.py")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "plain versions (a rehearsal, no kernel)")
    p.add_argument("--size", type=int, default=None,
                   help="render every case at SIZE x SIZE")
    p.add_argument("--out", default=None,
                   help="where to write the record (default "
                        "docs/port_parity_h100.json on the card, nowhere on "
                        "the CPU)")
    p.add_argument("--commit", default=None,
                   help="the commit to name in the record (default: git "
                        "rev-parse HEAD, where the checkout is a git tree)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("parity_torch: no CUDA device (torch.cuda."
                         "is_available() is False); --device cpu rehearses "
                         "on the plain versions")
    out_path = args.out or (OUT if args.device == "cuda" else None)
    card = card_line(args.device)
    print(card, flush=True)

    t0 = time.perf_counter()
    record_cases = []
    for name, n_tri, cfg in cases(args.size):
        case = run_case(name, n_tri, cfg, args.device)
        record_cases.append(case)
        agree = case["record_agreement_pct"]
        grad = ("not run" if case["grad_worst_rel"] is None else
                f"{case['grad_worst_leaf']} {case['grad_worst_rel']:.3g}")
        print(f"{case['case']} ({case['kernels']}): {case['pct_over_tol']:.4f}"
              f"% beyond {TIGHT}, worst {case['max_dev']:.4g}, packed "
              f"{case['packed_mismatch_pct']:.4f}% differ; record agrees pid "
              f"{agree['pid']:.4f}% lit {agree['lit']:.4f}% bid "
              f"{agree['bid']:.4f}%; gradient {grad}; oracle "
              f"{case['oracle_s']:.2f} s", flush=True)
    cpp = cpp_vs_numpy()
    for c in cpp:
        print(f"C++ vs NumPy oracle {c['config']} {c['size']}x{c['size']}: "
              f"{c['frac_over_1e-6']:.4%} beyond {CPP_TIGHT}, worst "
              f"{c['max_dev']:.3g}", flush=True)

    failed = [(c["case"], b) for c in record_cases for b in c["breaches"]]
    failed += [(f"C++ vs NumPy {c['config']}", "beyond tests/test_oracle.py's "
                "tolerance") for c in cpp if not c["ok"]]
    record = {
        "method": "parity_torch.py: render() (the forward kernels) against "
                  "reference.oracle.render_oracle; render_fused_res against "
                  "render_fused_res_plain; render_replay_bwd against "
                  "render_replay_bwd_plain under a seeded cotangent",
        "card": card,
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "commit": args.commit or git_commit(),
        "torch": torch.__version__,
        "budget": {"tight": TIGHT, "pct_over_tol_max": PCT_BUDGET,
                   "max_dev_max": OUTLIER_BOUND,
                   "packed_mismatch_pct_max": PCT_BUDGET,
                   "record_agreement_pct_min": RECORD_BUDGET,
                   "grad_rel_max": [GRAD_TOL, GRAD_TOL_GLASS],
                   "grad_max_pixels": GRAD_MAX_PIXELS},
        "cases": record_cases,
        "cpp_vs_numpy": cpp,
        "oracle_s_total": sum(c["oracle_s"] for c in record_cases),
        "seconds": time.perf_counter() - t0,
        "ok": not failed,
    }
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {os.path.relpath(out_path, ROOT)}", flush=True)
    for case, what in failed:
        print(f"PARITY BREACH {case}: {what}", flush=True)
    print(json.dumps({"ok": record["ok"], "cases": len(record_cases),
                      "seconds": record["seconds"]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
