"""The ray statistics and the work count of both configurations."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from rtbench import scenes, work
from rtbench.reference import render as ref
from rtbench.tests.conftest import REPO
from uob_raytracer_tpu_torch import flops
from uob_raytracer_tpu_torch.bench import _ray_count_stats
from uob_raytracer_tpu_torch.config import RenderConfig
from uob_raytracer_tpu_torch.scene import Scene


def _config(name):
    with open(os.path.join(REPO, "rtbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _small(name, **cut):
    c = _config(name)
    c["render"].update(width=16, height=16)
    c["scene"].update(cut)
    return c


def test_ray_stats_match_the_port_bench():
    for name, cut in (("cornell_1024", {}), ("dense_8192", {"n_tri": 300})):
        c = _small(name, **cut)
        leaves = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
                  scenes.build(c["scene"], 3).items()}
        p = ref.Params(**c["render"])
        n_prim, n_bounce, n_shaded = ref.ray_stats(leaves, p)
        want = _ray_count_stats(Scene(**leaves), RenderConfig(**c["render"]))
        assert (n_bounce, n_shaded) == want
        assert n_prim == 16 * 16 * p.aa_rays


def test_forward_count_is_the_jax_count_at_the_measured_fractions():
    """With every ray shaded and the bounce steps spread as live fractions,
    the count is the JAX package's forward_ops, term for term."""
    for name in ("cornell_1024", "dense_8192"):
        c = _config(name)
        p = ref.Params(**c["render"])
        n_tri = 26 if name == "cornell_1024" else c["scene"]["n_tri"]
        n_prim = p.width * p.height * p.aa_rays
        n_bounce = n_prim // 7
        fracs = [n_bounce / n_prim] + [0.0] * (p.bounces - 1)
        want = flops.forward_ops(RenderConfig(**c["render"]), n_tri, 2,
                                 fracs)["total"]
        got = work.forward_ops(p, n_tri, 2, (n_prim, n_bounce, n_prim))
        assert abs(got - want) <= 1e-9 * want


def test_backward_count_is_one_site_per_query():
    p = ref.Params()
    one = work.backward_ops(p, 26, 2, (1, 0, 1))
    assert one == (work.BWD_GATHER_PER_TRI + work.BWD_F1 + work.BWD_F3
                   + work.BWD_SCATTER_HIT + work.BWD_FIXED)
    step = work.backward_ops(p, 8192, 2, (0, 1, 0))
    assert step == (2 * work.BWD_GATHER_PER_TRI + work.BWD_STEP_FWD
                    + work.BWD_STEP_BWD + work.BWD_SCATTER_HIT)
    assert work.backward_ops(p, 8192, 2, (5, 3, 4)) == 5 * one + 3 * step


def test_bytes_and_bound():
    p = ref.Params()
    fwd = work.forward_bytes(p, 26, 2, record=False)
    assert fwd == 4 * (26 * 19 + 2 * 12 + 21) + 1024 * 1024 * 16
    rec = work.forward_bytes(p, 26, 2, record=True)
    assert rec - fwd == 1024 * 1024 * 4 * (8 + 40)
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert peak["fp32_flops_per_s"] == 67e12
    assert peak["bytes_per_s"] == 3.35e12
    assert work.bound_s(67e12, 1.0, peak) == 1.0
    assert work.peaks("no such card") is None
