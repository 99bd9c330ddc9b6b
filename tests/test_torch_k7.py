"""Port tests: K7, the structure twin of the backward kernel K2
(``kernels/bwd_twin.py``, ``csrc/bwd_twin.cu``,
``flops.build_bwd_structure_twin``), launch for launch as K2 takes its
launches (``render_bwd.splits``): the chain-free twin over the pixels none
of whose rays bounces, the chain twin over the rest; or the chain twin
alone.

On the CPU, against the JAX package's decision record of the Cornell box
(its Pallas kernel, run as its own tests run it) at small configs: the
JAX test's twin config (128x16, 2x2 AA, 2 samples, 1 bounce), one ray a
pixel at 3 bounces, 3x3 AA at 2 bounces and no bounce; the split is forced
with ``render_bwd.SPLIT_RAYS = 0``, as K2's card tests force it. The twin's
chain pixels equal a numpy transcription of K2's rule; each launch's
sizing meets its targets within the JAX test's 10% (census and depth,
``tests/test_flops.py:108``) and takes the pool that reaches its own K2
launch's registers; with equal sizings the split plain twin is the
one-launch plain twin bit for bit; the visits equal ``np.bincount`` of the
record, in all and per launch; the grids are K2's. The twin kernels on the
card: ``tests/test_torch_flops.py::test_structure_twin_on_card``.
"""
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res as j_render_res
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import flops
from uob_raytracer_tpu_torch.kernels import bwd_twin, render_bwd
from uob_raytracer_tpu_torch.ops.replay import residuals_from_numpy

CASES = {
    "twin": dict(width=128, height=16, aa_x=2, aa_y=2, shadow_samples=2,
                 bounces=1),
    "aa1_b3": dict(width=32, height=24, aa_x=1, aa_y=1, shadow_samples=2,
                   bounces=3),
    "aa9_b2": dict(width=20, height=12, aa_x=3, aa_y=3, shadow_samples=1,
                   bounces=2),
    "b0": dict(width=24, height=16, aa_x=2, aa_y=2, shadow_samples=1,
               bounces=0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, scene, config, record, (pid, lit, bid) as numpy) of the JAX
    package's record at one of CASES."""
    kw = CASES[request.param]
    _, _, jres = j_render_res(jrt.cornell_box(), jrt.RenderConfig(**kw))
    arrays = tuple(np.asarray(x) for x in (jres.prim_id, jres.lit_cnt,
                                           jres.bounce_id))
    return (request.param, trt.cornell_box(device="cpu"),
            trt.RenderConfig(**kw), residuals_from_numpy(*arrays, device="cpu"),
            arrays)


@pytest.fixture
def split_all(monkeypatch):
    """K2's split on every frame that bounces (up to 32 objects)."""
    monkeypatch.setattr(render_bwd, "SPLIT_RAYS", 0)


def numpy_chain_pixels(scene, cfg, pid):
    """K2's rule (render_bwd.cu: render_bwd_free_kernel), written out: a
    pixel goes to the chain launch when the config bounces and one of its
    rays' primary object has a material code <= 0."""
    mat = np.concatenate([scene.tri_mat.numpy(), scene.sph_mat.numpy()])
    ray = (pid >= 0) & (mat[np.clip(pid, 0, None)] <= 0.0)
    return ray.reshape(pid.shape[0], -1).any(axis=0) & (cfg.bounces > 0)


def test_chain_pixels_follow_k2s_rule(case, split_all):
    name, scene, cfg, res, (pid, _, _) = case
    want = numpy_chain_pixels(scene, cfg, pid)
    table = bwd_twin.twin_table(scene, cfg)
    np.testing.assert_array_equal(
        bwd_twin.chain_pixels(table, res, cfg).numpy(), want)
    twin = flops.build_bwd_structure_twin(scene, cfg, res,
                                          target_registers=0)
    out = twin["run_plain"]()
    assert out["split"] == twin["split"] == (cfg.bounces > 0)
    if out["split"]:
        np.testing.assert_array_equal(out["chain_pixels"].numpy(), want)
        assert 0 < want.sum() < want.size, name
    else:
        assert out["chain_pixels"] is None and not want.any()


def test_launch_sizing_meets_its_targets(case, split_all, monkeypatch):
    """Each launch's sizing meets its own K2 launch's targets within the
    JAX test's 10%; the free launch's have no step (live 0, K2's per-ray
    depth), the chain launch's the steps of the listed pixels' rays. With
    no register target given, each launch takes the smallest clean pool
    that reaches its K2 launch's registers (128 free, 168 chain)."""
    name, scene, cfg, res, (pid, _, bid) = case
    twin = flops.build_bwd_structure_twin(scene, cfg, res,
                                          target_registers=0)
    kinds = ("free", "chain") if twin["split"] else ("chain",)
    assert (twin["free"] is None) == (not twin["split"])
    for kind in kinds:
        t = twin[kind]
        assert t["kind"] == kind and t["n_pool"] == 0
        assert 0.9 < t["census_match"] < 1.1, (name, kind, t)
        assert t["depth"] > 0.9 * t["target_depth"], (name, kind, t)
        assert t["census_per_lane"] == round(flops.twin_ops_per_ray(
            t["n_step"], t["slots"], 0, t["live"], cfg.aa_rays), 1)
    if twin["split"]:
        on = numpy_chain_pixels(scene, cfg, pid)
        assert twin["free"]["live"] == 0.0
        assert twin["free"]["target_depth"] == flops.K2_DEPTH_RAY
        # the listed pixels' rays: steps per ray from the JAX record (a
        # chain runs while its object is specular; a step that misses ends
        # it and counts)
        mat = np.concatenate([scene.tri_mat.numpy(), scene.sph_mat.numpy()])

        def specular(ids):
            return (ids >= 0) & (mat[np.clip(ids, 0, None)] <= 0.0)

        n_pix = cfg.width * cfg.height
        active = specular(pid.reshape(cfg.aa_rays, n_pix)[:, on])
        steps = 0
        for k in range(cfg.bounces):
            steps += int(active.sum())
            active &= specular(bid.reshape(cfg.bounces, cfg.aa_rays,
                                           n_pix)[k][:, on])
        assert twin["chain"]["live"] == pytest.approx(
            steps / (cfg.aa_rays * on.sum()))
    else:
        assert twin["chain"] == {k: twin[k] for k in twin["chain"]}

    regs = {"free": dict(zip(bwd_twin.FREE_POOLS, (96, 112, 128, 136, 150))),
            "chain": dict(zip(bwd_twin.POOLS, (120, 150, 170, 200, 240)))}

    def fake(kernel):
        if kernel in flops.K2_OF_TWIN.values():
            return {"registers": 128 if "free" in kernel else 168,
                    "spill_stores": 104, "spill_loads": 0}
        kind = "free" if "free" in kernel else "chain"
        n = int(kernel.split("<")[1].rstrip(">"))
        return {"registers": regs[kind][n], "spill_stores": 0,
                "spill_loads": 0}

    monkeypatch.setattr(flops, "kernel_resources", fake)
    pooled = flops.build_bwd_structure_twin(scene, cfg, res)
    for kind in kinds:
        t = pooled[kind]
        assert (t["n_pool"], t["registers"], t["target_registers"]) == (
            (32, 128, 128) if kind == "free" else (64, 170, 168))
        assert t["symbol"] == bwd_twin.symbol(t["n_pool"], kind)
        assert 0.9 < t["census_match"] < 1.1, (name, kind, t)


def test_split_plain_twin_is_the_one_launch_twin(case, monkeypatch):
    """With both launches sized alike, the split plain twin's sums, their
    magnitudes and its image are the one-launch plain twin's bit for bit,
    and its launches' sums add up to them."""
    name, scene, cfg, res, _ = case
    one = flops.build_bwd_structure_twin(scene, cfg, res, target_registers=0)
    assert not one["split"]
    sizing = one["chain"]
    table = bwd_twin.twin_table(scene, cfg)
    g = torch.full((cfg.height, cfg.width, 3), 1e-3)
    ref = bwd_twin.bwd_twin_plain(table, g, res, cfg, sizing)
    monkeypatch.setattr(render_bwd, "SPLIT_RAYS", 0)
    got = bwd_twin.bwd_twin_plain(table, g, res, cfg, sizing, sizing)
    assert got["split"] == (cfg.bounces > 0)
    for k in ("sums", "abs_sums", "img", "visits"):
        assert torch.equal(got[k], ref[k]), (name, k)
    parts = sum(v["sums"] for v in got["launches"].values())
    torch.testing.assert_close(parts, got["sums"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("split", [False, True])
def test_visits_match_the_jax_record(case, split, monkeypatch):
    """The plain twin visits each object once per site of the record that
    hit it, in all and, split, each launch over its own pixels; the wrapper
    on the CPU runs the plain version, launches nothing, and lists the
    chain pixels in order."""
    name, scene, cfg, res, (pid, _, bid) = case
    if split:
        monkeypatch.setattr(render_bwd, "SPLIT_RAYS", 0)
    twin = flops.build_bwd_structure_twin(scene, cfg, res, target_registers=0)
    out = twin["run_plain"]()
    n_obj = scene.num_triangles + scene.num_spheres
    A, B = cfg.aa_rays, cfg.bounces

    def visits(pixels):
        p = pid.reshape(A, -1)[:, pixels]
        b = bid.reshape(B, A, cfg.width * cfg.height)[..., pixels]
        ids = np.concatenate([p[p >= 0], b[b >= 0]])
        return np.bincount(ids, minlength=n_obj)

    every = np.ones(cfg.width * cfg.height, dtype=bool)
    np.testing.assert_array_equal(out["visits"].numpy(), visits(every))
    on = numpy_chain_pixels(scene, cfg, pid)
    for kind, pixels in (("free", ~on), ("chain", on) if out["split"]
                         else ("chain", every)):
        if kind in out["launches"]:
            np.testing.assert_array_equal(
                out["launches"][kind]["visits"].numpy(), visits(pixels))
    assert set(out["launches"]) == ({"free", "chain"} if out["split"]
                                    else {"chain"})
    assert torch.isfinite(out["sums"]).all() and torch.isfinite(out["img"]).all()
    assert (out["abs_sums"] >= out["sums"].abs() - 1e-9).all()
    before = (bwd_twin.LAUNCHES, bwd_twin.FREE_LAUNCHES)
    sums, img = twin["run"]()
    assert torch.equal(img, out["img"])
    np.testing.assert_allclose(sums.numpy(), out["sums"].numpy(), rtol=1e-6)
    parts, _ = twin["run"](parts=True)
    assert set(parts) == ({"free", "chain", "list"} if out["split"]
                          else {"chain"})
    if out["split"]:
        np.testing.assert_array_equal(parts["list"].numpy(),
                                      np.flatnonzero(on))
    assert (bwd_twin.LAUNCHES, bwd_twin.FREE_LAUNCHES) == before


@pytest.mark.parametrize("A", [1, 4, 9])
@pytest.mark.parametrize("n_pix", [1, 37, 1000, 4097])
@pytest.mark.parametrize("split", [False, True])
def test_launch_grids_are_k2s(A, n_pix, split):
    free, chain = bwd_twin.launch_grids(n_pix, A, split)
    assert chain == render_bwd.chain_blocks(n_pix, A, split)
    assert free == (render_bwd.launch_blocks(n_pix, render_bwd.THREADS)
                    if split else None)


def test_listed_compacts_the_free_launchs_lists():
    """``listed`` reads each block's first counts[b] entries, in block
    order, as the chain twin's search over the offsets does."""
    rng = np.random.RandomState(3)
    n_pix = 1000
    on = rng.uniform(size=n_pix) < 0.1
    blocks = -(-n_pix // bwd_twin.THREADS)
    lists = np.full(blocks * bwd_twin.THREADS, -7, np.int32)
    counts = np.zeros(blocks, np.int32)
    for b in range(blocks):
        mine = np.flatnonzero(on[b * 128:(b + 1) * 128]) + b * 128
        lists[b * 128:b * 128 + len(mine)] = mine
        counts[b] = len(mine)
    got = bwd_twin.listed(torch.from_numpy(lists), torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(on))
    # the chain twin's walk: item j's pixel by the binary search over the
    # inclusive sums of the counts
    off = np.cumsum(counts)
    for j in range(int(off[-1])):
        lo = int(np.searchsorted(off, j, side="right"))
        assert lists[lo * 128 + j - (off[lo - 1] if lo else 0)] == got[j]
