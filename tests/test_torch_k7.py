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
record, in all and per launch; the grids are K2's: the free twin takes
K2f's grid of tile ranges (``render_bwd.free_grid``), and the numpy copy
of K2f's walk (``tests/test_torch_k2f.py:free_walk``) on the twin's grid
writes the twin's chain pixels as K2f's per-tile lists and counts, for
ragged last blocks, one tile a block, ``FREE_MAX_TILES`` a block and the
row bands K2 takes a tall frame in, at 1, 4 and 9 rays a pixel. A numpy
copy of the free twin's sums in the kernel's order (the carry across a
block's tiles, the warps' butterflies, one partial row a block) stays
within the card tests' 1e-5 of the plain twin's sums, and its image is the
plain twin's bit for bit, whatever the grid. The twin kernels on the card:
``tests/test_torch_flops.py::test_structure_twin_on_card`` and, on grids
of many tiles a block, ``tests/test_torch_k2f.py::test_free_twin_on_card``.
"""
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res as j_render_res
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import flops
from uob_raytracer_tpu_torch.kernels import bwd_twin, render_bwd
from uob_raytracer_tpu_torch.ops.replay import Residuals, residuals_from_numpy

from test_torch_k2f import free_walk, parent_lists

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
    """The free twin's grid is K2f's grid of tile ranges on the same slots
    (``render_bwd.free_grid``: one tile a block where two waves allow it,
    several past that), the chain twin's K2c's; without the slots a split
    grid is refused."""
    for slots in (1, 3, 528):
        free, chain = bwd_twin.launch_grids(n_pix, A, split, slots)
        assert chain == render_bwd.chain_blocks(n_pix, A, split)
        assert free == (render_bwd.free_grid(n_pix, slots) if split
                        else None)
    if split:
        with pytest.raises(ValueError, match="slots"):
            bwd_twin.launch_grids(n_pix, A, split)
    else:
        assert bwd_twin.launch_grids(n_pix, A, split) == (None, chain)


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


# --------------------------------------------------------------------------
# The free twin on K2f's grid of tile ranges
# --------------------------------------------------------------------------

WARP = 32
WARPS = bwd_twin.THREADS // WARP
# (pixels, slots): 11 tiles of which the last holds 20 pixels, 2 a block,
# the last block one; one tile a block; FREE_MAX_TILES a block, the last
# block 52 tiles
WALK_FRAMES = {"ragged": (1300, 3), "one_tile": (37 * 128 + 5, 528),
               "max_tiles": (2100 * 128 - 50, 1)}


def twin_flags(n_pix: int, A: int, seed: int) -> np.ndarray:
    """The free twin's chain pixels (``bwd_twin.chain_pixels``: K2's rule on
    the twin's table of the Cornell box) on a random record of A rays a
    pixel: primary ids over the box's 28 objects, a miss now and then."""
    scene = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=n_pix, height=1, aa_x=A, aa_y=1, bounces=2)
    pid = np.random.RandomState(seed).randint(-1, 28, size=(A, 1, n_pix))
    res = Residuals(torch.from_numpy(pid.astype(np.int32)),
                    torch.zeros((A, 1, n_pix)), None)
    return bwd_twin.chain_pixels(bwd_twin.twin_table(scene, cfg), res,
                                 cfg).numpy()


@pytest.mark.parametrize("frame", sorted(WALK_FRAMES) + ["bands"])
@pytest.mark.parametrize("A", [1, 4, 9])
def test_free_twin_walk_is_k2fs(A, frame, monkeypatch):
    """On the free twin's grid (``launch_grids``: K2f's ``free_grid``), the
    walk of K2f's code writes the twin's chain pixels as K2f's per-tile
    lists and counts entry for entry (``listed`` reads them back in
    order), runs every other pixel once, and the chain twin's grid is one
    block a count."""
    if frame == "bands":
        W, rows, B = 54, 60, 2
        cols = 28 * render_bwd.GRAD_COLS + render_bwd.CAM_COLS
        monkeypatch.setattr(render_bwd, "MAX_PARTIAL_BYTES", render_bwd.band_bytes(
            17, W, A, B, cols, False)["partials"][0])
        bands = render_bwd._row_bands(rows, W, A, B, cols, False)
        assert len(bands) == 4
        sizes = [(n * W, 2) for _, n in bands]
    else:
        sizes = [WALK_FRAMES[frame]]
    for k, (n_pix, slots) in enumerate(sizes):
        flags = twin_flags(n_pix, A, seed=A * 7 + k)
        assert 0 < flags.sum() < n_pix
        grid, chain = bwd_twin.launch_grids(n_pix, A, True, slots)
        assert grid == render_bwd.free_grid(n_pix, slots)
        blocks, per = grid
        tiles = -(-n_pix // bwd_twin.THREADS)
        assert blocks * per >= tiles > (blocks - 1) * per
        assert chain == tiles
        lists, counts, runs = free_walk(flags, slots, grid=grid)
        want_lists, want_counts = parent_lists(flags)
        np.testing.assert_array_equal(counts, want_counts)
        valid = np.arange(bwd_twin.THREADS)[None, :] < want_counts[:, None]
        np.testing.assert_array_equal(
            np.where(valid, lists.reshape(-1, bwd_twin.THREADS), -1),
            np.where(valid, want_lists.reshape(-1, bwd_twin.THREADS), -1))
        got = bwd_twin.listed(torch.from_numpy(lists.astype(np.int32)),
                              torch.from_numpy(counts.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.flatnonzero(flags))
        np.testing.assert_array_equal(np.sort(runs[:, 3]),
                                      np.flatnonzero(~flags))
        assert (runs[:, 3] // bwd_twin.THREADS
                == runs[:, 0] * per + runs[:, 2]).all()
    if frame == "one_tile":
        assert per == 1 and blocks == tiles
    elif frame == "max_tiles":
        assert per == render_bwd.FREE_MAX_TILES and tiles % per == 52
    else:
        assert 1 < per < tiles and tiles % per != 0


def butterfly(v):
    """Lane 0's sum of a warp's values [32, ...] by the five xor shuffles of
    ``warp_scatter`` and ``warp_camera``, in float32."""
    lane = np.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lane ^ off]
    return v[0]


def free_twin_rows(table, g, res, cfg, sizing, grid):
    """A numpy copy of ``bwd_twin_free_kernel``'s partial rows [blocks,
    n_obj*16 + 21] and image [n_pix, 3] (zeros at the chain pixels) on
    ``grid``, every ray's values the plain twin's (``bwd_twin._ray``), every
    sum in float32 in the kernel's order: block b's tiles in turn, a warp
    skipping a tile where none of its lanes has a pixel; a lane's primary
    row carried from ray to ray and tile to tile while its object repeats,
    the warp scattering (a butterfly per object and column, added to the
    warp's accumulator) when some lane's object changes and after the
    block's last tile; a lane's camera terms over all its pixels, one
    butterfly a column; the warps' accumulators added in order."""
    A = cfg.aa_rays
    n_obj = table.shape[0]
    n_pix = cfg.height * cfg.width
    pid = res.prim_id.reshape(A, n_pix)
    lit = res.lit_cnt.reshape(A, n_pix)
    gx = g.reshape(n_pix, 3)[:, 0]
    miss = torch.zeros((1, 17))
    miss[0, 15] = 1.0
    tab = torch.cat([table, miss])

    def row_of(ids):
        return tab[torch.where(ids >= 0, ids, n_obj).long()].T

    rays = [bwd_twin._ray(row_of, bwd_twin.camera_row(table), pid[a], lit[a],
                          gx, [], sizing, 0) for a in range(A)]
    prim = np.stack([torch.stack(r[1][1], 1).numpy() for r in rays])
    camt = np.stack([torch.stack(r[2], 1).numpy() for r in rays])
    rimg = np.stack([torch.stack(r[3], 1).numpy() for r in rays])
    ids0 = pid.numpy()
    flags = bwd_twin.chain_pixels(table, res, cfg).numpy()
    blocks, per = grid
    tiles = -(-n_pix // bwd_twin.THREADS)
    base = n_obj * 16
    out = np.zeros((blocks, base + 21), np.float32)
    img = np.zeros((n_pix, 3), np.float32)
    zero = np.float32(0.0)
    for b in range(blocks):
        t0 = b * per
        acc = np.zeros((WARPS, base + 21), np.float32)
        for w in range(WARPS):
            wacc = acc[w]

            def scatter(ids, v):
                for o in np.unique(ids[ids >= 0]):
                    wacc[o * 16:(o + 1) * 16] += butterfly(
                        np.where((ids == o)[:, None], v, zero))

            carry = np.zeros((WARP, 16), np.float32)
            carry_id = np.full(WARP, -1)
            dcam = np.zeros((WARP, 21), np.float32)
            for i in range(min(per, tiles - t0)):
                p = (t0 + i) * bwd_twin.THREADS + w * WARP + np.arange(WARP)
                pc = np.minimum(p, n_pix - 1)
                in_img = (p < n_pix) & ~flags[pc]
                if not in_img.any():
                    continue
                img_acc = np.zeros((WARP, 3), np.float32)
                for a in range(A):
                    ids = np.where(in_img, ids0[a, pc], -1)
                    change = (carry_id >= 0) & (ids >= 0) & (ids != carry_id)
                    if change.any():
                        scatter(np.where(change, carry_id, -1), carry)
                    on = (ids >= 0)[:, None]
                    carry = np.where(on & (ids == carry_id)[:, None],
                                     carry + prim[a, pc],
                                     np.where(on, prim[a, pc], carry))
                    carry_id = np.where(ids >= 0, ids, carry_id)
                    dcam = np.where(in_img[:, None], dcam + camt[a, pc], dcam)
                    img_acc = img_acc + rimg[a, pc]
                img[p[in_img]] = img_acc[in_img] / np.float32(A)
            scatter(carry_id, carry)
            wacc[base:] += butterfly(dcam)
        out[b] = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    return out, img


@pytest.mark.parametrize("slots", [1, 3, 528])
def test_free_twin_sums_whatever_the_grid(case, slots, monkeypatch):
    """The free twin's sums in the kernel's order on K2f's grid for
    ``slots`` (8 tiles a block to one on the 128x16 record) stay within
    1e-5 of the sum of their terms' magnitudes of the plain twin's free
    launch (the card tests' budget), its visits exact; its image is the
    plain twin's bit for bit at every chain-free pixel."""
    name, scene, cfg, res, _ = case
    monkeypatch.setattr(render_bwd, "SPLIT_RAYS", 0)
    twin = flops.build_bwd_structure_twin(scene, cfg, res, target_registers=0)
    if not twin["split"]:
        assert cfg.bounces == 0
        return
    table = bwd_twin.twin_table(scene, cfg)
    g = torch.from_numpy(np.random.RandomState(slots).uniform(
        -1e-2, 1e-2, (cfg.height, cfg.width, 3)).astype(np.float32))
    ref = bwd_twin.bwd_twin_plain(table, g, res, cfg, twin["chain"],
                                  twin["free"])
    n_pix = cfg.height * cfg.width
    grid, _ = bwd_twin.launch_grids(n_pix, cfg.aa_rays, True, slots)
    rows, img = free_twin_rows(table, g, res, cfg, twin["free"], grid)
    assert rows.shape[0] == grid[0]
    sums = torch.from_numpy(rows).sum(dim=0)
    want = ref["launches"]["free"]
    err = ((sums.double() - want["sums"]).abs()
           / want["abs_sums"].clamp(min=1e-30)).max().item()
    assert err <= 1e-5, (name, slots, err)
    n_obj = table.shape[0]
    visits = sums[:n_obj * 16].reshape(n_obj, 16)[:, 15].round().long()
    assert torch.equal(visits, want["visits"])
    free = ~ref["chain_pixels"].numpy()
    np.testing.assert_array_equal(
        img[free], ref["img"].reshape(-1, 3).numpy()[free])
