"""Port tests: the launch of K2's chain-free kernel
(``render_bwd_free_kernel`` in ``csrc/render_bwd.cu``), a grid whose
blocks take contiguous ranges of 128-pixel tiles in two waves, against the grid
and the buffers that ``kernels/render_bwd.py`` sizes for it.

On the CPU: a numpy copy of the kernel's walk (block b takes tiles b * T
... (b + 1) * T - 1 of ``free_grid``; its pre-pass flags each tile's
pixels with a chain ray, warp by warp, and ranks them within the tile;
its main loop runs each tile's other pixels, thread t the tile's pixel t)
runs every chain-free pixel exactly once, in its tile's order, and writes
the list and counts entry for entry as one block a tile wrote them (the
layout the chain kernel's search reads); for A = 1 to 16,
ragged frames, and slot counts that give one tile a block and many. The
grid's partial rows and shared memory fit ``band_bytes``,
``MAX_PARTIAL_BYTES`` and the staged table at 28 and 32 objects, on the
row bands that ``_row_bands`` makes; the chain kernel's grid over the
list (``chain_blocks``) is one block a tile, as before.

On the card (``cuda``): the split backward against its plain version and
against one launch of the chain kernel over every pixel, with few slots so
that a block takes many tiles (the carry across tiles), two runs
bit-equal; and K7f, K2f's structure twin (``kernels/bwd_twin.py``), on the
same grids: its grid K2f's, its list K2f's bit for bit, its image its
plain version's bit for bit, each launch's sums within 1e-5 of the sum of
their terms' magnitudes (as ``tests/test_torch_flops.py``). Tolerances as ``tests/test_torch_render_bwd.py``: leaf by leaf
max|a-b| / max(max|ref|, 1) within 1e-4 of the plain version (1e-3 where a
ray meets the glass), 1e-5 of the one launch; the replayed image bit-equal
to the one launch's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import flops
from uob_raytracer_tpu_torch.kernels import bwd_twin
from uob_raytracer_tpu_torch.kernels import render_bwd as tbwd
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.scene import Scene

THREADS, WARP = tbwd.THREADS, 32
WARPS = THREADS // WARP
LEAVES = tuple(f.name for f in dataclasses.fields(Scene))
H100_SLOTS = 4 * 132


def chain_flags(n_pix: int, A: int, seed: int) -> np.ndarray:
    """A pixel's chain flag as the kernel's pre-pass takes it: any of its A
    rays' primary objects specular (material <= 0), from a random record
    and random materials, a miss (-1) now and then."""
    rng = np.random.RandomState(seed)
    mat = rng.choice([0.0, 1.0, 2.0, -1.0], size=30, p=[0.1, 0.6, 0.2, 0.1])
    pid = rng.randint(-1, 30, size=(A, n_pix))
    spec = np.where(pid >= 0, mat[np.maximum(pid, 0)] <= 0, False)
    return spec.any(axis=0)


def parent_lists(flags: np.ndarray):
    """The layout of one block a tile: block t's pixels with a chain ray,
    in order, at list[t * 128 ...] and their number at count[t]."""
    tiles = -(-flags.size // THREADS)
    lists = np.full(tiles * THREADS, -1, np.int64)
    counts = np.zeros(tiles, np.int64)
    for t in range(tiles):
        mine = np.flatnonzero(flags[t * THREADS:(t + 1) * THREADS]) + t * THREADS
        lists[t * THREADS:t * THREADS + mine.size] = mine
        counts[t] = mine.size
    return lists, counts


def free_walk(flags: np.ndarray, slots: int, grid=None):
    """The kernel's walk on the grid ``free_grid`` gives (or on ``grid``,
    (blocks, tiles a block), where given: the free twin's walk on the grid
    its wrapper launches): (list, counts, runs), runs the (block, thread,
    tile round, pixel) of every pixel its main loop runs, in the order a
    block runs them."""
    n_pix = flags.size
    blocks, per = tbwd.free_grid(n_pix, slots) if grid is None else grid
    tiles = -(-n_pix // THREADS)
    lists = np.full(tiles * THREADS, -1, np.int64)
    counts = np.full(tiles, -1, np.int64)
    runs = []
    lane = np.arange(THREADS) % WARP
    warp = np.arange(THREADS) // WARP
    for b in range(blocks):
        t0 = b * per
        n_mine = min(per, tiles - t0)
        # the pre-pass: per tile and warp, the ballot of the flagged pixels
        bits = np.zeros((n_mine, WARPS), np.int64)
        for i in range(n_mine):
            p = (t0 + i) * THREADS + np.arange(THREADS)
            has = np.where(p < n_pix, flags[np.minimum(p, n_pix - 1)], False)
            for w in range(WARPS):
                bits[i, w] = sum(1 << k for k in range(WARP)
                                 if has[w * WARP + k])
        # the list: a pixel's rank among the tile's flagged ones
        for i in range(n_mine):
            tile = t0 + i
            pops = [bin(int(x)).count("1") for x in bits[i]]
            for t in range(THREADS):
                w, ln = warp[t], lane[t]
                if (bits[i, w] >> ln) & 1:
                    below = bin(int(bits[i, w]) & ((1 << ln) - 1)).count("1")
                    rank = below + sum(pops[:w])
                    lists[tile * THREADS + rank] = tile * THREADS + t
            counts[tile] = sum(pops)
        # the main loop: a tile's pixels left in, thread t the tile's pixel t
        for i in range(n_mine):
            for t in range(THREADS):
                p = (t0 + i) * THREADS + t
                if p < n_pix and not (bits[i, warp[t]] >> lane[t]) & 1:
                    runs.append((b, t, i, p))
    return lists, counts, np.array(runs, np.int64).reshape(-1, 4)


@pytest.mark.parametrize("A", list(range(1, 17)))
@pytest.mark.parametrize("n_pix,slots", [(1, 528), (37, 1), (1000, 3),
                                         (64 * 64 + 5, 7)])
def test_free_walk(A, n_pix, slots):
    """Every chain-free pixel once, in its tile's order, and the list and
    counts one block a tile wrote, entry for entry."""
    flags = chain_flags(n_pix, A, seed=A * 1000 + n_pix)
    lists, counts, runs = free_walk(flags, slots)
    want_lists, want_counts = parent_lists(flags)
    valid = np.arange(THREADS)[None, :] < want_counts[:, None]
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(
        np.where(valid, lists.reshape(-1, THREADS), -1),
        np.where(valid, want_lists.reshape(-1, THREADS), -1))
    # every pixel without a chain ray once, and no other
    np.testing.assert_array_equal(np.sort(runs[:, 3]), np.flatnonzero(~flags))
    # a block runs its tiles in order, and a tile is one block's
    blocks, per = tbwd.free_grid(n_pix, slots)
    for b in np.unique(runs[:, 0]):
        mine = runs[runs[:, 0] == b]
        assert (np.diff(mine[:, 2]) >= 0).all()
        assert (mine[:, 3] // THREADS == b * per + mine[:, 2]).all()
        assert (mine[:, 3] % THREADS == mine[:, 1]).all()
    # a warp of one tile round: 32 adjacent pixels of one tile, so a lane's
    # pixel in the next round lies 128 pixels on
    assert ((runs[:, 3] % THREADS) // WARP == runs[:, 1] // WARP).all()


@pytest.mark.parametrize("n_pix", [1, 127, 128, 129, 1000, 512 * 512,
                                   1024 * 1024, 4096 * 4096])
@pytest.mark.parametrize("slots", [1, 3, 528, 100_000])
def test_free_grid(n_pix, slots):
    """The grid: T the fewest tiles a block that fit FREE_WAVES waves of
    the slots (at most FREE_MAX_TILES), every block with a tile, the tiles
    covered once; as many blocks as tiles where the waves allow it."""
    tiles = -(-n_pix // THREADS)
    room = tbwd.FREE_WAVES * slots
    blocks, per = tbwd.free_grid(n_pix, slots)
    assert 1 <= per <= tbwd.FREE_MAX_TILES
    assert blocks * per >= tiles > (blocks - 1) * per
    if per < tbwd.FREE_MAX_TILES:
        assert blocks <= room
        assert per == 1 or -(-tiles // (per - 1)) > room
    else:
        assert blocks == -(-tiles // tbwd.FREE_MAX_TILES)
    if tiles <= room:
        assert (blocks, per) == (tiles, 1)
    assert tbwd.free_grid(0, slots) == (0, 0)


def test_free_grid_of_the_frames():
    """Two waves on an H100's 528 slots: full_1024's 8,192 tiles are 1,024
    blocks of 8 (one block a tile: 8,192 blocks, 15.5 waves), the
    headline's 2,048 are 1,024 of 2; the partial rows shrink by as much."""
    assert tbwd.FREE_WAVES == 2
    assert tbwd.free_grid(1024 * 1024, H100_SLOTS) == (1024, 8)
    assert tbwd.free_grid(512 * 512, H100_SLOTS) == (1024, 2)
    assert tbwd.free_grid(64 * 64, H100_SLOTS) == (32, 1)


@pytest.mark.parametrize("n_obj", [28, 32])
@pytest.mark.parametrize("H,W,A,B", [(1024, 1024, 4, 10), (512, 512, 4, 1),
                                     (4096, 4096, 1, 2), (3000, 2000, 4, 20)])
def test_free_buffers_fit(n_obj, H, W, A, B):
    """On every row band ``_row_bands`` makes, the chain-free launch's
    partial rows (its grid's) and the chain launch's (``chain_blocks``
    over the list, one block a tile) fit ``band_bytes`` and
    ``MAX_PARTIAL_BYTES``; the block's shared memory (the staged table,
    the camera row, four accumulators and the tiles' ballots) fits the
    budget and four blocks an SM (228 KB, 1 KB reserved a block) at the
    most tiles a block takes."""
    cols = n_obj * tbwd.GRAD_COLS + tbwd.CAM_COLS
    cfg = trt.RenderConfig(width=W, height=H, aa_x=A, aa_y=1, bounces=B)
    assert tbwd.splits(cfg, H, n_obj)
    for _, n in tbwd._row_bands(H, W, A, B, cols, False):
        sizes = tbwd.band_bytes(n, W, A, B, cols, False)
        limit = sizes["partials"][0]
        assert limit <= tbwd.MAX_PARTIAL_BYTES
        blocks, per = tbwd.free_grid(n * W, H100_SLOTS)
        assert 4 * blocks * cols <= limit
        assert 4 * tbwd.chain_blocks(n * W, A, True) * cols <= limit
        smem = tbwd.free_shared_bytes(n_obj, per)
        assert smem == 4 * (n_obj * 17 + 21 + 4 * (n_obj * 16 + 21) + 4 * per)
    most = tbwd.free_shared_bytes(n_obj, tbwd.FREE_MAX_TILES)
    assert most <= tfwd.SMEM_BUDGET_BYTES
    assert 4 * (most + 1024) <= 233472
    # the staged table alone, without the ballots, is the chain-free part
    # of the chain kernel's shared memory
    assert (tbwd.free_shared_bytes(n_obj, 0)
            == tfwd.bwd_shared_bytes(n_obj, A) - 4 * tfwd.pixels_per_block(A)
            * (3 * A + 1))


@pytest.mark.parametrize("A", [1, 4, 9, 16])
@pytest.mark.parametrize("n_pix", [1, 1000, 1024 * 1024])
def test_chain_grid_unchanged(A, n_pix):
    """The chain kernel's grid over the list is one block a tile, as many
    as the counts the chain-free launch writes (its search reads them)."""
    assert tbwd.chain_blocks(n_pix, A, True) == -(-n_pix // THREADS)
    assert tbwd.chain_blocks(n_pix, A, False) == -(
        -n_pix // tfwd.pixels_per_block(A))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _leafwise(ref, got):
    return max(((getattr(ref, k) - getattr(got, k)).abs().max().item()
                / max(getattr(ref, k).abs().max().item(), 1.0))
               for k in LEAVES if getattr(ref, k).numel())


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 3, 528])
@pytest.mark.parametrize("frame", ["64x48_aa4_b2", "50x30_aa1_b3",
                                   "40x20_aa9_b1_fresnel"])
def test_free_kernel_on_card(cuda_device, monkeypatch, slots, frame):
    """The split (the chain-free kernel on ``slots`` slots, then the chain
    kernel over its list) against the plain version and against the chain
    kernel alone over every pixel; two runs bit-equal."""
    cfg = {"64x48_aa4_b2": trt.RenderConfig(
               width=64, height=48, aa_x=2, aa_y=2, shadow_samples=3,
               bounces=2),
           "50x30_aa1_b3": trt.RenderConfig(
               width=50, height=30, aa_x=1, aa_y=1, shadow_samples=2,
               bounces=3),
           "40x20_aa9_b1_fresnel": trt.RenderConfig(
               width=40, height=20, aa_x=3, aa_y=3, shadow_samples=2,
               bounces=1, fresnel=True)}[frame]
    sc = trt.cornell_box(device=cuda_device)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(slots).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda_device)
    monkeypatch.setattr(tbwd, "SPLIT_RAYS", 0)
    monkeypatch.setattr(tbwd, "free_slots", lambda device, n_obj: slots)
    before = (tbwd.LAUNCHES, tbwd.FREE_LAUNCHES)
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again, primal2 = tbwd.render_replay_bwd(sc, cfg, res, g,
                                            return_primal=True)
    torch.cuda.synchronize()
    assert (tbwd.LAUNCHES, tbwd.FREE_LAUNCHES) == (before[0] + 2,
                                                   before[1] + 2)
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    assert torch.equal(primal, primal2)
    monkeypatch.setattr(tbwd, "SPLIT_RAYS", 1 << 62)
    one, one_primal = tbwd.render_replay_bwd(sc, cfg, res, g,
                                             return_primal=True)
    torch.cuda.synchronize()
    assert tbwd.FREE_LAUNCHES == before[1] + 2
    assert torch.equal(primal, one_primal)
    assert _leafwise(one, got) <= 1e-5
    ref = tbwd.render_replay_bwd_plain(sc, cfg, res, g)
    assert _leafwise(ref, got) <= (1e-3 if cfg.bounces >= 2 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 3, 528])
def test_free_twin_on_card(cuda_device, monkeypatch, slots):
    """K7f on K2f's grid for ``slots`` (12 and 4 tiles a block at 1 and 3:
    the carry across tiles; one at 528), then K7c over its list: the free
    twin's grid and list K2f's, the image bit-equal to the plain twin's,
    each launch's sums within 1e-5 of the sum of their terms' magnitudes,
    visits exact."""
    cfg = trt.RenderConfig(width=64, height=48, aa_x=2, aa_y=2,
                           shadow_samples=3, bounces=2)
    sc = trt.cornell_box(device=cuda_device)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    monkeypatch.setattr(tbwd, "SPLIT_RAYS", 0)
    monkeypatch.setattr(tbwd, "free_slots", lambda device, n_obj: slots)
    twin = flops.build_bwd_structure_twin(sc, cfg, res)
    assert twin["split"]
    before = (bwd_twin.LAUNCHES, bwd_twin.FREE_LAUNCHES)
    parts, img = twin["run"](parts=True)
    torch.cuda.synchronize()
    assert (bwd_twin.LAUNCHES, bwd_twin.FREE_LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
    assert parts["grid"] == tbwd.free_grid(cfg.width * cfg.height, slots)
    assert torch.equal(parts["list"], bwd_twin.k2_free_list(sc, cfg, res))
    ref = twin["run_plain"]()
    assert torch.equal(img, ref["img"])
    n_obj = sc.num_triangles + sc.num_spheres
    for kind, want in ref["launches"].items():
        got = parts[kind]
        err = ((got.double() - want["sums"]).abs()
               / want["abs_sums"].clamp(min=1e-30)).max().item()
        assert err <= 1e-5, (kind, err)
        visits = got[:n_obj * 16].reshape(n_obj, 16)[:, 15].round().long()
        assert torch.equal(visits, want["visits"])
