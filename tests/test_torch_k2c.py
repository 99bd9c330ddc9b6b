"""Port tests: the launch of K2's chain kernel (``render_bwd_kernel<Deep>``
in ``csrc/render_bwd.cu``), which takes one thread per AA ray, against the
grid and the buffers that ``kernels/render_bwd.py`` sizes for it.

On the CPU: a numpy copy of the kernel's walk (block b takes chunks b, b +
grid, ... of ``pixels_per_block(A)`` pixels; in a chunk ray a of pixel l
is item a * ppb + l, and thread t takes items t, t + 128, ...) replays
every ray exactly once, on a block of the wrapper's grid, with every
thread of a block taking as many items as the others (the block's
barriers) and every warp one AA index of 32 adjacent pixels (the
shuffles); for A = 1 to 16, ragged frames, and lists of none, one and
every pixel. The shared memory and the deep chain it needs fit what the
wrapper and ``bwd_shared_bytes`` give it.

On the card (``cuda``): the kernel against its plain version past 32
objects and past 16 bounces, two runs bit-equal. Tolerances as
``tests/test_torch_render_bwd.py``: leaf by leaf max|a-b| / max(max|ref|, 1)
within 1e-4 of the plain version, 1e-3 where a ray meets the glass.
"""
import dataclasses

import numpy as np
import pytest
import torch

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import debug
from uob_raytracer_tpu_torch.kernels import render_bwd as tbwd
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.scene import Scene

THREADS, WARP = tbwd.THREADS, 32
LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


def chain_walk(n_work: int, A: int, grid: int) -> np.ndarray:
    """The kernel's walk: for each ray (a, j) of the n_work pixels it runs
    (j a position in the list, or a pixel without one), the (block,
    thread, item round) that replays it; int64 [A, n_work, 3]. The item
    round counts a thread's items over all its chunks."""
    ppb = tfwd.pixels_per_block(A)
    a, j = np.meshgrid(np.arange(A), np.arange(n_work), indexing="ij")
    c, lp = j // ppb, j % ppb
    item = a * ppb + lp
    rounds = ppb * A // THREADS          # a thread's items in one chunk
    return np.stack([c % grid, item % THREADS,
                     (c // grid) * rounds + item // THREADS], axis=-1)


def check_walk(n_pix: int, n_work: int, A: int, listed: bool) -> None:
    grid = tbwd.chain_blocks(n_pix, A, listed)
    ppb = tfwd.pixels_per_block(A)
    walk = chain_walk(n_work, A, grid).reshape(-1, 3)
    block, thread, rnd = walk.T
    # every ray once, on a block of the grid
    assert len({(b, t, r) for b, t, r in walk}) == A * n_work
    assert (block < grid).all()
    # the chunks a block walks: all of a block's threads run as many
    # items (the same rounds), lanes past the last pixel included
    n_chunks = -(-n_work // ppb)
    for b in range(min(grid, n_chunks)):
        mine = np.arange(b, n_chunks, grid)
        assert ppb * A * len(mine) % THREADS == 0
        assert (rnd[block == b] < ppb * A * len(mine) // THREADS).all()
    # a warp of one round holds one AA index of 32 adjacent positions
    a_of = np.repeat(np.arange(A), n_work)
    j_of = np.tile(np.arange(n_work), A)
    warp = (block * THREADS + thread) // WARP * 1_000_000 + rnd
    for w in np.unique(warp)[:64]:
        sel = warp == w
        assert len(set(a_of[sel])) == 1
        js = np.sort(j_of[sel])
        assert js[-1] - js[0] < WARP and js[0] % WARP == 0
    # the deep chain has a slot for every thread of the grid, and the
    # partial rows a row for every block of it (band_bytes sizes both for
    # the larger grid, without the list)
    sizes = tbwd.band_bytes(1, n_pix, A, tbwd.REG_BOUNCES + 1, 21, False)
    assert sizes["partials"][0] >= 4 * grid * 21
    assert sizes["chain"][0] >= (4 * tbwd.CHAIN_FLOATS
                                 * (tbwd.REG_BOUNCES + 1) * grid * THREADS)


@pytest.mark.parametrize("A", list(range(1, 17)))
@pytest.mark.parametrize("n_pix", [1, 37, 1000, 64 * 64])
def test_chain_walk_every_pixel(A, n_pix):
    """Without the list (past 32 objects, or below SPLIT_RAYS): every
    pixel, one block a chunk, ragged frames included."""
    check_walk(n_pix, n_pix, A, listed=False)
    assert tbwd.chain_blocks(n_pix, A, False) == -(-n_pix // tfwd.pixels_per_block(A))


@pytest.mark.parametrize("A", [1, 2, 3, 4, 9, 16])
@pytest.mark.parametrize("n_pix", [37, 1000, 64 * 64])
@pytest.mark.parametrize("listed", ["none", "one", "all"])
def test_chain_walk_listed_pixels(A, n_pix, listed):
    """With the chain-free launch's list: the grid is that launch's (one
    block of 128 pixels), and its blocks walk the listed pixels' chunks;
    a block without a chunk writes zeros (none listed: every block)."""
    n_work = {"none": 0, "one": 1, "all": n_pix}[listed]
    grid = tbwd.chain_blocks(n_pix, A, True)
    assert grid == -(-n_pix // THREADS)
    check_walk(n_pix, n_work, A, listed=True)
    # every ray of every pixel listed: a block takes 128 / ppb * ... of
    # them, as many rays a thread as the one-thread-per-pixel design had
    n_chunks = -(-n_work // tfwd.pixels_per_block(A))
    most = -(-n_chunks // grid) * tfwd.pixels_per_block(A) * A // THREADS
    assert most <= max(A, tfwd.pixels_per_block(A) * A // THREADS)


@pytest.mark.parametrize("A", [1, 2, 4, 9, 16])
@pytest.mark.parametrize("n_obj", [28, 258, 322])
def test_chain_shared_memory(A, n_obj):
    """``bwd_shared_bytes(n_obj, A)`` is the launcher's ``chain_smem``: the
    tables and the per-warp accumulators, the chunk's rays' radiance and
    its pixels; every whole-table scene the routing admits fits a block at
    the AA counts of the configs, and K2' at 258 objects (dense_256) holds
    two blocks an SM (228 KB, 1 KB reserved a block), not three."""
    ppb = tfwd.pixels_per_block(A)
    tables = n_obj * 17 + 21 + 4 * (n_obj * 16 + 21)
    got = tfwd.bwd_shared_bytes(n_obj, A)
    assert got == 4 * (tables + ppb * (3 * A + 1))
    assert got <= tfwd.SMEM_BUDGET_BYTES
    if n_obj == 258 and A == 4:
        assert 2 * (got + 1024) <= 233472 < 3 * (got + 1024)
    if n_obj == 28:
        assert got < 48 * 1024


def test_chain_grid_sizes_of_the_frames():
    """The grids of the frames the routing sends to the chain kernel: the
    one-ray frames keep one block of 128 pixels; dense_256 128x128 aa4 takes
    512 blocks (one thread a pixel took 128); full_1024's chain launch walks
    its list on the chain-free launch's 8,192 blocks."""
    assert tbwd.chain_blocks(512 * 512, 1, False) == 2048
    assert tbwd.chain_blocks(128 * 128, 4, False) == 512
    assert tbwd.chain_blocks(1024 * 1024, 4, True) == 8192
    assert tbwd.chain_blocks(512 * 512, 4, True) == 2048


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


def _card_checks(sc, cfg, seed, budget):
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(seed).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)).to(sc.device)
    before = tbwd.LAUNCHES
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again, primal2 = tbwd.render_replay_bwd(sc, cfg, res, g,
                                            return_primal=True)
    torch.cuda.synchronize()
    assert tbwd.LAUNCHES == before + 2
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    assert torch.equal(primal, primal2)
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g,
                                                   return_primal=True)
    assert _leafwise(ref, got) <= budget
    assert torch.allclose(primal, ref_primal, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [1, 2, 3])
def test_chain_kernel_past_32_objects_on_card(cuda_device, aa):
    """dense_scene(40) at 32x32 (42 objects: the chain kernel alone, over
    every pixel, one thread per AA ray) against the plain version."""
    sc = debug.dense_scene(40, device=cuda_device)
    cfg = trt.RenderConfig(width=32, height=32, aa_x=aa, aa_y=aa,
                           shadow_samples=3, bounces=2)
    assert sc.num_triangles + sc.num_spheres > tbwd.SPLIT_OBJECTS
    assert not tfwd.use_streamed(sc.num_triangles, sc.num_spheres)
    _card_checks(sc, cfg, seed=aa, budget=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [1, 2])
def test_chain_kernel_deep_on_card(cuda_device, aa):
    """The deep instance (20 bounces) on the mirror box at 32x32 (the view
    of ``tests/test_torch_render_bwd.py``'s 128x128 mirror box: a quarter
    of its focal length), its chain read from device memory, against the
    plain version."""
    sc = debug.mirror_box(trt.cornell_box(device=cuda_device))
    cfg = trt.RenderConfig(width=32, height=32, aa_x=aa, aa_y=aa,
                           shadow_samples=2, bounces=20,
                           focal_length=debug.MIRROR_FOCAL / 4)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    assert (res.bounce_id[tbwd.REG_BOUNCES:] >= 0).any()
    _card_checks(sc, cfg, seed=20 + aa, budget=1e-3)
