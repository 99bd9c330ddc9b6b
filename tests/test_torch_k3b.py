"""Port tests: the buffers that ``kernels/render_bwd.py`` sizes for the
streamed backward kernel K3b (``csrc/render_bwd_streamed.cu``), which
takes one thread per AA ray, against its grid.

On the CPU: the block the wrapper hands the kernel (the forward's
``pixels_per_block``) is one the kernel takes (a whole number of warps of
pixels, a whole number of rounds of THREADS rays: the kernel refuses any
other), and ``band_bytes`` sizes a partial row per block of that grid and
a deep chain slot per thread of it. The kernel itself runs only on the
card: its tests are the ``cuda`` ones of ``tests/test_torch_streamed.py``,
ragged frames and A up to 16 among them."""
import pytest

from uob_raytracer_tpu_torch.kernels import render_bwd as tbwd

THREADS, WARP = tbwd.THREADS, 32


@pytest.mark.parametrize("A", [1, 2, 3, 4, 9, 16])
def test_streamed_block_is_one_the_kernel_takes(A):
    """valid_ppb of the kernel: a multiple of 32 pixels whose A rays fill
    whole rounds of THREADS threads; and the fewest such pixels (one round,
    one ray a thread, at A = 1, 2 and 4)."""
    ppb = tbwd.pixels_per_block(A)
    assert ppb % WARP == 0 and (ppb * A) % THREADS == 0
    assert all((m * A) % THREADS for m in range(WARP, ppb, WARP))
    if A in (1, 2, 4):
        assert ppb * A == THREADS


@pytest.mark.parametrize("A", [1, 4, 9])
@pytest.mark.parametrize("B", [2, 17, 32])
@pytest.mark.parametrize("W,n", [(37, 11), (64, 3), (128, 128)])
def test_streamed_backward_buffers_fit_the_grid(A, B, W, n):
    """The wrapper's per-site rows are (1 + B) * A rows of 16 floats a
    pixel, and its deep chain holds a slot per thread of the grid (13
    floats a step): ceil(n * W / pixels_per_block(A)) blocks of THREADS,
    one thread per AA ray; the whole-table chain kernel takes the same
    grid without the chain-free launch's list (and a smaller one with it),
    with a partial row per block."""
    cols = 2 * 16 + 21
    blocks = -(-n * W // tbwd.pixels_per_block(A))
    assert tbwd.launch_blocks(n * W, tbwd.pixels_per_block(A)) == blocks
    got = tbwd.band_bytes(n, W, A, B, cols, True)
    assert got["dlane"][0] == 4 * 16 * (1 + B) * A * n * W
    whole = tbwd.band_bytes(n, W, A, B, cols, False)
    assert whole["partials"][0] == 4 * blocks * cols
    assert tbwd.chain_blocks(n * W, A, False) == blocks
    assert tbwd.chain_blocks(n * W, A, True) <= blocks
    if B > tbwd.REG_BOUNCES:
        assert got["chain"][0] == 4 * tbwd.CHAIN_FLOATS * B * blocks * THREADS
        assert whole["chain"][0] == got["chain"][0]
    else:
        assert "chain" not in got and "chain" not in whole
