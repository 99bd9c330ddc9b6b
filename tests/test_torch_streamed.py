"""Port tests: the large-scene path (scenes whose tables do not fit the
whole-table kernels) against the JAX package's streamed kernels.

The scene is the JAX package's large-scene workload (``bench.py:dense_scene``
/ ``tests/test_pallas.py:_dense_scene``): the Cornell box plus random small
triangles, built here with numpy from the same seed and fed to both
packages. The JAX side runs its streamed Pallas kernels in interpret mode,
as its own tests do; on the CPU the port's wrappers run the kernels' plain
versions. The wrapper-side pieces of the streamed backward that do run on
the CPU (the segmented sum's plain version, the table cotangents, the
cut-over rule) are tested directly. Tests marked ``cuda`` launch the CUDA
kernels and skip without a card.

Tolerances: images within ``assert_images_match`` (at most 0.5% of pixels
beyond 3e-4, none beyond 0.45), and with a quad pairing at most 0.2% of
pixels beyond 2e-5 (``tests/test_pallas.py:test_streamed_occlusion_with_quads``);
the decision record equal on at least 99.5% of rays (boundary pixels may
flip); the streamed backward leaf by leaf within 2e-3 of max(max|ref|, 1)
(two float32 evaluations of the same replay, summed in different orders
over 600 triangles); ``train_step`` gradients within 2e-3 of max|ref| per
leaf (path replay against the JAX trainer's full autodiff,
``tests/test_replay.py:52-75``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import parallel as jpar
from uob_raytracer_tpu import scene as jscene
from uob_raytracer_tpu.kernels import render_bwd as jbwd
from uob_raytracer_tpu.kernels import render_fwd as jfwd
from uob_raytracer_tpu.ops.quads import detect_shadow_quads as jdetect
from uob_raytracer_tpu.render import render_image as j_render_image
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import parallel as tpar
from uob_raytracer_tpu_torch.kernels import render_bwd as tbwd
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops import replay as treplay
from uob_raytracer_tpu_torch.ops.image import pack_argb
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads as tdetect
from uob_raytracer_tpu_torch.scene import Scene, scene_from_numpy
from conftest import assert_images_match
from test_pallas import _dense_scene as j_dense_scene
from test_torch_render_bwd import mirror_box

LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


def dense_leaves(n_tri: int, seed: int = 1) -> dict:
    """The dense scene's leaves as numpy arrays: the Cornell box plus
    ``n_tri - 26`` random small diffuse triangles (the recipe of
    ``bench.py:dense_scene``)."""
    leaves = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jrt.cornell_box(as_numpy=True)).items()}
    rng = np.random.RandomState(seed)
    extra = n_tri - leaves["tri_v0"].shape[0]
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    for i, k in enumerate(("tri_v0", "tri_v1", "tri_v2")):
        leaves[k] = np.concatenate([leaves[k], verts[:, i]])
    leaves["tri_rgb"] = np.concatenate(
        [leaves["tri_rgb"], np.full((extra, 3), 0.6, np.float32)])
    leaves["tri_mat"] = np.concatenate(
        [leaves["tri_mat"], np.ones((extra,), np.float32)])
    return leaves


def scenes(n_tri: int):
    """(torch scene on the CPU, JAX scene) from the same numpy leaves."""
    leaves = dense_leaves(n_tri)
    return (scene_from_numpy(leaves, "cpu"),
            jscene.Scene(**{k: jnp.asarray(v) for k, v in leaves.items()}))


def _rgb(packed):
    """uint32 ARGB [H, W] -> float channels in [0, 1] [H, W, 3]."""
    p = np.ascontiguousarray(np.asarray(packed, dtype="<u4"))
    return p.view(np.uint8).reshape(*p.shape, 4)[..., :3] / np.float32(255)


def test_dense_scene_is_the_jax_recipe():
    """The numpy recipe gives the JAX package's scene leaf for leaf, and
    ``add_triangles`` of the port builds the same scene."""
    leaves = dense_leaves(600)
    ref = j_dense_scene(600)
    for k in LEAVES:
        np.testing.assert_array_equal(leaves[k], np.asarray(getattr(ref, k)), k)
    extra = np.stack([leaves[k][26:] for k in ("tri_v0", "tri_v1", "tri_v2")],
                     axis=1)
    sc = trt.add_triangles(trt.cornell_box(device="cpu"), extra,
                           leaves["tri_rgb"][26:], leaves["tri_mat"][26:])
    assert sc.num_triangles == 600 and sc.num_spheres == 2
    for k in LEAVES:
        np.testing.assert_allclose(getattr(sc, k).numpy(), leaves[k],
                                   atol=1e-7, rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# Forward and record against the JAX streamed kernel (interpret mode)
# --------------------------------------------------------------------------

FWD_CASES = {
    # the JAX package's own streamed case (test_streamed_large_scene)
    "600": (600, dict(width=128, height=16, shadow_samples=2, bounces=2)),
    # past 1,024 triangles: the JAX kernel's stream blocks are crossed twice
    "1100": (1100, dict(width=128, height=8, aa_x=1, aa_y=1, shadow_samples=2,
                        bounces=1)),
}


@pytest.fixture(scope="module", params=sorted(FWD_CASES))
def fwd_pair(request):
    """(JAX streamed kernel's image, packed, record; the port's; the
    port's scene) on one dense scene."""
    n_tri, kw = FWD_CASES[request.param]
    tsc, jsc = scenes(n_tri)
    assert jfwd._use_streamed(jsc)
    assert tfwd.use_streamed(tsc.num_triangles, tsc.num_spheres)
    ref = jfwd.render_fused_res(jsc, jrt.RenderConfig(**kw), interpret=True)
    before = (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES)
    got = tfwd.render_fused_res(tsc, trt.RenderConfig(**kw))
    assert (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES) == before   # plain version
    return ref, got, tsc


def test_forward_matches_jax_streamed(fwd_pair):
    (img_j, packed_j, _), (img_t, packed_t, _), _ = fwd_pair
    assert tuple(img_t.shape) == img_j.shape
    assert_images_match(img_t.numpy(), np.asarray(img_j),
                        what="torch plain vs JAX streamed kernel")
    assert torch.equal(packed_t.view(torch.int32),
                       pack_argb(img_t).view(torch.int32))
    assert_images_match(_rgb(packed_t.numpy()), _rgb(packed_j), what="packed")


def test_record_matches_jax_streamed(fwd_pair):
    """pid and bid on every ray; lit where the ray shades: primary-diffuse
    rays, and rays this record saw lit (elsewhere the JAX kernel scans a
    dummy point and the port writes 0, as tests/test_torch_replay.py)."""
    (_, _, res_j), (_, _, res_t), tsc = fwd_pair
    pid_j, lit_j, bid_j = (np.asarray(x) for x in res_j)
    pid_t, lit_t, bid_t = (x.numpy() for x in res_t)
    for name, a, b in (("pid", pid_j, pid_t), ("lit", lit_j, lit_t),
                       ("bid", bid_j, bid_t)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    assert (pid_j != pid_t).mean() <= 0.005
    assert (bid_j != bid_t).mean() <= 0.005
    assert (bid_t >= 0).any() and pid_t.max() >= 26   # added triangles are hit
    mat = np.concatenate([tsc.tri_mat.numpy(), tsc.sph_mat.numpy(), [0.0]])
    shades = ((pid_t >= 0) & (mat[pid_t] > 0)) | (lit_t > 0)
    assert shades.any()
    assert ((lit_j != lit_t) & shades).sum() <= 0.005 * shades.sum()


def test_forward_with_quads_matches_jax_streamed():
    """The mixed quad/triangle occlusion scan: the dense scene's Cornell
    walls pair. Both packages detect the same pairing; the port's plain
    version scans triangles, the JAX streamed kernel the merged rows."""
    tsc, jsc = scenes(600)
    q = jdetect(jsc)
    assert q is not None and len(q[0]) > 0 and tdetect(tsc) == q
    kw = dict(width=128, height=16, aa_x=1, aa_y=1, shadow_samples=3, bounces=1)
    img_j, _ = jfwd.render_fused_raw(jsc, jrt.RenderConfig(**kw),
                                     interpret=True, quads=q)
    img_t, _ = tfwd.render_fused_raw(tsc, trt.RenderConfig(**kw), quads=q)
    d = np.abs(img_t.numpy() - np.asarray(img_j)).max(-1)
    assert (d > 2e-5).mean() <= 0.002, (
        f"{(d > 2e-5).mean():.4%} pixels differ (max {d.max():.5f})")


def test_shadow_table_matches_jax_at_600():
    tsc, jsc = scenes(600)
    q = tdetect(tsc)
    a, b = tfwd.pack_shadow(tsc, q), np.asarray(jfwd.pack_shadow(jsc, q))
    assert tuple(a.shape) == b.shape == (600 - len(q[0]), tfwd.SHD_COLS)
    np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# Backward against the JAX streamed backward kernel (interpret mode)
# --------------------------------------------------------------------------

def test_backward_matches_jax_streamed():
    """render_replay_bwd on the CPU (its plain version) against the JAX
    streamed backward kernel, both fed the JAX forward kernel's record."""
    kw = dict(width=128, height=8, aa_x=1, aa_y=1, shadow_samples=2, bounces=1)
    tsc, jsc = scenes(600)
    cfg_j, cfg_t = jrt.RenderConfig(**kw), trt.RenderConfig(**kw)
    img, _, jres = jfwd.render_fused_res(jsc, cfg_j, interpret=True)
    g = np.random.RandomState(2).standard_normal(img.shape).astype(np.float32)
    ref = jbwd.render_replay_bwd(jsc, cfg_j, jres, jnp.asarray(g),
                                 interpret=True)
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    before = (tbwd.LAUNCHES, tbwd.STREAMED_LAUNCHES, tbwd.SEGMENT_SUM_LAUNCHES)
    got = tbwd.render_replay_bwd(tsc, cfg_t, res, torch.from_numpy(g))
    assert (tbwd.LAUNCHES, tbwd.STREAMED_LAUNCHES,
            tbwd.SEGMENT_SUM_LAUNCHES) == before
    for k in LEAVES:
        a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.abs(a - b).max() <= 2e-3 * max(np.abs(a).max(), 1.0), k
    # the added triangles get gradients too, not only the Cornell box
    assert np.abs(got.tri_v0.numpy()[26:]).max() > 0
    assert np.abs(got.tri_rgb.numpy()[26:]).max() > 0


# --------------------------------------------------------------------------
# The wrapper-side pieces that run on the CPU
# --------------------------------------------------------------------------

def _sites(n, n_seg, seed, integers):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-2, n_seg + 3, n).astype(np.int32)   # some out of range
    rows = (rs.randint(-8, 9, (n, 16)) if integers
            else rs.standard_normal((n, 16))).astype(np.float32)
    keep = (ids >= 0) & (ids < n_seg)
    ref = np.zeros((n_seg, 16), np.float64)
    np.add.at(ref, ids[keep], rows[keep].astype(np.float64))
    return ids, rows, ref


@pytest.mark.parametrize("integers", [True, False])
def test_segment_sum_matches_numpy(integers):
    """Exact for integer-valued floats, 1e-6 relative otherwise; ids outside
    [0, n_seg) are ignored; empty segments are zero."""
    ids, rows, ref = _sites(5000, 300, 0, integers)
    before = tbwd.SEGMENT_SUM_LAUNCHES
    out = tbwd.segment_sum(torch.from_numpy(ids), torch.from_numpy(rows), 300)
    assert tbwd.SEGMENT_SUM_LAUNCHES == before       # CPU: the plain version
    assert out.shape == (300, 16) and out.dtype == torch.float32
    if integers:
        np.testing.assert_array_equal(out.numpy(), ref.astype(np.float32))
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    empty = tbwd.segment_sum(torch.full((7,), -1, dtype=torch.int32),
                             torch.ones((7, 16)), 4)
    assert empty.shape == (4, 16) and not empty.any()


def test_segment_sum_on_a_permuted_input():
    """The same sites in another order: bit-equal for integer-valued floats
    (every partial sum is exact), within 1e-6 otherwise (float addition is
    not associative, and the order within a segment follows the input); two
    calls on the same input are bit-equal."""
    perm = np.random.RandomState(9).permutation(5000)
    for integers in (True, False):
        ids, rows, ref = _sites(5000, 300, 1, integers)
        a = tbwd.segment_sum(torch.from_numpy(ids), torch.from_numpy(rows), 300)
        b = tbwd.segment_sum(torch.from_numpy(ids[perm]),
                             torch.from_numpy(rows[perm]), 300)
        again = tbwd.segment_sum(torch.from_numpy(ids), torch.from_numpy(rows),
                                 300)
        assert torch.equal(a, again)
        if integers:
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max() <= 1e-6 * np.abs(ref).max()


def test_site_ids_layout():
    """Site 0 is the primary hit, site 1 + k bounce step k, each [A, rows, W]
    flattened: row (site * A + a) * n_pix + p of the kernel's dlane."""
    A, H, W, B = 2, 3, 4, 2
    pid = torch.arange(A * H * W, dtype=torch.int32).reshape(A, H, W)
    bid = 100 + torch.arange(B * A * H * W, dtype=torch.int32).reshape(B, A, H, W)
    lit = torch.zeros((A, H, W))
    ids = tbwd.site_ids(treplay.Residuals(pid, lit, bid))
    assert ids.dtype == torch.int32 and ids.shape == ((1 + B) * A * H * W,)
    site, a, p = 2, 1, 7
    assert ids[(site * A + a) * H * W + p] == bid[site - 1, a].reshape(-1)[p]
    assert ids[(0 * A + a) * H * W + p] == pid[a].reshape(-1)[p]
    none = tbwd.site_ids(treplay.Residuals(
        pid, lit, torch.zeros((0, A, H, W), dtype=torch.int32)))
    assert torch.equal(none, pid.reshape(-1))


def test_streamed_table_cotangents_match_whole_table():
    """The streamed kernel's outputs (per-site triangle rows, sphere and
    camera partials) give the table cotangents that the whole-table
    kernel's partials give for the same per-site cotangents."""
    n_tri, n_sph, blocks, n = 40, 2, 3, 500
    rs = np.random.RandomState(4)
    ids = rs.randint(-1, n_tri + n_sph, n).astype(np.int32)
    dlane = rs.randint(-4, 5, (n, 16)).astype(np.float32)
    dlane[:, 15] = 0                              # a triangle row has no r2
    dlane[(ids < 0) | (ids >= n_tri)] = 0         # dead and sphere sites
    part_s = rs.randint(-4, 5, (blocks, n_sph * 16 + 21)).astype(np.float32)
    # the same cotangents as one whole-table partial row per block
    tri_sums = np.zeros((n_tri, 16), np.float32)
    keep = (ids >= 0) & (ids < n_tri)
    np.add.at(tri_sums, ids[keep], dlane[keep])
    part_w = np.zeros((blocks, (n_tri + n_sph) * 16 + 21), np.float32)
    part_w[0, :n_tri * 16] = tri_sums.reshape(-1)
    part_w[:, n_tri * 16:] = part_s
    got = tbwd.streamed_table_cotangents(
        torch.from_numpy(part_s), torch.from_numpy(dlane),
        torch.from_numpy(ids), n_tri, n_sph, n_sph)
    ref = tbwd.table_cotangents(torch.from_numpy(part_w), n_tri, n_sph, n_sph)
    for name, a, b in zip(("dtri", "dsph", "dcam"), got, ref):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert got[0].shape == (n_tri, tfwd.TRI_COLS) and not got[0][:, 15:].any()
    # no spheres (cpu_ref): pack_scene's one zero row gets a zero cotangent
    dtri, dsph, dcam = tbwd.streamed_table_cotangents(
        torch.ones((blocks, 21)), torch.from_numpy(dlane),
        torch.from_numpy(ids), n_tri, 0, 1)
    assert dsph.shape == (1, tfwd.SPH_COLS) and not dsph.any()
    assert torch.equal(dcam, torch.full((21,), float(blocks)))


# (rows, W, A, B, partial columns, streamed): dense_8192 at full_1024's
# config (2.95 GB of per-site rows: two bands), full_1024 whole-table (one
# band), 32 bounces whole-table and streamed (the deep chain), a small
# frame, one row, no rows
BAND_CASES = [(1024, 1024, 4, 10, 2 * 16 + 21, True),
              (1024, 1024, 4, 10, 28 * 16 + 21, False),
              (1024, 1024, 4, 32, 28 * 16 + 21, False),
              (512, 512, 1, 32, 2 * 16 + 21, True),
              (13, 40, 2, 2, 2 * 16 + 21, True),
              (1, 8, 1, 0, 21, True),
              (0, 8, 1, 0, 21, False)]


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("scale", [1, 64])
def test_row_bands_cover_the_frame_within_the_limits(case, scale,
                                                     monkeypatch):
    """The bands cover [0, rows) in order, each within every byte limit,
    as few as there can be (the tallest band that fits, found row by row,
    gives the count), all but the last of one height. ``scale`` lowers the
    limits to force many bands."""
    for name in ("MAX_DLANE_BYTES", "MAX_PARTIAL_BYTES", "MAX_CHAIN_BYTES"):
        monkeypatch.setattr(tbwd, name, getattr(tbwd, name) // scale)
    rows, W, A, B, cols, streamed = case
    bands = tbwd._row_bands(rows, W, A, B, cols, streamed)
    assert [o for o, _ in bands] == list(
        np.cumsum([0] + [n for _, n in bands])[:-1])
    assert sum(n for _, n in bands) == rows and all(n > 0 for _, n in bands)
    for _, n in bands:
        for b, lim in tbwd.band_bytes(n, W, A, B, cols, streamed).values():
            assert b <= lim
    fits = [n for n in range(1, rows + 1) if all(
        b <= lim for b, lim in tbwd.band_bytes(n, W, A, B, cols,
                                               streamed).values())]
    assert len(bands) == (-(-rows // max(fits)) if rows else 0)
    assert len({n for _, n in bands[:-1]}) <= 1
    assert "chain" in tbwd.band_bytes(1, W, A, B, cols, streamed) or B <= 16
    if case == BAND_CASES[0] and scale == 1:
        assert bands == [(0, 512), (512, 512)]


@pytest.mark.parametrize("limit", ["MAX_DLANE_BYTES", "MAX_CHAIN_BYTES"])
def test_row_bands_refuse_a_row_past_the_limit(limit, monkeypatch):
    """One row that passes a limit cannot be banded: the planner raises and
    names the buffer."""
    W, A, B = 64, 4, 20
    one = tbwd.band_bytes(1, W, A, B, 21, True)
    key = "dlane" if limit == "MAX_DLANE_BYTES" else "chain"
    monkeypatch.setattr(tbwd, limit, one[key][0] - 1)
    with pytest.raises(ValueError, match=key):
        tbwd._row_bands(8, W, A, B, 21, True)


def test_cut_over_rule():
    """One function routes forward and backward, from the scene's size
    alone: whole-table up to STREAM_ABOVE_TRIANGLES while both whole-table
    kernels fit one block's shared memory, streamed beyond."""
    limit = tfwd.STREAM_ABOVE_TRIANGLES
    assert not tfwd.use_streamed(26, 2) and not tfwd.use_streamed(26, 0)
    assert not tfwd.use_streamed(limit, 2)
    assert tfwd.use_streamed(limit + 1, 2) and tfwd.use_streamed(8192, 2)
    # whatever the triangle limit, a scene whose tables do not fit streams
    for n_tri in (26, 128, 512, 600, 714, 1024):
        fits = (tfwd.shared_bytes(n_tri, 2, n_tri) <= tfwd.SMEM_BUDGET_BYTES
                and tbwd.shared_bytes(n_tri + 2) <= tfwd.SMEM_BUDGET_BYTES)
        assert tfwd.use_streamed(n_tri, 2) == (n_tri > limit or not fits)
    # either side of the shared-memory budget (the backward's binds first)
    edge = max(n for n in range(1, 2000)
               if tbwd.shared_bytes(n) <= tfwd.SMEM_BUDGET_BYTES)
    assert tbwd.shared_bytes(edge + 1) > tfwd.SMEM_BUDGET_BYTES
    assert tfwd.use_streamed(edge - 1, 2)      # edge + 1 objects: too many
    assert tfwd.pick_kernel(26, 2, None) is False
    assert tfwd.pick_kernel(26, 2, "streamed") is True
    assert tfwd.pick_kernel(8192, 2, "whole") is False
    with pytest.raises(ValueError, match="_kernel"):
        tfwd.pick_kernel(26, 2, "smem")
    assert not hasattr(tfwd, "MAX_TRIANGLES")


def test_plain_version_chunks_bound_memory():
    """The plain version's [rays, triangles] broadcast stays near 2^23
    pairs per chunk at any triangle count (a whole row at least), and the
    small-scene chunking is what it was."""
    big = trt.RenderConfig(width=128, height=128, aa_x=2, aa_y=2)
    for n_tri in (600, 8192, 100000):
        rows = tfwd._pick_chunk_rows(big, n_tri=n_tri)
        assert 128 % rows == 0
        assert rows == 1 or rows * 128 * 4 * n_tri <= 1 << 23
    assert tfwd._pick_chunk_rows(big, n_tri=26) == tfwd._pick_chunk_rows(big)
    assert tfwd._pick_chunk_rows(trt.RenderConfig(), n_tri=26) == 64
    # chunking changes no pixel
    tsc, _ = scenes(600)
    cfg = trt.RenderConfig(width=32, height=8, shadow_samples=2, bounces=1)
    a = tfwd.render_fused_plain(tsc, cfg, chunk_rows=1)[0]
    b = tfwd.render_fused_plain(tsc, cfg, chunk_rows=8)[0]
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The slice as a whole: train_step on a large scene
# --------------------------------------------------------------------------

def test_train_step_on_dense_scene_matches_jax():
    """Three SGD steps on light_pos and tri_rgb of the 600-triangle scene:
    the loss falls, and each step's gradients (read off the update) match
    the JAX trainer's (one-device mesh, full autodiff) to 2e-3."""
    kw = dict(width=32, height=32, aa_x=1, aa_y=1, shadow_samples=2, bounces=1)
    cfg_j, cfg_t = jrt.RenderConfig(**kw), trt.RenderConfig(**kw)
    tsc, jsc = scenes(600)
    target = j_render_image(dataclasses.replace(
        jsc, light_pos=jnp.asarray([0.25, -0.5, -0.7], jnp.float32)),
        cfg_j, backend="jnp")
    ttarget = torch.from_numpy(np.array(target))
    mesh = jpar.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    names, lr, losses = ("light_pos", "tri_rgb"), 2.0, []
    for _ in range(3):
        jout = jpar.train_step(jsc, target, cfg_j, mesh, lr=lr, trainable=names)
        tout = tpar.train_step(tsc, ttarget, cfg_t, lr=lr, trainable=names)
        np.testing.assert_allclose(tout.loss.item(), float(jout.loss),
                                   rtol=1e-4)
        for k in names:
            g_j = (np.asarray(getattr(jsc, k))
                   - np.asarray(getattr(jout.scene, k))) / lr
            g_t = (getattr(tsc, k) - getattr(tout.scene, k)).numpy() / lr
            assert np.abs(g_j).max() > 0
            assert np.abs(g_j - g_t).max() <= 2e-3 * np.abs(g_j).max(), k
        losses.append(tout.loss.item())
        jsc, tsc = jout.scene, tout.scene
    assert losses[2] < losses[0]


# --------------------------------------------------------------------------
# On the card (skip without one): the streamed kernels
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
@pytest.mark.parametrize("n_tri", [600, 1100])
def test_streamed_forward_kernel_on_card(cuda_device, n_tri):
    """The streamed kernel against its plain version (image budget, exact
    pack, record within 0.5%), with and without the quad pairing."""
    sc = scene_from_numpy(dense_leaves(n_tri), cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=3, bounces=2)
    ref, _, ref_res = tfwd.render_fused_res_plain(sc, cfg)
    for quads in (None, tdetect(sc)):
        before = (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES)
        img, packed, res = tfwd.render_fused_res(sc, cfg, quads=quads)
        torch.cuda.synchronize()
        assert (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES) == (before[0],
                                                           before[1] + 1)
        assert_images_match(img.cpu().numpy(), ref.cpu().numpy(),
                            what=f"{n_tri} quads={quads is not None}")
        assert torch.equal(packed.view(torch.int32),
                           pack_argb(img).view(torch.int32))
        for a, b in zip(res, ref_res):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert (a != b).float().mean() <= 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri", [26, 600])
def test_streamed_forward_equals_whole_table_on_card(cuda_device, n_tri):
    """A scene both kernels can run: the same image, pack and record bit
    for bit, full frame and row band."""
    sc = scene_from_numpy(dense_leaves(n_tri), cuda_device) if n_tri > 26 \
        else trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=3, bounces=3)
    for band in ((None, None), (7, 9)):
        a = tfwd.render_fused_res(sc, cfg, *band, _kernel="whole")
        b = tfwd.render_fused_res(sc, cfg, *band, _kernel="streamed")
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri", [600, 1100])
def test_streamed_backward_kernel_on_card(cuda_device, n_tri):
    """The streamed backward and its segmented sum against the plain
    version (1e-4: few rays reach the glass sphere at this size), two runs
    bit-equal, and against the whole-table kernel where that fits."""
    sc = scene_from_numpy(dense_leaves(n_tri), cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=3, bounces=1)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (20, 96, 3)).astype(np.float32)).to(cuda_device)
    before = (tbwd.LAUNCHES, tbwd.STREAMED_LAUNCHES, tbwd.SEGMENT_SUM_LAUNCHES)
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again = tbwd.render_replay_bwd(sc, cfg, res, g)
    torch.cuda.synchronize()
    assert (tbwd.LAUNCHES, tbwd.STREAMED_LAUNCHES,
            tbwd.SEGMENT_SUM_LAUNCHES) == (before[0], before[1] + 2,
                                           before[2] + 2)
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g,
                                                   return_primal=True)
    assert _leafwise(ref, got) <= 1e-4
    assert torch.allclose(primal, ref_primal, atol=1e-4)
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    if n_tri == 600:
        whole = tbwd.render_replay_bwd(sc, cfg, res, g, _kernel="whole")
        assert _leafwise(whole, got) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [1, 2, 4])
@pytest.mark.parametrize("deep", [False, True])
def test_streamed_backward_per_ray_on_card(cuda_device, monkeypatch, aa,
                                           deep):
    """The streamed backward with one thread per AA ray, A in {1, 4, 16}
    (at 16 a block of 32 pixels holds 512 rays, four a thread), its
    register instance (2 bounces) and its deep one (20, the mirror box), on
    a ragged frame (37 x 11 pixels: the last block is partly empty): within
    1e-4 of the plain version leaf by leaf and the replayed image within
    1e-4 of the plain primal; within 1e-5 of the whole-table kernel on the
    same record, the image bit for bit (each pixel's rays added in ray
    order in both); two runs bit-equal; and every per-site row whose
    recorded id is not a triangle (a miss, a sphere, a step the ray never
    ran) zero."""
    sc = scene_from_numpy(dense_leaves(600), cuda_device)
    more = {}
    if deep:
        sc = mirror_box(sc)
        more = {"focal_length": 4400.0}
    cfg = trt.RenderConfig(width=37, height=11, aa_x=aa, aa_y=aa,
                           shadow_samples=2, bounces=20 if deep else 2,
                           **more)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    if deep:
        assert (res.bounce_id[tbwd.REG_BOUNCES:] >= 0).any()
    g = torch.from_numpy(np.random.RandomState(aa + 2 * deep).standard_normal(
        (11, 37, 3)).astype(np.float32)).to(cuda_device)
    seen = []
    real = tbwd.streamed_table_cotangents

    def keep(partial, dlane, ids, *rest):
        seen.append((dlane.clone(), ids.clone()))
        return real(partial, dlane, ids, *rest)

    monkeypatch.setattr(tbwd, "streamed_table_cotangents", keep)
    before = tbwd.STREAMED_LAUNCHES
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again, primal_again = tbwd.render_replay_bwd(sc, cfg, res, g,
                                                 return_primal=True)
    torch.cuda.synchronize()
    assert tbwd.STREAMED_LAUNCHES == before + 2
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g,
                                                   return_primal=True)
    assert _leafwise(ref, got) <= 1e-4
    assert torch.allclose(primal, ref_primal, atol=1e-4)
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    assert torch.equal(primal, primal_again)
    whole, whole_primal = tbwd.render_replay_bwd(
        sc, cfg, res, g, return_primal=True, _kernel="whole")
    assert _leafwise(whole, got) <= 1e-5
    assert torch.equal(primal, whole_primal)
    dlane, ids = seen[0]
    dead = (ids < 0) | (ids >= sc.num_triangles)
    assert dead.any() and not dlane[dead].any()


@pytest.mark.cuda
def test_segment_sum_kernel_on_card(cuda_device):
    ids, rows, ref = _sites(20000, 700, 3, integers=True)
    ids_c = torch.from_numpy(ids).to(cuda_device)
    rows_c = torch.from_numpy(rows).to(cuda_device)
    before = tbwd.SEGMENT_SUM_LAUNCHES
    out = tbwd.segment_sum(ids_c, rows_c, 700)
    torch.cuda.synchronize()
    assert tbwd.SEGMENT_SUM_LAUNCHES == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), ref.astype(np.float32))
    ids, rows, ref = _sites(20000, 700, 4, integers=False)
    a = tbwd.segment_sum(torch.from_numpy(ids).to(cuda_device),
                         torch.from_numpy(rows).to(cuda_device), 700)
    b = tbwd.segment_sum(torch.from_numpy(ids).to(cuda_device),
                         torch.from_numpy(rows).to(cuda_device), 700)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.cuda
def test_streamed_backward_refuses_an_oversized_dlane(cuda_device, monkeypatch):
    """Above MAX_DLANE_BYTES the wrapper no longer refuses: it takes the
    frame in row bands (one launch and one segmented sum each), within 1e-5
    of one launch, the replayed radiance bit for bit, two banded runs
    bit-equal; a band asked for by the caller runs as before."""
    sc = scene_from_numpy(dense_leaves(600), cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=2, bounces=1)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (20, 96, 3)).astype(np.float32)).to(cuda_device)
    one, p_one = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    sites = 2 * cfg.aa_rays * 20 * 96
    monkeypatch.setattr(tbwd, "MAX_DLANE_BYTES", 64 * sites - 1)
    before = (tbwd.STREAMED_LAUNCHES, tbwd.SEGMENT_SUM_LAUNCHES)
    two, p_two = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    three = tbwd.render_replay_bwd(sc, cfg, res, g)
    torch.cuda.synchronize()
    assert (tbwd.STREAMED_LAUNCHES, tbwd.SEGMENT_SUM_LAUNCHES) == (
        before[0] + 4, before[1] + 4)                 # two bands a call
    assert _leafwise(one, two) <= 1e-5
    assert torch.equal(p_one, p_two)
    assert all(torch.equal(getattr(two, k), getattr(three, k)) for k in LEAVES)
    band = treplay.Residuals(*(t[..., 4:12, :].contiguous() for t in res))
    bar = tbwd.render_replay_bwd(sc, cfg, band, g[4:12].contiguous(),
                                 row0=4, rows=8)
    assert torch.isfinite(bar.tri_v0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [17, 20, 32])
def test_streamed_deep_backward_kernel_on_card(cuda_device, bounces):
    """The streamed backward past its in-register depth (the deep instance)
    at 600 triangles (the dense scene as the mirror box), rows whose chains
    run past 16 steps, against the plain version; two runs bit-equal."""
    sc = mirror_box(scene_from_numpy(dense_leaves(600), cuda_device))
    cfg = trt.RenderConfig(width=128, height=128, aa_x=1, aa_y=1,
                           shadow_samples=2, bounces=bounces,
                           focal_length=4400.0)
    _, _, res = tfwd.render_fused_res(sc, cfg, 48, 8)
    assert (res.bounce_id[tbwd.REG_BOUNCES:] >= 0).any()
    g = torch.from_numpy(np.random.RandomState(bounces).standard_normal(
        (8, 128, 3)).astype(np.float32)).to(cuda_device)
    before = tbwd.STREAMED_LAUNCHES
    got = tbwd.render_replay_bwd(sc, cfg, res, g, 48, 8)
    again = tbwd.render_replay_bwd(sc, cfg, res, g, 48, 8)
    torch.cuda.synchronize()
    assert tbwd.STREAMED_LAUNCHES == before + 2
    ref = tbwd.render_replay_bwd_plain(sc, cfg, res, g, 48, 8)
    assert _leafwise(ref, got) <= 1e-4
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [(1, 1), (2, 2), (3, 3)])
def test_streamed_forward_per_ray_equals_whole_table_on_card(cuda_device,
                                                             aa):
    """K3f with one thread per AA ray: A in {1, 4, 9}, on a frame whose
    last block is ragged (a row band of 37 columns), bit for bit the
    whole-table kernel's image, pack and record."""
    sc = scene_from_numpy(dense_leaves(300), cuda_device)
    cfg = trt.RenderConfig(width=37, height=11, aa_x=aa[0], aa_y=aa[1],
                           shadow_samples=3, bounces=3)
    for quads in (None, tdetect(sc)):
        for band in ((None, None), (2, 7)):
            a = tfwd.render_fused_res(sc, cfg, *band, quads=quads,
                                      _kernel="whole")
            b = tfwd.render_fused_res(sc, cfg, *band, quads=quads,
                                      _kernel="streamed")
            torch.cuda.synchronize()
            assert torch.equal(a[0], b[0])
            assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
            assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["equal", "permuted"])
def test_segment_sum_long_runs_on_card(cuda_device, case):
    """The two-pass segmented sum on a run of 100,000 equal ids (split over
    warps in tiles) and on a random permutation of mixed runs: within 1e-6
    of the sums' magnitude of their float64 value (what index_add_, the
    plain version, adds in float32), two runs bit-equal."""
    rs = np.random.RandomState(7)
    n, n_seg = 100_000, 50
    ids = (np.full(n, 3, np.int32) if case == "equal"
           else rs.randint(-1, n_seg + 1, n).astype(np.int32)[rs.permutation(n)])
    rows = rs.standard_normal((n, 16)).astype(np.float32)
    keep = (ids >= 0) & (ids < n_seg)
    ref = np.zeros((n_seg, 16))
    np.add.at(ref, ids[keep], rows[keep].astype(np.float64))
    ids_c = torch.from_numpy(ids).to(cuda_device)
    rows_c = torch.from_numpy(rows).to(cuda_device)
    a = tbwd.segment_sum(ids_c, rows_c, n_seg)
    b = tbwd.segment_sum(ids_c, rows_c, n_seg)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.cuda
def test_function_on_card_routes_a_large_scene_to_streamed_kernels(cuda_device):
    sc = scene_from_numpy(dense_leaves(600), cuda_device)
    live = dataclasses.replace(sc, **{
        k: getattr(sc, k).detach().clone().requires_grad_(True)
        for k in ("light_pos", "tri_rgb")})
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=2, bounces=1)
    before = (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES, tbwd.LAUNCHES,
              tbwd.STREAMED_LAUNCHES)
    grads = torch.autograd.grad(trt.render_image(live, cfg).mean(),
                                [live.light_pos, live.tri_rgb])
    assert (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES, tbwd.LAUNCHES,
            tbwd.STREAMED_LAUNCHES) == (before[0], before[1] + 1, before[2],
                                        before[3] + 1)
    assert all(torch.isfinite(t).all() for t in grads)
