"""Port tests: the per-shard partial scans (``kernels/partial.py``:
``nearest_tris``, ``occluded_tris``) and the kernel route of the wavefront
pipeline (``shade(..., tri_pass='kernel')``) against the JAX package's
partial-scan Pallas kernels, on the CPU.

The shard is the dense scene's triangle table (the Cornell box plus random
small triangles, ``tests/test_torch_streamed.py:dense_leaves``) and the ray
batch comes from a seed through numpy: origins inside the box, directions
on the sphere. Both packages get the same arrays. The JAX side runs its
kernels in interpret mode, as its own tests do; on the CPU the port's
wrappers run the kernels' plain versions. Tests marked ``cuda`` launch the
CUDA kernels and skip without a card.

Tolerances: winner ids and occlusion bits equal; ``t`` and ``pos`` within
1e-5; ``normal``, ``rgb`` and ``mat`` (gathered, not computed) equal; the
nearest hit's gradients rtol 1e-4, atol 1e-6 of max|ref| per input (the
same replay, summed over rays in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.kernels import partial as jpartial
from uob_raytracer_tpu.ops.camera import gen_primary_rays as j_gen_rays
from uob_raytracer_tpu.ops.intersect import prepare_scene as j_prepare_scene
from uob_raytracer_tpu.ops.shading import shade as j_shade
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.kernels import partial as tpartial
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops.camera import gen_primary_rays
from uob_raytracer_tpu_torch.ops.intersect import intersect, prepare_scene
from uob_raytracer_tpu_torch.ops.shading import shade
from conftest import assert_images_match
from test_torch_flops import occlusion_batch
from test_torch_streamed import scenes

N_TRI, N_RAYS = 300, 1500      # 1,500 rays: a ragged last tile on both sides
SHARD = ("v0", "e1", "e2", "n", "rgb", "mat")


def ray_batch(n: int, seed: int):
    """(start, d, radius_sq) as numpy float32: origins inside the box,
    unit directions, squared distances to a light."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return start, d, rng.uniform(0.05, 2.0, (n,)).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """The shard's tables and the ray batch, for both packages."""
    tsc, jsc = scenes(N_TRI)
    tds = prepare_scene(tsc)
    start, d, r2 = ray_batch(N_RAYS, seed=7)
    t_in = [getattr(tds, k) for k in SHARD] + [torch.from_numpy(start),
                                               torch.from_numpy(d)]
    j_in = [jnp.asarray(x.numpy()) for x in t_in]
    return t_in, j_in, torch.from_numpy(r2), jnp.asarray(r2)


def test_nearest_tris_matches_pallas(problem):
    t_in, j_in, _, _ = problem
    ref = [np.asarray(x) for x in jpartial.nearest_tris_pallas(*j_in)]
    with torch.no_grad():
        out = [x.numpy() for x in tpartial.nearest_tris(*t_in)]
    t, pos, nrm, rgb, mat, idx = out
    assert idx.dtype == np.int32 and (idx >= 0).sum() > N_RAYS // 2
    np.testing.assert_array_equal(idx, ref[5])
    hit = idx >= 0
    assert np.isinf(t[~hit]).all() and np.isinf(ref[0][~hit]).all()
    np.testing.assert_allclose(t[hit], ref[0][hit], atol=1e-5)
    np.testing.assert_allclose(pos, ref[1], atol=1e-5)
    for got, want in zip((nrm, rgb, mat), ref[2:5]):
        np.testing.assert_array_equal(got, want)
    # some winners among the random small triangles, not only the walls
    assert (idx >= 26).sum() > 0
    # the plain version by name is what the wrapper ran, in chunks or not
    whole = tpartial.nearest_tris_plain(*t_in)
    old = tpartial.PLAIN_PAIRS
    tpartial.PLAIN_PAIRS = 7 * N_TRI
    try:
        chunked = tpartial.nearest_tris_plain(*t_in)
    finally:
        tpartial.PLAIN_PAIRS = old
    for a, b, c in zip(out, whole, chunked):
        assert np.array_equal(a, b.numpy()) and torch.equal(b, c)


def test_occluded_tris_matches_pallas(problem):
    t_in, j_in, r2_t, r2_j = problem
    glass = t_in[5].clone()
    glass[::3] = -1.0                 # every third triangle casts no shadow
    args_t = (*t_in[:3], glass, *t_in[6:], r2_t)
    ref = np.asarray(jpartial.occluded_tris_pallas(
        *j_in[:3], jnp.asarray(glass.numpy()), *j_in[6:], r2_j))
    out = tpartial.occluded_tris(*args_t)
    assert out.dtype == torch.bool and out.shape == (N_RAYS,)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.1 < ref.mean() < 0.9
    # glass matters: with every triangle casting a shadow more rays are dark
    solid = tpartial.occluded_tris(*t_in[:3], t_in[5], *t_in[6:], r2_t)
    assert solid.sum() > out.sum() and (solid | ~out).all()
    assert torch.equal(out, tpartial.occluded_tris_plain(*args_t))
    empty = tpartial.occluded_tris(*t_in[:3], glass, t_in[6][:0], t_in[7][:0],
                                   r2_t[:0])
    assert empty.shape == (0,)
    assert (tpartial.NEAREST_LAUNCHES, tpartial.OCCLUDED_LAUNCHES) == (0, 0)


def test_nearest_tris_grads_match_jax_vjp(problem):
    """All of v0, e1, e2, n, rgb, start, d against ``jax.vjp`` of the JAX
    wrapper (its path-replay custom_vjp), on seeded cotangents."""
    t_in, j_in, _, _ = problem
    rng = np.random.RandomState(11)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((N_RAYS,), (N_RAYS, 3), (N_RAYS, 3), (N_RAYS, 3))]

    def j_fn(v0, e1, e2, n, rgb, start, d):
        return jpartial.nearest_tris_pallas(v0, e1, e2, n, rgb, j_in[5],
                                            start, d)[:4]

    j_args = j_in[:5] + j_in[6:]
    _, vjp = jax.vjp(j_fn, *j_args)
    ref = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]

    ins = [x.clone().requires_grad_(True) for x in t_in]
    out = tpartial.nearest_tris(*ins)
    assert not out[4].requires_grad and not out[5].requires_grad
    diff = [x for i, x in enumerate(ins) if i != 5]
    # t is inf on a miss: its cotangent there is void, as in the JAX rule
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in
               zip((torch.where(out[5] >= 0, out[0], 0.0), *out[1:4]), cts))
    got = torch.autograd.grad(loss, diff)
    names = [k for k in SHARD if k != "mat"] + ["start", "d"]
    for name, g, r in zip(names, got, ref):
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(r).max(), 1.0),
                                   err_msg=name)
    # the same bits on a second run (the deterministic row sum)
    again = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(
            tpartial.nearest_tris(*ins)[1:4], cts[1:])), diff[:5])
    again2 = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(
            tpartial.nearest_tris(*ins)[1:4], cts[1:])), diff[:5])
    assert all(torch.equal(a, b) for a, b in zip(again, again2))


def test_nearest_tris_grads_match_plain_autograd(problem):
    """The replay backward against plain autograd through the plain
    version: the argmin freezes the winner there as the record does here."""
    t_in, _, _, _ = problem
    rng = np.random.RandomState(12)
    cts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((N_RAYS, 3), (N_RAYS, 3), (N_RAYS, 3))]
    grads = []
    for fn in (tpartial.nearest_tris, tpartial.nearest_tris_plain):
        ins = [x.clone().requires_grad_(True) for x in t_in]
        out = fn(*ins)
        loss = sum((o * c).sum() for o, c in zip(out[1:4], cts))
        grads.append(torch.autograd.grad(
            loss, [x for i, x in enumerate(ins) if i != 5]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * max(b.abs().max().item(), 1.0))


def test_wrappers_refuse_other_devices(problem):
    t_in, _, r2, _ = problem
    meta = [x.to("meta") for x in t_in]
    with pytest.raises(ValueError, match="CUDA device"):
        tpartial.nearest_tris(*meta)
    with pytest.raises(ValueError, match="CUDA device"):
        tpartial.occluded_tris(*meta[:3], meta[5], *meta[6:], r2.to("meta"))
    with pytest.raises(ValueError, match="unknown tri_pass"):
        intersect(prepare_scene(
            trt.cornell_box(device="cpu")), t_in[6], t_in[7], None, "pallas")


@pytest.mark.parametrize("n_tri", [26, N_TRI])
def test_shade_kernel_route_matches_jax(n_tri):
    """``shade`` with the triangle scans through the partial kernels and no
    sharded axis (the one-chip run of the tp pipeline) against the JAX
    ``shade(..., None, 'pallas')``, and against the port's torch route."""
    tsc, jsc = scenes(n_tri) if n_tri > 26 else (
        trt.cornell_box(device="cpu"), jrt.cornell_box())
    kw = dict(width=16, height=8, aa_x=2, aa_y=1, shadow_samples=2, bounces=2)
    cfg_t, cfg_j = trt.RenderConfig(**kw), jrt.RenderConfig(**kw)
    dirs, gid = j_gen_rays(cfg_j, jsc.yaw, jsc.pitch)
    jds = j_prepare_scene(jsc)
    d_j = dirs.reshape(-1, 3)
    gid_j = jnp.repeat(gid.reshape(-1), dirs.shape[2])
    start_j = jnp.broadcast_to(jds.camera_pos, d_j.shape)
    ref = np.asarray(j_shade(jds, cfg_j, start_j, d_j, gid_j, None,
                                    "pallas"))

    tds = prepare_scene(tsc)
    dirs_t, gid_t = gen_primary_rays(cfg_t, tsc.yaw, tsc.pitch)
    d_t = dirs_t.reshape(-1, 3)
    gid_t = gid_t.reshape(-1).repeat_interleave(dirs_t.shape[2])
    start_t = tsc.camera_pos.expand(d_t.shape[0], 3)
    with torch.no_grad():
        out = shade(tds, cfg_t, start_t, d_t, gid_t,
                             tri_pass="kernel")
        plain = shade(tds, cfg_t, start_t, d_t, gid_t)
    shape = (cfg_t.height, cfg_t.width * cfg_t.aa_rays, 3)
    assert_images_match(out.numpy().reshape(shape), ref.reshape(shape),
                        tight=1e-5, outlier_frac=0.01,
                        what="shade kernel route vs JAX pallas route")
    assert_images_match(out.numpy().reshape(shape),
                        plain.numpy().reshape(shape), tight=1e-5,
                        outlier_frac=0.01, what="kernel route vs torch route")
    # the frame through render_flat's kernel route is that shade, one chunk
    with torch.no_grad():
        flat = tfwd.render_flat(tsc, cfg_t, tri_pass="kernel")
    assert torch.equal(flat.reshape(-1, 3), out)


def test_shade_kernel_route_gradients():
    """Gradients of a frame through the kernel route (the replay backward
    of ``nearest_tris``) against the torch route's plain autograd."""
    sc = dataclasses.replace(
        trt.cornell_box(device="cpu"), yaw=torch.tensor(0.11),
        pitch=torch.tensor(0.07))
    cfg = trt.RenderConfig(width=16, height=8, shadow_samples=2, bounces=2)
    names = ("light_pos", "light_color", "tri_v0", "tri_v1", "tri_v2",
             "tri_rgb", "camera_pos", "yaw", "pitch")
    grads = {}
    for route in ("kernel", "torch"):
        leaves = {k: getattr(sc, k).clone().requires_grad_(True)
                  for k in names}
        colors = tfwd.render_flat(dataclasses.replace(sc, **leaves), cfg,
                                  tri_pass=route)
        grads[route] = torch.autograd.grad(colors.square().mean(),
                                           list(leaves.values()))
    for k, a, b in zip(names, grads["kernel"], grads["torch"]):
        assert b.abs().max() > 0, k
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="single device"):
        shade(prepare_scene(sc), cfg, sc.camera_pos[None],
                       sc.camera_pos[None], torch.zeros(1, dtype=torch.int64),
                       record=True, tri_axis=object())


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 127, N_RAYS])
def test_partial_kernels_on_card(cuda_device, problem, n_rays):
    t_in, _, r2, _ = problem
    ins = [x.to(cuda_device) for x in t_in[:6]] + [
        x[:n_rays].to(cuda_device) for x in t_in[6:]]
    r2 = r2[:n_rays].to(cuda_device)
    before = (tpartial.NEAREST_LAUNCHES, tpartial.OCCLUDED_LAUNCHES)
    with torch.no_grad():
        out = tpartial.nearest_tris(*ins)
        occ = tpartial.occluded_tris(*ins[:3], ins[5], *ins[6:], r2)
    torch.cuda.synchronize()
    assert (tpartial.NEAREST_LAUNCHES, tpartial.OCCLUDED_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = tpartial.nearest_tris_plain(*ins)
    assert torch.equal(out[5], ref[5])
    hit = ref[5] >= 0
    assert torch.isinf(out[0][~hit]).all()
    assert (out[0][hit] - ref[0][hit]).abs().max() <= 1e-5 if hit.any() else True
    assert (out[1] - ref[1]).abs().max() <= 1e-5
    for a, b in zip(out[2:5], ref[2:5]):
        assert torch.equal(a, b)
    assert torch.equal(occ, tpartial.occluded_tris_plain(
        *ins[:3], ins[5], *ins[6:], r2))


@pytest.mark.cuda
def test_nearest_tris_backward_on_card(cuda_device, problem):
    t_in, _, _, _ = problem
    rng = np.random.RandomState(13)
    cts = [torch.from_numpy(rng.standard_normal((N_RAYS, 3)).astype(
        np.float32)).to(cuda_device) for _ in range(3)]
    runs = []
    for fn in (tpartial.nearest_tris, tpartial.nearest_tris,
               tpartial.nearest_tris_plain):
        ins = [x.to(cuda_device).requires_grad_(True) for x in t_in]
        out = fn(*ins)
        loss = sum((o * c).sum() for o, c in zip(out[1:4], cts))
        runs.append(torch.autograd.grad(
            loss, [x for i, x in enumerate(ins) if i != 5]))
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)          # two runs: the same bits
        assert ((a - c).abs().max() <= 1e-4 * max(c.abs().max().item(), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_rays,n_tri", [
    ("all_lit", 256, 256),          # every ray scans every row
    ("row0", 257, 390),             # every ray stops at row 0
    ("alternating", 300, 520),      # half the lanes of every warp stop
    ("neighbours", 256, 640),       # a neighbour's occluder is not a ray's own
    ("random", 333, 700),           # n_rays, n_tri off 32 and 128
    ("random", 61, 3),              # fewer rows than a step's group
])
def test_occluded_tris_on_card(cuda_device, kind, n_rays, n_tri):
    """K5 against its plain version on batches that steer its loop:
    whole warps lit, whole warps stopped at once, lanes stopping apart,
    rays whose neighbours stop early on a row that does not occlude them
    (each keeps scanning to its own occluder, past a glass row that casts
    no shadow), ragged ends."""
    ins = [x.to(cuda_device) for x in occlusion_batch(kind, n_rays, n_tri)]
    before = tpartial.OCCLUDED_LAUNCHES
    got = tpartial.occluded_tris(*ins)
    torch.cuda.synchronize()
    assert tpartial.OCCLUDED_LAUNCHES == before + 1
    assert torch.equal(got, tpartial.occluded_tris_plain(*ins))
    want = {"all_lit": 0.0, "row0": 1.0, "alternating": 0.5,
            "neighbours": 1.0}
    if kind in want:
        assert got.float().mean().item() == want[kind]
