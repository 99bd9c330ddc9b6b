"""Port tests: ``uob_raytracer_tpu_torch.ops`` against ``uob_raytracer_tpu.ops``
on the same inputs, made with numpy from a seed. Tolerances: the RNG,
packing and file writers are bit-exact; det3/dot3/cross run the same
float32 op sequence as the JAX package (contraction off on its CPU suite),
so they are exact too, and normalize3 is within one ulp; ray directions
agree within 1e-6 (sin/cos come from two libraries); intersection decisions
agree on >= 99.9% of rays, positions within 1e-5 where they do."""
import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.scene import scene_from_numpy


def _mods(pkg):
    # import_module: the ops packages export functions named like their
    # modules (ops.intersect), which shadow them as attributes
    return [importlib.import_module(f"{pkg}.ops.{m}") for m in
            ("camera", "image", "intersect", "math3", "quads", "rng")]


jcam, jimage, jint, jm3, jquads, jrng = _mods("uob_raytracer_tpu")
tcam, timage, tint, tm3, tquads, trng = _mods("uob_raytracer_tpu_torch")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ICO = os.path.join(os.path.dirname(__file__), os.pardir, "assets", "ico.obj")
N_PIX = 1024 * 1024


def _u32(x):
    return np.asarray(x).astype(np.uint64).astype(np.uint32)


# --------------------------------------------------------------------------
# RNG: bit-exact
# --------------------------------------------------------------------------

def _pixel_ids(seed=0):
    """Pixel ids of a 1024x1024 frame: the first and last rows whole, and a
    seeded sample of the rest."""
    rs = np.random.RandomState(seed)
    return np.unique(np.concatenate([
        np.arange(0, 2048), np.arange(N_PIX - 2048, N_PIX),
        rs.randint(0, N_PIX, 60000)])).astype(np.int64)


def _states(seed=1, n=50000):
    """uint32 states over the whole range, the edges included."""
    rs = np.random.RandomState(seed)
    s = rs.randint(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([s, [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint64)


def test_shadow_seed_bit_exact():
    gid = _pixel_ids()
    j = _u32(jrng.shadow_seed(jnp.asarray(gid.astype(np.uint32))))
    t = _u32(trng.shadow_seed(torch.from_numpy(gid)).numpy())
    assert t.shape == j.shape == (gid.size, 3)
    np.testing.assert_array_equal(t, j)
    assert (j >= 2**31).mean() > 0.4      # the high half is exercised


def test_xorshift_bit_exact():
    s = _states()
    j = jnp.asarray(s.astype(np.uint32))
    t = torch.from_numpy(s.astype(np.int64))
    for _ in range(10):
        j, t = jrng.xorshift(j), trng.xorshift(t)
        np.testing.assert_array_equal(_u32(t.numpy()), _u32(j))


@pytest.mark.parametrize("spread", [0.05, 0.1, 1.0])
def test_crush_bit_exact(spread):
    s = _states(seed=2)
    j = np.asarray(jrng.crush(jnp.asarray(s.astype(np.uint32)), spread))
    t = trng.crush(torch.from_numpy(s.astype(np.int64)), spread).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


# --------------------------------------------------------------------------
# 3-vector helpers and the camera
# --------------------------------------------------------------------------

def test_math3_exact():
    rs = np.random.RandomState(3)
    a, b, c = (rs.normal(0, 3, (4096, 3)).astype(np.float32) for _ in range(3))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    np.testing.assert_array_equal(tm3.det3(ta, tb, tc).numpy(),
                                  np.asarray(jm3.det3(a, b, c)))
    np.testing.assert_array_equal(tm3.dot3(ta, tb).numpy(),
                                  np.asarray(jm3.dot3(a, b)))
    np.testing.assert_array_equal(tm3.cross3(ta, tb).numpy(),
                                  np.asarray(jnp.cross(a, b)))
    # normalize3: within one ulp of a unit component (XLA's CPU divide and
    # torch's round differently on ~0.5% of lanes)
    np.testing.assert_allclose(tm3.normalize3(ta).numpy(),
                               np.asarray(jm3.normalize3(a)), rtol=0, atol=1.2e-7)
    act = rs.rand(4096) > 0.5
    np.testing.assert_allclose(
        tm3.normalize3(ta, torch.from_numpy(act)).numpy(),
        np.asarray(jm3.normalize3(a, act)), rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("kw,yaw,pitch", [
    ({"width": 64, "height": 48}, 0.0, 0.0),
    ({"width": 40, "height": 24, "aa_x": 3, "aa_y": 1}, 0.3, -0.2),
    ({"width": 64, "height": 64, "cpu_ref": True}, -0.1, 0.25),
])
def test_gen_primary_rays(kw, yaw, pitch):
    cfg_t, cfg_j = trt.RenderConfig(**kw), jrt.RenderConfig(**kw)
    R_t = tcam.rotation_matrix(torch.tensor(np.float32(yaw)),
                               torch.tensor(np.float32(pitch)))
    R_j = jcam.rotation_matrix(jnp.float32(yaw), jnp.float32(pitch))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-7)
    d_t, g_t = tcam.gen_primary_rays(cfg_t, torch.tensor(np.float32(yaw)),
                                     torch.tensor(np.float32(pitch)))
    d_j, g_j = jcam.gen_primary_rays(cfg_j, jnp.float32(yaw), jnp.float32(pitch))
    assert d_t.shape == d_j.shape
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j).astype(np.int64))
    # a row band is the same rows of the whole grid
    d_b, g_b = tcam.gen_primary_rays(cfg_t, torch.tensor(np.float32(yaw)),
                                     torch.tensor(np.float32(pitch)), 5, 7)
    assert torch.equal(d_b, d_t[5:12]) and torch.equal(g_b, g_t[5:12])


# --------------------------------------------------------------------------
# Packing and files: exact
# --------------------------------------------------------------------------

def test_pack_argb_and_to_u8_exact():
    rs = np.random.RandomState(4)
    img = rs.uniform(-0.2, 1.2, (64, 48, 3)).astype(np.float32)
    img[0, :3] = [[0, 0, 0], [1, 1, 1], [1 / 255, 254.5 / 255, 0.5]]
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_64_full.npz"))
    for x in (img, golden["image"]):
        t = timage.pack_argb(torch.from_numpy(x))
        assert t.dtype == torch.uint32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jimage.pack_argb(x)))
        np.testing.assert_array_equal(timage.to_u8(torch.from_numpy(x)).numpy(),
                                      np.asarray(jimage.to_u8(x)))
    np.testing.assert_array_equal(
        timage.pack_argb(torch.from_numpy(golden["image"])).numpy(),
        golden["packed"])


def test_save_bmp_byte_golden(tmp_path):
    g = np.load(os.path.join(GOLDEN_DIR, "cornell_64_full.npz"))
    out = tmp_path / "frame.bmp"
    timage.save_bmp(str(out), torch.from_numpy(g["packed"]))
    want = open(os.path.join(GOLDEN_DIR, "cornell_64_full.bmp"), "rb").read()
    assert out.read_bytes() == want


def test_save_ppm_matches(tmp_path):
    g = np.load(os.path.join(GOLDEN_DIR, "cornell_64_full.npz"))
    timage.save_ppm(str(tmp_path / "t.ppm"), torch.from_numpy(g["image"]))
    jimage.save_ppm(str(tmp_path / "j.ppm"), g["image"])
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()


# --------------------------------------------------------------------------
# Intersection and occlusion on 4096 random rays
# --------------------------------------------------------------------------

def _random_rays(seed, n=4096):
    """Starts inside the box, directions over the sphere, light radii."""
    rs = np.random.RandomState(seed)
    start = rs.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rs.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r2 = rs.uniform(0.01, 4.0, n).astype(np.float32)
    return start, d.astype(np.float32), r2


@pytest.mark.parametrize("spheres", [True, False])
def test_intersect_matches(spheres):
    leaves = dataclasses.asdict(jrt.cornell_box(spheres=spheres,
                                                masked_sphere=spheres,
                                                as_numpy=True))
    start, d, _ = _random_rays(5)
    hj = jint.intersect(jint.prepare_scene(jrt.cornell_box(
        spheres=spheres, masked_sphere=spheres)), jnp.asarray(start), jnp.asarray(d))
    ht = tint.intersect(tint.prepare_scene(scene_from_numpy(leaves, "cpu")),
                        torch.from_numpy(start), torch.from_numpy(d))
    same = ht.obj_id.numpy() == np.asarray(hj.obj_id)
    assert same.mean() >= 0.999, f"{1 - same.mean():.4%} of rays differ"
    assert ht.hit.numpy().mean() > 0.7     # the box has no front wall
    for name in ("pos", "normal", "rgb", "mat", "t"):
        a = getattr(ht, name).numpy()[same]
        b = np.asarray(getattr(hj, name))[same]
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("spheres", [True, False])
def test_in_shadow_matches(spheres):
    leaves = dataclasses.asdict(jrt.cornell_box(spheres=spheres,
                                                masked_sphere=spheres,
                                                as_numpy=True))
    start, d, r2 = _random_rays(6)
    oj = np.asarray(jint.in_shadow(
        jint.prepare_scene(jrt.cornell_box(spheres=spheres, masked_sphere=spheres)),
        jnp.asarray(start), jnp.asarray(d), jnp.asarray(r2)))
    ot = tint.in_shadow(tint.prepare_scene(scene_from_numpy(leaves, "cpu")),
                        torch.from_numpy(start), torch.from_numpy(d),
                        torch.from_numpy(r2)).numpy()
    assert 0.1 < oj.mean() < 0.9
    assert (ot == oj).mean() >= 0.999


# --------------------------------------------------------------------------
# Shadow quads (a numpy-only copy)
# --------------------------------------------------------------------------

def test_detect_shadow_quads_same_pairing():
    q_t = tquads.detect_shadow_quads(trt.cornell_box(device="cpu"))
    q_j = jquads.detect_shadow_quads(jrt.cornell_box())
    assert q_t == q_j
    pairs, leftover = q_t
    assert len(pairs) == 11 and len(leftover) == 4
    verts, rgb, mat = trt.load_obj(ICO, mat_code=1.0)
    q_t = tquads.detect_shadow_quads(trt.add_triangles(trt.cornell_box(device="cpu"),
                                                       verts, rgb, mat))
    q_j = jquads.detect_shadow_quads(jrt.add_triangles(jrt.cornell_box(),
                                                       verts, rgb, mat))
    assert q_t == q_j


def test_validate_shadow_quads_rejects_stale():
    sc = trt.cornell_box(device="cpu")
    q = tquads.detect_shadow_quads(sc)
    tquads.validate_shadow_quads(sc, q)          # fresh pairing passes
    tquads.validate_shadow_quads(sc, None)
    moved = dataclasses.replace(sc, tri_v1=sc.tri_v1.clone())
    moved.tri_v1[q[0][0][2]] += 0.1              # move a vertex of a pair
    with pytest.raises(ValueError, match="stale"):
        tquads.validate_shadow_quads(moved, q)
    with pytest.raises(ValueError, match="partition"):
        tquads.validate_shadow_quads(sc, (q[0], q[1][:-1]))
