"""Port tests: the fused render kernel's module
(``uob_raytracer_tpu_torch/kernels/render_fwd.py``) against the JAX
package's. On the CPU the wrapper runs the kernel's plain torch version;
tests marked ``cuda`` launch the CUDA kernel and skip without a card.

Tolerances: the scene tables within atol 1e-6 (sin/cos and the normal's
sqrt come from two libraries); images within ``assert_images_match``
(at most 0.5% of pixels beyond 3e-4, none beyond 0.45), the JAX package's
own budget for its kernel against its jnp pipeline."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import scene as jscene
from uob_raytracer_tpu.kernels import render_fwd as jfwd
from uob_raytracer_tpu.ops.quads import detect_shadow_quads as jdetect
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops.image import pack_argb
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads as tdetect
from uob_raytracer_tpu_torch.scene import scene_from_numpy
from conftest import assert_images_match


def _scenes(kind):
    """(torch scene, JAX scene) from the same numpy leaves: the Cornell box,
    or the Cornell box with seeded noise on every leaf."""
    leaves = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jrt.cornell_box(as_numpy=True)).items()}
    if kind == "perturbed":
        rs = np.random.RandomState(7)
        leaves = {k: (v + rs.normal(0, 0.02, v.shape)).astype(np.float32)
                  for k, v in leaves.items()}
    return (scene_from_numpy(leaves, "cpu"),
            jscene.Scene(**{k: jnp.asarray(v) for k, v in leaves.items()}))


@pytest.mark.parametrize("kind", ["cornell", "perturbed"])
def test_pack_scene_matches(kind):
    tsc, jsc = _scenes(kind)
    for name, a, b in zip(("tri", "sph", "cam"), tfwd.pack_scene(tsc),
                          jfwd.pack_scene(jsc)):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0, err_msg=name)
    assert tfwd.pack_scene(tsc)[2].shape == (tfwd.CAM_COLS,)


def test_pack_scene_no_spheres():
    sph = tfwd.pack_scene(trt.cornell_box(spheres=False, device="cpu"))[1]
    assert sph.shape == (1, tfwd.SPH_COLS) and not sph.any()


@pytest.mark.parametrize("kind", ["cornell", "perturbed"])
def test_pack_shadow_matches(kind):
    tsc, jsc = _scenes(kind)
    quads = tdetect(trt.cornell_box(device="cpu"))       # the unperturbed pairing
    a = tfwd.pack_shadow(tsc, quads)
    b = np.asarray(jfwd.pack_shadow(jsc, quads))
    assert tuple(a.shape) == b.shape == (26 - len(quads[0]), tfwd.SHD_COLS)
    np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"cpu_ref": True}])
def test_plain_matches_pallas_interpret(kw):
    """The port's plain K1 path against the JAX kernel itself, run in
    Pallas interpret mode with the quad-merged occlusion scan."""
    cfg_t = trt.RenderConfig(width=128, height=16, **kw)
    cfg_j = jrt.RenderConfig(width=128, height=16, **kw)
    jsc = jrt.cornell_box()
    img_j, packed_j = jfwd.render_fused_raw(jsc, cfg_j, interpret=True,
                                            quads=jdetect(jsc))
    img_t = trt.render_image(trt.cornell_box(device="cpu"), cfg_t, backend="torch")
    assert img_t.shape == (16, 128, 3)
    assert_images_match(img_t.numpy(), np.asarray(img_j),
                        what=f"torch plain vs pallas interpret {kw}")
    assert_images_match(_rgb(pack_argb(img_t).numpy()), _rgb(packed_j),
                        what="packed")


def _rgb(packed):
    """uint32 ARGB [H, W] -> float channels in [0, 1] [H, W, 3]."""
    p = np.ascontiguousarray(np.asarray(packed, dtype="<u4"))
    return p.view(np.uint8).reshape(*p.shape, 4)[..., :3] / np.float32(255)


def test_render_fused_raw_cpu_runs_plain_version():
    """A CPU scene takes the plain version: no launch, packed ==
    pack_argb(image), the same frame as render_fused_plain."""
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=16, shadow_samples=3, bounces=2)
    before = tfwd.LAUNCHES
    img, packed = tfwd.render_fused_raw(sc, cfg, quads=tdetect(sc))
    assert tfwd.LAUNCHES == before
    assert img.shape == (16, 32, 3) and packed.dtype == torch.uint32
    assert torch.equal(packed.view(torch.int32), pack_argb(img).view(torch.int32))
    plain_img, plain_packed = tfwd.render_fused_plain(sc, cfg)
    assert torch.equal(img, plain_img)
    assert torch.equal(packed.view(torch.int32), plain_packed.view(torch.int32))
    assert torch.equal(img, trt.render_image(sc, cfg, backend="torch"))


def test_row_band_equals_full_frame_rows():
    """The plain version's row band is the same rows of its full frame
    (ray centering and the pixel-id RNG stay global); the wrapper rejects
    a band outside the image."""
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=48, height=32, shadow_samples=4, bounces=3)
    full, full_p = tfwd.render_fused_plain(sc, cfg)
    band, band_p = tfwd.render_fused_plain(sc, cfg, row0=8, rows=12)
    assert band.shape == (12, 48, 3)
    assert torch.equal(band, full[8:20])
    assert torch.equal(band_p.view(torch.int32), full_p[8:20].view(torch.int32))
    with pytest.raises(ValueError, match="outside"):
        tfwd.render_fused_raw(sc, cfg, row0=30, rows=4)


def test_launch_params_and_budget():
    """The launcher's constants are the JAX kernel's float32 constants; the
    Cornell tables fit one block's shared memory."""
    cfg = trt.RenderConfig(width=96, height=20, aa_x=3)
    ints, floats = tfwd.launch_params(cfg, 4, 8, 26, 2, 11, 15)
    assert list(ints) == [96, 20, 4, 8, 3, 2, 10, 10, 26, 2, 11, 15, 0, 0, 0]
    want = [np.float32(96 * 3 / 2.0), np.float32(20 * 2 / 2.0),
            np.float32(cfg.effective_focal), np.float32(0.05),
            np.float32(1e-4), np.float32(1e-4), np.float32(1.52),
            np.float32(1.0), np.float32(1 / 6), np.float32(4 * np.pi)]
    assert [np.float32(f) for f in floats] == want
    ref = tfwd.launch_params(trt.RenderConfig(cpu_ref=True), 0, 1, 26, 0, 0, 0)
    assert np.float32(ref[1][4]) == np.float32(1e-3)   # the CPU path's bias
    assert tfwd.shared_bytes(26, 2, 15) < 48 * 1024
    assert tfwd.shared_bytes(512, 2, 512) < tfwd.SMEM_BUDGET_BYTES


def test_render_fused_raw_rejects_other_devices():
    sc = trt.cornell_box(device="cpu").to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfwd.render_fused_raw(sc, trt.RenderConfig(width=8, height=8))


# --------------------------------------------------------------------------
# On the card (skip without one): the CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"cpu_ref": True}, {"fresnel": True,
                                                        "bounces": 4}])
def test_kernel_matches_plain_on_card(cuda_device, kw):
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, **kw)
    before = tfwd.LAUNCHES
    img, packed = tfwd.render_fused_raw(sc, cfg, quads=tdetect(sc))
    torch.cuda.synchronize()
    assert tfwd.LAUNCHES == before + 1
    ref = trt.render_image(sc, cfg, backend="torch")
    assert_images_match(img.cpu().numpy(), ref.cpu().numpy(), what=str(kw))
    assert torch.equal(packed.view(torch.int32), pack_argb(img).view(torch.int32))


@pytest.mark.cuda
def test_kernel_row_band_on_card(cuda_device):
    """The kernel's row band: bit for bit the same rows of its own full
    frame (row0 enters the pixel id and the ray offset), and within the
    image budget of the plain version's band."""
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20)
    quads = tdetect(sc)
    full, full_p = tfwd.render_fused_raw(sc, cfg, quads=quads)
    band, band_p = tfwd.render_fused_raw(sc, cfg, row0=7, rows=9, quads=quads)
    torch.cuda.synchronize()
    assert band.shape == (9, 96, 3)
    assert torch.equal(band, full[7:16])
    assert torch.equal(band_p.view(torch.int32), full_p[7:16].view(torch.int32))
    ref = tfwd.render_fused_plain(sc, cfg, row0=7, rows=9)[0]
    assert_images_match(band.cpu().numpy(), ref.cpu().numpy(), what="band")


@pytest.mark.cuda
def test_kernel_rejects_scenes_beyond_its_tables(cuda_device):
    """A scene beyond the whole-table kernel's tables no longer raises: it
    routes to the streamed kernel and renders the plain version's frame.
    Only a pinned whole-table kernel refuses tables that do not fit."""
    rs = np.random.RandomState(0)
    verts = rs.uniform(-0.9, 0.9, (600, 3, 3)).astype(np.float32)
    big = trt.add_triangles(trt.cornell_box(device=cuda_device), verts,
                            np.full((600, 3), 0.5, np.float32),
                            np.ones(600, np.float32))
    cfg = trt.RenderConfig(width=16, height=8)
    assert tfwd.use_streamed(big.num_triangles, big.num_spheres)
    before = (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES)
    img, packed = tfwd.render_fused_raw(big, cfg)
    torch.cuda.synchronize()
    assert (tfwd.LAUNCHES, tfwd.STREAMED_LAUNCHES) == (before[0], before[1] + 1)
    ref = tfwd.render_fused_plain(big, cfg)[0]
    assert_images_match(img.cpu().numpy(), ref.cpu().numpy(), what="626")
    assert torch.equal(packed.view(torch.int32), pack_argb(img).view(torch.int32))
    huge = trt.add_triangles(big, np.tile(verts, (4, 1, 1)),
                             np.full((2400, 3), 0.5, np.float32),
                             np.ones(2400, np.float32))
    with pytest.raises(ValueError, match="shared memory"):
        tfwd.render_fused_raw(huge, cfg, _kernel="whole")
