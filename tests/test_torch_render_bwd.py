"""Port tests: the path-replay backward module
(``uob_raytracer_tpu_torch/kernels/render_bwd.py``) and the differentiable
``render_image`` (``render.py``'s ``torch.autograd.Function``) against the
JAX package's, on the CPU, where the wrappers run the kernels' plain
versions. Tests marked ``cuda`` launch the CUDA kernels and skip without a
card.

Tolerances: the K2 module leaf by leaf as max|a-b| / max(max|ref|, 1)
within 1e-4 of the JAX kernel in interpret mode (tests/test_bwd_kernel.py);
end-to-end gradients within 2e-3 of max|ref| per leaf
(tests/test_replay.py:52-75: the replay's gradient against full autodiff).
"""
import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.kernels.render_bwd import render_replay_bwd as j_replay_bwd
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res as j_fused_res
from uob_raytracer_tpu.render import render_image as j_render_image
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import cli, flops
from uob_raytracer_tpu_torch.kernels import render_bwd as tbwd
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops.intersect import _sphere_roots, prepare_scene
from uob_raytracer_tpu_torch.ops import replay as treplay
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
from uob_raytracer_tpu_torch.scene import Scene

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
LEAVES = tuple(f.name for f in dataclasses.fields(Scene))


def _grad_scene(scene, names=LEAVES):
    """The scene with fresh leaves that require a gradient."""
    return dataclasses.replace(scene, **{
        k: getattr(scene, k).detach().clone().requires_grad_(True)
        for k in names})


def _grads(loss, scene, names=LEAVES):
    return dict(zip(names, torch.autograd.grad(
        loss, [getattr(scene, k) for k in names], allow_unused=True)))


# --------------------------------------------------------------------------
# The K2 module
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bounces", [0, 1])
def test_plain_backward_matches_jax_kernel(bounces):
    """render_replay_bwd_plain against the JAX backward kernel (Pallas
    interpret mode) on the JAX forward kernel's record."""
    kw = dict(width=128, height=8, aa_x=2, aa_y=2, shadow_samples=4,
              bounces=bounces)
    jsc, cfg_j = jrt.cornell_box(), jrt.RenderConfig(**kw)
    img, _, jres = j_fused_res(jsc, cfg_j, interpret=True)
    g = np.random.RandomState(bounces).standard_normal(img.shape).astype(np.float32)
    ref = j_replay_bwd(jsc, cfg_j, jres, jnp.asarray(g), interpret=True)
    tsc, cfg_t = trt.cornell_box(device="cpu"), trt.RenderConfig(**kw)
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    got, primal = tbwd.render_replay_bwd_plain(tsc, cfg_t, res,
                                               torch.from_numpy(g),
                                               return_primal=True)
    for k in LEAVES:
        a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1.0), k
    assert torch.allclose(primal, treplay.replay_forward(tsc, cfg_t, res),
                          atol=1e-4)
    np.testing.assert_allclose(primal.numpy(), np.asarray(img), atol=2e-5)


# The mirror box: the Cornell box with its five walls (floor, left, right,
# ceiling, back: triangles 0-9) mirrored, the blocks and spheres as they
# are, seen from a camera inside the box at (0, -0.3, 0) that looks along
# the x axis (yaw pi/2) through a 2x zoom (focal_length 4400). Rays bounce
# between the side walls, and rows [46, 54) of the 128x128 frame hold
# chains that end on a block after more than 16 bounce steps.
MIRROR_WALLS = slice(0, 10)
DEEP_KW = dict(width=128, height=128, aa_x=1, aa_y=1, shadow_samples=2,
               focal_length=4400.0)
DEEP_BAND = (46, 8)
MIRROR_CAMERA = (0.0, -0.3, 0.0)


def mirror_box(scene):
    """The mirror box of either package's Cornell box."""
    if isinstance(scene, trt.Scene):
        mat = scene.tri_mat.clone()
        mat[MIRROR_WALLS] = trt.scene.MAT_MIRROR
        return dataclasses.replace(
            scene, tri_mat=mat, camera_pos=torch.tensor(
                MIRROR_CAMERA, device=mat.device),
            yaw=torch.tensor(np.pi / 2, dtype=torch.float32,
                             device=mat.device))
    mat = np.asarray(scene.tri_mat).copy()
    mat[MIRROR_WALLS] = jrt.scene.MAT_MIRROR
    return dataclasses.replace(
        scene, tri_mat=jnp.asarray(mat),
        camera_pos=jnp.asarray(MIRROR_CAMERA, jnp.float32),
        yaw=jnp.float32(np.pi / 2))


def test_plain_backward_matches_jax_kernel_past_16_bounces():
    """render_replay_bwd_plain at 20 bounces against the JAX backward kernel
    (interpret mode) on the JAX forward kernel's record of the mirror box's
    band, whose chains run past the kernel's in-register depth."""
    jsc, cfg_j = mirror_box(jrt.cornell_box()), jrt.RenderConfig(
        bounces=20, **DEEP_KW)
    row0, rows = DEEP_BAND
    img, _, jres = j_fused_res(jsc, cfg_j, interpret=True, row0=row0,
                               rows=rows)
    deep = np.asarray(jres.bounce_id)[tbwd.REG_BOUNCES:]
    # chains past the in-register depth that end on a (diffuse) block
    assert ((deep >= 10) & (deep < 26)).any()
    g = np.random.RandomState(20).standard_normal(img.shape).astype(np.float32)
    ref = j_replay_bwd(jsc, cfg_j, jres, jnp.asarray(g), row0=row0,
                       rows=rows, interpret=True)
    tsc = mirror_box(trt.cornell_box(device="cpu"))
    res = treplay.residuals_from_numpy(*(np.asarray(x) for x in jres), "cpu")
    got = tbwd.render_replay_bwd_plain(tsc, trt.RenderConfig(
        bounces=20, **DEEP_KW), res, torch.from_numpy(g), row0, rows)
    for k in LEAVES:
        a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1.0), k


def test_wrapper_on_cpu_runs_plain_version():
    """A CPU scene takes the plain version: no launch, the same gradient;
    other devices are refused."""
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=8, shadow_samples=2, bounces=2)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.ones((8, 32, 3))
    before = tbwd.LAUNCHES
    got = tbwd.render_replay_bwd(sc, cfg, res, g)
    assert tbwd.LAUNCHES == before
    ref = tbwd.render_replay_bwd_plain(sc, cfg, res, g)
    assert all(torch.equal(getattr(got, k), getattr(ref, k)) for k in LEAVES)
    assert not got.tri_mat.any() and not got.sph_mat.any()
    assert got.tri_v0.abs().max() > 0 and got.light_pos.abs().max() > 0
    with pytest.raises(ValueError, match="CUDA"):
        tbwd.render_replay_bwd(sc.to("meta"), cfg, res, g)
    with pytest.raises(ValueError, match="outside"):
        tbwd.render_replay_bwd(sc, cfg, res, g, row0=4, rows=8)


def test_table_cotangents_layout():
    """The kernel's partial sums land in pack_scene's columns: object rows
    of 16 (v0 e1 e2 n rgb | r2), then the 21 camera columns."""
    n_tri, n_sph = 3, 2
    cols = (n_tri + n_sph) * tbwd.GRAD_COLS + tfwd.CAM_COLS
    partial = torch.arange(2 * cols, dtype=torch.float32).reshape(2, cols)
    sums = partial.sum(0)
    dtri, dsph, dcam = tbwd.table_cotangents(partial, n_tri, n_sph, n_sph)
    assert dtri.shape == (n_tri, tfwd.TRI_COLS) and dsph.shape == (n_sph, tfwd.SPH_COLS)
    assert torch.equal(dtri[1, :15], sums[16:31]) and not dtri[:, 15:].any()
    s0 = sums[n_tri * 16:n_tri * 16 + 16]
    assert torch.equal(dsph[0, 0:3], s0[0:3]) and dsph[0, 3] == s0[15]
    assert torch.equal(dsph[0, 4:7], s0[12:15]) and not dsph[:, 7:].any()
    assert torch.equal(dcam, sums[-21:])
    # no spheres: pack_scene's one zero row gets a zero cotangent
    cols = n_tri * tbwd.GRAD_COLS + tfwd.CAM_COLS
    _, dsph, _ = tbwd.table_cotangents(torch.ones((4, cols)), n_tri, 0, 1)
    assert dsph.shape == (1, tfwd.SPH_COLS) and not dsph.any()


def test_launch_params_and_budget():
    cfg = trt.RenderConfig(width=96, height=20, aa_x=3, fresnel=True)
    ints, floats = tbwd.launch_params(cfg, 4, 8, 26, 2, True)
    assert list(ints) == [96, 20, 4, 8, 3, 2, 10, 10, 26, 2, 0, 1, 0, 1]
    assert [np.float32(f) for f in floats] == [
        np.float32(96 * 3 / 2.0), np.float32(20 * 2 / 2.0),
        np.float32(cfg.effective_focal), np.float32(1e-4), np.float32(1.52),
        np.float32(1.0), np.float32(4 * np.pi)]
    assert tbwd.shared_bytes(28) < 48 * 1024
    assert cfg.bounces <= tbwd.REG_BOUNCES


# --------------------------------------------------------------------------
# End to end: render_image through the autograd Function
# --------------------------------------------------------------------------

CFG_KW = dict(width=128, height=16, shadow_samples=4, bounces=4)


@pytest.fixture(scope="module")
def fused_grads():
    """Gradients of mean(render_image) through the Function on a CPU scene."""
    sc = _grad_scene(trt.cornell_box(device="cpu"))
    loss = trt.render_image(sc, trt.RenderConfig(**CFG_KW)).mean()
    return _grads(loss, sc)


def test_function_gradients_match_jax_pallas_backend(fused_grads):
    cfg_j = jrt.RenderConfig(**CFG_KW)
    ref = jax.grad(lambda s: jnp.mean(j_render_image(s, cfg_j, backend="pallas")))(
        jrt.cornell_box())
    for k in LEAVES:
        a, b = np.asarray(getattr(ref, k)), fused_grads[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.abs(a - b).max() <= 2e-3 * (np.abs(a).max() + 1e-12), k


def test_function_gradients_match_torch_backend(fused_grads):
    """The third witness: plain autograd through the full pipeline."""
    sc = _grad_scene(trt.cornell_box(device="cpu"))
    loss = trt.render_image(sc, trt.RenderConfig(**CFG_KW), backend="torch").mean()
    ref = _grads(loss, sc)
    for k in LEAVES:
        if ref[k] is None:     # the pipeline never reads the material codes
            assert k in ("tri_mat", "sph_mat") and not fused_grads[k].any()
            continue
        a, b = ref[k].numpy(), fused_grads[k].numpy()
        assert np.abs(a - b).max() <= 2e-3 * (np.abs(a).max() + 1e-12), k


def test_function_gradients_are_zero_for_material_codes(fused_grads):
    for k in ("tri_mat", "sph_mat"):
        assert fused_grads[k] is not None and not fused_grads[k].any()
    # a vertex gradient flows through the recomputed normals
    # (tests/test_grad.py:177)
    assert fused_grads["tri_v0"].abs().max() > 1e-6
    assert fused_grads["tri_v1"].abs().max() > 1e-6
    assert fused_grads["light_pos"].abs().max() > 0


@pytest.mark.parametrize("kw", [dict(bounces=3, quirk_nan_tir=True),
                                dict(bounces=4, fresnel=True),
                                dict(cpu_ref=True)])
def test_function_gradients_finite(kw):
    sc = _grad_scene(trt.cornell_box(device="cpu"))
    cfg = trt.RenderConfig(width=16, height=16, shadow_samples=2, **kw)
    for backend in ("auto", "torch"):
        g = _grads(trt.render_image(sc, cfg, backend=backend).mean(), sc)
        assert all(torch.isfinite(v).all() for v in g.values() if v is not None)


def test_tangent_ray_sphere_grads_finite():
    """Exact-tangent sphere hits (disc == 0) must not leak sqrt'(0) = inf
    into the sphere-quadratic gradients (tests/test_grad.py:149)."""
    sc = trt.cornell_box(device="cpu")
    r2 = torch.tensor([1.0], requires_grad=True)
    sc = dataclasses.replace(
        sc, sph_center=torch.tensor([[1.0, 0.0, 0.0]]), sph_r2=r2,
        sph_rgb=torch.ones((1, 3)), sph_mat=torch.ones((1,)))
    # start=(0,0,-2), d=(0,0,1), center=(1,0,0), r2=1: disc = 16-16 = 0
    start = torch.tensor([[0.0, 0.0, -2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    xmin, xmax, no_sol = _sphere_roots(prepare_scene(sc), start, d)
    v = torch.where(no_sol, 0.0, xmin).sum()
    (g,) = torch.autograd.grad(v, r2)
    assert torch.isfinite(v) and torch.isfinite(g).all()
    # and through the replay's hit reconstruction
    table = treplay.build_object_table(sc)
    ids = torch.tensor([sc.num_triangles], dtype=torch.int32)
    pos, *_ = treplay._hit_from_row(treplay._gather_rows(table, ids),
                                    sc.num_triangles, ids, start, d)
    (g,) = torch.autograd.grad(pos.sum(), r2)
    assert torch.isfinite(g).all()


def test_function_mechanics(monkeypatch):
    """No record without a gradient; packed is not differentiable; a row
    band and a subset of leaves work; quads enter the forward only."""
    trender = sys.modules["uob_raytracer_tpu_torch.render"]   # not the function
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=16, shadow_samples=2, bounces=2)
    calls = []
    real = trender.render_fused_res_plain
    monkeypatch.setattr(trender, "render_fused_res_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = trt.render(sc, cfg)
    assert not calls and not out.image.requires_grad
    live = _grad_scene(sc, ("light_pos", "tri_rgb"))
    with torch.no_grad():
        trt.render(live, cfg)
    assert not calls
    out = trt.render(live, cfg, shadow_quads=detect_shadow_quads(sc))
    assert calls == [1] and out.image.requires_grad
    assert not out.packed.requires_grad
    assert torch.equal(out.image.detach(), trt.render(sc, cfg).image)
    g = _grads(out.image.square().mean(), live, ("light_pos", "tri_rgb"))
    assert g["light_pos"].shape == (3,) and g["tri_rgb"].abs().max() > 0
    # a row band's gradient is the full frame's with the other rows' zeroed
    band = trt.render_image(live, cfg, row0=4, rows=8)
    assert band.shape == (8, 32, 3)
    assert torch.equal(band.detach(), out.image.detach()[4:12])
    gb = _grads(band.sum(), live, ("light_pos",))["light_pos"]
    gf = _grads(trt.render_image(live, cfg)[4:12].sum(), live,
                ("light_pos",))["light_pos"]
    assert torch.allclose(gb, gf, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# The default device, and the import rule
# --------------------------------------------------------------------------

def test_default_device_is_cuda(tmp_path):
    """cornell_box(), scene_from_numpy(...) and load_scene(...) with no
    device ask for a CUDA device: without one they raise torch's own error,
    which names CUDA; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        assert trt.cornell_box().device.type == "cuda"
        return
    from uob_raytracer_tpu_torch import scene as tscene
    leaves = tscene.scene_to_numpy(trt.cornell_box(device="cpu"))
    path = str(tmp_path / "s.npz")
    tscene.save_scene(path, trt.cornell_box(device="cpu"))
    for make in (trt.cornell_box, lambda: tscene.scene_from_numpy(leaves),
                 lambda: tscene.load_scene(path)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()
    assert tscene.load_scene(path, "cpu").device.type == "cpu"


def test_cli_without_device_cpu_does_not_render_on_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("with a card the CLI renders on it")
    out = tmp_path / "f.bmp"
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        cli.main(["render", "--width", "8", "-o", str(out)])
    assert not out.exists() and "Rendertime" not in capsys.readouterr().out
    cli.main(["render", "--width", "8", "--device", "cpu", "-o", str(out)])
    assert out.exists() and "(cpu)" in capsys.readouterr().out


def test_port_imports_no_jax():
    """No module of the port, and neither chip_smoke.py, chip_timing.py
    nor parity_torch.py, imports jax or the JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_timing.py"),
             os.path.join(ROOT, "parity_torch.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "uob_raytracer_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|optax|uob_raytracer_tpu)(\.|\s|$)",
                     re.M)
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


# --------------------------------------------------------------------------
# On the card (skip without one): the CUDA kernels against their plain versions
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
@pytest.mark.parametrize("kw", [{}, {"cpu_ref": True},
                                {"fresnel": True, "bounces": 4}])
def test_kernel_record_matches_plain_on_card(cuda_device, kw):
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, **kw)
    before = tfwd.LAUNCHES
    img, packed, res = tfwd.render_fused_res(sc, cfg)
    raw, _ = tfwd.render_fused_raw(sc, cfg)
    torch.cuda.synchronize()
    assert tfwd.LAUNCHES == before + 2
    assert torch.equal(img, raw)           # recording changes nothing
    ref = tfwd.render_fused_res_plain(sc, cfg)[2]
    for a, b in zip(res, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.numel():
            assert (a != b).float().mean() <= 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"bounces": 0}, {"bounces": 1},
                                {"cpu_ref": True}])
def test_backward_kernel_matches_plain_on_card(cuda_device, kw):
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, **kw)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (20, 96, 3)).astype(np.float32)).to(cuda_device)
    before = tbwd.LAUNCHES
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again = tbwd.render_replay_bwd(sc, cfg, res, g)
    torch.cuda.synchronize()
    assert tbwd.LAUNCHES == before + 2
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g,
                                                   return_primal=True)
    assert _leafwise(ref, got) <= 1e-4
    assert torch.allclose(primal, ref_primal, atol=1e-4)
    # no float atomics: two runs give bit-equal gradients
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    # a row band of the record gives that band's gradient
    band = treplay.Residuals(*(t[..., 4:12, :].contiguous() for t in res))
    got_b = tbwd.render_replay_bwd(sc, cfg, band, g[4:12].contiguous(),
                                   row0=4, rows=8)
    ref_b = tbwd.render_replay_bwd_plain(sc, cfg, band, g[4:12], 4, 8)
    assert _leafwise(ref_b, got_b) <= 1e-4


@pytest.mark.cuda
def test_function_on_card_launches_both_kernels(cuda_device):
    sc = _grad_scene(trt.cornell_box(device=cuda_device))
    cfg = trt.RenderConfig(width=96, height=20, bounces=1)
    f0, b0 = tfwd.LAUNCHES, tbwd.LAUNCHES
    got = _grads(trt.render_image(sc, cfg).mean(), sc)
    assert (tfwd.LAUNCHES, tbwd.LAUNCHES) == (f0 + 1, b0 + 1)
    ref = _grads(trt.render_image(sc, cfg, backend="torch").mean(), sc)
    for k in LEAVES:
        if ref[k] is None:
            assert not got[k].any()
            continue
        assert ((ref[k] - got[k]).abs().max()
                <= 2e-3 * (ref[k].abs().max() + 1e-12)), k
    # past the in-register depth the deep instance runs: the same gradient
    deep = trt.RenderConfig(width=16, height=8, bounces=tbwd.REG_BOUNCES + 1)
    got = _grads(trt.render_image(sc, deep).mean(), sc)
    assert tbwd.LAUNCHES == b0 + 2
    ref = _grads(trt.render_image(sc, deep, backend="torch").mean(), sc)
    for k in LEAVES:
        if ref[k] is None:
            assert not got[k].any()
            continue
        assert ((ref[k] - got[k]).abs().max()
                <= 2e-3 * (ref[k].abs().max() + 1e-12)), k


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [17, 20, 32])
def test_deep_backward_kernel_on_card(cuda_device, bounces):
    """The whole-table kernel past its in-register depth (the deep
    instance, its chain in a device buffer) on the mirror box's band,
    against the plain version; two runs bit-equal."""
    sc = mirror_box(trt.cornell_box(device=cuda_device))
    cfg = trt.RenderConfig(bounces=bounces, **DEEP_KW)
    row0, rows = DEEP_BAND
    _, _, res = tfwd.render_fused_res(sc, cfg, row0, rows)
    assert (res.bounce_id[tbwd.REG_BOUNCES:] >= 0).any()
    g = torch.from_numpy(np.random.RandomState(bounces).standard_normal(
        (rows, cfg.width, 3)).astype(np.float32)).to(cuda_device)
    before = tbwd.LAUNCHES
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, row0, rows,
                                         return_primal=True)
    again = tbwd.render_replay_bwd(sc, cfg, res, g, row0, rows)
    torch.cuda.synchronize()
    assert tbwd.LAUNCHES == before + 2
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g, row0,
                                                   rows, return_primal=True)
    assert _leafwise(ref, got) <= 1e-4
    assert torch.allclose(primal, ref_primal, atol=1e-4)
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)


@pytest.mark.cuda
def test_backward_in_row_bands_on_card(cuda_device, monkeypatch):
    """Past MAX_PARTIAL_BYTES the whole-table backward takes the frame in
    row bands, one launch each: the same gradient within 1e-5, the same
    replayed radiance bit for bit, and two banded runs bit-equal."""
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=3, bounces=2)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (20, 96, 3)).astype(np.float32)).to(cuda_device)
    one, p_one = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    cols = (sc.num_triangles + sc.num_spheres) * 16 + 21
    # 4 rows: 12 blocks of pixels_per_block(4) = 32 pixels
    monkeypatch.setattr(tbwd, "MAX_PARTIAL_BYTES", 4 * 12 * cols)
    before = tbwd.LAUNCHES
    two, p_two = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    three = tbwd.render_replay_bwd(sc, cfg, res, g)
    torch.cuda.synchronize()
    assert tbwd.LAUNCHES == before + 10
    assert _leafwise(one, two) <= 1e-5
    assert torch.equal(p_one, p_two)
    assert all(torch.equal(getattr(two, k), getattr(three, k)) for k in LEAVES)


def _away_from_glass(sc, res, g):
    """g with zeros on the pixels where a ray's path meets a glass object
    (material -1) at its primary hit or a bounce step: the double
    refraction's derivative there is held to 1e-3, the rest to 1e-5."""
    mat = torch.cat([sc.tri_mat, sc.sph_mat])

    def glass(ids):
        return (ids >= 0) & (mat[ids.clamp(min=0).long()] == -1.0)

    hit = glass(res.prim_id).any(dim=0)
    if res.bounce_id.numel():
        hit = hit | glass(res.bounce_id).any(dim=(0, 1))
    return torch.where(hit[..., None], 0.0, g)


@pytest.mark.parametrize("n_obj,kw,rows,want", [
    (28, {}, 1024, True),                       # full_1024: 4.2 M rays
    (28, {}, 64, False),                        # 64 of its rows: 262,144
    (28, {"aa_x": 1, "aa_y": 1}, 1024, True),   # 1,048,576 rays
    (28, {"aa_x": 1, "aa_y": 1}, 1023, False),
    (28, {"bounces": 0}, 1024, False),          # no chain anywhere
    (33, {}, 1024, False),                      # past 32 objects
])
def test_split_rule(n_obj, kw, rows, want):
    """Which frames the whole-table backward splits into its chain-free
    and chain launches (``render_bwd.splits``)."""
    assert tbwd.splits(trt.RenderConfig(**kw), rows, n_obj) == want


def _split_checks(sc, cfg, monkeypatch, seed, split=True):
    """The whole-table backward as the card runs it: two runs bit-equal;
    the replayed image bit-equal to one launch of the chain kernel over
    every pixel (the design before the split) and its gradients within
    1e-5; within 1e-5 of the plain version away from the glass interior
    and 1e-3 with it. Returns the record."""
    # these frames are small: split them all the same
    monkeypatch.setattr(tbwd, "SPLIT_RAYS", 0)
    _, _, res = tfwd.render_fused_res(sc, cfg)
    g = torch.from_numpy(np.random.RandomState(seed).standard_normal(
        (cfg.height, cfg.width, 3)).astype(np.float32)).to(sc.device)
    before = (tbwd.LAUNCHES, tbwd.FREE_LAUNCHES)
    got, primal = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    again = tbwd.render_replay_bwd(sc, cfg, res, g)
    torch.cuda.synchronize()
    split = split and cfg.bounces > 0
    assert (tbwd.LAUNCHES, tbwd.FREE_LAUNCHES) == (
        before[0] + 2, before[1] + (2 if split else 0))
    assert all(torch.equal(getattr(got, k), getattr(again, k)) for k in LEAVES)
    with monkeypatch.context() as m:
        m.setattr(tbwd, "SPLIT_OBJECTS", 0)
        one, p_one = tbwd.render_replay_bwd(sc, cfg, res, g, return_primal=True)
    assert torch.equal(primal, p_one)
    assert _leafwise(one, got) <= 1e-5
    ref, ref_primal = tbwd.render_replay_bwd_plain(sc, cfg, res, g,
                                                   return_primal=True)
    assert _leafwise(ref, got) <= 1e-3
    assert torch.allclose(primal, ref_primal, atol=1e-4)
    g0 = _away_from_glass(sc, res, g)
    assert _leafwise(tbwd.render_replay_bwd_plain(sc, cfg, res, g0),
                     tbwd.render_replay_bwd(sc, cfg, res, g0)) <= 1e-5
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 2, 10, tbwd.REG_BOUNCES + 1])
def test_split_backward_on_card(cuda_device, monkeypatch, bounces):
    """The chain-free launch and the chain launch on a 60x20 frame (a
    ragged last block; past 16 bounces the deep instance): with bounces,
    pixels whose AA rays mix chain and chain-free rays go whole to the
    chain launch."""
    sc = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=60, height=20, bounces=bounces)
    res = _split_checks(sc, cfg, monkeypatch, seed=bounces)
    chain = flops.chain_rays(sc, cfg, res).reshape(cfg.aa_rays, -1)
    mixed = int((chain.any(dim=0) & ~chain.all(dim=0)).sum())
    assert (mixed > 0) == (bounces > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["no chain", "every ray a chain"])
def test_split_backward_extremes_on_card(cuda_device, monkeypatch, frame):
    """No ray with a chain (no spheres: the chain launch finds an empty
    list), and every ray with one (the mirror box with every object a
    mirror: the chain-free launch runs no ray)."""
    if frame == "no chain":
        sc = trt.cornell_box(spheres=False, device=cuda_device)
        cfg = trt.RenderConfig(width=64, height=16, bounces=10)
        want = 0.0
    else:
        sc = mirror_box(trt.cornell_box(device=cuda_device))
        sc = dataclasses.replace(sc, tri_mat=torch.zeros_like(sc.tri_mat),
                                 sph_mat=torch.zeros_like(sc.sph_mat))
        cfg = trt.RenderConfig(bounces=6, **dict(DEEP_KW, height=24))
        want = 1.0
    res = _split_checks(sc, cfg, monkeypatch, seed=3)
    assert flops.chain_share(sc, cfg, res)["rays"] == want


def strip_scene(device, n_strips: int = 137, width: float = 0.02):
    """The Cornell box and 274 triangles (300 in all): 137 narrow vertical
    strips across the view at z = -1.5, each a pair of triangles, so that
    the 32 pixels of a warp's row meet 32 distinct objects at their
    primary site (the dense scene of 300 triangles meets at most 12)."""
    x0 = -n_strips * width / 2 + np.arange(n_strips) * width
    lo, hi = np.full(n_strips, -1.5), np.full(n_strips, 1.5)
    z = np.full(n_strips, -1.5)
    a, b = np.stack([x0, lo, z], 1), np.stack([x0 + width, lo, z], 1)
    c, d = np.stack([x0, hi, z], 1), np.stack([x0 + width, hi, z], 1)
    v = np.concatenate([np.stack([a, b, c], 1),
                        np.stack([b, d, c], 1)]).astype(np.float32)
    rgb = np.random.RandomState(3).uniform(0.2, 0.9, (len(v), 3)).astype(
        np.float32)
    return trt.add_triangles(trt.cornell_box(device=device), v, rgb,
                             np.ones(len(v), np.float32))


@pytest.mark.cuda
def test_backward_many_objects_a_warp_on_card(cuda_device, monkeypatch):
    """302 objects (one launch of the chain kernel over every pixel, as
    past 32 objects), with warps that meet 32 distinct objects at one
    site: the scatter's loop over a warp's objects."""
    sc = strip_scene(cuda_device)
    cfg = trt.RenderConfig(width=64, height=16, shadow_samples=2, bounces=2)
    res = _split_checks(sc, cfg, monkeypatch, seed=4, split=False)
    pid = res.prim_id.reshape(cfg.aa_rays, -1, 32)
    most = max(len({int(i) for i in w if i >= 0})
               for a in pid.cpu() for w in a)
    assert sc.num_triangles == 300 and most > 16
