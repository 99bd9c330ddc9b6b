"""Port tests: config and scene of ``uob_raytracer_tpu_torch`` against the
JAX package. Scenes are built from the same constant tables, so leaves must
be bit-identical; normals go through different norm kernels (atol 1e-6)."""
import ast
import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import scene as jscene
from uob_raytracer_tpu.config import ShadingModel as JShading
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import scene as tscene
from uob_raytracer_tpu_torch.config import ShadingModel as TShading

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
ICO = os.path.join(ROOT, "assets", "ico.obj")
FIELDS = [f.name for f in dataclasses.fields(tscene.Scene)]


def _cfg_dict(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d = {k: (v.value if isinstance(v, enum.Enum) else v) for k, v in d.items()}
    d.update(aa_rays=cfg.aa_rays, effective_focal=cfg.effective_focal)
    return d


@pytest.mark.parametrize("name", ["cpu_ref_256", "soft_shadows_512",
                                  "mirror_512", "glass_fresnel_512",
                                  "full_1024"])
def test_baseline_configs_match(name):
    assert list(trt.baseline_configs()) == list(jrt.baseline_configs())
    assert _cfg_dict(trt.baseline_configs()[name]) == _cfg_dict(
        jrt.baseline_configs()[name])


@pytest.mark.parametrize("kw", [{}, {"cpu_ref": True},
                                {"width": 96, "height": 20, "aa_x": 3},
                                {"fresnel": True, "quirk_nan_tir": True}])
def test_render_config_matches(kw):
    """Field for field, including __post_init__ (cpu_ref) and the
    derived properties."""
    assert _cfg_dict(trt.RenderConfig(**kw)) == _cfg_dict(jrt.RenderConfig(**kw))
    assert [m.value for m in TShading] == [m.value for m in JShading]


def _assert_scene_equal(tsc, jleaves):
    for name in FIELDS:
        a = getattr(tsc, name).cpu().numpy()
        b = np.asarray(jleaves[name] if isinstance(jleaves, dict)
                       else getattr(jleaves, name))
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("spheres", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shading", ["device", "host"])
def test_cornell_box_bit_identical(spheres, masked, shading):
    tsc = trt.cornell_box(spheres=spheres, masked_sphere=masked,
                          shading=TShading(shading), device="cpu")
    jsc = jrt.cornell_box(spheres=spheres, masked_sphere=masked,
                          shading=JShading(shading), as_numpy=True)
    assert tsc.num_triangles == 26
    assert tsc.num_spheres == (3 if masked else 2) * spheres
    _assert_scene_equal(tsc, jsc)


def test_default_spheres_and_normals():
    for inc in (False, True):
        for a, b in zip(tscene.default_spheres(inc), jscene.default_spheres(inc)):
            np.testing.assert_array_equal(a, b)
    j = jrt.cornell_box(as_numpy=True)
    n_t = trt.compute_normals(*(torch.from_numpy(getattr(j, k))
                                for k in ("tri_v0", "tri_v1", "tri_v2")))
    n_j = jscene.compute_normals(j.tri_v0, j.tri_v1, j.tri_v2, xp=np)
    np.testing.assert_allclose(n_t.numpy(), n_j, atol=1e-6)


def test_load_obj_and_add_triangles():
    """assets/ico.obj loads the same, and appends the same leaves."""
    for a, b in zip(trt.load_obj(ICO, mat_code=1.0),
                    jrt.load_obj(ICO, mat_code=1.0)):
        np.testing.assert_array_equal(a, b)
    verts, rgb, mat = jrt.load_obj(ICO)
    tsc = trt.add_triangles(trt.cornell_box(device="cpu"), verts, rgb, mat)
    jsc = jrt.add_triangles(jrt.cornell_box(), verts, rgb, mat)
    assert tsc.num_triangles == 26 + 20
    _assert_scene_equal(tsc, jsc)


def test_animate_light_matches():
    tx, tl = jx, jl = 0.0, True
    for _ in range(200):
        tx, tl = trt.animate_light(tx, tl)
        jx, jl = jrt.animate_light(jx, jl)
        assert (tx, tl) == (jx, jl)


def _perturbed_leaves(seed=0):
    """The Cornell leaves with seeded noise on every leaf."""
    rs = np.random.RandomState(seed)
    leaves = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jrt.cornell_box(as_numpy=True)).items()}
    return {k: (v + rs.normal(0, 0.01, v.shape)).astype(np.float32)
            for k, v in leaves.items()}


def test_scene_numpy_roundtrip():
    leaves = _perturbed_leaves()
    sc = tscene.scene_from_numpy(leaves, "cpu")
    back = tscene.scene_to_numpy(sc)
    assert sorted(back) == sorted(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    moved = sc.to("cpu")
    assert moved.device.type == "cpu"
    _assert_scene_equal(moved, leaves)


def test_npz_jax_to_torch(tmp_path):
    path = str(tmp_path / "jax_scene.npz")
    jsc = jscene.Scene(**{k: np.asarray(v) for k, v in _perturbed_leaves(1).items()})
    jscene.save_scene(path, jsc)
    _assert_scene_equal(tscene.load_scene(path, "cpu"), jsc)


def test_npz_torch_to_jax(tmp_path):
    path = str(tmp_path / "torch_scene.npz")
    tsc = tscene.scene_from_numpy(_perturbed_leaves(2), "cpu")
    tscene.save_scene(path, tsc)
    jsc = jscene.load_scene(path)
    _assert_scene_equal(tsc, jsc)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """No module of the port (nor chip_smoke.py) imports jax or the JAX
    package; the subprocess test in test_torch_render.py checks it at run
    time."""
    pkg = os.path.join(ROOT, "uob_raytracer_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "uob_raytracer_tpu"), (
                f"{path} imports {mod}")
