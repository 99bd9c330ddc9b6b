"""Port tests: ``uob_raytracer_tpu_torch.render`` — the slice as a whole —
against the JAX package's jnp pipeline, the checked-in goldens and the CLI.
Images are held to ``assert_images_match`` (at most 0.5% of pixels beyond
3e-4, none beyond 0.45): the budget of the JAX package's own renderer
against its oracle and goldens."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu.config import ShadingModel as JShading
from uob_raytracer_tpu.render import _render_image_jnp
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import cli
from uob_raytracer_tpu_torch.config import ShadingModel
from uob_raytracer_tpu_torch.ops.image import pack_argb
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
from conftest import assert_images_match

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
ICO = os.path.join(ROOT, "assets", "ico.obj")


@pytest.mark.parametrize("name", ["cpu_ref_256", "soft_shadows_512",
                                  "mirror_512", "glass_fresnel_512",
                                  "full_1024"])
def test_plain_matches_jnp_baseline_features(name):
    """Every baseline config's feature set (AA grid, shadow samples,
    bounces, Fresnel, cpu_ref) at 64x64, on the scene the CLI builds."""
    cfg_t = dataclasses.replace(trt.baseline_configs()[name], width=64, height=64)
    cfg_j = dataclasses.replace(jrt.baseline_configs()[name], width=64, height=64)
    ts = trt.cornell_box(spheres=not cfg_t.cpu_ref,
                         shading=ShadingModel(cfg_t.shading.value),
                         device="cpu")
    js = jrt.cornell_box(spheres=not cfg_j.cpu_ref,
                         shading=JShading(cfg_j.shading.value))
    img_t = trt.render_image(ts, cfg_t, backend="torch")
    img_j = np.asarray(_render_image_jnp(js, cfg_j, chunk_rows=64))
    assert img_t.shape == (64, 64, 3) and torch.isfinite(img_t).all()
    assert img_t.max() > 0.2
    assert_images_match(img_t.numpy(), img_j, what=name)


def _ico_scene():
    verts, rgb, mat = trt.load_obj(ICO, mat_code=1.0)
    return trt.add_triangles(trt.cornell_box(device="cpu"), verts, rgb, mat)


@pytest.mark.parametrize("golden", ["cornell_64_full", "cornell_64_cpuref",
                                    "cornell_ico_64"])
def test_render_matches_golden(golden):
    if golden == "cornell_64_cpuref":
        scene = trt.cornell_box(spheres=False, shading=ShadingModel.HOST,
                                device="cpu")
        cfg = trt.RenderConfig(width=64, height=64, cpu_ref=True)
    else:
        scene = (_ico_scene() if golden == "cornell_ico_64"
                 else trt.cornell_box(device="cpu"))
        cfg = trt.RenderConfig(width=64, height=64)
    g = np.load(os.path.join(GOLDEN_DIR, golden + ".npz"))
    out = trt.render(scene, cfg)
    assert_images_match(out.image.numpy(), g["image"], what=golden)
    assert (out.packed.numpy() != g["packed"]).mean() <= 0.005


def test_render_packed_and_chunks():
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=32, height=16, shadow_samples=2, bounces=2)
    out = trt.render(sc, cfg)
    assert out.packed.dtype == torch.uint32
    assert torch.equal(out.packed.view(torch.int32),
                       pack_argb(out.image).view(torch.int32))
    assert torch.equal(trt.render_packed(sc, cfg).view(torch.int32),
                       out.packed.view(torch.int32))
    # chunking changes nothing: every ray is computed on its own
    assert torch.equal(trt.render_image(sc, cfg, chunk_rows=4), out.image)
    with pytest.raises(ValueError, match="divide"):
        trt.render_image(sc, cfg, chunk_rows=5)


def test_backend_selection():
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=8, height=8, shadow_samples=1, bounces=1)
    with pytest.raises(ValueError, match="CUDA device"):
        trt.render_image(sc, cfg, backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        trt.render(sc, cfg, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        trt.render_image(sc, cfg, backend="pallas")
    assert torch.equal(trt.render_image(sc, cfg),
                       trt.render_image(sc, cfg, backend="torch"))


def test_render_validates_passed_quads():
    sc = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=8, height=8, shadow_samples=1, bounces=0)
    q = detect_shadow_quads(sc)
    trt.render(sc, cfg, shadow_quads=q)
    moved = dataclasses.replace(sc, tri_v0=sc.tri_v0 + 0.05 * torch.arange(
        26, dtype=torch.float32)[:, None])
    with pytest.raises(ValueError, match="stale"):
        trt.render(moved, cfg, shadow_quads=q)


def test_cli_configs_and_render(tmp_path, capsys):
    cli.main(["configs"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(trt.baseline_configs())
    out = tmp_path / "frame.bmp"
    cli.main(["render", "--config", "cpu_ref_256", "--width", "16",
              "--backend", "torch", "--device", "cpu", "-o", str(out)])
    assert "Rendertime" in capsys.readouterr().out
    data = out.read_bytes()
    assert data[:2] == b"BM" and len(data) == 54 + 16 * 16 * 4


def test_imports_and_renders_without_jax():
    """The port needs neither jax nor the JAX package at run time."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['uob_raytracer_tpu'] = None\n"
        "import uob_raytracer_tpu_torch as rt\n"
        "out = rt.render(rt.cornell_box(device='cpu'), rt.RenderConfig(width=16, height=16))\n"
        "assert tuple(out.image.shape) == (16, 16, 3)\n"
        "assert 'jaxlib' not in sys.modules\n"
        "print('ok', float(out.image.mean()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
