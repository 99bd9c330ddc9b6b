"""Port tests: ``uob_raytracer_tpu_torch.reference`` (the NumPy and C++
oracles) against the JAX package's ``reference``, the oracle-parity
statistics of ``parity_torch.py``, and the build directory rule of
``kernels/_build.py``.

Both NumPy oracles do the same float32 arithmetic in the same order, so on
the same leaves (made with numpy from a seed) their images are held bit for
bit. The port's oracle must import neither jax nor the JAX package: the
machine with the card has no jax."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import scene as jscene
from uob_raytracer_tpu.reference.cpp_oracle import (
    render_cpp_oracle as j_render_cpp_oracle)
from uob_raytracer_tpu.reference.oracle import (
    pack_argb_np as j_pack_argb_np, render_oracle as j_render_oracle)
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.debug import dense_scene
from uob_raytracer_tpu_torch.kernels import _build, render_bwd, render_fwd
from uob_raytracer_tpu_torch.reference import pack_argb_np, render_oracle
from uob_raytracer_tpu_torch.reference import cpp_oracle
from uob_raytracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import parity_torch as parity  # noqa: E402

CONFIGS = list(trt.baseline_configs())


def _configs(name: str, size: int):
    """The baseline config ``name`` at size x size, in both packages."""
    t = dataclasses.replace(trt.baseline_configs()[name], width=size,
                            height=size)
    j = dataclasses.replace(jrt.baseline_configs()[name], width=size,
                            height=size)
    return t, j


def _leaves(name: str, seed: int = 0) -> dict:
    """The config's Cornell scene (``parity_torch.scene_for``) with the
    light moved and the camera turned by seeded amounts."""
    cfg = trt.baseline_configs().get(name, trt.RenderConfig())
    leaves = scene_to_numpy(parity.scene_for(cfg, "cpu"))
    rng = np.random.RandomState(seed)
    leaves["light_pos"] = (leaves["light_pos"] + rng.uniform(
        -0.05, 0.05, 3)).astype(np.float32)
    leaves["yaw"] = np.float32(rng.uniform(-0.05, 0.05))
    leaves["pitch"] = np.float32(rng.uniform(-0.05, 0.05))
    return leaves


def _both(leaves: dict):
    """(the port's CPU Scene, the JAX package's Scene) of the same leaves."""
    return (scene_from_numpy(leaves, "cpu"),
            jscene.Scene(**{k: jnp.asarray(v) for k, v in leaves.items()}))


@pytest.mark.parametrize("name", CONFIGS)
def test_numpy_oracle_bit_equal(name):
    cfg, j_cfg = _configs(name, 32)
    scene, j_scene = _both(_leaves(name))
    got = render_oracle(scene, cfg)
    want = j_render_oracle(j_scene, j_cfg)
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    assert got.max() > 0.1    # rendered something
    assert np.array_equal(got, want)


def test_numpy_oracle_bit_equal_dense():
    """dense_scene(64): the Cornell box and 38 random small triangles, 2x2
    AA, 3 samples, 2 bounces."""
    leaves = scene_to_numpy(dense_scene(64, device="cpu"))
    scene, j_scene = _both(leaves)
    cfg = trt.RenderConfig(width=16, height=16, shadow_samples=3, bounces=2)
    j_cfg = jrt.RenderConfig(width=16, height=16, shadow_samples=3, bounces=2)
    assert np.array_equal(render_oracle(scene, cfg),
                          j_render_oracle(j_scene, j_cfg))


def test_oracle_reads_a_scene_on_any_device_as_numpy():
    """The oracle returns numpy float32 and does no torch arithmetic: a
    scene whose leaves need a gradient renders the same bits."""
    cfg, _ = _configs("mirror_512", 16)
    scene, _ = _both(_leaves("mirror_512"))
    grad = dataclasses.replace(scene, light_pos=scene.light_pos.clone()
                               .requires_grad_(True))
    a, b = render_oracle(scene, cfg), render_oracle(grad, cfg)
    assert isinstance(b, np.ndarray) and np.array_equal(a, b)


def test_pack_argb_np_equal():
    img = np.random.RandomState(3).uniform(-0.2, 1.2, (16, 16, 3)).astype(
        np.float32)
    img[0, 0] = [0.0, 1.0, 254.9999 / 255.0]
    got = pack_argb_np(img)
    assert got.dtype == np.uint32
    assert np.array_equal(got, j_pack_argb_np(img))
    assert np.array_equal(pack_argb_np(np.zeros((1, 1, 3), np.float32)),
                          np.full((1, 1), 0xFF000000, np.uint32))


@pytest.mark.parametrize("name", CONFIGS)
def test_cpp_oracle_equal(name):
    """The port's C++ oracle (built from its own copy of the source) equals
    the JAX package's at 16x16."""
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no g++ and make to build the C++ oracle")
    cfg, j_cfg = _configs(name, 16)
    scene, j_scene = _both(_leaves(name))
    got = cpp_oracle.render_cpp_oracle(scene, cfg)
    assert np.array_equal(got, j_render_cpp_oracle(j_scene, j_cfg))
    # built under the build root, never inside the package
    path = cpp_oracle.library_path()
    assert os.path.exists(path)
    assert path.startswith(os.path.join(_build.build_root(), "oracle"))
    assert not any(f.endswith(".so") for f in os.listdir(cpp_oracle._DIR))


def test_cpp_obj_loader(tmp_path):
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no g++ and make to build the C++ oracle")
    p = tmp_path / "two.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\nf 1 2 3\nf 2 3 4\n")
    verts, _, _ = trt.load_obj(str(p))
    assert np.array_equal(cpp_oracle.load_obj_cpp(str(p)), verts)


def test_reference_and_parity_import_no_jax():
    """With jax unimportable, the port's oracles and parity_torch.py still
    import, and nothing of the JAX package is loaded."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import uob_raytracer_tpu_torch.reference\n"
        "import uob_raytracer_tpu_torch.reference.cpp_oracle\n"
        "import parity_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.split('.')[0] in ('jaxlib', 'uob_raytracer_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


# --------------------------------------------------------------------------
# parity_torch.py's statistics, on 16x16 plain renders and hand-made cases
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    """(scene, cfg, render() on the CPU, the oracle's image) at 16x16."""
    cfg, _ = _configs("full_1024", 16)
    scene = parity.scene_for(cfg, "cpu")
    return scene, cfg, trt.render(scene, cfg), render_oracle(scene, cfg)


def test_pct_over_one_pixel(frame):
    _, _, out, oracle = frame
    assert parity.pct_over(out.image, oracle) == 0.0
    assert parity.max_dev(out.image, oracle) < 1e-5
    off = oracle.copy()
    off[5, 7, 1] += np.float32(4e-4)
    assert parity.pct_over(oracle, off) == 100.0 / 256
    assert parity.max_dev(oracle, off) == pytest.approx(4e-4, rel=1e-3)
    # a deviation within the tolerance counts for nothing
    off[5, 7, 1] = oracle[5, 7, 1] + np.float32(2e-4)
    assert parity.pct_over(oracle, off) == 0.0


def test_packed_mismatch_one_word(frame):
    _, _, out, oracle = frame
    packed = pack_argb_np(oracle)
    assert out.packed.dtype == torch.uint32
    assert parity.packed_mismatch_pct(out.packed, packed) == 0.0
    bad = packed.copy()
    bad[15, 0] ^= np.uint32(1)
    assert parity.packed_mismatch_pct(out.packed, bad) == 100.0 / 256
    assert parity.packed_mismatch_pct(bad, packed) == 100.0 / 256


def test_record_agreement(frame):
    scene, cfg, _, _ = frame
    res = render_fwd.render_fused_res(scene, cfg)[2]
    ref = render_fwd.render_fused_res_plain(scene, cfg)[2]
    assert parity.record_agreement_pct(res, ref) == {
        "pid": 100.0, "lit": 100.0, "bid": 100.0}
    pid = res.prim_id.clone()
    pid.view(-1)[0] += 1
    got = parity.record_agreement_pct(type(res)(pid, *res[1:]), ref)
    assert got["pid"] == 100.0 * (1 - 1 / pid.numel())
    assert got["lit"] == got["bid"] == 100.0
    # no bounce steps: an empty bid agrees
    empty = type(res)(res.prim_id, res.lit_cnt, res.bounce_id[:, :0])
    assert parity.record_agreement_pct(empty, empty)["bid"] == 100.0


def test_worst_leaf_error(frame):
    scene, cfg, _, _ = frame
    res = render_fwd.render_fused_res(scene, cfg)[2]
    g = parity.cotangent(cfg, "cpu")
    got = render_bwd.render_replay_bwd(scene, cfg, res, g)
    ref = render_bwd.render_replay_bwd_plain(scene, cfg, res, g)
    assert parity.worst_leaf_error(ref, got) == (0.0, "pitch")
    # one leaf off by 3e-3 of its largest magnitude (or of 1, if smaller)
    lc = ref.light_color
    scale = max(lc.abs().max().item(), 1.0)
    bad = dataclasses.replace(got, light_color=lc + 3e-3 * scale)
    rel, leaf = parity.worst_leaf_error(ref, bad)
    assert leaf == "light_color" and rel == pytest.approx(3e-3, rel=1e-3)
    nan = dataclasses.replace(got, yaw=torch.tensor(float("nan")))
    assert parity.worst_leaf_error(ref, nan) == (float("inf"), "yaw")


def _case(**over):
    case = {"pct_over_tol": 0.1, "max_dev": 0.3, "packed_mismatch_pct": 0.2,
            "record_agreement_pct": {"pid": 99.9, "lit": 100.0, "bid": 99.6},
            "grad_worst_rel": 5e-4, "grad_worst_leaf": "tri_v0",
            "grad_budget": 1e-3}
    case.update(over)
    return case


@pytest.mark.parametrize("over,want", [
    ({}, []),
    ({"grad_worst_rel": None}, []),
    ({"pct_over_tol": 0.6}, ["of pixels beyond"]),
    ({"max_dev": 0.46}, ["worst pixel"]),
    ({"packed_mismatch_pct": 0.51}, ["packed words"]),
    ({"record_agreement_pct": {"pid": 99.4, "lit": 100.0, "bid": 100.0}},
     ["record pid"]),
    ({"grad_worst_rel": 2e-3}, ["gradient tri_v0"]),
    ({"pct_over_tol": float("nan"), "max_dev": 0.5},
     ["of pixels beyond", "worst pixel"]),
])
def test_breaches(over, want):
    got = parity.breaches(_case(**over))
    assert len(got) == len(want)
    for msg, part in zip(got, want):
        assert part in msg


def test_parity_cases():
    """Five configs at 256x256, four more at their own sizes (cpu_ref's is
    256x256), and the dense scene routed to the streamed kernels."""
    cs = parity.cases()
    names = [f"{n} {c.width}x{c.height}" for n, _, c in cs]
    assert len(names) == len(set(names)) == 10
    assert sum(c.width == 256 for _, _, c in cs) == 5
    assert ("full_1024", 0) == (cs[8][0], cs[8][1]) and cs[8][2].width == 1024
    name, n_tri, cfg = cs[-1]
    assert (name, n_tri, cfg.width, cfg.aa_rays, cfg.shadow_samples,
            cfg.bounces) == ("dense_600", 600, 64, 4, 3, 2)
    assert render_fwd.use_streamed(n_tri, 2)
    assert all(c.width == 16 for _, _, c in parity.cases(16))


def test_parity_main_on_cpu(tmp_path, capsys):
    """The whole script through the plain versions at 16x16: every case
    within the budget, the record written, exit 0."""
    out = tmp_path / "p.json"
    assert parity.main(["--device", "cpu", "--size", "16", "--out",
                        str(out), "--commit", "abc"]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["card"] == "cpu" and rec["commit"] == "abc"
    assert len(rec["cases"]) == 6 and len(rec["cpp_vs_numpy"]) == 4
    for c in rec["cases"]:
        assert c["breaches"] == [] and c["oracle_s"] > 0
        assert c["grad_worst_rel"] == 0.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ok"] is True


# --------------------------------------------------------------------------
# kernels/_build.py: where a checkout and an installed copy build
# --------------------------------------------------------------------------

def test_build_root_checkout(tmp_path):
    pkg = tmp_path / "repo" / "uob_raytracer_tpu_torch"
    pkg.mkdir(parents=True)
    (tmp_path / "repo" / "pyproject.toml").write_text("[project]\n")
    assert _build.build_root(str(pkg)) == str(tmp_path / "repo" / "build")


def test_build_root_installed(tmp_path, monkeypatch):
    pkg = tmp_path / "site-packages" / "uob_raytracer_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.build_root(str(pkg)) == str(
        tmp_path / "xdg" / "uob_raytracer_tpu_torch")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_root(str(pkg)) == str(
        tmp_path / "home" / ".cache" / "uob_raytracer_tpu_torch")


def test_library_paths_under_build_root():
    """This checkout builds the kernels and the C++ oracle under its own
    build/ directory."""
    root = os.path.join(ROOT, "build")
    assert _build.build_root() == root
    assert _build.library_path().startswith(
        os.path.join(root, "torch_kernels", "libuob_rt_kernels_"))
    assert cpp_oracle.library_path().startswith(
        os.path.join(root, "oracle", "liboracle_"))
