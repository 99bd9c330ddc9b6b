"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program. Top-level names are compared whole: the
port's name begins with the JAX package's."""
from __future__ import annotations

import json
import subprocess
import sys

from rtbench.tests.conftest import REPO, SEED, cells, make_root


def _modules(code: str, cwd: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json; "
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=cwd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_a_run_of_every_cell_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    code = ("import sys, torch\nsys.path.insert(0, %r)\n"
            "from rtbench import harness\n" % REPO)
    for cell in cells():
        for trace in (False, True):
            code += (f"harness.run_cell(harness.Run({root!r}, {cell!r}, "
                     f"{SEED}, 0.2, {trace}, torch.device('cpu')), 0.0)\n")
    code += "from rtbench import control, trace, work\n"
    code += "assert not harness.forbidden_modules()\n"
    tops = _tops(_modules(code, REPO))
    assert "uob_raytracer_tpu_torch" in tops     # the program did run
    assert not tops & {"jax", "jaxlib", "flax", "uob_raytracer_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\nsys.path.insert(0, %r)\n"
            "import rtbench.reference.render, rtbench.reference.live\n"
            "import rtbench.scenes, rtbench.scenes.cornell, "
            "rtbench.scenes.dense, rtbench.work\n" % REPO)
    tops = _tops(_modules(code, REPO))
    assert not tops & {"uob_raytracer_tpu_torch", "uob_raytracer_tpu",
                       "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    from rtbench import harness
    assert harness.forbidden_modules(
        ["uob_raytracer_tpu_torch", "uob_raytracer_tpu_torch.render",
         "uob_raytracer_tpu.scene", "jaxlib", "jax_extra", "jax",
         "flax.linen", "torch"]) == ["flax.linen", "jax", "jaxlib",
                                     "uob_raytracer_tpu.scene"]
