"""ctypes wrapper for the scalar C++ oracle (reference/cpp/oracle.cpp) — the
port's copy of ``uob_raytracer_tpu/reference/cpp_oracle.py``, reading the
port's ``Scene`` and ``RenderConfig``.

Builds the shared library on first use (``make`` with g++, the package's
``cpp/Makefile``) into ``oracle/`` under the kernels' build root
(``kernels/_build.py:build_root``: ``build/`` in a checkout, a cache
directory for an installed copy), never into the package; the library's
name carries a hash of the source and the Makefile, so an edit rebuilds it.
The C++ oracle is an independent scalar implementation of the reference
semantics used to cross-check the vectorized NumPy oracle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..config import RenderConfig
from ..kernels._build import build_root
from ..scene import Scene, scene_to_numpy

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library for the current source and Makefile lives."""
    h = hashlib.sha256()
    for name in ("oracle.cpp", "Makefile"):
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_root(), "oracle",
                        f"liboracle_{h.hexdigest()[:16]}.so")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                proc = subprocess.run(["make", "-C", _DIR, f"LIB={tmp}"],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"building the C++ oracle failed "
                                       f"({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)   # a concurrent loader sees all or nothing
            _lib = ctypes.CDLL(path)
        return _lib


def _fp(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def render_cpp_oracle(scene: Scene, cfg: RenderConfig) -> np.ndarray:
    """Render the float image [H, W, 3] with the scalar C++ oracle."""
    lib = _load()
    leaves = scene_to_numpy(scene)
    s = {k: _fp(leaves[k]) for k in (
        "tri_v0", "tri_v1", "tri_v2", "tri_rgb", "tri_mat",
        "sph_center", "sph_r2", "sph_rgb", "sph_mat",
        "light_pos", "light_color", "indirect_light", "camera_pos")}
    T = s["tri_v0"].shape[0]
    S = s["sph_center"].shape[0]
    out = np.zeros((cfg.height, cfg.width, 3), dtype=np.float32)
    c_fp = ctypes.POINTER(ctypes.c_float)
    p = lambda a: a.ctypes.data_as(c_fp)
    yaw = float(leaves["yaw"])
    pitch = float(leaves["pitch"])
    if cfg.cpu_ref:
        rc = lib.oracle_render_cpu_ref(
            p(s["tri_v0"]), p(s["tri_v1"]), p(s["tri_v2"]),
            p(s["tri_rgb"]), p(s["tri_mat"]), ctypes.c_int(T),
            p(s["light_pos"]), p(s["light_color"]), p(s["indirect_light"]),
            p(s["camera_pos"]),
            ctypes.c_float(yaw), ctypes.c_float(pitch),
            ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
            ctypes.c_float(cfg.effective_focal),
            ctypes.c_float(cfg.cpu_ref_bias), p(out))
    else:
        rc = lib.oracle_render_gpu(
            p(s["tri_v0"]), p(s["tri_v1"]), p(s["tri_v2"]),
            p(s["tri_rgb"]), p(s["tri_mat"]), ctypes.c_int(T),
            p(s["sph_center"]), p(s["sph_r2"]), p(s["sph_rgb"]),
            p(s["sph_mat"]), ctypes.c_int(S),
            p(s["light_pos"]), p(s["light_color"]), p(s["indirect_light"]),
            p(s["camera_pos"]),
            ctypes.c_float(yaw), ctypes.c_float(pitch),
            ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
            ctypes.c_int(cfg.aa_x), ctypes.c_int(cfg.aa_y),
            ctypes.c_int(cfg.shadow_samples),
            ctypes.c_float(cfg.light_spread), ctypes.c_int(cfg.bounces),
            ctypes.c_float(cfg.effective_focal), ctypes.c_float(cfg.bias),
            ctypes.c_int(1 if cfg.quirk_nan_tir else 0), p(out))
    if rc != 0:
        raise RuntimeError(f"C++ oracle failed with code {rc}")
    return out


def load_obj_cpp(path: str, scale: float = 1.5,
                 translate=(-0.4, 1.15, -0.7)) -> np.ndarray:
    """Native OBJ loader (C++, mirrors Source/Loader.cpp transforms).
    Returns triangle vertices [T, 3, 3] float32."""
    lib = _load()
    t = _fp(np.asarray(translate, dtype=np.float32))
    c_fp = ctypes.POINTER(ctypes.c_float)
    n = lib.oracle_load_obj(path.encode(), ctypes.c_float(scale),
                            t.ctypes.data_as(c_fp), None, 0)
    if n < 0:
        raise IOError(f"oracle_load_obj failed with code {n} for {path}")
    out = np.zeros((n, 3, 3), dtype=np.float32)
    got = lib.oracle_load_obj(path.encode(), ctypes.c_float(scale),
                              t.ctypes.data_as(c_fp),
                              out.ctypes.data_as(c_fp), n)
    if got != n:
        raise IOError(f"oracle_load_obj read {got} triangles of {n} from "
                      f"{path}")
    return out
