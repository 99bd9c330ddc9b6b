"""Build the CUDA sources of ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per
source, all started together, and links the objects into one shared
library with a plain ``extern "C"`` interface, which ``ctypes`` loads; no
PyTorch headers are involved, so the build takes seconds. The library goes
to ``torch_kernels/`` under ``build_root()`` (``build/`` at the root of a
checkout, a cache directory for an installed copy), under a name that
carries a hash of the sources and flags, so an edit rebuilds it; beside it
the ``.log`` holds each source's command and ptxas report, in source order.
A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

# --fmad=false: no FMA contraction, so the kernels can be held tightly to
# their plain torch versions (see the note in csrc/render_fwd.cu). Never
# --use_fast_math: division and sqrt stay IEEE. -Xptxas -v reports each
# kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_root(pkg: str = _PKG) -> str:
    """Where the package's built libraries go. A checkout (a package whose
    parent directory holds ``pyproject.toml``) keeps them in ``build/`` at
    its root; an installed copy, whose directory may be read-only, in
    ``$XDG_CACHE_HOME/uob_raytracer_tpu_torch`` (``~/.cache/...`` where that
    variable is unset), never inside site-packages."""
    parent = os.path.dirname(pkg)
    if os.path.exists(os.path.join(parent, "pyproject.toml")):
        return os.path.join(parent, "build")
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, os.path.basename(pkg))


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_root(), "torch_kernels",
                        f"libuob_rt_kernels_{h.hexdigest()[:16]}.so")


def tool(name: str) -> str:
    """A program of the CUDA toolkit (``nvcc``, ``cuobjdump``), from
    $CUDA_HOME/bin or the PATH; raises where there is none."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", name), shutil.which(name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (looked in $CUDA_HOME/bin and "
                       f"PATH): it ships with the CUDA toolkit")


def build() -> tuple[str, float]:
    """Compile the sources if their library is missing. Returns (library
    path, seconds spent compiling and linking; 0 when it was already
    built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    nvcc = tool("nvcc")
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = tmp + ".d"
    os.makedirs(objs, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(objs, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    shutil.rmtree(objs, ignore_errors=True)
    with open(path[:-3] + ".log", "w") as f:
        f.write("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return path, seconds


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = ctypes.CDLL(path)
        return _lib
