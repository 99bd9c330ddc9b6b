"""uob_raytracer_tpu_torch — the ray tracer in PyTorch, with CUDA kernels.

A port of ``uob_raytracer_tpu`` (JAX/Pallas) to PyTorch on an NVIDIA H100.
The forward frame runs as one launch of a hand-written CUDA kernel
(``csrc/render_fwd.cu``) for a scene on the card, and as the plain torch
pipeline for a scene on the CPU. This package imports neither jax nor the
JAX package; the JAX package is the reference its tests hold it to.
"""
from .config import RenderConfig, ShadingModel, baseline_configs  # noqa: F401
from .scene import (  # noqa: F401
    Scene, cornell_box, load_obj, add_triangles, compute_normals, animate_light,
)
from .render import render, render_image, render_packed  # noqa: F401

__version__ = "0.1.0"
