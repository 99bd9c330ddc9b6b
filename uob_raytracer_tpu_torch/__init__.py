"""uob_raytracer_tpu_torch — the ray tracer in PyTorch, with CUDA kernels.

A port of ``uob_raytracer_tpu`` (JAX/Pallas) to PyTorch on an NVIDIA H100.
For a scene on the card the forward frame is one launch of a hand-written
CUDA kernel (``csrc/render_fwd.cu``) and its gradient one launch of the
path-replay backward kernel (``csrc/render_bwd.cu``); a scene on the CPU
runs their plain torch versions. Scenes are built on the card unless the
caller passes ``device="cpu"``. This package imports neither jax nor the
JAX package; the JAX package is the reference its tests hold it to.
"""
from .config import RenderConfig, ShadingModel, baseline_configs  # noqa: F401
from .scene import (  # noqa: F401
    Scene, cornell_box, load_obj, add_triangles, compute_normals, animate_light,
)
from .render import render, render_image, render_packed  # noqa: F401

__version__ = "0.1.0"
