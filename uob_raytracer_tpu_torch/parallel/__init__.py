"""Sharded rendering and training through the differentiable renderer: the
counterpart of ``uob_raytracer_tpu/parallel``. One process is one position
of a (dp, tp) mesh; ``mesh=None`` is the one device the scene lives on."""
from .mesh import make_mesh, pad_triangles, select_devices  # noqa: F401
from .multihost import global_mesh, initialize_multihost  # noqa: F401
from .render import render_image_sharded  # noqa: F401
from .train import (DEFAULT_LRS, TRAINABLE, TrainOut, fit,  # noqa: F401
                    image_loss, train_step)
