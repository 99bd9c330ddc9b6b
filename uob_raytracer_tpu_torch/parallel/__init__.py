"""Training through the differentiable renderer — the counterpart of
``uob_raytracer_tpu/parallel``. Single device for now: every entry point
takes ``mesh=None``; the dp/tp meshes of the JAX package are not ported."""
from .train import (DEFAULT_LRS, TRAINABLE, TrainOut, fit,  # noqa: F401
                    image_loss, train_step)
