"""The port's reference oracles: the NumPy float32 oracle (``oracle``) and
the scalar C++ oracle that cross-checks it (``cpp_oracle``), copies of the
JAX package's ``reference/`` that import neither jax nor the JAX package."""
from .oracle import render_oracle, pack_argb_np  # noqa: F401
