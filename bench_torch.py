#!/usr/bin/env python
"""The PyTorch/CUDA port's bench: the counterpart of ``bench.py``, which
stays the JAX package's. The logic lives in ``uob_raytracer_tpu_torch.bench``;
see its docstring for the flags. Prints one JSON line.

    python bench_torch.py                       # on the card: headline + configs
    python bench_torch.py --device cpu --width 16 --headline-only --iters 2
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from uob_raytracer_tpu_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    main()
