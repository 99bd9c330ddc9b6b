#!/usr/bin/env python
"""Local preview of the PyTorch/CUDA port: the light animation as a GIF, a
Tk window (``--show``), the live loop with mouse and keyboard camera control
(``--interactive``) and its headless keypress->frame bench
(``--latency-bench``). The logic lives in ``uob_raytracer_tpu_torch.preview``;
see its docstring for the flags.

    python scripts/preview_torch.py --device cpu --latency-bench --width 32
    python scripts/preview_torch.py --latency-bench --width 256 --bounces 1
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uob_raytracer_tpu_torch.preview import main  # noqa: E402

if __name__ == "__main__":
    main()
