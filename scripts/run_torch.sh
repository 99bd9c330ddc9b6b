#!/usr/bin/env bash
# Render the flagship Cornell frame with the PyTorch/CUDA port (the
# counterpart of run.sh). Usage: scripts/run_torch.sh [extra cli args]
set -euo pipefail
cd "$(dirname "$0")/.."
python -m uob_raytracer_tpu_torch.cli render "$@"
