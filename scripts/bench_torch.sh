#!/usr/bin/env bash
# The PyTorch/CUDA port's benchmark (the counterpart of bench.sh): one JSON
# line on stdout, details on stderr.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python bench_torch.py "$@"
