#!/usr/bin/env bash
# The PyTorch/CUDA port's card-only tests (pytest -m cuda -k torch, one
# process), logged as an artifact (the counterpart of tpu_suite.sh).
#
#   scripts/cuda_suite.sh [out]     # default docs/cuda_suite_h100.txt
#
# The header gives the card's name and power limit, the date and the
# commit (git rev-parse HEAD, or $COMMIT where the checkout is not a git
# tree); the last line the exit code of pytest. Needs a card: without one
# every test in the log skips.
set -uo pipefail
cd "$(dirname "$0")/.."
out="${1:-docs/cuda_suite_h100.txt}"
commit="$(git rev-parse HEAD 2>/dev/null || echo "${COMMIT:-unknown}")"
{
    echo "# pytest -m cuda -k torch — the port's card-only tests"
    date -u +"# %Y-%m-%dT%H:%M:%SZ"
    echo "# card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>&1 | head -n 1)"
    echo "# commit: $commit"
    python -c 'import sys, torch; print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")'
    # -o addopts="": one process, whether or not pytest-xdist is installed
    python -m pytest tests/ -o addopts="" -m cuda -k torch --durations=10 \
        -p no:cacheprovider 2>&1
    rc=$?
    echo "# exit: $rc"
    exit "$rc"
} | tee "$out"
exit "${PIPESTATUS[0]}"
