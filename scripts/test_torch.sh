#!/usr/bin/env bash
# The PyTorch/CUDA port's tests and checks (the counterpart of test.sh).
#
#   scripts/test_torch.sh                 the port's tests, slow cases
#                                         included (the card's tests skip
#                                         without a card)
#   scripts/test_torch.sh --nan-check     the launch list under the NaN
#                                         checks (debug.nan_checks): exits
#                                         non-zero at the first NaN; on the
#                                         card, or with --device cpu through
#                                         the plain versions
#   scripts/test_torch.sh --smoke         fresh-install smoke test: pip-install
#                                         the package into a clean --target
#                                         directory (torch and numpy come from
#                                         the interpreter's site-packages; no
#                                         network) and run cli render and cli
#                                         fit on the CPU from the installed
#                                         copy, away from the checkout
#   scripts/test_torch.sh --smoke --cuda  then make the installed copy
#                                         read-only and render 64x64 on the
#                                         card from it: the kernels build
#                                         into $XDG_CACHE_HOME (~/.cache),
#                                         not into site-packages
set -euo pipefail
cd "$(dirname "$0")/.."
if [[ "${1:-}" == "--nan-check" ]]; then
    shift
    exec python -m uob_raytracer_tpu_torch.debug --nan-check "$@"
fi
if [[ "${1:-}" == "--smoke" ]]; then
    shift
    cuda=0
    if [[ "${1:-}" == "--cuda" ]]; then
        cuda=1
    fi
    tmp="$(mktemp -d)"
    # the --cuda step makes the copy read-only: give write back to remove it
    trap 'chmod -R u+w "$tmp" 2>/dev/null; rm -rf "$tmp"' EXIT
    pip install --quiet --no-index --no-build-isolation --no-deps \
        --target "$tmp/site" .
    mkdir "$tmp/cwd"   # run away from the repo so the INSTALLED copy imports
    site="$tmp/site${PYTHONPATH:+:$PYTHONPATH}"
    (cd "$tmp/cwd" && \
     PYTHONPATH="$site" python -m uob_raytracer_tpu_torch.cli \
         render --device cpu --width 32 -o smoke.bmp && \
     test -s smoke.bmp && \
     PYTHONPATH="$site" python -m uob_raytracer_tpu_torch.cli \
         fit --device cpu --steps 1 --width 16)
    echo "smoke test OK: installed-package cli render + fit ran clean on the CPU"
    if (( cuda )); then
        chmod -R a-w "$tmp/site"
        touch "$tmp/stamp"
        (cd "$tmp/cwd" && \
         PYTHONDONTWRITEBYTECODE=1 PYTHONPATH="$site" \
             python -m uob_raytracer_tpu_torch.cli \
             render --width 64 -o smoke_cuda.bmp && \
         test -s smoke_cuda.bmp)
        # chmod does not stop root: check that nothing was written there
        written="$(find "$tmp/site" -newer "$tmp/stamp" \
                   ! -path '*/__pycache__*')"
        if [[ -n "$written" ]]; then
            echo "smoke test FAILED: the render wrote into the installed" \
                 "copy: $written" >&2
            exit 1
        fi
        echo "smoke test OK: cli render on the card from a read-only" \
             "installed copy (kernels built under" \
             "${XDG_CACHE_HOME:-$HOME/.cache}/uob_raytracer_tpu_torch)"
    fi
    exit 0
fi
exec python -m pytest tests/ -q -k torch -m 'slow or not slow' "$@"
