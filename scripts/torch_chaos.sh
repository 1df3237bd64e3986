#!/usr/bin/env bash
# Chaos campaign driver for the PyTorch/CUDA port (python -m
# acg_tpu_torch): seeded randomized fault schedules through the
# supervisor, the twin of scripts/chaos.sh.  Every schedule must end
# converged or agreed-abort; a single wrong-answer-green run fails the
# campaign (exit 96, errors.ExitCode.WRONG_ANSWER).
#
# Usage: scripts/torch_chaos.sh [--serve] [SEED[:N]] [extra flags...]
#   --serve    run the campaign against a live --serve daemon instead
#              of one solve per schedule: a supervised solver service
#              is launched, N seeded request-level schedules (crashes
#              mid-request, slow-solve stalls, device fault injections)
#              are fired at it over HTTP on localhost, and every
#              response is verified against a host-side oracle.  A
#              wrong answer under a green status exits 96; a hung
#              request (neither answer nor typed refusal) exits 1.
#   SEED[:N]   campaign seed and schedule count (default 1234:20)
#
# Environment:
#   CHAOS_MATRIX   matrix spec (default gen:poisson2d:20)
#   CHAOS_NPARTS   stacked parts on the device (default 4; 0 = one
#                  part; --serve mode defaults to 0)
#   CHAOS_DEVICE   cuda (default) or cpu
#   CHAOS_DIR      scratch/ledger directory (default a mktemp dir)
#
# The solve-per-schedule campaign arms --abft --audit-every (so
# sdc:flip schedules are detectable), snapshots every 8 iterations (so
# crash:exit schedules are resumable), and records per-schedule
# verdicts into the $CHAOS_DIR/history ledger plus the acg_recovery_*
# metric families in $CHAOS_DIR/chaos.prom.  The --serve campaign
# records one acg-tpu-chaos-serve/1 verdict row per request instead.
set -o pipefail
cd "$(dirname "$0")/.."

SERVE=0
if [ "${1:-}" = "--serve" ]; then
    SERVE=1
    shift
fi

SPEC="${1:-1234:20}"
shift 2>/dev/null || true
MATRIX="${CHAOS_MATRIX:-gen:poisson2d:20}"
DEVICE="${CHAOS_DEVICE:-cuda}"
if [ "$SERVE" = "1" ]; then
    NPARTS="${CHAOS_NPARTS:-0}"
else
    NPARTS="${CHAOS_NPARTS:-4}"
fi
DIR="${CHAOS_DIR:-$(mktemp -d "${TMPDIR:-/tmp}/acg-chaos.XXXXXX")}"
mkdir -p "$DIR"

PARTS_FLAGS=(--device "$DEVICE")
if [ "$NPARTS" -gt 1 ]; then
    PARTS_FLAGS+=(--nparts "$NPARTS" --shrink any)
fi

if [ "$SERVE" = "1" ]; then
    echo "torch_chaos.sh: SERVE campaign $SPEC on $MATRIX ($NPARTS parts, $DEVICE) -> $DIR"
    python -m acg_tpu_torch "$MATRIX" \
        "${PARTS_FLAGS[@]}" \
        --serve --serve-faults \
        --max-iterations 400 --residual-rtol 1e-8 --quiet \
        --ckpt "$DIR/ck" \
        --chaos "$SPEC" --relaunch-backoff 0 \
        --history "$DIR/history" \
        --metrics-file "$DIR/chaos.prom" \
        "$@"
    rc=$?
    if [ $rc -eq 96 ]; then
        echo "torch_chaos.sh: WRONG-ANSWER-GREEN detected (exit 96) -- see $DIR"
    elif [ $rc -ne 0 ]; then
        echo "torch_chaos.sh: serve campaign failed (exit $rc) -- see $DIR"
    else
        echo "torch_chaos.sh: serve campaign clean (ledger: $DIR/history)"
    fi
    exit $rc
fi

echo "torch_chaos.sh: campaign $SPEC on $MATRIX ($NPARTS parts, $DEVICE) -> $DIR"
python -m acg_tpu_torch "$MATRIX" \
    "${PARTS_FLAGS[@]}" \
    --max-iterations 400 --residual-rtol 1e-8 --warmup 0 --quiet \
    --ckpt "$DIR/ck" --ckpt-every 8 \
    --audit-every 5 --abft \
    --chaos "$SPEC" --relaunch-backoff 0 \
    --history "$DIR/history" \
    --metrics-file "$DIR/chaos.prom" \
    "$@"
rc=$?
if [ $rc -eq 96 ]; then
    echo "torch_chaos.sh: WRONG-ANSWER-GREEN detected (exit 96) -- see $DIR"
elif [ $rc -ne 0 ]; then
    echo "torch_chaos.sh: campaign driver failed (exit $rc)"
else
    echo "torch_chaos.sh: campaign clean (ledger: $DIR/history)"
fi
exit $rc
