#!/usr/bin/env bash
# Fast static gate for the port: its determinism/SPMD-safety analyzer
# plus a syntax pass over lddl_tpu_torch (pyflakes when available,
# compileall otherwise). Counterpart of tools/ci_check.sh.
#
# Two modes:
#   lddl_tpu_torch/tools/ci_check.sh         pre-commit default: report
#                                            findings only for files changed
#                                            vs git HEAD (the flow analysis
#                                            still spans the whole tree, and
#                                            the content-hash cache makes
#                                            the warm run sub-second)
#   lddl_tpu_torch/tools/ci_check.sh --full  full-tree report + the
#                                            lddl_tpu_torch_check.sarif
#                                            artifact at the repo root (read
#                                            by lddl_tpu_torch.tools.
#                                            pipeline_status)
#
# Extra arguments after the mode flag pass through to
# lddl_tpu_torch.tools.lddl_check.
#
# Opt-in blocks, in the reference's order, each gating when asked for:
#   LDDL_TPU_CI_SMOKE_BENCH=1     the six identity smokes
#                                 (python -m lddl_tpu_torch.tools.<name>_smoke
#                                 for sink, elastic, backend, thread, status,
#                                 cache)
#   LDDL_TPU_CI_SMOKE_NATIVE=1    build the native engine, then the
#                                 fused/staged/hf shard identity test
#   LDDL_TPU_CI_SMOKE_SANITIZE=1  the sanitizer smoke
#                                 (python -m lddl_tpu_torch.tools.sanitize_smoke):
#                                 the native engine rebuilt under TSan+UBSan
#                                 and the 1-vs-N thread identity suite run
#                                 against it
set -euo pipefail
cd "$(dirname "$0")/../.."

MODE="changed"
if [ "${1:-}" = "--full" ]; then
    MODE="full"
    shift
fi

if [ "$MODE" = "full" ]; then
    python -m lddl_tpu_torch.tools.lddl_check \
        --sarif lddl_tpu_torch_check.sarif "$@"
    echo "ci_check: SARIF artifact written to lddl_tpu_torch_check.sarif"
else
    python -m lddl_tpu_torch.tools.lddl_check --changed-only "$@"
fi

if python -c "import pyflakes" >/dev/null 2>&1; then
    python -m pyflakes lddl_tpu_torch
else
    python -m compileall -q lddl_tpu_torch
fi
# Opt-in identity smokes: each runs one small corpus through two settings
# that must give the same bytes (serial/async sink, legacy/batched elastic
# coordination, local/mock store, 1/N native threads, sync/prefetch+cache
# loader on a latency-injected store) or holds pipeline_status's exit-code
# contract, and exits nonzero on a divergence or a crash. The timings they
# print are informational. Opt-in because together they take minutes.
if [ "${LDDL_TPU_CI_SMOKE_BENCH:-0}" = "1" ]; then
    for smoke in sink elastic backend thread status cache; do
        if python -m "lddl_tpu_torch.tools.${smoke}_smoke"; then
            echo "ci_check: ${smoke} smoke OK (timings non-gating)"
        else
            echo "ci_check: ${smoke} smoke FAILED: a divergence, a broken contract or a crash" >&2
            exit 1
        fi
    done
fi

# Opt-in native-engine smoke: builds the C++ engine from its sources, then
# holds the masked, binned, schema-v2 shards of the fused, staged and hf
# rungs byte-equal. A failed build fails the block: the port never falls to another engine on its own.
if [ "${LDDL_TPU_CI_SMOKE_NATIVE:-0}" = "1" ]; then
    python -m lddl_tpu_torch.native.build
    python -m pytest tests/test_torch_smokes_preprocess.py -q \
        -k "identity_smoke" -p no:cacheprovider
    echo "ci_check: native fused identity smoke passed"
fi

# Opt-in sanitizer smoke: rebuilds the native engine under TSan+UBSan
# (its own library, so the normal build is untouched) and runs the 1-vs-N
# thread identity suite against it. It fails on any sanitizer report, a
# failed instrumented build, or a sanitized engine that does not load.
# Opt-in because the instrumented build and the slowed suite take about a
# minute; the static gate itself stays within seconds.
if [ "${LDDL_TPU_CI_SMOKE_SANITIZE:-0}" = "1" ]; then
    if python -m lddl_tpu_torch.tools.sanitize_smoke; then
        echo "ci_check: sanitize smoke passed (TSan+UBSan, zero reports)"
    else
        echo "ci_check: sanitize smoke FAILED: a sanitizer report or an instrumented build/load failure" >&2
        exit 1
    fi
fi
echo "ci_check: OK"
