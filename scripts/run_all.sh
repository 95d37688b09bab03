#!/usr/bin/env bash
# Build + test + chip checks (reference: scripts/run_all.sh).
# Usage: scripts/run_all.sh [outdir]
# The GPU steps run one after another: each JAX process reserves most of
# the card's memory, so no two may hold it at once.
set -euo pipefail
cd "$(dirname "$0")/.."
OUT="${1:-out/$(date +%Y%m%d_%H%M%S)}"
mkdir -p "$OUT"

echo "== environment =="
python -m crlot_tpu.profiling | tee "$OUT/env.json"

echo "== native build =="
python -c "from crlot_tpu.io.native import native_available; print('native:', native_available())"

echo "== tests (CPU, correctness-gate lane) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow" 2>&1 | tee "$OUT/tests.txt"

echo "== tests (CPU, slow lane) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m slow 2>&1 | tee "$OUT/tests_slow.txt"

echo "== GPU: main path at real size =="
python chip_smoke.py 2>&1 | tee "$OUT/chip_smoke.txt"

echo "== GPU: tests that need the card =="
JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu -p no:cacheprovider 2>&1 | tee "$OUT/tests_gpu.txt"

echo "== GPU: headline bench =="
python bench.py | tee "$OUT/bench.json"
