#!/usr/bin/env bash
# The port's CI entry point, the twin of the reference's tools/ci_check.sh:
# moolint static analysis first (a new finding is reported in seconds),
# then the port's lint tests and the perf smoke. Runs on the CPU:
#   bash moolib_tpu_torch/tools/ci_check.sh
set -euo pipefail
cd "$(dirname "$0")/../.."

# On GitHub runners, emit ::error workflow annotations so new findings
# surface inline on the PR diff; plain text everywhere else.
fmt=text
if [ -n "${GITHUB_ACTIONS:-}" ]; then fmt=gha; fi

echo "== moolint: moolib_tpu_torch/ =="
# --rule-times: the per-rule wall time rides the run that lints the tree
# anyway, so a rule that goes quadratic shows here before the lint
# test's runtime budget catches it.
python -m moolib_tpu_torch.tools.moolint --check --format="$fmt" \
  --rule-times moolib_tpu_torch/

echo "== moolint: the port's tests, benches and chip_smoke.py =="
# The non-package files are held to their own (empty) baseline, so debt
# there can never hide behind the package's, and vice versa.
python -m moolib_tpu_torch.tools.moolint --check --format="$fmt" \
  --baseline moolib_tpu_torch/analysis/baseline_tools.json \
  tests/test_torch_*.py ./*_torch.py chip_smoke.py

echo "== moolint: baselines must stay empty =="
python -m moolib_tpu_torch.tools.moolint --baseline-stats --fail-nonempty
python -m moolib_tpu_torch.tools.moolint --baseline-stats --fail-nonempty \
  --baseline moolib_tpu_torch/analysis/baseline_tools.json

echo "== lint tests =="
# The parity corpus against the reference's rules, the torch families,
# recompile_guard, the CLI, and the whole-port sweeps.
timeout -k 10 600 env JAX_PLATFORMS=cpu python -m pytest \
  tests/test_torch_lint*.py -q -p no:cacheprovider

echo "== perf smoke =="
# telemetry_smoke: a live __telemetry scrape of a two-Rpc cohort plus the
# disabled-mode overhead budget; perf --suite cpu-proxy --smoke: the
# CPU-proxy rows, gated on their budgets and the trend store's
# regression detector (the device rows on the CPU here).
python -m moolib_tpu_torch.tools.telemetry_smoke
timeout -k 10 420 python -m moolib_tpu_torch.tools.perf \
  --suite cpu-proxy --smoke --device cpu
