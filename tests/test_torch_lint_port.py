"""The whole port under moolint, in tier-1: ``moolib_tpu_torch/`` against
its empty baseline (``moolib_tpu_torch/analysis/baseline.json``). One
uncached sweep per module, through the CLI's own ``main``, feeds the
three tests: the tree is clean, the CLI exits 0, and the sweep stays
inside a load-compensated runtime budget. The non-package files have
their own module (``test_torch_lint_port_tools.py``), so that xdist's
``--dist loadfile`` runs the two sweeps side by side."""

import ast
import contextlib
import io
import json
import time
from pathlib import Path

import pytest

from moolib_tpu_torch.tools import moolint

REPO_ROOT = Path(__file__).resolve().parent.parent

#: The budget: this many times a fixed parse workload timed under the
#: same load (moolint is parse/AST bound, so the two slow down together).
#: On an idle 8-core CPU box the package sweep took ~27 s against a
#: ~0.37 s reference (~73x): 150x leaves ~2x headroom for growth.
BUDGET_FACTOR = 150.0
BUDGET_FLOOR_S = 60.0


def parse_reference_seconds() -> float:
    src = (REPO_ROOT / "moolib_tpu_torch" / "rpc" / "rpc.py").read_text()
    t0 = time.monotonic()
    for _ in range(10):
        ast.parse(src)
    return time.monotonic() - t0


def sweep(argv) -> dict:
    """One uncached moolint run in this process: its exit code, its JSON
    report, its wall time and the parse reference around it."""
    t_ref = parse_reference_seconds()
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = moolint.main(["--check", "--json", "--rule-times", "--no-cache",
                           *map(str, argv)])
    elapsed = time.monotonic() - t0
    t_ref = max(t_ref, parse_reference_seconds())
    return dict(rc=rc, report=json.loads(out.getvalue()), elapsed=elapsed,
                t_ref=t_ref)


@pytest.fixture(scope="module")
def package_sweep():
    return sweep([REPO_ROOT / "moolib_tpu_torch"])


def test_the_package_is_clean_against_its_empty_baseline(package_sweep):
    report = package_sweep["report"]
    assert report["new"] == [], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in report["new"])
    assert report["findings"] == []
    assert report["fixed_baseline_entries"] == []


def test_cli_over_the_package_exits_zero(package_sweep):
    assert package_sweep["rc"] == 0
    # Every registered rule ran over the tree.
    assert set(package_sweep["report"]["rule_seconds"]) == {
        r.name for r in moolint.all_rules()}


def test_package_sweep_runtime_budget(package_sweep):
    budget = max(BUDGET_FLOOR_S, BUDGET_FACTOR * package_sweep["t_ref"])
    print(f"moolint sweep of moolib_tpu_torch/: "
          f"{package_sweep['elapsed']:.1f} s (parse reference "
          f"{package_sweep['t_ref']:.3f} s, budget {budget:.1f} s)")
    assert package_sweep["elapsed"] < budget, (
        f"moolint over moolib_tpu_torch/ took "
        f"{package_sweep['elapsed']:.1f}s (budget {budget:.1f}s = "
        f"{BUDGET_FACTOR:.0f}x the {package_sweep['t_ref']:.2f}s parse "
        "reference); profile the slowest rule with --rule-times")
