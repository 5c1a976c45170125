"""The port's non-package files under moolint, in tier-1: its tests
(``tests/test_torch_*.py``), the root ``*_torch.py`` benches and
``chip_smoke.py``, against their own empty baseline
(``moolib_tpu_torch/analysis/baseline_tools.json``). One uncached sweep
per module feeds the three tests, as in ``test_torch_lint_port.py``."""

from pathlib import Path

import pytest

from test_torch_lint_port import BUDGET_FACTOR, BUDGET_FLOOR_S, sweep

REPO_ROOT = Path(__file__).resolve().parent.parent
BASELINE_TOOLS = REPO_ROOT / "moolib_tpu_torch" / "analysis" / \
    "baseline_tools.json"


def non_package_files():
    return (sorted((REPO_ROOT / "tests").glob("test_torch_*.py"))
            + sorted(REPO_ROOT.glob("*_torch.py"))
            + [REPO_ROOT / "chip_smoke.py"])


@pytest.fixture(scope="module")
def tools_sweep():
    return sweep(["--baseline", BASELINE_TOOLS, *non_package_files()])


def test_the_non_package_files_are_clean_against_their_baseline(tools_sweep):
    report = tools_sweep["report"]
    assert report["new"] == [], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in report["new"])
    assert report["findings"] == []


def test_cli_over_the_non_package_files_exits_zero(tools_sweep):
    assert tools_sweep["rc"] == 0
    linted = {f.name for f in non_package_files()}
    assert {"chip_smoke.py", "bench_torch.py", "test_torch_lint.py"} <= linted


def test_non_package_sweep_runtime_budget(tools_sweep):
    budget = max(BUDGET_FLOOR_S, BUDGET_FACTOR * tools_sweep["t_ref"])
    print(f"moolint sweep of the non-package files: "
          f"{tools_sweep['elapsed']:.1f} s (parse reference "
          f"{tools_sweep['t_ref']:.3f} s, budget {budget:.1f} s)")
    assert tools_sweep["elapsed"] < budget, (
        f"moolint over the port's non-package files took "
        f"{tools_sweep['elapsed']:.1f}s (budget {budget:.1f}s)")
