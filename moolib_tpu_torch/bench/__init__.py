"""perfwatch of the port: the benchmark harness, the CPU-proxy suite,
telemetry-derived budgets, and the append-only trend store + regression
detector; the counterpart of :mod:`moolib_tpu.bench`.

One CLI fronts all of it: ``python -m moolib_tpu_torch.tools.perf``. The
card benchmarks (``bench_torch.py``, ``bench_e2e_torch.py``,
``bench_allreduce_torch.py``, the ``tools/`` benches) keep their one-line
JSON contracts while feeding the same trend schema through
:func:`~moolib_tpu_torch.bench.harness.maybe_append_trend`.

Importing this package imports no torch (an ``EnvPool`` worker unpickles
the suite's ``TrivialEnv``).
"""

from .harness import (
    SCHEMA_VERSION,
    BenchResult,
    append_device_trend,
    clock,
    env_fingerprint,
    maybe_append_trend,
    measure,
    parse_result,
    trimmed_stats,
)
from .budgets import CPU_PROXY_BUDGETS, Budget, BudgetBreach, evaluate_budgets
from .suite import CPU_PROXY_SUITE, run_suite
from .trends import Regression, append_trend, detect_regressions, load_trends

__all__ = [
    "SCHEMA_VERSION",
    "BenchResult",
    "Budget",
    "BudgetBreach",
    "CPU_PROXY_BUDGETS",
    "CPU_PROXY_SUITE",
    "Regression",
    "append_device_trend",
    "append_trend",
    "clock",
    "detect_regressions",
    "env_fingerprint",
    "evaluate_budgets",
    "load_trends",
    "maybe_append_trend",
    "measure",
    "parse_result",
    "run_suite",
    "trimmed_stats",
]
