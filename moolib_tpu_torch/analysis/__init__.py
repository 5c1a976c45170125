"""moolint of the port: static analysis for async-RPC safety, capture
hygiene, mesh/collective consistency, RPC round and wire balance,
benchmark timing, threading races, resource lifecycles, hot-path
device/host discipline and numerics; the counterpart of
:mod:`moolib_tpu.analysis`.

Ten rule families, each a module here:

- :mod:`.rules_async`, :mod:`.rules_bench`, :mod:`.rules_lifecycle`,
  :mod:`.rules_protocol`, :mod:`.rules_wire` and :mod:`.rules_race` are
  the reference's own (they never touched JAX), with the reference's
  rule names, messages and suppression grammars; only their package
  paths name the port's;
- :mod:`.rules_jax` (captured regions: ``torch.compile`` and
  ``torch.cuda.graph``), :mod:`.rules_hot` (the step loop around the
  port's step factories and ``nn.Module`` calls, mirrored at run time
  by :mod:`moolib_tpu_torch.testing.hotwatch`), :mod:`.rules_num`
  (generator seeding, global samplers, bf16 reductions and promotion,
  hash-ordered reductions; mirrored by
  :mod:`moolib_tpu_torch.testing.paritywatch`) and
  :mod:`.rules_sharding` (axis names against the ``(dp, tp, sp, pp,
  ep)`` ``DeviceMesh``) are torch counterparts. A reference rule without
  one is listed, with its reason, by
  :func:`~.engine.not_ported_rules`.

The families lean on the interprocedural layer in :mod:`.engine` (per
module symbol tables and a project index, one import hop deep) and its
project-wide endpoint registry; :func:`~.engine.lint_paths` caches
per-file results, and baselines grandfather findings (the port's two
ship empty).

Entry points:

- ``python -m moolib_tpu_torch.tools.moolint moolib_tpu_torch/`` — the
  CLI (``--check``, ``--json``, ``--baseline-update``, ``--list-rules``,
  ``--explain``, ``--diff``);
- ``moolib_tpu_torch/tools/ci_check.sh`` — the port's CI entry point;
- :mod:`.recompile_guard` — the runtime companion, pinning kernel-build
  counts.

This package imports neither torch nor the RPC stack: linting a tree
runs from any process.
"""

from .engine import (
    Finding,
    LintError,
    ModuleContext,
    ProjectIndex,
    Rule,
    all_rules,
    diff_against_baseline,
    findings_to_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    not_ported_rules,
    save_baseline,
)
from .recompile_guard import (
    RecompileBudgetExceeded,
    RecompileGuard,
    compile_count,
    guarded_jit,
    kernel_builds,
    recompile_budget,
)
from .rules_race import static_lock_edges

__all__ = [
    "Finding",
    "LintError",
    "ModuleContext",
    "ProjectIndex",
    "Rule",
    "all_rules",
    "diff_against_baseline",
    "findings_to_baseline",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "not_ported_rules",
    "save_baseline",
    "static_lock_edges",
    "RecompileBudgetExceeded",
    "RecompileGuard",
    "compile_count",
    "guarded_jit",
    "kernel_builds",
    "recompile_budget",
]
