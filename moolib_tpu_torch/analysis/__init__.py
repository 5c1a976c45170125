"""Static analysis of the port; the counterpart of
:mod:`moolib_tpu.analysis`, so far the lint engine (:mod:`.engine`) and
its race family (:mod:`.rules_race`: guarded fields, atomicity, lock
order, and :func:`~.rules_race.static_lock_edges`, the superset the
dynamic mirror :mod:`moolib_tpu_torch.testing.locktrace` checks its
observed edges against). The other families, baselines and the moolint
CLI are still to port (ROADMAP.md queue A, item 12).

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
    lint_paths,
    lint_source,
)
from .rules_race import static_lock_edges

__all__ = [
    "Finding",
    "LintError",
    "ModuleContext",
    "ProjectIndex",
    "Rule",
    "all_rules",
    "lint_paths",
    "lint_source",
    "static_lock_edges",
]
