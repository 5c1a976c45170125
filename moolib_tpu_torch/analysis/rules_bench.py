"""Benchmark hygiene rules.

One invariant, enforced where numbers are born: durations in bench/tools
code must come from ``time.perf_counter()`` (or the harness timers built
on it), never ``time.time()``. The wall clock steps — NTP slew, manual
sets, leap smearing — and a stepped interval silently corrupts a
benchmark sample; the monotonic high-resolution clock cannot step. Wall
timestamps as *placement* (artifact stamps, trend-row ``t`` fields,
cross-host trace alignment) are legitimate and stay unflagged: the rule
fires only when a ``time.time()`` value flows into a subtraction — the
duration idiom.

Scope: benchmark-bearing trees only (``tools/``, ``moolib_tpu_torch/bench/``,
``moolib_tpu_torch/tools/``,
root-level ``bench*.py`` scripts, and the shared timing module
``moolib_tpu_torch/utils/benchmark.py``). Elsewhere ``time.time()`` has
legitimate duration-free uses the rule should not police.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from .engine import Finding, ModuleContext, Rule, iter_scoped, iter_scoped_body

__all__ = ["RULES", "is_bench_path"]


def is_bench_path(relpath: str) -> bool:
    """Is this file part of the measurement surface the rule polices?
    ``tools/``, ``moolib_tpu_torch/bench/``, ``moolib_tpu_torch/tools/``,
    the shared timing module, and
    ROOT-level ``bench*.py`` scripts only — a bench-named file deeper in
    the package (an example, a test helper) is not automatically a
    benchmark and stays out of scope."""
    if relpath.startswith(("tools/", "moolib_tpu_torch/bench/",
                           "moolib_tpu_torch/tools/")):
        return True
    if relpath == "moolib_tpu_torch/utils/benchmark.py":
        return True
    return ("/" not in relpath and relpath.startswith("bench")
            and relpath.endswith(".py"))


def _is_time_time(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "time"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "time"
    )


class BenchWallclock(Rule):
    name = "bench-wallclock"
    description = (
        "duration measured with time.time() in bench/tools code — the "
        "wall clock steps (NTP, manual set) and silently corrupts the "
        "sample; use time.perf_counter() or the harness timer "
        "(moolib_tpu_torch.bench.harness.clock / measure). Flags time.time() "
        "values flowing into a subtraction; wall timestamps used as "
        "placement (artifact stamps) stay unflagged."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not is_bench_path(ctx.relpath):
            return
        # Each execution scope separately: a name bound to time.time() in
        # one function says nothing about the same name elsewhere.
        scopes: List[ast.AST] = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))
        ]
        for scope in scopes:
            yield from self._check_scope(ctx, scope)

    def _check_scope(self, ctx: ModuleContext,
                     scope: ast.AST) -> Iterable[Finding]:
        if isinstance(scope, ast.Module):
            nodes = list(iter_scoped_body(scope.body))
        else:
            nodes = [n for n in iter_scoped(scope) if n is not scope]
        # Pass 1: every simple-name assignment, ordered by line, marking
        # whether it binds a time.time() value. Ordering matters: a name
        # rebound to a wall stamp AFTER a perf_counter duration must not
        # retroactively taint the earlier subtraction (and vice versa a
        # perf_counter rebind clears the taint going forward).
        assigns: Dict[str, List[Tuple[int, bool]]] = {}
        for n in nodes:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        assigns.setdefault(t.id, []).append(
                            (n.lineno, _is_time_time(n.value)))
            elif (isinstance(n, ast.AnnAssign) and n.value is not None
                  and isinstance(n.target, ast.Name)):
                assigns.setdefault(n.target.id, []).append(
                    (n.lineno, _is_time_time(n.value)))
        for history in assigns.values():
            history.sort()

        def _is_wall(e: ast.expr, at_line: int) -> bool:
            if _is_time_time(e):
                return True
            if not isinstance(e, ast.Name):
                return False
            # Latest binding strictly before the use decides (same-line
            # assignments are the use's own statement, not its input).
            prior = [w for line, w in assigns.get(e.id, ()) if line < at_line]
            return bool(prior) and prior[-1]

        # Pass 2: a subtraction touching a wall-clock value is a duration.
        for n in nodes:
            if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                    and (_is_wall(n.left, n.lineno)
                         or _is_wall(n.right, n.lineno))):
                yield self.finding(
                    ctx, n,
                    "duration computed from time.time(); use "
                    "time.perf_counter() (or the harness timer) — the "
                    "wall clock steps and corrupts interval math",
                )


RULES = [BenchWallclock]
