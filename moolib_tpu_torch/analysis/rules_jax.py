"""Capture hygiene of the port: the torch counterpart of
:mod:`moolib_tpu.analysis.rules_jax`.

The reference polices code traced under ``jax.jit``. Its torch analogue
is a **captured region**: a function given to or decorated with
``torch.compile`` (whose body dynamo traces into a graph), or the body of
``with torch.cuda.graph(...)`` (whose kernels are recorded once and
replayed). A host sync inside one either breaks the graph, fails the
capture, or pins the hot path to the host; Python-side randomness runs
once at capture time and replays the same numbers. These rules find both
classes statically.

Regions are found lexically: functions decorated with ``torch.compile``
(bare, called, or through ``functools.partial``), functions passed by
name to a ``torch.compile(...)`` call, every ``with torch.cuda.graph``
body, and everything nested inside either. The port builds its CUDA
kernels from source and calls no ``torch.compile`` today, so these rules
guard code yet to come.

``jit-missing-static`` has no counterpart (:data:`NOT_PORTED`): the port
specializes nothing at trace time; its kernel builds are counted at run
time by :mod:`moolib_tpu_torch.analysis.recompile_guard`.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from .engine import Finding, ModuleContext, Rule
from .engine import terminal_name as _terminal_name

__all__ = ["NOT_PORTED", "RULES", "captured_regions", "traced_functions"]


def _numpy_aliases(ctx: ModuleContext) -> Set[str]:
    """Names the module binds to the numpy module (np, onp, numpy...).
    Memoized on the context, like every import table of these families:
    the rules consult them once per node."""
    cached = getattr(ctx, "_numpy_aliases", None)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "numpy":
                    out.add(alias.asname or alias.name.split(".")[0])
    ctx._numpy_aliases = out
    return out


def _torch_aliases(ctx: ModuleContext) -> Set[str]:
    """Names the module binds to the torch module (``torch``, ``th``)."""
    cached = getattr(ctx, "_torch_aliases", None)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch" or (alias.name.startswith("torch.")
                                             and alias.asname is None):
                    out.add(alias.asname or "torch")
    ctx._torch_aliases = out
    return out


def _from_torch(ctx: ModuleContext, module: str) -> Dict[str, str]:
    """local name -> original name for ``from <module> import ...``
    anywhere in the module (function-local imports included)."""
    tables = ctx.__dict__.setdefault("_from_imports", {})
    if module not in tables:
        out: Dict[str, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == module \
                    and node.level == 0:
                for alias in node.names:
                    out[alias.asname or alias.name] = alias.name
        tables[module] = out
    return tables[module]


def _is_compile_fn(ctx: ModuleContext, node: ast.expr) -> bool:
    """Does ``node`` name ``torch.compile`` itself?"""
    if isinstance(node, ast.Attribute) and node.attr == "compile":
        return isinstance(node.value, ast.Name) \
            and node.value.id in _torch_aliases(ctx)
    if isinstance(node, ast.Name):
        return _from_torch(ctx, "torch").get(node.id) == "compile"
    return False


def _is_compile_expr(ctx: ModuleContext, node: ast.expr) -> bool:
    """Does ``node`` evaluate to a torch.compile transform? Covers
    ``torch.compile``, ``torch.compile(mode=...)`` and
    ``functools.partial(torch.compile, ...)``."""
    if _is_compile_fn(ctx, node):
        return True
    if isinstance(node, ast.Call):
        if _is_compile_fn(ctx, node.func) and not node.args:
            return True  # @torch.compile(mode=...)
        if _terminal_name(node.func) == "partial" and node.args:
            return _is_compile_fn(ctx, node.args[0])
    return False


def traced_functions(ctx: ModuleContext) -> List[ast.AST]:
    """FunctionDef/AsyncFunctionDef nodes whose bodies torch.compile
    traces: decorated with it, or passed BY NAME to a ``torch.compile``
    call anywhere in the module. (The reference's name, so the wire
    family's tracer leg reads the port's regions unchanged.)"""
    cached = getattr(ctx, "_captured_functions", None)
    if cached is not None:
        return cached
    named: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _is_compile_fn(ctx, node.func) \
                and node.args and isinstance(node.args[0], ast.Name):
            named.add(node.args[0].id)
    out: List[ast.AST] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in named or any(_is_compile_expr(ctx, dec)
                                     for dec in node.decorator_list):
            out.append(node)
    ctx._captured_functions = out
    return out


def _is_graph_capture(ctx: ModuleContext, expr: ast.expr) -> bool:
    """``torch.cuda.graph(...)`` (or ``graph(...)`` from torch.cuda)."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute) and f.attr == "graph":
        v = f.value
        if isinstance(v, ast.Attribute) and v.attr == "cuda":
            return isinstance(v.value, ast.Name) \
                and v.value.id in _torch_aliases(ctx)
        return isinstance(v, ast.Name) \
            and _from_torch(ctx, "torch").get(v.id) == "cuda"
    if isinstance(f, ast.Name):
        return _from_torch(ctx, "torch.cuda").get(f.id) == "graph"
    return False


def captured_regions(ctx: ModuleContext) -> List[ast.AST]:
    """Every captured region's root: the compiled functions and the
    ``with torch.cuda.graph(...)`` statements."""
    out: List[ast.AST] = list(traced_functions(ctx))
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_capture(ctx, item.context_expr)
                for item in node.items):
            out.append(node)
    return out


def _region_subtree(roots: Iterable[ast.AST]) -> Iterable[ast.AST]:
    """Every node lexically inside any region (nested defs and lambdas
    INCLUDED: they run during the same capture). A ``with`` region
    contributes its body, not its header."""
    seen = set()
    for root in roots:
        starts = root.body if isinstance(root, (ast.With, ast.AsyncWith)) \
            else [root]
        for start in starts:
            for node in ast.walk(start):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield node


_REGION = ("inside a captured region (a torch.compile graph break, or "
           "illegal under CUDA graph capture)")
_HOST_SYNC_METHODS = {
    "item": f"`.item()` forces a device->host sync {_REGION}",
    "tolist": f"`.tolist()` forces a device->host sync {_REGION}",
    "cpu": f"`.cpu()` copies to the host synchronously {_REGION}",
    "numpy": f"`.numpy()` materializes on the host {_REGION}",
    "synchronize": f"`.synchronize()` blocks the host on the card "
                   f"{_REGION}",
}
_HOST_CASTS = {"float", "int", "bool"}
_NUMPY_MATERIALIZERS = {"asarray", "array", "copy"}


class HostSyncInJit(Rule):
    name = "host-sync-in-jit"
    description = (
        "host-synchronizing operation (float()/int()/bool()/.item()/"
        ".tolist()/.cpu()/.numpy()/np.asarray()/np.array()/"
        "torch.cuda.synchronize()) inside a captured region — a function "
        "given to torch.compile or a `with torch.cuda.graph(...)` body: "
        "it breaks the graph, fails the capture, or pins the hot path to "
        "the host."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        regions = captured_regions(ctx)
        if not regions:
            return
        np_aliases = _numpy_aliases(ctx)
        for node in _region_subtree(regions):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in _HOST_CASTS and node.args \
                    and not isinstance(node.args[0], ast.Constant):
                yield self.finding(
                    ctx, node,
                    f"{f.id}() on a captured value forces a host sync "
                    f"{_REGION}; keep it a tensor on the card",
                )
            elif isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_METHODS:
                yield self.finding(ctx, node, _HOST_SYNC_METHODS[f.attr])
            elif (isinstance(f, ast.Attribute)
                  and f.attr in _NUMPY_MATERIALIZERS
                  and isinstance(f.value, ast.Name)
                  and f.value.id in np_aliases):
                yield self.finding(
                    ctx, node,
                    f"{f.value.id}.{f.attr}() materializes a captured "
                    "value on the host; use torch ops inside a captured "
                    "region",
                )


class PythonRandomInJit(Rule):
    name = "python-random-in-jit"
    description = (
        "Python `random` / `np.random` inside a captured region runs once "
        "at capture time: a CUDA graph replays the same 'random' numbers "
        "on every launch, and torch.compile bakes or guards on them. Draw "
        "with torch and an explicit generator instead."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        regions = captured_regions(ctx)
        if not regions:
            return
        np_aliases = _numpy_aliases(ctx)
        for node in _region_subtree(regions):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            base = f.value
            # random.<fn>(...)
            if isinstance(base, ast.Name) and base.id == "random":
                yield self.finding(
                    ctx, node,
                    f"random.{f.attr}() runs at capture time, not per "
                    "call; use torch sampling with an explicit generator",
                )
            # np.random.<fn>(...) / np.random.default_rng(...).<fn>
            elif (isinstance(base, ast.Attribute) and base.attr == "random"
                  and isinstance(base.value, ast.Name)
                  and base.value.id in np_aliases):
                yield self.finding(
                    ctx, node,
                    f"{base.value.id}.random.{f.attr}() runs at capture "
                    "time, not per call; use torch sampling with an "
                    "explicit generator",
                )


RULES = [HostSyncInJit, PythonRandomInJit]

#: Reference rules of this family without a torch counterpart.
NOT_PORTED: Dict[str, str] = {
    "jit-missing-static": (
        "the port does no trace-time specialization: it calls no jit, so "
        "a Python scalar argument never keys a recompile. What it does "
        "build (its CUDA kernel libraries, once per process) "
        "recompile_guard counts at run time (guarded_jit, "
        "recompile_budget)."
    ),
}
