"""RPC wire-surface consistency rules.

The moolib design hangs everything off a stringly-typed RPC surface:
handlers are registered by name (``rpc.define("GroupService::update",
...)``) and invoked by name from other processes
(``rpc.async_("learner", "unroll", ...)``) — so a typo'd endpoint, an
arity drift between caller and handler, or an unpicklable payload only
fails at runtime on a live cohort. These rules check the wire contract
statically against the project-wide **endpoint registry** the engine
builds from every ``define``/``define_queue``/``define_deferred`` call
(:meth:`ProjectIndex.endpoints`), with f-string names abstracted to
wildcard patterns so ``f"{name}::step"`` registrations match literal and
f-string call sites by pattern overlap.

Rules:

- ``rpc-endpoint-unknown``: an ``async_``/``sync``/``async_callback``
  call names an endpoint no linted module defines — the call can only
  ever produce "function not found" on a live peer.
- ``rpc-endpoint-arity``: a call site resolving to exactly ONE
  registration with a known handler signature passes a payload the
  handler provably cannot accept (too many positionals, an unknown
  keyword, a missing required parameter). Batch/pad handlers take the
  same per-call signature (stacking preserves arity); deferred handlers
  have their leading handle parameter dropped; queues accept anything.
- ``rpc-define-collision``: the same fully-literal name is defined twice
  on one receiver in one registration scope — the second ``define``
  silently replaces the first handler (both hash to the same fid).
- ``rpc-payload-unserializable``: a payload argument is provably outside
  ``rpc/serial.py``'s encode set AND unpicklable — a lambda, a generator
  expression, a lock/thread/event, an open file, or a traced value (an
  RPC dispatch inside a function torch.compile traces ships abstract
  values; the regions come from the port's :mod:`.rules_jax`).
- ``rpc-result-no-timeout``: a bare ``.result()`` on a Future whose
  dataflow origin is an RPC/Group/Accumulator call — the distributed-hang
  class: if the peer (or the local IO loop) dies at the wrong moment the
  waiter blocks forever with no error path. ``timeout=0`` polling (any
  timeout argument) is exempt; deliberate sites carry per-line
  suppressions. Origins flow through local assignments, ``self.<attr>``
  assignments in the same function, and one hop through the returns of
  module-local (or one-import-hop) functions.

Everything here is best-effort on literals: an unresolvable name, an
ambiguous pattern match, or an unknown handler silences the rule — the
wire rules only speak when the violation is provable.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .engine import (
    ENDPOINT_DEFINERS,
    WILDCARD,
    Finding,
    ModuleContext,
    Rule,
    iter_scoped_body,
    name_pattern,
    pattern_display,
    patterns_overlap,
    receiver_name,
    returned_calls,
)
from .engine import terminal_name as _terminal_name

__all__ = ["RULES"]

# Client-side call surface: method name -> index of the first PAYLOAD
# argument (the endpoint name sits at index 1 for all of them;
# call_with_deadline carries the budget at index 2, async_callback the
# callback at index 2 — payload starts after those).
_PAYLOAD_START = {"async_": 2, "sync": 2, "async_callback": 3,
                  "call_with_deadline": 3}

# Endpoints the library itself defines: the telemetry export surface
# every Rpc auto-defines at construction, plus the serving tier's
# ``{service}.*`` family (moolib_tpu_torch/serving/replica.py registers them
# from f-strings, so tools/tests lint runs — which do not see the
# package's defines — must still resolve literal call sites like
# ``"serve.health"``). The serving entries use the engine's WILDCARD
# (the f-string-hole abstraction), matching any service prefix.
_BUILTIN_ENDPOINTS = (
    "__telemetry",
    "__flightrec",
    WILDCARD + ".infer",
    WILDCARD + ".health",
    WILDCARD + ".load",
    WILDCARD + ".drain",
    # The statestore wire family (moolib_tpu_torch/statestore/store.py):
    # literal call sites in tools/tests must resolve even when the
    # defining module is outside the lint run.
    "StateStoreService::" + WILDCARD,
    # The fleet wire family (moolib_tpu_torch/fleet/controller.py): every
    # fleet role peer defines fleet.ping/fleet.role_info, the
    # controller defines fleet.status — same out-of-run resolution
    # problem as the serving family for tools/tests call sites.
    "fleet." + WILDCARD,
)


def _call_sites(
    ctx: ModuleContext,
) -> Iterator[Tuple[ast.Call, str, Optional[str]]]:
    """(call, method, name pattern or None) for every RPC call site.

    Only attribute calls count (``rpc.async_``, ``self.rpc.sync``) — a
    bare ``sync(...)`` name is some other function. A None pattern means
    the endpoint-name expression was not a literal/f-string."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        method = node.func.attr
        if method not in _PAYLOAD_START or len(node.args) < 2:
            continue
        yield node, method, name_pattern(node.args[1])


class RpcEndpointUnknown(Rule):
    name = "rpc-endpoint-unknown"
    description = (
        "an async_/sync/async_callback call names an endpoint no linted "
        "module defines (define/define_queue/define_deferred, f-string "
        "registrations matched by pattern overlap): the call can only "
        "fail with 'function not found' on a live peer. Silent when the "
        "lint run sees no registrations at all."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        endpoints = ctx.project.endpoints()
        if not endpoints:
            return  # partial view (no defines in scope): cannot judge
        patterns = [e.pattern for e in endpoints]
        # Every Rpc defines these on itself at construction (rpc/rpc.py),
        # so they resolve on any live peer even when rpc.py sits outside
        # this lint run (tools/ and tests/ are linted separately).
        patterns.extend(_BUILTIN_ENDPOINTS)
        for node, _method, pat in _call_sites(ctx):
            if pat is None:
                continue
            if not any(patterns_overlap(pat, p) for p in patterns):
                yield self.finding(
                    ctx, node,
                    f"endpoint {pattern_display(pat)!r} is not defined by "
                    f"any linted module ({len(endpoints)} registrations "
                    "checked); typo'd name, or the defining module is "
                    "outside this lint run",
                )


class RpcEndpointArity(Rule):
    name = "rpc-endpoint-arity"
    description = (
        "the payload of an async_/sync/async_callback call provably "
        "mismatches the resolved handler's signature (too many "
        "positionals, unknown keyword, or a missing required parameter). "
        "Only fires when the name resolves to exactly one registration "
        "with a known handler; batch/pad handlers keep per-call arity, "
        "deferred handlers drop the handle parameter, queues are exempt."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        endpoints = ctx.project.endpoints()
        if not endpoints:
            return
        for node, method, pat in _call_sites(ctx):
            if pat is None:
                continue
            matches = [
                e for e in endpoints if patterns_overlap(pat, e.pattern)
            ]
            if len(matches) != 1:
                continue  # unknown (other rule) or ambiguous: don't guess
            sig = matches[0].signature()
            if sig is None:
                continue
            payload = node.args[_PAYLOAD_START[method]:]
            if any(isinstance(a, ast.Starred) for a in payload):
                continue  # *args at the call site: count unknown
            keywords = node.keywords
            if any(k.arg is None for k in keywords):
                continue  # **kwargs expansion: names unknown
            npos = len(payload)
            shown = pattern_display(pat)
            if not sig.has_vararg and npos > len(sig.params):
                yield self.finding(
                    ctx, node,
                    f"endpoint {shown!r} handler takes at most "
                    f"{len(sig.params)} payload argument(s); this call "
                    f"passes {npos}",
                )
                continue
            if not sig.has_kwarg:
                unknown = sorted(
                    k.arg for k in keywords
                    if k.arg not in sig.params and k.arg not in sig.kwonly
                )
                if unknown:
                    yield self.finding(
                        ctx, node,
                        f"endpoint {shown!r} handler has no parameter "
                        f"{unknown[0]!r} (and no **kwargs)",
                    )
                    continue
            kw_names = {k.arg for k in keywords}
            required = sig.params[:len(sig.params) - sig.n_defaults]
            filled = set(sig.params[:npos]) | kw_names
            missing = [p for p in required if p not in filled]
            missing += [p for p in sig.kwonly_required if p not in kw_names]
            if missing:
                yield self.finding(
                    ctx, node,
                    f"endpoint {shown!r} handler requires parameter "
                    f"{missing[0]!r}, which this call does not pass",
                )


class RpcDefineCollision(Rule):
    name = "rpc-define-collision"
    description = (
        "the same literal endpoint name is defined twice on one receiver "
        "in one registration scope, on one execution path: both "
        "registrations hash to the same fid, so the second define "
        "silently replaces the first handler. Registrations in mutually "
        "exclusive branches (if/else arms, try body vs handler) never "
        "both execute and are exempt."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        scopes: List[List[ast.stmt]] = [ctx.tree.body]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            defines: List[Tuple[str, str, tuple, ast.Call]] = []
            self._collect(body, (), defines)
            defines.sort(key=lambda t: (t[3].lineno, t[3].col_offset))
            seen: Dict[Tuple[str, str], List[Tuple[tuple, ast.Call]]] = {}
            for recv, pat, path, node in defines:
                earlier = seen.setdefault((recv, pat), [])
                first = next(
                    (n for p, n in earlier if _paths_coexecute(p, path)),
                    None,
                )
                earlier.append((path, node))
                if first is not None:
                    yield self.finding(
                        ctx, node,
                        f"endpoint {pat!r} is already defined on {recv} at "
                        f"line {first.lineno} on this execution path; this "
                        "define silently replaces that handler",
                    )

    def _collect(self, stmts: Iterable[ast.stmt], path: tuple,
                 out: List[Tuple[str, str, tuple, ast.Call]]):
        """Define-calls under ``stmts`` tagged with their branch path —
        the chain of (compound stmt, arm) choices that must hold for the
        statement to execute. Nested defs/classes are their own scopes."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                self._harvest(stmt.test, path, out)
                self._collect(stmt.body, path + ((id(stmt), "body"),), out)
                self._collect(stmt.orelse, path + ((id(stmt), "else"),), out)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                # A loop body may execute alongside everything at this
                # level (and twice against itself) — same path.
                self._collect(stmt.body, path, out)
                self._collect(stmt.orelse, path, out)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._harvest(item.context_expr, path, out)
                self._collect(stmt.body, path, out)
                continue
            if isinstance(stmt, ast.Try):
                body_arm = path + ((id(stmt), "body"),)
                self._collect(stmt.body, body_arm, out)
                for i, handler in enumerate(stmt.handlers):
                    # The body may have partially run before the handler,
                    # so body-vs-handler duplication is NOT provable:
                    # distinct arms keep them exempt.
                    self._collect(
                        handler.body, path + ((id(stmt), f"handler{i}"),),
                        out,
                    )
                self._collect(stmt.orelse, body_arm, out)
                self._collect(stmt.finalbody, path, out)  # always runs
                continue
            self._harvest(stmt, path, out)

    @staticmethod
    def _harvest(node: ast.AST, path: tuple,
                 out: List[Tuple[str, str, tuple, ast.Call]]):
        for sub in iter_scoped_body([node]):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in ENDPOINT_DEFINERS
                    and sub.args):
                continue
            pat = name_pattern(sub.args[0])
            if pat is None or WILDCARD in pat:
                continue  # only fully-literal duplicates are provable
            recv = receiver_name(sub.func.value)
            if recv is None:
                continue
            out.append((recv, pat, path, sub))


def _paths_coexecute(a: tuple, b: tuple) -> bool:
    """Two branch paths lie on one execution path iff one is a prefix of
    the other — sibling arms of the same compound diverge and never both
    run."""
    m = min(len(a), len(b))
    return a[:m] == b[:m]


# -- payload serializability --------------------------------------------------

# threading primitives whose instances cannot be pickled (rpc/serial.py
# falls back to pickle for anything outside its tag set).
_THREADING_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Event", "Barrier", "Thread",
}


def _unpicklable_ctor(call: ast.Call, ctx: ModuleContext) -> Optional[str]:
    """Why a constructor call provably builds an unpicklable value, or
    None."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "open":
        return "an open file handle"
    n = _terminal_name(f)
    if n in _THREADING_CTORS:
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in ("threading", "_thread"):
            return f"a threading.{n}"
        if isinstance(f, ast.Name):
            bound = ctx.import_bindings.get(n)
            if bound is not None and bound[0] in ("threading", "_thread"):
                return f"a threading.{n}"
    return None


def _payload_problem(
    expr: ast.expr, ctx: ModuleContext,
    local_categories: Dict[str, List[Tuple[int, Optional[str]]]],
    traced_params: Set[str],
) -> Optional[str]:
    """Why this payload expression is provably unserializable, or None.

    Containers are descended literally (a lambda inside a list literal is
    just as fatal); a lambda nested in some other call (``sorted(xs,
    key=lambda ...)``) is consumed before serialization and stays silent.
    """
    if isinstance(expr, ast.Lambda):
        return "a lambda (unpicklable)"
    if isinstance(expr, ast.GeneratorExp):
        return "a generator (unpicklable)"
    if isinstance(expr, ast.Call):
        why = _unpicklable_ctor(expr, ctx)
        return f"{why} (unpicklable)" if why else None
    if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
        for elt in expr.elts:
            why = _payload_problem(elt, ctx, local_categories, traced_params)
            if why:
                return why
        return None
    if isinstance(expr, ast.Dict):
        for v in list(expr.keys) + list(expr.values):
            if v is None:
                continue
            why = _payload_problem(v, ctx, local_categories, traced_params)
            if why:
                return why
        return None
    if isinstance(expr, ast.Name):
        if expr.id in traced_params:
            return "a jit tracer (the call runs under trace)"
        assigns = local_categories.get(expr.id)
        if assigns:
            before = [a for a in assigns if a[0] < expr.lineno]
            if before:
                _line, why = max(before, key=lambda a: a[0])
                if why:
                    return f"{why} (assigned at line {_line})"
        return None
    return None


class RpcPayloadUnserializable(Rule):
    name = "rpc-payload-unserializable"
    description = (
        "an RPC payload argument is provably unserializable against "
        "rpc/serial.py's encode set and its pickle fallback: a lambda, a "
        "generator, a threading lock/event/thread, an open file, or a "
        "value that is traced because the dispatch happens inside a "
        "function torch.compile traces."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        from .rules_jax import traced_functions

        traced = traced_functions(ctx)
        traced_nodes: Set[int] = set()
        params_of: Dict[int, Set[str]] = {}
        for fn in traced:
            names = {
                p.arg
                for p in list(fn.args.posonlyargs) + list(fn.args.args)
                + list(fn.args.kwonlyargs)
            }
            for node in ast.walk(fn):
                traced_nodes.add(id(node))
                params_of[id(node)] = names

        # Per-function map of simple local assignments to provably
        # unpicklable values (f = open(...); rpc.async_("p", "fn", f)).
        categories: Dict[int, Dict[str, List[Tuple[int, Optional[str]]]]] = {}
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cat: Dict[str, List[Tuple[int, Optional[str]]]] = {}
            for node in iter_scoped_body(fn.body):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    why = None
                    if isinstance(node.value, ast.Lambda):
                        why = "a lambda (unpicklable)"
                    elif isinstance(node.value, ast.Call):
                        ctor = _unpicklable_ctor(node.value, ctx)
                        why = f"{ctor} (unpicklable)" if ctor else None
                    cat.setdefault(node.targets[0].id, []).append(
                        (node.lineno, why)
                    )
            for node in iter_scoped_body(fn.body):
                categories[id(node)] = cat

        for node, method, _pat in _call_sites(ctx):
            local = categories.get(id(node), {})
            tparams = params_of.get(id(node), set()) \
                if id(node) in traced_nodes else set()
            payload = list(node.args[_PAYLOAD_START[method]:]) + [
                k.value for k in node.keywords if k.arg is not None
            ]
            for arg in payload:
                why = _payload_problem(arg, ctx, local, tparams)
                if why:
                    yield self.finding(
                        ctx, arg,
                        f"RPC payload is {why}: rpc/serial.py cannot "
                        "encode it and the call will fail at send time "
                        "on a live cohort",
                    )


# -- future-origin timeout discipline ----------------------------------------

#: Methods whose return value is an RPC-origin Future (Rpc.async_/
#: async_callback/call_with_deadline, Group.all_reduce — the
#: Accumulator's rounds flow through these same calls — and the serving
#: Router's infer_async, whose executor future wraps an RPC wait).
_PRODUCER_METHODS = {"async_", "async_callback", "call_with_deadline",
                     "all_reduce", "infer_async"}


def _producer_functions(ctx: ModuleContext) -> Set[str]:
    """Names (module functions AND methods of module classes) that can
    return an RPC-origin Future — the one-hop return leg."""
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for call in returned_calls(node):
            callee = _terminal_name(call.func)
            if callee in _PRODUCER_METHODS and isinstance(
                call.func, ast.Attribute
            ):
                out.add(node.name)
                break
    return out


class _FlowScan:
    """Ordered statement walk of one scope tracking which local names (and
    ``self.<attr>`` slots) currently hold an RPC-origin Future."""

    def __init__(self, rule: "RpcResultNoTimeout", ctx: ModuleContext,
                 producers: Set[str]):
        self.rule = rule
        self.ctx = ctx
        self.producers = producers
        self.env: Dict[str, ast.AST] = {}
        self.findings: List[Finding] = []
        self._replaying = False  # bounds back-edge re-scans (see stmt())

    # -- producers -----------------------------------------------------------

    def _is_producer_call(self, node: ast.expr) -> bool:
        if not isinstance(node, ast.Call):
            return False
        callee = _terminal_name(node.func)
        if callee in _PRODUCER_METHODS and isinstance(
            node.func, ast.Attribute
        ):
            return True
        if callee in self.producers:
            return True
        if isinstance(node.func, ast.Name):
            resolved = self.ctx.project.resolve_function(
                self.ctx, node.func.id
            )
            if resolved is not None:
                for call in returned_calls(resolved[1]):
                    if _terminal_name(call.func) in _PRODUCER_METHODS \
                            and isinstance(call.func, ast.Attribute):
                        return True
        return False

    def _target_key(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ) and node.value.id == "self":
            return f"self.{node.attr}"
        return None

    # -- walk ----------------------------------------------------------------

    def block(self, stmts: Iterable[ast.stmt]):
        for stmt in stmts:
            self.stmt(stmt)

    def stmt(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # its own scope (fresh env — closures are not chased)
        if isinstance(stmt, (ast.If,)):
            self.expr(stmt.test)
            self.block(stmt.body)
            self.block(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.expr(stmt.iter)
            key = self._target_key(stmt.target)
            if key:
                self.env.pop(key, None)
            self.block(stmt.body)
            self.block(stmt.orelse)
            self._replay(stmt.body)
            return
        if isinstance(stmt, ast.While):
            self.expr(stmt.test)
            self.block(stmt.body)
            self.block(stmt.orelse)
            self._replay(stmt.body)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.expr(item.context_expr)
            self.block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.block(stmt.body)
            for handler in stmt.handlers:
                self.block(handler.body)
            self.block(stmt.orelse)
            self.block(stmt.finalbody)
            return
        # Simple statement: scan uses first, then apply assignments.
        self.expr(stmt)
        self._apply_assign(stmt)

    def _replay(self, body: Iterable[ast.stmt]):
        """Loop back-edge: assignments late in the body feed uses early in
        the next iteration, so the body is scanned once more — but replays
        never nest (a replayed inner loop skips its own replay), keeping
        the total work O(depth x nodes) instead of 2^depth."""
        if self._replaying:
            return
        self._replaying = True
        try:
            self.block(body)
        finally:
            self._replaying = False

    def _apply_assign(self, stmt: ast.stmt):
        if isinstance(stmt, ast.Assign):
            produced = self._is_producer_call(stmt.value)
            for target in stmt.targets:
                key = self._target_key(target)
                if key is None:
                    continue
                if produced:
                    self.env[key] = stmt.value
                else:
                    self.env.pop(key, None)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            key = self._target_key(stmt.target)
            if key:
                value = getattr(stmt, "value", None)
                if isinstance(stmt, ast.AnnAssign) and value is not None \
                        and self._is_producer_call(value):
                    self.env[key] = value
                else:
                    self.env.pop(key, None)

    def expr(self, node: ast.AST):
        """Flag bare RPC-origin ``.result()`` uses in one statement's own
        expressions (scoped walk: nested defs/lambdas are their own
        scope)."""
        self._check_use(node)
        for sub in iter_scoped_body(ast.iter_child_nodes(node)):
            self._check_use(sub)

    def _check_use(self, node: ast.AST):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "result"
                and not node.args and not node.keywords):
            return
        base = node.func.value
        origin: Optional[ast.AST] = None
        if self._is_producer_call(base):
            origin = base
        else:
            key = self._target_key(base)
            if key is not None:
                origin = self.env.get(key)
        if origin is None:
            return
        self.findings.append(self.rule.finding(
            self.ctx, node,
            "bare .result() on an RPC-origin Future (started at line "
            f"{getattr(origin, 'lineno', '?')}): a dead peer or wedged IO "
            "loop hangs this thread forever — pass a timeout and handle "
            "TimeoutError (timeout=0 polling is exempt)",
        ))


class RpcResultNoTimeout(Rule):
    name = "rpc-result-no-timeout"
    description = (
        "bare .result() on a Future whose dataflow origin is an "
        "RPC/Group/Accumulator call (async_/async_callback/all_reduce, "
        "through local assignments, self-attribute assignments, and one "
        "hop through function returns): the distributed-hang class — "
        "pass a timeout and an error path; timeout=0 polling is exempt."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        producers = _producer_functions(ctx)
        scopes: List[List[ast.stmt]] = [ctx.tree.body]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        reported: Set[Tuple[int, int]] = set()
        for body in scopes:
            scan = _FlowScan(self, ctx, producers)
            scan.block(body)
            for f in scan.findings:
                key = (f.line, f.col)
                if key not in reported:
                    reported.add(key)
                    yield f


RULES = [
    RpcEndpointUnknown,
    RpcEndpointArity,
    RpcDefineCollision,
    RpcPayloadUnserializable,
    RpcResultNoTimeout,
]
