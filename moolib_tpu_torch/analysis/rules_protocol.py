"""RPC round/counter balance rules.

The failure class the reference once fixed by hand: counter-style state driving the
elastic round protocol (``_round_inflight``, ``_grads_inflight``,
``_electing``, ... in ``rpc/group.py`` / ``parallel/accumulator.py``) is
incremented on one path and must be decremented/restored on EVERY path out
— including the exception edges. A path that escapes a completion callback
without restoring the gate wedges the whole round machinery forever; the
cluster keeps counting rounds this peer never joins again.

These rules encode that invariant statically:

- counters are discovered per class: any ``self.X`` attribute the class
  both raises (``= True`` / ``+=``) and lowers (``= False`` / ``-=``);
- each method (and nested completion callback) is walked as a small CFG
  *including exception edges*: a ``try`` body may throw at any statement
  boundary, so handlers are analyzed from every prefix state;
- a call to a class-local helper that writes a counter (the
  ``settle_locked`` idiom) counts as touching it — the one-level
  call-graph from the engine's interprocedural layer.

Rules:

- ``counter-unbalanced-except``: a path through an exception handler
  leaves an incremented counter elevated at function exit.
- ``counter-restore-parity``: one handler of a try restores a counter,
  a sibling handler terminates the function without touching it (the
  exact shape of the reference's early cancellation bug: the broad handler
  restored, the added ``except CancelledError: raise`` guard did not).
- ``inflight-gate-unguarded``: an in-flight gate (name contains
  ``inflight``/``electing``/...) is raised and a later call can throw
  with no ``try`` anywhere on the path to restore it.
"""

from __future__ import annotations

import ast
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import Finding, ModuleContext, Rule, iter_scoped_body
from .engine import terminal_name as _terminal_name

__all__ = ["RULES"]

_GATE_TOKENS = ("inflight", "in_flight", "electing", "busy")
_MAX_STATES = 48  # path cap per block; beyond it the analysis goes silent


def _self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _counter_ops(node: ast.stmt) -> Iterable[Tuple[str, str, ast.stmt]]:
    """(attr, op, node) for counter-shaped writes in ONE simple statement:
    op is 'up' (= True / += const), 'down' (= False / -= const), or
    'other' (non-literal assignment — poisons tracking)."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            attr = _self_attr(t)
            if attr is None:
                continue
            v = node.value
            if isinstance(v, ast.Constant) and v.value is True:
                yield attr, "up", node
            elif isinstance(v, ast.Constant) and v.value is False:
                yield attr, "down", node
            else:
                yield attr, "other", node
    elif isinstance(node, ast.AugAssign):
        attr = _self_attr(node.target)
        if attr is None:
            return
        if isinstance(node.op, ast.Add):
            yield attr, "up", node
        elif isinstance(node.op, ast.Sub):
            yield attr, "down", node
        else:
            yield attr, "other", node


def _class_counters(cls: ast.ClassDef) -> Set[str]:
    """Attributes the class both raises and lowers OUTSIDE ``__init__``:
    initialization is not protocol movement, so a one-way flag like
    ``self._closed`` (False in __init__, True in close(), never again)
    does not become a counter."""
    ups: Set[str] = set()
    downs: Set[str] = set()
    init = next(
        (n for n in cls.body
         if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
         and n.name == "__init__"),
        None,
    )
    init_nodes = set(map(id, ast.walk(init))) if init is not None else set()
    for node in ast.walk(cls):
        if id(node) in init_nodes:
            continue
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            for attr, op, _n in _counter_ops(node):
                if op == "up":
                    ups.add(attr)
                elif op == "down":
                    downs.add(attr)
    return ups & downs


def _class_functions(cls: ast.ClassDef) -> List[ast.AST]:
    """Every def in the class subtree: methods AND nested completion
    callbacks (each is analyzed as its own entry point — callbacks run on
    RPC threads long after the defining method returned)."""
    return [
        n for n in ast.walk(cls)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def _writer_index(cls: ast.ClassDef, counters: Set[str]) -> Dict[str, Set[str]]:
    """def-name -> counters it writes anywhere in its body (one level of
    the class-local call graph: a call to one of these names counts as
    touching those counters)."""
    out: Dict[str, Set[str]] = {}
    for fn in _class_functions(cls):
        writes: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                for attr, _op, _n in _counter_ops(node):
                    if attr in counters:
                        writes.add(attr)
        out[fn.name] = writes
    return out


def _called_writers(node: ast.AST, writers: Dict[str, Set[str]]) -> Set[str]:
    """Counters possibly written by calls inside ``node`` (one hop:
    ``helper(...)`` / ``self.helper(...)`` where helper is a class-local
    def that writes them)."""
    touched: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            callee = _terminal_name(n.func)
            if callee in writers:
                touched |= writers[callee]
    return touched


# -- CFG walk -----------------------------------------------------------------


class _State:
    __slots__ = ("delta", "unknown", "via_except", "inc_node", "except_elev")

    def __init__(self):
        self.delta: Dict[str, int] = {}
        self.unknown: Set[str] = set()
        self.via_except: Optional[ast.ExceptHandler] = None
        # Counters that were ELEVATED at the moment the handler was
        # entered: only those may be blamed on the exception path — a gate
        # raised after an unrelated, completed try rejoins normal flow.
        self.except_elev: frozenset = frozenset()
        self.inc_node: Dict[str, ast.AST] = {}

    def copy(self) -> "_State":
        s = _State()
        s.delta = dict(self.delta)
        s.unknown = set(self.unknown)
        s.via_except = self.via_except
        s.except_elev = self.except_elev
        s.inc_node = dict(self.inc_node)
        return s

    def key(self):
        return (tuple(sorted(self.delta.items())),
                tuple(sorted(self.unknown)), id(self.via_except),
                self.except_elev)


def _dedupe(states: List[_State]) -> List[_State]:
    seen = {}
    for s in states:
        seen.setdefault(s.key(), s)
    out = list(seen.values())
    if len(out) > _MAX_STATES:
        # Path explosion: give up soundly — poison everything so no path
        # from here can produce a finding.
        s = _State()
        s.unknown = {c for st in out for c in
                     itertools.chain(st.delta, st.unknown)}
        return [s]
    return out


class _Walker:
    """Statement-level abstract interpreter tracking counter deltas along
    every path, with exception edges out of try bodies."""

    def __init__(self, counters: Set[str], writers: Dict[str, Set[str]]):
        self.counters = counters
        self.writers = writers
        self.exits: List[Tuple[str, _State, ast.AST]] = []

    def run(self, fn: ast.AST) -> List[Tuple[str, _State, ast.AST]]:
        falls = self.block(fn.body, [_State()])
        for s in falls:
            self.exits.append(("fall", s, fn))
        return self.exits

    # -> fall-through states
    def block(self, stmts: Sequence[ast.stmt],
              states: List[_State]) -> List[_State]:
        states, _ = self.block_with_boundaries(stmts, states)
        return states

    def block_with_boundaries(
        self, stmts: Sequence[ast.stmt], states: List[_State]
    ) -> Tuple[List[_State], List[_State]]:
        """(fall states, every state at any statement boundary) — the
        boundary set is the exception-edge entry set for an enclosing
        handler."""
        boundaries: List[_State] = list(states)
        for stmt in stmts:
            states = self.stmt(stmt, states)
            states = _dedupe(states)
            boundaries.extend(states)
            if not states:
                break
        return states, _dedupe(boundaries)

    def stmt(self, stmt: ast.stmt, states: List[_State]) -> List[_State]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return states  # analyzed as its own entry point
        if isinstance(stmt, ast.Return):
            states = self.effects(stmt, states)
            for s in states:
                self.exits.append(("return", s, stmt))
            return []
        if isinstance(stmt, ast.Raise):
            states = self.effects(stmt, states)
            for s in states:
                self.exits.append(("raise", s, stmt))
            return []
        if isinstance(stmt, ast.If):
            pre = self.effects_expr(stmt.test, states)
            return _dedupe(
                self.block(stmt.body, [s.copy() for s in pre])
                + self.block(stmt.orelse, [s.copy() for s in pre])
            )
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            pre = states
            once = self.block(stmt.body, [s.copy() for s in pre])
            skip = self.block(stmt.orelse, [s.copy() for s in pre]) \
                if stmt.orelse else [s.copy() for s in pre]
            return _dedupe(once + skip)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                states = self.effects_expr(item.context_expr, states)
            return self.block(stmt.body, states)
        if isinstance(stmt, ast.Try):
            return self.try_stmt(stmt, states)
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return states  # loop approximation: body runs 0 or 1 times
        return self.effects(stmt, states)

    def try_stmt(self, stmt: ast.Try, states: List[_State]) -> List[_State]:
        n_before = len(self.exits)
        body_falls, boundaries = self.block_with_boundaries(stmt.body, states)
        # A `raise` recorded while processing the BODY (including re-raises
        # escaping a nested try's handlers) is catchable HERE: route those
        # states into this try's handlers instead of out of the function —
        # otherwise an outer `except BaseException: restore; raise` around
        # an inner cancellation guard is invisible and the guard pattern
        # the docs recommend gets flagged.
        body_raises = [e for e in self.exits[n_before:] if e[0] == "raise"]
        if body_raises and stmt.handlers:
            self.exits[n_before:] = [
                e for e in self.exits[n_before:] if e[0] != "raise"
            ]
            boundaries = _dedupe(
                boundaries + [s for _k, s, _n in body_raises]
            )
        handler_falls: List[_State] = []
        for handler in stmt.handlers:
            h_entry = []
            for s in boundaries:
                hs = s.copy()
                hs.via_except = handler
                hs.except_elev = frozenset(
                    a for a, d in s.delta.items()
                    if d > 0 and a not in s.unknown
                )
                h_entry.append(hs)
            handler_falls.extend(self.block(handler.body, _dedupe(h_entry)))
        if stmt.orelse:
            body_falls = self.block(stmt.orelse, body_falls)
        falls = _dedupe(body_falls + handler_falls)
        if stmt.finalbody:
            falls = self.block(stmt.finalbody, falls)
            # Exits recorded inside body/handlers pass through the finally
            # on their way out: apply its unconditional direct counter
            # writes to their states, so a restoring finally silences the
            # would-be finding.
            for fstmt in stmt.finalbody:
                for attr, op, n in self._direct_ops(fstmt):
                    for _kind, s, _node in self.exits[n_before:]:
                        self._apply_op(s, attr, op, n)
        return falls

    def _direct_ops(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            yield from (
                (a, op, n) for a, op, n in _counter_ops(stmt)
                if a in self.counters
            )
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for sub in stmt.body:
                yield from self._direct_ops(sub)

    def _apply_op(self, s: _State, attr: str, op: str, node: ast.AST):
        if op == "up":
            if isinstance(node, ast.Assign):
                s.delta[attr] = 1  # flag set: absolute
            else:
                s.delta[attr] = s.delta.get(attr, 0) + 1
            s.inc_node[attr] = node
        elif op == "down":
            if isinstance(node, ast.Assign):
                s.delta[attr] = 0
            else:
                s.delta[attr] = s.delta.get(attr, 0) - 1
        else:
            s.unknown.add(attr)
            s.delta[attr] = 0

    def effects(self, stmt: ast.stmt, states: List[_State]) -> List[_State]:
        """Apply one simple statement: direct counter writes + one-hop
        writer calls (which poison the counters they may touch)."""
        touched = _called_writers(stmt, self.writers) & self.counters
        ops = [
            (a, op, n) for a, op, n in _counter_ops(stmt)
            if a in self.counters
        ]
        for s in states:
            for attr in touched:
                s.unknown.add(attr)
                s.delta[attr] = 0
            for attr, op, node in ops:
                self._apply_op(s, attr, op, node)
        return states

    def effects_expr(self, expr: ast.expr,
                     states: List[_State]) -> List[_State]:
        touched = _called_writers(expr, self.writers) & self.counters
        for s in states:
            for attr in touched:
                s.unknown.add(attr)
                s.delta[attr] = 0
        return states


# -- rules --------------------------------------------------------------------


def _classes_with_counters(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            counters = _class_counters(node)
            if counters:
                yield node, counters


class CounterUnbalancedExcept(Rule):
    name = "counter-unbalanced-except"
    description = (
        "a path through an exception handler exits the method with a "
        "class counter/gate still elevated (incremented, never "
        "decremented/restored on that path): during elastic membership "
        "changes this wedges round bookkeeping forever."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for cls, counters in _classes_with_counters(ctx):
            writers = _writer_index(cls, counters)
            for fn in _class_functions(cls):
                reported: Set[Tuple[int, str]] = set()
                walker = _Walker(counters, writers)
                for _kind, state, _node in walker.run(fn):
                    if state.via_except is None:
                        continue
                    for attr, d in state.delta.items():
                        if d <= 0 or attr in state.unknown \
                                or attr not in state.except_elev:
                            continue
                        key = (state.via_except.lineno, attr)
                        if key in reported:
                            continue
                        reported.add(key)
                        inc = state.inc_node.get(attr)
                        at = f" (set at line {inc.lineno})" if inc else ""
                        yield self.finding(
                            ctx, state.via_except,
                            f"exception path may exit {fn.name!r} with "
                            f"self.{attr} still elevated{at}; restore it "
                            "in this handler before leaving",
                        )


class CounterRestoreParity(Rule):
    name = "counter-restore-parity"
    description = (
        "one handler of a try restores a class counter but a sibling "
        "handler terminates without touching it — the classic shape of a "
        "cancellation guard (`except CancelledError: raise`) added "
        "without the bookkeeping restore its broad sibling performs."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for cls, counters in _classes_with_counters(ctx):
            writers = _writer_index(cls, counters)
            for fn in _class_functions(cls):
                # Scoped walk: a try inside a nested callback belongs to
                # the callback's own iteration, not the enclosing method's
                # (descending twice would double-report it).
                for node in iter_scoped_body(fn.body):
                    if not isinstance(node, ast.Try) \
                            or len(node.handlers) < 2:
                        continue
                    yield from self._check_try(
                        ctx, fn, node, counters, writers
                    )

    def _check_try(self, ctx, fn, node, counters, writers):
        per_handler: List[Set[str]] = []
        for handler in node.handlers:
            writes: Set[str] = set()
            for n in ast.walk(handler):
                if isinstance(n, (ast.Assign, ast.AugAssign)):
                    for attr, _op, _n in _counter_ops(n):
                        if attr in counters:
                            writes.add(attr)
            writes |= _called_writers(handler, writers) & counters
            per_handler.append(writes)
        restored = set().union(*per_handler)
        # A finally that writes the counter restores it on EVERY path —
        # handlers need not repeat it (the guard-plus-finally pattern).
        fin_writes: Set[str] = set()
        for n in node.finalbody:
            for sub in ast.walk(n):
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    for attr, _op, _n in _counter_ops(sub):
                        if attr in counters:
                            fin_writes.add(attr)
            fin_writes |= _called_writers(n, writers) & counters
        restored -= fin_writes
        # Parity only applies to counters this function's NORMAL flow also
        # manages (success path lowers the gate, as every settle-style
        # completion callback does). A purely defensive reset in one
        # handler, for a counter the rest of the function never touches,
        # does not oblige its siblings to mirror it.
        handler_nodes = {
            id(n) for h in node.handlers for n in ast.walk(h)
        }
        normal_writes: Set[str] = set()
        for n in iter_scoped_body(fn.body):
            if id(n) in handler_nodes:
                continue
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                for attr, _op, _n in _counter_ops(n):
                    if attr in counters:
                        normal_writes.add(attr)
            elif isinstance(n, ast.Call):
                callee = _terminal_name(n.func)
                if callee in writers:
                    normal_writes |= writers[callee] & counters
        restored &= normal_writes
        if not restored:
            return
        for handler, writes in zip(node.handlers, per_handler):
            if writes:
                continue
            walker = _Walker(counters, writers)
            falls = walker.block(handler.body, [_State()])
            if falls:
                continue  # falls through: later code can still restore
            missing = sorted(restored)
            yield self.finding(
                ctx, handler,
                f"sibling handler restores self.{missing[0]} but this "
                f"handler exits {fn.name!r} without touching it "
                f"(unbalanced on this exception edge)",
            )


class InflightGateUnguarded(Rule):
    name = "inflight-gate-unguarded"
    description = (
        "an in-flight gate (self.*inflight*/*electing*/...) is raised and "
        "a later call in the same method can throw, with no try anywhere "
        "after the increment to restore the gate: one synchronous dispatch "
        "failure leaves the gate set forever and the protocol stalls."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for cls, counters in _classes_with_counters(ctx):
            gates = {
                c for c in counters
                if any(tok in c.lower() for tok in _GATE_TOKENS)
            }
            if not gates:
                continue
            writers = _writer_index(cls, counters)
            for fn in _class_functions(cls):
                yield from self._check_fn(ctx, fn, gates, writers)

    def _check_fn(self, ctx, fn, gates, writers):
        # Every node under some try BODY of this function: a call there has
        # failure handling around it. Handler and finally subtrees do NOT
        # count — an exception raised in a handler is not caught by its own
        # try, so a risky dispatch there is exactly as unguarded as one
        # outside the statement.
        in_try: Set[int] = set()
        for t in ast.walk(fn):
            if isinstance(t, ast.Try):
                for stmt in t.body:
                    for n in ast.walk(stmt):
                        in_try.add(id(n))
        increments: List[Tuple[str, ast.stmt]] = []
        for node in self._scoped(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                for attr, op, n in _counter_ops(node):
                    if op == "up" and attr in gates:
                        increments.append((attr, n))
        # tries whose handlers/finally touch a given gate: a protected
        # call under one of these means the author manages the gate here.
        def try_manages(t: ast.Try, attr: str) -> bool:
            regions = [h.body for h in t.handlers] + [t.finalbody]
            for region in regions:
                for stmt in region:
                    for n in ast.walk(stmt):
                        if isinstance(n, (ast.Assign, ast.AugAssign)):
                            for a, _op, _n in _counter_ops(n):
                                if a == attr:
                                    return True
                    if attr in _called_writers(stmt, writers):
                        return True
            return False

        tries = [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
        body_of = {
            id(n): t for t in tries for stmt in t.body
            for n in ast.walk(stmt)
        }
        reported: Set[str] = set()
        for attr, inc in increments:
            if attr in reported:
                continue
            if id(inc) in in_try:
                continue  # the increment itself sits under a try
            for node in self._scoped(fn):
                if getattr(node, "lineno", 0) <= inc.lineno:
                    continue
                if isinstance(node, ast.Call):
                    callee = _terminal_name(node.func)
                    if callee in writers and attr in writers[callee]:
                        break  # the call itself restores the gate
                    enclosing = body_of.get(id(node))
                    if enclosing is not None:
                        if try_manages(enclosing, attr):
                            break  # failure handling restores the gate;
                            # path precision is counter-unbalanced-except's
                            # job from here
                        continue  # protected but gate-oblivious try: keep
                        # scanning — a later unguarded call still leaks
                    reported.add(attr)
                    yield self.finding(
                        ctx, node,
                        f"self.{attr} was raised at line {inc.lineno}; if "
                        "this call throws, nothing restores the gate — "
                        "wrap it in try/except (restore, then re-raise)",
                    )
                    break

    @staticmethod
    def _scoped(fn: ast.AST) -> Iterable[ast.AST]:
        return sorted(
            iter_scoped_body(fn.body),
            key=lambda n: (getattr(n, "lineno", 0),
                           getattr(n, "col_offset", 0)),
        )


RULES = [
    CounterUnbalancedExcept,
    CounterRestoreParity,
    InflightGateUnguarded,
]
