"""racelint: guarded-field & lock-order analysis for threaded code; the
counterpart of :mod:`moolib_tpu.analysis.rules_race`, whole and
unchanged in what it finds (the same findings on the same sources, and
the same static edge set over the same tree).

The port runs the reference's concurrency in Python (IO loops, executor
threads, deferred-reply threads, probe/health loops); this family makes
its cross-thread race class machine-checked, in the
GUARDED_BY/ThreadSanitizer lineage but static and convention-driven:

- **Guarded-field inference**: for each class, a field ``self._x`` written
  under ``with self._lock:`` (or ``self._cv``) in any non-``__init__``
  method is *guarded by* that lock. Methods reachable from a thread entry
  point (``threading.Thread(target=...)``, ``executor.submit``,
  ``add_done_callback``, Rpc handler registration) must hold a guarding
  lock to touch the field (``race-unguarded-field``).
- **Atomicity**: read-modify-write of a guarded field outside its lock
  (``self._n += 1``, ``self._x = f(self._x)``), check-then-act where the
  check reads the field unlocked and the taken branch writes it
  (``race-nonatomic-rmw``), and lock-release-between-check-and-use — a
  local snapshots a guarded field under the lock, the lock is dropped,
  and the snapshot later gates a re-locked write (``race-lock-gap``).
- **Lock order**: the static *acquires-while-holding* graph across the
  package — in-function nesting, class-local calls (transitively), and
  one attribute-typed cross-class hop — must stay acyclic; a cycle is a
  potential deadlock and a nested re-acquire of a non-reentrant
  ``threading.Lock`` is a certain one (``race-lock-order-cycle``). The
  dynamic mirror lives in :mod:`moolib_tpu_torch.testing.locktrace`, which
  records *real* acquisition edges during tests and asserts they stay
  acyclic and inside :func:`static_lock_edges`' over-approximation.

Conventions the inference understands (the reference's
docs/reliability.md):

- a method whose name ends in ``_locked`` is called with the class's
  lock(s) held — its body counts as a lock region;
- ``__init__`` is single-threaded by construction and never flagged;
- suppression carries a REASON: ``# racelint: unguarded -- <why>`` on the
  flagged line silences the race rules there; a bare marker with no
  reason suppresses nothing and is itself flagged
  (``race-bare-suppression``). The generic
  ``# moolint: disable=race-...`` grammar still works but the racelint
  form is preferred because it forces the why into the diff.

Everything here is best-effort and silence-biased like the rest of the
engine: an unresolvable receiver, an unknown callee, or a lock the
analysis cannot name makes the rule say nothing rather than guess.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import (
    Finding,
    ModuleContext,
    ProjectIndex,
    Rule,
    iter_py_files,
    iter_scoped_body,
    terminal_name,
)

__all__ = ["RULES", "static_lock_edges"]

#: Constructors whose result is a lock-like object with acquire/release.
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

#: Attribute-name tokens that mark a lock-like field even when the
#: constructor is out of sight (assigned via a helper, injected, ...).
_LOCKISH_TOKENS = ("lock", "cond", "mutex")
_LOCKISH_EXACT = ("_cv",)

#: Receiver methods that mutate a container in place: a call
#: ``self._d.pop(k)`` is a WRITE of ``self._d`` for guardedness.
_MUTATORS = {
    "append", "appendleft", "add", "insert", "extend", "extendleft",
    "update", "pop", "popleft", "popitem", "remove", "discard", "clear",
    "setdefault", "sort", "reverse", "put", "put_nowait",
}

#: Call surfaces whose function argument becomes a THREAD ENTRY POINT:
#: it will run on another thread (or an executor/callback thread).
_SPAWN_KWARG = "target"          # threading.Thread(target=...)
_SUBMIT_NAMES = {"submit"}       # executor.submit(fn, ...)
_CALLBACK_NAMES = {"add_done_callback"}  # fut.add_done_callback(fn)
_DEFINER_NAMES = {"define", "define_deferred", "define_queue"}

_RACE_MARKER_RE = re.compile(r"#\s*racelint:\s*unguarded\b")
_RACE_REASON_RE = re.compile(
    r"#\s*racelint:\s*unguarded\b[\s:,(–—-]*([^\s)].*)"
)

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _race_suppressions(ctx: ModuleContext) -> Dict[int, bool]:
    """line -> has_reason for every ``# racelint: unguarded`` marker.
    Only REAL comments count (``ctx.comments`` is tokenize-derived): a
    marker inside a string literal — e.g. a lint-test fixture — neither
    suppresses nor trips ``race-bare-suppression``."""
    out: Dict[int, bool] = {}
    for i, text in ctx.comments:
        if "racelint" not in text:
            continue
        if _RACE_MARKER_RE.search(text):
            m = _RACE_REASON_RE.search(text)
            out[i] = bool(m and m.group(1).strip())
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _is_lockish_name(attr: str) -> bool:
    low = attr.lower()
    return low in _LOCKISH_EXACT or any(t in low for t in _LOCKISH_TOKENS)


# -- lock references ----------------------------------------------------------

# A lock reference as it appears at an acquisition site. ``owner`` is
# "self" for ``with self._lock:``, "mod" for a module-global ``with
# _pool_lock:``, and a local variable name for ``with op.lock:`` (the
# lock of ANOTHER object held in a local).
@dataclasses.dataclass(frozen=True)
class _LockRef:
    owner: str
    attr: str


def _lock_ref(expr: ast.expr) -> Optional[_LockRef]:
    attr = _self_attr(expr)
    if attr is not None:
        return _LockRef("self", attr)
    if isinstance(expr, ast.Name):
        return _LockRef("mod", expr.id)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return _LockRef(expr.value.id, expr.attr)
    return None


# -- per-function facts -------------------------------------------------------


@dataclasses.dataclass
class _Access:
    field: str
    node: ast.AST
    write: bool
    held: FrozenSet[str]  # self-lock attrs held at the access


@dataclasses.dataclass
class _CallSite:
    recv: Optional[str]   # None = bare name; "self" = self-call;
    #                       otherwise the first attribute hop ("_group")
    name: str             # callee terminal name
    node: ast.Call
    held: FrozenSet[str]
    held_refs: FrozenSet[_LockRef] = frozenset()


@dataclasses.dataclass
class _CheckAct:
    node: ast.If
    test_reads: Set[str]
    body_writes: Set[str]
    held: FrozenSet[str]


@dataclasses.dataclass
class _Snapshot:
    local: str
    field: str
    line: int


@dataclasses.dataclass
class _FnFacts:
    fn: ast.AST
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    acquires: List[Tuple[_LockRef, ast.AST, FrozenSet[_LockRef]]] = \
        dataclasses.field(default_factory=list)
    calls: List[_CallSite] = dataclasses.field(default_factory=list)
    checks: List[_CheckAct] = dataclasses.field(default_factory=list)
    snapshots: List[_Snapshot] = dataclasses.field(default_factory=list)
    ifs_outside: List[Tuple[ast.If, FrozenSet[str]]] = \
        dataclasses.field(default_factory=list)
    local_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Function-local lock bindings (``done_lock = threading.Lock()``):
    # name -> factory kind. The dynamic tracer names these from the same
    # binding line, so the static superset must resolve them too.
    local_locks: Dict[str, str] = dataclasses.field(default_factory=dict)


def _expr_field_reads(expr: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(expr):
        attr = _self_attr(n)
        if attr is not None and isinstance(n.ctx, ast.Load):  # type: ignore[attr-defined]
            out.add(attr)
    return out


def _scoped_field_writes(stmts: Sequence[ast.stmt]) -> Set[str]:
    """Fields written anywhere under ``stmts`` without crossing into
    nested defs (those run later, on their own thread)."""
    out: Set[str] = set()
    for n in iter_scoped_body(stmts):
        out |= _node_field_writes(n)
    return out


def _node_field_writes(n: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(n, ast.Assign):
        for t in n.targets:
            out |= _target_fields(t)
    elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
        out |= _target_fields(n.target)
    elif isinstance(n, ast.Delete):
        for t in n.targets:
            out |= _target_fields(t)
    elif isinstance(n, ast.Call):
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None:
                out.add(attr)
    return out


def _target_fields(t: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(t, ast.Attribute):
        attr = _self_attr(t)
        if attr is not None:
            out.add(attr)
    elif isinstance(t, ast.Subscript):
        attr = _self_attr(t.value)
        if attr is not None:
            out.add(attr)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            out |= _target_fields(e)
    elif isinstance(t, ast.Starred):
        out |= _target_fields(t.value)
    return out


def _self_held(held: FrozenSet[_LockRef]) -> FrozenSet[str]:
    return frozenset(r.attr for r in held if r.owner == "self")


class _FnWalker:
    """One pass over a function body tracking the held-lock set (as lock
    *references* — self attrs, module globals, other objects' locks).
    Nested defs are NOT entered: they execute later on some other thread,
    so the lexically-enclosing lock is not held there."""

    def __init__(self, self_locks: Set[str]):
        self.self_locks = self_locks
        self.facts: Optional[_FnFacts] = None

    def run(self, fn: ast.AST, init_held: FrozenSet[str]) -> _FnFacts:
        self.facts = _FnFacts(fn=fn)
        # Parameter annotations are local types (`op: "_Op"`).
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                ann = a.annotation
                if isinstance(ann, ast.Constant) \
                        and isinstance(ann.value, str):
                    name = ann.value.strip()
                elif isinstance(ann, ast.Name):
                    name = ann.id
                else:
                    continue
                if name[:1].isupper() or name[:1] == "_":
                    self.facts.local_types.setdefault(a.arg, name)
        self._stmts(
            getattr(fn, "body", []),
            frozenset(_LockRef("self", a) for a in init_held),
        )
        return self.facts

    def _stmts(self, stmts: Sequence[ast.stmt],
               held: FrozenSet[_LockRef]):
        for s in stmts:
            self._stmt(s, held)

    def _stmt(self, node: ast.stmt, held: FrozenSet[_LockRef]):
        if isinstance(node, _FN_NODES + (ast.ClassDef, ast.Lambda)):
            return  # analyzed as its own entry
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                ref = _lock_ref(item.context_expr)
                self._expr(item.context_expr, inner)
                if ref is not None and (
                    (ref.owner == "self" and ref.attr in self.self_locks)
                    or (ref.owner != "self" and _is_lockish_name(ref.attr))
                    or (ref.owner == "mod"
                        and ref.attr in self.facts.local_locks)
                ):
                    self.facts.acquires.append(
                        (ref, item.context_expr, inner)
                    )
                    inner = inner | {ref}
            self._stmts(node.body, inner)
            return
        if isinstance(node, ast.If):
            reads = _expr_field_reads(node.test)
            writes = _scoped_field_writes(node.body)
            self.facts.checks.append(
                _CheckAct(node=node, test_reads=reads,
                          body_writes=writes, held=_self_held(held))
            )
            self.facts.ifs_outside.append((node, _self_held(held)))
            self._expr(node.test, held)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._expr(node.iter, held)
            self._write_targets(node.target, node, held)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return
        if isinstance(node, ast.While):
            self._expr(node.test, held)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return
        if isinstance(node, ast.Try):
            self._stmts(node.body, held)
            for h in node.handlers:
                self._stmts(h.body, held)
            self._stmts(node.orelse, held)
            self._stmts(node.finalbody, held)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._write_targets(t, node, held)
            self._expr(node.value, held)
            if len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                local = node.targets[0].id
                cname = _constructed_class(node.value)
                if cname is not None:
                    self.facts.local_types.setdefault(local, cname)
                if isinstance(node.value, ast.Call):
                    kind = terminal_name(node.value.func)
                    if kind in _LOCK_FACTORIES:
                        self.facts.local_locks.setdefault(local, kind)
                # Snapshot detection for race-lock-gap: a LOCAL bound,
                # under a lock, from an expression reading guarded fields.
                if _self_held(held):
                    for field in _expr_field_reads(node.value):
                        self.facts.snapshots.append(_Snapshot(
                            local=local, field=field, line=node.lineno,
                        ))
            return
        if isinstance(node, ast.AugAssign):
            self._write_targets(node.target, node, held)
            # The target of += is also a read (the RMW shape itself).
            for f in _target_fields(node.target):
                self.facts.accesses.append(
                    _Access(field=f, node=node, write=False,
                            held=_self_held(held))
                )
            self._expr(node.value, held)
            return
        if isinstance(node, ast.AnnAssign):
            self._write_targets(node.target, node, held)
            if node.value is not None:
                self._expr(node.value, held)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._write_targets(t, node, held)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self._expr(node.value, held)
            return
        if isinstance(node, ast.Expr):
            self._expr(node.value, held)
            return
        # Anything else (Raise, Assert, Global, ...): generic expression
        # scan over immediate children.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr,)):
                self._expr(child, held)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held)

    def _write_targets(self, t: ast.AST, at: ast.AST,
                       held: FrozenSet[_LockRef]):
        for f in _target_fields(t):
            self.facts.accesses.append(
                _Access(field=f, node=at, write=True,
                        held=_self_held(held))
            )
        # Subscript slices are reads; recurse into them.
        if isinstance(t, ast.Subscript):
            self._expr(t.slice, held)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                if not isinstance(e, (ast.Name, ast.Attribute, ast.Starred,
                                      ast.Subscript, ast.Tuple, ast.List)):
                    self._expr(e, held)

    def _expr(self, expr: ast.AST, held: FrozenSet[_LockRef]):
        stack: List[ast.AST] = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue  # executes later, on whatever thread calls it
            stack.extend(ast.iter_child_nodes(n))
            if isinstance(n, ast.Call):
                self._call(n, held)
            attr = _self_attr(n)
            if attr is not None and isinstance(getattr(n, "ctx", None),
                                               ast.Load):
                self.facts.accesses.append(
                    _Access(field=attr, node=n, write=False,
                            held=_self_held(held))
                )

    def _call(self, node: ast.Call, held: FrozenSet[_LockRef]):
        f = node.func
        sh = _self_held(held)
        # Mutator calls are writes of the receiver field.
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None:
                self.facts.accesses.append(
                    _Access(field=attr, node=node, write=True, held=sh)
                )
        if isinstance(f, ast.Name):
            self.facts.calls.append(_CallSite(
                recv=None, name=f.id, node=node, held=sh, held_refs=held
            ))
        elif isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name):
                self.facts.calls.append(_CallSite(
                    recv=f.value.id, name=f.attr, node=node, held=sh,
                    held_refs=held,
                ))
            else:
                recv_attr = _self_attr(f.value)
                if recv_attr is not None:
                    # self.<attr>.<m>() — one attribute hop off self.
                    self.facts.calls.append(_CallSite(
                        recv=recv_attr, name=f.attr, node=node, held=sh,
                        held_refs=held,
                    ))


# -- per-class analysis -------------------------------------------------------


@dataclasses.dataclass
class _ClassInfo:
    node: ast.ClassDef
    locks: Dict[str, str]                # lock attr -> kind
    functions: List[ast.AST]             # methods + nested defs
    methods: Dict[str, ast.AST]          # top-level methods by name
    facts: Dict[int, _FnFacts]           # id(fn) -> facts
    guarded: Dict[str, Set[str]]         # field -> guarding lock attrs
    entries: Dict[int, str]              # id(fn) -> entry description
    reachable: Dict[int, str]            # id(fn) -> via-entry description
    attr_types: Dict[str, str]           # self.attr -> ClassName (literal)


def _class_functions(cls: ast.ClassDef) -> List[ast.AST]:
    return [n for n in ast.walk(cls) if isinstance(n, _FN_NODES)]


def _discover_locks(cls: ast.ClassDef) -> Dict[str, str]:
    locks: Dict[str, str] = {}
    for n in ast.walk(cls):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            kind = terminal_name(n.value.func)
            if kind in _LOCK_FACTORIES:
                for t in n.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        locks[attr] = kind
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr not in locks \
                        and _is_lockish_name(attr):
                    locks[attr] = "unknown"
    return locks


def _constructed_class(expr: ast.AST) -> Optional[str]:
    """ClassName when ``expr`` is (or contains as a fallback arm)
    ``ClassName(...)`` — sees through ``x or ClassName(...)`` and
    conditional expressions."""
    if isinstance(expr, ast.Call):
        cname = terminal_name(expr.func)
        if cname is not None and cname[:1].isupper():
            return cname
        return None
    if isinstance(expr, ast.BoolOp):
        for v in expr.values:
            c = _constructed_class(v)
            if c is not None:
                return c
    if isinstance(expr, ast.IfExp):
        return _constructed_class(expr.body) or _constructed_class(expr.orelse)
    return None


def _attr_types(cls: ast.ClassDef) -> Dict[str, str]:
    """``self.attr -> ClassName`` for literal constructor assignments in
    any method (``self._group = group or Group(...)``)."""
    out: Dict[str, str] = {}
    for n in ast.walk(cls):
        if isinstance(n, ast.Assign):
            cname = _constructed_class(n.value)
            if cname is None:
                continue
            for t in n.targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.setdefault(attr, cname)
    return out


def _entry_description(kind: str, node: ast.AST) -> str:
    return f"{kind} at line {getattr(node, 'lineno', '?')}"


def _find_entries(cls: ast.ClassDef,
                  functions: List[ast.AST]) -> Dict[int, str]:
    """id(fn) -> how it becomes a thread entry point."""
    by_name: Dict[str, List[ast.AST]] = {}
    for fn in functions:
        by_name.setdefault(fn.name, []).append(fn)
    methods = {
        n.name: n for n in cls.body if isinstance(n, _FN_NODES)
    }
    entries: Dict[int, str] = {}

    def mark(expr: ast.AST, why: str):
        attr = _self_attr(expr)
        if attr is not None and attr in methods:
            entries.setdefault(id(methods[attr]), why)
            return
        if isinstance(expr, ast.Name):
            for fn in by_name.get(expr.id, ()):
                entries.setdefault(id(fn), why)
        elif isinstance(expr, ast.Lambda):
            # The lambda body runs on the other thread; treat every
            # self-method it calls as an entry.
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Call):
                    a = _self_attr(n.func)
                    if a is not None and a in methods:
                        entries.setdefault(id(methods[a]), why)

    for n in ast.walk(cls):
        if not isinstance(n, ast.Call):
            continue
        name = terminal_name(n.func)
        if name == "Thread":
            for kw in n.keywords:
                if kw.arg == _SPAWN_KWARG:
                    mark(kw.value, _entry_description("Thread target", n))
        elif name in _SUBMIT_NAMES and n.args:
            mark(n.args[0], _entry_description("executor submit", n))
        elif name in _CALLBACK_NAMES and n.args:
            mark(n.args[0], _entry_description("done-callback", n))
        elif name in _DEFINER_NAMES and len(n.args) >= 2:
            mark(n.args[1], _entry_description("RPC handler", n))
    # Decorator-form RPC registration: @rpc.define("name") above a method.
    for fn in functions:
        for dec in getattr(fn, "decorator_list", ()):
            for sub in ast.walk(dec):
                if isinstance(sub, ast.Call) \
                        and terminal_name(sub.func) in _DEFINER_NAMES:
                    entries.setdefault(
                        id(fn), _entry_description("RPC handler", sub)
                    )
    return entries


def _analyze_class(cls: ast.ClassDef) -> Optional[_ClassInfo]:
    locks = _discover_locks(cls)
    if not locks:
        return None
    functions = _class_functions(cls)
    methods = {n.name: n for n in cls.body if isinstance(n, _FN_NODES)}
    self_locks = set(locks)
    facts: Dict[int, _FnFacts] = {}
    for fn in functions:
        init_held = frozenset(self_locks) if fn.name.endswith("_locked") \
            else frozenset()
        facts[id(fn)] = _FnWalker(self_locks).run(fn, init_held)
    entries = _find_entries(cls, functions)
    # Caller-sensitive held inference: a PRIVATE method whose every
    # class-internal call site holds a common lock is called-with-lock-
    # held by construction (the `_reset_epoch` idiom — the `_locked`
    # suffix makes the convention explicit, this makes it checked).
    # Public methods and thread entry points stay unlocked: the runtime
    # or user code calls them bare. Monotone (assumptions only grow), so
    # the fixpoint terminates.
    assumed: Dict[int, FrozenSet[str]] = {}
    while True:
        sites: Dict[str, List[FrozenSet[str]]] = {}
        for fn in functions:
            for call in facts[id(fn)].calls:
                if call.recv == "self" and call.name in methods:
                    sites.setdefault(call.name, []).append(call.held)
        changed = False
        for name, heldlist in sites.items():
            m = methods[name]
            if not name.startswith("_") or name.startswith("__") \
                    or id(m) in entries:
                continue
            common = frozenset.intersection(*heldlist)
            if common and assumed.get(id(m), frozenset()) != common:
                assumed[id(m)] = common
                init = common | (
                    frozenset(self_locks) if name.endswith("_locked")
                    else frozenset()
                )
                facts[id(m)] = _FnWalker(self_locks).run(m, init)
                changed = True
        if not changed:
            break
    # Guarded-field inference: written under a lock in any non-__init__
    # function. Lock attrs themselves are never "fields".
    guarded: Dict[str, Set[str]] = {}
    for fn in functions:
        if fn.name == "__init__":
            continue
        for acc in facts[id(fn)].accesses:
            if acc.write and acc.held and acc.field not in self_locks \
                    and not _is_lockish_name(acc.field):
                guarded.setdefault(acc.field, set()).update(acc.held)
    # Reachability closure over the class-local call graph.
    by_name: Dict[str, List[ast.AST]] = {}
    for fn in functions:
        by_name.setdefault(fn.name, []).append(fn)
    reachable: Dict[int, str] = dict(entries)
    work = [fn for fn in functions if id(fn) in entries]
    while work:
        fn = work.pop()
        why = reachable[id(fn)]
        for call in facts[id(fn)].calls:
            targets: List[ast.AST] = []
            if call.recv == "self" and call.name in methods:
                targets = [methods[call.name]]
            elif call.recv is None:
                targets = by_name.get(call.name, [])
            for t in targets:
                if id(t) not in reachable:
                    reachable[id(t)] = why
                    work.append(t)
    return _ClassInfo(
        node=cls, locks=locks, functions=functions, methods=methods,
        facts=facts, guarded=guarded, entries=entries,
        reachable=reachable, attr_types=_attr_types(cls),
    )


def _module_classes(ctx: ModuleContext) -> List[_ClassInfo]:
    """Analyzed classes of one module, memoized on the context (several
    rules share the same per-class facts)."""
    cached = getattr(ctx, "_race_classes", None)
    if cached is not None:
        return cached
    out: List[_ClassInfo] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            info = _analyze_class(node)
            if info is not None:
                out.append(info)
    ctx._race_classes = out  # type: ignore[attr-defined]
    return out


# -- rule: race-bare-suppression ---------------------------------------------


class RaceBareSuppression(Rule):
    name = "race-bare-suppression"
    description = (
        "a `# racelint: unguarded` marker with no reason: the grammar "
        "requires the why (`# racelint: unguarded -- <reason>`) so every "
        "suppressed race carries its justification in the diff; a bare "
        "marker suppresses nothing."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for line, has_reason in sorted(_race_suppressions(ctx).items()):
            if not has_reason:
                snippet_node = ast.Module(body=[], type_ignores=[])
                snippet_node.lineno = line  # type: ignore[attr-defined]
                snippet_node.col_offset = 0  # type: ignore[attr-defined]
                yield self.finding(
                    ctx, snippet_node,
                    "racelint suppression without a reason — write "
                    "`# racelint: unguarded -- <reason>`",
                )


def _suppressed(ctx: ModuleContext, sup: Dict[int, bool], line: int) -> bool:
    return sup.get(line, False)


# -- rule: race-unguarded-field ----------------------------------------------


class RaceUnguardedField(Rule):
    name = "race-unguarded-field"
    description = (
        "a field written under `with self._lock:` elsewhere (a guarded "
        "field) is touched without the lock in a method reachable from a "
        "thread entry point (Thread target / executor submit / "
        "done-callback / RPC handler): another thread can interleave and "
        "the read is stale or the write is lost. Hold the guarding lock, "
        "or annotate `# racelint: unguarded -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _race_suppressions(ctx)
        for info in _module_classes(ctx):
            if not info.guarded:
                continue
            for fn in info.functions:
                if id(fn) not in info.reachable or fn.name == "__init__":
                    continue
                why = info.reachable[id(fn)]
                reported: Set[str] = set()
                for acc in info.facts[id(fn)].accesses:
                    guards = info.guarded.get(acc.field)
                    if not guards or acc.held & guards:
                        continue
                    if acc.field in reported:
                        continue
                    line = getattr(acc.node, "lineno", 0)
                    if _suppressed(ctx, sup, line):
                        reported.add(acc.field)
                        continue
                    reported.add(acc.field)
                    lock = "/".join(f"self.{g}" for g in sorted(guards))
                    verb = "written" if acc.write else "read"
                    yield self.finding(
                        ctx, acc.node,
                        f"self.{acc.field} is guarded by {lock} but "
                        f"{verb} here without it; {fn.name!r} runs on "
                        f"another thread ({why}) — hold the lock or "
                        "annotate `# racelint: unguarded -- <reason>`",
                    )


# -- rule: race-nonatomic-rmw -------------------------------------------------


class RaceNonatomicRmw(Rule):
    name = "race-nonatomic-rmw"
    description = (
        "read-modify-write of a guarded field outside its lock "
        "(`self._n += 1`, `self._x = f(self._x)`) or check-then-act (an "
        "unlocked test of a guarded field gating a write of the same "
        "field): the interleaving window between read and write loses "
        "updates regardless of which thread this method runs on."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _race_suppressions(ctx)
        for info in _module_classes(ctx):
            if not info.guarded:
                continue
            for fn in info.functions:
                if fn.name == "__init__":
                    continue
                facts = info.facts[id(fn)]
                reported: Set[Tuple[int, str]] = set()

                def emit(node, field, msg):
                    key = (getattr(node, "lineno", 0), field)
                    if key in reported:
                        return None
                    reported.add(key)
                    if _suppressed(ctx, sup, key[0]):
                        return None
                    return self.finding(ctx, node, msg)

                for node in iter_scoped_body(fn.body):
                    if not isinstance(node, (ast.AugAssign, ast.Assign)):
                        continue
                    held = self._held_at(facts, node)
                    if held is None:
                        continue
                    if isinstance(node, ast.AugAssign):
                        fields = _target_fields(node.target)
                    else:
                        fields = set()
                        for t in node.targets:
                            fields |= _target_fields(t)
                        fields &= _expr_field_reads(node.value)
                    for field in sorted(fields):
                        guards = info.guarded.get(field)
                        if not guards or held & guards:
                            continue
                        lock = "/".join(
                            f"self.{g}" for g in sorted(guards)
                        )
                        f = emit(
                            node, field,
                            f"read-modify-write of self.{field} outside "
                            f"{lock}: the read and the write can "
                            "interleave with another thread's update — "
                            "do it under the lock",
                        )
                        if f is not None:
                            yield f
                for chk in facts.checks:
                    both = chk.test_reads & chk.body_writes
                    for field in sorted(both):
                        guards = info.guarded.get(field)
                        if not guards or chk.held & guards:
                            continue
                        lock = "/".join(
                            f"self.{g}" for g in sorted(guards)
                        )
                        f = emit(
                            chk.node, field,
                            f"check-then-act on self.{field} without "
                            f"{lock}: the test is stale by the time the "
                            "branch writes the field — move the check "
                            "under the lock",
                        )
                        if f is not None:
                            yield f

    @staticmethod
    def _held_at(facts: _FnFacts, node: ast.AST) -> Optional[FrozenSet[str]]:
        """Held set recorded for this statement, or None when the walker
        never recorded it (no self-field access there — the silence-bias
        skip in check())."""
        for acc in facts.accesses:
            if acc.node is node:
                return acc.held
        return None


# -- rule: race-lock-gap ------------------------------------------------------


class RaceLockGap(Rule):
    name = "race-lock-gap"
    description = (
        "lock released between check and use: a local snapshots a "
        "guarded field under the lock, the lock is dropped, and the "
        "snapshot later gates a re-locked write of the same field — the "
        "state can change in the gap; re-check under the lock before "
        "acting."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _race_suppressions(ctx)
        for info in _module_classes(ctx):
            if not info.guarded:
                continue
            for fn in info.functions:
                if fn.name == "__init__":
                    continue
                facts = info.facts[id(fn)]
                if not facts.snapshots:
                    continue
                snaps = [
                    s for s in facts.snapshots if s.field in info.guarded
                ]
                if not snaps:
                    continue
                for node, held in facts.ifs_outside:
                    test_names = {
                        n.id for n in ast.walk(node.test)
                        if isinstance(n, ast.Name)
                    }
                    for s in snaps:
                        guards = info.guarded[s.field]
                        if held & guards:
                            continue  # still under the lock: no gap
                        if s.local not in test_names \
                                or node.lineno <= s.line:
                            continue
                        if not self._relocked_write(
                            node.body, s.field, guards
                        ):
                            continue
                        if _suppressed(ctx, sup, node.lineno):
                            continue
                        lock = "/".join(
                            f"self.{g}" for g in sorted(guards)
                        )
                        yield self.finding(
                            ctx, node,
                            f"{s.local!r} snapshots self.{s.field} under "
                            f"{lock} (line {s.line}) but the lock is "
                            "released before this check and the branch "
                            f"re-locks to write self.{s.field} — the "
                            "snapshot is stale; re-check under the lock",
                        )
                        break

    @staticmethod
    def _relocked_write(stmts: Sequence[ast.stmt], field: str,
                        guards: Set[str]) -> bool:
        for n in iter_scoped_body(stmts):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    ref = _lock_ref(item.context_expr)
                    if ref is not None and ref.owner == "self" \
                            and ref.attr in guards:
                        if field in _scoped_field_writes(n.body):
                            return True
        return False


# -- rule: race-lock-order-cycle ---------------------------------------------

# A node of the acquires-while-holding graph. ``owner`` is the class name
# ("" at module level); display is ``path:Class._lock``.
@dataclasses.dataclass(frozen=True, order=True)
class _LockNode:
    path: str
    owner: str
    attr: str

    def display(self) -> str:
        o = f"{self.owner}." if self.owner else ""
        return f"{self.path}:{o}{self.attr}"


@dataclasses.dataclass
class _Edge:
    src: _LockNode
    dst: _LockNode
    ctx: ModuleContext
    node: ast.AST  # acquisition / call site


class _LockGraph:
    def __init__(self):
        self.edges: List[_Edge] = []
        self.kinds: Dict[_LockNode, str] = {}

    def add(self, edge: _Edge):
        self.edges.append(edge)


def _module_locks(ctx: ModuleContext) -> Dict[str, str]:
    """Module-level ``X = threading.Lock()`` assignments: name -> kind."""
    out: Dict[str, str] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            kind = terminal_name(node.value.func)
            if kind in _LOCK_FACTORIES:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = kind
    return out


def _class_index(project: ProjectIndex) -> Dict[str, List[Tuple[ModuleContext, ast.ClassDef]]]:
    cached = getattr(project, "_race_class_index", None)
    if cached is not None:
        return cached
    idx: Dict[str, List[Tuple[ModuleContext, ast.ClassDef]]] = {}
    for ctx in project.contexts:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                idx.setdefault(node.name, []).append((ctx, node))
    project._race_class_index = idx  # type: ignore[attr-defined]
    return idx


def _project_lock_graph(project: ProjectIndex) -> _LockGraph:
    cached = getattr(project, "_race_lock_graph", None)
    if cached is not None:
        return cached
    graph = _LockGraph()

    # Per-(ctx, class) info and per-class transitive acquisition memo.
    class_infos: Dict[int, Tuple[ModuleContext, _ClassInfo]] = {}
    for ctx in project.contexts:
        for info in _module_classes(ctx):
            class_infos[id(info.node)] = (ctx, info)
            for attr, kind in info.locks.items():
                node = _LockNode(ctx.relpath, info.node.name, attr)
                graph.kinds.setdefault(node, kind)
            ctx_mod_locks = _module_locks(ctx)
            for name, kind in ctx_mod_locks.items():
                graph.kinds.setdefault(
                    _LockNode(ctx.relpath, "", name), kind
                )

    cindex = _class_index(project)

    _mod_locks_cache: Dict[int, Dict[str, str]] = {}

    def mod_locks_of(ctx: ModuleContext) -> Dict[str, str]:
        if id(ctx) not in _mod_locks_cache:
            _mod_locks_cache[id(ctx)] = _module_locks(ctx)
        return _mod_locks_cache[id(ctx)]

    def resolve_class(ctx: ModuleContext, name: str) \
            -> Optional[Tuple[ModuleContext, _ClassInfo]]:
        cands = cindex.get(name, [])
        infos = [
            class_infos[id(cls)] for c, cls in cands
            if id(cls) in class_infos
        ]
        if len(infos) == 1:
            return infos[0]
        # Prefer a class from this module on name collision.
        local = [i for i in infos if i[0] is ctx]
        return local[0] if len(local) == 1 else None

    def _call_targets(ctx, info, call, resolve, facts=None):
        out = []
        if call.recv == "self" and call.name in info.methods:
            out.append((ctx, info, info.methods[call.name]))
        elif call.recv is None:
            for fn in info.functions:
                if fn.name == call.name:
                    out.append((ctx, info, fn))
        elif call.recv not in (None, "self"):
            cname = info.attr_types.get(call.recv)
            if cname is None and facts is not None:
                cname = facts.local_types.get(call.recv)
            if cname is not None:
                resolved = resolve(ctx, cname)
                if resolved is not None:
                    tctx, tinfo = resolved
                    m = tinfo.methods.get(call.name)
                    if m is not None:
                        out.append((tctx, tinfo, m))
        return out

    # Unique-lock-attr fallback per module: ``with op.lock:`` where the
    # receiver's type is invisible (pulled from a dict) still resolves
    # when exactly one analyzed class IN THIS MODULE has a lock attr of
    # that name.
    unique_lock_attr: Dict[int, Dict[str, _LockNode]] = {}
    for ctx in project.contexts:
        owners: Dict[str, List[_LockNode]] = {}
        for info in _module_classes(ctx):
            for attr in info.locks:
                owners.setdefault(attr, []).append(
                    _LockNode(ctx.relpath, info.node.name, attr)
                )
        unique_lock_attr[id(ctx)] = {
            attr: nodes[0] for attr, nodes in owners.items()
            if len(nodes) == 1
        }

    def ref_node(ctx: ModuleContext, info: _ClassInfo, facts: _FnFacts,
                 ref: _LockRef, mod_locks: Dict[str, str]) \
            -> Optional[_LockNode]:
        direct = _ref_node(ctx, info, ref, mod_locks)
        if direct is not None:
            return direct
        if ref.owner not in ("self", "mod"):
            cname = info.attr_types.get(ref.owner) \
                or facts.local_types.get(ref.owner)
            if cname is not None:
                resolved = resolve_class(ctx, cname)
                if resolved is not None:
                    tctx, tinfo = resolved
                    if ref.attr in tinfo.locks:
                        return _LockNode(
                            tctx.relpath, tinfo.node.name, ref.attr
                        )
            return unique_lock_attr[id(ctx)].get(ref.attr)
        return None

    # Transitive acquisitions per function, closed over the resolved
    # call graph by Kleene iteration. NOT a memoized recursion: caching
    # a result computed under a cycle guard truncates it (mutually
    # recursive helpers would poison the memo with partial sets and
    # hide real deadlock edges); the fixpoint is sound under any
    # recursion shape and the graphs here are tiny.
    direct_acq: Dict[int, Set[_LockNode]] = {}
    targets_of: Dict[int, List[int]] = {}
    for ctx in project.contexts:
        for info in _module_classes(ctx):
            for fn in info.functions:
                facts = info.facts[id(fn)]
                acq: Set[_LockNode] = set()
                for ref, _site, _held in facts.acquires:
                    n = ref_node(ctx, info, facts, ref, mod_locks_of(ctx))
                    if n is not None:
                        acq.add(n)
                direct_acq[id(fn)] = acq
                targets_of[id(fn)] = [
                    id(tfn)
                    for call in facts.calls
                    for _tc, _ti, tfn in _call_targets(
                        ctx, info, call, resolve_class, facts
                    )
                ]
    trans: Dict[int, Set[_LockNode]] = {
        k: set(v) for k, v in direct_acq.items()
    }
    changed = True
    while changed:
        changed = False
        for fn_id, tgts in targets_of.items():
            cur = trans[fn_id]
            before = len(cur)
            for t in tgts:
                cur |= trans.get(t, set())
            if len(cur) != before:
                changed = True

    # Edges.
    for ctx in project.contexts:
        mod_locks = mod_locks_of(ctx)
        for info in _module_classes(ctx):
            for fn in info.functions:
                facts = info.facts[id(fn)]
                for ref, site, held in facts.acquires:
                    dst = ref_node(ctx, info, facts, ref, mod_locks)
                    if dst is None:
                        continue
                    for h in held:
                        src = ref_node(ctx, info, facts, h, mod_locks)
                        if src is not None:
                            graph.add(_Edge(src, dst, ctx, site))
                for call in facts.calls:
                    if not call.held_refs:
                        continue
                    srcs = [
                        s for s in (
                            ref_node(ctx, info, facts, h, mod_locks)
                            for h in call.held_refs
                        ) if s is not None
                    ]
                    if not srcs:
                        continue
                    for tctx, tinfo, tfn in _call_targets(
                        ctx, info, call,
                        lambda c, n: resolve_class(c, n), facts,
                    ):
                        if tfn is fn:
                            continue
                        for dst in trans.get(id(tfn), ()):
                            for src in srcs:
                                graph.add(_Edge(src, dst, ctx, call.node))
    project._race_lock_graph = graph  # type: ignore[attr-defined]
    return graph


def _ref_node(ctx: ModuleContext, info: _ClassInfo, ref: _LockRef,
              mod_locks: Dict[str, str]) -> Optional[_LockNode]:
    if ref.owner == "self" and ref.attr in info.locks:
        return _LockNode(ctx.relpath, info.node.name, ref.attr)
    if ref.owner == "mod" and ref.attr in mod_locks:
        return _LockNode(ctx.relpath, "", ref.attr)
    return None


def _find_cycles(graph: _LockGraph) -> List[List[_Edge]]:
    """Self-loops plus one shortest representative cycle per SCC."""
    adj: Dict[_LockNode, List[_Edge]] = {}
    for e in graph.edges:
        adj.setdefault(e.src, []).append(e)
    cycles: List[List[_Edge]] = []
    seen_loops: Set[_LockNode] = set()
    for e in graph.edges:
        if e.src == e.dst and e.src not in seen_loops:
            seen_loops.add(e.src)
            # Re-acquiring a non-reentrant Lock is a certain deadlock;
            # an RLock self-edge is the reentrancy it exists for.
            if graph.kinds.get(e.src) == "Lock":
                cycles.append([e])
    # Tarjan SCC.
    index: Dict[_LockNode, int] = {}
    low: Dict[_LockNode, int] = {}
    on: Set[_LockNode] = set()
    stack: List[_LockNode] = []
    sccs: List[List[_LockNode]] = []
    counter = [0]

    def strongconnect(v: _LockNode):
        work = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for e in it:
                w = e.dst
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(scc)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    for scc in sccs:
        members = set(scc)
        start = min(scc)
        # BFS for the shortest cycle through ``start`` inside the SCC.
        best: Optional[List[_Edge]] = None
        frontier: List[Tuple[_LockNode, List[_Edge]]] = [(start, [])]
        visited = {start}
        while frontier and best is None:
            nxt: List[Tuple[_LockNode, List[_Edge]]] = []
            for node, path in frontier:
                for e in adj.get(node, ()):
                    if e.dst not in members or e.src == e.dst:
                        continue
                    if e.dst == start:
                        best = path + [e]
                        break
                    if e.dst not in visited:
                        visited.add(e.dst)
                        nxt.append((e.dst, path + [e]))
                if best is not None:
                    break
            frontier = nxt
        if best:
            cycles.append(best)
    return cycles


class RaceLockOrderCycle(Rule):
    name = "race-lock-order-cycle"
    description = (
        "the static acquires-while-holding graph has a cycle: two "
        "threads taking the locks in opposite order deadlock. Also "
        "flags nested re-acquisition of a non-reentrant threading.Lock "
        "(self-deadlock). Establish one global lock order and release "
        "before acquiring against it; the dynamic mirror is "
        "moolib_tpu_torch.testing.locktrace."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _race_suppressions(ctx)
        graph = _project_lock_graph(ctx.project)
        for cycle in _find_cycles(graph):
            # Report once, in the module owning the lexically-first edge.
            site = min(
                cycle,
                key=lambda e: (e.ctx.relpath,
                               getattr(e.node, "lineno", 0)),
            )
            if site.ctx is not ctx:
                continue
            line = getattr(site.node, "lineno", 0)
            if _suppressed(ctx, sup, line):
                continue
            if len(cycle) == 1 and cycle[0].src == cycle[0].dst:
                yield self.finding(
                    ctx, site.node,
                    f"{cycle[0].src.display()} is a non-reentrant "
                    "threading.Lock re-acquired while already held on "
                    "this path — certain self-deadlock (use RLock or "
                    "restructure)",
                )
                continue
            chain = " -> ".join(e.src.display() for e in cycle)
            chain += f" -> {cycle[-1].dst.display()}"
            sites = ", ".join(
                f"{e.ctx.relpath}:{getattr(e.node, 'lineno', '?')}"
                for e in cycle
            )
            yield self.finding(
                ctx, site.node,
                f"lock-order cycle {chain} (edges at {sites}): threads "
                "taking these locks in opposite order deadlock — pick "
                "one order and restructure the odd acquisition out",
            )


# -- static edges for the dynamic mirror -------------------------------------


def static_lock_edges(paths: Sequence[Path], root: Optional[Path] = None) \
        -> Set[Tuple[Tuple[str, str], Tuple[str, str]]]:
    """Over-approximated acquires-while-holding edges for
    :mod:`moolib_tpu_torch.testing.locktrace`'s subset assertion, keyed the way
    the dynamic tracer names locks: ``((path, attr), (path, attr))``.

    Deliberately coarser than the precise cycle rule: calls made while a
    lock is held resolve BY NAME against every same-named
    function/method in the project (receiver-ignorant), and acquisition
    closure follows those name matches transitively. Dynamic traces must
    land inside this superset; the precise rule alone would false-fail
    the mirror on call chains its typed one-hop resolution cannot see
    (e.g. a telemetry counter's internal lock taken under an RPC lock).
    """
    root = Path(root) if root is not None else Path.cwd()
    contexts: List[ModuleContext] = []
    for path in iter_py_files(paths):
        try:
            source = path.read_text(encoding="utf-8")
        except OSError:
            continue
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.resolve().as_posix()
        try:
            contexts.append(ModuleContext(source, rel))
        except Exception:
            continue
    project = ProjectIndex(contexts)

    # name -> list of (ctx, owner_info_or_None, fn) across the project.
    fn_index: Dict[str, List[Tuple[ModuleContext, Optional[_ClassInfo], ast.AST]]] = {}
    all_facts: Dict[int, Tuple[ModuleContext, Optional[_ClassInfo], _FnFacts]] = {}
    mod_locks_of: Dict[int, Dict[str, str]] = {}

    for ctx in project.contexts:
        mod_locks_of[id(ctx)] = _module_locks(ctx)
        class_fn_ids: Set[int] = set()
        for info in _module_classes(ctx):
            for fn in info.functions:
                class_fn_ids.add(id(fn))
                fn_index.setdefault(fn.name, []).append((ctx, info, fn))
                all_facts[id(fn)] = (ctx, info, info.facts[id(fn)])
        # Module-level + non-class functions (no self locks, but they can
        # hold module locks and call into classes).
        for fn in [n for n in ast.walk(ctx.tree) if isinstance(n, _FN_NODES)]:
            if id(fn) in class_fn_ids:
                continue
            facts = _FnWalker(set()).run(fn, frozenset())
            fn_index.setdefault(fn.name, []).append((ctx, None, fn))
            all_facts[id(fn)] = (ctx, None, facts)

    def node_of(ctx: ModuleContext, info: Optional[_ClassInfo],
                facts: _FnFacts, ref: _LockRef) \
            -> Optional[Tuple[str, str]]:
        if ref.owner == "self" and info is not None \
                and ref.attr in info.locks:
            return (ctx.relpath, ref.attr)
        if ref.owner == "mod":
            if ref.attr in mod_locks_of[id(ctx)] \
                    or ref.attr in facts.local_locks:
                # Module-global, or a FUNCTION-LOCAL lock binding
                # (``done_lock = threading.Lock()``) — the tracer names
                # those from the very same binding line, so the superset
                # must know them or assert_within false-fails the first
                # time one nests with a named lock at runtime.
                return (ctx.relpath, ref.attr)
            return None
        if ref.owner not in ("self", "mod") and _is_lockish_name(ref.attr):
            # ``op.lock`` on some other object: name-level node in this
            # module (the tracer names locks by creation site, which for
            # these is usually the same module).
            return (ctx.relpath, ref.attr)
        return None

    # Transitive acquisitions, closed by Kleene iteration over the
    # name-resolved call graph — NOT a memoized recursion: a result
    # cached while a cycle guard truncated it (mutually recursive
    # helpers) would miss edges and silently break the documented
    # superset guarantee assert_within relies on.
    direct: Dict[int, Set[Tuple[str, str]]] = {}
    targets_of: Dict[int, List[int]] = {}
    for fn_id, (ctx, info, facts) in all_facts.items():
        acq: Set[Tuple[str, str]] = set()
        for ref, _site, _held in facts.acquires:
            n = node_of(ctx, info, facts, ref)
            if n is not None:
                acq.add(n)
        direct[fn_id] = acq
        targets_of[fn_id] = [
            id(tfn)
            for call in facts.calls
            for _tctx, _tinfo, tfn in fn_index.get(call.name, ())
        ]
    closure_of: Dict[int, Set[Tuple[str, str]]] = {
        k: set(v) for k, v in direct.items()
    }
    changed = True
    while changed:
        changed = False
        for fn_id, tgts in targets_of.items():
            cur = closure_of[fn_id]
            before = len(cur)
            for t in tgts:
                cur |= closure_of.get(t, set())
            if len(cur) != before:
                changed = True

    edges: Set[Tuple[Tuple[str, str], Tuple[str, str]]] = set()
    for fn_id, (ctx, info, facts) in all_facts.items():

        def held_nodes(held: FrozenSet[_LockRef]) -> List[Tuple[str, str]]:
            return [
                n for n in (node_of(ctx, info, facts, h) for h in held)
                if n is not None
            ]

        for ref, _site, held in facts.acquires:
            dst = node_of(ctx, info, facts, ref)
            if dst is None:
                continue
            for src in held_nodes(held):
                if src != dst:
                    edges.add((src, dst))
        for call in facts.calls:
            if not call.held_refs:
                continue
            srcs = held_nodes(call.held_refs)
            if not srcs:
                continue
            for _tctx, _tinfo, tfn in fn_index.get(call.name, ()):
                for dst in closure_of.get(id(tfn), ()):
                    for src in srcs:
                        if src != dst:
                            edges.add((src, dst))
    return edges


RULES = [
    RaceBareSuppression,
    RaceUnguardedField,
    RaceNonatomicRmw,
    RaceLockGap,
    RaceLockOrderCycle,
]
