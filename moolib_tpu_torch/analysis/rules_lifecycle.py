"""lifelint: resource-lifecycle & shutdown-path analysis.

The reference moolib is a long-lived RPC core where every object owns
OS-level state — sockets, shm segments, threads, fds — and lifecycle
bugs are its dominant live-bug class: a supervisor thread pinned
abandoned EnvPools forever, gauge closures pinned closed Rpcs in the
registry, an end-to-end drive found /dev/shm littered by SIGKILLed
creators, and locktrace caught a ``__del__``-under-registry-lock GC
deadlock. This family makes the whole ownership discipline
machine-checked (the reference's docs/reliability.md, "Resource
ownership conventions"):

- **resource-no-release-path**: a class that acquires a tracked resource
  (a started ``Thread``, a ``ThreadPoolExecutor``, a ``SharedMemory``
  segment, an ``open()`` handle, or any project class that itself has a
  ``close()``) into a ``self`` attribute must release it from ``close()``
  (transitively through class-local calls). Acquire/release pairing for
  project classes is inferred from the project index — one from-import
  hop, like racelint's resolution.
- **thread-pins-self**: a ``Thread(target=self.m)`` (or
  ``executor.submit(self.m)`` result) stored on ``self`` strongly pins
  the owner from the running thread — an abandoned object is never
  collected, its ``__del__`` backstop never runs, and everything it owns
  leaks forever (the EnvPool supervisor bug). Long-lived loops must use
  a module-level entry function holding only a ``weakref`` (see
  ``statestore/store.py::_replicator_entry``).
- **del-heavy-work**: ``__del__`` and ``weakref.finalize`` callbacks run
  on whatever thread the GC interrupts — possibly while that thread
  holds arbitrary locks. Acquiring a lock, doing I/O, or calling into
  the telemetry registry there is the GC-deadlock class locktrace
  caught; finalizers must be lock-free flag-flips or os-level
  best-effort cleanup that cannot block.
- **close-not-idempotent**: ``close()`` is called from ``__del__``
  backstops, error paths, and user code — often more than once. A
  ``close()`` that re-runs one-shot release effects (``join``,
  ``unlink``, ``shutdown``, ``unregister``, ``undefine``, ...) with
  neither an early-return latch on a ``self`` flag nor a per-resource
  guard can raise or double-release on the second call (the codebase
  contract).
- **registration-outlives-owner**: a gauge_fn/endpoint/reader
  registration made in ``__init__`` writes a strong reference into a
  registry that outlives the object; without a matching
  ``unregister``/``undefine``/``remove_reader`` in the class the closed
  object stays reachable — and scrapes keep calling into it (the
  gauge-closure bug family).

Suppression carries a REASON, racelint-style:
``# lifelint: intentional -- <why>`` on the flagged line silences the
lifecycle rules there; a bare marker suppresses nothing and is itself
flagged (``lifecycle-bare-suppression``). The generic
``# moolint: disable=...`` grammar also works but the lifelint form is
preferred because it forces the why into the diff.

Everything here is silence-biased like the rest of the engine: an
unresolvable constructor, receiver, or name pattern makes a rule say
nothing rather than guess. Release detection is presence-based over the
class-local transitive call closure of the close-like methods (full
path-sensitivity is out of scope; the dynamic mirror —
:mod:`moolib_tpu_torch.testing.restrack` — catches what a skipped path leaks
at runtime).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import (
    Finding,
    ModuleContext,
    ProjectIndex,
    Rule,
    iter_scoped_body,
    name_pattern,
    pattern_display,
    patterns_overlap,
    terminal_name,
)

__all__ = ["RULES"]

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: Stdlib resource factories: constructor terminal name -> (human kind,
#: release method names that count as giving the resource back).
_STDLIB_RESOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "Thread": ("thread", ("join",)),
    "ThreadPoolExecutor": ("executor", ("shutdown",)),
    "ProcessPoolExecutor": ("executor", ("shutdown",)),
    "SharedMemory": ("shm segment", ("close", "unlink")),
    "open": ("file handle", ("close",)),
}

#: Methods that count as a shutdown path: releases reachable from any of
#: these (transitively through class-local calls) satisfy the pairing.
_CLOSE_LIKE = ("close", "aclose", "shutdown", "stop", "terminate",
               "__exit__", "__aexit__")

#: One-shot release effects: re-running these on a second ``close()``
#: raises or double-releases. Plain ``.close()`` delegation is excluded —
#: the contract makes every close() idempotent, so delegating is too.
_ONESHOT_RELEASES = ("join", "unlink", "shutdown", "unregister",
                     "undefine", "remove_reader", "terminate", "kill")

#: Registration surfaces (rule: registration-outlives-owner).
#: kind -> (registering call names, releasing call names).
_REGISTRATIONS = {
    "gauge": (("gauge_fn", "register_gauge_fn"), ("unregister",)),
    "endpoint": (("define", "define_queue", "define_deferred"),
                 ("undefine",)),
    "reader": (("add_reader",), ("remove_reader",)),
}

#: Calls in a finalizer that mean lock acquisition, I/O, or registry work.
_DEL_LOCK_CALLS = ("acquire",)
_DEL_REGISTRY_CALLS = ("unregister", "gauge_fn", "register_gauge_fn")
_DEL_IO_CALLS = ("open", "unlink", "rmtree", "remove", "rename", "write",
                 "flush", "fsync", "sendall", "send", "recv", "connect",
                 "listen", "join")

_LIFE_MARKER_RE = re.compile(r"#\s*lifelint:\s*intentional\b")
_LIFE_REASON_RE = re.compile(
    r"#\s*lifelint:\s*intentional\b[\s:,(–—-]*([^\s)].*)"
)

_LOCKISH_TOKENS = ("lock", "cond", "mutex")


def _life_suppressions(ctx: ModuleContext) -> Dict[int, bool]:
    """line -> has_reason for every ``# lifelint: intentional`` marker.
    Only REAL comments count (``ctx.comments`` is tokenize-derived): a
    marker inside a string literal — e.g. a lint-test fixture — neither
    suppresses nor trips ``lifecycle-bare-suppression``."""
    out: Dict[int, bool] = {}
    for i, text in ctx.comments:
        if "lifelint" not in text:
            continue
        if _LIFE_MARKER_RE.search(text):
            m = _LIFE_REASON_RE.search(text)
            out[i] = bool(m and m.group(1).strip())
    return out


def _suppressed(ctx: ModuleContext, sup: Dict[int, bool], line: int) -> bool:
    return sup.get(line, False)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _is_lockish_name(attr: str) -> bool:
    low = attr.lower()
    return low == "_cv" or any(t in low for t in _LOCKISH_TOKENS)


# -- project class resolution ---------------------------------------------------


def _project_class_index(project: ProjectIndex) \
        -> Dict[str, List[Tuple[ModuleContext, ast.ClassDef]]]:
    cached = getattr(project, "_life_class_index", None)
    if cached is not None:
        return cached
    idx: Dict[str, List[Tuple[ModuleContext, ast.ClassDef]]] = {}
    for c in project.contexts:
        for node in ast.walk(c.tree):
            if isinstance(node, ast.ClassDef):
                idx.setdefault(node.name, []).append((c, node))
    project._life_class_index = idx  # type: ignore[attr-defined]
    return idx


def _class_has_close(cls: ast.ClassDef) -> bool:
    return any(
        isinstance(n, _FN_NODES) and n.name == "close" for n in cls.body
    )


def _resolve_closeable(ctx: ModuleContext, name: str) -> bool:
    """True when ``name``, as visible from ``ctx``, is a project class
    defining ``close()`` — a local class or one from-import hop away.
    Unresolvable or ambiguous names resolve to False (silence-bias)."""
    idx = _project_class_index(ctx.project)
    # Local class first.
    local = [cls for c, cls in idx.get(name, []) if c is ctx]
    if len(local) == 1:
        return _class_has_close(local[0])
    bound = ctx.import_bindings.get(name)
    if bound is not None:
        target = ctx.project.module(bound[0])
        if target is not None:
            cands = [cls for c, cls in idx.get(bound[1], [])
                     if c is target]
            if len(cands) == 1:
                return _class_has_close(cands[0])
    return False


# -- constructed-resource classification ----------------------------------------


def _resource_call(expr: ast.AST) -> Optional[ast.Call]:
    """The constructor Call inside ``expr``, seeing through ``x or C(...)``
    and conditional expressions (the fallback-arm idiom)."""
    if isinstance(expr, ast.Call):
        return expr
    if isinstance(expr, ast.BoolOp):
        for v in expr.values:
            c = _resource_call(v)
            if c is not None:
                return c
    if isinstance(expr, ast.IfExp):
        return _resource_call(expr.body) or _resource_call(expr.orelse)
    return None


def _classify_acquisition(ctx: ModuleContext, expr: ast.AST) \
        -> Optional[Tuple[str, str, Tuple[str, ...]]]:
    """(factory name, human kind, release method names) when ``expr``
    constructs a tracked resource; None otherwise."""
    call = _resource_call(expr)
    if call is None:
        return None
    fname = terminal_name(call.func)
    if fname is None:
        return None
    std = _STDLIB_RESOURCES.get(fname)
    if std is not None:
        # ``open`` only counts as a bare name (``self.f = open(...)``);
        # ``x.open()`` is some object's method, not the builtin.
        if fname == "open" and not isinstance(call.func, ast.Name):
            return None
        return fname, std[0], std[1]
    if fname[:1].isupper() and isinstance(call.func, (ast.Name, ast.Attribute)):
        if _resolve_closeable(ctx, fname):
            return fname, f"{fname} instance", ("close",)
    return None


# -- per-class lifecycle facts ---------------------------------------------------


@dataclasses.dataclass
class _Acq:
    attr: str                    # self attribute holding the resource
    factory: str                 # constructor name (Thread, Rpc, ...)
    kind: str                    # human-readable resource kind
    releases: Tuple[str, ...]    # method names that release it
    node: ast.AST                # the acquiring assignment
    method: str                  # method the acquisition lives in


@dataclasses.dataclass
class _Registration:
    kind: str                    # gauge / endpoint / reader
    call_name: str               # gauge_fn / define / add_reader / ...
    pattern: Optional[str]       # abstracted name pattern (None: reader)
    receiver: Optional[str]      # dotted receiver ("self._rpc", "reg")
    node: ast.Call
    method: str


@dataclasses.dataclass
class _LifeInfo:
    node: ast.ClassDef
    methods: Dict[str, ast.AST]
    acquisitions: List[_Acq]
    #: fn name -> {(attr, release method)} release calls on self attrs
    #: (directly or through a ``t = self.X`` local alias).
    releases: Dict[str, Set[Tuple[str, str]]]
    #: fn name -> self-method / local-function names it calls.
    calls: Dict[str, Set[str]]
    #: attrs with a ``self.X.start()`` call somewhere in the class.
    started: Set[str]
    registrations: List[_Registration]
    #: releasing calls for registrations: (release call name, pattern).
    unregistrations: List[Tuple[str, Optional[str]]]
    #: receivers (dotted) that get ``.close()``d somewhere in the class.
    closed_receivers: Set[str]
    #: container attr -> self attrs its value reads (``self.brokers =
    #: [self.broker, self.standby]``): releasing the container through a
    #: ``for x in self.brokers:`` loop releases every member.
    aggregates: Dict[str, Set[str]]


def _receiver_dotted(node: ast.expr) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _method_facts(ctx: ModuleContext, info: _LifeInfo, fn: ast.AST):
    """One scoped pass over a method: acquisitions, releases (with local
    aliasing), class-local calls, registrations."""
    name = fn.name
    aliases: Dict[str, str] = {}  # local -> self attr it snapshots
    rels = info.releases.setdefault(name, set())
    calls = info.calls.setdefault(name, set())
    for node in iter_scoped_body(getattr(fn, "body", [])):
        if isinstance(node, ast.Assign):
            value = node.value
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    acq = _classify_acquisition(ctx, value)
                    if acq is not None:
                        info.acquisitions.append(_Acq(
                            attr=attr, factory=acq[0], kind=acq[1],
                            releases=acq[2], node=node, method=name,
                        ))
                    else:
                        members = {
                            a for a in (
                                _self_attr(n) for n in ast.walk(value)
                            ) if a is not None
                        }
                        if members:
                            info.aggregates.setdefault(
                                attr, set()
                            ).update(members)
                elif isinstance(t, ast.Name):
                    src = _self_attr(value)
                    if src is not None:
                        aliases[t.id] = src
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            # ``for b in self.brokers:`` — releases on the loop variable
            # count against the container attr; the aggregates map then
            # fans them out to the members.
            src = _self_attr(node.iter)
            if src is not None and isinstance(node.target, ast.Name):
                aliases[node.target.id] = src
        elif isinstance(node, ast.Call):
            f = node.func
            cname = terminal_name(f)
            if cname is None:
                continue
            if isinstance(f, ast.Attribute):
                recv_attr = _self_attr(f.value)
                recv_local = f.value.id if isinstance(f.value, ast.Name) \
                    else None
                # self.X.release() / alias.release()
                target_attr = recv_attr if recv_attr is not None \
                    else aliases.get(recv_local or "")
                if target_attr is not None:
                    rels.add((target_attr, cname))
                    if cname == "start":
                        info.started.add(target_attr)
                # class-local call graph: self.m()
                if recv_attr is None and recv_local == "self":
                    calls.add(cname)
                # registrations / unregistrations / closed receivers
                recv = _receiver_dotted(f.value)
                for kind, (reg_names, unreg_names) in \
                        _REGISTRATIONS.items():
                    if cname in reg_names:
                        pat = name_pattern(node.args[0]) if node.args \
                            else None
                        info.registrations.append(_Registration(
                            kind=kind, call_name=cname, pattern=pat,
                            receiver=recv, node=node, method=name,
                        ))
                    if cname in unreg_names:
                        pat = name_pattern(node.args[0]) if node.args \
                            else None
                        info.unregistrations.append((cname, pat))
                if cname == "close" and recv is not None:
                    info.closed_receivers.add(recv)
            elif isinstance(f, ast.Name):
                calls.add(f.id)


def _analyze_class(ctx: ModuleContext, cls: ast.ClassDef) -> _LifeInfo:
    methods = {n.name: n for n in cls.body if isinstance(n, _FN_NODES)}
    info = _LifeInfo(
        node=cls, methods=methods, acquisitions=[], releases={},
        calls={}, started=set(), registrations=[], unregistrations=[],
        closed_receivers=set(), aggregates={},
    )
    for fn in methods.values():
        _method_facts(ctx, info, fn)
    return info


def _module_classes(ctx: ModuleContext) -> List[_LifeInfo]:
    cached = getattr(ctx, "_life_classes", None)
    if cached is not None:
        return cached
    out = [
        _analyze_class(ctx, node)
        for node in ast.walk(ctx.tree) if isinstance(node, ast.ClassDef)
    ]
    ctx._life_classes = out  # type: ignore[attr-defined]
    return out


def _close_closure(info: _LifeInfo) -> Set[str]:
    """Method names reachable from any close-like method through the
    class-local call graph (the release-path closure)."""
    roots = [m for m in _CLOSE_LIKE if m in info.methods]
    seen: Set[str] = set(roots)
    work = list(roots)
    while work:
        m = work.pop()
        for callee in info.calls.get(m, ()):
            if callee in info.methods and callee not in seen:
                seen.add(callee)
                work.append(callee)
    return seen


# -- rule: lifecycle-bare-suppression ------------------------------------------


class LifecycleBareSuppression(Rule):
    name = "lifecycle-bare-suppression"
    description = (
        "a `# lifelint: intentional` marker with no reason: the grammar "
        "requires the why (`# lifelint: intentional -- <reason>`) so "
        "every suppressed lifecycle finding carries its justification "
        "in the diff; a bare marker suppresses nothing."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for line, has_reason in sorted(_life_suppressions(ctx).items()):
            if not has_reason:
                marker = ast.Module(body=[], type_ignores=[])
                marker.lineno = line  # type: ignore[attr-defined]
                marker.col_offset = 0  # type: ignore[attr-defined]
                yield self.finding(
                    ctx, marker,
                    "lifelint suppression without a reason — write "
                    "`# lifelint: intentional -- <reason>`",
                )


# -- rule: resource-no-release-path --------------------------------------------


class ResourceNoReleasePath(Rule):
    name = "resource-no-release-path"
    description = (
        "a class acquires a tracked resource (started thread, executor, "
        "shm segment, open() handle, or a project object with close()) "
        "into a self attribute but its close() never releases it "
        "(checked through class-local calls): the resource outlives the "
        "owner and leaks. Release it from close(), or annotate "
        "`# lifelint: intentional -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _life_suppressions(ctx)
        for info in _module_classes(ctx):
            if not info.acquisitions:
                continue
            closure = _close_closure(info)
            released: Dict[str, Set[str]] = {}
            for m in closure:
                for attr, rel in info.releases.get(m, ()):
                    released.setdefault(attr, set()).add(rel)
            # Releasing a container releases what it aggregates
            # (``for b in self.brokers: b.close()``).
            for container, members in info.aggregates.items():
                rels = released.get(container)
                if rels:
                    for member in members:
                        released.setdefault(member, set()).update(rels)
            reported: Set[str] = set()
            for acq in info.acquisitions:
                if acq.attr in reported:
                    continue
                # An unstarted thread holds no OS resource yet.
                if acq.factory == "Thread" and acq.attr not in info.started:
                    continue
                # Acquired inside a close-like path: re-acquisition during
                # teardown is its own pattern, not a leak we can pair.
                if acq.method in closure:
                    continue
                # Released in the acquiring method itself: a scoped temp.
                if any(attr == acq.attr and rel in acq.releases
                       for attr, rel in
                       info.releases.get(acq.method, ())):
                    continue
                if released.get(acq.attr, set()) & set(acq.releases):
                    continue
                line = getattr(acq.node, "lineno", 0)
                if _suppressed(ctx, sup, line):
                    reported.add(acq.attr)
                    continue
                reported.add(acq.attr)
                want = "/".join(f".{r}()" for r in acq.releases)
                if not any(m in info.methods for m in _CLOSE_LIKE):
                    yield self.finding(
                        ctx, acq.node,
                        f"self.{acq.attr} acquires a {acq.kind} "
                        f"({acq.factory}) but {info.node.name} has no "
                        f"close() to release it ({want}) — the resource "
                        "outlives every owner",
                    )
                else:
                    yield self.finding(
                        ctx, acq.node,
                        f"self.{acq.attr} acquires a {acq.kind} "
                        f"({acq.factory}) but no close() path of "
                        f"{info.node.name} releases it ({want}) — the "
                        "resource leaks past shutdown",
                    )


# -- rule: thread-pins-self -----------------------------------------------------


def _pins_self(call: ast.Call) -> Optional[str]:
    """The bound-method / self-closure entry of a Thread(...) call, as a
    display string; None when the entry does not pin ``self``."""
    target = None
    for kw in call.keywords:
        if kw.arg == "target":
            target = kw.value
    if target is None and call.args:
        target = call.args[0]
    if target is None:
        return None
    attr = _self_attr(target)
    if attr is not None:
        return f"self.{attr}"
    if isinstance(target, ast.Lambda):
        for n in ast.walk(target.body):
            if isinstance(n, ast.Name) and n.id == "self":
                return "a lambda closing over self"
    if isinstance(target, ast.Call) and terminal_name(target.func) == \
            "partial":
        for a in list(target.args) + [kw.value for kw in target.keywords]:
            sa = _self_attr(a)
            if sa is not None:
                return f"partial(self.{sa}, ...)"
    return None


class ThreadPinsSelf(Rule):
    name = "thread-pins-self"
    description = (
        "a Thread(target=self.m) (or executor.submit(self.m) future) "
        "stored on self: the running thread strongly pins the owner, so "
        "an abandoned object is never collected, its __del__ backstop "
        "never runs, and everything it owns leaks forever (the EnvPool "
        "supervisor bug). Use a module-level entry function holding only a "
        "weakref (statestore/store.py::_replicator_entry), or annotate "
        "`# lifelint: intentional -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _life_suppressions(ctx)
        for info in _module_classes(ctx):
            for fn in info.methods.values():
                for node in iter_scoped_body(getattr(fn, "body", [])):
                    if not isinstance(node, ast.Assign):
                        continue
                    attrs = [a for a in
                             (_self_attr(t) for t in node.targets)
                             if a is not None]
                    if not attrs:
                        continue
                    call = _resource_call(node.value)
                    if call is None:
                        continue
                    cname = terminal_name(call.func)
                    entry = None
                    if cname == "Thread":
                        entry = _pins_self(call)
                    elif cname == "submit" and call.args:
                        sa = _self_attr(call.args[0])
                        if sa is not None:
                            entry = f"self.{sa}"
                    if entry is None:
                        continue
                    line = getattr(node, "lineno", 0)
                    if _suppressed(ctx, sup, line):
                        continue
                    via = "Thread target" if cname == "Thread" \
                        else "submitted callable"
                    yield self.finding(
                        ctx, node,
                        f"self.{attrs[0]} stores a long-lived thread "
                        f"whose {via} is {entry}: the running thread "
                        f"pins the {info.node.name} against GC, so an "
                        "abandoned instance never collects and its "
                        "resources leak — use a module-level entry "
                        "holding a weakref to self",
                    )


# -- rule: del-heavy-work --------------------------------------------------------


def _heavy_calls(body: Sequence[ast.stmt]) -> List[Tuple[ast.AST, str]]:
    """(node, why) for every lock acquisition, registry call, or I/O call
    directly in ``body`` (scoped walk)."""
    out: List[Tuple[ast.AST, str]] = []
    for node in iter_scoped_body(body):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                attr = _self_attr(expr)
                if attr is None and isinstance(expr, ast.Attribute):
                    attr = expr.attr
                elif attr is None and isinstance(expr, ast.Name):
                    attr = expr.id
                if attr is not None and _is_lockish_name(attr):
                    out.append((node, f"acquires lock {attr!r}"))
        elif isinstance(node, ast.Call):
            cname = terminal_name(node.func)
            if cname in _DEL_LOCK_CALLS:
                out.append((node, "acquires a lock (.acquire())"))
            elif cname in _DEL_REGISTRY_CALLS:
                out.append((
                    node,
                    f"calls into the telemetry registry ({cname})",
                ))
            elif cname in _DEL_IO_CALLS:
                out.append((node, f"does blocking I/O ({cname})"))
    return out


def _finalizer_callbacks(ctx: ModuleContext, info: Optional[_LifeInfo],
                         call: ast.Call) -> Optional[ast.AST]:
    """Resolve the callback of ``weakref.finalize(obj, cb, ...)`` to a
    function node visible from ``ctx`` (module function, one import hop,
    self method, or lambda)."""
    if len(call.args) < 2:
        return None
    cb = call.args[1]
    if isinstance(cb, ast.Lambda):
        return cb
    attr = _self_attr(cb)
    if attr is not None and info is not None:
        return info.methods.get(attr)
    if isinstance(cb, ast.Name):
        resolved = ctx.project.resolve_function(ctx, cb.id)
        if resolved is not None:
            return resolved[1]
    return None


class DelHeavyWork(Rule):
    name = "del-heavy-work"
    description = (
        "__del__ / weakref.finalize callback acquires a lock, does I/O, "
        "or calls into the telemetry registry: finalizers run on "
        "whatever thread the GC interrupts — possibly while it already "
        "holds the very lock the finalizer wants (the GC deadlock "
        "locktrace caught). Keep finalizers to lock-free flag flips and "
        "best-effort os-level cleanup, or annotate "
        "`# lifelint: intentional -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _life_suppressions(ctx)
        infos = _module_classes(ctx)
        by_class: Dict[int, _LifeInfo] = {id(i.node): i for i in infos}
        # __del__ bodies: direct triggers plus ONE class-local call hop.
        for info in infos:
            dtor = info.methods.get("__del__")
            if dtor is None:
                continue
            hits = _heavy_calls(dtor.body)
            for callee in sorted(info.calls.get("__del__", ())):
                m = info.methods.get(callee)
                if m is None:
                    continue
                for _node, why in _heavy_calls(m.body):
                    hits.append((
                        dtor, f"calls self.{callee}() which {why}"
                    ))
                    break
            seen: Set[str] = set()
            for node, why in hits:
                line = getattr(node, "lineno", 0)
                if why in seen or _suppressed(ctx, sup, line):
                    seen.add(why)
                    continue
                seen.add(why)
                yield self.finding(
                    ctx, node,
                    f"{info.node.name}.__del__ {why}: a finalizer runs "
                    "mid-GC on an arbitrary thread and can deadlock or "
                    "block collection — flip flags and leave real "
                    "teardown to close()",
                )
        # weakref.finalize callbacks anywhere in the module.
        cls_of: Dict[int, _LifeInfo] = {}
        for info in infos:
            for n in ast.walk(info.node):
                cls_of.setdefault(id(n), info)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if terminal_name(node.func) != "finalize":
                continue
            cb = _finalizer_callbacks(ctx, cls_of.get(id(node)), node)
            if cb is None:
                continue
            body = [ast.Expr(value=cb.body)] if isinstance(cb, ast.Lambda) \
                else list(getattr(cb, "body", []))
            for hit, why in _heavy_calls(body):
                line = getattr(node, "lineno", 0)
                if _suppressed(ctx, sup, line) or _suppressed(
                        ctx, sup, getattr(hit, "lineno", 0)):
                    continue
                yield self.finding(
                    ctx, node,
                    f"weakref.finalize callback {why}: finalizers run "
                    "mid-GC on an arbitrary thread and can deadlock or "
                    "block collection — keep them lock-free",
                )
                break


# -- rule: close-not-idempotent ---------------------------------------------------


def _latch_lines(close_fn: ast.AST) -> List[int]:
    """Lines of early-return latches in ``close()``: an If whose test
    reads a self attribute and whose body returns."""
    out: List[int] = []
    for node in iter_scoped_body(close_fn.body):
        if not isinstance(node, ast.If):
            continue
        reads_self = any(
            _self_attr(n) is not None for n in ast.walk(node.test)
        )
        if not reads_self:
            continue
        if any(isinstance(s, ast.Return) for s in node.body):
            out.append(node.lineno)
    return out


def _guarded_by_if(fn: ast.AST, trigger: ast.Call) -> bool:
    """True when the trigger call sits inside an If (or While) whose test
    mentions the trigger's receiver — the per-resource None-check guard
    (``t = self._x; if t is not None: t.join()``)."""
    recv = trigger.func.value if isinstance(trigger.func, ast.Attribute) \
        else None
    names: Set[str] = set()
    if isinstance(recv, ast.Name):
        names.add(recv.id)
    else:
        attr = _self_attr(recv) if recv is not None else None
        if attr is not None:
            names.add(attr)
    if not names:
        return False

    found = [False]

    def visit(node: ast.AST, guarded: bool):
        if node is trigger and guarded:
            found[0] = True
            return
        g = guarded
        if isinstance(node, (ast.If, ast.While)):
            test_names = {
                n.id for n in ast.walk(node.test)
                if isinstance(n, ast.Name)
            } | {
                a for a in (
                    _self_attr(n) for n in ast.walk(node.test)
                ) if a is not None
            }
            if names & test_names:
                g = True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        for child in ast.iter_child_nodes(node):
            visit(child, g)

    visit(fn, False)
    return found[0]


class CloseNotIdempotent(Rule):
    name = "close-not-idempotent"
    description = (
        "close() re-runs one-shot release effects (join/unlink/shutdown/"
        "unregister/undefine/...) with neither an early-return latch on "
        "a self flag (`if self._closed: return`) nor a per-resource "
        "guard: close() is called from __del__ backstops, error paths, "
        "and user code — the second call double-releases or raises (the "
        "idempotence contract). Add the latch, or annotate "
        "`# lifelint: intentional -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _life_suppressions(ctx)
        for info in _module_classes(ctx):
            close_fn = info.methods.get("close")
            if close_fn is None:
                continue
            triggers = [
                n for n in iter_scoped_body(close_fn.body)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _ONESHOT_RELEASES
            ]
            if not triggers:
                continue
            latches = _latch_lines(close_fn)
            first_trigger = min(
                getattr(t, "lineno", 0) for t in triggers
            )
            if any(line <= first_trigger for line in latches):
                continue
            unguarded = [
                t for t in triggers if not _guarded_by_if(close_fn, t)
            ]
            if not unguarded:
                continue
            site = min(unguarded, key=lambda t: getattr(t, "lineno", 0))
            line = getattr(site, "lineno", 0)
            if _suppressed(ctx, sup, line) or _suppressed(
                    ctx, sup, close_fn.lineno):
                continue
            effects = ", ".join(sorted({
                t.func.attr for t in unguarded  # type: ignore[union-attr]
            }))
            yield self.finding(
                ctx, site,
                f"{info.node.name}.close() re-runs one-shot release "
                f"effects ({effects}) on a second call: no early-return "
                "latch on a self flag and no per-resource guard — add "
                "`if self._closed: return` / `self._closed = True` at "
                "the top (the close() idempotence contract)",
            )


# -- rule: registration-outlives-owner --------------------------------------------


class RegistrationOutlivesOwner(Rule):
    name = "registration-outlives-owner"
    description = (
        "a gauge_fn/endpoint/reader registration in __init__ has no "
        "matching unregister/undefine/remove_reader anywhere in the "
        "class (and the receiver is not closed by the class): the "
        "registry holds a strong reference, so the closed object stays "
        "reachable and scrapes/dispatch keep calling into it (the "
        "gauge-closure family). Unregister in close(), or annotate "
        "`# lifelint: intentional -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        sup = _life_suppressions(ctx)
        for info in _module_classes(ctx):
            regs = [r for r in info.registrations if r.method == "__init__"]
            if not regs:
                continue
            unreg_by_kind: Dict[str, List[Optional[str]]] = {}
            for call_name, pat in info.unregistrations:
                for kind, (_r, unreg_names) in _REGISTRATIONS.items():
                    if call_name in unreg_names:
                        unreg_by_kind.setdefault(kind, []).append(pat)
            for reg in regs:
                # Receiver closed by the class: registrations die with it
                # (``self._rpc = Rpc(...)`` ... ``self._rpc.close()``).
                if reg.receiver is not None \
                        and reg.receiver in info.closed_receivers:
                    continue
                pats = unreg_by_kind.get(reg.kind, [])
                if reg.kind == "reader":
                    if pats:
                        continue  # any remove_reader pairs a reader
                else:
                    if reg.pattern is None:
                        continue  # unresolvable name: stay silent
                    # An unresolvable unregister name (``for name in
                    # self._gauge_names: reg.unregister(name)``) must
                    # silence every registration of its kind — the
                    # engine-wide silence bias.
                    if any(p is None or patterns_overlap(reg.pattern, p)
                           for p in pats):
                        continue
                line = getattr(reg.node, "lineno", 0)
                if _suppressed(ctx, sup, line):
                    continue
                what = reg.pattern and pattern_display(reg.pattern) \
                    or reg.call_name
                release = "/".join(_REGISTRATIONS[reg.kind][1])
                yield self.finding(
                    ctx, reg.node,
                    f"{reg.call_name}({what!r}) in "
                    f"{info.node.name}.__init__ has no matching "
                    f"{release} in the class and the receiver is never "
                    "closed here: the registration outlives the owner "
                    "and pins it (or dispatches into a closed object) — "
                    "unregister in close()",
                )


RULES = [
    LifecycleBareSuppression,
    ResourceNoReleasePath,
    ThreadPinsSelf,
    DelHeavyWork,
    CloseNotIdempotent,
    RegistrationOutlivesOwner,
]
