"""locktrace: the dynamic mirror of racelint's lock-order analysis; the
counterpart of :mod:`moolib_tpu.testing.locktrace`.

While active, every ``threading.Lock()`` / ``threading.RLock()`` created
anywhere in the process is wrapped in a tracing proxy (``Condition``
rides along: it builds on the patched ``RLock``). Each thread carries a
context-var held-set; acquiring lock B while holding lock A records the
*acquires-while-holding* edge A→B with the stack at its first
observation. An inversion is two opposing edges, so its report carries
both offending stacks — one per edge. After a run:

- :meth:`LockTrace.assert_acyclic` fails if the observed graph has a
  cycle (a real lock-order inversion, with the two stacks that form it);
- :meth:`LockTrace.assert_within` fails if an observed edge is missing
  from the static over-approximation
  (:func:`moolib_tpu_torch.analysis.rules_race.static_lock_edges`) —
  i.e. the running system took a nesting the static analysis cannot see,
  so the static cycle check is no longer a safety proof.

Locks are *named from their creation site*: the innermost stack frame
inside the root (the repo, by default) at construction time, whose
source line is parsed for the ``self._lock = ...`` / ``name = ...``
binding — yielding the same
``(path, attr)`` key the static analysis uses. Only a direct
``Lock(``/``RLock(``/``Condition(`` call on that line names a lock: locks
that torch's own Python code creates while a trace is active (its
profiler, lazy CUDA initialisation, a ``queue.Queue``'s condition built
from a package line) and pytest's or the stdlib's machinery stay unnamed
and are invisible to the graph; locks created before
:meth:`activate` are untraced entirely, so a trace only covers objects
constructed inside the active window.

Two deliberate blind spots, both conservative: ``Condition.wait``
releases/reacquires through private fast paths that bypass the proxy's
bookkeeping (the held-set keeps the condition's lock across the wait —
edges recorded while "waiting" over-approximate, never miss); and edges
between two locks with the SAME name (two instances of one class's
``_lock``) are recorded but excluded from the cycle check — sibling
instances share no deadlock ordering the name-level graph could express.

Usage::

    from moolib_tpu_torch.testing.locktrace import LockTrace
    with LockTrace() as trace:
        run_scenario()
    trace.assert_acyclic()
    trace.assert_within(static_edges)   # optional subset check
"""

from __future__ import annotations

import contextvars
import linecache
import re
import sys
import threading
import traceback
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

__all__ = ["LockOrderViolation", "LockTrace", "TracedLock",
           "static_package_edges"]

_PKG_ROOT = Path(__file__).resolve().parent.parent  # moolib_tpu_torch/
_REPO_ROOT = _PKG_ROOT.parent

_BIND_RE = re.compile(r"(?:self\.)?([A-Za-z_]\w*)\s*[:=]")
# Only a DIRECT factory call at the binding line names a lock — the same
# shape the static analysis indexes. Locks born inside stdlib machinery
# (Thread's ready-Event, Queue's mutex, executor internals) bind to
# lines like ``self._thread = threading.Thread(...)`` and must stay
# unnamed/invisible, exactly as they are statically.
_FACTORY_RE = re.compile(r"\b(?:Lock|RLock|Condition)\s*\(")

# Per-thread (threads start fresh contexts) ordered tuple of currently
# held TracedLocks: (id, name-or-None, reentry count).
_held: contextvars.ContextVar[Tuple[Tuple[int, Optional[Tuple[str, str]], int], ...]] = \
    contextvars.ContextVar("locktrace_held", default=())


class LockOrderViolation(AssertionError):
    """An observed lock-order inversion (or an edge outside the static
    graph); the message carries the first-observation stack of every
    edge in the cycle — for an A→B/B→A inversion, both sides."""


class _EdgeRecord:
    __slots__ = ("src", "dst", "acquire_stack", "count",
                 "same_name_distinct")

    def __init__(self, src, dst, acquire_stack, same_name_distinct):
        self.src = src
        self.dst = dst
        #: Stack of the acquisition that FIRST formed this edge (the
        #: thread held src and took dst here). A cycle's report shows
        #: one of these per edge — both sides of an inversion.
        self.acquire_stack = acquire_stack
        self.count = 1
        self.same_name_distinct = same_name_distinct


# (filename, root) -> the filename's root-relative posix path, or None
# outside the root: resolving a path stats the file system, and a trace
# names every lock created while it is active (a Future's condition, a
# queue's mutex), so each filename is resolved once.
_rel_paths: Dict[Tuple[str, Path], Optional[str]] = {}


def _rel_path(filename: str, root: Path) -> Optional[str]:
    key = (filename, root)
    try:
        return _rel_paths[key]
    except KeyError:
        pass
    try:
        rel = Path(filename).resolve().relative_to(root)
    except (ValueError, OSError):
        out = None
    else:
        out = None if (rel.parts[:2] == ("moolib_tpu_torch", "testing")
                       and rel.name == "locktrace.py") else rel.as_posix()
    _rel_paths[key] = out
    return out


def _name_from_frame(frame, root: Path,
                     limit: int = 8) -> Optional[Tuple[str, str]]:
    """(root-relative path, bound attr) from the innermost in-root frame
    among ``frame`` and its ``limit - 1`` callers (the creation stack),
    or None when the lock was born outside the root or the line has no
    recognizable binding. Only in-root frames read their source line."""
    for _ in range(limit):
        if frame is None:
            return None
        rel = _rel_path(frame.f_code.co_filename, root)
        if rel is not None:
            text = linecache.getline(frame.f_code.co_filename,
                                     frame.f_lineno).strip()
            if text and _FACTORY_RE.search(text):
                m = _BIND_RE.match(text)
                if m is not None:
                    return (rel, m.group(1))
        frame = frame.f_back
    return None


class TracedLock:
    """Proxy around a real lock primitive. Unknown attributes delegate to
    the wrapped lock, so ``Condition``'s ``_is_owned`` /
    ``_acquire_restore`` / ``_release_save`` fast paths keep working
    (they bypass the proxy's bookkeeping — see the module docstring)."""

    def __init__(self, inner, trace: "LockTrace",
                 name: Optional[Tuple[str, str]]):
        self._inner = inner
        self._trace = trace
        self._name = name

    # -- bookkeeping ---------------------------------------------------------

    def _note_acquired(self):
        held = _held.get()
        me = id(self)
        for i, (lid, lname, count) in enumerate(held):
            if lid == me:
                # Reentrant re-acquire: count up, no edge.
                _held.set(held[:i] + ((lid, lname, count + 1),)
                          + held[i + 1:])
                return
        if self._trace.active and self._name is not None:
            self._trace._record(held, self)
        _held.set(held + ((me, self._name, 1),))

    def _note_released(self):
        held = _held.get()
        me = id(self)
        for i in range(len(held) - 1, -1, -1):
            lid, lname, count = held[i]
            if lid == me:
                if count > 1:
                    _held.set(held[:i] + ((lid, lname, count - 1),)
                              + held[i + 1:])
                else:
                    _held.set(held[:i] + held[i + 1:])
                return

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self):
        self._inner.release()
        self._note_released()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<TracedLock {self._name} of {self._inner!r}>"


class LockTrace:
    """Patch ``threading.Lock``/``threading.RLock`` so every lock created
    while active is a :class:`TracedLock`; collect the observed
    acquires-while-holding graph."""

    def __init__(self, root: Optional[Path] = None):
        #: Paths are keyed relative to this root — the repo root by
        #: default, so names line up with rules_race.static_lock_edges.
        self.root = Path(root).resolve() if root is not None else _REPO_ROOT
        self.active = False
        self._meta = threading.Lock()  # created pre-patch: a real lock
        self._edges: Dict[Tuple[Tuple[str, str], Tuple[str, str]],
                          _EdgeRecord] = {}
        self._orig_lock = None
        self._orig_rlock = None

    # -- lifecycle -----------------------------------------------------------

    def activate(self) -> "LockTrace":
        if self._orig_lock is not None:
            raise RuntimeError("LockTrace already active")
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock

        def make(factory):
            def build(*args, **kwargs):
                inner = factory(*args, **kwargs)
                name = _name_from_frame(sys._getframe(), self.root)
                return TracedLock(inner, self, name)
            return build

        threading.Lock = make(self._orig_lock)
        threading.RLock = make(self._orig_rlock)
        self.active = True
        return self

    def deactivate(self):
        if self._orig_lock is None:
            return
        threading.Lock = self._orig_lock
        threading.RLock = self._orig_rlock
        self._orig_lock = self._orig_rlock = None
        # Existing TracedLocks keep working but stop recording.
        self.active = False

    def __enter__(self) -> "LockTrace":
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()
        return False

    # -- recording -----------------------------------------------------------

    def _record(self, held, acquiring: TracedLock):
        dst = acquiring._name
        stack: Optional[str] = None
        for _lid, src, _count in held:
            if src is None:
                continue
            key = (src, dst)
            with self._meta:
                rec = self._edges.get(key)
                if rec is not None:
                    rec.count += 1
                    continue
                if stack is None:
                    # Captured once, only when a NEW edge appears: the
                    # steady-state cost of tracing is dict lookups.
                    stack = "".join(traceback.format_stack()[-12:])
                self._edges[key] = _EdgeRecord(
                    src, dst,
                    acquire_stack=stack,
                    same_name_distinct=(src == dst),
                )

    # -- results -------------------------------------------------------------

    def edges(self, *, include_same_name: bool = False) \
            -> Set[Tuple[Tuple[str, str], Tuple[str, str]]]:
        with self._meta:
            return {
                k for k, rec in self._edges.items()
                if include_same_name or not rec.same_name_distinct
            }

    def edge_records(self) -> List[_EdgeRecord]:
        with self._meta:
            return list(self._edges.values())

    def cycles(self) -> List[List[Tuple[Tuple[str, str], Tuple[str, str]]]]:
        """Shortest representative cycle per strongly-connected component
        of the observed (named, cross-name) edge set."""
        edges = self.edges()
        adj: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for s, d in edges:
            adj.setdefault(s, []).append(d)
        out = []
        seen_pairs: Set[FrozenSet[Tuple[str, str]]] = set()
        for s, d in sorted(edges):
            if (d, s) in edges and frozenset((s, d)) not in seen_pairs:
                seen_pairs.add(frozenset((s, d)))
                out.append([(s, d), (d, s)])
        # Longer cycles: DFS back-edge search (graphs here are tiny).
        for start in sorted(adj):
            path: List[Tuple[str, str]] = []
            on: Set[Tuple[str, str]] = set()

            def dfs(node) -> Optional[List]:
                if node == start and path:
                    return list(path)
                if node in on:
                    return None
                on.add(node)
                path.append(node)
                for nxt in adj.get(node, ()):  # pragma: no branch
                    found = dfs(nxt)
                    if found is not None:
                        return found
                path.pop()
                return None

            found = None
            for nxt in adj.get(start, ()):
                if nxt == start:
                    continue
                path = [start]
                on = {start}
                found = dfs(nxt)
                if found and len(found) > 2:
                    cyc = [
                        (found[i], found[(i + 1) % len(found)])
                        for i in range(len(found))
                    ]
                    key = frozenset(found)
                    if key not in seen_pairs:
                        seen_pairs.add(key)
                        out.append(cyc)
                    break
        return out

    @staticmethod
    def _fmt(name: Tuple[str, str]) -> str:
        return f"{name[0]}:{name[1]}"

    def assert_acyclic(self):
        """Raise :class:`LockOrderViolation` (with both stacks of the
        offending edges) if the observed graph has a cycle."""
        cycles = self.cycles()
        if not cycles:
            return
        cyc = cycles[0]
        lines = ["observed lock-order inversion: "
                 + " -> ".join(self._fmt(s) for s, _d in cyc)
                 + f" -> {self._fmt(cyc[0][0])}"]
        with self._meta:
            for edge in cyc:
                rec = self._edges.get(edge)
                if rec is None:
                    continue
                lines.append(
                    f"\nedge {self._fmt(edge[0])} -> "
                    f"{self._fmt(edge[1])} first observed at:\n"
                    f"{rec.acquire_stack}"
                )
        raise LockOrderViolation("".join(lines))

    def assert_within(
        self,
        static_edges: Set[Tuple[Tuple[str, str], Tuple[str, str]]],
    ):
        """Every observed cross-name edge must appear in the static
        over-approximation — otherwise the running system nests locks in
        a way the static cycle check cannot see, and its "acyclic"
        verdict is no longer a proof."""
        unknown = sorted(self.edges() - set(static_edges))
        if not unknown:
            return
        with self._meta:
            detail = "\n".join(
                f"  {self._fmt(s)} -> {self._fmt(d)}\n"
                + (self._edges[(s, d)].acquire_stack
                   if (s, d) in self._edges else "")
                for s, d in unknown
            )
        raise LockOrderViolation(
            f"{len(unknown)} observed lock edge(s) missing from the "
            "static acquires-while-holding graph (extend "
            "rules_race.static_lock_edges resolution or restructure):\n"
            + detail
        )


def static_package_edges() \
        -> Set[Tuple[Tuple[str, str], Tuple[str, str]]]:
    """The static over-approximation for the whole port, keyed relative
    to the repo root as the tracer's names are — the default
    ``assert_within`` argument for the tests and ``chaos_soak
    --locktrace``."""
    from ..analysis.rules_race import static_lock_edges

    return static_lock_edges([_PKG_ROOT], root=_REPO_ROOT)
