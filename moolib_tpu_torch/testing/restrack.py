"""restrack: resource-lifecycle tracking at run time; the port's twin
of :mod:`moolib_tpu.testing.restrack`.

While active, the tracked constructors are patched so every acquisition
of an OS-level resource made anywhere in the process is recorded with
the stack of its acquisition site, and every matching release is paired
back to it:

- ``threading.Thread.start`` — a started thread is an acquisition; it is
  released when it is no longer alive (joined, or exited on its own).
  Threads whose target is a *module-level function taking a weakref*
  (the thread-pins-self convention, and stdlib executor workers) are
  exempt from the leak report when still alive at assert time: they
  cannot pin their owner and exit on their own once the owner dies —
  see :data:`_Acq.weakref_entry`.
- ``multiprocessing.shared_memory.SharedMemory`` — creating a segment
  (``create=True``) must be paired with ``unlink()`` (a leaked
  ``/dev/shm`` entry outlives the process); attaching to one must be
  paired with ``close()``.
- the port's ``Rpc.__init__`` / ``Rpc.close`` — an Rpc owns a socket, an
  asyncio loop, an io thread, and an executor; it must be closed. An Rpc
  that was garbage-collected is dropped from the report (its io thread,
  if leaked, is reported by the thread tracker — one leak, one report).
- the port's ``Registry.gauge_fn`` / ``Registry.unregister`` — a gauge
  registration pins its closure; it must be unregistered unless its
  whole registry died first.

Only acquisitions whose call stack passes through the port are tracked:
a frame counts when its file lies in the ``moolib_tpu_torch`` package
directory or is one of the port's test files (``tests/test_torch_*.py``).
The reference package's directory, ``moolib_tpu``, is a prefix of the
port's name but not its directory, so nothing the reference acquires is
tracked; stdlib and pytest internals stay invisible too.

Usage (the chaos_soak / tier-1 shape)::

    with ResourceTracker() as tracker:
        tok = tracker.mark()
        run_scenario()
        tracker.assert_released(since=tok, what="drop_storm")

:meth:`ResourceTracker.assert_released` first runs a GC pass plus a
bounded grace join (weakref-entry threads need one wait-tick to notice
their owner died), then raises :class:`ResourceLeak` naming every
unreleased acquisition *and the stack of the line that acquired it*.
"""

from __future__ import annotations

import gc
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ResourceLeak", "ResourceTracker"]

_PKG_ROOT = Path(__file__).resolve().parent.parent  # moolib_tpu_torch/
_REPO_ROOT = _PKG_ROOT.parent
_SELF = Path(__file__).resolve()


def _port_frame(path: Path) -> "str | None":
    """The repo-relative path of a frame's file when it belongs to the
    port (its package directory or one of its test files), else None."""
    try:
        rel = path.relative_to(_REPO_ROOT)
    except ValueError:
        return None
    if rel.parts[0] == _PKG_ROOT.name:
        return None if path == _SELF else rel.as_posix()
    if (len(rel.parts) == 2 and rel.parts[0] == "tests"
            and rel.name.startswith("test_torch_")):
        return rel.as_posix()
    return None


class ResourceLeak(AssertionError):
    """One or more tracked acquisitions were never released; the message
    names each leak's kind, identity, and acquisition-site stack."""


class _Acq:
    """One tracked acquisition."""

    __slots__ = ("kind", "label", "stack", "ref", "released",
                 "weakref_entry", "closed", "unlinked", "created")

    def __init__(self, kind: str, label: str, stack: str,
                 ref: Optional[weakref.ref] = None, *,
                 weakref_entry: bool = False, created: bool = False):
        self.kind = kind
        self.label = label
        #: Formatted stack of the acquisition site (the leak report's
        #: payload: *where* the resource was acquired, not where it was
        #: noticed leaking).
        self.stack = stack
        self.ref = ref
        self.released = False
        self.weakref_entry = weakref_entry
        self.created = created
        self.closed = False
        self.unlinked = False


def _site_stack(limit: int = 16) -> Tuple[Optional[str], str]:
    """(innermost port "path:line" or None, formatted stack trimmed to
    the port's frames). Acquisitions with no frame of the port are not
    tracked at all."""
    stack = traceback.extract_stack(limit=limit)
    site = None
    kept = []
    for frame in stack:
        try:
            rel = _port_frame(Path(frame.filename).resolve())
        except OSError:
            continue
        if rel is None:
            continue
        kept.append(frame)
        site = f"{rel}:{frame.lineno}"
    if site is None:
        return None, ""
    text = "".join(traceback.format_list(kept))
    return site, text


def _is_weakref_entry(thread: threading.Thread) -> bool:
    """The thread-pins-self convention: a module-level target (not a bound
    method) holding only a ``weakref.ref`` to its owner. Such a thread
    cannot pin anything and exits on its own once the owner dies."""
    target = getattr(thread, "_target", None)
    if target is None or getattr(target, "__self__", None) is not None:
        return False
    args = tuple(getattr(thread, "_args", ()) or ())
    kwargs = dict(getattr(thread, "_kwargs", {}) or {})
    return any(isinstance(a, weakref.ref)
               for a in args + tuple(kwargs.values()))


class ResourceTracker:
    """Patch the tracked constructors; collect acquisition/release
    pairings; assert leak-freedom at scenario boundaries."""

    def __init__(self):
        self.active = False
        self._meta = threading.Lock()
        self._acqs: List[_Acq] = []
        # key -> _Acq for O(1) release pairing. Keys are id()-based and
        # pruned by weakref callbacks, so a recycled id can never pair a
        # release against a dead record.
        self._by_key: Dict[Tuple[str, int], _Acq] = {}
        self._reg_keys: Dict[Tuple[int, str, Tuple], _Acq] = {}
        self._orig: Dict[str, Any] = {}

    # -- lifecycle -----------------------------------------------------------

    def activate(self) -> "ResourceTracker":
        if self.active:
            raise RuntimeError("ResourceTracker already active")
        import multiprocessing.shared_memory as mp_shm

        from ..rpc.rpc import Rpc
        from ..telemetry.registry import Registry

        tracker = self

        orig_start = threading.Thread.start
        self._orig["thread_start"] = orig_start

        def start(thread, *a, **k):
            res = orig_start(thread, *a, **k)
            tracker._note_thread(thread)
            return res

        threading.Thread.start = start

        orig_shm_init = mp_shm.SharedMemory.__init__
        orig_shm_close = mp_shm.SharedMemory.close
        orig_shm_unlink = mp_shm.SharedMemory.unlink
        self._orig["shm"] = (orig_shm_init, orig_shm_close, orig_shm_unlink)

        def shm_init(shm, *a, **k):
            orig_shm_init(shm, *a, **k)
            created = bool(k.get("create", False)
                           or (len(a) >= 2 and a[1]))
            tracker._note_shm(shm, created)

        def shm_close(shm):
            orig_shm_close(shm)
            tracker._note_release("shm", shm, part="close")

        def shm_unlink(shm):
            orig_shm_unlink(shm)
            tracker._note_release("shm", shm, part="unlink")

        mp_shm.SharedMemory.__init__ = shm_init
        mp_shm.SharedMemory.close = shm_close
        mp_shm.SharedMemory.unlink = shm_unlink

        orig_rpc_init = Rpc.__init__
        orig_rpc_close = Rpc.close
        self._orig["rpc"] = (Rpc, orig_rpc_init, orig_rpc_close)

        def rpc_init(rpc, *a, **k):
            orig_rpc_init(rpc, *a, **k)
            tracker._note_obj("rpc", rpc, f"Rpc({rpc.get_name()!r})")

        def rpc_close(rpc):
            orig_rpc_close(rpc)
            tracker._note_release("rpc", rpc)

        Rpc.__init__ = rpc_init
        Rpc.close = rpc_close

        orig_gauge_fn = Registry.gauge_fn
        orig_unregister = Registry.unregister
        self._orig["registry"] = (Registry, orig_gauge_fn, orig_unregister)

        def gauge_fn(reg, name, fn, **labels):
            res = orig_gauge_fn(reg, name, fn, **labels)
            tracker._note_registration(reg, name, labels)
            return res

        def unregister(reg, name, **labels):
            res = orig_unregister(reg, name, **labels)
            tracker._note_unregistration(reg, name, labels)
            return res

        Registry.gauge_fn = gauge_fn
        Registry.unregister = unregister

        self.active = True
        return self

    def deactivate(self):
        if not self.active:
            return
        import multiprocessing.shared_memory as mp_shm

        threading.Thread.start = self._orig.pop("thread_start")
        shm_init, shm_close, shm_unlink = self._orig.pop("shm")
        mp_shm.SharedMemory.__init__ = shm_init
        mp_shm.SharedMemory.close = shm_close
        mp_shm.SharedMemory.unlink = shm_unlink
        rpc_cls, rpc_init, rpc_close = self._orig.pop("rpc")
        rpc_cls.__init__ = rpc_init
        rpc_cls.close = rpc_close
        reg_cls, gauge_fn, unregister = self._orig.pop("registry")
        reg_cls.gauge_fn = gauge_fn
        reg_cls.unregister = unregister
        self.active = False

    def __enter__(self) -> "ResourceTracker":
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()
        return False

    # -- recording -----------------------------------------------------------

    def _add(self, acq: _Acq, key: Optional[Tuple[str, int]] = None):
        with self._meta:
            self._acqs.append(acq)
            if key is not None:
                self._by_key[key] = acq

    def _drop_key(self, key: Tuple[str, int]):
        # weakref callback: the object died; its id may be recycled, so
        # the key must stop pairing releases to this record.
        with self._meta:
            self._by_key.pop(key, None)

    def _note_thread(self, thread: threading.Thread):
        site, stack = _site_stack()
        if site is None:
            return
        key = ("thread", id(thread))
        try:
            ref = weakref.ref(thread, lambda _r: self._drop_key(key))
        except TypeError:
            ref = None
        self._add(
            _Acq("thread", f"Thread({thread.name!r}) at {site}", stack,
                 ref, weakref_entry=_is_weakref_entry(thread)),
            key,
        )

    def _note_shm(self, shm, created: bool):
        site, stack = _site_stack()
        if site is None:
            return
        key = ("shm", id(shm))
        try:
            ref = weakref.ref(shm, lambda _r: self._drop_key(key))
        except TypeError:
            ref = None
        what = "created" if created else "attached"
        self._add(
            _Acq("shm", f"SharedMemory({shm.name!r}, {what}) at {site}",
                 stack, ref, created=created),
            key,
        )

    def _note_obj(self, kind: str, obj, label: str):
        site, stack = _site_stack()
        if site is None:
            return
        key = (kind, id(obj))
        try:
            ref = weakref.ref(obj, lambda _r: self._drop_key(key))
        except TypeError:
            ref = None
        self._add(_Acq(kind, f"{label} at {site}", stack, ref), key)

    def _note_release(self, kind: str, obj, part: Optional[str] = None):
        with self._meta:
            acq = self._by_key.get((kind, id(obj)))
            if acq is None:
                return
            if kind == "shm":
                if part == "close":
                    acq.closed = True
                elif part == "unlink":
                    acq.unlinked = True
                # A created segment owes an unlink (the /dev/shm entry
                # outlives the fd); an attached handle only owes close.
                acq.released = (acq.unlinked if acq.created
                                else acq.closed)
            else:
                acq.released = True

    def _note_registration(self, reg, name: str, labels: Dict[str, Any]):
        site, stack = _site_stack()
        if site is None:
            return
        lkey = tuple(sorted(labels.items()))
        key = (id(reg), name, lkey)
        try:
            regref = weakref.ref(reg)
        except TypeError:
            regref = None
        with self._meta:
            prior = self._reg_keys.get(key)
            if prior is not None and not prior.released:
                return  # replace-semantics re-register: same acquisition
        acq = _Acq("registration",
                   f"gauge_fn({name!r}, {dict(lkey)!r}) at {site}",
                   stack, regref)
        self._add(acq)
        with self._meta:
            self._reg_keys[key] = acq

    def _note_unregistration(self, reg, name: str,
                             labels: Dict[str, Any]):
        key = (id(reg), name, tuple(sorted(labels.items())))
        with self._meta:
            acq = self._reg_keys.get(key)
            if acq is not None:
                acq.released = True

    # -- results -------------------------------------------------------------

    def mark(self) -> int:
        """Snapshot token: the number of acquisitions recorded so far.
        Pass to :meth:`assert_released`/:meth:`live` to scope the check
        to everything acquired after this point."""
        with self._meta:
            return len(self._acqs)

    def _leaked(self, acq: _Acq) -> bool:
        if acq.released:
            return False
        if acq.kind == "thread":
            thread = acq.ref() if acq.ref is not None else None
            if thread is None or not thread.is_alive():
                return False  # exited (or collected): released
            return not acq.weakref_entry
        if acq.kind == "rpc":
            # A collected Rpc is dropped: a leaked io thread, if any,
            # is the thread tracker's report — one leak, one entry.
            return acq.ref is not None and acq.ref() is not None
        if acq.kind == "registration":
            # Registrations die with their registry.
            return acq.ref is None or acq.ref() is not None
        return True

    def live(self, since: int = 0) -> List[_Acq]:
        """Unreleased acquisitions recorded at or after ``since``."""
        with self._meta:
            window = list(self._acqs[since:])
        return [a for a in window if self._leaked(a)]

    def counts(self, since: int = 0) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for acq in self.live(since):
            out[acq.kind] = out.get(acq.kind, 0) + 1
        return out

    def assert_released(self, since: int = 0, what: str = "scenario",
                        grace: float = 2.0):
        """GC + bounded grace join, then raise :class:`ResourceLeak` if
        anything acquired at or after ``since`` is still unreleased."""
        deadline = time.monotonic() + grace
        gc.collect()
        while self.live(since) and time.monotonic() < deadline:
            # One wait-tick: weakref-entry threads poll their owner at
            # 0.2s; SharedMemory.__del__ closes on collection.
            time.sleep(0.1)
            gc.collect()
        leaks = self.live(since)
        if not leaks:
            return
        lines = [f"{len(leaks)} leaked acquisition(s) after {what}:"]
        for acq in leaks:
            lines.append(f"\n[{acq.kind}] {acq.label} — acquired at:\n"
                         f"{acq.stack}")
        raise ResourceLeak("".join(lines))
