"""hotwatch of the port: count the synchronous device->host reads that
actually happen in a steady-state window; the counterpart of
:mod:`moolib_tpu.testing.hotwatch`.

A :class:`Hotwatch` scopes transfer accounting plus a compile counter to
a steady-state window — the shape the learner tests and the bench suite
use: warm up outside the window, enter it, run N steps, and any
unbudgeted synchronous device->host materialization raises
:class:`HotwatchViolation` *at the offending call site* with the in-repo
stack (where it happened, not where it was noticed).

The reference's three layers are JAX's (the array's ``_value`` property,
``numpy.asarray``/``numpy.array``, and jax's transfer guards). The
port's, cheapest first:

- ``torch.Tensor``'s materializing methods are wrapped: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``__array__``, ``__float__``,
  ``__int__``, ``__bool__``, ``__index__``, and ``.to()`` onto the CPU,
  each counted once (a method that calls another is one read) when the
  tensor lies on the watched ``device``;
- ``numpy.asarray``/``numpy.array`` are wrapped for a tensor on the
  watched device (modules that did ``from numpy import asarray`` keep
  the unwrapped function — a known hole the native layer backstops on
  the card);
- uploads from pageable host memory onto the watched device are counted
  as ``h2d``: ``.to()``, ``.cuda()`` and ``.copy_()`` from a CPU tensor
  that is not pinned onto a CUDA device, and ``torch.as_tensor``,
  ``torch.tensor`` and ``torch.from_numpy`` of a numpy array (on a CUDA
  device, of a list too) that land on the watched device. On the CPU the
  host *is* the device, so there an upload is a numpy array turned into
  a tensor, as the reference counts numpy -> array on JAX's CPU backend;
- as the native backstop, on a CUDA device only, and only when the
  window allows neither kind of transfer (``d2h=0`` and ``h2d=0``: the
  sync check cannot tell the two apart),
  ``torch.cuda.set_sync_debug_mode("error")`` is held for the window:
  CUDA then refuses every implicit synchronization (a synchronous
  device->host read, a pageable upload) the patches cannot see.

Explicit staging through
:func:`~moolib_tpu_torch.utils.staging.stage_host_async` (a pinned,
non-blocking copy waited for by an event) is counted as ``staged``, never
as a violation.

Counting is scoped to the thread that entered the window:
``get_state``-style full-model reads on RPC/broadcast threads are their
own design and must not trip a step-loop window. **The native backstop
is not so scoped**: CUDA's sync debug mode is one setting of the whole
process, so while it is held an RPC thread that reads a card tensor
*synchronously* inside the window raises CUDA's ``RuntimeError`` (not a
:class:`HotwatchViolation`, and uncounted). Reads through
``stage_host_async`` pass it. A window beside such a thread leaves
``h2d`` unwatched (``None``, the default): without the backstop the
thread-scoped counting stands alone, as on the CPU.

Compiles: the port has no jit. Its compiles are the first-use builds of
its CUDA kernel libraries (``ops/_kernels.py:CudaLibrary._build``,
process-wide, read through
:func:`moolib_tpu_torch.analysis.recompile_guard.kernel_builds`);
``compile_delta`` counts those made inside the window and
``max_compiles`` bounds them. ``jits=`` is accepted for the reference's
signature and not read.

Off switch: ``MOOLIB_TPU_HOTWATCH=0`` (or ``enabled=False``) turns the
window into a no-op — nothing is patched, the sync mode is left alone,
the hot path pays nothing.

Usage (the e2e / bench shape)::

    step = make_impala_train_step()
    run_steps(5)                                # warmup: builds, uploads
    with Hotwatch(device="cuda", h2d=0) as hw:
        run_steps(50)                           # steady state
    assert hw.d2h == 0 and hw.compile_delta == 0
"""

from __future__ import annotations

import os
import threading
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["Hotwatch", "HotwatchViolation", "hotwatch_enabled"]

_PKG_ROOT = Path(__file__).resolve().parent.parent  # moolib_tpu_torch/
_REPO_ROOT = _PKG_ROOT.parent

#: torch.Tensor methods that read a tensor back synchronously.
_D2H_METHODS = ("item", "tolist", "cpu", "numpy", "__array__", "__float__",
                "__int__", "__bool__", "__index__")


class HotwatchViolation(AssertionError):
    """An unbudgeted transfer (raised at the materialization site, with
    its stack) or a compile-count overrun (raised on window exit)."""


def hotwatch_enabled(default: bool = True) -> bool:
    """The environment gate: ``MOOLIB_TPU_HOTWATCH=0`` disables every
    window in the process (debug escape hatch when a guard itself is
    suspected); anything else leaves ``default``."""
    v = os.environ.get("MOOLIB_TPU_HOTWATCH", "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return False
    if v in ("1", "on", "true", "yes"):
        return True
    return default


def _site_stack(limit: int = 20) -> Tuple[Optional[str], str]:
    """(innermost "path:line" or None, formatted stack trimmed to the
    interesting frames, hotwatch's own frames excluded).

    In-repo frames are preferred; when the window is driven from a
    script outside the repo, the fallback keeps that script's frames
    instead — filtering out interpreter/site-packages internals — so the
    violation still names the caller's line."""
    stack = traceback.extract_stack(limit=limit)
    site = outside_site = None
    kept: List[Any] = []
    outside: List[Any] = []
    for frame in stack:
        p = Path(frame.filename)
        try:
            rel = p.resolve().relative_to(_REPO_ROOT)
        except (ValueError, OSError):
            f = frame.filename
            if "site-packages" in f or f.startswith("<") \
                    or f"{os.sep}lib{os.sep}python" in f:
                continue
            outside.append(frame)
            outside_site = f"{f}:{frame.lineno}"
            continue
        if rel.parts[:2] == ("moolib_tpu_torch", "testing") \
                and rel.name == "hotwatch.py":
            continue
        kept.append(frame)
        site = f"{rel.as_posix()}:{frame.lineno}"
    if site is not None:
        return site, "".join(traceback.format_list(kept))
    if outside_site is not None:
        return outside_site, "".join(traceback.format_list(outside))
    return None, ""


def _device_of(args, kwargs) -> Optional[torch.device]:
    """The target device of a ``Tensor.to``/``.cuda`` call, if it names
    one."""
    dev = kwargs.get("device")
    if dev is None:
        for a in args:
            if isinstance(a, (str, torch.device, int)) \
                    and not isinstance(a, bool):
                dev = a
                break
            if isinstance(a, torch.Tensor):
                return a.device
    if dev is None:
        return None
    if isinstance(dev, int):
        return torch.device("cuda", dev)
    return torch.device(dev)


def _pageable(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" and not t.is_pinned()


class Hotwatch:
    """Steady-state transfer/compile window.

    Parameters
    ----------
    d2h:
        Budget of *synchronous* device->host materializations allowed in
        the window (staged ``stage_host_async`` copies are free). The
        default 0 is the steady-state contract; exceeding the budget
        raises :class:`HotwatchViolation` at the offending site.
    h2d:
        ``None`` (default) counts uploads from pageable host memory
        without a limit; 0 makes each such upload raise at its site,
        with "disallowed" in the message.
    jits:
        Accepted for the reference's signature; not read (module
        docstring: the port's compiles are its kernel builds).
    max_compiles:
        Kernel-library builds allowed inside the window (default 0: a
        steady-state window builds nothing). Checked on clean exit.
    enabled:
        ``None`` consults :func:`hotwatch_enabled`; ``False`` makes the
        whole window a no-op with zero overhead (nothing patched).
    label:
        Names the window in violation messages.
    device:
        The watched device (:func:`~moolib_tpu_torch.utils.device.resolve_device`:
        the card unless given; resolved on entry).
    """

    def __init__(self, *, d2h: int = 0, h2d: Optional[int] = None,
                 jits: Sequence[Any] = (), max_compiles: int = 0,
                 enabled: Optional[bool] = None,
                 label: str = "hotwatch", device=None):
        if h2d not in (None, 0):
            raise ValueError("h2d must be None (counted) or 0 (disallow)")
        self.d2h_budget = int(d2h)
        self.h2d_budget = None if h2d is None else int(h2d)
        self.jits = list(jits)
        self.max_compiles = int(max_compiles)
        self.label = label
        self.enabled = hotwatch_enabled() if enabled is None else bool(enabled)
        self._device_arg = device
        self.device: Optional[torch.device] = None
        #: (site, stack) per counted synchronous materialization.
        self.d2h_events: List[Tuple[Optional[str], str]] = []
        #: (site, stack) per counted upload from pageable host memory.
        self.h2d_events: List[Tuple[Optional[str], str]] = []
        #: Explicit async stagings observed (never violations).
        self.staged = 0
        self._tid: Optional[int] = None
        self._inside = False
        self._orig: Dict[Tuple[Any, str], Any] = {}
        self._sync_mode_prev: Optional[int] = None
        self._compile_start = 0
        self._active = False

    # -- counters -------------------------------------------------------------

    @property
    def d2h(self) -> int:
        """Synchronous materializations counted so far."""
        return len(self.d2h_events)

    @property
    def h2d(self) -> int:
        """Uploads from pageable host memory counted so far."""
        return len(self.h2d_events)

    @property
    def compile_delta(self) -> int:
        """Kernel-library builds since entry."""
        from ..analysis.recompile_guard import kernel_builds

        return max(0, kernel_builds() - self._compile_start)

    # -- the counting core ----------------------------------------------------

    def _on_device(self, d: torch.device) -> bool:
        if d.type != self.device.type:
            return False
        if d.type == "cuda":  # "cuda" alone is the current device
            index = torch.cuda.current_device() if d.index is None else d.index
            return self.device.index is None or index == self.device.index
        return True

    def _watched(self, t: Any) -> bool:
        return isinstance(t, torch.Tensor) and self._on_device(t.device)

    def _on_transfer(self) -> None:
        """Record one synchronous materialization; raise at the site once
        the budget is exhausted."""
        site, stack = _site_stack()
        self.d2h_events.append((site, stack))
        if self.d2h > self.d2h_budget:
            raise HotwatchViolation(
                f"{self.label}: unbudgeted synchronous device->host "
                f"transfer #{self.d2h} (budget {self.d2h_budget}) at "
                f"{site or '<outside repo>'} — stage it with "
                f"stage_host_async and drain at a log boundary, or raise "
                f"the window's d2h budget.\nMaterialization site:\n{stack}"
            )

    def _on_upload(self) -> None:
        """Record one upload from pageable host memory; raise at the site
        once the h2d budget (if any) is exhausted."""
        site, stack = _site_stack()
        self.h2d_events.append((site, stack))
        if self.h2d_budget is not None and self.h2d > self.h2d_budget:
            raise HotwatchViolation(
                f"{self.label}: host->device upload #{self.h2d} from "
                f"pageable memory disallowed (budget {self.h2d_budget}) "
                f"at {site or '<outside repo>'} — upload the batch before "
                f"the window, or from pinned memory.\nUpload site:\n{stack}"
            )

    # -- patching -------------------------------------------------------------

    def _patch(self, owner: Any, name: str, counts) -> None:
        """Wrap ``owner.name``: ``counts(args, kwargs)`` names the kind of
        transfer the call is ("d2h", "h2d", "staged" or None); only the
        window thread's outermost patched call is counted."""
        orig = getattr(owner, name)
        own = name in vars(owner)
        watch = self
        handlers = {"d2h": self._on_transfer, "h2d": self._on_upload}

        def patched(*args, **kwargs):
            if watch._inside or threading.get_ident() != watch._tid:
                return orig(*args, **kwargs)
            kind = counts(args, kwargs)
            if kind is None:
                return orig(*args, **kwargs)
            watch._inside = True
            try:
                if kind == "staged":
                    watch.staged += 1
                else:
                    handlers[kind]()
                return orig(*args, **kwargs)
            finally:
                watch._inside = False

        self._orig[(owner, name)] = (orig, own)
        setattr(owner, name, patched)

    def _activate(self) -> None:
        from ..utils import staging

        cuda = self.device.type == "cuda"
        watched = self._watched

        def d2h_method(args, kwargs):
            return "d2h" if watched(args[0]) else None

        for name in _D2H_METHODS:
            self._patch(torch.Tensor, name, d2h_method)

        def to(args, kwargs):
            t, target = args[0], _device_of(args[1:], kwargs)
            if target is None:
                return None
            if watched(t) and target.type == "cpu" and t.device.type != "cpu":
                return None if kwargs.get("non_blocking") else "d2h"
            if cuda and _pageable(t) and self._on_device(target):
                return "h2d"
            return None

        self._patch(torch.Tensor, "to", to)
        if cuda:
            def to_cuda(args, kwargs):
                target = _device_of(args[1:], kwargs) or torch.device(
                    "cuda", torch.cuda.current_device())
                return ("h2d" if _pageable(args[0])
                        and self._on_device(target) else None)

            def copy_(args, kwargs):
                dst, src = args[0], args[1]
                return ("h2d" if isinstance(src, torch.Tensor)
                        and _pageable(src) and watched(dst) else None)

            self._patch(torch.Tensor, "cuda", to_cuda)
            self._patch(torch.Tensor, "copy_", copy_)

        host_data = (np.ndarray, list, tuple) if cuda else (np.ndarray,)

        def create(args, kwargs):
            data = args[0] if args else kwargs.get("data")
            if not isinstance(data, host_data):
                return None
            target = kwargs.get("device")
            target = (torch.device("cpu") if target is None
                      else torch.device(target))
            return "h2d" if self._on_device(target) else None

        for name in ("as_tensor", "tensor", "from_numpy"):
            self._patch(torch, name, create)

        def np_read(args, kwargs):
            return "d2h" if args and watched(args[0]) else None

        self._patch(np, "asarray", np_read)
        self._patch(np, "array", np_read)

        def stage(args, kwargs):
            return "staged" if watched(args[0]) else None

        self._patch(staging, "_stage", stage)

        if cuda and self.d2h_budget == 0 and self.h2d_budget == 0:
            self._sync_mode_prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")

    def _deactivate(self) -> None:
        if self._sync_mode_prev is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode_prev)
            self._sync_mode_prev = None
        for (owner, name), (orig, own) in reversed(list(self._orig.items())):
            if own:
                setattr(owner, name, orig)
            else:  # inherited: drop the override, the base's shows again
                delattr(owner, name)
        self._orig = {}

    # -- context protocol -----------------------------------------------------

    def __enter__(self) -> "Hotwatch":
        if not self.enabled:
            return self
        from ..analysis.recompile_guard import kernel_builds

        self.device = resolve_device(self._device_arg)
        self._tid = threading.get_ident()
        self._compile_start = kernel_builds()
        self._activate()
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._active:
            return False
        self._active = False
        self._deactivate()
        if exc_type is None:
            delta = self.compile_delta
            if delta > self.max_compiles:
                raise HotwatchViolation(
                    f"{self.label}: the kernels were built {delta} "
                    f"time(s) inside a window budgeted for "
                    f"{self.max_compiles} compiles — the steady state "
                    "met a kernel library at its first use"
                )
        return False

