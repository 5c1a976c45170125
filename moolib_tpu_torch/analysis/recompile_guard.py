"""Runtime companion to the capture-hygiene rules: pin build counts; the
counterpart of :mod:`moolib_tpu.analysis.recompile_guard`.

The reference counts jit cache misses. The port calls no jit: what it
compiles are its CUDA kernel libraries, each built (``nvcc``, or the kept
library loaded) once per process at first use
(``ops/_kernels.py:CudaLibrary``; :func:`kernel_builds` reads the
process-wide count). A **compile** here is one such build, and a block
that builds more often than it should has a cold path on its hot path::

    step = guarded_jit(make_impala_train_step())
    step(state, batch)                       # first use: may build
    with recompile_budget(step, max_compiles=0):
        for batch in batches:
            state, m = step(state, batch)    # must build nothing

What :func:`compile_count` can read:

- a :class:`GuardedJit` (what :func:`guarded_jit` returns): the builds
  its calls made (the process-wide count's growth across each call,
  builds on other threads during a call included);
- a kernel library of ``ops/_kernels.py`` (anything with an integer
  ``builds``): its own builds.

Anything else (a plain function) is uncountable: :class:`RecompileGuard`
refuses it rather than guard nothing.

:mod:`moolib_tpu_torch.ops._kernels` (and so torch) is imported lazily,
inside the functions that read it: importing
:mod:`moolib_tpu_torch.analysis` stays free of torch.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Optional

__all__ = [
    "RecompileBudgetExceeded",
    "RecompileGuard",
    "compile_count",
    "guarded_jit",
    "kernel_builds",
    "recompile_budget",
]


class RecompileBudgetExceeded(RuntimeError):
    """A guarded block compiled more often than its budget allows."""


def kernel_builds() -> int:
    """First-use builds of every kernel library in this process so far
    (``ops/_kernels.py:build_count``): the one reader of the count, shared
    with :class:`~moolib_tpu_torch.testing.hotwatch.Hotwatch`."""
    from ..ops._kernels import build_count

    return build_count()


def compile_count(fn: Any) -> Optional[int]:
    """Best-effort number of builds attributable to ``fn``.

    Understands :class:`GuardedJit` wrappers and the kernel libraries of
    ``ops/_kernels.py``. Returns None when the count is unreadable."""
    if isinstance(fn, GuardedJit):
        return fn.compiles
    builds = getattr(fn, "builds", None)
    if isinstance(builds, int) and not isinstance(builds, bool):
        return builds
    return None


class GuardedJit:
    """A callable wrapper that counts the kernel builds its calls make.

    The port has no jit to wrap: ``fun`` is called as is, and each call
    adds the growth of :func:`kernel_builds` across it to
    :attr:`compiles`. Builds made by another thread during a call count
    too (the count is process-wide)."""

    def __init__(self, fun: Callable):
        self._fun = fun
        functools.update_wrapper(self, fun)
        self._builds = 0
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        before = kernel_builds()
        try:
            return self._fun(*args, **kwargs)
        finally:
            grown = kernel_builds() - before
            with self._lock:
                self._builds += grown

    @property
    def compiles(self) -> int:
        return self._builds


def guarded_jit(fun: Optional[Callable] = None):
    """Wrap a plain callable so that its result exposes ``.compiles``:
    the kernel-library builds its calls trigger. Usable as
    ``guarded_jit(f)``, ``@guarded_jit`` or ``@guarded_jit()``; the
    reference's jit options have no counterpart."""
    if fun is None:
        return GuardedJit
    return GuardedJit(fun)


class RecompileGuard:
    """Context manager asserting a callable (or kernel library) builds at
    most ``max_compiles`` times inside the ``with`` block.

    The check runs on clean exit only (an exception inside the block wins);
    ``.compiles`` is readable at any point for finer assertions."""

    def __init__(self, fn: Any, max_compiles: int = 1,
                 label: Optional[str] = None):
        if compile_count(fn) is None:
            raise TypeError(
                "cannot read a build count from "
                f"{getattr(fn, '__name__', fn)!r}; pass a kernel library, "
                "or wrap the callable with guarded_jit()"
            )
        self.fn = fn
        self.max_compiles = int(max_compiles)
        self.label = label or getattr(fn, "__name__", None) \
            or getattr(fn, "name", repr(fn))
        self._start: Optional[int] = None

    @property
    def compiles(self) -> int:
        if self._start is None:
            raise RuntimeError("RecompileGuard not entered")
        now = compile_count(self.fn)
        return 0 if now is None else now - self._start

    def __enter__(self) -> "RecompileGuard":
        self._start = compile_count(self.fn)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self.compiles > self.max_compiles:
            raise RecompileBudgetExceeded(
                f"{self.label}: built {self.compiles} kernel librar"
                f"{'y' if self.compiles == 1 else 'ies'} in a block "
                f"budgeted for {self.max_compiles} — a first-use build "
                "landed on a path that should find everything built"
            )
        return False


def recompile_budget(fn: Any, max_compiles: int = 1,
                     label: Optional[str] = None) -> RecompileGuard:
    """``with recompile_budget(guarded_fn, 1): ...`` — see
    :class:`RecompileGuard`."""
    return RecompileGuard(fn, max_compiles=max_compiles, label=label)
