"""Admission control: bounded queues, deadline-aware shedding, drain.

The counterpart of :mod:`moolib_tpu.serving.admission`, without its
telemetry counters and flight-recorder hooks (they come with the
telemetry slice). A replica refuses work it cannot serve explicitly and
early: ``Overloaded`` at the door instead of silent queue growth, and a
shed (``DeadlineExceeded``) the moment a request's remaining budget
provably cannot cover the observed service time.

Errors cross a process boundary as message prefixes (``Overloaded:`` /
``DeadlineExceeded:``); :func:`error_kind` classifies either the typed
exceptions or the prefixed strings into retry-safety classes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Tuple

from ..utils.quantile import RollingQuantile

__all__ = [
    "AdmissionQueue",
    "DeadlineExceeded",
    "Overloaded",
    "RpcError",
    "ServingError",
    "error_kind",
]


class RpcError(RuntimeError):
    """A failed call, carrying the error string a remote peer would
    send; the base of the serving errors until the RPC layer is
    ported."""


class ServingError(RpcError):
    """Base of the serving tier's explicit refusals."""


class Overloaded(ServingError):
    """Admission refused: queue at capacity or the replica is draining.
    The request was NEVER executed; always safe to retry elsewhere."""


class DeadlineExceeded(ServingError):
    """The request's remaining budget cannot cover service (shed at
    admission, in the queue, or after the budget ran out end to end)."""


def error_kind(exc_or_msg: Any) -> str:
    """Classify a serving-path failure into a retry-safety class:
    ``"overloaded"`` (never executed, retry elsewhere is safe),
    ``"deadline"`` (budget gone, do not retry), ``"worker_died"`` (an
    env-tier worker died; retry against the same pool is safe),
    ``"conn"`` (connection lost or peer unroutable; retry iff
    idempotent), ``"timeout"`` (expired in flight, may have executed;
    retry iff idempotent), ``"not_found"`` (misconfigured endpoint or
    peer) or ``"other"``. Accepts the typed exceptions or the error
    strings."""
    if isinstance(exc_or_msg, Overloaded):
        return "overloaded"
    if isinstance(exc_or_msg, DeadlineExceeded):
        return "deadline"
    msg = str(exc_or_msg)
    if msg.startswith("Overloaded:"):
        return "overloaded"
    if msg.startswith("DeadlineExceeded:"):
        return "deadline"
    if msg.startswith("WorkerDied:") or type(exc_or_msg).__name__ == "WorkerDied":
        return "worker_died"
    if "expired in the server queue" in msg:
        return "deadline"
    if ("connection to" in msg and "lost" in msg) or "no route to" in msg:
        return "conn"
    if "timed out" in msg:
        return "timeout"
    if "not found" in msg:
        return "not_found"
    return "other"


class _Entry:
    __slots__ = ("item", "deadline", "enqueued_at")

    def __init__(self, item, deadline, enqueued_at):
        self.item = item
        self.deadline = deadline
        self.enqueued_at = enqueued_at


class AdmissionQueue:
    """Bounded FIFO with deadline-aware shedding and graceful drain.

    Producers :meth:`admit` opaque items with an optional monotonic
    deadline; refusal is an explicit exception, never silent growth.
    The consumer (the replica's batch loop) calls :meth:`get_batch`,
    which sheds entries whose remaining budget cannot cover the current
    p50 service-time estimate (a :class:`RollingQuantile` window, so one
    slow first batch does not poison shedding forever), then
    acknowledges completed work via :meth:`done`/:meth:`fail` so
    :meth:`drain` can wait for admitted work to finish.
    """

    def __init__(self, capacity: int, *, service: str = "serve",
                 estimator_window: int = 128, shed_safety: float = 1.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.capacity = int(capacity)
        self.service = service
        self._cond = threading.Condition()
        self._entries: "deque[_Entry]" = deque()
        self._inflight = 0  # popped by get_batch, not yet done()/fail()
        self._draining = False
        self._closed = False
        # Shed when remaining < shed_safety * p50(service time): 1.0 is
        # the break-even point; >1 sheds earlier (more headroom).
        self._safety = float(shed_safety)
        self._service_est = RollingQuantile(estimator_window)

    # -- introspection -------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._entries)

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def service_p50(self) -> Optional[float]:
        """Current windowed p50 service-time estimate (None until the
        first completion is recorded)."""
        return self._service_est.quantile(0.5)

    def would_shed(self, deadline: Optional[float],
                   now: Optional[float] = None) -> bool:
        """Whether a request with this monotonic deadline would be shed
        right now (remaining budget < safety x p50 service estimate)."""
        if deadline is None:
            return False
        est = self._service_est.quantile(0.5)
        if est is None:
            return False  # no evidence yet: admit and learn
        if now is None:
            now = time.monotonic()
        return (deadline - now) < self._safety * est

    # -- producer side -------------------------------------------------------

    def admit(self, item: Any, deadline: Optional[float] = None) -> None:
        """Admit ``item`` or refuse explicitly: :class:`Overloaded` at
        capacity or while draining/closed, :class:`DeadlineExceeded` when
        the remaining budget already cannot cover the observed p50
        service time."""
        now = time.monotonic()
        if self.would_shed(deadline, now):
            raise DeadlineExceeded(
                f"remaining budget {max(0.0, deadline - now):.3f}s cannot "
                f"cover observed p50 service time "
                f"{self._service_est.quantile(0.5):.3f}s"
            )
        with self._cond:
            if self._closed or self._draining:
                raise Overloaded(
                    f"service {self.service!r} is "
                    + ("closed" if self._closed else "draining")
                )
            if len(self._entries) >= self.capacity:
                raise Overloaded(
                    f"admission queue at capacity ({self.capacity})"
                )
            self._entries.append(_Entry(item, deadline, now))
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

    def get_batch(self, max_items: int, timeout: Optional[float] = None,
                  linger: float = 0.0) -> Tuple[List[Any], List[Any]]:
        """Pop up to ``max_items`` admitted items -> ``(serve, shed)``.

        Blocks up to ``timeout`` for at least one entry (returns
        ``([], [])`` on timeout or close). With ``linger`` > 0, once the
        first entry is seen the consumer waits up to that long for more
        to coalesce (a full batch returns at once). Entries whose
        remaining budget cannot cover the p50 service estimate are
        returned in ``shed``; the caller owes each an explicit error
        reply. Both lists count toward :attr:`inflight` until
        acknowledged via :meth:`done`/:meth:`fail`."""
        if max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items!r}")
        with self._cond:
            if not self._entries:
                if not self._cond.wait_for(
                    lambda: self._entries or self._closed, timeout=timeout
                ) or self._closed and not self._entries:
                    return [], []
            if linger > 0 and len(self._entries) < max_items:
                deadline = time.monotonic() + linger
                while len(self._entries) < max_items:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=remaining)
            now = time.monotonic()
            serve: List[Any] = []
            shed: List[Any] = []
            est = self._service_est.quantile(0.5)
            while self._entries and len(serve) < max_items:
                e = self._entries.popleft()
                if (e.deadline is not None and est is not None
                        and (e.deadline - now) < self._safety * est):
                    shed.append(e.item)
                else:
                    serve.append(e.item)
            self._cond.notify_all()
            self._inflight += len(serve) + len(shed)
        return serve, shed

    def done(self, n: int,
             service_seconds_per_item: Optional[float] = None) -> None:
        """Acknowledge ``n`` served items, optionally feeding the per-item
        service time into the shed estimator."""
        if service_seconds_per_item is not None:
            self._service_est.observe(service_seconds_per_item)
        with self._cond:
            self._inflight -= n
            self._cond.notify_all()

    def fail(self, n: int) -> None:
        """Acknowledge ``n`` items that were errored (handler failure, or
        shed entries after their error replies went out)."""
        with self._cond:
            self._inflight -= n
            self._cond.notify_all()

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting (new admits raise :class:`Overloaded`), then
        wait until every already-admitted item has been acknowledged.
        Returns True when the queue fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: (not self._entries and self._inflight == 0)
                or self._closed,
                timeout=timeout,
            )
            # close() also wakes the wait: report drained ONLY when the
            # admitted work truly finished, never because a hard stop
            # discarded it.
            return not self._entries and self._inflight == 0

    def close(self) -> None:
        """Hard stop. Entries still queued are returned to no one: call
        :meth:`drain` first for a graceful departure."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
