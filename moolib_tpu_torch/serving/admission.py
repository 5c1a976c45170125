"""Admission control: bounded queues, deadline-aware shedding, drain.

The counterpart of :mod:`moolib_tpu.serving.admission`, with its
telemetry counters and flight-recorder events. A replica refuses work it
cannot serve explicitly and early: ``Overloaded`` at the door instead of
silent queue growth, and a shed (``DeadlineExceeded``) the moment a
request's remaining budget provably cannot cover the observed service
time.

Errors cross a process boundary as message prefixes (``Overloaded:`` /
``DeadlineExceeded:``); :func:`error_kind` classifies either the typed
exceptions or the prefixed strings into retry-safety classes.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, List, Optional, Tuple

from ..rpc import RpcError
from ..telemetry import RollingQuantile, Telemetry, global_telemetry

__all__ = [
    "AdmissionQueue",
    "DeadlineExceeded",
    "Overloaded",
    "ServingError",
    "error_kind",
]


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
    p50 service-time estimate (a :class:`RollingQuantile` window — the
    CURRENT regime, so one slow cold first batch does not poison shedding
    forever), then acknowledges completed work via :meth:`done`/
    :meth:`fail` so :meth:`drain` can wait for admitted work to finish.

    Telemetry (``service``-labelled): ``serving_admitted_total``,
    ``serving_rejected_total{reason}``, ``serving_shed_total``,
    ``serving_completed_total``, ``serving_failed_total``,
    ``serving_drained_total`` and a ``serving_queue_depth`` gauge.
    """

    def __init__(self, capacity: int, *, service: str = "serve",
                 peer: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None,
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

        self._tel = telemetry if telemetry is not None else global_telemetry()
        reg = self._tel.registry
        self._m_admitted = reg.counter("serving_admitted_total",
                                       service=service)
        self._m_rej_capacity = reg.counter(
            "serving_rejected_total", service=service, reason="capacity")
        self._m_rej_draining = reg.counter(
            "serving_rejected_total", service=service, reason="draining")
        self._m_shed = reg.counter("serving_shed_total", service=service)
        self._m_completed = reg.counter("serving_completed_total",
                                        service=service)
        self._m_failed = reg.counter("serving_failed_total", service=service)
        self._m_drained = reg.counter("serving_drained_total",
                                      service=service)
        self._m_service = reg.histogram("serving_service_seconds",
                                        service=service)
        # Weakref gauge (the Group/Accumulator/Rpc contract): a shared or
        # global Telemetry must never pin a closed queue; close()
        # unregisters the series. The peer label keeps two same-service
        # queues sharing one Telemetry from replacing (and, on close,
        # unregistering) each other's gauges — same rule as the Rpc
        # inflight/peers gauges.
        self._gauge_labels = {"service": service}
        if peer is not None:
            self._gauge_labels["peer"] = peer
        wself = weakref.ref(self)
        reg.gauge_fn("serving_queue_depth",
                     lambda: len(wself()._entries), **self._gauge_labels)

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
        """Admit ``item`` or refuse explicitly.

        Raises :class:`Overloaded` at capacity or while draining/closed,
        :class:`DeadlineExceeded` when the remaining budget already
        cannot cover the observed p50 service time (shed at the door —
        queueing it would only waste a batch slot on dead work)."""
        now = time.monotonic()
        if self.would_shed(deadline, now):
            self._m_shed.inc()
            fr = self._tel.flight
            if fr.on:
                fr.record("serving_shed", service=self.service, shed=1)
            raise DeadlineExceeded(
                f"remaining budget {max(0.0, deadline - now):.3f}s cannot "
                f"cover observed p50 service time "
                f"{self._service_est.quantile(0.5):.3f}s"
            )
        with self._cond:
            if self._closed or self._draining:
                self._m_rej_draining.inc()
                raise Overloaded(
                    f"service {self.service!r} is "
                    + ("closed" if self._closed else "draining")
                )
            if len(self._entries) >= self.capacity:
                self._m_rej_capacity.inc()
                raise Overloaded(
                    f"admission queue at capacity ({self.capacity})"
                )
            self._m_admitted.inc()
            self._entries.append(_Entry(item, deadline, now))
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

    def get_batch(self, max_items: int, timeout: Optional[float] = None,
                  linger: float = 0.0) -> Tuple[List[Any], List[Any]]:
        """Pop up to ``max_items`` admitted items -> ``(serve, shed)``.

        Blocks up to ``timeout`` for at least one entry (returns
        ``([], [])`` on timeout or close). With ``linger`` > 0, once the
        first entry is seen the consumer waits up to that long for more
        to coalesce (bounded — a full batch returns immediately).
        Entries whose remaining budget cannot cover the p50 service
        estimate are returned in ``shed`` (counted) — the caller owes
        each an explicit error reply. Both lists count toward
        :attr:`inflight` until acknowledged via :meth:`done`/:meth:`fail`
        (shed items should be acknowledged with ``fail``)."""
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
            # Telemetry and wakeups before the gate raise (the
            # inflight-gate rule): nothing after the += may throw, so a
            # failed pop can never leak in-flight accounting. Waiters run
            # only after the lock releases, so the order is invisible.
            if shed:
                self._m_shed.inc(len(shed))
                fr = self._tel.flight
                if fr.on:  # the recorder lock is a leaf under _cond
                    fr.record("serving_shed", service=self.service,
                              shed=len(shed))
            self._cond.notify_all()
            self._inflight += len(serve) + len(shed)
        return serve, shed

    def done(self, n: int,
             service_seconds_per_item: Optional[float] = None) -> None:
        """Acknowledge ``n`` served items, optionally feeding the per-item
        service time into the shed estimator and the exported histogram."""
        if service_seconds_per_item is not None:
            self._service_est.observe(service_seconds_per_item)
            if self._tel.on:
                for _ in range(n):
                    self._m_service.observe(service_seconds_per_item)
        with self._cond:
            self._inflight -= n
            self._m_completed.inc(n)
            self._cond.notify_all()

    def fail(self, n: int, shed: bool = False) -> None:
        """Acknowledge ``n`` items that were errored (handler failure, or
        shed entries after their error replies went out)."""
        with self._cond:
            self._inflight -= n
            if not shed:
                self._m_failed.inc(n)
            self._cond.notify_all()

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting (new admits raise :class:`Overloaded`), then
        wait until every already-admitted item has been acknowledged.
        Returns True when the queue fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            fr = self._tel.flight
            if fr.on:  # the recorder lock is a leaf under _cond
                fr.record("serving_drain", service=self.service,
                          pending=len(self._entries) + self._inflight)
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: (not self._entries and self._inflight == 0)
                or self._closed,
                timeout=timeout,
            )
            # close() also wakes the wait — report drained ONLY when the
            # admitted work truly finished, never because a hard stop
            # discarded it (the caller tears the replica down on True).
            ok = not self._entries and self._inflight == 0
        if ok:
            self._m_drained.inc()
        return ok

    def close(self) -> None:
        """Close and unregister the depth gauge. Entries still queued are
        returned to no one — call :meth:`drain` first for a graceful
        departure; close() is the hard stop."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._tel.registry.unregister("serving_queue_depth",
                                      **self._gauge_labels)
