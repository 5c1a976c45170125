"""Health gating for routed replicas: probe-miss tracking and a
failure-rate circuit breaker with jittered, capped-exponential reopen;
the counterpart of :mod:`moolib_tpu.serving.health`.

A replica leaves the routable set two ways:

- **probe misses** — K consecutive health-probe failures (the replica is
  dark: dead process, partition, wedged loop). It rejoins on the first
  successful probe; probing itself IS the redial, and the router's probe
  cadence plus the breaker cooldown below provide the jittered backoff.
- **circuit breaker** — the recent call failure rate crossed a threshold
  (the replica answers probes but fails work). The breaker opens for a
  jittered cooldown that doubles on each consecutive re-open (capped),
  then admits ONE half-open trial call; success closes it, failure
  re-opens with a longer cooldown.

All state is plain and lock-guarded; decisions are pure in (seeded RNG,
recorded outcomes, the ``now`` passed in), so tests can drive the clock.
"""

from __future__ import annotations

import threading
from collections import deque
from random import Random
from typing import Any, Dict, Optional

from ..telemetry import RollingQuantile

__all__ = ["CircuitBreaker", "ReplicaHealth"]


class CircuitBreaker:
    """Sliding-window failure-rate breaker (closed -> open -> half-open).

    ``record(ok)`` feeds outcomes; ``allow(now)`` answers "may I send
    this call?" — True while closed, False while open and cooling down,
    and True exactly once per cooldown expiry (the half-open trial)."""

    def __init__(self, *, window: int = 16, threshold: float = 0.5,
                 min_samples: int = 4, cooldown_s: float = 0.5,
                 cooldown_cap_s: float = 8.0, seed: Optional[int] = None,
                 name: str = "", telemetry=None):
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"threshold must be in (0, 1], got {threshold!r}")
        # Flight-recorder identity: open/close transitions are recorded
        # as typed events (and an open is an incident auto-capture
        # trigger). ``telemetry`` defaults to the process-global
        # instance, resolved lazily — a breaker has no peer identity.
        self._name = name
        self._tel = telemetry
        self._lock = threading.Lock()
        self._window: "deque[bool]" = deque(maxlen=int(window))
        self._threshold = float(threshold)
        self._min_samples = int(min_samples)
        self._base_cooldown = float(cooldown_s)
        self._cooldown_cap = float(cooldown_cap_s)
        self._cooldown = float(cooldown_s)
        self._rng = Random(seed)
        self._state = "closed"
        self._open_until = 0.0
        self._trial_pending = False
        self.opened_total = 0

    @property
    def state(self) -> str:
        return self._state

    def _telemetry(self):
        tel = self._tel
        if tel is None:
            from ..telemetry import global_telemetry

            tel = global_telemetry()
        return tel

    def record(self, ok: bool, now: float) -> None:
        opened = closed_now = False
        failures = 0
        with self._lock:
            self._window.append(bool(ok))
            if self._state == "half_open":
                if ok:
                    # Trial succeeded: close and reset the cooldown ramp.
                    self._state = "closed"
                    self._cooldown = self._base_cooldown
                    self._window.clear()
                    self._window.append(True)
                    closed_now = True
                else:
                    self._open(now)
                    opened, failures = True, 1
                self._trial_pending = False
            elif self._state == "closed":
                n = len(self._window)
                if n >= self._min_samples:
                    failures = sum(1 for v in self._window if not v)
                    if failures / n >= self._threshold:
                        self._open(now)
                        opened = True
        # Flight events + incident capture OUTSIDE the breaker lock:
        # capture writes a bundle and dumps thread stacks.
        if opened:
            fr = self._telemetry().flight
            if fr.on:
                fr.record("breaker_open", name=self._name,
                          failures=int(failures),
                          window=self._window.maxlen)
            from ..flightrec.capture import maybe_capture

            maybe_capture(
                "breaker_open",
                f"circuit breaker {self._name or '(unnamed)'} opened "
                f"({failures} failures in window)",
                telemetry=self._tel,
            )
        elif closed_now:
            fr = self._telemetry().flight
            if fr.on:
                fr.record("breaker_close", name=self._name)

    def _open(self, now: float) -> None:
        self._state = "open"
        self.opened_total += 1
        # Full jitter over the current cooldown ceiling (the reconnect-
        # backoff rule: spread the cohort's re-probes), then double it.
        self._open_until = now + self._rng.uniform(
            self._cooldown * 0.5, self._cooldown
        )
        self._cooldown = min(self._cooldown_cap, self._cooldown * 2.0)

    def allow(self, now: float) -> bool:
        """Non-mutating: would a call be admitted right now? Safe for
        introspection/candidate listing — never consumes the half-open
        trial token (that is :meth:`try_acquire`, at dispatch time)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return now >= self._open_until
            return not self._trial_pending  # half_open

    def try_acquire(self, now: float) -> bool:
        """Mutating admission at dispatch time: True while closed; when a
        cooldown has expired, transitions open -> half-open and hands out
        the SINGLE trial token (concurrent callers stay parked until
        ``record`` settles the trial)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" and now >= self._open_until:
                self._state = "half_open"
                self._trial_pending = True
                return True
            if self._state == "half_open" and not self._trial_pending:
                self._trial_pending = True
                return True
            return False


class ReplicaHealth:
    """Routable-or-not view of one replica, as the router sees it.

    Combines probe-miss gating, the circuit breaker, the draining flag
    reported by the replica's own health endpoint, and the scraped load
    signals (inflight, queue depth, p50 service time) dispatch ranks on.
    ``outstanding`` is the router's OWN in-flight count toward this
    replica — fresher than any probe."""

    def __init__(self, name: str, *, probe_misses: int = 3,
                 breaker: Optional[CircuitBreaker] = None,
                 latency_window: int = 64, seed: Optional[int] = None):
        self.name = name
        self._lock = threading.Lock()
        self._miss_limit = int(probe_misses)
        self._misses = 0
        self._ever_ok = False  # routable only after a first good probe
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker(seed=seed, name=name)
        self.outstanding = 0  # router-side in-flight (guard with lock)
        self.latency = RollingQuantile(latency_window)
        # Last scraped health-endpoint signals (None until first probe).
        self.scraped: Optional[Dict[str, Any]] = None
        self.probes_ok = 0
        self.probes_missed = 0

    # -- probe results -------------------------------------------------------

    def probe_ok(self, info: Dict[str, Any]) -> None:
        with self._lock:
            self._misses = 0
            self._ever_ok = True
            self.scraped = dict(info)
            self.probes_ok += 1

    def probe_miss(self) -> None:
        with self._lock:
            self._misses += 1
            self.probes_missed += 1

    # -- call outcomes -------------------------------------------------------

    def record_call(self, ok: bool, now: float,
                    latency_s: Optional[float] = None) -> None:
        self.breaker.record(ok, now)
        if ok and latency_s is not None:
            self.latency.observe(latency_s)

    def add_outstanding(self, n: int) -> None:
        with self._lock:
            self.outstanding += n

    # -- routing decision ----------------------------------------------------

    @property
    def draining(self) -> bool:
        s = self.scraped
        return bool(s and s.get("draining"))

    @property
    def dark(self) -> bool:
        """Unproven (never probed successfully) or K consecutive probe
        misses: either way the replica has not earned traffic — this is
        what makes "wait until routable" startup guards real instead of
        vacuously true before the first probe lands."""
        with self._lock:
            return (not self._ever_ok) or self._misses >= self._miss_limit

    def routable(self, now: float) -> bool:
        if self.dark or self.draining:
            return False
        return self.breaker.allow(now)

    def load_key(self):
        """Sort key for least-loaded dispatch: the router's own
        outstanding count first (freshest), then the replica-reported
        queue+inflight from the last probe, then observed p50 latency."""
        with self._lock:
            outstanding = self.outstanding
            s = self.scraped or {}
        reported = float(s.get("inflight", 0) or 0) \
            + float(s.get("queue_depth", 0) or 0)
        return (outstanding, reported, self.latency.quantile(0.5) or 0.0)

    def state(self, now: float) -> Dict[str, Any]:
        with self._lock:
            misses = self._misses
            ever_ok = self._ever_ok
            outstanding = self.outstanding
            scraped = dict(self.scraped) if self.scraped else None
        return {
            "name": self.name,
            "routable": self.routable(now),
            "dark": (not ever_ok) or misses >= self._miss_limit,
            "draining": self.draining,
            "breaker": self.breaker.state,
            "breaker_opened_total": self.breaker.opened_total,
            "probe_misses": misses,
            "outstanding": outstanding,
            "p50_latency_s": self.latency.quantile(0.5),
            "scraped": scraped,
        }
