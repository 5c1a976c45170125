"""Load-aware, health-gated request router with deadline-bounded
failover; the counterpart of :mod:`moolib_tpu.serving.router`.

The router is the client-facing half of the serving tier: it owns the
fleet view (one :class:`~moolib_tpu_torch.serving.health.ReplicaHealth` per
replica, refreshed by a background probe of each replica's
``{service}.health`` endpoint — the scraped inflight/latency gauges),
dispatches each request to the least-loaded routable replica, propagates
the request's remaining budget on the wire
(:meth:`~moolib_tpu_torch.rpc.Rpc.call_with_deadline`, ``reroute=False`` so a
replica death is an explicit error in milliseconds, not a silent
transport redial), and retries *safe* failures on a different replica
with capped-exponential jittered backoff:

- ``Overloaded`` — the replica refused at admission; never executed,
  always safe to retry elsewhere.
- connection-lost / unroutable / attempt-timeout — retried only when the
  service was declared ``idempotent`` (inference is; anything with side
  effects must say so), and only while budget remains.
- ``DeadlineExceeded`` — the budget is gone everywhere; surface it.

Every outcome is explicit and bounded by the caller's budget: an
accepted request either returns a result or raises a typed error well
before the transport's own 30s deadline.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from random import Random
from typing import Any, Dict, List, Optional

from ..rpc import Rpc, RpcError
from ..telemetry import RollingQuantile
from ..utils import get_logger
from .admission import DeadlineExceeded, Overloaded, error_kind
from .health import CircuitBreaker, ReplicaHealth

__all__ = ["Router", "publish_from_accumulator", "publish_from_statestore"]

log = get_logger("serving")


def _probe_entry(wref, stop, interval):
    """Probe-thread entry: holds the Router only for one probe sweep, so
    an abandoned router (dropped without close()) is still collectable
    instead of being pinned forever by its own prober."""
    while not stop.wait(interval):
        router = wref()
        if router is None:
            return
        router._probe_sweep()
        del router


class Router:
    """Routes ``infer`` requests across a replica fleet.

    ``replicas`` are peer names the underlying ``rpc`` can reach (dial
    them with ``rpc.connect`` / rely on gossip before or after
    construction; probing tolerates not-yet-connected peers — a replica
    becomes routable on its first successful probe)."""

    def __init__(self, rpc: Rpc, replicas: List[str], *,
                 service: str = "serve", default_budget_s: float = 5.0,
                 attempt_timeout_s: Optional[float] = None,
                 probe_interval_s: float = 0.2,
                 probe_timeout_s: float = 0.5, probe_misses: int = 3,
                 max_retries: int = 2, backoff_base_s: float = 0.01,
                 backoff_cap_s: float = 0.25, idempotent: bool = True,
                 breaker_window: int = 16, breaker_threshold: float = 0.5,
                 breaker_min_samples: int = 4,
                 breaker_cooldown_s: float = 0.5,
                 seed: Optional[int] = None):
        if not replicas:
            raise ValueError("need at least one replica name")
        self.rpc = rpc
        self.service = service
        self._ep_infer = f"{service}.infer"
        self._ep_health = f"{service}.health"
        self._default_budget = float(default_budget_s)
        # Per-attempt cap (None = the full remaining budget): bounding an
        # attempt below the budget is what lets a partitioned replica's
        # victim be rescued on a healthy one — drops are not conn losses,
        # so only this cap ends the attempt before the budget does.
        self._attempt_timeout = (
            None if attempt_timeout_s is None else float(attempt_timeout_s)
        )
        self._probe_interval = float(probe_interval_s)
        self._probe_timeout = float(probe_timeout_s)
        self._max_retries = int(max_retries)
        self._backoff_base = float(backoff_base_s)
        self._backoff_cap = float(backoff_cap_s)
        self._idempotent = bool(idempotent)
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._closed = False
        # Canary slice (the reference's fleet rollout): a replica subset that
        # receives ``weight`` of the traffic, with per-slice outcome
        # stats so the rollout's SLO gates read the CURRENT regime
        # (RollingQuantile, not the forever-cumulative histogram). All
        # three fields move together under ``_lock``.
        self._canary: frozenset = frozenset()
        self._canary_weight = 0.0
        self._slice_stats = self._fresh_slice_stats()
        self._drain_hooks: List[Any] = []

        self._health: Dict[str, ReplicaHealth] = {}
        for i, name in enumerate(replicas):
            breaker = CircuitBreaker(
                window=breaker_window, threshold=breaker_threshold,
                min_samples=breaker_min_samples,
                cooldown_s=breaker_cooldown_s,
                seed=None if seed is None else seed + i,
            )
            self._health[name] = ReplicaHealth(
                name, probe_misses=probe_misses, breaker=breaker,
            )

        tel = rpc.telemetry
        reg = tel.registry
        self._tel = tel
        self._m_requests = reg.counter("serving_router_requests_total",
                                       service=service)
        self._m_ok = reg.counter("serving_router_ok_total", service=service)
        self._m_retried = reg.counter("serving_retried_total",
                                      service=service)
        self._m_errors: Dict[str, Any] = {}
        self._m_latency = reg.histogram("serving_request_seconds",
                                        service=service)
        self._m_dispatch: Dict[str, Any] = {}
        self._m_probe_miss = reg.counter("serving_probe_misses_total",
                                         service=service)
        # Executor for infer_async callers (load generators, benches).
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=32, thread_name_prefix=f"{rpc.get_name()}-route"
        )
        self._stop = threading.Event()
        self._prober = threading.Thread(
            target=_probe_entry,
            args=(weakref.ref(self), self._stop, self._probe_interval),
            name=f"{rpc.get_name()}-{service}-probe", daemon=True,
        )
        self._prober.start()

    # -- health probing ------------------------------------------------------

    def _probe_sweep(self):
        """One probe pass over the fleet; driven by :func:`_probe_entry`
        so the prober never pins ``self`` across the interval wait."""
        for name, h in list(self._health.items()):
            if self._closed:
                return
            self._probe_one(name, h)

    def _probe_one(self, name: str, h: ReplicaHealth):
        try:
            fut = self.rpc.call_with_deadline(
                name, self._ep_health, self._probe_timeout
            )
            info = fut.result(timeout=self._probe_timeout + 2.0)
            h.probe_ok(info)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except (RpcError, TimeoutError) as e:
            h.probe_miss()
            if self._tel.on:
                self._m_probe_miss.inc()
            log.debug("probe %s failed: %s", name, e)

    # -- dispatch ------------------------------------------------------------

    def routable(self) -> List[str]:
        now = time.monotonic()
        return [n for n, h in list(self._health.items())
                if h.routable(now)]

    def _pick(self, exclude) -> Optional[str]:
        """Least-loaded routable replica not in ``exclude`` (falls back
        to already-tried ones rather than refusing outright — with every
        candidate tried once, a second visit beats an error while budget
        remains). Half-open breakers hand out one trial at dispatch.

        With a canary slice installed, the traffic split is decided
        FIRST (one weighted coin per pick), then least-loaded within the
        chosen slice — but untried-beats-tried stays dominant and each
        slice falls back to the other before refusing: a canary made of
        corpses must degrade to stable dispatch, never to ``Overloaded``
        (the zero-downtime half of the rollout contract)."""
        now = time.monotonic()
        with self._lock:
            canary, weight = self._canary, self._canary_weight
        if canary:
            # None marks the stable slice: membership is "not in canary"
            # so replicas never fall in a gap between the two pools.
            preferred = canary if self._rng.random() < weight else None
            slices = (preferred, self._other(preferred, canary))
        else:
            slices = (None,)
        for pool in (exclude, None):
            for slc in slices:
                cands = [
                    (h.load_key(), self._rng.random(), n)
                    for n, h in list(self._health.items())
                    if h.routable(now) and (pool is None or n not in pool)
                    and self._in_slice(n, slc, canary)
                ]
                for _key, _jit, name in sorted(cands):
                    if self._health[name].breaker.try_acquire(
                            time.monotonic()):
                        return name
        return None

    @staticmethod
    def _other(preferred, canary):
        return None if preferred is canary else canary

    @staticmethod
    def _in_slice(name, slc, canary) -> bool:
        if slc is None:  # stable slice (or no canary at all)
            return not canary or name not in canary
        return name in slc

    def infer(self, x: Any, *, budget_s: Optional[float] = None) -> Any:
        """Route one request; returns the replica's reply or raises an
        explicit, typed error — always within the budget (plus a small
        bounded slack), never the transport's own deadline."""
        budget = self._default_budget if budget_s is None else float(budget_s)
        if budget <= 0:
            raise ValueError(f"budget_s must be positive, got {budget_s!r}")
        if self._closed:
            raise RpcError("Router is closed")
        deadline = time.monotonic() + budget
        if self._tel.on:
            self._m_requests.inc()
        t_start = time.monotonic()
        tried: set = set()
        attempt = 0
        last_exc: Optional[Exception] = None
        while True:
            now = time.monotonic()
            remaining = deadline - now
            if remaining <= 1e-3:
                self._count_error("deadline")
                raise DeadlineExceeded(
                    f"budget {budget:.3f}s exhausted after {attempt} "
                    f"attempt(s); last error: {last_exc}"
                )
            name = self._pick(tried)
            if name is None:
                self._count_error("no_replica")
                raise Overloaded(
                    "no routable replica for service "
                    f"{self.service!r} (fleet: {sorted(self._health)}; "
                    f"last error: {last_exc})"
                )
            attempt_budget = remaining if self._attempt_timeout is None \
                else min(remaining, self._attempt_timeout)
            h = self._health[name]
            h.add_outstanding(1)
            t0 = time.monotonic()
            err: Optional[Exception] = None
            try:
                fut = self.rpc.call_with_deadline(
                    name, self._ep_infer, attempt_budget, x
                )
                result = fut.result(timeout=attempt_budget + 2.0)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError) as e:
                err = e
            finally:
                h.add_outstanding(-1)
            dt = time.monotonic() - t0
            if err is None:
                h.record_call(True, time.monotonic(), latency_s=dt)
                self._record_slice(name, True, dt)
                if self._tel.on:
                    self._m_ok.inc()
                    self._m_latency.observe(time.monotonic() - t_start)
                    self._dispatch_counter(name).inc()
                return result
            kind = error_kind(err)
            if kind not in ("overloaded", "deadline"):
                # Admission refusals are load signals, not failures —
                # only real failures feed the slice error-rate gate.
                self._record_slice(name, False, dt)
            last_exc = err
            tried.add(name)
            if kind == "deadline" and attempt_budget >= remaining - 1e-3:
                # The attempt carried the WHOLE remaining budget, so the
                # refusal means the budget is gone everywhere: terminal.
                self._count_error("deadline")
                raise DeadlineExceeded(str(err)) from None
            if kind in ("overloaded", "deadline"):
                # Refused before execution (admission door or a shed
                # against the per-attempt slice): the replica is alive
                # and answered — a load signal, not a failure. Recording
                # success keeps the breaker honest AND settles a
                # half-open trial this dispatch may have acquired.
                h.record_call(True, time.monotonic())
            else:
                h.record_call(False, time.monotonic())
            retryable = kind in ("overloaded", "deadline") or (
                self._idempotent and kind in ("conn", "timeout", "other")
            )
            attempt += 1
            if not retryable or attempt > self._max_retries:
                self._count_error(kind)
                raise err
            if self._tel.on:
                self._m_retried.inc()
            # Capped exponential backoff with full jitter, never past the
            # deadline: an overloaded fleet must not see a retry stampede.
            ceiling = min(self._backoff_cap,
                          self._backoff_base * (2 ** (attempt - 1)))
            pause = min(self._rng.uniform(0.0, ceiling),
                        max(0.0, deadline - time.monotonic()))
            if pause > 0:
                time.sleep(pause)

    def infer_async(self, x: Any, *,
                    budget_s: Optional[float] = None
                    ) -> "concurrent.futures.Future":
        """`infer` on the router's thread pool — the concurrency surface
        for load generators and pipelined clients."""
        return self._pool.submit(self.infer, x, budget_s=budget_s)

    # -- canary slice (fleet rollout) ----------------------------------------

    @staticmethod
    def _fresh_slice_stats():
        return {s: {"ok": 0, "errors": 0, "lat": RollingQuantile(256)}
                for s in ("canary", "stable")}

    def _record_slice(self, name: str, ok: bool, latency_s: float) -> None:
        lat = None
        with self._lock:
            key = "canary" if name in self._canary else "stable"
            s = self._slice_stats[key]
            if ok:
                s["ok"] += 1
                lat = s["lat"]
            else:
                s["errors"] += 1
        if lat is not None:
            # Observed OUTSIDE the router lock (RollingQuantile has its
            # own): a concurrent set_canary may have swapped the stats,
            # in which case this sample lands in the discarded window —
            # exactly the reset semantics the SLO gates want.
            lat.observe(latency_s)

    def set_canary(self, replicas, weight: float) -> None:
        """Install a canary slice: ``replicas`` (known names) carry
        ``weight`` of the traffic from the next pick on. Installing a
        slice resets the per-slice stats — the SLO gates must judge the
        canary regime, not history — and re-resolves atomically: there
        is never a pick that sees the new weight with the old slice."""
        names = frozenset(replicas)
        unknown = names - set(self._health)
        if unknown:
            raise ValueError(f"unknown replica(s) {sorted(unknown)}")
        if not names:
            raise ValueError("canary slice must name at least one replica")
        weight = float(weight)
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"weight must be in (0, 1], got {weight!r}")
        with self._lock:
            self._canary = names
            self._canary_weight = weight
            self._slice_stats = self._fresh_slice_stats()
        if self._tel.on:
            self._tel.registry.gauge(
                "serving_canary_weight", service=self.service
            ).set(weight)

    def clear_canary(self) -> None:
        """Remove the canary slice (promote/rollback epilogue): all
        traffic is least-loaded across the whole fleet again."""
        with self._lock:
            self._canary = frozenset()
            self._canary_weight = 0.0
        if self._tel.on:
            self._tel.registry.gauge(
                "serving_canary_weight", service=self.service
            ).set(0.0)

    def canary(self):
        """The installed slice as ``(names, weight)`` —
        ``(frozenset(), 0.0)`` when none."""
        with self._lock:
            return self._canary, self._canary_weight

    def slice_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-slice outcome stats since the last ``set_canary``:
        ``{"canary"|"stable": {n, ok, errors, p99_s}}`` — the inputs the
        rollout's SLO gates are derived from."""
        with self._lock:
            stats = {k: dict(ok=s["ok"], errors=s["errors"], lat=s["lat"])
                     for k, s in self._slice_stats.items()}
        out = {}
        for key, s in stats.items():
            out[key] = {
                "n": s["ok"] + s["errors"], "ok": s["ok"],
                "errors": s["errors"], "p99_s": s["lat"].quantile(0.99),
            }
        return out

    # -- fleet management ----------------------------------------------------

    def forget_replica(self, name: str) -> None:
        """Drop ``name`` from the fleet view entirely (the controller's
        permanent-down path): no more probes, no more dispatch — the
        router routes around the corpse instead of re-counting its
        probe misses forever. Unknown names are a no-op so forget after
        forget is idempotent."""
        with self._lock:
            self._canary = self._canary - {name}
            if not self._canary:
                self._canary_weight = 0.0
        self._health.pop(name, None)

    def add_drain_hook(self, fn) -> None:
        """Register ``fn(name)`` to run after ``drain_replica(name)``
        succeeds — the seam the fleet controller uses to sequence
        restarts behind graceful drains."""
        with self._lock:
            self._drain_hooks.append(fn)

    def publish_weights(self, params: Any, version: int, *,
                        timeout_s: float = 30.0,
                        replicas=None) -> Dict[str, bool]:
        """Hot-swap the model on every replica (draining ones included —
        they still serve admitted work), or on the ``replicas`` subset
        when given (the canary publish path). Returns per-replica
        success; a dark replica simply reports False (it will be told
        again by the next publisher once it returns — version
        monotonicity is the publisher's concern, not the wire's)."""
        targets = list(self._health) if replicas is None else list(replicas)
        unknown = set(targets) - set(self._health)
        if unknown:
            raise ValueError(f"unknown replica(s) {sorted(unknown)}")
        acks: Dict[str, bool] = {}
        futs = {
            name: self.rpc.call_with_deadline(
                name, f"{self.service}.load", timeout_s, params, version
            )
            for name in targets
        }
        for name, fut in futs.items():
            try:
                acks[name] = fut.result(timeout=timeout_s + 2.0) == version
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError) as e:
                log.warning("publish to %s failed: %s", name, e)
                acks[name] = False
        return acks

    def drain_replica(self, name: str, *,
                      timeout_s: float = 60.0) -> bool:
        """Ask ``name`` to drain gracefully (finish admitted work, refuse
        new). The probe loop sees ``draining`` and stops routing there
        without a breaker penalty."""
        if name not in self._health:
            raise ValueError(f"unknown replica {name!r}")
        fut = self.rpc.call_with_deadline(
            name, f"{self.service}.drain", timeout_s
        )
        try:
            reply = fut.result(timeout=timeout_s + 2.0)
            drained = bool(reply and reply.get("drained"))
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except (RpcError, TimeoutError) as e:
            log.warning("drain of %s failed: %s", name, e)
            return False
        if drained:
            with self._lock:
                hooks = list(self._drain_hooks)
            for fn in hooks:
                fn(name)
        return drained

    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        return {
            "service": self.service,
            "replicas": {n: h.state(now)
                         for n, h in list(self._health.items())},
            "routable": self.routable(),
        }

    # -- internals -----------------------------------------------------------

    def _dispatch_counter(self, name: str):
        c = self._m_dispatch.get(name)
        if c is None:
            c = self._tel.registry.counter(
                "serving_dispatch_total", service=self.service, replica=name
            )
            self._m_dispatch[name] = c
        return c

    def _count_error(self, kind: str):
        if not self._tel.on:
            return
        c = self._m_errors.get(kind)
        if c is None:
            c = self._tel.registry.counter(
                "serving_router_errors_total", service=self.service,
                kind=kind,
            )
            self._m_errors[kind] = c
        c.inc()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._prober.join(timeout=5)
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def publish_from_accumulator(router: Router, accumulator, params: Any,
                             *, timeout_s: float = 30.0) -> Dict[str, bool]:
    """Publish a training cohort's current weights into the serving
    fleet: the version is the accumulator's ``model_version`` (already
    monotone under its election/supersession rules), ``params`` the
    bundle the trainer materialized for that version. In-flight requests
    keep the params their batch captured — nothing is dropped by a swap."""
    return router.publish_weights(
        params, int(accumulator.model_version), timeout_s=timeout_s
    )


def publish_from_statestore(router: Router, store, *,
                            peers: "tuple | list" = (),
                            version: Optional[int] = None,
                            quorum: int = 1,
                            timeout_s: float = 30.0):
    """Publish a *durable* model version into the serving fleet — the
    path that survives the death of the training host: weights come out
    of the statestore (local, or negotiated+pulled from the replica
    ``peers`` when the local disk was lost), so a hot publish into the
    serving tier can never be orphaned by a single machine loss.

    With ``version=None`` the newest restorable version wins: the
    restore negotiation across ``peers`` + the local store when peers
    are given, else the newest locally verified version. Returns
    ``(version, acks)``; raises
    :class:`~moolib_tpu_torch.statestore.StateStoreError` when nothing
    restorable exists anywhere."""
    from ..statestore import StateStoreError  # local: no import cycle

    if version is not None:
        params = store.load(int(version))
        v = int(version)
    elif peers:
        restored = store.restore(tuple(peers), quorum=quorum,
                                 timeout=timeout_s)
        if restored is None:
            raise StateStoreError(
                "no restorable model version on any replica"
            )
        v, params = restored
    else:
        v = store.latest()
        if v is None:
            raise StateStoreError("local statestore holds no verified "
                                  "version and no peers were given")
        params = store.load(v)
    return v, router.publish_weights(params, v, timeout_s=timeout_s)
