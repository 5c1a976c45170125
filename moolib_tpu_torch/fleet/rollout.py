"""Zero-downtime model rollout: canary -> SLO gates -> promote/rollback;
the counterpart of :mod:`moolib_tpu.fleet.rollout`.

The state machine::

    idle -> canary -> settling -> promoted
                        \\-> rolled_back

- **canary** — the new version is published onto a deterministic subset
  of routable replicas (sorted, first ``canary_replicas``), then the
  Router's weighted canary dispatch sends ``canary_weight`` of the
  traffic there. Per-slice stats are reset at install, so the gates
  judge the canary regime, not history.
- **settling** — for ``settle_s`` seconds the SLO gates are evaluated
  on every tick; the traffic gates engage once the canary slice has
  ``min_samples`` attempts (one noisy first sample must not flip a
  ratio gate; an idle canary promotes at window end — an offline fleet
  cannot hold a rollout hostage):

  - *error rate*: canary attempt failures / attempts above
    ``error_rate_max`` (admission refusals are load signals and do not
    count — see ``Router._record_slice``);
  - *p99*: the canary slice's ``RollingQuantile`` p99 above
    ``p99_ratio_max`` x the stable slice's p99, floored at
    ``p99_floor_s`` so a microsecond-quiet baseline cannot flake the
    ratio;
  - *reward bar* (training canaries): ``reward_fn()`` below
    ``reward_min``.

- **promoted** — the settle window closed green: the new version is
  published to the WHOLE fleet and the canary slice cleared. In-flight
  requests keep the params their batch captured (the Replica hot-swap
  contract), so zero accepted requests are dropped.
- **rolled_back** — a gate breached: the *exact prior version* is
  republished to every replica (from the in-memory registry, or from
  the statestore when a ``store`` is given — the durable path), the
  canary cleared, and a flightrec incident bundle captured
  (``fleet_rollback`` trigger) so the breach and the transition sit on
  the same timeline.

Every transition is a typed ``fleet_rollout`` flight event; breaches add
``fleet_slo_breach``. A ``stop`` event (controller death) freezes the
machine mid-settle — the cohort record then carries enough state for a
standby controller to resume it (fresh settle window), which is how a
canary is never orphaned.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils import get_logger
from .spec import RolloutSpec

__all__ = ["Rollout", "RolloutError"]

log = get_logger("fleet")

#: ordered rollout states.
STATES = ("idle", "canary", "settling", "promoted", "rolled_back")


class RolloutError(RuntimeError):
    """A rollout could not even start (no routable canary candidates,
    canary publish rejected) — distinct from a rollback, which is the
    machine *working*."""


class Rollout:
    """One drive of the rollout state machine. Construct, then
    :meth:`run` (blocking; the controller backgrounds it for the
    async shape). ``stop`` is the controller's kill/close event: set, it
    freezes the machine mid-settle for a successor to resume."""

    def __init__(self, router, spec: RolloutSpec, *, fleet: str,
                 params: Any, version: int,
                 prior_params: Any = None, prior_version: int = 0,
                 telemetry=None, reward_fn: Optional[Callable] = None,
                 incident_dir: Optional[str] = None, store=None,
                 on_state: Optional[Callable] = None,
                 stop: Optional[threading.Event] = None,
                 tick_s: float = 0.02, publish_timeout_s: float = 10.0):
        spec.validate("rollout")
        self.router = router
        self.spec = spec
        self.fleet = fleet
        self.params = params
        self.version = int(version)
        self.prior_params = prior_params
        self.prior_version = int(prior_version)
        self.reward_fn = reward_fn
        self.incident_dir = incident_dir
        self.store = store
        self._on_state = on_state
        self._stop = stop if stop is not None else threading.Event()
        self._tick = float(tick_s)
        self._publish_timeout = float(publish_timeout_s)
        self._tel = (telemetry if telemetry is not None
                     else router.rpc.telemetry)
        self.state = "idle"
        self.breach: Optional[Dict[str, Any]] = None
        self.incident_path: Optional[str] = None

    # -- state bookkeeping ---------------------------------------------------

    def _transition(self, state: str) -> None:
        assert state in STATES, state
        self.state = state
        log.info("fleet %s rollout v%d: %s", self.fleet, self.version,
                 state)
        if self._tel.on:
            fr = self._tel.flight
            if fr.on:
                fr.record("fleet_rollout", fleet=self.fleet, state=state,
                          version=self.version)
            if state in ("promoted", "rolled_back"):
                self._tel.registry.counter(
                    "fleet_rollouts_total", fleet=self.fleet,
                    outcome=state,
                ).inc()
        if self._on_state is not None:
            self._on_state(state, self.version)

    def _breach(self, gate: str, value: float, bound: float) -> None:
        self.breach = {"gate": gate, "value": float(value),
                       "bound": float(bound)}
        log.warning("fleet %s rollout v%d: SLO breach %s=%.6g "
                    "(bound %.6g)", self.fleet, self.version, gate,
                    value, bound)
        if self._tel.on:
            self._tel.registry.counter(
                "fleet_slo_breaches_total", fleet=self.fleet, gate=gate,
            ).inc()
            fr = self._tel.flight
            if fr.on:
                fr.record("fleet_slo_breach", fleet=self.fleet, gate=gate,
                          value=float(value), bound=float(bound))

    # -- the drive -----------------------------------------------------------

    def run(self) -> str:
        """Drive to a terminal state (or freeze on ``stop``); returns
        the final state."""
        canary = self._pick_canary()
        acks = self.router.publish_weights(
            self.params, self.version, timeout_s=self._publish_timeout,
            replicas=sorted(canary),
        )
        self._transition("canary")
        if not all(acks.values()):
            # The canary slice never fully took the version: roll back
            # before any traffic shifts (still an incident — the version
            # failed to deploy).
            self._breach("publish", sum(not v for v in acks.values()), 0)
            return self._rollback(f"canary publish not acked: {acks}")
        self.router.set_canary(canary, self.spec.canary_weight)
        self._transition("settling")
        verdict = self._settle()
        if verdict is None:
            # stop event mid-settle: leave the record as "settling" for
            # the adopter; do NOT clear the canary — the successor owns
            # that decision (clearing here would double-decide).
            return self.state
        if verdict:
            return self._promote()
        return self._rollback(
            f"SLO breach: {self.breach}" if self.breach else "SLO breach"
        )

    def _pick_canary(self) -> frozenset:
        routable = sorted(self.router.routable())
        k = self.spec.canary_replicas
        if len(routable) < k:
            raise RolloutError(
                f"need {k} routable replicas to canary, have "
                f"{len(routable)} ({routable})"
            )
        if len(routable) == k:
            raise RolloutError(
                f"refusing to canary the whole routable fleet "
                f"({routable}): a breach would leave no stable slice"
            )
        return frozenset(routable[:k])

    def _settle(self) -> Optional[bool]:
        """The settle window: True = green, False = breach, None =
        stopped mid-settle."""
        deadline = time.monotonic() + self.spec.settle_s
        while True:
            if self._stop.is_set():
                return None
            if not self._gates_green():
                return False
            if time.monotonic() >= deadline:
                # One last look at the gates closes the window.
                return bool(self._gates_green())
            time.sleep(self._tick)

    def _gates_green(self) -> bool:
        s = self.router.slice_stats()
        can, stable = s["canary"], s["stable"]
        if can["n"] >= self.spec.min_samples:
            err_rate = can["errors"] / can["n"]
            if err_rate > self.spec.error_rate_max:
                self._breach("error_rate", err_rate,
                             self.spec.error_rate_max)
                return False
            p99c = can["p99_s"]
            if p99c is not None:
                base = max(stable["p99_s"] or 0.0, self.spec.p99_floor_s)
                bound = self.spec.p99_ratio_max * base
                if p99c > bound:
                    self._breach("p99", p99c, bound)
                    return False
        if self.reward_fn is not None and self.spec.reward_min is not None:
            reward = float(self.reward_fn())
            if reward < self.spec.reward_min:
                self._breach("reward", reward, self.spec.reward_min)
                return False
        return True

    def _promote(self) -> str:
        acks = self.router.publish_weights(
            self.params, self.version, timeout_s=self._publish_timeout,
        )
        bad = sorted(n for n, ok in acks.items() if not ok)
        if bad:
            log.warning("fleet %s rollout v%d: promote not acked by %s "
                        "(they will be told again by the next publish)",
                        self.fleet, self.version, bad)
        self.router.clear_canary()
        self._transition("promoted")
        return self.state

    def _rollback(self, detail: str) -> str:
        """Restore the exact prior version on EVERY replica (stable ones
        are already on it; republishing is idempotent and makes the
        invariant unconditional), clear the canary, freeze a bundle."""
        params = self.prior_params
        if params is None and self.store is not None:
            # The durable path: the prior version comes back out of the
            # statestore, so rollback survives the trainer host too.
            params = self.store.load(self.prior_version)
        if params is None:
            raise RolloutError(
                f"no prior params for v{self.prior_version}: cannot "
                "roll back"
            )
        self.router.publish_weights(
            params, self.prior_version, timeout_s=self._publish_timeout,
        )
        self.router.clear_canary()
        self._transition("rolled_back")
        from ..flightrec import capture_incident

        self.incident_path = capture_incident(
            "fleet_rollback",
            f"fleet {self.fleet}: v{self.version} -> "
            f"v{self.prior_version}: {detail}",
            telemetry=self._tel, out_dir=self.incident_dir,
        )
        return self.state
