"""Declarative fleet spec — the cohort shape as data; the counterpart of
:mod:`moolib_tpu.fleet.spec` (the same fields, defaults, validation
messages and JSON text).

Every survivability feature shipped since the quorum/failover work is a
library piece the examples wire by hand: N learner peers with a quorum
and a straggler deadline, M env workers, K serving replicas behind a
router, a broker with standbys, a statestore replication factor. The
spec makes that shape a *value*: a nested frozen dataclass tree that is

- **validated** at construction — every violation names the dotted field
  path (``serving.replicas must be >= 1, got 0``) so a bad launch config
  fails in milliseconds with the field to fix, not mid-materialization;
- **JSON round-trippable** — ``to_json()`` / ``FleetSpec.from_json()``
  are exact inverses (pinned in tests), so a spec can live in a file,
  ride the wire to a standby controller, and come back identical;
- **the adoption contract** — a standby controller re-materializes the
  fleet from the spec plus observed cohort state
  (:mod:`moolib_tpu_torch.fleet.controller`), so the spec is the single source
  of truth for *what should exist*.

``FleetSpec.small()`` is the canonical toy shape the smoke tool, the
bench row and the chaos scenarios all start from.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = [
    "SpecError",
    "LearnerSpec",
    "EnvSpec",
    "ServingSpec",
    "BrokerSpec",
    "StateStoreSpec",
    "SupervisionSpec",
    "RolloutSpec",
    "FleetSpec",
]


class SpecError(ValueError):
    """A fleet spec failed validation; the message names the dotted
    field path that is wrong (``learners.min_quorum``) so the fix is
    named, not hunted."""


def _check(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise SpecError(f"{path} {msg}")


@dataclass(frozen=True)
class LearnerSpec:
    """The training cohort: ``n`` learner peers committing gradient
    rounds with ``min_quorum``-of-``n`` contributions after
    ``straggler_timeout_s`` (None = full-cohort lock step)."""

    n: int = 1
    min_quorum: Optional[int] = None
    straggler_timeout_s: Optional[float] = None
    group: str = "fleet"

    def validate(self, path: str = "learners") -> None:
        _check(self.n >= 0, f"{path}.n",
               f"must be >= 0 (0 = serving-only fleet), got {self.n!r}")
        if self.min_quorum is not None:
            _check(1 <= self.min_quorum <= max(self.n, 1),
                   f"{path}.min_quorum",
                   f"must be in [1, n={self.n}], got {self.min_quorum!r}")
        if self.straggler_timeout_s is not None:
            _check(self.straggler_timeout_s > 0,
                   f"{path}.straggler_timeout_s",
                   f"must be > 0, got {self.straggler_timeout_s!r}")
        _check(bool(self.group), f"{path}.group", "must be non-empty")


@dataclass(frozen=True)
class EnvSpec:
    """The acting tier: ``n`` env-worker peers feeding the learners."""

    n: int = 0

    def validate(self, path: str = "env_workers") -> None:
        _check(self.n >= 0, f"{path}.n", f"must be >= 0, got {self.n!r}")


@dataclass(frozen=True)
class ServingSpec:
    """The inference tier: ``replicas`` model replicas behind
    ``routers`` load-aware routers on service name ``service``."""

    replicas: int = 0
    routers: int = 0
    service: str = "serve"
    batch_size: int = 4
    max_queue: int = 128

    def validate(self, path: str = "serving") -> None:
        _check(self.replicas >= 0, f"{path}.replicas",
               f"must be >= 0, got {self.replicas!r}")
        _check(self.routers >= 0, f"{path}.routers",
               f"must be >= 0, got {self.routers!r}")
        if self.routers > 0:
            _check(self.replicas >= 1, f"{path}.replicas",
                   f"must be >= 1 when routers > 0, got {self.replicas!r}")
        _check(bool(self.service), f"{path}.service", "must be non-empty")
        _check(self.batch_size >= 1, f"{path}.batch_size",
               f"must be >= 1, got {self.batch_size!r}")
        _check(self.max_queue >= 1, f"{path}.max_queue",
               f"must be >= 1, got {self.max_queue!r}")


@dataclass(frozen=True)
class BrokerSpec:
    """Cohort membership authority: one primary broker plus
    ``standbys`` idle brokers members can promote."""

    standbys: int = 0

    def validate(self, path: str = "broker") -> None:
        _check(self.standbys >= 0, f"{path}.standbys",
               f"must be >= 0, got {self.standbys!r}")


@dataclass(frozen=True)
class StateStoreSpec:
    """Durable-state tier: every published model version is replicated
    to ``replication`` peers (0 disables the tier)."""

    replication: int = 0

    def validate(self, path: str = "statestore") -> None:
        _check(self.replication >= 0, f"{path}.replication",
               f"must be >= 0, got {self.replication!r}")


@dataclass(frozen=True)
class SupervisionSpec:
    """Role supervision knobs — the EnvPool restart-budget idiom at
    fleet scale: ``probe_misses`` consecutive missed health probes
    declare a role dead; deaths are respawned under capped-exponential
    full-jitter backoff, and more than ``restart_limit`` deaths inside
    ``restart_window_s`` degrade the role to permanently down."""

    probe_interval_s: float = 0.2
    probe_timeout_s: float = 0.5
    probe_misses: int = 3
    restart_limit: int = 3
    restart_window_s: float = 60.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0

    def validate(self, path: str = "supervision") -> None:
        _check(self.probe_interval_s > 0, f"{path}.probe_interval_s",
               f"must be > 0, got {self.probe_interval_s!r}")
        _check(self.probe_timeout_s > 0, f"{path}.probe_timeout_s",
               f"must be > 0, got {self.probe_timeout_s!r}")
        _check(self.probe_misses >= 1, f"{path}.probe_misses",
               f"must be >= 1, got {self.probe_misses!r}")
        _check(self.restart_limit >= 0, f"{path}.restart_limit",
               f"must be >= 0, got {self.restart_limit!r}")
        _check(self.restart_window_s > 0, f"{path}.restart_window_s",
               f"must be > 0, got {self.restart_window_s!r}")
        _check(self.backoff_base_s > 0, f"{path}.backoff_base_s",
               f"must be > 0, got {self.backoff_base_s!r}")
        _check(self.backoff_cap_s >= self.backoff_base_s,
               f"{path}.backoff_cap_s",
               f"must be >= backoff_base_s={self.backoff_base_s}, "
               f"got {self.backoff_cap_s!r}")


@dataclass(frozen=True)
class RolloutSpec:
    """Zero-downtime rollout policy: canary a new version onto
    ``canary_replicas`` replicas carrying ``canary_weight`` of traffic,
    watch the SLO gates over a ``settle_s`` window (the traffic gates
    engage once the canary slice has ``min_samples`` attempts, so one
    noisy first sample cannot flip them; an idle canary promotes at
    window end — an offline fleet cannot hold a rollout hostage), then
    auto-promote on green or auto-rollback on breach.

    Gates: canary attempt error rate above
    ``error_rate_max``; canary p99 above ``p99_ratio_max`` x the stable
    slice's p99 (floored at ``p99_floor_s`` so a microsecond-quiet
    baseline cannot flake the ratio); and — for training canaries — a
    reward bar: the controller's ``reward_fn`` dropping below
    ``reward_min`` (None disables the gate)."""

    canary_replicas: int = 1
    canary_weight: float = 0.25
    settle_s: float = 5.0
    min_samples: int = 8
    error_rate_max: float = 0.1
    p99_ratio_max: float = 3.0
    p99_floor_s: float = 0.1
    reward_min: Optional[float] = None

    def validate(self, path: str = "rollout") -> None:
        _check(self.canary_replicas >= 1, f"{path}.canary_replicas",
               f"must be >= 1, got {self.canary_replicas!r}")
        _check(0.0 < self.canary_weight <= 1.0, f"{path}.canary_weight",
               f"must be in (0, 1], got {self.canary_weight!r}")
        _check(self.settle_s > 0, f"{path}.settle_s",
               f"must be > 0, got {self.settle_s!r}")
        _check(self.min_samples >= 1, f"{path}.min_samples",
               f"must be >= 1, got {self.min_samples!r}")
        _check(0.0 <= self.error_rate_max <= 1.0, f"{path}.error_rate_max",
               f"must be in [0, 1], got {self.error_rate_max!r}")
        _check(self.p99_ratio_max > 0, f"{path}.p99_ratio_max",
               f"must be > 0, got {self.p99_ratio_max!r}")
        _check(self.p99_floor_s >= 0, f"{path}.p99_floor_s",
               f"must be >= 0, got {self.p99_floor_s!r}")


#: section name -> nested spec type (the one table from_json/to_json,
#: validation and the controller's materialization all walk).
SECTIONS: Dict[str, type] = {
    "learners": LearnerSpec,
    "env_workers": EnvSpec,
    "serving": ServingSpec,
    "broker": BrokerSpec,
    "statestore": StateStoreSpec,
    "supervision": SupervisionSpec,
    "rollout": RolloutSpec,
}


@dataclass(frozen=True)
class FleetSpec:
    """The whole cohort as one validated value. ``validate()`` runs at
    construction; an invalid spec is unrepresentable."""

    name: str = "fleet"
    learners: LearnerSpec = field(default_factory=LearnerSpec)
    env_workers: EnvSpec = field(default_factory=EnvSpec)
    serving: ServingSpec = field(default_factory=ServingSpec)
    broker: BrokerSpec = field(default_factory=BrokerSpec)
    statestore: StateStoreSpec = field(default_factory=StateStoreSpec)
    supervision: SupervisionSpec = field(default_factory=SupervisionSpec)
    rollout: RolloutSpec = field(default_factory=RolloutSpec)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        _check(bool(self.name) and isinstance(self.name, str), "name",
               f"must be a non-empty string, got {self.name!r}")
        for section, cls in SECTIONS.items():
            value = getattr(self, section)
            if not isinstance(value, cls):
                raise SpecError(
                    f"{section} must be a {cls.__name__}, "
                    f"got {type(value).__name__}"
                )
            value.validate(section)

    # -- shapes ---------------------------------------------------------------

    def n_roles(self) -> int:
        """How many supervised role peers this spec materializes (the
        controller itself excluded)."""
        return (1 + self.broker.standbys + self.learners.n
                + self.env_workers.n + self.serving.replicas
                + self.serving.routers)

    @classmethod
    def small(cls, *, replicas: int = 2, routers: int = 1,
              learners: int = 1, env_workers: int = 1,
              settle_s: float = 1.0, name: str = "fleet") -> "FleetSpec":
        """The canonical toy shape: fast knobs everywhere, suited to the
        smoke tool, the bench row, and scenario seeds."""
        return cls(
            name=name,
            learners=LearnerSpec(n=learners),
            env_workers=EnvSpec(n=env_workers),
            serving=ServingSpec(replicas=replicas, routers=routers),
            supervision=SupervisionSpec(
                probe_interval_s=0.1, probe_timeout_s=0.5,
                backoff_base_s=0.02, backoff_cap_s=0.2,
            ),
            rollout=RolloutSpec(settle_s=settle_s, min_samples=4,
                                canary_weight=0.5),
        )

    # -- JSON round trip ------------------------------------------------------

    def to_json(self) -> str:
        """Serialize to JSON text; ``FleetSpec.from_json`` is the exact
        inverse, and the same text as the reference's for the same
        spec."""
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        """Parse + validate. Unknown fields are rejected by name with a
        did-you-mean suggestion — a typo'd knob must not silently become
        the default."""
        try:
            raw = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"spec is not valid JSON: {e}") from None
        if not isinstance(raw, dict):
            raise SpecError(
                f"spec must be a JSON object, got {type(raw).__name__}"
            )
        kwargs: Dict[str, Any] = {}
        top_known = ["name"] + list(SECTIONS)
        for key, value in raw.items():
            if key == "name":
                kwargs["name"] = value
                continue
            section_cls = SECTIONS.get(key)
            if section_cls is None:
                raise SpecError(_unknown(key, top_known, "spec"))
            if not isinstance(value, dict):
                raise SpecError(
                    f"{key} must be a JSON object, "
                    f"got {type(value).__name__}"
                )
            known = [f.name for f in dataclasses.fields(section_cls)]
            for sub in value:
                if sub not in known:
                    raise SpecError(_unknown(sub, known, key))
            try:
                kwargs[key] = section_cls(**value)
            except TypeError as e:
                raise SpecError(f"{key}: {e}") from None
        return cls(**kwargs)


def _unknown(key: str, known, where: str) -> str:
    hint = difflib.get_close_matches(str(key), list(known), n=1)
    suggest = f" (did you mean {hint[0]!r}?)" if hint else ""
    return (f"unknown field {key!r} in {where}{suggest}; "
            f"known: {sorted(known)}")
