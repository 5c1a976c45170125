"""Typed flight-recorder event kinds — the black box's schema; the
counterpart of :mod:`moolib_tpu.flightrec.events`, with the same kinds
and fields, so bundles of the two packages validate against each other.

Every state transition the recorder captures is a *typed* event: a kind
from :data:`KINDS` with exactly the field names that kind declares, never
a free-form string. The instrument seams record against it, the bundle
format validates against it on *load*, and the merge renders each kind
onto the cross-peer timeline without per-producer special cases.

Field values must be JSON scalars (str/int/float/bool/None) or flat
lists of scalars — the bundle is strict JSON and a round-trip must be
identical.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = ["KINDS", "check_event_fields"]

#: kind -> exact field-name tuple. Grouped by the reference's seam that
#: emits them (moolib_tpu/...); the port's seams emit the same kinds.
KINDS: Dict[str, Tuple[str, ...]] = {
    # RPC transport (moolib_tpu/rpc/rpc.py)
    "conn_up": ("peer", "transport"),
    "conn_down": ("peer", "transport", "why"),
    "call_resend": ("peer", "endpoint"),
    "call_timeout": ("peer", "endpoint"),
    # Group membership / broker authority (moolib_tpu/rpc/group.py)
    "group_epoch": ("group", "sync_id", "members", "cancelled"),
    "broker_dark": ("group", "broker", "silence_s"),
    "broker_promote": ("group", "old", "new", "silence_s"),
    # Accumulator training rounds (moolib_tpu/parallel/accumulator.py)
    "acc_leader": ("leader", "version", "is_self"),
    "acc_election": ("epoch",),
    "acc_round_commit": ("kind", "seq", "participants", "members"),
    "acc_round_reject": ("kind", "seq", "participants", "required"),
    "acc_round_failure": ("kind", "seq", "error"),
    "acc_writeoff": ("kind", "seq", "written_off"),
    # Serving tier (moolib_tpu/serving/)
    "breaker_open": ("name", "failures", "window"),
    "breaker_close": ("name",),
    "serving_shed": ("service", "shed"),
    "serving_drain": ("service", "pending"),
    # EnvPool worker tier (moolib_tpu/envpool/pool.py)
    "worker_death": ("pool", "slot", "kind", "reason"),
    "worker_respawn": ("pool", "slot"),
    "worker_down": ("pool", "slot", "strikes"),
    "env_quarantine": ("pool", "env", "why"),
    # Durable-state tier (moolib_tpu/statestore/)
    "ss_publish": ("store", "version", "chunks", "bytes"),
    "ss_replicate": ("store", "version", "peer", "ok"),
    "ss_write_failure": ("store", "version", "op", "error"),
    "ss_restore": ("store", "version", "holders", "refetched"),
    "ss_gc": ("store", "version"),
    # Fleet controller + rollout (moolib_tpu/fleet/)
    "fleet_spawn": ("fleet", "role", "kind", "backend"),
    "fleet_restart": ("fleet", "role", "strikes"),
    "fleet_down": ("fleet", "role", "strikes"),
    "fleet_adopt": ("fleet", "controller", "epoch", "roles"),
    "fleet_rollout": ("fleet", "state", "version"),
    "fleet_slo_breach": ("fleet", "gate", "value", "bound"),
    # Step-phase attribution (moolib_tpu/telemetry/stepscope.py): a
    # periodic stamp of a hot loop's windowed critical-path fractions,
    # so the merged incident timeline shows what the cohort was spending
    # its steps on when it died.
    "step_phases": ("loop", "steps", "wall_s", "exposed_comms",
                    "host_blocked", "env_wait"),
    # chaosnet injections (moolib_tpu/testing/chaos.py) and the incident
    # machinery itself (moolib_tpu/flightrec/capture.py)
    "chaos": ("kind", "action", "peer", "endpoint"),
    "incident": ("trigger", "detail"),
}

_SCALARS = (str, int, float, bool, type(None))


def check_event_fields(kind: str, fields: Dict[str, Any]) -> None:
    """Validate (kind, fields) against :data:`KINDS` — exact field-name
    match, JSON-scalar (or flat scalar-list) values. Raises ValueError."""
    schema = KINDS.get(kind)
    if schema is None:
        raise ValueError(
            f"unknown flightrec event kind {kind!r} "
            f"(known: {sorted(KINDS)})"
        )
    if set(fields) != set(schema):
        raise ValueError(
            f"event kind {kind!r} requires exactly fields {sorted(schema)}, "
            f"got {sorted(fields)}"
        )
    for name, value in fields.items():
        if isinstance(value, _SCALARS):
            continue
        if isinstance(value, (list, tuple)) and all(
            isinstance(v, _SCALARS) for v in value
        ):
            continue
        raise ValueError(
            f"event {kind!r} field {name!r} must be a JSON scalar or a "
            f"flat list of scalars, got {type(value).__name__}"
        )
