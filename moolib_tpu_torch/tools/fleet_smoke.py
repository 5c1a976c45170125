"""Fleet rollout smoke of the port: spec -> cohort -> canary rollout, end
to end; the twin of the reference's ``tools/fleet_smoke.py``.

One bounded pass over the fleet tier's whole contract, its replicas
serving a numpy toy model on the card unless ``--device cpu``:

1. **Materialize** — a :meth:`FleetSpec.small` cohort (broker, learner,
   env worker, 3 serving replicas, router) comes up in-process from the
   declarative spec, JSON-round-tripped first so the text form is what
   actually materializes.
2. **Promote** — a healthy new model version rides the canary state
   machine under closed-loop load: weighted slice, SLO gates, promote.
   Zero accepted requests may be dropped across the swap.
3. **Rollback** — a poisoned version follows; the error-rate gate
   breaches inside the settle window, auto-rollback restores the exact
   promoted version on every replica (still zero dropped requests), and
   the incident bundle it captures re-validates from disk.
4. **Evidence** — the ``fleet_*`` counter family and the
   ``fleet_spawn``/``fleet_rollout``/``fleet_slo_breach`` flightrec
   events must all be present (and are printed): the smoke fails if the
   fleet tier went dark in telemetry even when the data path still works.

Usage::

    python -m moolib_tpu_torch.tools.fleet_smoke [--requests 200] [--seed 7]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time

import numpy as np

from ..fleet import FleetSpec
from ..flightrec import load_bundle
from ..testing.scenarios import FleetHarness, _await, _fleet_model, _run_load
from .statestore_smoke import evidence


def _drive_rollout(harness, version, params, requests, lock):
    """Start a background rollout, feed it load, return (state, bad)."""
    ctl = harness.controller
    ctl.publish_model(params, version)
    rollout = ctl.start_rollout(version=version, wait=False)
    _await(lambda: rollout.state == "settling", 10.0,
           "rollout never reached settling")
    outcomes: list = []
    threads = _run_load(harness.router, requests, 4, 8.0, outcomes, lock)
    _await(lambda: rollout.state in ("promoted", "rolled_back"),
           harness.spec.rollout.settle_s + 15.0,
           "rollout never reached a terminal state")
    for t in threads:
        t.join(timeout=120)
        if t.is_alive():
            raise AssertionError("load worker hung across the rollout")
    bad = [r for r in outcomes if r[0] != "ok"]
    return rollout, bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200,
                    help="closed-loop requests per rollout phase")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="the replicas' device (default: the card)")
    args = ap.parse_args()

    t0 = time.monotonic()
    spec = FleetSpec.from_json(
        FleetSpec.small(replicas=3, routers=1, settle_s=2.0).to_json()
    )
    lock = threading.Lock()
    with tempfile.TemporaryDirectory(prefix="fleet-smoke-") as tmp:
        harness = FleetHarness(spec, standby=False, seed=args.seed,
                               model=_fleet_model,
                               params={"scale": np.float32(2.0)},
                               incident_dir=tmp, device=args.device)
        try:
            harness.wait_routable(3)
            n = len(harness.controller.status()["roles"])
            print(f"materialized {n} roles from spec "
                  f"{spec.name!r} in {time.monotonic() - t0:.2f}s")

            rollout, bad = _drive_rollout(
                harness, 2, {"scale": np.float32(3.0)}, args.requests,
                lock)
            if rollout.state != "promoted" or bad:
                print(f"FAIL healthy rollout: state={rollout.state} "
                      f"dropped={bad[:3]}")
                return 1
            print(f"promoted v2 under load ({args.requests} requests, "
                  "0 dropped)")

            rollout, bad = _drive_rollout(
                harness, 3, {"scale": np.float32(9.0), "poison": True},
                args.requests, lock)
            if rollout.state != "rolled_back" or bad:
                print(f"FAIL bad canary: state={rollout.state} "
                      f"dropped={bad[:3]}")
                return 1
            for i in range(3):
                h = harness.handle(f"{spec.name}-rep{i}")
                if h.obj.version != 2:
                    print(f"FAIL {h.name} on v{h.obj.version} after "
                          "rollback (want the promoted v2)")
                    return 1
            if not rollout.incident_path:
                print("FAIL rollback captured no incident bundle")
                return 1
            load_bundle(rollout.incident_path)  # strict re-validation
            print(f"rolled back poisoned v3 to v2 on every replica "
                  f"({args.requests} requests, 0 dropped); bundle "
                  "re-validates")

            reg = harness.controller.rpc.telemetry.registry
            for counter, labels in (
                ("fleet_rollouts_total", dict(fleet=spec.name,
                                              outcome="promoted")),
                ("fleet_rollouts_total", dict(fleet=spec.name,
                                              outcome="rolled_back")),
                ("fleet_slo_breaches_total", dict(fleet=spec.name,
                                                  gate="error_rate")),
            ):
                if not (reg.value(counter, **labels) or 0) >= 1:
                    print(f"FAIL {counter}{labels} never incremented")
                    return 1
            kinds = {e["kind"]
                     for e in harness.controller.rpc.telemetry.flight
                     .events()}
            missing = {"fleet_spawn", "fleet_rollout",
                       "fleet_slo_breach"} - kinds
            if missing:
                print(f"FAIL flightrec events missing: {sorted(missing)}")
                return 1
            print(f"verified telemetry evidence in "
                  f"{time.monotonic() - t0:.2f}s")
            print("evidence: " + evidence(harness.controller.rpc.telemetry,
                                          "fleet_", "fleet_"))
            print("OK fleet rollout smoke")
            return 0
        finally:
            harness.close()


if __name__ == "__main__":
    sys.exit(main())
