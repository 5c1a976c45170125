"""Statestore restore smoke of the port: the durable-state round trip,
end to end; the twin of the reference's ``tools/statestore_smoke.py``.

One bounded pass on the host (the state is numpy; no device is used) over
the whole durability contract:

1. **Publish** — a three-member loopback cohort; the "leader" store
   bundles a model-sized state (content-hashed chunks, crash-atomic
   local write) and pushes it to both peers over the live
   ``StateStoreService`` offer/ingest/commit wire family.
2. **Host loss** — the leader's store directory is wiped (the failure a
   single local checkpoint cannot survive).
3. **Restore negotiation** — a fresh store on the same member runs the
   negotiation against the two surviving replicas (quorum 2), pulls the
   agreed version chunk-by-chunk with sha256 verification, and the
   restored state must be byte-identical to what was published.
4. **Evidence** — the ``statestore_*`` counter family and the
   ``ss_publish``/``ss_replicate``/``ss_restore`` flightrec events must
   all be present (and are printed): the smoke fails if the durability
   tier went dark in telemetry even when the data path still works.

Usage::

    python -m moolib_tpu_torch.tools.statestore_smoke [--mbytes 4] [--seed 7]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..rpc import Rpc
from ..statestore import StateStore


def evidence(telemetry, prefix: str, kinds: str) -> str:
    """The nonzero ``prefix*`` counters of ``telemetry``'s registry and
    the counts of its flight events whose kind starts with ``kinds``."""
    counters = {k: v["value"]
                for k, v in telemetry.registry.snapshot().items()
                if k.startswith(prefix) and v["type"] == "counter"
                and v["value"]}
    events: dict = {}
    for e in telemetry.flight.events():
        if e["kind"].startswith(kinds):
            events[e["kind"]] = events.get(e["kind"], 0) + 1
    return f"counters {counters} | flight events {events}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbytes", type=float, default=4.0,
                    help="state payload size (MB)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    rng = np.random.RandomState(args.seed)
    state = {
        "w": rng.uniform(-1, 1,
                         size=(int(args.mbytes * (1 << 20) // 4),)
                         ).astype(np.float32),
        "step": 42,
    }
    t0 = time.monotonic()
    rpcs = [Rpc(f"ss-smoke-{i}") for i in range(3)]
    td = tempfile.mkdtemp(prefix="ss-smoke-")
    stores = []
    try:
        for r in rpcs[1:]:
            r.listen("127.0.0.1:0")
        for i, r in enumerate(rpcs):
            stores.append(StateStore(os.path.join(td, f"s{i}"), r,
                                     name=f"s{i}"))
        for r in rpcs[1:]:
            rpcs[0].connect(r.debug_info()["listen"][0])
        peers = tuple(r.get_name() for r in rpcs[1:])

        acks = stores[0].publish(11, state, peers=peers)
        if not all(acks.values()):
            print(f"FAIL publish not fully acked: {acks}")
            return 1
        print(f"published v11 ({args.mbytes:g}MB) to {len(peers)} "
              f"replicas in {time.monotonic() - t0:.2f}s")

        # Host loss: the publisher's disk dies.
        stores[0].close()
        stores.pop(0)
        shutil.rmtree(os.path.join(td, "s0"))

        # Same-member restart restores from the surviving replicas.
        fresh = StateStore(os.path.join(td, "s0"), rpcs[0], name="s0r")
        stores.insert(0, fresh)
        restored = fresh.restore(peers, quorum=2)
        if restored is None:
            print("FAIL restore negotiation found nothing restorable")
            return 1
        v, s = restored
        if v != 11 or not np.array_equal(s["w"], state["w"]):
            print(f"FAIL restored v{v} does not match what was published")
            return 1
        if fresh.versions() != stores[1].versions():
            print("FAIL rejoiner did not become a verified holder: "
                  f"{fresh.versions()} vs {stores[1].versions()}")
            return 1

        reg = rpcs[0].telemetry.registry
        for counter in ("statestore_put_total", "statestore_restore_total"):
            if not (reg.value(counter) or 0) >= 1:
                print(f"FAIL {counter} never incremented")
                return 1
        kinds = {e["kind"] for e in rpcs[0].telemetry.flight.events()}
        missing = {"ss_publish", "ss_replicate", "ss_restore"} - kinds
        if missing:
            print(f"FAIL flightrec events missing: {sorted(missing)}")
            return 1
        print(f"restored v{v} from peer replicas + verified telemetry "
              f"evidence in {time.monotonic() - t0:.2f}s")
        print("evidence: "
              + evidence(rpcs[0].telemetry, "statestore_", "ss_"))
        print("OK statestore restore smoke")
        return 0
    finally:
        for st in stores:
            st.close()
        for r in rpcs:
            r.close()
        shutil.rmtree(td, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
