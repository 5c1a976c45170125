"""Seeded chaos scenarios of the port; the counterpart of
:mod:`moolib_tpu_torch.testing.scenarios`, holding its durable-state and fleet
scenarios and the harnesses they drive (``MiniCluster``, ``StateCohort``,
``FleetHarness``). The reference's wire, elastic, serving and env-tier
scenarios (``ServingFleet``, ``EnvFleet``, ``ChaosStepEnv`` and their
twelve scenarios) are still to port: ROADMAP.md queue A, item 10 (d).

Each scenario takes a seed, drives a live in-process cluster through a
:class:`~moolib_tpu_torch.testing.chaos.FaultPlan`, raises
``AssertionError`` with a descriptive message on any invariant violation,
and returns the plan's injected-event summary. Replaying a failure needs
only the seed. The fleet scenarios serve a numpy toy model through the
port's ``Replica``, which runs on the card unless ``device="cpu"`` is
given.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from typing import Any, Dict

import numpy as np

from ..rpc import Rpc
from ..rpc.broker import Broker
from ..rpc.group import Group
from .chaos import ChaosNet, FaultPlan, ResourceChaos, ResourceFaultPlan

__all__ = [
    "MiniCluster",
    "StateCohort",
    "scenario_statestore_host_loss",
    "scenario_statestore_disk_full",
    "scenario_statestore_bitflip",
    "FleetHarness",
    "scenario_fleet_controller_kill",
    "scenario_fleet_bad_canary",
    "scenario_fleet_role_crashloop",
    "SCENARIOS",
]


def _minicluster_entry(ref: "weakref.ref[MiniCluster]") -> None:
    """Module-level broker-pump target holding only a weakref between
    ticks, so an abandoned cluster can still be GC'd (lifelint
    thread-pins-self)."""
    while True:
        self = ref()
        if self is None or self._stop.is_set():
            return
        for b in list(self.brokers):
            b.update()
        del self  # do not pin across the sleep
        time.sleep(0.05)


class MiniCluster:
    """Broker + member peers, all in-process over loopback. With
    ``standby=True`` a second (idle) broker peer is also started and
    every spawned Group gets a broker-candidate list, so killing the
    primary exercises the member-driven failover + gossip-adoption path
    (see Broker epoch adoption)."""

    def __init__(self, standby: bool = False,
                 failover_after: float = 1.5):
        self.broker_rpc = Rpc("broker")
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = Broker(self.broker_rpc)
        self.standby_rpc = None
        self.standby = None
        self.standby_addr = None
        self.failover_after = failover_after
        if standby:
            self.standby_rpc = Rpc("broker2")
            self.standby_rpc.listen("127.0.0.1:0")
            self.standby_addr = self.standby_rpc.debug_info()["listen"][0]
            self.standby = Broker(self.standby_rpc, settle_s=1.5)
        self.brokers = [b for b in (self.broker, self.standby)
                        if b is not None]
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=_minicluster_entry, args=(weakref.ref(self),), daemon=True
        )
        self._thread.start()
        self.clients = []

    def spawn(self, name: str, group: str = "g", timeout: float = 4.0):
        rpc = Rpc(name)
        rpc.listen("127.0.0.1:0")
        rpc.connect(self.addr)
        g = Group(rpc, broker_name="broker", group_name=group,
                  timeout=timeout)
        if self.standby_addr is not None:
            rpc.connect(self.standby_addr)
            g.set_broker_candidates(["broker", "broker2"],
                                    failover_after=self.failover_after)
        self.clients.append((rpc, g))
        return rpc, g

    def kill_broker(self):
        """Kill the primary broker process (its Rpc dies; the standby —
        if any — keeps running and takes over when members fail over)."""
        if self.broker in self.brokers:
            self.brokers.remove(self.broker)
        self.broker_rpc.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5)
        for rpc, g in self.clients:
            g.close()
            rpc.close()
        self.broker.close()
        if self.standby is not None:
            self.standby.close()
        self.broker_rpc.close()
        if self.standby_rpc is not None:
            self.standby_rpc.close()


def _pump_accs(accs, until, timeout, what, each=None):
    """Drive ``update()`` on every accumulator until ``until()`` holds —
    the one canonical poll loop for accumulator scenarios. ``each(acc)``
    runs after each accumulator's update (apply results, contribute
    gradients, checkpoint, ...)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for a in accs:
            a.update()
            if each is not None:
                each(a)
        if until():
            return
        time.sleep(0.005)
    raise AssertionError(
        f"{what}: condition never reached; stats: "
        + str([a.get_gradient_stats() for a in accs])
    )


# -- durable state (statestore) ----------------------------------------------


class StateCohort:
    """MiniCluster + N Accumulator members, each with a
    :class:`~moolib_tpu_torch.statestore.StateStore` and a
    :class:`~moolib_tpu_torch.statestore.Replicator` attached to its
    durability hook — the canonical cohort for the statestore chaos
    scenarios. Training is the same seeded SGD-on-a-quadratic the
    learner-restart scenario uses, so the loss trajectory is exactly
    computable and any torn/stale restore shows up as a trajectory
    miss."""

    def __init__(self, seed: int, n: int = 3, *, followers: int = 2,
                 chunk_bytes: int = 256, keep_versions: int = 64,
                 tmpdir: "str | None" = None):
        import tempfile

        rng = np.random.RandomState(seed)
        self.target = rng.uniform(-1.0, 1.0, size=(4,)).astype(np.float32)
        self.lr = np.float32(0.2)
        self.followers = followers
        self.chunk_bytes = chunk_bytes
        self.keep_versions = keep_versions
        self.cluster = MiniCluster()
        self.td = tempfile.TemporaryDirectory(dir=tmpdir)
        self.state: Dict[str, np.ndarray] = {}
        self.accs: Dict[str, Any] = {}
        self.stores: Dict[str, Any] = {}
        self.reps: Dict[str, Any] = {}
        for i in range(n):
            self.add_member(f"p{i}")

    def root(self, name: str) -> str:
        import os

        return os.path.join(self.td.name, f"{name}-store")

    def add_member(self, name: str, *, restore_from=(), quorum: int = 2):
        """Spawn a member. With ``restore_from`` it first runs the
        restore negotiation against those peers (the wiped-rejoiner
        path) and seeds its model version from the restored bundle so a
        durable-state holder competes in leader election like a
        checkpoint holder would. Returns the restored version (or
        None)."""
        from ..parallel import Accumulator
        from ..statestore import Replicator, StateStore

        rpc, g = self.cluster.spawn(name)
        store = StateStore(self.root(name), rpc,
                           chunk_bytes=self.chunk_bytes,
                           keep_versions=self.keep_versions, name=name)
        self.state.setdefault(name, np.zeros(4, np.float32))
        restored_version = None
        if restore_from:
            restored = store.restore(tuple(restore_from), quorum=quorum,
                                     timeout=15.0)
            assert restored is not None, (
                f"{name}: restore negotiation with {restore_from} found "
                "nothing restorable"
            )
            restored_version, s = restored
            self.state[name] = np.asarray(s["w"], np.float32)

        def get_state(n=name):
            return {"w": self.state[n]}

        def set_state(s, n=name):
            self.state[n] = np.asarray(s["w"], np.float32)

        acc = Accumulator(rpc, group=g, virtual_batch_size=2,
                          get_state=get_state, set_state=set_state)
        if restored_version is not None:
            acc.set_model_version(restored_version)
        rep = Replicator(store, acc,
                         state_fn=lambda n=name: {"w": self.state[n]},
                         followers=self.followers)
        self.accs[name] = acc
        self.stores[name] = store
        self.reps[name] = rep
        return restored_version

    def traj(self, version: int) -> np.ndarray:
        """The exact params every member holds after ``version``
        applied updates (all members contribute the same gradient, so
        the cohort walks one deterministic trajectory)."""
        w = np.zeros(4, np.float32)
        for _ in range(version):
            g = np.asarray(2.0 * (w - self.target), np.float32)
            mean = np.asarray((g + g + g) / 3, np.float32)
            w = np.asarray(w - self.lr * mean, np.float32)
        return w

    def drive(self, until, timeout: float, what: str):
        """Pump all live members through the apply/contribute loop."""
        def step(a):
            name = a.rpc.get_name()
            if a.has_gradients():
                mean, _count = a.result_gradients()
                self.state[name] = np.asarray(
                    self.state[name] - self.lr * mean["w"], np.float32
                )
                a.zero_gradients()  # fires the durability hook
            elif a.wants_gradients():
                a.reduce_gradients(
                    {"w": 2.0 * (self.state[name] - self.target)},
                    batch_size=1,
                )

        _pump_accs(list(self.accs.values()), until, timeout, what,
                   each=step)

    def kill_member(self, name: str, net, *, wipe: bool = False):
        """SIGKILL-equivalent death; with ``wipe`` the member's store
        directory dies with the host (the host-loss failure class)."""
        import shutil

        acc = self.accs.pop(name)
        self.reps.pop(name).close()
        store = self.stores.pop(name)
        net.kill_conns(acc.rpc)
        acc.rpc.close()
        store.close()
        if wipe:
            shutil.rmtree(self.root(name), ignore_errors=True)
        return acc

    def replicated_on(self, holders, v_min: int = 1):
        """Newest version advertised with one hash by ALL ``holders``
        (>= ``v_min``), or None."""
        ads = [dict(self.stores[h].versions()) for h in holders]
        common = [v for v in ads[0]
                  if all(v in a and a[v] == ads[0][v] for a in ads[1:])]
        newest = max(common, default=None)
        return newest if newest is not None and newest >= v_min else None

    def close(self):
        for rep in self.reps.values():
            rep.close()
        for store in self.stores.values():
            store.close()
        self.cluster.close()
        self.td.cleanup()


def scenario_statestore_host_loss(seed: int, rounds: int = 12,
                                  tmpdir: "str | None" = None
                                  ) -> Dict[str, int]:
    """Host loss: SIGKILL a member AND wipe its checkpoint/statestore
    directory — the one failure a local-checkpoint restart cannot
    survive. The leader's Replicator has been streaming committed
    versions to follower replicas (asynchronously, off the training
    thread), so the same-name restart with an EMPTY disk runs the
    restore negotiation, agrees with the survivors on the newest
    quorum-verified version, pulls its chunks from a peer replica, and
    rejoins — and its loss trajectory matches the undisturbed control
    run (the restored state *is* a point on the exact deterministic
    trajectory, and resync brings it to the survivors' current step).
    The whole sequence — publish, replicate, conn kill, restore — is
    visible in ONE merged flightrec timeline across all members
    including the dead one's black box. The only injection is the
    scripted conn kill, so the event log is identical for identical
    seeds."""
    from ..flightrec.bundle import snapshot_bundle
    from ..flightrec.merge import merge_bundles

    cohort = StateCohort(seed, 3, followers=2, tmpdir=tmpdir)
    plan = FaultPlan(seed)
    net = None
    victim_telemetry = None
    try:
        net = ChaosNet(plan, [a.rpc for a in cohort.accs.values()]
                       + [cohort.cluster.broker_rpc])
        kill_at = max(2, rounds // 3)
        # Train until the version is durable on BOTH survivors-to-be:
        # quorum-2 negotiation after the wipe needs two agreeing
        # holders (the victim's own replica dies with its disk).
        cohort.drive(
            lambda: all(a.model_version >= kill_at
                        for a in cohort.accs.values())
            and cohort.replicated_on(["p0", "p1"], 1) is not None,
            40, "pre-kill training + replication",
        )
        bar = float(((cohort.traj(rounds) - cohort.target) ** 2).mean())

        victim_telemetry = cohort.accs["p2"].rpc.telemetry
        cohort.kill_member("p2", net, wipe=True)
        import os

        assert not os.path.exists(cohort.root("p2")), "wipe failed"

        # Same-name restart from NOTHING but the peer replicas.
        restored_v = cohort.add_member("p2", restore_from=("p0", "p1"),
                                       quorum=2)
        assert restored_v is not None and restored_v >= 1
        # Integrity: the pulled params are byte-identical to the copy
        # the surviving replica holds for that version (per-chunk
        # sha256 against the quorum-agreed manifest makes this exact,
        # not approximate).
        np.testing.assert_array_equal(
            cohort.state["p2"],
            np.asarray(cohort.stores["p0"].load(restored_v)["w"],
                       np.float32),
            err_msg=f"restored v{restored_v} differs from the replica's "
                    "copy",
        )

        cohort.drive(
            lambda: all(
                a.connected() and a._synced
                and len(a.group.members) == 3
                for a in cohort.accs.values()
            ), 30, "restart rejoin",
        )
        cohort.drive(
            lambda: all(a.model_version >= rounds
                        for a in cohort.accs.values())
            and all(not a.has_gradients() for a in cohort.accs.values()),
            30, "post-restore training",
        )
        # Loss continuity vs the undisturbed control run.
        for name, a in cohort.accs.items():
            w = cohort.state[name]
            loss = float(((w - cohort.target) ** 2).mean())
            assert loss <= bar * 1.05 + 1e-7, (
                f"{name} missed the control loss bar: {loss} > {bar}"
            )
        ws = list(cohort.state[n] for n in cohort.accs)
        for w in ws[1:]:
            np.testing.assert_allclose(w, ws[0], rtol=1e-5, atol=1e-6)

        # ONE merged flightrec timeline shows the whole sequence — the
        # dead member's black box included (post-mortem snapshot).
        bundles = {
            name: snapshot_bundle(a.rpc.telemetry)
            for name, a in cohort.accs.items()
        }
        bundles["p2-dead"] = snapshot_bundle(victim_telemetry)
        timeline, _meta = merge_bundles(bundles)
        kinds = [r.get("kind") for r in timeline if r["type"] == "event"]
        for want in ("ss_publish", "ss_replicate", "ss_restore", "chaos"):
            assert want in kinds, (
                f"{want} missing from the merged timeline: "
                f"{sorted(set(kinds))}"
            )
        restores = [r for r in timeline if r["type"] == "event"
                    and r.get("kind") == "ss_restore"]
        kill_marks = [
            i for i, r in enumerate(timeline)
            if r["type"] == "event" and r.get("kind") == "chaos"
            and r["fields"].get("kind") == "conn_kill"
        ]
        assert restores and kill_marks, (restores, kill_marks)
        assert restores[-1]["fields"]["version"] == restored_v
        assert timeline.index(restores[-1]) > kill_marks[0], (
            "the restore must appear after the kill on the merged "
            "timeline"
        )

        assert [e.kind for e in plan.events] == ["conn_kill"], (
            f"unexpected injected-event log: {plan.events}"
        )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        if net is not None:
            net.detach_all()
        cohort.close()


def scenario_statestore_disk_full(seed: int,
                                  tmpdir: "str | None" = None
                                  ) -> Dict[str, int]:
    """Disk full mid-checkpoint on the leader: an injected ENOSPC lands
    in the middle of a bundle write (first chunk succeeds, manifest
    fails). The failure is TYPED, counted
    (``statestore_write_failures_total``) and flight-recorded
    (``ss_write_failure``); crash-atomic staging leaves no torn or
    half-GC'd bundle (strict re-validation of every surviving version
    passes and no staging leftovers remain); the cohort KEEPS TRAINING;
    and the durability role moves — the degraded leader widens its
    follower set, so new versions become durable on replicas its own
    disk never held. ENOSPC fire counts are cadence-dependent (like the
    straggler scenario's delays), so this asserts invariants plus
    decision-level telemetry consistency rather than an exact log."""
    import os

    cohort = StateCohort(seed, 3, followers=1, tmpdir=tmpdir)
    rplan = ResourceFaultPlan(seed)
    try:
        # Leadership is an election outcome, not a constant: startup
        # churn (a member joining the broker late) can crown any name.
        # Derive the leader and its sorted-ring followers (the
        # Replicator's deterministic placement) once a leader's version
        # has actually replicated to its first follower.
        def ring_after(name):
            names = sorted(cohort.accs)
            i = names.index(name)
            return names[i + 1:] + names[:i]

        def sole_leader():
            leaders = [n for n, a in cohort.accs.items()
                       if a.is_leader()]
            return leaders[0] if len(leaders) == 1 else None

        def baseline_replicated():
            ln = sole_leader()
            return (ln is not None
                    and cohort.replicated_on([ln, ring_after(ln)[0]], 1)
                    is not None)

        cohort.drive(baseline_replicated, 40,
                     "baseline replication (leader + 1 follower)")
        leader_name = sole_leader()
        f1, f2 = ring_after(leader_name)
        leader = cohort.accs[leader_name]
        store = cohort.stores[leader_name]
        baseline = store.latest()
        assert baseline is not None
        if max(a.get_gradient_stats()["elections"]
               for a in cohort.accs.values()) == 1:
            # No leadership churn: with followers=1 the second ring
            # follower must hold nothing until the durability role
            # moves. (A transient earlier leader may legitimately have
            # pushed a version elsewhere, so the assert is scoped to
            # the churn-free common case.)
            assert not dict(cohort.stores[f2].versions()), (
                "with followers=1 the second follower must hold "
                "nothing until the durability role moves"
            )
        v_before = leader.model_version

        # Disk fills mid-bundle: the first staged write of each bundle
        # succeeds, everything after fails — and stays failing until
        # the chaos context exits (a full disk does not heal itself).
        rplan.enospc("v*/*", op="write", after=1)
        reg = leader.rpc.telemetry.registry
        with ResourceChaos(rplan, root=store.root):
            cohort.drive(
                lambda: store.degraded
                and (reg.value("statestore_write_failures_total",
                               op="write") or 0) >= 1
                and cohort.replicated_on([f1, f2], baseline + 1)
                is not None,
                40, "degraded leader hands durability to both followers",
            )
            # The cohort kept training THROUGH the full disk.
            assert leader.model_version >= v_before + 1
            handed = cohort.replicated_on([f1, f2], baseline + 1)

        # Typed + flight-recorded: the black box names the seam.
        ev = [e for e in leader.rpc.telemetry.flight.events()
              if e["kind"] == "ss_write_failure"]
        assert ev and ev[-1]["fields"]["op"] == "write", ev
        # The replicator's ack map records the failed local write the
        # way a caller of put() would see it typed (WriteFailed).
        from ..statestore import LOCAL, Replicator

        # Quiesce the leader's replicator before auditing its disk: the
        # worker may have a (now healthy) publish mid-stage, and a live
        # ``.stage-*`` dir or a fresh post-chaos commit is normal
        # operation, not a torn-bundle leak. close() joins the worker,
        # so after it the directory is still.
        rep = cohort.reps[leader_name]
        rep.close()
        failed_acks = [v for v, acks in rep.published.items()
                       if acks.get(LOCAL) is False]
        assert failed_acks, "no publish recorded the local write failure"

        # No torn bundle, no half-GC: every surviving version on the
        # leader's disk re-validates strictly, nothing but committed
        # version dirs remains, and nothing from a FAILED write landed
        # locally (an injected-window bundle either committed completely
        # before its version failed — impossible, versions are immutable
        # — or left no trace).
        survivors = store.verify_all()
        assert survivors, "leader lost its pre-fault versions"
        assert not set(survivors) & set(failed_acks), (
            survivors, failed_acks,
        )
        stray = [n for n in os.listdir(store.root)
                 if not (n.startswith("v") and n[1:].isdigit())]
        assert not stray, f"staging/GC leftovers after ENOSPC: {stray}"
        # ... while the handed-off version IS durable on both followers.
        assert handed is not None and handed > baseline
        assert cohort.stores[f2].latest() is not None

        # Disk freed: re-attach a replicator (the quiesce above was
        # test-side); the next local write succeeds and clears degraded.
        cohort.reps[leader_name] = Replicator(
            store, leader,
            state_fn=lambda: {"w": cohort.state[leader_name]},
            followers=1,
        )
        recovered_from = store.latest() or 0
        cohort.drive(
            lambda: not store.degraded
            and (store.latest() or 0) > recovered_from,
            30, "store recovers once the disk frees",
        )

        kinds = {e.kind for e in rplan.events}
        assert kinds == {"enospc"}, kinds
        rplan.verify_telemetry()  # registry counters == injected log
        return rplan.summary()
    finally:
        cohort.close()


def scenario_statestore_bitflip(seed: int,
                                tmpdir: "str | None" = None
                                ) -> Dict[str, int]:
    """A bit flips on one replica's disk AFTER it verified (and
    advertised) a version: restore negotiation still agrees on the
    version (both holders advertise the same manifest hash), the puller
    detects the corrupt chunk by its sha256, counts the reject, and
    refetches that chunk from the other holder — the restore succeeds
    and the rejoiner becomes a verified holder itself. The corruption
    target (holder + chunk + byte) is drawn from the seed, so the run
    is replay-identical; no wire faults are injected (empty event
    log)."""
    import os
    import tempfile

    from ..statestore import StateStore
    from ..statestore.bundle import read_manifest

    plan = ResourceFaultPlan(seed)
    rng = np.random.RandomState(seed)
    state = {"w": rng.uniform(-1.0, 1.0, size=(256,)).astype(np.float64)}
    a = Rpc(f"ssa{seed}")
    b = Rpc(f"ssb{seed}")
    c = Rpc(f"ssc{seed}")
    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        store_a = store_b = store_c = None
        try:
            a.listen("127.0.0.1:0")
            b.listen("127.0.0.1:0")
            store_a = StateStore(os.path.join(td, "a"), a, chunk_bytes=256,
                                 name="ssa")
            store_b = StateStore(os.path.join(td, "b"), b, chunk_bytes=256,
                                 name="ssb")
            a.connect(b.debug_info()["listen"][0])
            acks = store_a.publish(7, state, peers=(b.get_name(),))
            assert acks == {"<local>": True, b.get_name(): True}, acks
            # Both holders verify + advertise (the verification cache is
            # what makes post-verification rot the interesting case).
            assert len(store_a.versions()) == 1
            assert store_a.versions() == store_b.versions()

            n_chunks = len(read_manifest(store_a.root, 7)["chunks"])
            assert n_chunks >= 3, f"need a multi-chunk bundle: {n_chunks}"
            # Seeded corruption target. The puller assigns chunk i of
            # pass 0 to holders[i % 2] with holders ordered (ssa, ssb),
            # so corrupting chunk k on THAT holder guarantees the first
            # fetch hits the bad copy and the refetch path runs.
            k = plan.pick(n_chunks)
            corrupt_store = store_a if k % 2 == 0 else store_b
            path = os.path.join(corrupt_store.root, f"v{7:012d}",
                                f"c{k:06d}.bin")
            size = os.path.getsize(path)
            off = plan.pick(size)
            with open(path, "r+b") as f:
                f.seek(off)
                byte = f.read(1)
                f.seek(off)
                f.write(bytes([byte[0] ^ 0x40]))

            c.connect(a.debug_info()["listen"][0])
            c.connect(b.debug_info()["listen"][0])
            store_c = StateStore(os.path.join(td, "c"), c, chunk_bytes=256,
                                 name="ssc")
            restored = store_c.restore((a.get_name(), b.get_name()),
                                       quorum=2)
            assert restored is not None
            v, s = restored
            assert v == 7
            np.testing.assert_array_equal(s["w"], state["w"])

            creg = c.telemetry.registry
            assert creg.value("statestore_chunk_rejects_total") == 1, (
                "exactly one chunk must be hash-rejected"
            )
            assert creg.value("statestore_restore_total") == 1
            ev = [e for e in c.telemetry.flight.events()
                  if e["kind"] == "ss_restore"]
            assert ev and ev[-1]["fields"]["refetched"] == 1, ev
            # The rejoiner persisted what it pulled: it is a holder now.
            assert dict(store_c.versions()) == dict(store_b.versions())

            # Replay determinism: no injected faults, and the seeded
            # corruption target re-draws identically.
            assert plan.events == [], plan.events
            replay = ResourceFaultPlan(seed)
            assert (replay.pick(n_chunks), replay.pick(size)) == (k, off)
            plan.verify_telemetry()  # trivially: nothing injected
            return plan.summary()
        finally:
            for st in (store_a, store_b, store_c):
                if st is not None:
                    st.close()
            a.close()
            b.close()
            c.close()


# -- serving tier ------------------------------------------------------------


# -- fleet tier --------------------------------------------------------------


def _run_load(router, n_requests: int, concurrency: int,
              budget_s: float, outcomes: list, lock: threading.Lock,
              on_count=None):
    """Drive ``n_requests`` through ``router`` from ``concurrency``
    threads; every outcome (ok latency or explicit error) is recorded —
    a request that neither returns nor raises within budget+slack would
    hang its worker and fail the join assertion in the scenario."""
    from ..serving import error_kind

    per = [n_requests // concurrency] * concurrency
    for i in range(n_requests % concurrency):
        per[i] += 1
    counter = {"n": 0}

    def worker(k):
        x = np.ones(4, np.float32)
        for _ in range(per[k]):
            t0 = time.monotonic()
            try:
                out = router.infer(x, budget_s=budget_s)
                rec = ("ok", time.monotonic() - t0, float(out[0]))
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except Exception as e:
                rec = ("err", time.monotonic() - t0,
                       f"{error_kind(e)}: {e}")
            with lock:
                outcomes.append(rec)
                counter["n"] += 1
                n = counter["n"]
            if on_count is not None:
                on_count(n)

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(concurrency)]
    for t in threads:
        t.start()
    return threads


def _p99(latencies):
    if not latencies:
        return None
    vals = sorted(latencies)
    return vals[min(int(0.99 * len(vals)), len(vals) - 1)]



def _await(cond, timeout, what, lock=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (cond() if lock is None else _locked_cond(cond, lock)):
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _locked_cond(cond, lock):
    with lock:
        return cond()


class FleetHarness:
    """Spec-driven fleet-in-a-box: one controller (plus an optional
    standby sharing the cohort), and every role the spec names —
    brokers, learners, env workers, replicas, routers — all in-process
    over loopback on OS-assigned ports. Scales the MiniCluster idea to
    fleet shape and is the substrate the fleet chaos scenarios drive.
    ``device`` is the replicas' (the card unless ``"cpu"``)."""

    def __init__(self, spec=None, *, standby: bool = True, seed: int = 0,
                 model=None, params=None, version: int = 1,
                 failover_after_s: float = 0.5, incident_dir=None,
                 device=None):
        from ..fleet import Controller, FleetSpec

        self.spec = (spec if spec is not None
                     else FleetSpec.small(replicas=3, routers=1))
        self.controller = Controller(
            self.spec, name="ctl0", model=model, params=params,
            version=version, seed=seed, incident_dir=incident_dir,
            device=device,
        )
        self.controller.materialize()
        self.cohort = self.controller.cohort
        self.standby = None
        if standby:
            self.standby = Controller(
                self.spec, cohort=self.cohort, name="ctl1", standby=True,
                model=model, params=params, version=version,
                seed=seed + 1, failover_after_s=failover_after_s,
                incident_dir=incident_dir, device=device,
            )
        self._closed = False

    @property
    def router(self):
        """The fleet's first live router object (reads the shared
        cohort, so it survives a controller kill)."""
        return self.controller.router()

    def handle(self, name: str):
        with self.cohort.lock:
            return self.cohort.roles[name]

    def role_rpcs(self):
        with self.cohort.lock:
            return [h.rpc for h in self.cohort.roles.values()
                    if h.rpc is not None]

    def all_rpcs(self):
        rpcs = [self.controller.rpc]
        if self.standby is not None:
            rpcs.append(self.standby.rpc)
        return rpcs + self.role_rpcs()

    def wait_routable(self, n: int, timeout: float = 15.0):
        router = self.router
        assert router is not None, "fleet spec has no router"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(router.routable()) >= n:
                return
            time.sleep(0.02)
        raise AssertionError(
            f"fleet never reached {n} routable replicas: "
            + str(router.stats())
        )

    def close(self):
        """Idempotent full teardown: controllers first (their threads
        reference the roles), then every role via the cohort."""
        if self._closed:
            return
        self._closed = True
        if self.standby is not None:
            self.standby.close()
        self.controller.close()
        self.cohort.close()


def _fleet_model(params, x):
    """The fleet scenarios' model: a numpy scale with a poison switch,
    so a "bad build" is just a params publish away."""
    if params.get("poison"):
        raise RuntimeError("poisoned canary build")
    return x * params["scale"]


def scenario_fleet_controller_kill(seed: int, *, requests: int = 240,
                                   post_requests: int = 120,
                                   concurrency: int = 4,
                                   budget_s: float = 8.0,
                                   device=None) -> Dict[str, int]:
    """SIGKILL the primary controller mid-rollout (mid-settle): the
    standby adopts behind the epoch fence once the cohort heartbeat goes
    stale, resumes the in-flight canary with a fresh settle window, and
    the healthy canary completes (promoted — never orphaned). No
    accepted request is dropped across the handoff, a second adopt by
    the winner is a fenced no-op, and the injected-event log is
    identical for identical seeds (the kill is the only injection)."""
    from ..fleet import FleetSpec

    spec = FleetSpec.small(replicas=3, routers=1, settle_s=2.0)
    harness = FleetHarness(spec, standby=True, seed=seed,
                           model=_fleet_model,
                           params={"scale": np.float32(2.0)}, device=device)
    plan = FaultPlan(seed)
    net = ChaosNet(plan, harness.all_rpcs())
    lock = threading.Lock()
    try:
        harness.wait_routable(3)
        primary, standby = harness.controller, harness.standby
        primary.publish_model({"scale": np.float32(3.0)}, 2)
        outcomes: list = []
        threads = _run_load(harness.router, requests, concurrency,
                            budget_s, outcomes, lock)
        primary.start_rollout(version=2, wait=False)
        _await(lambda: (harness.cohort.rollout or {}).get("state")
               == "settling", 10.0, "rollout never reached settling",
               lock=harness.cohort.lock)
        # The injected SIGKILL: connections die abruptly, the
        # supervisor stops without any cleanup — the heartbeat stales.
        net.kill_conns(primary.rpc)
        primary.kill()
        _await(lambda: harness.cohort.epoch == 2
               and harness.cohort.controller == "ctl1", 15.0,
               "standby never adopted the fleet",
               lock=harness.cohort.lock)
        _await(lambda: (harness.cohort.rollout or {}).get("state")
               in ("promoted", "rolled_back"), 15.0,
               "resumed rollout never reached a terminal state",
               lock=harness.cohort.lock)
        with harness.cohort.lock:
            state = harness.cohort.rollout["state"]
            version = harness.cohort.current_version
        assert state == "promoted", (
            f"a healthy canary must promote after adoption, got {state}"
        )
        assert version == 2, version
        # The fence: re-adopting the epoch you hold is a no-op (it can
        # never double-spawn), and the adopter is the fenced controller.
        again = standby.adopt()
        assert again == {"already": True, "epoch": 2}, again
        assert standby.status()["fenced"], "adopter is not fenced"
        # The canary slice was cleared by the promote.
        members, weight = harness.router.canary()
        assert members == frozenset() and weight == 0.0, (members, weight)
        # Every replica ends on the new version.
        for h in (harness.handle(f"{spec.name}-rep{i}") for i in range(3)):
            assert h.obj is not None and h.obj.version == 2, h.summary()
        for t in threads:
            t.join(timeout=requests * (budget_s + 5))
            assert not t.is_alive(), (
                "load worker hung across the controller handoff"
            )
        bad = [r for r in outcomes if r[0] != "ok"]
        assert not bad, (
            f"accepted requests dropped across controller loss: {bad[:3]}"
        )
        # Service continues under the adopted controller too.
        post: list = []
        for t in _run_load(harness.router, post_requests, concurrency,
                           budget_s, post, lock):
            t.join(timeout=60)
            assert not t.is_alive(), "post-adoption load worker hung"
        assert all(k == "ok" for k, _lat, _v in post), (
            f"post-adoption failures: "
            f"{[r for r in post if r[0] != 'ok'][:3]}"
        )
        # Replay determinism: the kill is the only injection.
        assert [e.kind for e in plan.events] == ["conn_kill"], (
            f"unexpected injected-event log: {plan.events}"
        )
        plan.verify_telemetry()
        return plan.summary()
    finally:
        net.detach_all()
        harness.close()


def scenario_fleet_bad_canary(seed: int, *, requests: int = 300,
                              concurrency: int = 4,
                              budget_s: float = 8.0,
                              device=None) -> Dict[str, int]:
    """Roll out a poisoned build under load: the canary slice's error
    rate breaches the SLO gate, auto-rollback fires within the settle
    window (not at its end), zero accepted requests are dropped (canary
    victims fail fast and are retried on the stable slice), every
    replica is restored to the exact prior version, and the incident
    bundle re-validates from disk with the breach and the rollback
    transition on one merged timeline."""
    import tempfile

    from ..fleet import FleetSpec
    from ..flightrec import load_bundle, merge_bundles

    spec = FleetSpec.small(replicas=3, routers=1, settle_s=3.0)
    with tempfile.TemporaryDirectory() as tmp:
        harness = FleetHarness(spec, standby=False, seed=seed,
                               model=_fleet_model,
                               params={"scale": np.float32(2.0)},
                               incident_dir=tmp, device=device)
        plan = FaultPlan(seed)
        net = ChaosNet(plan, harness.all_rpcs())
        lock = threading.Lock()
        try:
            harness.wait_routable(3)
            ctl = harness.controller
            ctl.publish_model({"scale": np.float32(9.0), "poison": True},
                              2)
            rollout = ctl.start_rollout(version=2, wait=False)
            _await(lambda: rollout.state == "settling", 10.0,
                   "rollout never reached settling")
            t_settling = time.monotonic()
            outcomes: list = []
            threads = _run_load(harness.router, requests, concurrency,
                                budget_s, outcomes, lock)
            _await(lambda: rollout.state in ("promoted", "rolled_back"),
                   spec.rollout.settle_s + 10.0,
                   "rollout never reached a terminal state")
            took = time.monotonic() - t_settling
            assert rollout.state == "rolled_back", rollout.state
            assert took < spec.rollout.settle_s, (
                f"rollback took {took:.2f}s — the gate should breach "
                f"within the {spec.rollout.settle_s}s settle window, "
                "not at its close"
            )
            assert rollout.breach and rollout.breach["gate"] == (
                "error_rate"), rollout.breach
            for t in threads:
                t.join(timeout=requests * (budget_s + 5))
                assert not t.is_alive(), "load worker hung across rollback"
            assert len(outcomes) == requests, len(outcomes)
            bad = [r for r in outcomes if r[0] != "ok"]
            assert not bad, (
                f"accepted requests dropped across the bad canary: "
                f"{bad[:3]}"
            )
            # Exact prior version restored on EVERY replica.
            for h in (harness.handle(f"{spec.name}-rep{i}")
                      for i in range(3)):
                assert h.obj is not None and h.obj.version == 1, (
                    h.summary()
                )
            members, weight = harness.router.canary()
            assert members == frozenset(), (members, weight)
            reg = ctl.rpc.telemetry.registry
            assert reg.value("fleet_rollouts_total", fleet=spec.name,
                             outcome="rolled_back") == 1
            assert (reg.value("fleet_slo_breaches_total",
                              fleet=spec.name, gate="error_rate") or 0) >= 1
            # The incident bundle re-validates from disk, and its merged
            # timeline shows the breach beside the rollback transition.
            assert rollout.incident_path, "rollback wrote no bundle"
            bundle = load_bundle(rollout.incident_path)
            timeline, _meta = merge_bundles({"ctl": bundle})
            events = [r for r in timeline if r["type"] == "event"]
            kinds = [r["kind"] for r in events]
            assert "fleet_slo_breach" in kinds, kinds
            rolled = [i for i, r in enumerate(events)
                      if r["kind"] == "fleet_rollout"
                      and r["fields"].get("state") == "rolled_back"]
            assert rolled, kinds
            assert kinds.index("fleet_slo_breach") <= rolled[0], (
                "breach does not precede the rollback on the timeline"
            )
            # No injections: the poison rides a params publish, so the
            # replayable injected-event log is deterministically empty.
            assert not plan.events, plan.events
            plan.verify_telemetry()
            return plan.summary()
        finally:
            net.detach_all()
            harness.close()


def scenario_fleet_role_crashloop(seed: int, *, requests: int = 120,
                                  concurrency: int = 4,
                                  budget_s: float = 8.0,
                                  device=None) -> Dict[str, int]:
    """Crash-loop one replica past its restart budget: every death
    inside the budget is respawned under jittered backoff
    (``fleet_restart``), the death past ``restart_limit`` degrades it to
    permanently down (``fleet_down``), routers forget the corpse and
    traffic continues on the survivors with zero dropped requests. The
    injected log is exactly ``restart_limit + 1`` scripted conn kills."""
    import dataclasses

    from ..fleet import FleetSpec, SupervisionSpec

    spec = dataclasses.replace(
        FleetSpec.small(replicas=3, routers=1),
        supervision=SupervisionSpec(
            probe_interval_s=0.1, probe_timeout_s=0.5, probe_misses=2,
            restart_limit=2, restart_window_s=60.0,
            backoff_base_s=0.02, backoff_cap_s=0.2,
        ),
    )
    harness = FleetHarness(spec, standby=False, seed=seed, device=device)
    plan = FaultPlan(seed)
    net = ChaosNet(plan, harness.all_rpcs())
    lock = threading.Lock()
    victim = f"{spec.name}-rep0"
    kills = spec.supervision.restart_limit + 1
    try:
        harness.wait_routable(3)
        h = harness.handle(victim)
        for k in range(kills):
            want_spawns = k + 1
            _await(lambda: h.status == "up" and h.spawns == want_spawns
                   and h.rpc is not None, 15.0,
                   f"victim never reached spawn {want_spawns}",
                   lock=harness.cohort.lock)
            rpc = h.rpc
            net.attach(rpc)
            net.kill_conns(rpc)
            rpc.close()
            _await(lambda: h.status != "up" or h.spawns > want_spawns,
                   15.0, f"death {k + 1} was never detected",
                   lock=harness.cohort.lock)
        _await(lambda: h.status == "down", 15.0,
               "victim was never degraded to permanently down",
               lock=harness.cohort.lock)
        # Routers route around the corpse.
        _await(lambda: victim not in harness.router.routable(), 10.0,
               "router still routes to the permanently-down replica")
        outcomes: list = []
        for t in _run_load(harness.router, requests, concurrency,
                           budget_s, outcomes, lock):
            t.join(timeout=requests * (budget_s + 5))
            assert not t.is_alive(), "load worker hung after crash-loop"
        bad = [r for r in outcomes if r[0] != "ok"]
        assert not bad, (
            f"requests dropped after the fleet routed around the "
            f"corpse: {bad[:3]}"
        )
        reg = harness.controller.rpc.telemetry.registry
        assert reg.value("fleet_restarts_total", fleet=spec.name) == (
            spec.supervision.restart_limit)
        assert reg.value("fleet_role_down_total", fleet=spec.name) == 1
        # Replay determinism: exactly the scripted kills, nothing else.
        assert [e.kind for e in plan.events] == ["conn_kill"] * kills, (
            f"unexpected injected-event log: {plan.events}"
        )
        plan.verify_telemetry()
        return plan.summary()
    finally:
        net.detach_all()
        harness.close()


SCENARIOS = {
    "statestore_host_loss": scenario_statestore_host_loss,
    "statestore_disk_full": scenario_statestore_disk_full,
    "statestore_bitflip": scenario_statestore_bitflip,
    "fleet_controller_kill": scenario_fleet_controller_kill,
    "fleet_bad_canary": scenario_fleet_bad_canary,
    "fleet_role_crashloop": scenario_fleet_role_crashloop,
}
