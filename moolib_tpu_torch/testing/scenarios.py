"""Seeded chaos scenarios of the port; the counterpart of
:mod:`moolib_tpu.testing.scenarios`: ONE implementation shared by the
tests and the soak runner (:mod:`moolib_tpu_torch.tools.chaos_soak`), so
the invariants the soak checks are exactly the invariants the tests pin.
All eighteen of the reference's scenarios, in its order: the wire and
elastic ones on ``MiniCluster``, the durable-state ones on
``StateCohort``, the serving tier's on ``ServingFleet``, the env tier's
on ``EnvFleet`` (``ChaosStepEnv`` envs in spawn workers) and the fleet's
on ``FleetHarness``.

Each scenario takes a seed, drives a live in-process cluster through a
:class:`~moolib_tpu_torch.testing.chaos.FaultPlan`, raises
``AssertionError`` with a descriptive message on any invariant violation,
and returns the plan's injected-event summary. Replaying a failure needs
only the seed. The wire, elastic and env models and payloads are numpy,
as in the reference. The serving and fleet scenarios serve a numpy toy
model through the port's ``Replica``, which runs on the card unless
``device="cpu"`` is given.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from typing import Any, Dict

import numpy as np
import torch

from ..fleet.controller import _scale_model
from ..rpc import Rpc, RpcError
from ..rpc.broker import Broker
from ..rpc.group import Group
from .chaos import (ChaosNet, FaultPlan, ProcChaos, ProcFaultPlan,
                    ResourceChaos, ResourceFaultPlan)
from .chaos_env import ChaosStepEnv

__all__ = [
    "ChaosStepEnv",
    "EnvFleet",
    "MiniCluster",
    "ServingFleet",
    "StateCohort",
    "scenario_drop_storm",
    "scenario_partition_heal",
    "scenario_leader_loss",
    "scenario_learner_restart",
    "scenario_broker_failover",
    "scenario_straggler_quorum",
    "scenario_shm_lane_fallback",
    "scenario_statestore_host_loss",
    "scenario_statestore_disk_full",
    "scenario_statestore_bitflip",
    "scenario_replica_kill",
    "scenario_router_partition",
    "scenario_envpool_worker_kill",
    "scenario_envpool_wedge",
    "scenario_envpool_poison",
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


def _pump_groups(groups, n, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for g in groups:
            g.update()
        if all(len(g.members) == n and g.active() for g in groups) and (
            len({g.sync_id for g in groups}) == 1
        ):
            return
        time.sleep(0.02)
    raise AssertionError(f"group never stabilized at {n} members")


def scenario_drop_storm(seed: int, calls: int = 30) -> Dict[str, int]:
    """Seeded loss storm on both the request and the response endpoint:
    every call completes with the right answer (poke/NACK resend +
    cached-response replay — no lost acked call) and every request
    executes exactly once (duplicate suppression under resend)."""
    host = Rpc("host")
    host.listen("127.0.0.1:0")
    executed = []
    lock = threading.Lock()

    def work(x):
        with lock:
            executed.append(x)
        return x * 3

    host.define("work", work)
    client = Rpc("client")
    client._poke_min = 0.2
    client.set_timeout(20.0)
    client.connect(host.debug_info()["listen"][0])
    plan = FaultPlan(seed).drop("work", p=0.3).drop("@success", p=0.3)
    try:
        with ChaosNet(plan, [client, host]):
            futs = [client.async_("host", "work", i) for i in range(calls)]
            for i, f in enumerate(futs):
                got = f.result(timeout=30)
                assert got == i * 3, f"call {i} returned {got}: lost/corrupt"
        assert any(e.kind == "drop" for e in plan.events), (
            "storm never dropped anything — seed too tame"
        )
        with lock:
            assert sorted(executed) == list(range(calls)), (
                f"exactly-once violated: {sorted(executed)}"
            )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        client.close()
        host.close()


def scenario_partition_heal(seed: int) -> Dict[str, int]:
    """Partition a leaf from the tree root mid-epoch: the round must not
    split-brain — EVERY member's future errors (none completes a partial
    sum). After heal, the next round completes on every member."""
    cluster = MiniCluster()
    try:
        peers = [cluster.spawn(f"p{i}") for i in range(3)]
        groups = [g for _, g in peers]
        _pump_groups(groups, 3)
        members = groups[0].members
        root, leaf = members[0], members[-1]
        plan = FaultPlan(seed)
        net = ChaosNet(plan, [rpc for rpc, _ in peers])
        try:
            net.partition(root, leaf)
            futs = [g.all_reduce("parted", np.ones(2)) for g in groups]
            deadline = time.monotonic() + 20
            while not all(f.done() for f in futs):
                assert time.monotonic() < deadline, (
                    "partitioned round neither completed nor errored"
                )
                for g in groups:
                    g.update()  # drives _expire_ops
                time.sleep(0.05)
            excs = [f.exception(timeout=1) for f in futs]
            assert all(isinstance(e, RpcError) for e in excs), (
                f"split outcome under partition: {excs}"
            )
            assert any(e.kind == "partitioned" for e in plan.events)

            net.heal(root, leaf)
            deadline = time.monotonic() + 25
            attempt = 0
            while True:
                for g in groups:
                    g.update()
                attempt += 1
                futs = [g.all_reduce(f"healed{attempt}", np.ones(2))
                        for g in groups]
                try:
                    for f in futs:
                        out = f.result(timeout=8)
                        assert float(out[0]) == 3.0, out
                    break
                except (RpcError, TimeoutError):
                    assert time.monotonic() < deadline, (
                        "group never recovered after heal"
                    )
            plan.verify_telemetry()  # registry counters == injected log
            return plan.summary()
        finally:
            net.detach_all()
    finally:
        cluster.close()


def scenario_leader_loss(seed: int) -> Dict[str, int]:
    """The elected leader freezes mid-round and then dies: stranded
    collective futures error promptly (group timeout / epoch
    cancellation — never the 30s RPC deadline wheel), round bookkeeping
    does not wedge, and the survivors re-elect and reduce again —
    including the contributions restored from the aborted epoch."""
    from ..parallel import Accumulator

    cluster = MiniCluster()
    plan = FaultPlan(seed)
    try:
        accs = []
        for i in range(3):
            rpc, g = cluster.spawn(f"p{i}")
            accs.append(Accumulator(rpc, group=g, virtual_batch_size=4))
        accs[0].set_model_version(3)  # p0 wins the election (no state
        # callbacks, so followers never inherit its version)
        net = ChaosNet(plan, [a.rpc for a in accs])
        _pump_accs(accs, lambda: all(
            a.connected() and a.wants_gradients() for a in accs
        ), 25, "initial sync")
        assert accs[0].is_leader()
        survivors = accs[1:]
        for a in survivors:
            a.reduce_gradients({"w": np.full((3,), 2.0)}, batch_size=2)

        def aged():
            # Only ops stalled >0.6s are provably waiting on the frozen
            # leader (a live loopback round completes in milliseconds).
            now = time.monotonic()
            return [
                op.future
                for a in survivors
                for op in list(a.group._active.values())
                if now - op.started > 0.6 and not op.future.done()
            ]

        _pump_accs(survivors, lambda: aged(), 10, "strand a round")
        stuck = aged()
        assert stuck, "no in-flight collective to strand"
        net.kill_conns(accs[0].rpc)
        accs[0].rpc.close()
        t0 = time.monotonic()
        _pump_accs(survivors, lambda: all(f.done() for f in stuck), 20,
                   "stranded futures error")
        for f in stuck:
            assert isinstance(f.exception(timeout=1), RpcError), (
                "stranded future completed instead of erroring"
            )
        assert time.monotonic() - t0 < 20.0
        _pump_accs(survivors, lambda: all(
            a.connected() and len(a.group.members) == 2 for a in survivors
        ), 25, "re-election")
        leader = survivors[0].get_leader()
        assert leader in ("p1", "p2") and all(
            a.get_leader() == leader for a in survivors
        ), "survivors disagree on the new leader"
        _pump_accs(survivors,
                   lambda: all(a.has_gradients() for a in survivors),
                   25, "post-loss reduction")
        for a in survivors:
            mean, count = a.result_gradients()
            assert count == 4, count
            np.testing.assert_allclose(np.asarray(mean["w"]), 1.0)
            assert a.get_gradient_stats()["gradient_rounds_inflight"] == 0, (
                "gradient round left in flight after recovery"
            )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        cluster.close()


# -- survivable training ----------------------------------------------------


def scenario_learner_restart(seed: int, rounds: int = 12,
                             tmpdir: "str | None" = None) -> Dict[str, int]:
    """SIGKILL-equivalent death of a learner mid-training (its conns and
    process die with no goodbye), followed by an immediate restart under
    the SAME peer name: the incarnation nonce makes the broker treat the
    restart as a fresh join (fresh epoch — the dead incarnation's
    sequence state is never continued), the restarted peer seeds
    ``set_model_version`` from its checkpoint so a checkpoint holder can
    win election, fetches current model state over RPC from the leader,
    and re-enters rounds. The run must reach the same seeded loss bar as
    an undisturbed control run — and since every peer computes the same
    gradient from the same params, the per-update trajectory matches the
    control exactly (loss continuity, not merely eventual convergence).
    The only injection is the scripted conn kill, so the event log is
    identical for identical seeds."""
    import tempfile

    from ..parallel import Accumulator
    from ..utils import Checkpointer

    rng = np.random.RandomState(seed)
    target = rng.uniform(-1.0, 1.0, size=(4,)).astype(np.float32)
    lr = np.float32(0.2)

    # Control trajectory: plain SGD on f(w) = ||w - target||^2 from w=0.
    w_ctrl = np.zeros(4, np.float32)
    for _ in range(rounds):
        w_ctrl = w_ctrl - lr * (2.0 * (w_ctrl - target))
    bar = float(((w_ctrl - target) ** 2).mean())

    cluster = MiniCluster()
    plan = FaultPlan(seed)
    state: Dict[str, np.ndarray] = {}

    def make_acc(name, ckpt=None):
        rpc, g = cluster.spawn(name)
        state.setdefault(name, np.zeros(4, np.float32))

        def get_state(n=name):
            return {"w": state[n]}

        def set_state(s, n=name):
            state[n] = np.asarray(s["w"], np.float32)

        acc = Accumulator(rpc, group=g, virtual_batch_size=2,
                          get_state=get_state, set_state=set_state)
        if ckpt is not None:
            saved = ckpt.load()
            if saved is not None:
                state[name] = np.asarray(saved["w"], np.float32)
                # The checkpoint holder must win election over emptier
                # peers (reference: set_model_version before joining).
                acc.set_model_version(saved["model_version"])
        return acc

    def drive(accs, cks, until, timeout, what):
        def step(a):
            name = a.rpc.get_name()
            if a.has_gradients():
                mean, _count = a.result_gradients()
                state[name] = np.asarray(
                    state[name] - lr * mean["w"], np.float32
                )
                a.zero_gradients()
                ck = cks.get(name)
                if ck is not None:
                    ck.save({"w": state[name],
                             "model_version": a.result_model_version()})
            elif a.wants_gradients():
                a.reduce_gradients(
                    {"w": 2.0 * (state[name] - target)}, batch_size=1
                )

        _pump_accs(accs, until, timeout, what, each=step)

    net = None
    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        ck_path = td + "/learner.ckpt"
        try:
            accs = [make_acc(f"p{i}") for i in range(3)]
            net = ChaosNet(plan, [a.rpc for a in accs]
                           + [cluster.broker_rpc])
            victim = accs[2]
            cks = {"p2": Checkpointer(ck_path, interval=0.0)}
            kill_at = max(2, rounds // 3)
            # The kill waits for the victim's lanes to settle too, to
            # every other peer: which members it dials depends on the
            # run's reduction topology, and the shm lanes come up after
            # the greetings, so a kill before then would log another
            # count of connections killed for the same seed.
            others = [a.rpc for a in accs[:2]] + [cluster.broker_rpc]
            for o in others[:2]:
                victim.rpc.connect(o.debug_info()["listen"][0])
            drive(accs, cks, lambda: all(
                a.model_version >= kill_at for a in accs
            ) and _lanes_settled(victim.rpc, others), 30,
                "pre-kill training")

            # SIGKILL-equivalent: connections die, process gone, no
            # goodbye — the checkpoint on disk is all that survives.
            net.kill_conns(victim.rpc)
            victim.rpc.close()
            accs = accs[:2]

            # Immediate restart under the SAME name, resuming from the
            # checkpoint (exercises the incarnation nonce: the broker
            # must not mistake this for the dead incarnation).
            restarted = make_acc("p2", ckpt=Checkpointer(ck_path))
            accs.append(restarted)
            cks = {}
            drive(accs, cks, lambda: all(
                a.connected() and a._synced
                and len(a.group.members) == 3 for a in accs
            ), 30, "restart rejoin")

            # Every peer at one version with nothing left to apply: a
            # version alone may count a result another peer has applied
            # and this one has not yet received.
            drive(accs, cks, lambda: all(
                a.model_version >= rounds for a in accs
            ) and len({a.model_version for a in accs}) == 1
                and all(not a.has_gradients() for a in accs),
                30, "post-restart training")

            # Loss continuity: every peer (including the restarted one)
            # converged along the control trajectory — same update rule,
            # same params, so >= `rounds` updates means <= the control
            # bar (the loss is monotonically contracting at this lr).
            for a in accs:
                w = state[a.rpc.get_name()]
                loss = float(((w - target) ** 2).mean())
                assert loss <= bar * 1.05 + 1e-7, (
                    f"{a.rpc.get_name()} missed the control loss bar: "
                    f"{loss} > {bar} (w={w}, target={target})"
                )
            ws = [state[a.rpc.get_name()] for a in accs]
            for w in ws[1:]:
                np.testing.assert_allclose(w, ws[0], rtol=1e-5, atol=1e-6)
            # Replay determinism: the only injection is the scripted kill.
            assert [e.kind for e in plan.events] == ["conn_kill"], (
                f"unexpected injected-event log: {plan.events}"
            )
            plan.verify_telemetry()  # registry counters == injected log
            return plan.summary()
        finally:
            if net is not None:
                net.detach_all()
            cluster.close()


def scenario_broker_failover(seed: int) -> Dict[str, int]:
    """Kill the broker while a collective is in flight: members rotate to
    the standby within the failover threshold, the standby
    re-materializes the epoch from cohort gossip (same sync id — no
    resync, so the in-flight op completes instead of being cancelled),
    ``broker_dark_seconds`` stops accruing after promotion, and a
    post-promotion allreduce completes. The only injection is the
    scripted conn kill, so the event log is identical for identical
    seeds."""
    cluster = MiniCluster(standby=True, failover_after=2.5)
    plan = FaultPlan(seed)
    net = ChaosNet(plan, [cluster.broker_rpc, cluster.standby_rpc])
    try:
        peers = [cluster.spawn(f"p{i}", timeout=8.0) for i in range(3)]
        for rpc, g in peers:
            net.attach(rpc)
            # A grace shorter than the failover threshold (but longer
            # than the ping cadence) so the pre-promotion window REGISTERS
            # as dark — the accrual-stops-at-promotion check needs a
            # nonzero baseline.
            g.set_broker_grace(1.2)
        groups = [g for _, g in peers]
        _pump_groups(groups, 3)
        sync_before = groups[0].sync_id
        futs = [g.all_reduce("pre", np.ones(2)) for g in groups]
        for f in futs:
            assert float(f.result(timeout=10)[0]) == 3.0

        # Strand an op in flight: every member but the last contributes,
        # then the broker dies. The op must SURVIVE the promotion (same
        # epoch) and complete once the last member joins in.
        inflight = [g.all_reduce("inflight", np.ones(2))
                    for g in groups[:-1]]
        net.kill_conns(cluster.broker_rpc)
        cluster.kill_broker()

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            for g in groups:
                g.update()
            if all(g.broker_name == "broker2" and g.broker_connected()
                   for g in groups):
                break
            time.sleep(0.02)
        else:
            raise AssertionError(
                "members never promoted the standby: "
                + str([(g.broker_name, g.broker_silence()) for g in groups])
            )
        reg0 = peers[0][0].telemetry.registry
        assert (reg0.value("group_broker_failovers_total", group="g")
                or 0) >= 1, "promotion did not count a failover"
        dark_total = reg0.value("group_broker_dark_seconds_total", group="g")
        assert dark_total and dark_total > 0, (
            "the dark window before promotion must accrue dark seconds"
        )

        # Complete the stranded op across the promotion.
        inflight.append(groups[-1].all_reduce("inflight", np.ones(2)))
        for f in inflight:
            out = f.result(timeout=10)
            assert float(out[0]) == 3.0, (
                f"in-flight op did not survive the promotion: {out}"
            )

        # The standby adopted the epoch from gossip: give its settle
        # window time to close, then check nothing was resynced and the
        # dark counter stopped accruing.
        _await(lambda: _settled(groups, sync_before), 15,
               "standby never finished adopting the epoch")
        d1 = reg0.value("group_broker_dark_seconds_total", group="g")
        end = time.monotonic() + 1.0
        while time.monotonic() < end:
            for g in groups:
                g.update()
            time.sleep(0.02)
        assert all(g.sync_id == sync_before for g in groups), (
            "promotion minted a new epoch despite an intact roster"
        )
        for rpc, _g in peers:
            cancelled = rpc.telemetry.registry.value(
                "group_rounds_cancelled_total", group="g")
            assert not cancelled, (
                f"promotion cancelled in-flight ops on {rpc.get_name()}"
            )
        after = reg0.value("group_broker_dark_seconds_total", group="g")
        # Steadily-accruing would add ~1.0s over the settle pump; allow a
        # scheduler-blip fraction of it but not wholesale accrual.
        assert after - d1 < 0.5, (
            f"broker_dark_seconds kept accruing after promotion: "
            f"{d1} -> {after} (pre-promotion window accrued {dark_total})"
        )

        futs = [g.all_reduce("post", np.ones(2)) for g in groups]
        for f in futs:
            assert float(f.result(timeout=10)[0]) == 3.0

        assert [e.kind for e in plan.events] == ["conn_kill"], (
            f"unexpected injected-event log: {plan.events}"
        )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        net.detach_all()
        cluster.close()


def _settled(groups, sync_id):
    for g in groups:
        g.update()
    return all(g.sync_id == sync_id and g.broker_connected()
               for g in groups)


def scenario_straggler_quorum(seed: int) -> Dict[str, int]:
    """One member's outbound data-plane traffic crawls (a slow link):
    with ``min_quorum=2`` the cohort commits gradient rounds with N-1
    contributions at the straggler deadline — well before the collective
    timeout — the straggler (which still receives results on time) sees
    its contribution was written off and re-contributes it, and once the
    link heals every contribution lands EXACTLY once on every member.
    Delay verdicts depend on live message cadence, so this scenario
    asserts invariants plus decision-level telemetry consistency rather
    than an exact log (like router_partition)."""
    from ..parallel import Accumulator

    cluster = MiniCluster()  # group timeout 4s
    plan = FaultPlan(seed)
    state: Dict[str, np.ndarray] = {}
    applied: Dict[str, np.ndarray] = {}
    net = slow_net = None
    try:
        accs = []
        for i in range(3):
            rpc, g = cluster.spawn(f"p{i}")
            name = rpc.get_name()
            state[name] = np.zeros(3, np.float32)
            applied[name] = np.zeros(3, np.float64)

            def get_state(n=name):
                return {"w": state[n]}

            def set_state(s, n=name):
                state[n] = np.asarray(s["w"], np.float32)

            accs.append(Accumulator(
                rpc, group=g, virtual_batch_size=2,
                min_quorum=2, straggler_timeout=0.5,
                get_state=get_state, set_state=set_state,
            ))
        net = ChaosNet(plan, [a.rpc for a in accs] + [cluster.broker_rpc])
        # Straggler write-offs arm only once the quorum negotiation has
        # landed (first count-round commit) — wait for it before slowing
        # the link, so the write-off path (not broker expiry) is what
        # this scenario exercises.
        _pump_accs(accs, lambda: all(
            a.connected() and a.wants_gradients()
            and a.get_gradient_stats()["negotiated_quorum"] == 2
            for a in accs
        ), 25, "initial sync + quorum negotiation")

        members = accs[0].group.members
        straggler = next(a for a in accs
                         if a.rpc.get_name() == members[-1])
        fast = [a for a in accs if a is not straggler]
        weights = {m: w for m, w in zip(members, (1.0, 10.0, 100.0))}
        total = sum(weights.values())

        # One-way slow link, installed on the straggler's Rpc only: its
        # OUTBOUND collective messages crawl (written off at the
        # straggler deadline) while results still reach it on time, so
        # it stays in sequence and observes every commit it missed.
        slow_plan = FaultPlan(seed + 1)
        for a in fast:
            slow_plan.delay("AllReduceService::*", seconds=1.2,
                            direction="send", peer=a.rpc.get_name())
        slow_net = ChaosNet(slow_plan, [straggler.rpc])

        def apply_result(a):
            if a.has_gradients():
                mean, count = a.result_gradients()
                applied[a.rpc.get_name()] += (
                    np.asarray(mean["w"], np.float64) * count
                )
                a.zero_gradients()

        def pump_apply(until, timeout, what):
            _pump_accs(accs, until, timeout, what, each=apply_result)

        for a in accs:
            w = weights[a.rpc.get_name()]
            a.reduce_gradients({"w": np.full((3,), w, np.float32)},
                               batch_size=2)
        t0 = time.monotonic()
        fast_mass = sum(weights[a.rpc.get_name()] for a in fast)
        pump_apply(lambda: all(
            np.allclose(applied[a.rpc.get_name()], fast_mass)
            for a in fast
        ), 10, "quorum commit with N-1 contributions")
        commit_latency = time.monotonic() - t0
        assert commit_latency < 4.0, (
            f"quorum round took {commit_latency:.2f}s — it must beat the "
            "4s collective timeout (straggler deadline is 0.5s)"
        )
        for a in fast:
            part = a.get_gradient_stats()["last_participation"]
            assert part == (2, 3), (
                f"expected an N-1 commit, got participation {part}"
            )
            reg = a.rpc.telemetry.registry
            assert (reg.value("acc_partial_gradient_rounds_total")
                    or 0) >= 1, "partial gradient round not counted"
        # The straggler observed the commit it missed and re-pended.
        pump_apply(lambda: straggler.get_gradient_stats()[
            "recontributed"] >= 1, 10, "straggler re-contribution")

        slow_net.detach_all()  # the link heals
        pump_apply(lambda: all(
            np.allclose(applied[n], total) for n in applied
        ), 25, "late contribution lands exactly once after heal")
        # Settle: a few more count rounds must not double-apply anything.
        end = time.monotonic() + 1.0
        pump_apply(lambda: time.monotonic() >= end, 5, "settle")
        for n, mass in applied.items():
            np.testing.assert_allclose(
                mass, total, rtol=1e-6,
                err_msg=f"{n}: contribution applied twice or lost"
            )
        kinds = {e.kind for e in slow_plan.events}
        assert kinds <= {"delay"}, kinds
        assert plan.events == [], plan.events
        plan.verify_telemetry()
        slow_plan.verify_telemetry()
        return {**plan.summary(), **slow_plan.summary()}
    finally:
        if slow_net is not None:
            slow_net.detach_all()
        if net is not None:
            net.detach_all()
        cluster.close()


def _lanes_settled(rpc: Rpc, peers) -> bool:
    """Every lane ``rpc`` will hold to each of ``peers`` (Rpcs) is up and
    no other: the socket lane, plus the same-host shm lane where both
    sides offer one (its offer/accept round trip follows the greeting),
    and no connection still waiting for its greeting. A conn kill of
    ``rpc`` then counts the same connections in every run of a seed."""
    if rpc._anon_conns:
        return False
    for other in peers:
        p = rpc._peers.get(other.get_name())
        live = ({t for t, c in list(p.conns.items()) if not c.is_closing()}
                if p is not None else set())
        shm = (rpc._shm_enabled and other._shm_enabled
               and "shm" in rpc._transports and "shm" in other._transports)
        if live != ({"tcp", "shm"} if shm else {"tcp"}):
            return False
    return True


def _await_shm_lane(a: Rpc, b: Rpc, timeout: float = 10.0):
    """Wait until the zero-copy shm lane is mounted on BOTH peers (the
    rendezvous rides the greeting + one offer/accept round trip)."""
    def up(x: Rpc, peer: str) -> bool:
        p = x._peers.get(peer)
        return bool(p and "shm" in p.conns
                    and not p.conns["shm"].is_closing())

    _await(lambda: up(a, b.get_name()) and up(b, a.get_name()), timeout,
           "shm lane never came up between "
           f"{a.get_name()} and {b.get_name()}")


def scenario_shm_lane_fallback(seed: int, calls: int = 6) -> Dict[str, int]:
    """Kill the same-host shm lane on both peers while calls are in
    flight on it (the segment-death / peer-death failure class,
    docs/reliability.md): every stranded call is resent over the
    surviving TCP lane and completes EXACTLY once (duplicate rids
    suppressed server-side), the dead lane's /dev/shm entries are
    unlinked (no segment leak), the lane never silently resurrects, and
    the injected-event log is deterministic — exactly one scripted
    conn_kill per side, every run, for any seed."""
    import os as _os

    host = Rpc("shmhost")
    host.listen("127.0.0.1:0")
    gate = threading.Event()
    executed = []
    lock = threading.Lock()

    def work(x):
        # Hold the (single-worker) executor until the kill lands so the
        # whole batch is provably in flight across the lane teardown.
        gate.wait(15)
        with lock:
            executed.append(int(x[0]))
        return x * 2.0

    host.define("work", work)
    client = Rpc("shmclient")
    client._poke_min = 0.2
    client.set_timeout(20.0)
    client.connect(host.debug_info()["listen"][0])
    plan = FaultPlan(seed)
    net = ChaosNet(plan, [client, host])
    try:
        _await_shm_lane(client, host)
        lane_paths = [
            e["lane"].path for e in list(client._shm_pairs.values())
        ] + [e["lane"].path for e in list(host._shm_pairs.values())]
        assert lane_paths, "no shm lane paths to watch for leaks"

        # Spill-sized payloads: the calls ride the shm lane's zero-copy
        # slot path (fresh lanes tie on EWMA and shm wins the tie).
        futs = [
            client.async_("shmhost", "work",
                          np.full((1 << 18,), float(i), np.float32))
            for i in range(calls)
        ]
        hreg = host.telemetry.registry
        _await(lambda: (hreg.value("rpc_server_calls_total",
                                   endpoint="work") or 0) >= calls,
               15, "calls never reached the server over the shm lane")
        shm_out = client.telemetry.registry.value(
            "rpc_bytes_out_total", transport="shm") or 0
        # Headroom mirrors bench_rpc_shm_payload's 0.8 margin: the
        # per-send exploration bandit (global RNG, ~2.5%/call) may
        # legally route a payload or two over TCP — those calls simply
        # are not stranded by the kill; requiring most (not all) of the
        # ~1 MB payloads on the lane keeps the scenario deterministic
        # in its assertions without depending on the RNG stream position.
        assert shm_out > (calls - 2) * (1 << 20), (
            f"payloads did not ride the shm lane ({shm_out} bytes)"
        )

        # Segment death, both sides: only the shm lane dies; TCP survives.
        assert net.kill_conns(client, "shmhost", transport="shm") == 1
        assert net.kill_conns(host, "shmclient", transport="shm") == 1
        gate.set()

        # Exactly-once completion over the TCP fallback.
        for i, f in enumerate(futs):
            out = f.result(timeout=30)
            assert float(out[0]) == 2.0 * i, (
                f"call {i} lost or corrupted across the lane kill: {out}"
            )
        with lock:
            assert sorted(executed) == list(range(calls)), (
                f"exactly-once violated across the shm->tcp fallback: "
                f"{sorted(executed)}"
            )
        creg = client.telemetry.registry
        assert (creg.value("rpc_resends_total") or 0) >= 1, (
            "stranded calls were never resent onto the TCP lane"
        )

        # The lane is gone (no silent resurrection without a reconnect)
        # and its filesystem entries are unlinked — no /dev/shm leak.
        for rpc, peer in ((client, "shmhost"), (host, "shmclient")):
            conns = rpc._peers[peer].conns
            assert "shm" not in conns, (
                f"{rpc.get_name()} still holds an shm conn after the kill"
            )
        for path in lane_paths:
            for suffix in ("", ".db0", ".db1"):
                assert not _os.path.exists(path + suffix), (
                    f"shm lane leaked {path + suffix} after death"
                )

        # A post-kill call rides TCP (the degraded steady state works).
        assert client.sync("shmhost", "work", np.zeros(2, np.float32))[
            0] == 0.0

        # Replay determinism: the only injections are the two scripted
        # lane kills — identical log for identical seeds, every run.
        assert [(e.kind, e.arg) for e in plan.events] == [
            ("conn_kill", 1), ("conn_kill", 1)
        ], f"unexpected injected-event log: {plan.events}"
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        gate.set()
        net.detach_all()
        client.close()
        host.close()


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


class ServingFleet:
    """Router + N replica peers, all in-process over loopback on
    OS-assigned ports — the canonical serving cohort for the chaos
    scenarios, the soak runner, and
    :mod:`moolib_tpu_torch.tools.serving_load`.

    The model is a trivial scale (``x * params["scale"]``) so the
    scenarios measure the serving machinery, not arithmetic; the
    model-serving path is pinned separately in
    ``tests/test_torch_serving.py``. ``device`` is each replica's (the
    card unless ``"cpu"``)."""

    def __init__(self, n_replicas: int = 3, *, service: str = "serve",
                 batch_size: int = 4, max_queue: int = 128,
                 attempt_timeout_s: float = 1.0,
                 probe_interval_s: float = 0.1, probe_misses: int = 3,
                 seed: int = 0, device=None):
        from ..serving import Replica, Router

        self.service = service
        self.replicas = []
        self.replica_rpcs = []
        params = {"scale": np.float32(2.0)}
        for i in range(n_replicas):
            rpc = Rpc(f"rep{i}")
            rpc.listen("127.0.0.1:0")
            rep = Replica(rpc, _scale_model, params, version=1,
                          service=service, batch_size=batch_size,
                          max_queue=max_queue, device=device)
            self.replica_rpcs.append(rpc)
            self.replicas.append(rep)
        self.router_rpc = Rpc("router")
        for rpc in self.replica_rpcs:
            self.router_rpc.connect(rpc.debug_info()["listen"][0])
        self.router = Router(
            self.router_rpc, [r.get_name() for r in self.replica_rpcs],
            service=service, attempt_timeout_s=attempt_timeout_s,
            probe_interval_s=probe_interval_s, probe_misses=probe_misses,
            seed=seed,
        )

    def all_rpcs(self):
        return [self.router_rpc] + list(self.replica_rpcs)

    def wait_routable(self, n: int, timeout: float = 15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.router.routable()) >= n:
                return
            time.sleep(0.02)
        raise AssertionError(
            f"fleet never reached {n} routable replicas: "
            + str(self.router.stats())
        )

    def close(self):
        self.router.close()
        self.router_rpc.close()
        for rep, rpc in zip(self.replicas, self.replica_rpcs):
            # Idempotent: scenarios may have closed a killed replica.
            rep.close()
            rpc.close()


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


def scenario_replica_kill(seed: int, *, pre_requests: int = 60,
                          post_requests: int = 90,
                          concurrency: int = 4,
                          budget_s: float = 8.0,
                          device=None) -> Dict[str, int]:
    """Kill one of three replicas mid-load: every accepted request
    completes or fails fast with an
    explicit error (no hang to the RPC deadline), served p99 stays
    within 3x the pre-kill p99 (floored at the transport's 100ms
    failure-detection tick so a quiet-host baseline cannot flake the
    bound), the injected-event log
    is identical for identical seeds (the only injections are scripted),
    and the serving metric family is consistent with the observed
    counts — checked in-registry AND through a live ``__telemetry``
    wire scrape of a surviving replica."""
    fleet = ServingFleet(3, seed=seed, device=device)
    plan = FaultPlan(seed)
    net = ChaosNet(plan, fleet.all_rpcs())
    lock = threading.Lock()
    try:
        fleet.wait_routable(3)
        # Pre-kill phase: a clean baseline under the same concurrency.
        pre: list = []
        for t in _run_load(fleet.router, pre_requests, concurrency,
                           budget_s, pre, lock):
            t.join(timeout=60)
            assert not t.is_alive(), "pre-kill load worker hung"
        assert all(k == "ok" for k, _lat, _v in pre), (
            f"pre-kill phase had failures: "
            f"{[r for r in pre if r[0] != 'ok'][:3]}"
        )
        p99_pre = _p99([lat for _k, lat, _v in pre])

        # Post phase: kill rep0 after ~1/6 of the load has completed.
        post: list = []
        killed = threading.Event()

        def maybe_kill(n):
            if n >= post_requests // 6 and not killed.is_set():
                killed.set()
                net.kill_conns(fleet.replica_rpcs[0])
                fleet.replica_rpcs[0].close()

        threads = _run_load(fleet.router, post_requests, concurrency,
                            budget_s, post, lock, on_count=maybe_kill)
        for t in threads:
            # budget + slack bounds every worker: a hang here means a
            # request neither completed nor failed fast.
            t.join(timeout=post_requests * (budget_s + 5))
            assert not t.is_alive(), (
                "post-kill load worker hung: an accepted request neither "
                "completed nor failed fast"
            )
        assert killed.is_set(), "load finished before the kill landed"
        assert len(post) == post_requests, (
            f"accepted-then-dropped: {post_requests - len(post)} requests "
            "vanished without an outcome"
        )
        # Every failure must be explicit AND fast (well under the 30s
        # RPC deadline — bounded by the request budget plus slack).
        for k, lat, detail in post:
            assert lat < budget_s + 5.0, (
                f"outcome took {lat:.1f}s (> budget {budget_s}s + slack): "
                f"{detail}"
            )
        ok_lat = [lat for k, lat, _v in post if k == "ok"]
        n_err = sum(1 for k, _lat, _v in post if k == "err")
        assert len(ok_lat) >= post_requests * 0.8, (
            f"only {len(ok_lat)}/{post_requests} requests served across "
            f"the kill; errors: "
            f"{[r[2] for r in post if r[0] == 'err'][:5]}"
        )
        p99_post = _p99(ok_lat)
        # Floor the baseline at the transport's failure-detection
        # granularity (one 100ms timeout-wheel tick): a rescued request
        # structurally pays detection + one retry (~0.15s), and a
        # sub-millisecond quiet-host baseline must not flake the bound
        # into measuring the wheel instead of the serving tier.
        bound = 3.0 * max(p99_pre, 0.1)
        assert p99_post <= bound, (
            f"served p99 blew out across the kill: pre={p99_pre:.4f}s "
            f"post={p99_post:.4f}s (bound {bound:.4f}s)"
        )
        # Replay determinism: the only injections are scripted, so the
        # log for a given seed is exactly this, every run.
        assert [e.kind for e in plan.events] == ["conn_kill"], (
            f"unexpected injected-event log: {plan.events}"
        )

        # Serving metric family consistent with the observed counts.
        n_ok = len(ok_lat) + len(pre)
        rreg = fleet.router_rpc.telemetry.registry
        got_req = rreg.value("serving_router_requests_total",
                             service=fleet.service)
        got_ok = rreg.value("serving_router_ok_total", service=fleet.service)
        assert got_req == pre_requests + post_requests, got_req
        assert got_ok == n_ok, (got_ok, n_ok)
        retried = rreg.value("serving_retried_total",
                             service=fleet.service) or 0
        admitted = sum(
            rpc.telemetry.registry.value("serving_admitted_total",
                                         service=fleet.service) or 0
            for rpc in fleet.replica_rpcs[1:]
        )
        # Survivors admitted at least every request they served; the
        # dead replica's registry died with it, so only bound below.
        completed = sum(
            rpc.telemetry.registry.value("serving_completed_total",
                                         service=fleet.service) or 0
            for rpc in fleet.replica_rpcs[1:]
        )
        assert admitted >= completed and completed <= n_ok + retried, (
            admitted, completed, n_ok, retried,
        )
        # The family is visible through the wire scrape any peer serves.
        scrape = fleet.router_rpc.sync(
            fleet.replica_rpcs[1].get_name(), "__telemetry",
            fmt="prometheus",
        )
        for metric in ("serving_admitted_total", "serving_completed_total",
                       "serving_queue_depth", "serving_service_seconds"):
            assert metric in scrape, f"{metric} missing from wire scrape"
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        net.detach_all()
        fleet.close()


def scenario_router_partition(seed: int, *, budget_s: float = 8.0,
                              concurrency: int = 3,
                              device=None) -> Dict[str, int]:
    """Partition the router from one replica mid-load: health probes go
    dark, the replica is drained from rotation (no accepted request is
    dropped — victims fail fast at the attempt timeout and are retried
    on healthy replicas), and after heal the replica returns to
    rotation. Patterned drops depend on live timing, so this scenario
    asserts invariants plus decision-level telemetry consistency, not an
    exact log."""
    fleet = ServingFleet(3, seed=seed, attempt_timeout_s=0.5,
                         device=device)
    plan = FaultPlan(seed)
    net = ChaosNet(plan, fleet.all_rpcs())
    lock = threading.Lock()
    outcomes: list = []
    stop = threading.Event()
    try:
        fleet.wait_routable(3)
        target = fleet.replica_rpcs[0].get_name()

        def worker():
            x = np.ones(4, np.float32)
            from ..serving import error_kind

            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    fleet.router.infer(x, budget_s=budget_s)
                    rec = ("ok", time.monotonic() - t0, "")
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except Exception as e:
                    rec = ("err", time.monotonic() - t0,
                           f"{error_kind(e)}: {e}")
                with lock:
                    outcomes.append(rec)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(concurrency)]
        for t in threads:
            t.start()
        _await(lambda: len(outcomes) >= 10, 30,
               "load never got going", lock)

        net.partition("router", target)
        _await(lambda: target not in fleet.router.routable(), 15,
               f"{target} never left rotation under partition")
        with lock:
            mark = len(outcomes)
        # Served THROUGH the partition: the healthy replicas carry it.
        _await(lambda: _count_ok(outcomes, lock, mark) >= 10, 30,
               "no requests served while partitioned")
        # The partition must have COST probes. Awaited while still
        # partitioned (misses keep accruing until heal) rather than
        # asserted after the fact: the probe loop's cadence is scheduler
        # timing, and a starved probe thread under host load would
        # under-count by heal time — the replica can leave rotation via
        # the dispatch-failure breaker before 3 probes even fire.
        rreg = fleet.router_rpc.telemetry.registry
        _await(lambda: (rreg.value("serving_probe_misses_total",
                                   service=fleet.service) or 0) >= 3,
               15, "partition never cost a probe")

        net.heal("router", target)
        _await(lambda: target in fleet.router.routable(), 30,
               f"{target} never returned to rotation after heal")
        stop.set()
        for t in threads:
            t.join(timeout=budget_s + 10)
            assert not t.is_alive(), "load worker hung"

        for k, lat, detail in outcomes:
            assert lat < budget_s + 5.0, (
                f"outcome took {lat:.1f}s: {detail}"
            )
        n_ok = sum(1 for k, _l, _d in outcomes if k == "ok")
        assert n_ok >= len(outcomes) * 0.5, (
            f"partition starved the fleet: {n_ok}/{len(outcomes)} ok"
        )
        kinds = {e.kind for e in plan.events}
        assert "partition" in kinds and "partitioned" in kinds, kinds
        assert rreg.value("serving_probe_misses_total",
                          service=fleet.service) >= 3, (
            "partition never cost a probe"
        )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        stop.set()
        net.detach_all()
        fleet.close()


# -- env tier ----------------------------------------------------------------


class EnvFleet:
    """EnvPool + EnvPoolServer + one RemoteEnvStepper actor client, all
    in-process over loopback on OS-assigned ports — the canonical env-tier
    cohort for the chaos scenarios (the served-step path is what actors
    and, through them, the learner ride on)."""

    def __init__(self, create_env, *, procs: int, batch_size: int,
                 pool_name: str, watchdog_timeout: float = 5.0,
                 restart_backoff: float = 0.05,
                 poison_threshold: int = 3):
        from ..envpool import EnvPool, EnvPoolServer, RemoteEnvStepper

        self.pool = EnvPool(
            create_env, num_processes=procs, batch_size=batch_size,
            num_batches=2, name=pool_name,
            watchdog_timeout=watchdog_timeout,
            restart_backoff=restart_backoff,
            poison_threshold=poison_threshold,
        )
        self.server_rpc = Rpc("env-server")
        self.server_rpc.listen("127.0.0.1:0")
        self.server = EnvPoolServer(self.server_rpc, self.pool)
        self.client_rpc = Rpc("actor0")
        self.client_rpc.connect(self.server_rpc.debug_info()["listen"][0])
        self.stepper = RemoteEnvStepper(self.client_rpc, "env-server")

    def close(self):
        self.stepper.close()
        self.client_rpc.close()
        self.server.close()
        self.server_rpc.close()
        self.pool.close()


def _reg_delta(reg, name, base, **labels):
    return (reg.value(name, **labels) or 0) - base


def scenario_envpool_worker_kill(seed: int, *, procs: int = 3,
                                 batch_size: int = 6,
                                 steps: int = 12) -> Dict[str, int]:
    """SIGKILL 1-of-N env workers mid-batch (the seeded slot): only that
    worker's in-flight slices error — fast and typed (``WorkerDied:``,
    retry-safe), the surviving slices are served from their already-written
    results exactly once (no env steps twice across the retry), the pool
    respawns the slot within the restart budget, post-respawn steps/s
    recovers to >= 80% of the pre-kill rate (the env's fixed per-step
    sleep dominates both, so the ratio is scheduler-stable), the injected
    event log is seed-replay-identical ([proc_kill] with the seeded slot),
    and ``verify_telemetry`` matches the plan."""
    import functools

    from ..telemetry import global_telemetry

    pname = f"envkill{seed}"
    fleet = EnvFleet(
        functools.partial(ChaosStepEnv, sleep_s=0.01),
        procs=procs, batch_size=batch_size, pool_name=pname,
    )
    plan = ProcFaultPlan(seed)
    chaos = ProcChaos(plan, fleet.pool)
    try:
        st = fleet.stepper
        a = np.zeros(batch_size, np.int64)
        st.step(a).result(timeout=60)  # warm: every worker has stepped
        reg = global_telemetry().registry
        base_deaths = reg.value("envpool_worker_deaths_total",
                                pool=pname, kind="exit") or 0
        base_respawns = reg.value("envpool_respawns_total",
                                  pool=pname) or 0

        t0 = time.monotonic()
        for _ in range(steps):
            last = st.step(a).result(timeout=60)
        pre_rate = steps / (time.monotonic() - t0)
        pre_t = np.array(last["episode_step"], copy=True)

        slot = plan.pick(procs)  # the seeded decision
        per = batch_size // procs
        fut = st.step(a)
        time.sleep(0.004)  # land mid-slice (each slice takes ~per*10ms)
        chaos.kill(slot)
        out = fut.result(timeout=60)  # the retrying future heals

        # Exactly-once across the failure: every SURVIVING slice advanced
        # by exactly one step (their results were served, never re-run),
        # and the killed slot's slice restarted its episodes (fresh envs).
        lo, hi = slot * per, (slot + 1) * per
        surv = np.ones(batch_size, bool)
        surv[lo:hi] = False
        post_t = np.asarray(out["episode_step"])
        assert (post_t[surv] == pre_t[surv] + 1).all(), (
            f"surviving slices not exactly-once: {pre_t} -> {post_t} "
            f"(killed slot {slot})"
        )
        assert (post_t[lo:hi] == 1).all(), (
            f"killed slot's respawned slice should be on its first step: "
            f"{post_t[lo:hi]}"
        )
        assert st.retries_total >= 1, (
            "the kill must surface as a typed retry-safe failure that the "
            "stepper retried (not as a silent success)"
        )
        assert st.last_error and st.last_error.startswith("WorkerDied:"), (
            f"expected a WorkerDied: wire error, got {st.last_error!r}"
        )

        # The pool recovered within the restart budget...
        _await(lambda: _reg_delta(
            reg, "envpool_respawns_total", base_respawns, pool=pname
        ) >= 1, 20, "worker never respawned")
        assert _reg_delta(reg, "envpool_worker_deaths_total", base_deaths,
                          pool=pname, kind="exit") == 1
        # ... and serves at >= 80% of the pre-kill rate.
        t0 = time.monotonic()
        for _ in range(steps):
            st.step(a).result(timeout=60)
        post_rate = steps / (time.monotonic() - t0)
        assert post_rate >= 0.8 * pre_rate, (
            f"post-respawn steps/s did not recover: {post_rate:.1f} vs "
            f"pre-kill {pre_rate:.1f}"
        )

        # Replay determinism: decisions are pure in the seed, and the only
        # injected action is the scripted kill of the seeded slot.
        assert [(e.kind, e.arg) for e in plan.events] == [
            ("proc_kill", slot)
        ], plan.events
        assert ProcFaultPlan(seed).pick(procs) == slot, (
            "seeded slot draw is not replay-identical"
        )
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        fleet.close()


def scenario_envpool_wedge(seed: int, *, procs: int = 2,
                           batch_size: int = 4,
                           watchdog: float = 1.0) -> Dict[str, int]:
    """SIGSTOP one env worker mid-step (the seeded slot): the hung-step
    watchdog distinguishes the wedge from a merely slow worker (whose
    heartbeat advances per env step), kills it within the watchdog
    deadline, respawns the slot, and the wedged batch fails typed and
    completes on retry. Event log: exactly [proc_stop]."""
    import functools

    from ..telemetry import global_telemetry

    pname = f"envwedge{seed}"
    fleet = EnvFleet(
        functools.partial(ChaosStepEnv, sleep_s=0.03),
        procs=procs, batch_size=batch_size, pool_name=pname,
        watchdog_timeout=watchdog,
    )
    plan = ProcFaultPlan(seed)
    chaos = ProcChaos(plan, fleet.pool)
    try:
        st = fleet.stepper
        a = np.zeros(batch_size, np.int64)
        st.step(a).result(timeout=60)
        reg = global_telemetry().registry
        base_wedge = reg.value("envpool_worker_deaths_total",
                               pool=pname, kind="wedge") or 0

        slot = plan.pick(procs)
        fut = st.step(a)
        time.sleep(0.01)  # the slice is being stepped
        chaos.wedge(slot)
        t_wedge = time.monotonic()
        _await(lambda: _reg_delta(
            reg, "envpool_worker_deaths_total", base_wedge,
            pool=pname, kind="wedge"
        ) >= 1, watchdog + 5.0, "watchdog never reaped the wedged worker")
        detect_s = time.monotonic() - t_wedge
        # Deadline + one heartbeat-arm slack + scheduler slack: a wedge
        # must be detected promptly, not at some multiple of the deadline.
        assert detect_s <= watchdog + 2.0, (
            f"wedge detected after {detect_s:.2f}s (watchdog {watchdog}s)"
        )
        out = fut.result(timeout=60)  # typed failure absorbed by retry
        assert out["obs"].shape[0] == batch_size
        assert st.retries_total >= 1
        st.step(a).result(timeout=60)  # pool serves normally again

        assert [(e.kind, e.arg) for e in plan.events] == [
            ("proc_stop", slot)
        ], plan.events
        assert ProcFaultPlan(seed).pick(procs) == slot
        plan.verify_telemetry()  # registry counters == injected log
        return plan.summary()
    finally:
        fleet.close()


def scenario_envpool_poison(seed: int, *, procs: int = 2,
                            batch_size: int = 6) -> Dict[str, int]:
    """One env (the seeded index) raises on every step: its worker
    quarantines it after ``poison_threshold`` consecutive failures —
    masked out of the batch as a terminal transition, reported per env
    index and counted in telemetry — while the worker stays alive
    (NO death/respawn: quarantine exists so a poison env cannot
    crash-loop its worker) and the rest of the cohort keeps stepping.
    The plan injects nothing (the poison is in the env); its only
    decision is the seeded index, so the event log is empty and
    seed-identical."""
    import functools

    from ..telemetry import global_telemetry

    pname = f"envpoison{seed}"
    plan = ProcFaultPlan(seed)
    poison = plan.pick(batch_size)  # the seeded decision
    fleet = EnvFleet(
        functools.partial(ChaosStepEnv, poison=poison),
        procs=procs, batch_size=batch_size, pool_name=pname,
        poison_threshold=2,
    )
    try:
        st = fleet.stepper
        a = np.zeros(batch_size, np.int64)
        reg = global_telemetry().registry
        base_q = reg.value("envpool_quarantined_total", pool=pname) or 0

        def quarantined():
            st.step(a).result(timeout=60)
            return fleet.pool.quarantined() == (poison,)

        _await(quarantined, 30, "poison env never quarantined")
        assert _reg_delta(reg, "envpool_quarantined_total", base_q,
                          pool=pname) == 1

        # The cohort keeps training across the quarantine: healthy envs
        # advance, the poisoned row is a terminal transition every step.
        before = np.array(
            st.step(a).result(timeout=60)["episode_step"], copy=True
        )
        for _ in range(5):
            out = st.step(a).result(timeout=60)
        healthy = np.ones(batch_size, bool)
        healthy[poison] = False
        post = np.asarray(out["episode_step"])
        assert (post[healthy] == before[healthy] + 5).all(), (before, post)
        assert bool(out["done"][poison]) and post[poison] == 0, (
            f"quarantined env {poison} must read as terminal: "
            f"done={out['done'][poison]} step={post[poison]}"
        )
        # Quarantine, not crash-loop: the worker never died.
        assert (reg.value("envpool_worker_deaths_total",
                          pool=pname, kind="exit") or 0) == 0
        assert (reg.value("envpool_respawns_total", pool=pname) or 0) == 0
        assert plan.events == [], plan.events
        assert ProcFaultPlan(seed).pick(batch_size) == poison
        plan.verify_telemetry()  # trivially: nothing injected, none counted
        return plan.summary()
    finally:
        fleet.close()


def _count_ok(outcomes, lock, start):
    with lock:
        return sum(1 for k, _l, _d in outcomes[start:] if k == "ok")


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


# -- fleet tier --------------------------------------------------------------




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
    return _scale_model(params, x)


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
    "drop_storm": scenario_drop_storm,
    "partition_heal": scenario_partition_heal,
    "leader_loss": scenario_leader_loss,
    "learner_restart": scenario_learner_restart,
    "broker_failover": scenario_broker_failover,
    "straggler_quorum": scenario_straggler_quorum,
    "shm_lane_fallback": scenario_shm_lane_fallback,
    "statestore_host_loss": scenario_statestore_host_loss,
    "statestore_disk_full": scenario_statestore_disk_full,
    "statestore_bitflip": scenario_statestore_bitflip,
    "replica_kill": scenario_replica_kill,
    "router_partition": scenario_router_partition,
    "envpool_worker_kill": scenario_envpool_worker_kill,
    "envpool_wedge": scenario_envpool_wedge,
    "envpool_poison": scenario_envpool_poison,
    "fleet_controller_kill": scenario_fleet_controller_kill,
    "fleet_bad_canary": scenario_fleet_bad_canary,
    "fleet_role_crashloop": scenario_fleet_role_crashloop,
}
