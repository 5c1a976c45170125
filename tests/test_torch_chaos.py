"""Port parity: the seeded fault engine (moolib_tpu_torch.testing.chaos)
and the port's durable-state scenarios (moolib_tpu_torch.testing.
scenarios), held against the reference's.

The decision engine is pure in (seed, message sequence): the same
scripted sequence through a reference FaultPlan and a port FaultPlan with
one seed must give equal event logs and summaries (exact), for the wire
rules, the process draws and the disk rules. ChaosNet drives the port's
Rpc through its fault hooks; ProcChaos signals a pool's worker slots.
The three statestore scenarios run on the port's Accumulator, StateStore
and Replicator and must replay their injected-event logs under one seed.
Every wait has a deadline of its own.
"""

import subprocess
import threading
import time

import numpy as np
import pytest

from moolib_tpu.testing import chaos as ref_chaos
from moolib_tpu_torch.rpc import Rpc
from moolib_tpu_torch.testing import chaos
from moolib_tpu_torch.testing import scenarios

PKG = {"port": chaos, "ref": ref_chaos}


def _scripted_events(mod, seed, rules):
    """A fixed message sequence through ``mod.FaultPlan(seed)`` built by
    ``rules``; returns (events, summary)."""
    plan = rules(mod.FaultPlan(seed))
    endpoints = ["step0", "step1", "grad2", "bcast3", "@keepalive", "other"]
    for i in range(400):
        plan.decide("send" if i % 2 == 0 else "recv", "a", "bcd"[i % 3],
                    endpoints[i % len(endpoints)], i)
        if i == 200:
            plan.heal("a", "c")
            plan.heal_link("d")
            plan.blackhole_keepalive("b")
    return [tuple(e) for e in plan.events], plan.summary()


def _all_rules(plan):
    return (plan.drop("step*", p=0.4)
            .delay("grad*", 0.01, p=0.5)
            .duplicate("*", copies=2, direction="recv", p=0.2)
            .reorder("bcast*", window=0.03, direction="both", p=0.5)
            .slow_link("d", 0.2)
            .partition("a", "c"))


def _bounded_rules(plan):
    return (plan.drop("step1", after=3, count=5)
            .delay("*", 0.5, peer="c*", direction="recv", count=7)
            .duplicate("grad*", copies=1, direction="both", p=0.7))


@pytest.mark.parametrize("rules", [_all_rules, _bounded_rules],
                         ids=["all_primitives", "bounded"])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_event_log_equals_the_reference(seed, rules):
    ref = _scripted_events(ref_chaos, seed, rules)
    port = _scripted_events(chaos, seed, rules)
    assert port == ref
    assert port[0], "the script injected nothing"


def test_fault_plan_replay_identical_and_seed_sensitive():
    first = _scripted_events(chaos, 7, _all_rules)
    assert _scripted_events(chaos, 7, _all_rules) == first
    kinds = {e[1] for e in first[0]}
    assert {"drop", "delay", "duplicate", "reorder", "slow_link",
            "partitioned", "partition", "keepalive_blackhole"} <= kinds, kinds
    assert _scripted_events(chaos, 8, _all_rules) != first


@pytest.mark.parametrize("seed", [3, 31])
def test_proc_and_resource_draws_equal_the_reference(seed):
    """ProcFaultPlan.pick and ResourceFaultPlan.decide_disk over one
    scripted sequence: the same draws, verdicts and event logs."""
    def run(mod):
        plan = mod.ResourceFaultPlan(seed)
        plan.enospc("v*/c*.bin", after=1, count=2).emfile("*manifest*")
        picks = [plan.pick(n) for n in (3, 7, 1000, 2, 64)]
        verdicts = []
        for i in range(6):
            for op, path in (("write", f"v{i:012d}/c000000.bin"),
                             ("open", f"v{i:012d}/manifest.json"),
                             ("fsync", "root")):
                e = plan.decide_disk(op, path)
                verdicts.append(None if e is None
                                else (e.errno, e.statestore_op))
        return picks, verdicts, [tuple(e) for e in plan.events], \
            plan.summary()

    assert run(chaos) == run(ref_chaos)


class _FakePool:
    def __init__(self, procs):
        self._procs = procs


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_proc_chaos_signals_slots_and_logs_like_the_reference(pkg):
    mod = PKG[pkg]
    procs = [subprocess.Popen(["sleep", "30"]) for _ in range(3)]
    try:
        plan = mod.ProcFaultPlan(31)
        pc = mod.ProcChaos(plan, _FakePool(procs))
        picks = [plan.pick(3) for _ in range(3)]
        pc.wedge(picks[0])
        pc.resume(picks[0])
        pc.kill(picks[2])
        assert procs[picks[2]].wait(timeout=10) == -9
        plan.verify_telemetry()
        log = [(e.kind, e.action, e.peer, e.arg) for e in plan.events]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ref_plan = ref_chaos.ProcFaultPlan(31)
    assert picks == [ref_plan.pick(3) for _ in range(3)]
    assert log == [("proc_stop", "stop", f"worker{picks[0]}", picks[0]),
                   ("proc_cont", "cont", f"worker{picks[0]}", picks[0]),
                   ("proc_kill", "kill", f"worker{picks[2]}", picks[2])]


def test_resource_chaos_relativizes_staged_paths(tmp_path):
    """A rule written against the committed layout hits the staged write
    of that file, and nothing outside the store's root."""
    from moolib_tpu_torch.statestore import bundle
    from moolib_tpu_torch.utils import diskio

    root = str(tmp_path / "store")
    plan = chaos.ResourceFaultPlan(5).enospc("v*/c000001.bin", count=1)
    chunks = bundle.chunk_blob(bundle.encode_state(
        {"w": np.arange(100, dtype=np.float32)}), 128)
    m = bundle.manifest_for(4, chunks)
    with chaos.ResourceChaos(plan, root=root):
        diskio.write_file_atomic(str(tmp_path / "elsewhere.bin"), b"x")
        with pytest.raises(OSError) as ei:
            bundle.write_version(root, 4, m, chunks)
    assert ei.value.errno == 28 and ei.value.statestore_op == "write"
    assert bundle.list_versions(root) == []
    assert [(e.kind, e.arg) for e in plan.events] == [
        ("enospc", "c000001.bin")]
    bundle.write_version(root, 4, m, chunks)  # the hook is gone
    assert bundle.list_versions(root) == [4]


def _echo_pair(tag):
    server, client = Rpc(f"chaos-srv-{tag}"), Rpc(f"chaos-cli-{tag}")
    server.listen("127.0.0.1:0")
    calls = []
    lock = threading.Lock()

    def work(x):
        with lock:
            calls.append(x)
        return x * 2

    server.define("work", work)
    client.connect(server.debug_info()["listen"][0])
    return server, client, calls


def test_chaos_net_drop_storm_loses_and_repeats_no_call():
    """Seeded loss on the request and the response endpoint of the
    port's Rpc: every call completes with the right answer and every
    request executes exactly once (poke/NACK resend, response replay)."""
    server, client, calls = _echo_pair("drop")
    plan = chaos.FaultPlan(31).drop("work", p=0.3).drop(
        "@success", direction="send", p=0.3)
    try:
        with chaos.ChaosNet(plan, [client, server]):
            got = [client.async_(server.get_name(), "work", i)
                   .result(timeout=60) for i in range(20)]
        assert got == [2 * i for i in range(20)]
        assert sorted(calls) == list(range(20)), calls
        assert plan.summary().get("drop", 0) >= 1, plan.summary()
        plan.verify_telemetry()
    finally:
        client.close()
        server.close()


def test_chaos_net_duplicate_delivery_runs_the_handler_once():
    server, client, calls = _echo_pair("dup")
    plan = chaos.FaultPlan(2).duplicate("work", copies=2, count=1)
    try:
        with chaos.ChaosNet(plan, [client, server]):
            assert client.async_(server.get_name(), "work", 21).result(
                timeout=30) == 42
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline and len(calls) < 2:
                time.sleep(0.02)  # a second run would land by now
        assert calls == [21]
        assert [(e.kind, e.endpoint) for e in plan.events] == [
            ("duplicate", "work")]
    finally:
        client.close()
        server.close()


def test_chaos_net_kill_conns_logs_and_the_call_resends():
    server, client, _calls = _echo_pair("kill")
    plan = chaos.FaultPlan(4)
    try:
        with chaos.ChaosNet(plan, [client, server]) as net:
            assert client.async_(server.get_name(), "work", 1).result(
                timeout=30) == 2
            assert net.kill_conns(client, server.get_name()) >= 1
            assert client.async_(server.get_name(), "work", 5).result(
                timeout=30) == 10
        assert [e.kind for e in plan.events] == ["conn_kill"]
        assert net.endpoint_name(123456789) == "fid:123456789"
    finally:
        client.close()
        server.close()


# -- the durable-state scenarios: seed replay ---------------------------------

_SS_PINNED = {"statestore_host_loss": (909, {"conn_kill": 1}),
              "statestore_bitflip": (1111, {})}


@pytest.mark.parametrize("name", sorted(_SS_PINNED))
def test_statestore_scenario_replays_its_pinned_log(name, tmp_path):
    """The injected-event log is the reference test's pinned one, on two
    runs of one seed."""
    seed, want = _SS_PINNED[name]
    fn = scenarios.SCENARIOS[name]
    assert fn(seed, tmpdir=str(tmp_path)) == want
    assert fn(seed, tmpdir=str(tmp_path)) == want


def test_statestore_disk_full_scenario_replays_its_kinds(tmp_path):
    """ENOSPC fire counts follow the cohort's cadence (as in the
    reference), so two runs of one seed pin the kinds."""
    fn = scenarios.scenario_statestore_disk_full
    for _ in range(2):
        summary = fn(1010, tmpdir=str(tmp_path))
        assert set(summary) == {"enospc"} and summary["enospc"] >= 1, summary


def test_bitflip_corruption_target_equals_the_reference():
    """The bit-flip scenario's seeded target draw (holder, chunk, byte)
    is the reference's for the same seed."""
    for seed in (1111, 5):
        port, ref = chaos.ResourceFaultPlan(seed), \
            ref_chaos.ResourceFaultPlan(seed)
        assert [port.pick(n) for n in (9, 256, 4)] == \
            [ref.pick(n) for n in (9, 256, 4)]


def test_scenarios_registry_holds_the_ported_six():
    """The port's registry holds every scenario of the reference's, in
    its order (the soak runs them sorted; the order is the reference's
    grouping by tier)."""
    from moolib_tpu.testing.scenarios import SCENARIOS as REF
    from moolib_tpu_torch.testing import SCENARIOS

    assert list(SCENARIOS) == list(REF)
    assert len(SCENARIOS) == 18
