"""Port parity: the fleet tier (moolib_tpu_torch.fleet), held against the
reference's (moolib_tpu.fleet).

- FleetSpec: the same JSON text as the reference's for the same spec, a
  reference spec's JSON parses into the port's equal value and back, and
  bad fields are refused with the reference's messages (exact).
- ``from_fleet_spec`` of the port's A2CConfig and VtraceConfig gives the
  reference's fields.
- The controller on the port's Rpc, Replica and Router, serving the
  numpy toy model on the CPU (``device="cpu"``): the epoch fence, the
  subprocess backend (``python -m moolib_tpu_torch.fleet.runner``, whose
  replica descriptor must name its device), a rollout under load, the
  durable rollback out of the port's StateStore and
  ``publish_from_statestore``.
- The three fleet chaos scenarios replay the reference test's pinned
  injected-event logs on two runs of one seed.

Every wait has a deadline of its own.
"""

import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from moolib_tpu import fleet as ref_fleet
from moolib_tpu_torch import fleet
from moolib_tpu_torch.fleet import (AdoptError, Controller, FleetSpec,
                                    RolloutError)
from moolib_tpu_torch.testing import scenarios
from moolib_tpu_torch.testing.scenarios import (FleetHarness, _await,
                                                _fleet_model, _p99, _run_load)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _specs(mod):
    small = mod.FleetSpec.small
    return {
        "small": small(),
        "sized": small(replicas=3, routers=1, learners=2, env_workers=4,
                       settle_s=2.5),
        "full": dataclasses.replace(
            small(learners=3, env_workers=4, name="prod"),
            learners=mod.LearnerSpec(n=3, min_quorum=2,
                                     straggler_timeout_s=1.5, group="g1"),
            broker=mod.BrokerSpec(standbys=1),
            statestore=mod.StateStoreSpec(replication=2),
            rollout=mod.RolloutSpec(reward_min=0.5, p99_ratio_max=2.0)),
        "default": mod.FleetSpec(),
    }


@pytest.mark.parametrize("name", sorted(_specs(fleet)))
def test_spec_json_equals_the_reference_and_round_trips(name):
    port, ref = _specs(fleet)[name], _specs(ref_fleet)[name]
    assert port.to_json() == ref.to_json()
    assert FleetSpec.from_json(ref.to_json()) == port
    assert ref_fleet.FleetSpec.from_json(port.to_json()) == ref
    assert FleetSpec.from_json(port.to_json()).to_json() == port.to_json()
    assert port.n_roles() == ref.n_roles()


_BAD = [
    ("learners", "LearnerSpec", dict(n=2, min_quorum=5)),
    ("serving", "ServingSpec", dict(replicas=0, routers=1)),
    ("serving", "ServingSpec", dict(replicas=1, batch_size=0)),
    ("supervision", "SupervisionSpec", dict(probe_misses=0)),
    ("supervision", "SupervisionSpec", dict(backoff_base_s=1.0,
                                            backoff_cap_s=0.1)),
    ("rollout", "RolloutSpec", dict(canary_weight=1.5)),
    ("rollout", "RolloutSpec", dict(error_rate_max=2.0)),
    ("env_workers", "EnvSpec", dict(n=-1)),
]


@pytest.mark.parametrize("section,cls,kw", _BAD,
                         ids=[f"{s}-{i}" for i, (s, _c, _k) in enumerate(_BAD)])
def test_bad_fields_refused_with_the_reference_message(section, cls, kw):
    msgs = []
    for mod in (fleet, ref_fleet):
        with pytest.raises(mod.SpecError) as ei:
            dataclasses.replace(mod.FleetSpec.small(),
                                **{section: getattr(mod, cls)(**kw)})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and msgs[0].startswith(section), msgs


def test_unknown_json_field_refused_like_the_reference():
    text = FleetSpec.small().to_json().replace('"canary_weight"',
                                               '"cannary_weight"')
    msgs = []
    for mod in (fleet, ref_fleet):
        with pytest.raises(mod.SpecError) as ei:
            mod.FleetSpec.from_json(text)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "canary_weight" in msgs[0]


def test_example_configs_from_fleet_spec_equal_the_reference():
    from moolib_tpu.examples.a2c import A2CConfig as RefA2C
    from moolib_tpu.examples.vtrace.experiment import VtraceConfig as RefVt
    from moolib_tpu_torch.examples.a2c import A2CConfig
    from moolib_tpu_torch.examples.vtrace.experiment import VtraceConfig

    port, ref = _specs(fleet)["full"], _specs(ref_fleet)["full"]
    a2c = A2CConfig.from_fleet_spec(port, total_steps=100)
    want = RefA2C.from_fleet_spec(ref, total_steps=100)
    keys = ("num_processes", "min_quorum", "straggler_timeout", "group",
            "total_steps")
    assert [getattr(a2c, k) for k in keys] == [getattr(want, k)
                                              for k in keys]
    assert [getattr(a2c, k) for k in keys] == [4, 2, 1.5, "g1", 100]
    vt, vt_ref = VtraceConfig.from_fleet_spec(port), RefVt.from_fleet_spec(ref)
    keys = ("num_actor_processes", "min_quorum", "straggler_timeout",
            "group")
    assert [getattr(vt, k) for k in keys] == [getattr(vt_ref, k)
                                             for k in keys]
    assert VtraceConfig.from_fleet_spec(FleetSpec.small(
        env_workers=0)).num_actor_processes == 1


def test_second_materialize_refused_and_double_adopt_noop():
    spec = FleetSpec.small(replicas=2, routers=1, learners=0, env_workers=0)
    primary = Controller(spec, name="ctl0", device="cpu")
    primary.materialize()
    standby = Controller(spec, cohort=primary.cohort, name="ctl1",
                         standby=True, failover_after_s=3600.0, device="cpu")
    try:
        rival = Controller(spec, name="rival", cohort=primary.cohort,
                           device="cpu")
        with pytest.raises(AdoptError):
            rival.materialize()
        rival.close()
        primary.kill()
        first = standby.adopt()
        assert first["already"] is False and first["epoch"] == 2
        assert standby.adopt() == {"already": True, "epoch": 2}
        assert standby.status()["fenced"]
        with pytest.raises(AdoptError):
            primary.start_rollout(params={"scale": 1.0}, version=3)
        _await(lambda: len(standby.router().routable()) >= 2, 15.0,
               "routers lost the replicas across adoption")
        assert float(standby.router().infer(
            np.ones(4, np.float32))[0]) == 2.0
    finally:
        standby.close()
        primary.close(close_roles=True)


def test_replicas_serve_on_the_card_unless_asked():
    """Without a device the in-process replicas need the card; here
    there is none, so materialize raises instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is right")
    spec = FleetSpec.small(replicas=1, routers=0, learners=0, env_workers=0)
    ctl = Controller(spec, name="nodev")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctl.materialize()
    finally:
        ctl.close(close_roles=True)


def test_subprocess_backend_spawns_real_processes():
    spec = FleetSpec.small(replicas=1, routers=1, learners=0, env_workers=0)
    ctl = Controller(spec, backend="subprocess", device="cpu")
    try:
        ctl.materialize()
        st = ctl.status()["roles"]
        assert st[f"{spec.name}-broker0"]["backend"] == "subprocess"
        assert st[f"{spec.name}-rep0"]["backend"] == "subprocess"
        assert st[f"{spec.name}-router0"]["backend"] == "in_process"
        with ctl.cohort.lock:
            procs = [h.proc for h in ctl.cohort.roles.values()
                     if h.backend == "subprocess"]
        assert len(procs) == 2 and all(p.poll() is None for p in procs)
        _await(lambda: len(ctl.router().routable()) >= 1, 30.0,
               "subprocess replica never became routable")
        assert float(ctl.router().infer(np.ones(4, np.float32))[0]) == 2.0
    finally:
        ctl.close(close_roles=True)


@pytest.mark.parametrize("desc,why", [
    ({"name": "r", "kind": "replica"}, "must name its device"),
    ({"name": "r", "kind": "replica", "device": None}, "no CUDA device"),
])
def test_runner_neither_guesses_nor_falls_back(desc, why):
    import torch

    if torch.cuda.is_available() and desc.get("device", 1) is None:
        pytest.skip("this machine has a card: null names it")
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.fleet.runner", "--role",
         json.dumps(desc)], cwd=str(REPO_ROOT), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "FLEET_ADDR" not in proc.stdout
    assert why in proc.stderr, proc.stderr[-2000:]


def test_zero_downtime_rollout_under_load():
    spec = FleetSpec.small(replicas=3, routers=1, settle_s=1.5)
    harness = FleetHarness(spec, standby=False, model=_fleet_model,
                           params={"scale": np.float32(2.0)}, device="cpu")
    lock = threading.Lock()
    try:
        harness.wait_routable(3)
        pre: list = []
        for t in _run_load(harness.router, 120, 4, 8.0, pre, lock):
            t.join(timeout=60)
            assert not t.is_alive(), "pre-roll load worker hung"
        assert all(k == "ok" for k, _l, _v in pre), pre[:3]
        p99_pre = _p99([lat for _k, lat, _v in pre])
        ctl = harness.controller
        ctl.publish_model({"scale": np.float32(3.0)}, 2)
        rollout = ctl.start_rollout(version=2, wait=False)
        _await(lambda: rollout.state == "settling", 10.0,
               "rollout never reached settling")
        during: list = []
        threads = _run_load(harness.router, 240, 4, 8.0, during, lock)
        _await(lambda: rollout.state in ("promoted", "rolled_back"),
               spec.rollout.settle_s + 15.0,
               "rollout never reached a terminal state")
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "mid-roll load worker hung"
        assert rollout.state == "promoted", rollout.state
        assert not [r for r in during if r[0] != "ok"], during[:3]
        bound = 3.0 * max(p99_pre, 0.1)
        assert _p99([lat for _k, lat, _v in during]) <= bound
        for i in range(3):
            assert harness.handle(f"{spec.name}-rep{i}").obj.version == 2
        assert harness.router.canary() == (frozenset(), 0.0)
        assert ctl.status()["current_version"] == 2
    finally:
        harness.close()


def test_rollback_from_the_statestore_and_publish_from_statestore(tmp_path):
    from moolib_tpu_torch.serving import publish_from_statestore
    from moolib_tpu_torch.statestore import StateStore, StateStoreError

    spec = FleetSpec.small(replicas=3, routers=1, settle_s=3.0)
    v1 = {"scale": np.float32(2.0)}
    harness = FleetHarness(spec, standby=False, model=_fleet_model,
                           params=v1, incident_dir=str(tmp_path / "inc"),
                           device="cpu")
    store = StateStore(str(tmp_path / "store"), harness.controller.rpc)
    lock = threading.Lock()
    try:
        harness.wait_routable(3)
        with pytest.raises(StateStoreError):
            publish_from_statestore(harness.router, store)
        store.put(1, v1)
        rollout = harness.controller.start_rollout(
            params={"scale": np.float32(9.0), "poison": True}, version=2,
            wait=False, store=store)
        _await(lambda: rollout.state == "settling", 10.0,
               "rollout never reached settling")
        outcomes: list = []
        threads = _run_load(harness.router, 160, 4, 8.0, outcomes, lock)
        _await(lambda: rollout.state in ("promoted", "rolled_back"),
               spec.rollout.settle_s + 15.0,
               "rollout never reached a terminal state")
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "load worker hung across rollback"
        assert rollout.state == "rolled_back", rollout.state
        assert rollout.breach["gate"] == "error_rate"
        assert not [r for r in outcomes if r[0] != "ok"], outcomes[:3]
        for i in range(3):
            assert harness.handle(f"{spec.name}-rep{i}").obj.version == 1
            assert float(harness.router.infer(
                np.ones(4, np.float32))[0]) == 2.0
        from moolib_tpu_torch.flightrec import load_bundle

        assert load_bundle(rollout.incident_path)["trigger"]["kind"] == \
            "fleet_rollback"
        store.put(3, {"scale": np.float32(5.0)})
        v, acks = publish_from_statestore(harness.router, store)
        assert v == 3 and all(acks.values()), (v, acks)
        assert float(harness.router.infer(np.ones(4, np.float32))[0]) == 5.0
        v, acks = publish_from_statestore(harness.router, store, version=1)
        assert v == 1 and all(acks.values()), (v, acks)
    finally:
        store.close()
        harness.close()


def test_rollout_refuses_to_canary_the_whole_fleet():
    spec = FleetSpec.small(replicas=1, routers=1, learners=0, env_workers=0)
    harness = FleetHarness(spec, standby=False, device="cpu")
    try:
        harness.wait_routable(1)
        with pytest.raises(RolloutError, match="whole routable fleet"):
            harness.controller.start_rollout(params={"scale": 1.0},
                                             version=2)
    finally:
        harness.close()


_PINNED = {"fleet_controller_kill": (301, {"conn_kill": 1}),
           "fleet_bad_canary": (302, {}),
           "fleet_role_crashloop": (303, {"conn_kill": 3})}


@pytest.mark.parametrize("name", sorted(_PINNED))
def test_fleet_scenario_replays_its_pinned_log(name):
    seed, want = _PINNED[name]
    fn = scenarios.SCENARIOS[name]
    assert fn(seed, device="cpu") == want
    assert fn(seed, device="cpu") == want


def test_default_model_scales_on_the_requests_device():
    """The Controller's default model (a fleet built without one, as the
    perf suite's fleet_rollout_s row builds it) multiplies on the
    request's device: a published scale arrives as a 0-d numpy array,
    and ``tensor * ndarray`` reads a card tensor back to the host (a
    meta tensor stands in for one: it has no host copy either)."""
    import torch

    from moolib_tpu_torch.fleet.controller import default_model

    model, params = default_model()
    x = torch.ones(4, device="meta")
    scale = np.array(3.0, np.float32)
    with pytest.raises((TypeError, NotImplementedError)):
        x * scale  # noqa: B018
    out = model({"scale": scale}, x)
    assert out.device == x.device and out.dtype == torch.float32
    assert torch.equal(model(params, torch.ones(2)), torch.full((2,), 2.0))
    assert torch.equal(model({"scale": scale}, torch.ones(2)),
                       torch.full((2,), 3.0))
