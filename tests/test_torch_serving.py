"""Port parity: the acting step, batch staging, nest, admission control and
the serving Replica of moolib_tpu_torch, and their telemetry.

The act step's logits are held against the reference's jitted act step;
its samples cannot match the reference's bits, so their frequencies are
held against softmax(logits). The Replica is driven through its local
submit() path (the RPC binding is not ported yet) and its replies are
held against the direct forward. The admission and replica cases mirror
the tests/test_serving.py cases that need no RPC. The admission queue's
``serving_*`` series are held to the reference's exactly (equal
snapshots after the same sequence of calls).
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.learner import make_act_step as jax_make_act_step
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.serving.admission import AdmissionQueue as JaxAdmissionQueue
from moolib_tpu.telemetry import Telemetry as JaxTelemetry
from moolib_tpu.utils import nest as jax_nest
from moolib_tpu_torch import make_act_step
from moolib_tpu_torch.models import TransformerNet, transformer_params_from_flax
from moolib_tpu_torch.ops import stage_batch
from moolib_tpu_torch.serving import (
    AdmissionQueue,
    DeadlineExceeded,
    Overloaded,
    Replica,
    RpcError,
    error_kind,
)
from moolib_tpu_torch.telemetry import (
    Telemetry,
    global_telemetry,
    summarize_stepscope,
)
from moolib_tpu_torch.utils import nest

SMALL = dict(d_model=32, num_layers=2, num_heads=2)


def _net(seed=0, num_actions=4):
    return TransformerNet(num_actions, (5,), attention_backend="flash",
                          device="cpu",
                          generator=torch.Generator().manual_seed(seed),
                          **SMALL)


# ---------------------------------------------------------------------------
# Acting step
# ---------------------------------------------------------------------------


def test_act_step_logits_match_reference():
    rng = np.random.default_rng(0)
    B = 6
    obs = rng.standard_normal((B, 5)).astype(np.float32)
    done = rng.random(B) < 0.5
    jnet = JaxTransformerNet(num_actions=4, attention_backend="dense",
                             **SMALL)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs[None]),
                       jnp.asarray(done[None]), ())
    _a, jlogits, _ = jax_make_act_step(jnet.apply, temperature=0.5)(
        params, jax.random.PRNGKey(1), jnp.asarray(obs), jnp.asarray(done),
        (),
    )
    net = _net()
    net.load_state_dict(transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    act = make_act_step(net, temperature=0.5)
    actions, logits, state = act(torch.from_numpy(obs),
                                 torch.from_numpy(done), (),
                                 torch.Generator().manual_seed(0))
    assert actions.shape == (B,) and actions.dtype == torch.int64
    assert state == ()
    np.testing.assert_allclose(np.asarray(jlogits), logits.numpy(),
                               atol=1e-4)


def test_act_step_sample_frequencies_follow_softmax():
    """Many lanes with one observation: the action frequencies follow
    softmax(logits / temperature). 8000 draws put each frequency within
    about 0.006 (one standard deviation) of its probability; 0.03 is
    five of them."""
    n = 8000
    obs = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 5)).astype(np.float32)
    ).expand(n, 5)
    act = make_act_step(_net(seed=3), temperature=0.7)
    gen = torch.Generator().manual_seed(5)
    actions, logits, _ = act(obs, torch.zeros(n, dtype=torch.bool), (), gen)
    probs = torch.softmax(logits[0], dim=-1).numpy()
    freq = np.bincount(actions.numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, probs, atol=0.03)
    # The generator alone decides the draws.
    again, _, _ = act(obs, torch.zeros(n, dtype=torch.bool), (),
                      torch.Generator().manual_seed(5))
    assert torch.equal(actions, again)


# ---------------------------------------------------------------------------
# nest and staging
# ---------------------------------------------------------------------------


def test_nest_matches_reference():
    rng = np.random.default_rng(2)
    trees = [
        {"obs": rng.standard_normal((3, 2)),
         "meta": (rng.integers(0, 9, 4), np.float64(rng.random()))}
        for _ in range(5)
    ]
    ours, ref = nest.stack_fields(trees), jax_nest.stack_fields(trees)
    for a, b in zip(nest.flatten(ours), jax_nest.flatten(ref)):
        np.testing.assert_array_equal(a, np.asarray(b))
    sliced = nest.slice_fields(ours, 1, 3)
    assert sliced["obs"].shape == (2, 3, 2)
    back = nest.unstack_fields(ours, 5)
    for a, b in zip(back, trees):
        for x, y in zip(nest.flatten(a), nest.flatten(b)):
            np.testing.assert_array_equal(x, y)
    tensors = nest.map_structure(torch.from_numpy, [t["obs"] for t in trees])
    stacked = nest.stack_fields(tensors)
    assert isinstance(stacked, torch.Tensor) and stacked.shape == (5, 3, 2)
    with pytest.raises(ValueError, match="batch_size"):
        nest.unstack_fields(ours, 4)


def test_stage_batch_cpu():
    batch = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]}
    staged = stage_batch(batch, "cpu")
    assert isinstance(staged["x"], torch.Tensor)
    np.testing.assert_array_equal(staged["x"].numpy(), batch["x"])


# ---------------------------------------------------------------------------
# Admission control (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_admission_overloaded_at_capacity():
    q = AdmissionQueue(3, service="t_cap")
    for i in range(3):
        q.admit(i)
    with pytest.raises(Overloaded, match="capacity"):
        q.admit(99)
    serve, shed = q.get_batch(8)
    assert serve == [0, 1, 2] and shed == []
    q.admit(3)
    q.done(3)
    q.close()


def test_admission_shed_order_under_deadline_pressure():
    q = AdmissionQueue(16, service="t_shed")
    now = time.monotonic()
    assert not q.would_shed(now + 0.001)
    q.admit("early-tight", deadline=now + 0.0005)
    serve, shed = q.get_batch(8)
    assert serve == ["early-tight"] and shed == []
    q.done(1, service_seconds_per_item=0.2)  # p50 is now ~200ms
    with pytest.raises(DeadlineExceeded, match="p50"):
        q.admit("tight", deadline=time.monotonic() + 0.01)
    now = time.monotonic()
    q.admit("a-tight", deadline=now + 0.25)
    q.admit("b-ok", deadline=now + 60.0)
    q.admit("c-tight", deadline=now + 0.26)
    q.admit("d-no-deadline")
    time.sleep(0.12)  # burn a-tight/c-tight below the 0.2s estimate
    serve, shed = q.get_batch(8)
    assert shed == ["a-tight", "c-tight"], shed
    assert serve == ["b-ok", "d-no-deadline"], serve
    q.fail(len(shed))
    q.done(len(serve), service_seconds_per_item=0.2)
    assert q.inflight == 0
    q.close()


def test_admission_drain_completes_admitted_work():
    q = AdmissionQueue(16, service="t_drain")
    for i in range(6):
        q.admit(i)
    done = []

    def consumer():
        while True:
            serve, _shed = q.get_batch(2, timeout=1.0)
            if not serve:
                return
            time.sleep(0.02)  # admitted work takes real time
            done.extend(serve)
            q.done(len(serve))

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    assert q.drain(timeout=10.0), "drain never completed"
    assert sorted(done) == list(range(6)), "drain dropped admitted work"
    with pytest.raises(Overloaded, match="draining"):
        q.admit(99)
    t.join(timeout=5)
    assert not t.is_alive()
    q.close()


def test_drain_interrupted_by_close_reports_false():
    q = AdmissionQueue(8, service="t_dc")
    q.admit("a")
    q.admit("b")
    got = {}

    def drainer():
        got["ok"] = q.drain(timeout=10.0)

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    time.sleep(0.1)  # drain is parked on the non-empty queue
    q.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["ok"] is False


def test_error_kind_classification():
    assert error_kind(Overloaded("x")) == "overloaded"
    assert error_kind(DeadlineExceeded("x")) == "deadline"
    assert error_kind(RpcError("Overloaded: queue full")) == "overloaded"
    assert error_kind(RpcError("DeadlineExceeded: shed")) == "deadline"
    assert error_kind(RpcError(
        "request expired in the server queue 'q' before service"
    )) == "deadline"
    assert error_kind(RpcError("no route to rep0 for 'serve.infer'")) \
        == "conn"
    assert error_kind(RpcError("call to rep0::serve.infer timed out")) \
        == "timeout"
    assert error_kind(RpcError("function 'f' not found on 'rep0'")) \
        == "not_found"
    assert error_kind(RpcError("ValueError: boom")) == "other"


# ---------------------------------------------------------------------------
# Replica
# ---------------------------------------------------------------------------


def _forward(net, batch):
    """Context service: batch of [T] windows -> per-step logits/baseline."""
    obs = batch["obs"].transpose(0, 1)
    done = batch["done"].transpose(0, 1)
    (logits, baseline), _ = net(obs, done, ())
    return {"logits": logits.transpose(0, 1),
            "baseline": baseline.transpose(0, 1)}


@pytest.mark.parametrize("n_requests", [3, 6])
def test_replica_replies_match_direct_forward(n_requests):
    """3 requests fill a padded batch of 4; 6 take a full batch and a
    padded one."""
    rng = np.random.default_rng(4)
    net = _net(seed=1)
    reqs = [{"obs": rng.standard_normal((8, 5)).astype(np.float32),
             "done": rng.random(8) < 0.2} for _ in range(n_requests)]
    with Replica(None, _forward, net, batch_size=4, pad=True,
                 linger_s=0.05, device="cpu") as rep:
        futs = [rep.submit(r) for r in reqs]
        replies = [f.result(timeout=30) for f in futs]
    for req, rep_out in zip(reqs, replies):
        with torch.no_grad():
            (logits, baseline), _ = net(
                torch.from_numpy(req["obs"][:, None]),
                torch.from_numpy(req["done"][:, None]), ())
        assert rep_out["logits"].shape == (8, 4)
        np.testing.assert_allclose(rep_out["logits"], logits[:, 0].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(rep_out["baseline"],
                                   baseline[:, 0].numpy(), atol=1e-5)


def test_replica_serves_act_step():
    rng = np.random.default_rng(5)
    net = _net(seed=2)
    act = make_act_step(net)
    gen = torch.Generator().manual_seed(0)

    def act_fn(model, batch):
        n, envs = batch["done"].shape
        actions, logits, _ = act(batch["obs"].reshape(n * envs, 5),
                                 batch["done"].reshape(n * envs), (), gen)
        return {"action": actions.reshape(n, envs),
                "logits": logits.reshape(n, envs, -1)}

    reqs = [{"obs": rng.standard_normal((3, 5)).astype(np.float32),
             "done": np.zeros(3, bool)} for _ in range(2)]
    with Replica(None, act_fn, net, batch_size=4, pad=True,
                 device="cpu") as rep:
        replies = [rep.submit(r).result(timeout=30) for r in reqs]
    for req, out in zip(reqs, replies):
        _a, logits, _ = act(torch.from_numpy(req["obs"]),
                            torch.from_numpy(req["done"]), (), gen)
        np.testing.assert_allclose(out["logits"], logits.numpy(), atol=1e-5)
        assert out["action"].shape == (3,)
        assert ((out["action"] >= 0) & (out["action"] < 4)).all()


def test_replica_overloaded_is_explicit():
    block = threading.Event()

    def slow_model(_p, x):
        block.wait(10.0)
        return x

    rep = Replica(None, slow_model, None, batch_size=1, max_queue=2,
                  device="cpu")
    try:
        x = np.ones(2, np.float32)
        first = rep.submit(x)
        deadline = time.monotonic() + 10
        while rep.admission.inflight < 1:  # first request in service
            assert time.monotonic() < deadline
            time.sleep(0.01)
        queued = [rep.submit(x) for _ in range(2)]
        with pytest.raises(RpcError, match="Overloaded"):
            rep.submit(x).result(timeout=5)
        block.set()
        for f in [first, *queued]:
            np.testing.assert_allclose(f.result(timeout=10), 1.0)
    finally:
        block.set()
        rep.close()


def test_replica_deadline_shed_and_drain():
    rep = Replica(None, lambda _p, x: x * 2, None, batch_size=2,
                  device="cpu")
    try:
        x = np.ones(3, np.float32)
        np.testing.assert_allclose(rep.submit(x).result(timeout=10), 2.0)
        rep.admission.done(0, service_seconds_per_item=5.0)  # p50 evidence
        with pytest.raises(RpcError, match="DeadlineExceeded"):
            rep.submit(x, deadline=time.monotonic() + 0.01).result(timeout=5)
        futs = [rep.submit(x) for _ in range(5)]
        assert rep.drain(timeout=10.0)
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=1), 2.0)
        with pytest.raises(RpcError, match="Overloaded"):
            rep.submit(x).result(timeout=5)
        assert rep.health()["draining"] is True
    finally:
        rep.close()


def test_replica_set_model_swaps_between_batches():
    def model_fn(scale, x):
        return x * scale

    with Replica(None, model_fn, 1.0, batch_size=1, device="cpu") as rep:
        x = np.ones(2, np.float32)
        np.testing.assert_allclose(rep.submit(x).result(timeout=10), 1.0)
        rep.set_model(3.0, version=7)
        assert rep.version == 7 and rep.health()["model_version"] == 7
        np.testing.assert_allclose(rep.submit(x).result(timeout=10), 3.0)


# ---------------------------------------------------------------------------
# Telemetry of the serving tier
# ---------------------------------------------------------------------------


def _admission_sequence(queue_cls, tel_cls):
    """One admit/get_batch/done/fail/shed/drain sequence with explicit
    service times; returns (snapshot before close, snapshot after close,
    flight events without their stamps)."""
    tel = tel_cls("q", enabled=True)
    q = queue_cls(4, service="svc", peer="p0", telemetry=tel)
    for i in range(4):
        q.admit(i)
    with pytest.raises(Exception, match="capacity"):  # each's Overloaded
        q.admit(99)
    serve, shed = q.get_batch(3)
    assert (serve, shed) == ([0, 1, 2], [])
    q.done(2, service_seconds_per_item=0.004)
    q.fail(1)
    serve, _ = q.get_batch(3)
    q.done(len(serve), service_seconds_per_item=2.0)
    # p50 is now 2s: a 1s budget is shed at the door, and an entry
    # admitted with 3s of budget is shed in the queue once p50 is 100s.
    with pytest.raises(Exception, match="p50"):
        q.admit("tight", deadline=time.monotonic() + 1.0)
    q.admit("late", deadline=time.monotonic() + 3.0)
    q.admit("ok")
    for _ in range(4):
        q.done(0, service_seconds_per_item=100.0)  # the estimator only
    serve, shed = q.get_batch(4)
    assert (serve, shed) == (["ok"], ["late"])
    q.fail(1, shed=True)
    q.done(1, service_seconds_per_item=0.5)
    assert q.drain(timeout=1.0)
    with pytest.raises(Exception, match="draining"):
        q.admit("x")
    before = tel.snapshot()
    q.close()
    q.close()  # idempotent
    events = [{k: v for k, v in e.items() if k != "ts_us"}
              for e in tel.flight.events()]
    return before, tel.snapshot(), events


def test_admission_counters_match_reference():
    ref = _admission_sequence(JaxAdmissionQueue, JaxTelemetry)
    port = _admission_sequence(AdmissionQueue, Telemetry)
    assert json.dumps(port[0]) == json.dumps(ref[0])
    assert json.dumps(port[1]) == json.dumps(ref[1])
    assert port[2] == ref[2]
    snap = port[0]
    counts = {sid: v["value"] for sid, v in snap.items()
              if v["type"] == "counter"}
    assert counts == {
        'serving_admitted_total{service="svc"}': 6.0,
        'serving_completed_total{service="svc"}': 4.0,
        'serving_drained_total{service="svc"}': 1.0,
        'serving_failed_total{service="svc"}': 1.0,
        'serving_rejected_total{reason="capacity",service="svc"}': 1.0,
        'serving_rejected_total{reason="draining",service="svc"}': 1.0,
        'serving_shed_total{service="svc"}': 2.0,
        "trace_spans_dropped_total": 0.0,
    }
    assert snap['serving_service_seconds{service="svc"}']["count"] == 4
    assert snap['serving_queue_depth{peer="p0",service="svc"}'][
        "value"] == 0.0
    # close() unregisters the depth gauge; the counters stay.
    assert not any(sid.startswith("serving_queue_depth") for sid in port[1])
    assert [e["kind"] for e in port[2]] == ["serving_shed", "serving_shed",
                                           "serving_drain"]


def _serve_n(rep, n):
    x = np.ones(3, np.float32)
    futs = [rep.submit(x * i) for i in range(n)]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30), 2.0 * i)


def test_replica_records_serving_series_and_replica_steps():
    """Replica(rpc=None) on the CPU: every request admitted and completed,
    batch rows and fill, the model version, and one {service}_replica
    step (queue_wait, linger, infer) per served batch."""
    tel = Telemetry("rep")
    n = 7
    rep = Replica(None, lambda _p, x: x * 2, None, service="echo",
                  batch_size=4, linger_s=0.05, device="cpu", telemetry=tel,
                  version=3)
    try:
        _serve_n(rep, n)
        rep.set_model(None, version=5)
    finally:
        rep.close()  # joins the worker: every count is in
    snap = tel.snapshot()

    def value(name):
        return snap[f'{name}{{service="echo"}}']["value"]

    assert value("serving_admitted_total") == n
    assert value("serving_completed_total") == n
    assert value("serving_batch_rows_total") == n
    assert value("serving_model_version") == 5
    assert snap['serving_shed_total{service="echo"}']["value"] == 0
    batches = value("serving_batches_total")
    fill = snap['serving_batch_fill_fraction{service="echo"}']
    assert fill["edges"] == [i / 8 for i in range(1, 9)]
    assert fill["count"] == batches and 2 <= batches <= n
    assert fill["sum"] * 4 == n  # rows over the batch size, exactly
    ledger = summarize_stepscope(snap)["echo_replica"]
    assert ledger["steps"] == batches
    assert {"queue_wait", "linger", "infer"} <= set(ledger["phases"])
    assert sum(ledger["phases"].values()) == pytest.approx(ledger["wall_s"],
                                                           rel=1e-9)


def test_replica_without_telemetry_records_into_the_global_registry():
    reg = global_telemetry().registry
    service = f"glob{time.monotonic_ns()}"
    with Replica(None, lambda _p, x: x * 2, None, service=service,
                 batch_size=2, device="cpu") as rep:
        assert reg.value("serving_inflight", service=service) == 0.0
        _serve_n(rep, 3)
    assert reg.value("serving_completed_total", service=service) == 3
    assert reg.value("serving_inflight", service=service) is None


def test_replica_close_leaves_no_live_series_behind():
    """close() unregisters every series that reads the replica (the
    inflight and queue-depth callbacks, the replica loop's windowed
    fraction gauges), as the reference's close() does; what stays is
    cumulative (counters, histograms) and the last model version."""
    tel = Telemetry("rep")
    rep = Replica(None, lambda _p, x: x, None, service="gone",
                  batch_size=2, device="cpu", telemetry=tel)
    for f in [rep.submit(np.zeros(1, np.float32)) for _ in range(3)]:
        f.result(timeout=30)
    live = set(tel.snapshot())
    assert 'serving_inflight{service="gone"}' in live
    assert 'serving_queue_depth{service="gone"}' in live
    rep.close()
    left = tel.snapshot()
    assert set(left) < live
    for sid, series in left.items():
        if series["type"] == "gauge":
            assert sid == 'serving_model_version{service="gone"}', sid
    assert {sid.split("{")[0] for sid in live - set(left)} == {
        "serving_inflight", "serving_queue_depth",
        "stepscope_exposed_comms_fraction", "stepscope_host_blocked_fraction",
        "stepscope_env_wait_fraction", "stepscope_attributed_fraction",
        "stepscope_ledger_overrun_fraction"}
