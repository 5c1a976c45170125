"""Port parity: the acting step, batch staging, nest, admission control and
the serving Replica of moolib_tpu_torch, and their telemetry; then the
serving tier on the RPC.

The act step's logits are held against the reference's jitted act step;
its samples cannot match the reference's bits, so their frequencies are
held against softmax(logits). The Replica is driven through its local
submit() path and its replies are held against the direct forward. The
admission and replica cases mirror the tests/test_serving.py cases that
need no RPC. The admission queue's ``serving_*`` series are held to the
reference's exactly (equal snapshots after the same sequence of calls).

On the RPC: port Replicas bound to port Rpcs serve the TransformerNet to
a reference Router and to a port Router; every reply is held against the
reference's flax TransformerNet on the converted params at 1e-4 (f32),
before and after publish_weights swaps in a second version. Then the
reference's fleet cases (drain, health, endpoint collision, the peer
label) on port peers. Every wait has a timeout of its own.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moolib_tpu.rpc as ref_rpc
import moolib_tpu.serving as ref_serving
import moolib_tpu_torch.rpc as port_rpc
import moolib_tpu_torch.serving as port_serving
from moolib_tpu.learner import make_act_step as jax_make_act_step
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.serving.admission import AdmissionQueue as JaxAdmissionQueue
from moolib_tpu.telemetry import Telemetry as JaxTelemetry
from moolib_tpu.utils import nest as jax_nest
from moolib_tpu_torch import make_act_step
from moolib_tpu_torch.models import TransformerNet, transformer_params_from_flax
from moolib_tpu_torch.ops import stage_batch
from moolib_tpu_torch.rpc import Rpc
from moolib_tpu_torch.serving import (
    AdmissionQueue,
    DeadlineExceeded,
    Overloaded,
    Replica,
    Router,
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
                      torch.Generator().manual_seed(5))  # numlint: prng-key-reuse -- the generator alone decides the draws
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
        np.testing.assert_allclose(out["logits"], logits.numpy(), atol=1e-5)  # hotlint: sync -- the test compares each reply
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
    # The worker records a batch's step after its replies go out: wait
    # for the last one, so `live` holds every series the replica makes.
    reg, deadline = tel.registry, time.monotonic() + 30
    while not (reg.value("serving_batch_rows_total", service="gone") == 3
               and reg.value("stepscope_steps_total", loop="gone_replica")
               == reg.value("serving_batches_total", service="gone")):
        assert time.monotonic() < deadline
        time.sleep(0.001)
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


# ---------------------------------------------------------------------------
# The serving tier on the RPC
# ---------------------------------------------------------------------------

RPC_WAIT = 30.0  # seconds: the bound of every wait below
SERVE_T = 8      # steps per context request


def _flax_params(seed):
    jnet = JaxTransformerNet(num_actions=4, attention_backend="dense",
                             **SMALL)
    obs = jnp.zeros((SERVE_T, 1, 5), jnp.float32)
    params = jnet.init(jax.random.PRNGKey(seed), obs,
                       jnp.zeros((SERVE_T, 1), bool), ())
    return jnet, params


def _jax_reply(jnet, params, req):
    (logits, baseline), _ = jnet.apply(
        params, jnp.asarray(req["obs"][:, None]),
        jnp.asarray(req["done"][:, None]), ())
    return np.asarray(logits[:, 0]), np.asarray(baseline[:, 0])


def _wait_routable(router, n):
    deadline = time.monotonic() + RPC_WAIT
    while len(router.routable()) < n:
        assert time.monotonic() < deadline, router.stats()
        time.sleep(0.02)


class _Fleet:
    """Two port replicas of the context service, each on its own port
    Rpc, the port net carrying the reference's converted params."""

    def __init__(self, seed=1, **replica_kw):
        self.jnet, self.params = _flax_params(seed)
        self.rpcs, self.reps = [], []
        for i in range(2):
            rpc = Rpc(f"tsrep{i}")
            rpc.set_timeout(RPC_WAIT)
            rpc.listen("127.0.0.1:0")
            net = _net()
            net.load_state_dict(transformer_params_from_flax(
                jax.tree_util.tree_map(np.asarray, self.params)))
            kw = dict(batch_size=4, pad=True, linger_s=0.02, device="cpu",
                      version=1)
            kw.update(replica_kw)
            self.reps.append(Replica(rpc, _forward, net.eval(), **kw))
            self.rpcs.append(rpc)

    @property
    def names(self):
        return [rpc.get_name() for rpc in self.rpcs]

    def addrs(self):
        return [rpc.debug_info()["listen"][0] for rpc in self.rpcs]

    def close(self):
        for rpc, rep in zip(self.rpcs, self.reps):
            rep.close()
            rpc.close()


def _router(pkg, fleet, name):
    rpc_mod, router_mod = ((ref_rpc, ref_serving) if pkg == "ref"
                           else (port_rpc, port_serving))
    client = rpc_mod.Rpc(name)
    client.set_timeout(RPC_WAIT)
    for addr in fleet.addrs():
        client.connect(addr)
    router = router_mod.Router(client, fleet.names, probe_interval_s=0.05,
                               attempt_timeout_s=RPC_WAIT, seed=5)
    _wait_routable(router, 2)
    return client, router


def _context_requests(rng, n):
    return [{"obs": rng.standard_normal((SERVE_T, 5)).astype(np.float32),
             "done": rng.random(SERVE_T) < 0.2} for _ in range(n)]


@pytest.mark.parametrize("router_pkg", ["ref", "port"])
def test_rpc_replicas_answer_a_router_with_the_reference_model(router_pkg):
    """Port Replica(rpc, ...) on the CPU behind a reference or a port
    Router: replies equal the reference TransformerNet's on the
    converted params (1e-4, f32); publish_weights to version 2 (numpy
    leaves from the reference router, the torch state_dict from the
    port's) changes every reply to the new params' and both replicas'
    health to version 2."""
    rng = np.random.default_rng(11)
    fleet = _Fleet()
    client, router = _router(router_pkg, fleet, f"tsrouter-{router_pkg}")
    try:
        for version, params in ((1, fleet.params), (2, None)):
            if version == 2:
                jnet2, params = _flax_params(seed=7)
                new = transformer_params_from_flax(
                    jax.tree_util.tree_map(np.asarray, params))
                if router_pkg == "ref":
                    new = {k: v.numpy() for k, v in new.items()}
                acks = router.publish_weights(new, version=2,
                                              timeout_s=RPC_WAIT)
                assert acks == {n: True for n in fleet.names}, acks
            reqs = _context_requests(rng, 6)
            futs = [router.infer_async(r, budget_s=RPC_WAIT) for r in reqs]
            for req, fut in zip(reqs, futs):
                out = fut.result(timeout=RPC_WAIT)
                logits, baseline = _jax_reply(fleet.jnet, params, req)
                assert out["logits"].shape == (SERVE_T, 4)
                np.testing.assert_allclose(out["logits"], logits, atol=1e-4)
                np.testing.assert_allclose(out["baseline"], baseline,
                                           atol=1e-4)
            for name, rep in zip(fleet.names, fleet.reps):
                health = client.async_(name, "serve.health").result(
                    timeout=RPC_WAIT)
                assert health["model_version"] == version == rep.version
                assert health["name"] == name
        served = [rpc.telemetry.registry.value("serving_completed_total",
                                               service="serve") or 0
                  for rpc in fleet.rpcs]
        assert sum(served) == 12
    finally:
        router.close()
        client.close()
        fleet.close()


def test_rpc_load_swaps_a_module_copy_and_keeps_bfloat16():
    """The load endpoint loads a state_dict off the wire into a copy of
    the module (the batch in flight keeps the module it captured), with
    bfloat16 leaves arriving as tensors."""
    rpc, client = Rpc("loadrep"), Rpc("loadclient")
    net = TransformerNet(4, (5,), attention_backend="flash", device="cpu",
                         compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0),
                         **SMALL).to(torch.bfloat16).eval()
    rep = Replica(rpc, _forward, net, device="cpu")
    try:
        rpc.listen("127.0.0.1:0")
        client.connect(rpc.debug_info()["listen"][0])
        new = {k: torch.full_like(v, 0.25)
               for k, v in net.state_dict().items()}
        assert client.async_("loadrep", "serve.load", new, 9).result(
            timeout=RPC_WAIT) == 9
        assert rep.version == 9 and rep._params is not net
        for k, v in rep._params.state_dict().items():
            assert v.dtype == torch.bfloat16 and bool((v == 0.25).all()), k
        assert all(not bool((v == 0.25).all())
                   for v in net.state_dict().values())
    finally:
        rep.close()
        client.close()
        rpc.close()


def test_rpc_fleet_graceful_drain():
    fleet = _Fleet()
    client, router = _router("port", fleet, "tsrouter-drain")
    try:
        name0 = fleet.names[0]
        assert router.drain_replica(name0, timeout_s=RPC_WAIT)
        deadline = time.monotonic() + RPC_WAIT
        while name0 in router.routable():
            assert time.monotonic() < deadline, router.stats()
            time.sleep(0.05)
        req = _context_requests(np.random.default_rng(3), 1)[0]
        for _ in range(4):
            out = router.infer(req, budget_s=RPC_WAIT)
            assert out["logits"].shape == (SERVE_T, 4)
        st = router.stats()["replicas"][name0]
        assert st["draining"] and st["breaker"] == "closed", st
        assert client.async_(name0, "serve.health").result(
            timeout=RPC_WAIT)["draining"] is True
        with pytest.raises(RpcError, match="Overloaded"):
            client.call_with_deadline(name0, "serve.infer", 5.0,
                                      req).result(timeout=RPC_WAIT)
    finally:
        router.close()
        client.close()
        fleet.close()


def test_rpc_replica_endpoint_collision_refused():
    rpc = Rpc("colrep")
    try:
        rep = Replica(rpc, lambda p, x: x, None, service="col", device="cpu")
        with pytest.raises(RpcError, match="already defined"):
            Replica(rpc, lambda p, x: x, None, service="col", device="cpu")
        rep.close()
        for suffix in ("infer", "health", "load", "drain"):
            assert not rpc.defined(f"col.{suffix}")
        rep2 = Replica(rpc, lambda p, x: x, None, service="col",
                       device="cpu")
        rep2.close()
    finally:
        rpc.close()


def test_rpc_replica_gauges_carry_the_peer_label():
    """Bound to an Rpc, the replica records into rpc.telemetry with
    peer=rpc.get_name() on its gauges, as the reference's does, and
    close() unregisters them; telemetry= overrides the Rpc's."""
    rpc = Rpc("gaugerep")
    try:
        rep = Replica(rpc, lambda p, x: x, None, service="gg", device="cpu")
        reg = rpc.telemetry.registry
        labels = {"service": "gg", "peer": "gaugerep"}
        assert reg.value("serving_inflight", **labels) == 0
        assert reg.value("serving_queue_depth", **labels) == 0
        assert reg.value("serving_inflight", service="gg") is None
        rep.close()
        assert reg.value("serving_inflight", **labels) is None
        assert reg.value("serving_queue_depth", **labels) is None
        tel = Telemetry("own")
        rep = Replica(rpc, lambda p, x: x, None, service="gg", device="cpu",
                      telemetry=tel)
        assert tel.registry.value("serving_inflight", **labels) == 0
        assert reg.value("serving_inflight", **labels) is None
        rep.close()
    finally:
        rpc.close()


def test_rpc_replica_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rpc = Rpc("nodev")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Replica(rpc, lambda p, x: x, None)
        assert not rpc.defined("serve.infer")
    finally:
        rpc.close()


def _scale_fleet(n=2, **kw):
    rpcs, reps = [], []
    for i in range(n):
        rpc = Rpc(f"screp{i}")
        rpc.set_timeout(RPC_WAIT)
        rpc.listen("127.0.0.1:0")
        reps.append(Replica(rpc, lambda p, x: x * p, 2.0, batch_size=4,
                            pad=True, device="cpu", **kw))
        rpcs.append(rpc)
    client = Rpc("scrouter")
    client.set_timeout(RPC_WAIT)
    for rpc in rpcs:
        client.connect(rpc.debug_info()["listen"][0])
    router = Router(client, [r.get_name() for r in rpcs],
                    probe_interval_s=0.05, attempt_timeout_s=2.0, seed=5)
    _wait_routable(router, n)
    return rpcs, reps, client, router


def test_publish_from_accumulator_takes_the_accumulators_version():
    """A Router over a replica on the CPU: publish_from_accumulator swaps
    in the trainer's params under the accumulator's model_version."""
    from moolib_tpu_torch.parallel import Accumulator
    from moolib_tpu_torch.serving import publish_from_accumulator

    rpcs, reps, client, router = _scale_fleet(n=1)
    trainer = Rpc("pubtrainer")
    acc = Accumulator(trainer, virtual_batch_size=1)
    try:
        acc.set_model_version(42)
        acks = publish_from_accumulator(router, acc, 3.0, timeout_s=RPC_WAIT)
        assert acks == {"screp0": True}
        assert reps[0].version == 42
        health = client.async_("screp0", "serve.health").result(
            timeout=RPC_WAIT)
        assert health["model_version"] == 42
        x = np.ones(3, np.float32)
        np.testing.assert_array_equal(router.infer(x, budget_s=RPC_WAIT),
                                      3 * x)
    finally:
        acc.close()
        trainer.close()
        router.close()
        client.close()
        for rep, rpc in zip(reps, rpcs):
            rep.close()
            rpc.close()


def test_rpc_fleet_failover_zero_accepted_dropped():
    """The reference's failover case on port peers: one of two replicas
    dies mid-load; every accepted request completes on the survivor or
    fails fast with an explicit error, and the dead one leaves rotation."""
    rpcs, reps, client, router = _scale_fleet()
    try:
        x = np.ones(3, np.float32)
        router.infer(x, budget_s=RPC_WAIT)
        futs = [router.infer_async(x, budget_s=RPC_WAIT) for _ in range(40)]
        time.sleep(0.01)
        rpcs[0].close()
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", f.result(timeout=RPC_WAIT)))
            except RpcError as e:
                outcomes.append(("err", str(e)))
        assert len(outcomes) == 40
        n_ok = sum(1 for k, _ in outcomes if k == "ok")
        assert n_ok >= 36, outcomes
        for k, v in outcomes:
            if k == "ok":
                np.testing.assert_array_equal(v, 2 * x)
        deadline = time.monotonic() + RPC_WAIT
        while "screp0" in router.routable():
            assert time.monotonic() < deadline, router.stats()
            time.sleep(0.05)
        reg = client.telemetry.registry
        assert reg.value("serving_router_ok_total", service="serve") >= n_ok
    finally:
        router.close()
        client.close()
        for rpc, rep in zip(rpcs, reps):
            rep.close()
            rpc.close()


def test_rpc_overloaded_replica_is_explicit_and_retried_elsewhere():
    block = threading.Event()

    def slow(p, x):
        block.wait(RPC_WAIT)
        return x

    rpc0, rpc1 = Rpc("ovrep0"), Rpc("ovrep1")
    for rpc in (rpc0, rpc1):
        rpc.listen("127.0.0.1:0")
    rep0 = Replica(rpc0, slow, None, batch_size=1, max_queue=2,
                   service="ov", device="cpu")
    rep1 = Replica(rpc1, lambda p, x: x, None, batch_size=1, max_queue=64,
                   service="ov", device="cpu")
    client = Rpc("ovrouter")
    client.set_timeout(RPC_WAIT)
    for rpc in (rpc0, rpc1):
        client.connect(rpc.debug_info()["listen"][0])
    router = Router(client, ["ovrep0", "ovrep1"], service="ov",
                    probe_interval_s=0.05, seed=2)
    try:
        _wait_routable(router, 2)
        x = np.ones(2, np.float32)
        direct = [client.call_with_deadline("ovrep0", "ov.infer", RPC_WAIT,
                                            x)]
        deadline = time.monotonic() + RPC_WAIT
        while rep0.admission.inflight < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        direct += [client.call_with_deadline("ovrep0", "ov.infer",
                                             RPC_WAIT, x) for _ in range(2)]
        while rep0.admission.depth < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(RpcError, match="Overloaded"):
            client.call_with_deadline("ovrep0", "ov.infer", 5.0,
                                      x).result(timeout=RPC_WAIT)
        futs = [router.infer_async(x, budget_s=RPC_WAIT) for _ in range(12)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=RPC_WAIT), x)
        block.set()
        for f in direct:
            f.result(timeout=RPC_WAIT)
    finally:
        block.set()
        router.close()
        client.close()
        for rep, rpc in ((rep0, rpc0), (rep1, rpc1)):
            rep.close()
            rpc.close()
