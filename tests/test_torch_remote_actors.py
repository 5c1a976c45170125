"""The remote-actors example (moolib_tpu_torch.examples.remote_actors):
the served inference's random streams, against the reference's
discipline, and a learner fed by thin actors over the RPC on CartPole.

Each run is bounded by total_updates and a wall-clock cap of seconds,
and the Rpc timeout of this test's peers is cut to 5 s, so an actor
whose call is in flight when the learner leaves fails fast instead of
waiting out the default RPC timeout.
"""

import threading

import numpy as np
import pytest
import torch

from moolib_tpu_torch.examples import remote_actors as ra
from moolib_tpu_torch.models import A2CNet, a2c_params_from_flax


def _quiet(*a, **k):
    pass


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net():
    return A2CNet(4, 4, hidden_sizes=(8,), device="cpu",
                  generator=torch.Generator().manual_seed(0))


def test_remote_actor_inference_samples_fresh_streams():
    """Under a fixed model, successive infer calls draw from fresh random
    streams (the sampled actions vary; a reused stream would freeze
    them), the same seed replays the whole action sequence and its logits
    bit for bit, and another seed draws otherwise."""
    net = _net()
    params = lambda: dict(net.named_parameters())  # noqa: E731
    obs = np.random.default_rng(0).standard_normal((1, 3, 4)).astype(
        np.float32)
    done = np.zeros((1, 3), bool)

    infer = ra.make_infer_fn(net, params, 1, threading.Lock())
    steps = [infer(obs, done) for _ in range(8)]
    assert any(not np.array_equal(steps[0][0], a) for a, _ in steps[1:]), \
        "sampled actions frozen across calls: the stream is not advancing"
    replay = ra.make_infer_fn(net, params, 1, threading.Lock())
    for (a, logits), (ra_, rlogits) in zip(
            steps, (replay(obs, done) for _ in range(8))):
        np.testing.assert_array_equal(a, ra_)
        np.testing.assert_array_equal(logits, rlogits)
    other = ra.make_infer_fn(net, params, 2, threading.Lock())
    others = [other(obs, done)[0] for _ in range(8)]
    assert any(not np.array_equal(a, b)
               for (a, _), b in zip(steps, others))


def test_infer_matches_the_reference_on_stacked_calls():
    """make_infer_fn against the reference's on one stacked request
    ([n_calls=3, B_env=2] observations, each row its own) and A2CNet
    parameters converted from flax: the merge of both batch dims, the
    forward and the unmerge of logits and actions give the reference's
    logits (within 1e-5 of their max) in the reference's [n, b, A]
    order. The policy layer is scaled so that most rows' softmax puts
    all but 1e-6 of its mass on one action: every sampled action, in
    both packages, lies in its own row's support, and the supports
    differ between rows, so actions returned in another order fail."""
    import jax
    import jax.numpy as jnp
    from moolib_tpu.examples import remote_actors as ref_ra
    from moolib_tpu.models.a2c import A2CNet as FlaxA2CNet

    n, b, F, A = 3, 2, 4, 4
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((n, b, F)).astype(np.float32)
    done = rng.random((n, b)) < 0.3
    jnet = FlaxA2CNet(num_actions=A, hidden_sizes=(8,))
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]),
                       jnp.asarray(done[:1]), ())
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    # The first 4 hidden units copy the observation and the policy reads
    # them x1000: each row's logits peak on that row's largest feature.
    hidden, head = params["params"]["Dense_0"], params["params"]["Dense_1"]
    hidden["kernel"][:, :F] = np.eye(F, dtype=np.float32)
    hidden["bias"][:F] = 0.0
    head["kernel"] = np.zeros_like(head["kernel"])
    head["kernel"][:F] = 1000.0 * np.eye(F, dtype=np.float32)
    head["bias"] = np.zeros_like(head["bias"])
    net = A2CNet(A, F, hidden_sizes=(8,), device="cpu")
    net.load_state_dict(a2c_params_from_flax(params))

    ref_infer = ref_ra.make_infer_fn(jnet.apply, lambda: params, 0,
                                     threading.Lock())
    port_infer = ra.make_infer_fn(net, lambda: dict(net.named_parameters()),
                                  0, threading.Lock())
    ref_a, ref_logits = ref_infer(obs, done)
    port_a, port_logits = port_infer(obs, done)
    assert port_logits.shape == ref_logits.shape == (n, b, A)
    assert port_a.shape == np.asarray(ref_a).shape == (n, b)
    np.testing.assert_allclose(port_logits, ref_logits, rtol=0,
                               atol=1e-5 * np.abs(ref_logits).max())
    z = ref_logits - ref_logits.max(-1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    support = probs > 1e-6
    singletons = support.sum(-1) == 1
    assert singletons.sum() >= n * b // 2
    assert len({int(np.argmax(p)) for p in probs[singletons]}) > 1, \
        "every peaked row wants the same action: the check would be blind"
    for a in (np.asarray(ref_a), port_a):
        assert a.dtype.kind in "iu"
        assert support[np.arange(n)[:, None], np.arange(b)[None], a].all()


def test_infer_snapshots_the_params_under_the_lock():
    """infer copies the parameters into a policy of its own under the
    state lock: the model being written meanwhile (here: held by another
    thread under the lock) does not change a call in flight, and the
    next call sees the new weights."""
    net = _net()
    lock = threading.Lock()
    infer = ra.make_infer_fn(net, lambda: dict(net.named_parameters()), 0,
                             lock)
    obs = np.ones((2, 2, 4), np.float32)
    done = np.zeros((2, 2), bool)
    _, before = infer(obs, done)
    assert before.shape == (2, 2, 4)
    with torch.no_grad():
        net.policy.bias.add_(1.0)
    _, after = infer(obs, done)
    np.testing.assert_allclose(after, before + 1.0, rtol=0, atol=1e-5)
    # Calls are ordered by the lock: one waits while it is held.
    got = []
    with lock:
        t = threading.Thread(target=lambda: got.append(infer(obs, done)))
        t.start()
        t.join(0.3)
        assert t.is_alive() and not got
    t.join(10)
    assert got


def test_remote_actors_learner(monkeypatch):
    """The reference's test_remote_actors_learner on the port: two thin
    actors feed a central learner over the RPC (the policy served by
    define(batch_size=, pad=True), unrolls shipped into a define_queue)
    until total_updates; the learner's last row reaches the registry."""
    from moolib_tpu_torch.rpc import rpc as rpc_mod
    from moolib_tpu_torch.telemetry import global_telemetry

    monkeypatch.setattr(rpc_mod, "_DEFAULT_TIMEOUT", 5.0)
    cfg = ra.RemoteConfig(
        env="cartpole", actor_batch_size=2, num_env_processes=2,
        unroll_length=5, infer_batch_size=4, learn_batch_size=4,
        total_updates=20, max_seconds=30, log_interval=0.5)
    addr_box, logs_box = {}, {}
    addr_ready = threading.Event()

    def on_ready(addr):
        addr_box["addr"] = addr
        addr_ready.set()

    def learner():
        logs_box["logs"] = ra.run_learner(cfg, log_fn=_quiet,
                                          ready_fn=on_ready, device="cpu")

    lt = threading.Thread(target=learner)
    lt.start()
    frames = []
    actors = []
    try:
        assert addr_ready.wait(30), "learner never reported its address"
        actors = [threading.Thread(target=lambda: frames.append(
            ra.run_actor(cfg, addr_box["addr"], max_seconds=30)))
            for _ in range(2)]
        for t in actors:
            t.start()
    finally:
        lt.join(timeout=60)
        for t in actors:  # actors stop once the learner is gone
            t.join(timeout=60)
    assert not lt.is_alive(), "learner never reached total_updates"
    assert not any(t.is_alive() for t in actors)
    assert sum(frames) > 0
    rows = logs_box["logs"]
    assert rows and rows[-1]["updates"] >= 1
    assert np.isfinite(rows[-1]["total_loss"])
    updates = global_telemetry().registry.value("train_updates",
                                                example="remote_actors")
    assert updates == cfg.total_updates >= rows[-1]["updates"]


def test_learner_refuses_dict_observation_envs():
    with pytest.raises(ValueError, match="nethack"):
        ra._make_model(ra.RemoteConfig(env="nethack"), "cpu", None)
