"""The port's examples layer against the reference's: EnvBatchState's
unrolls, the TSV logger's bytes, the config overrides, A2CNet against
flax's with converted parameters, and the reference's vtrace experiment
cases (tests/test_examples.py) run through the port's train() on the
CPU."""

import dataclasses
import json
import math
import time

import jax
import numpy as np
import pytest
import torch

from moolib_tpu.examples import common as ref_common
from moolib_tpu.examples.common import record as ref_record
from moolib_tpu.examples.vtrace import experiment as ref_exp
from moolib_tpu.models import A2CNet as FlaxA2CNet
from moolib_tpu_torch.examples import common as port_common
from moolib_tpu_torch.examples.common import record as port_record
from moolib_tpu_torch.examples.vtrace import experiment as port_exp
from moolib_tpu_torch.models import A2CNet, a2c_params_from_flax

VtraceConfig, train = port_exp.VtraceConfig, port_exp.train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the loops' CPU steps are small, and the
    test processes run side by side (more threads than cores only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- EnvBatchState -------------------------------------------------------------


def _env_outs(rng, steps, B, dict_obs):
    ep_step = np.zeros(B, np.int64)
    ep_ret = np.zeros(B, np.float64)
    for _ in range(steps):
        done = rng.random(B) < 0.2
        reward = rng.standard_normal(B).astype(np.float32)
        ep_step += 1
        ep_ret += reward
        out = {"reward": reward, "done": done,
               "episode_step": ep_step.copy(),
               "episode_return": ep_ret.copy()}
        if dict_obs:
            out["glyphs"] = rng.integers(0, 99, (B, 3, 4)).astype(np.int16)
            out["blstats"] = rng.standard_normal((B, 5)).astype(np.float32)
        else:
            out["obs"] = rng.integers(0, 255, (B, 4, 4, 2)).astype(np.uint8)
        ep_step[done] = 0
        ep_ret[done] = 0.0
        yield out


@pytest.mark.parametrize("dict_obs", [False, True], ids=["array", "dict"])
def test_env_batch_state_unrolls_equal_the_reference(dict_obs):
    """Same env outputs, actions and logits into both: the same unrolls,
    bit for bit, and the same episode stats; the port keeps its core
    state as the act step gave it (tensors), the reference its arrays."""
    T, B, H = 4, 3, 5
    rng = np.random.default_rng(int(dict_obs))
    c0 = (np.zeros((B, H), np.float32), np.zeros((B, H), np.float32))
    ref = ref_common.EnvBatchState(T, c0)
    port = port_common.EnvBatchState(T, tuple(torch.from_numpy(x)
                                              for x in c0))
    n_unrolls = 0
    for t, out in enumerate(_env_outs(rng, 3 * T + 2, B, dict_obs)):
        u_ref, u_port = ref.observe(out), port.observe(out)
        assert (u_ref is None) == (u_port is None)
        if u_ref is not None:
            n_unrolls += 1
            assert sorted(u_ref) == sorted(u_port)
            for k in ("done", "rewards", "actions", "behavior_logits"):
                _same(u_ref[k], u_port[k])
            if dict_obs:
                for k in u_ref["obs"]:
                    _same(u_ref["obs"][k], u_port["obs"][k])
            else:
                _same(u_ref["obs"], u_port["obs"])
            for r, p in zip(u_ref["core_state"], u_port["core_state"]):
                assert isinstance(p, torch.Tensor)
                _same(r, p)
        a = rng.integers(0, 6, B)
        logits = rng.standard_normal((B, 6)).astype(np.float32)
        core = tuple(np.full((B, H), t, np.float32) for _ in range(2))
        ref.record_action(a, logits, core)
        port.record_action(torch.from_numpy(a), torch.from_numpy(logits),
                           tuple(torch.from_numpy(x) for x in core))
    assert n_unrolls == 3
    assert ref.recent_returns() == port.recent_returns()
    assert ref.recent_lengths() == port.recent_lengths()


def test_obs_from_env_out_equals_the_reference():
    rng = np.random.default_rng(3)
    for dict_obs in (False, True):
        out = next(_env_outs(rng, 1, 2, dict_obs))
        r, p = ref_common.obs_from_env_out(out), port_common.obs_from_env_out(out)
        assert type(r) is type(p)
        if dict_obs:
            assert sorted(r) == sorted(p)


# -- record ---------------------------------------------------------------------


def test_tsv_logger_and_metadata_write_the_reference_bytes(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)
    rows = [{"loss": 0.123456789, "steps": 10, "leader": True, "x": "a"},
            {"loss": float("nan"), "steps": 20, "late": 1.0},
            {"steps": 30}]
    for mod, name in ((ref_record, "ref"), (port_record, "port")):
        log = mod.TsvLogger(str(tmp_path / name / "logs.tsv"))
        for row in rows:
            log.log(row)
        mod.write_metadata(str(tmp_path / name / "metadata.json"),
                           config={"a": 1}, peer="p")
        # A resumed logger adopts the header and appends.
        mod.TsvLogger(str(tmp_path / name / "logs.tsv")).log({"steps": 40})
    for f in ("logs.tsv", "metadata.json"):
        assert (tmp_path / "ref" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    assert json.loads((tmp_path / "port" / "metadata.json").read_text())[
        "peer"] == "p"


# -- config ---------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    [],
    ["env=cartpole", "use_lstm=true", "learning_rate=1e-3"],
    ["max-seconds=12.5", "broker=tcp://h:1", "min_quorum=2", "seed=7",
     "wandb=no", "savedir=/x/y"],
])
def test_apply_overrides_equals_the_reference(overrides):
    ref = ref_exp._apply_overrides(ref_exp.VtraceConfig(), overrides)
    port = port_exp._apply_overrides(port_exp.VtraceConfig(), overrides)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)


@pytest.mark.parametrize("bad", [["nokey"], ["no_such_key=1"]])
def test_apply_overrides_refuses_what_the_reference_refuses(bad):
    with pytest.raises(SystemExit):
        ref_exp._apply_overrides(ref_exp.VtraceConfig(), bad)
    with pytest.raises(SystemExit):
        port_exp._apply_overrides(port_exp.VtraceConfig(), bad)


def test_config_files_are_the_references():
    from importlib.resources import files

    for name in ("config.yaml", "config_nethack.yaml", "config_procgen.yaml"):
        import yaml

        ref = yaml.safe_load(files("moolib_tpu.examples.vtrace")
                             .joinpath(name).read_text())
        port = yaml.safe_load(files("moolib_tpu_torch.examples.vtrace")
                              .joinpath(name).read_text())
        assert ref == port, name
        port_exp.VtraceConfig(**port)  # every key is a field


# -- A2CNet ---------------------------------------------------------------------


@pytest.mark.parametrize("use_lstm", [False, True])
def test_a2c_net_equals_flax_with_converted_params(use_lstm):
    """f32 at 1e-5; the flax biases drawn at random (flax starts them at
    0, which would hide a bias on the wrong side)."""
    T, B, F, A = 5, 3, 4, 2
    rng = np.random.default_rng(int(use_lstm))
    obs = rng.standard_normal((T, B, F)).astype(np.float32)
    done = rng.random((T, B)) < 0.3
    ref = FlaxA2CNet(num_actions=A, use_lstm=use_lstm)
    state = ref.initial_state(B)
    params = ref.init(jax.random.PRNGKey(0), obs, done, state)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.1,
        params)
    (logits, baseline), new_state = ref.apply(params, obs, done, state)
    net = A2CNet(A, F, use_lstm=use_lstm, device="cpu")
    net.load_state_dict(a2c_params_from_flax(params))
    with torch.no_grad():
        (p_logits, p_baseline), p_state = net(
            torch.from_numpy(obs), torch.from_numpy(done),
            net.initial_state(B))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(p_baseline.numpy(), np.asarray(baseline),
                               rtol=0, atol=1e-5)
    assert len(p_state) == len(new_state)
    for r, p in zip(new_state, p_state):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


# -- the vtrace experiment --------------------------------------------------------


def test_train_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(VtraceConfig(env="cartpole", total_steps=8), log_fn=_quiet)


@pytest.mark.parametrize("cfg,err", [
    (dict(env="nethack"), NotImplementedError),
    (dict(model="transformer", transformer_mlp="moe"), NotImplementedError),
    (dict(model="nope"), ValueError),
])
def test_unported_models_raise(cfg, err):
    with pytest.raises(err):
        port_exp._make_model(VtraceConfig(**cfg), "cpu")


def test_vtrace_experiment_runs_and_checkpoints(tmp_path):
    cfg = VtraceConfig(
        env="cartpole", total_steps=6_000, actor_batch_size=8,
        learn_batch_size=8, virtual_batch_size=8, num_actor_processes=2,
        unroll_length=10, log_interval_steps=2_000, savedir=str(tmp_path),
        checkpoint_interval=0.0, checkpoint_history_interval=None,
        stats_interval=0.2, seed=0)
    logs = train(cfg, log_fn=_quiet, device="cpu")
    assert len(logs) == 3
    assert logs[-1]["updates"] > 10
    assert np.isfinite(logs[-1]["total_loss"])
    for f in ("logs.tsv", "metadata.json", "checkpoint.ckpt"):
        assert (tmp_path / f).exists(), f
    assert logs[-1]["global_env_steps"] > 0
    # Resume: the checkpoint holder wins the leader election and
    # model_version carries over.
    vers = [r["model_version"] for r in logs]
    resumed = []
    cfg2 = VtraceConfig(**{**cfg.__dict__, "total_steps": 2_000})
    logs2 = train(cfg2, log_fn=resumed.append, device="cpu")
    assert logs2[0]["model_version"] >= vers[-1]
    assert any(line.startswith("resumed from") for line in resumed)


def test_vtrace_synthetic_pixels_smoke():
    cfg = VtraceConfig(
        env="synthetic", num_actions=4, episode_length=40, total_steps=640,
        actor_batch_size=4, learn_batch_size=4, virtual_batch_size=4,
        num_actor_processes=2, num_actor_batches=2, unroll_length=4,
        log_interval_steps=320, stats_interval=1e9, seed=0)
    logs = train(cfg, log_fn=_quiet, device="cpu")
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])


def test_vtrace_lstm_smoke():
    """The LSTM's core_state ([B, H] tensors) batches alongside [T, B, ...]
    host leaves (the learn Batcher's per-key dims)."""
    cfg = VtraceConfig(
        env="cartpole", use_lstm=True, total_steps=2_000, actor_batch_size=4,
        learn_batch_size=8, virtual_batch_size=8, num_actor_processes=2,
        unroll_length=5, log_interval_steps=1_000, stats_interval=1e9,
        seed=0)
    logs = train(cfg, log_fn=_quiet, device="cpu")
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])


def test_vtrace_transformer_smoke(monkeypatch):
    """The transformer agent through the loop; on the CPU its attention is
    the plain dense path, counted here (act at T=1, train at T+1=6)."""
    from moolib_tpu_torch.ops import attention as attn

    seen = []
    dense = attn.dense_attention

    def counting(q, *args, **kwargs):
        seen.append(q.shape[-2])
        return dense(q, *args, **kwargs)

    monkeypatch.setattr(attn, "dense_attention", counting)
    cfg = VtraceConfig(
        env="cartpole", model="transformer", total_steps=2_000,
        actor_batch_size=4, learn_batch_size=8, virtual_batch_size=8,
        num_actor_processes=2, unroll_length=5, log_interval_steps=1_000,
        stats_interval=1e9, seed=0)
    logs = train(cfg, log_fn=_quiet, device="cpu")
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])
    # Two layers per call: every act step and every grad step.
    assert seen.count(1) >= 2 * 2000 // 4 and seen.count(6) >= 2
    assert set(seen) == {1, 6}


def test_profile_dir_gets_a_trace_of_the_update_window(tmp_path):
    cfg = VtraceConfig(
        env="cartpole", total_steps=1_200, actor_batch_size=4,
        learn_batch_size=4, virtual_batch_size=4, num_actor_processes=1,
        num_actor_batches=1, unroll_length=4, log_interval_steps=400,
        stats_interval=1e9, seed=0, profile_dir=str(tmp_path / "prof"))
    logs = train(cfg, log_fn=_quiet, device="cpu")
    assert logs[-1]["updates"] >= 13
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and "optimizer" not in n and n.startswith("aten::")
               for n in names)
    assert math.isfinite(logs[-1]["total_loss"])
