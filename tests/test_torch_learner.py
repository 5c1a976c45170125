"""Port parity: moolib_tpu_torch's learner and optimizers against
moolib_tpu.learner and optax.

A small TransformerNet (d_model 32, 2 layers, 2 heads) with the
reference's weights converted by transformer_params_from_flax; the same
numpy learn batch ([T+1=5, B=2], pixel or vector observations, rewards
that reward_clip cuts) goes through both. The reference runs its Pallas
flash kernels in interpret mode, the port its plain flash forward and
backward. transformer_params_from_flax is linear in its leaves, so it
carries the reference's gradients and optax's nu across too.

Tolerances, f32 throughout unless stated:
- loss metrics 1e-5 relative: the same sums in other orders;
- gradients 1e-4 of each tensor's largest entry (measured on the CPU:
  up to 1.1e-5, at conv1.bias);
- with compute_dtype bf16 both round the scaled pixels and pos_emb to
  bf16, and pos_emb's gradient too on its way back through the cast, so
  one of its roundings may fall the other way: pos_emb's gradient at
  2**-7 of its max, every other tolerance as in f32;
- the optimizer against optax 1e-6 relative: elementwise, one rounding
  per operation in both;
- parameters after 3 train steps 1e-6 absolute: each step moves them by
  lr * g / sqrt(nu + eps), which scales gradient differences by < 0.1.

ImpalaNet (f32, without and with its LSTM) trains through the same entry
points on [T+1=3, B=2] 84x84x4 frames with experiment.py's RMSprop
chain: metrics 1e-5 relative, gradients 1e-4 of each tensor's largest
entry, parameters after each step 1e-5 of their tensor's largest entry.
The reference runs op by op there (jax.disable_jit). Jitted, XLA's CPU
convolutions round otherwise, and now and then a max-pool window's two
largest inputs (or an input at a relu's kink) fall the other way, which
sends a whole position's gradient elsewhere: on six seeds the jitted
reference's gradients differed from its own op-by-op ones by up to
2.6e-3 of a tensor's largest entry (on two seeds of six), the port's
from the op-by-op ones by at most 1.7e-5.
ClippedAdam (bench.py's chain) is held to optax's adam on gradients of
its own, where each step moves a parameter by about lr whatever the
gradient's size: 1e-6 relative, as for the RMSprop chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moolib_tpu import learner as jlearner
from moolib_tpu.models import ImpalaNet as JaxImpalaNet
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.models import (
    ImpalaNet,
    TransformerNet,
    impala_params_from_flax,
    transformer_params_from_flax,
)
from moolib_tpu_torch.optim import ClippedAdam, ClippedRMSprop, global_norm
from moolib_tpu_torch.telemetry import StepScope, Telemetry

SMALL = dict(d_model=32, num_layers=2, num_heads=2)
A = 6
METRICS = ("total_loss", "pg_loss", "baseline_loss", "entropy",
           "mean_baseline")


def _batch(seed, pixels, T=4, B=2):
    rng = np.random.default_rng(seed)
    if pixels:
        obs = rng.integers(0, 256, (T + 1, B, 84, 84, 4), dtype=np.uint8)
    else:
        obs = rng.standard_normal((T + 1, B, 5)).astype(np.float32)
    return {
        "obs": obs,
        "done": rng.random((T + 1, B)) < 0.25,
        "rewards": (2.0 * rng.standard_normal((T + 1, B))).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }


def _jbatch(b):
    return {**{k: jnp.asarray(v) for k, v in b.items()}, "core_state": ()}


def _tbatch(b):
    return {**{k: torch.from_numpy(np.array(v)) for k, v in b.items()},
            "core_state": ()}


def _pair(batch, compute_dtype=torch.float32):
    jdtype = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32
    jnet = JaxTransformerNet(num_actions=A, attention_backend="flash",
                             compute_dtype=jdtype, **SMALL)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(batch["obs"]),
                       jnp.asarray(batch["done"]), ())
    net = TransformerNet(A, batch["obs"].shape[2:], attention_backend="flash",
                         compute_dtype=compute_dtype, device="cpu", **SMALL)
    net.load_state_dict(_convert(params))
    return jnet, params, net


def _convert(tree):
    return transformer_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               tree))


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=0, atol=rel * scale, err_msg=err_msg)


@pytest.mark.parametrize("pixels", [True, False])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_impala_loss_and_gradients_match_reference(pixels, compute_dtype):
    batch = _batch(0, pixels)
    jnet, params, net = _pair(batch, compute_dtype)
    cfg = jlearner.ImpalaConfig()
    (_, jm), jgrads = jax.value_and_grad(
        lambda p: jlearner.impala_loss(p, jnet.apply, _jbatch(batch), cfg),
        has_aux=True)(params)
    grads, tm = tlearner.make_grad_step()(net, _tbatch(batch))

    bf16 = compute_dtype == torch.bfloat16
    for name in METRICS:
        _close_rel(tm[name], jm[name], 1e-5, name)
    want = _convert(jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        rel = 2.0 ** -7 if bf16 and name == "pos_emb.weight" else 1e-4
        _close_rel(g, want[name], rel, name)
    _close_rel(tm["grad_norm"], optax.global_norm(jgrads), 1e-5)


@pytest.mark.parametrize("max_norm", [None, 40.0])
def test_optimizer_matches_optax(max_norm):
    """3 steps from nu = 0 on gradients of norm ~130 (clipped at 40) or
    the same gradients unclipped; parameters and nu against optax."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (20.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    rms = optax.rmsprop(6e-4, decay=0.99, eps=0.01)
    tx = rms if max_norm is None else optax.chain(
        optax.clip_by_global_norm(max_norm), rms)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ClippedRMSprop(tp.values(), 6e-4, decay=0.99, eps=0.01,
                         max_norm=max_norm)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    nu = (state if max_norm is None else state[1])[0].nu
    for k, p in tp.items():
        _close_rel(p.detach(), jp[k], 1e-6, k)
        _close_rel(opt.state[p]["nu"], nu[k], 1e-6, f"nu {k}")
    norm = float(global_norm(torch.from_numpy(v) for v in grads[0].values()))
    assert norm > 40.0  # the clipping case clips
    np.testing.assert_allclose(norm, float(optax.global_norm(grads[0])),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [None, 40.0])
def test_adam_matches_optax(max_norm):
    """bench.py's chain: 3 steps from mu = nu = 0 on gradients of norm
    ~130 (clipped at 40) or the same gradients unclipped; parameters, mu
    and nu against optax's."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (20.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    adam = optax.adam(6e-4)
    tx = adam if max_norm is None else optax.chain(
        optax.clip_by_global_norm(max_norm), adam)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ClippedAdam(tp.values(), 6e-4, max_norm=max_norm)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    adam_state = (state if max_norm is None else state[1])[0]
    assert opt.param_groups[0]["count"] == int(adam_state.count) == 3
    for k, p in tp.items():
        _close_rel(p.detach(), jp[k], 1e-6, k)
        _close_rel(opt.state[p]["mu"], adam_state.mu[k], 1e-6, f"mu {k}")
        _close_rel(opt.state[p]["nu"], adam_state.nu[k], 1e-6, f"nu {k}")
    assert float(global_norm(torch.from_numpy(v)
                             for v in grads[0].values())) > 40.0


def test_adam_rejects_bad_settings():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="adam"):
        ClippedAdam(p, lr=1e-3, b2=1.0)
    with pytest.raises(ValueError, match="max_norm"):
        ClippedAdam(p, lr=1e-3, max_norm=-1.0)


def test_optimizer_rejects_bad_settings():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="rmsprop"):
        ClippedRMSprop(p, lr=0.0)
    with pytest.raises(ValueError, match="max_norm"):
        ClippedRMSprop(p, lr=1e-3, max_norm=0.0)


def _experiment_optimizers(net):
    """experiment.py's chain on both sides."""
    tx = optax.chain(optax.clip_by_global_norm(40.0),
                     optax.rmsprop(6e-4, decay=0.99, eps=0.01))
    opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                         max_norm=40.0)
    return tx, opt


def test_three_train_steps_match_reference():
    batches = [_batch(s, pixels=False) for s in range(3)]
    jnet, params, net = _pair(batches[0])
    tx, opt = _experiment_optimizers(net)
    cfg = jlearner.ImpalaConfig()
    jstep = jlearner.make_impala_train_step(jnet.apply, tx, cfg,
                                            donate=False)
    jstate = jlearner.make_train_state(params, tx)
    tstep = tlearner.make_impala_train_step(config=tlearner.ImpalaConfig())
    tstate = tlearner.make_train_state(net, opt)
    for b in batches:
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        for name in METRICS + ("grad_norm",):
            _close_rel(tm[name], jm[name], 1e-5, name)
    assert tstate.step == int(jstate.step) == 3
    want = _convert(jstate.params)
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    nu = _convert(jstate.opt_state[1][0].nu)
    for name, p in net.named_parameters():
        _close_rel(opt.state[p]["nu"], nu[name], 1e-4, f"nu {name}")


def test_grad_step_then_apply_step_equals_fused_step():
    """experiment.py's split: grads x grad_scale, the one-peer
    Accumulator mean (divide by the batch size), then the apply step.
    Scaling by a power of two is exact, so the result is bitwise."""
    batch = _tbatch(_batch(7, pixels=False))
    states = []
    for _ in range(2):
        net = TransformerNet(A, (5,), attention_backend="flash", device="cpu",
                             generator=torch.Generator().manual_seed(0),  # numlint: prng-key-reuse -- twin models: both draws must be equal
                             **SMALL)
        opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                             max_norm=40.0)
        states.append(tlearner.make_train_state(net, opt))
    fused, fm = tlearner.make_impala_train_step()(states[0], batch)
    grads, gm = tlearner.make_grad_step(grad_scale=2.0)(states[1].model, batch)
    grads = {n: g / 2.0 for n, g in grads.items()}
    split = tlearner.make_apply_step()(states[1], grads)
    assert fused.step == split.step == 1
    for name in fm:
        assert torch.equal(fm[name], gm[name]), name
    for (n, a), b in zip(fused.model.state_dict().items(),
                         split.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_train_step_runs_the_conv_backward_without_tf32():
    """cuDNN reads its TF32 switch when the convolutions' backward runs:
    the train step holds it off around the forward and the backward, and
    puts the caller's setting back."""
    batch = _tbatch(_batch(3, pixels=True, T=1))
    net = TransformerNet(A, (84, 84, 4), device="cpu",
                         generator=torch.Generator().manual_seed(0), **SMALL)
    seen = []
    for conv in (net.conv0, net.conv1):
        conv.weight.register_hook(
            lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        opt = ClippedRMSprop(net.parameters(), 6e-4, max_norm=40.0)
        tlearner.make_impala_train_step()(
            tlearner.make_train_state(net, opt), batch)
        assert seen == [False, False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_train_step_runs_the_conv_backward_on_deterministic_algorithms():
    """cuDNN reads its determinism switch when the convolutions' backward
    runs (its weight-gradient algorithms may sum in a different order on
    every call otherwise): the train step holds it on around the forward
    and the backward, and puts the caller's setting back."""
    batch = _tbatch(_batch(3, pixels=True, T=1))
    net = TransformerNet(A, (84, 84, 4), device="cpu",
                         generator=torch.Generator().manual_seed(0), **SMALL)
    seen = []
    for conv in (net.conv0, net.conv1):
        conv.weight.register_hook(
            lambda g: seen.append(torch.backends.cudnn.deterministic))
    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        opt = ClippedRMSprop(net.parameters(), 6e-4, max_norm=40.0)
        tlearner.make_impala_train_step()(
            tlearner.make_train_state(net, opt), batch)
        assert seen == [True, True]
        assert torch.backends.cudnn.deterministic is False
    finally:
        torch.backends.cudnn.deterministic = prev


def test_unported_options_name_their_roadmap_item(tmp_path):
    """``mesh`` and ``batch_axes`` once raised here, naming ROADMAP item 11;
    they are ported (tests/test_torch_mesh.py holds the dp step on 2 and
    4 ranks). Without a mesh ``batch_axes`` changes nothing, in both
    packages; on a one-rank dp mesh the train step gives the reference's
    mesh step (the tolerances of the module docstring)."""
    import torch.distributed as dist

    from moolib_tpu.parallel.mesh import make_mesh as jmake_mesh
    from moolib_tpu.parallel.mesh import shard_batch as jshard_batch
    from moolib_tpu_torch.parallel.mesh import make_mesh

    batch = _batch(6, pixels=False)
    jnet, params, net = _pair(batch)
    g_plain, _ = tlearner.make_grad_step()(net, _tbatch(batch))
    g_axes, _ = tlearner.make_grad_step(batch_axes={"obs": 1})(
        net, _tbatch(batch))
    for name, g in g_plain.items():
        assert torch.equal(g, g_axes[name]), name
    jg, _ = jlearner.make_grad_step(jnet.apply, batch_axes={"obs": 1})(
        params, _jbatch(batch))
    want = _convert(jg)
    for name, g in g_axes.items():
        _close_rel(g, want[name], 1e-4, name)

    opt = optax.chain(optax.clip_by_global_norm(40.0),
                      optax.rmsprop(6e-4, decay=0.99, eps=0.01))
    jmesh = jmake_mesh(dp=1, devices=jax.devices()[:1])
    jdense = JaxTransformerNet(num_actions=A, attention_backend="dense",
                               **SMALL)  # Pallas does not run in shard_map
    jstate, jm = jlearner.make_impala_train_step(
        jdense.apply, opt, mesh=jmesh, donate=False)(
        jlearner.make_train_state(params, opt),
        jshard_batch(jmesh, _jbatch(batch)))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        state = tlearner.make_train_state(net, ClippedRMSprop(
            net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))
        state, tm = tlearner.make_impala_train_step(
            mesh=make_mesh(device="cpu"))(state, _tbatch(batch))
    finally:
        dist.destroy_process_group()
    for name in METRICS:
        _close_rel(tm[name], jm[name], 1e-5, name)
    want = _convert(jstate.params)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def _twins(seed=0):
    """Two identical TransformerNet train states."""
    states = []
    for _ in range(2):
        net = TransformerNet(A, (5,), attention_backend="flash", device="cpu",
                             generator=torch.Generator().manual_seed(seed),  # numlint: prng-key-reuse -- twin models: both draws must be equal
                             **SMALL)
        opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                             max_norm=40.0)
        states.append(tlearner.make_train_state(net, opt))
    return states


def _assert_ledger_closes(scope, steps, phases):
    s = scope.summary()
    assert s["steps"] == steps
    assert set(phases) <= set(s["phases"]), s["phases"]
    assert all(s["phases"][p] > 0 for p in phases)
    assert sum(s["phases"].values()) == pytest.approx(s["wall_s"],
                                                      rel=1e-9)
    snap = scope._tel.snapshot()
    assert snap[f'stepscope_ledger_overrun_fraction{{loop="{scope.loop}"}}'][
        "value"] == 0.0


def _program_ranges(prof):
    """{name: [(start_ns, end_ns)]} of the ``stepscope.*`` host ranges a
    profile holds."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("stepscope."):
            out.setdefault(e.name()[len("stepscope."):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _assert_ranges_nest(prof, steps, nests):
    """Each step opened each range once, and each ``(inner, outer)``
    range lies inside one of ``outer``'s."""
    ranges = _program_ranges(prof)
    names = {n for pair in nests for n in pair}
    assert {n: len(ranges.get(n, [])) for n in names} == \
        dict.fromkeys(names, steps), ranges
    for inner, outer in nests:
        for i0, i1 in ranges[inner]:
            assert any(o0 <= i0 and i1 <= o1 for o0, o1 in ranges[outer]), \
                (inner, outer)


def test_scoped_train_step_is_bit_identical_and_its_ledger_closes():
    """stepscope= only times the step: parameters and metrics are the
    unscoped step's bits, under the profiler too; the ledger holds
    fwd_bwd and the caller's host_sync and closes (phases + other ==
    wall, no overrun); the profiler sees forward inside loss inside
    fwd_bwd, and backward and optimizer inside fwd_bwd."""
    scope = StepScope("learner", telemetry=Telemetry("t"))
    plain_state, scoped_state = _twins()
    plain = tlearner.make_impala_train_step()
    scoped = tlearner.make_impala_train_step(stepscope=scope)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for seed in range(2):
            batch = _tbatch(_batch(20 + seed, pixels=False))
            plain_state, pm = plain(plain_state, batch)
            with scope.step():
                scoped_state, sm = scoped(scoped_state, batch)
                with scope.phase("host_sync"):
                    loss = float(sm["total_loss"])  # hotlint: sync -- the test compares each step's loss
            assert loss == float(pm["total_loss"])  # hotlint: sync -- the test compares each step's loss
            for name in pm:
                assert torch.equal(pm[name], sm[name]), name
    assert scoped_state.step == plain_state.step == 2
    for (n, a), b in zip(plain_state.model.state_dict().items(),
                         scoped_state.model.state_dict().values()):
        assert torch.equal(a, b), n
    _assert_ledger_closes(scope, 2, ("fwd_bwd", "host_sync"))
    _assert_ranges_nest(prof, 2, [("forward", "loss"), ("loss", "fwd_bwd"),
                                  ("backward", "fwd_bwd"),
                                  ("optimizer", "fwd_bwd")])
    # Outside scope.step() a scoped step records nothing.
    scoped(scoped_state, _tbatch(_batch(30, pixels=False)))
    assert scope.summary()["steps"] == 2


def test_scoped_grad_apply_and_act_steps_are_bit_identical():
    """The elastic split with fwd_bwd and optimizer phases, and the act
    step with its act phase, give the unscoped steps' bits, under the
    profiler too; the profiler sees forward inside loss inside fwd_bwd,
    backward inside fwd_bwd, and the optimizer phase."""
    scope = StepScope("split", telemetry=Telemetry("t"))
    plain_state, scoped_state = _twins(1)
    batch = _tbatch(_batch(8, pixels=False))
    grads, gm = tlearner.make_grad_step(grad_scale=2.0)(plain_state.model,
                                                        batch)
    plain_state = tlearner.make_apply_step()(plain_state, grads)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with scope.step():
            sgrads, sgm = tlearner.make_grad_step(
                grad_scale=2.0, stepscope=scope)(scoped_state.model, batch)
            scoped_state = tlearner.make_apply_step(stepscope=scope)(
                scoped_state, sgrads)
    for name in gm:
        assert torch.equal(gm[name], sgm[name]), name
    for (n, a), b in zip(plain_state.model.state_dict().items(),
                         scoped_state.model.state_dict().values()):
        assert torch.equal(a, b), n
    _assert_ledger_closes(scope, 1, ("fwd_bwd", "optimizer"))
    _assert_ranges_nest(prof, 1, [("forward", "loss"), ("loss", "fwd_bwd"),
                                  ("backward", "fwd_bwd")])
    assert len(_program_ranges(prof)["optimizer"]) == 1

    act_scope = StepScope("actor", telemetry=Telemetry("t"))
    obs = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 5)).astype(np.float32))
    done = torch.tensor([False, True, False])
    outs = []
    for stepscope in (None, act_scope):
        act = tlearner.make_act_step(plain_state.model, temperature=0.5,
                                     stepscope=stepscope)
        with act_scope.step():
            a, lg, st = act(obs, done, (), torch.Generator().manual_seed(3))  # numlint: prng-key-reuse -- both steps must draw the same actions
            with act_scope.phase("host_sync"):
                a = a.numpy()  # hotlint: sync -- the act phase's designed read of the actions
        outs.append((a, lg))
    assert (outs[0][0] == outs[1][0]).all()
    assert torch.equal(outs[0][1], outs[1][1])
    _assert_ledger_closes(act_scope, 2, ("act", "host_sync"))
    assert act_scope.summary()["phases"]["act"] > 0


def _impala_batch(seed, use_lstm, T=2, B=2):
    b = _batch(seed, pixels=True, T=T, B=B)
    rng = np.random.default_rng(seed + 100)
    b["done"] = np.zeros((T + 1, B), bool)
    b["done"][1, 0] = b["done"][2, 1] = True  # resets inside the unroll
    state = tuple(rng.standard_normal((B, 256)).astype(np.float32)
                  for _ in range(2)) if use_lstm else ()
    return b, state


def _impala_pair(batch, state, use_lstm):
    """The reference ImpalaNet with random biases (flax starts them at
    zero) and the port's with the converted weights."""
    jnet = JaxImpalaNet(num_actions=A, use_lstm=use_lstm)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(2),
                                jnp.asarray(batch["obs"]),
                                jnp.asarray(batch["done"]),
                                tuple(jnp.asarray(s) for s in state))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape)).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(x),
        params)
    net = ImpalaNet(A, use_lstm=use_lstm, device="cpu")
    net.load_state_dict(impala_params_from_flax(params))
    return jnet, params, net


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_net_train_steps_match_reference(use_lstm):
    """Two IMPALA steps of f32 ImpalaNet through make_impala_train_step
    on both sides, with experiment.py's chain; before each step the
    gradients of make_grad_step against the reference's. With the LSTM
    the batch's core_state (the state at frame 0) is a random (c, h)."""
    batches = [_impala_batch(s, use_lstm) for s in range(2)]
    jnet, params, net = _impala_pair(*batches[0], use_lstm)
    tx, opt = _experiment_optimizers(net)
    cfg = jlearner.ImpalaConfig()
    jstep = jlearner.make_impala_train_step(jnet.apply, tx, cfg,
                                            donate=False)
    jgrad = jax.grad(
        lambda p, b: jlearner.impala_loss(p, jnet.apply, b, cfg)[0])
    jstate = jlearner.make_train_state(params, tx)
    tgrad = tlearner.make_grad_step()
    tstep = tlearner.make_impala_train_step()
    tstate = tlearner.make_train_state(net, opt)
    for b, state in batches:
        jb = {**{k: jnp.asarray(v) for k, v in b.items()},
              "core_state": tuple(jnp.asarray(s) for s in state)}
        tb = {**{k: torch.from_numpy(np.array(v)) for k, v in b.items()},
              "core_state": tuple(torch.from_numpy(s) for s in state)}
        with jax.disable_jit():  # op by op (module docstring)
            want = _convert_impala(jgrad(jstate.params, jb))
            jstate, jm = jstep(jstate, jb)
        grads, _ = tgrad(net, tb)
        assert set(grads) == set(want)
        for name, g in grads.items():
            assert float(g.abs().max()) > 0, name
            _close_rel(g, want[name], 1e-4, f"grad {name}")
        tstate, tm = tstep(tstate, tb)
        for name in METRICS + ("grad_norm",):
            _close_rel(tm[name], jm[name], 1e-5, name)
        want = _convert_impala(jstate.params)
        for name, p in net.state_dict().items():
            _close_rel(p, want[name], 1e-5, name)
    assert tstate.step == int(jstate.step) == 2


def _convert_impala(tree):
    return impala_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_act_step_threads_the_lstm_state():
    """make_act_step on the LSTM ImpalaNet: the state it returns, fed
    back, gives the same logits and state as one unroll over the same
    frames, with a reset where done is set."""
    gen = torch.Generator().manual_seed(0)
    net = ImpalaNet(A, use_lstm=True, device="cpu", generator=gen)
    rng = np.random.default_rng(4)
    obs = torch.from_numpy(rng.integers(0, 256, (3, 2, 84, 84, 4),
                                        dtype=np.uint8))
    done = torch.tensor([[False, False], [False, True], [True, False]])
    act = tlearner.make_act_step(net)
    state = net.initial_state(2)
    sample = torch.Generator().manual_seed(1)
    logits = []
    for t in range(3):
        actions, lg, state = act(obs[t], done[t], state, sample)
        assert actions.shape == (2,) and ((actions >= 0) & (actions < A)).all()
        logits.append(lg)
    with torch.no_grad():
        (want, _), want_state = net(obs, done, net.initial_state(2))
    torch.testing.assert_close(torch.stack(logits), want, rtol=0, atol=1e-5)
    for got, ref in zip(state, want_state):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
