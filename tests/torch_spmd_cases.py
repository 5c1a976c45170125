"""The port's side of the multi-device parity tests: functions that every
rank of a :class:`moolib_tpu_torch.testing.spmd.SpmdWorld` runs on
numpy inputs, handing numpy back (the tests hold it against the JAX
package). Imports torch and the port only: the workers never load JAX.
"""

import numpy as np
import torch

from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.models import A2CNet, ImpalaNet, TransformerNet
from moolib_tpu_torch.optim import ClippedAdam, ClippedRMSprop
from moolib_tpu_torch.parallel import collectives
from moolib_tpu_torch.parallel import distributed as tdist
from moolib_tpu_torch.parallel import mesh as tmesh
from moolib_tpu_torch.parallel import moe as tmoe
from moolib_tpu_torch.parallel import pipeline as tpipe
from moolib_tpu_torch.parallel import tp as ttp
from moolib_tpu_torch.ops import ring_attention as tring


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return {k: _np_leaf(v) for k, v in tree.items()}


def _np_leaf(v):
    v = tmesh.local_value(v)
    return v.detach().float().numpy() if torch.is_tensor(v) else v


def _tbatch(b, core_state=()):
    return {**{k: _t(v) for k, v in b.items()}, "core_state": core_state}


# -- mesh ----------------------------------------------------------------------


def mesh_layouts(ctx):
    shapes = {}
    for kw in ({}, {"tp": 2, "sp": 2}, {"pp": 2, "ep": 2}):
        mesh = ctx.mesh(**kw)
        shapes[str(sorted(kw.items()))] = (
            tuple(mesh.shape), [mesh.get_local_rank(a) for a in tmesh.AXES])
    try:
        tmesh.make_mesh(dp=3, tp=3, device="cpu")
    except ValueError as e:
        shapes["error"] = str(e)
    return shapes


def shard_batch_case(ctx, obs, r, core):
    mesh = ctx.mesh()
    out = tmesh.shard_batch(mesh, {"obs": _t(obs), "r": _t(r),
                                   "core_state": (_t(core),)})
    return (out["obs"].numpy(), out["r"].numpy(),
            out["core_state"][0].numpy())


def psum_case(ctx, values):
    mesh = ctx.mesh()
    mine = {"g": torch.tensor([values[ctx.rank]])}
    return (tmesh.psum_gradients(mine, mesh)["g"].numpy(),
            tmesh.pmean_gradients(mine, mesh)["g"].numpy())


def a2c_dp_grads(ctx, state_dict, obs, done):
    """dp_average_grads of each rank's gradients of its local mean loss."""
    mesh = ctx.mesh()
    net = A2CNet(3, obs.shape[-1], hidden_sizes=(16,), device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    local = tmesh.shard_batch(mesh, {"obs": _t(obs), "done": _t(done)})
    (logits, baseline), _ = net(local["obs"], local["done"], ())
    loss = torch.mean(logits ** 2) + torch.mean(baseline ** 2)
    names = [n for n, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        net.parameters()))))
    return _np(tmesh.dp_average_grads(grads, mesh))


def _transformer(state_dict, obs_shape, backend="dense", **kw):
    net = TransformerNet(6, obs_shape, attention_backend=backend,
                         device="cpu", d_model=32, num_layers=2,
                         num_heads=2, **kw)
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    return net


def _rmsprop(net):
    return ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                          max_norm=40.0)


def dp_train_step(ctx, state_dict, batch, dp):
    """One IMPALA step of the TransformerNet over a mesh of ``dp`` ranks
    along dp (the rest of the world along sp, which the step ignores)."""
    mesh = ctx.mesh(dp=dp, sp=ctx.world // dp)
    net = _transformer(state_dict, batch["obs"].shape[2:])
    state = tlearner.make_train_state(net, _rmsprop(net))
    step = tlearner.make_impala_train_step(mesh=mesh)
    state, metrics = step(state, _tbatch(batch))
    return _np(dict(net.named_parameters())), _np(metrics)


def dp_grad_step(ctx, state_dict, batch):
    mesh = ctx.mesh()
    net = _transformer(state_dict, batch["obs"].shape[2:])
    grads, metrics = tlearner.make_grad_step(mesh=mesh)(net, _tbatch(batch))
    return _np(grads), _np(metrics)


def dp1_bitwise(ctx, state_dict, batch):
    """A dp=1 mesh's step against the plain step from the same state:
    every rank compares its two results bit for bit."""
    def run(mesh):
        net = _transformer(state_dict, batch["obs"].shape[2:])
        state = tlearner.make_train_state(net, _rmsprop(net))
        step = tlearner.make_impala_train_step(mesh=mesh)
        state, m = step(state, _tbatch(batch))
        state, m = step(state, _tbatch(batch))
        return (_np(dict(net.named_parameters())), _np(m),
                {n: _np_leaf(state.optimizer.state[p]["nu"])
                 for n, p in net.named_parameters()})
    mesh = ctx.mesh(dp=1, sp=ctx.world)
    return run(mesh), run(None)


# -- distributed -----------------------------------------------------------------


def distributed_bringup(ctx):
    tdist.initialize("unused:0", ctx.world, ctx.rank, "gloo")  # idempotent
    out = {"initialized": tdist.is_initialized(),
           "count": tdist.process_count(), "index": tdist.process_index(),
           "shape": tuple(tdist.global_mesh(device="cpu").shape)}
    for what, rank, backend in (("backend", ctx.rank, "mpi"),
                                ("rank", (ctx.rank + 1) % ctx.world,
                                 "gloo")):
        try:
            tdist.initialize("unused:0", ctx.world, rank, backend)
        except (ValueError, RuntimeError) as e:
            out[what] = type(e).__name__
    return out


def distributed_train_step(ctx, state_dict, local_batches):
    """The reference's two-controller step: every process feeds its own
    rollouts through host_local_batch_to_global into one dp step."""
    mesh = tdist.global_mesh(device="cpu")
    local = local_batches[ctx.rank]
    net = ImpalaNet(4, local["obs"].shape[2:], channels=(4,),
                    device="cpu")
    gen = torch.Generator().manual_seed(ctx.rank)  # ranks start apart
    net.reset_parameters(gen)
    state = tlearner.make_train_state(net, _rmsprop(net))
    if ctx.rank == 0:
        net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    state = tlearner.replicate_state(state, mesh)
    batch = tdist.host_local_batch_to_global(mesh, _tbatch(local))
    shape = tuple(batch["obs"].shape)
    step = tlearner.make_impala_train_step(mesh=mesh)
    state, metrics = step(state, batch)
    return (shape, _np(dict(net.named_parameters())), _np(metrics),
            state.step)


# -- ring attention ------------------------------------------------------------


def ring_case(ctx, q, k, v, seg, causal, n, zigzag=False):
    """The global wrappers over an sp axis of ``n``; o and the gradients
    of sum(o**2) (global on every rank)."""
    mesh = ctx.mesh(dp=ctx.world // n, sp=n)
    q, k, v = (_t(x).requires_grad_() for x in (q, k, v))
    s = None if seg is None else _t(seg)
    if zigzag:
        o = tring.zigzag_sharded_attention(mesh, q, k, v, segment_ids=s)
    else:
        o = tring.sequence_sharded_attention(mesh, q, k, v, causal=causal,
                                             segment_ids=s)
    (o ** 2).sum().backward()
    return [x.detach().numpy() for x in (o, q.grad, k.grad, v.grad)]


def ring_local_grads(ctx, q, k, v, n):
    """ring_attention on this rank's shards, loss on its own rows; the
    rank's dq rows (the reference's shard_map gradient)."""
    mesh = ctx.mesh(dp=ctx.world // n, sp=n)
    i = mesh.get_local_rank("sp")
    q = _t(q).chunk(n, 2)[i].contiguous().requires_grad_()
    k, v = (_t(x).chunk(n, 2)[i].contiguous() for x in (k, v))
    o = tring.ring_attention(q, k, v, mesh, causal=True)
    (o ** 2).sum().backward()
    return q.grad.numpy()


def transformer_ring_case(ctx, state_dict, obs, done, seg, n, backend,
                          train):
    """TransformerNet with a ring backend on this rank's T shard (zigzag
    layout for zigzag); logits and baseline of the rank's rows, and with
    ``train`` the gradients of the per-shard partial loss summed over sp."""
    mesh = ctx.mesh(dp=ctx.world // n, sp=n)
    i = mesh.get_local_rank("sp")
    T, B, F = obs.shape
    pos = np.arange(T)
    if backend == "zigzag":
        perm = tring.zigzag_order(n, T)
        obs, done, seg, pos = obs[perm], done[perm], seg[:, perm], pos[perm]
    rows = slice(i * T // n, (i + 1) * T // n)
    net = TransformerNet(3, (F,), attention_backend=backend, mesh=mesh,
                         device="cpu", d_model=16, num_layers=1,
                         num_heads=2, max_len=T)
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    (l, b), _ = net(_t(obs[rows]), _t(done[rows]), (),
                    segment_ids=_t(seg[:, rows]), positions=_t(pos[rows]))
    out = {"rows": np.asarray(pos[rows]), "logits": l.detach().numpy(),
           "baseline": b.detach().numpy()}
    if train:
        s = torch.sum(l ** 2) + 3 * torch.sum(b ** 2)
        loss = s / (T * B * 3)
        names = [n_ for n_, _ in net.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(
            net.parameters()))))
        out["grads"] = _np(tmesh.psum_gradients(grads, mesh, "sp"))
    return out


# -- tensor parallelism ----------------------------------------------------------


def _tp_net(state_dict, obs_shape):
    net = TransformerNet(4, obs_shape, attention_backend="dense",
                         device="cpu", d_model=16, num_layers=1,
                         num_heads=2)
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    return net


def tp_forward(ctx, state_dict, obs, done):
    mesh = ctx.mesh(dp=ctx.world // 2, tp=2)
    net = _tp_net(state_dict, obs.shape[2:])
    specs = ttp.transformer_tp_specs(net)
    ttp.shard_params(mesh, net, specs)
    local = tmesh.shard_batch(mesh, {"obs": _t(obs), "done": _t(done)})
    with torch.no_grad():
        (l, b), _ = net(local["obs"], local["done"], ())
    shapes = {n: tuple(tmesh.local_value(p).shape)
              for n, p in net.named_parameters()}
    return l.numpy(), b.numpy(), shapes, mesh.get_local_rank("dp")


def tp_train_step(ctx, state_dict, batch):
    """dp=2 x tp=2: one Adam step, the reference's tp test's."""
    mesh = ctx.mesh(dp=ctx.world // 2, tp=2)
    net = _tp_net(state_dict, batch["obs"].shape[2:])
    ttp.shard_params(mesh, net, ttp.transformer_tp_specs(net))
    opt = ClippedAdam(net.parameters(), 1e-3)
    ttp.sharded_init_opt_state(opt, net)
    state = tlearner.make_train_state(net, opt)
    state, metrics = tlearner.make_impala_train_step(mesh=mesh)(
        state, _tbatch(batch))
    # Every rank's shards, to be put together by the test.
    return ({n: _np_leaf(p) for n, p in net.named_parameters()},
            _np(metrics), mesh.get_local_rank("tp"))


def impala_tp_forward(ctx, state_dict, obs, done, use_lstm):
    mesh = ctx.mesh(dp=ctx.world // 2, tp=2)
    net = ImpalaNet(6, obs.shape[2:], use_lstm=use_lstm, device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    specs = ttp.impala_tp_specs(net)
    ttp.shard_params(mesh, net, specs)
    with torch.no_grad():
        (l, b), _ = net(_t(obs), _t(done), net.initial_state(obs.shape[1]))
    return (l.numpy(), b.numpy(),
            tuple(net.fc.weight.to_local().shape),
            ttp.count_sharded_leaves(specs))


# -- pipelines -------------------------------------------------------------------


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_gpipe(ctx, stages, x, n_stages, remat, grads):
    mesh = ctx.mesh(dp=ctx.world // n_stages, pp=n_stages)
    stacked = tpipe.stack_stage_params(
        [{k: _t(v) for k, v in s.items()} for s in stages])
    mine = {k: v.requires_grad_() for k, v in
            tpipe.stage_slice(stacked, mesh).items()}
    x_sh = tpipe.shard_microbatches(_t(x), n_stages)
    local = tmesh.shard_batch(mesh, x_sh, axis_name="pp")
    y = tpipe.pipeline_apply(_stage_fn, mine, local, mesh, remat=remat)
    out = {"y": y.detach().numpy(), "pp": mesh.get_local_rank("pp")}
    if grads:
        torch.sum(y ** 2).backward()
        out["grads"] = {k: v.grad.numpy() for k, v in mine.items()}
    return out


def pipeline_1f1b(ctx, stages, x, n_stages):
    mesh = ctx.mesh(dp=ctx.world // n_stages, pp=n_stages)
    stacked = tpipe.stack_stage_params(
        [{k: _t(v) for k, v in s.items()} for s in stages])
    loss, grads = tpipe.pipeline_train_1f1b(
        _stage_fn, lambda y: torch.sum(y ** 2),
        tpipe.stage_slice(stacked, mesh), _t(x), mesh)
    return (float(loss), {k: v.numpy() for k, v in grads.items()},
            mesh.get_local_rank("pp"))


# -- expert parallelism ----------------------------------------------------------


def moe_sharded(ctx, params, x, capacity, top_k):
    """moe_ffn_sharded over ep=world: this rank's tokens and experts;
    the output rows, the aux and the gradients of the dry run's loss
    (expert gradients this rank's, the router's summed over ep)."""
    mesh = ctx.mesh(ep=ctx.world)
    g, G = mesh.get_local_rank("ep"), ctx.world
    p = {"router": _t(params["router"]).requires_grad_(),
         "w_up": _t(params["w_up"]).chunk(G)[g].contiguous()
         .requires_grad_(),
         "w_down": _t(params["w_down"]).chunk(G)[g].contiguous()
         .requires_grad_()}
    xs = _t(x).chunk(G)[g].contiguous()
    y, aux = tmoe.moe_ffn_sharded(p, xs, capacity, mesh=mesh, top_k=top_k)
    loss = torch.sum(y ** 2) + 0.01 * aux["load_balance_loss"]
    loss.backward()
    grads = {k: v.grad for k, v in p.items()}
    grads["router"] = tmesh.psum_gradients({"r": grads["router"]}, mesh,
                                           "ep")["r"]
    return (y.detach().numpy(),
            {k: float(v.detach()) for k, v in aux.items()},
            {k: v.numpy() for k, v in grads.items()}, g)


def collectives_backends(ctx):
    """The transport table: gloo moves host tensors, refuses none here;
    an unknown pairing raises."""
    group = ctx.mesh().get_group("dp")
    out = {"cpu": collectives.transport(group, torch.device("cpu"))}
    try:
        collectives.transport(group, torch.device("meta"))
    except RuntimeError as e:
        out["meta"] = str(e)
    return out


def pipeline_memory(ctx, kind, n_stages, mb, F, n_micro):
    """Peak card memory of one rank's pipeline run (torch's allocator):
    ``temp`` above what the inputs hold, ``total`` with them. ``kind``:
    "forward" (pipeline_apply, no graph), "gpipe" and "remat" (its loss
    and backward), "1f1b" (pipeline_train_1f1b on the whole stream)."""
    dev = ctx.device
    mesh = ctx.mesh(dp=ctx.world // n_stages, pp=n_stages)
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.standard_normal((F, F)) * 0.5).astype(np.float32),
               "b": (rng.standard_normal(F) * 0.1).astype(np.float32)}
              for _ in range(n_stages)]
    x = rng.standard_normal((n_micro, mb, F)).astype(np.float32)
    # The first matmul allocates cuBLAS's workspace: before the baseline.
    torch.ones(F, F, device=dev) @ torch.ones(F, F, device=dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    stacked = tpipe.stack_stage_params(
        [{k: _t(v) for k, v in s.items()} for s in stages])
    mine = {k: v.to(dev).requires_grad_(kind in ("gpipe", "remat"))
            for k, v in tpipe.stage_slice(stacked, mesh).items()}
    if kind == "1f1b":
        xs = _t(x).to(dev)
    else:
        xs = tmesh.shard_batch(mesh, tpipe.shard_microbatches(_t(x),
                                                              n_stages),
                               axis_name="pp").contiguous().to(dev)
    torch.cuda.synchronize(dev)
    inputs = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if kind == "forward":
        with torch.no_grad():
            tpipe.pipeline_apply(_stage_fn, mine, xs, mesh)
    elif kind == "1f1b":
        tpipe.pipeline_train_1f1b(_stage_fn, lambda y: torch.sum(y ** 2),
                                  mine, xs, mesh)
    else:
        y = tpipe.pipeline_apply(_stage_fn, mine, xs, mesh,
                                 remat=kind == "remat")
        torch.sum(y ** 2).backward()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"temp": peak - inputs, "total": peak - before}
