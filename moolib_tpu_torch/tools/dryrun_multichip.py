"""The multi-device dry run: the twin of ``__graft_entry__.py``'s
``dryrun_multichip``.

    python -m moolib_tpu_torch.tools.dryrun_multichip 4

One process per rank runs, on tiny shapes, the full IMPALA train step of
the flagship ImpalaNet (LSTM) data parallel over every rank (V-trace
loss, backward, the dp gradient mean, the optimizer), then the
sequence (ring-attention TransformerNet, loss and gradients), tensor
(the TransformerNet train step on a dp x tp mesh), pipeline (GPipe
forward and gradients) and expert (the all-to-all MoE, loss and
gradients) legs; each checks its loss and gradients are finite (and
the gradients non-zero).

With ``torch.cuda.device_count()`` at least N the ranks are N processes
on the cards over NCCL; otherwise the run provisions itself as N gloo
processes on the CPU, as the reference provisions a CPU child with N
virtual devices. Prints one line per leg from rank 0 and a last line
``dryrun_multichip(N) ok on N <device> ranks (<backend>)``; exits
non-zero if any rank fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

__all__ = ["dryrun_multichip", "dryrun_body"]

TIMEOUT_S = 600.0


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap: 6 ranks give a 3-stage
    pipeline, not a 1x4 mesh over 6."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _finite(x) -> float:
    import torch

    v = float(torch.as_tensor(x).detach().float().sum())
    if v != v or v in (float("inf"), float("-inf")):
        raise RuntimeError(f"non-finite value {v}")
    return v


def _grad_l1(grads) -> float:
    from ..parallel.mesh import local_value

    total = sum(float(local_value(g).detach().abs().sum())
                for g in grads if g is not None)
    if not total > 0 or total != total:
        raise RuntimeError(f"gradients missing or non-finite: {total}")
    return total


def _same_everywhere(device):
    """A seeded generator: every rank draws the same weights."""
    import torch

    return torch.Generator(device=device).manual_seed(0)


def _leg_dp(n: int, device):
    import numpy as np
    import torch

    from ..learner import (ImpalaConfig, make_impala_train_step,
                           make_train_state, replicate_state)
    from ..models import ImpalaNet
    from ..optim import ClippedAdam
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(dp=n, device=device)
    net = ImpalaNet(4, (8, 8, 1), channels=(4,), use_lstm=True,
                    lstm_size=8, device=device)
    T, B = 2, 2 * n
    rng = np.random.default_rng(0)
    batch = {
        "obs": torch.from_numpy(rng.integers(0, 255, (T + 1, B, 8, 8, 1),
                                             dtype=np.uint8)),
        "done": torch.from_numpy(rng.random((T + 1, B)) < 0.1),
        "rewards": torch.from_numpy(
            rng.standard_normal((T + 1, B)).astype(np.float32)),
        "actions": torch.from_numpy(rng.integers(0, 4, (T, B))),
        "behavior_logits": torch.zeros((T, B, 4)),
        "core_state": net.initial_state(B),
    }
    batch = {k: tuple(t.to(device) for t in v) if k == "core_state"
             else v.to(device) for k, v in batch.items()}
    state = replicate_state(make_train_state(
        net, ClippedAdam(net.parameters(), 6e-4, max_norm=40.0)), mesh)
    step = make_impala_train_step(config=ImpalaConfig(), mesh=mesh)
    state, metrics = step(state, batch)
    if state.step != 1:
        raise RuntimeError(f"step count {state.step}")
    return f"loss {_finite(metrics['total_loss']):.6f}"


def _leg_sp(n: int, device):
    import numpy as np
    import torch

    from ..models import TransformerNet, segment_ids_from_done
    from ..parallel import collectives
    from ..parallel.mesh import make_mesh, psum_gradients

    mesh = make_mesh(dp=1, sp=n, device=device)
    i = mesh.get_local_rank("sp")
    T, B, F = 4 * n, 2, 5
    rng = np.random.default_rng(0)
    obs = torch.from_numpy(rng.standard_normal((T, B, F)).astype(
        np.float32)).to(device)
    done = torch.from_numpy(rng.random((T, B)) < 0.1).to(device)
    seg = segment_ids_from_done(done)  # globally correct, [B, T]
    rows = slice(i * 4, (i + 1) * 4)
    net = TransformerNet(3, (F,), d_model=16, num_layers=1, num_heads=2,
                         attention_backend="ring", mesh=mesh, device=device,
                         generator=_same_everywhere(device))
    (logits, baseline), _ = net(obs[rows], done[rows], (),
                                segment_ids=seg[:, rows],
                                positions=torch.arange(T, device=device)
                                [rows])
    local = torch.mean(logits ** 2) + torch.mean(baseline ** 2)
    loss = collectives.pmean(local, mesh, "sp")
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    grads = psum_gradients(dict(zip(names, grads)), mesh, "sp")
    return (f"loss {_finite(loss):.6f} |grad|_1 "
            f"{_grad_l1(grads.values()):.6f}")


def _leg_tp(n: int, device):
    import numpy as np
    import torch

    from ..learner import make_impala_train_step, make_train_state
    from ..models import TransformerNet
    from ..optim import ClippedAdam
    from ..parallel import tp as tp_ops
    from ..parallel.mesh import make_mesh

    tp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=n // tp, tp=tp, device=device)
    net = TransformerNet(4, (5,), d_model=16, num_layers=1, num_heads=2,
                         attention_backend="dense", device=device,
                         generator=_same_everywhere(device))
    T, B, F, A = 4, 2 * (n // tp), 5, 4
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((T + 1, B, F)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.1,
        "rewards": rng.standard_normal((T + 1, B)).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)),
        "behavior_logits": np.zeros((T, B, A), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    batch["core_state"] = ()
    tp_ops.shard_params(mesh, net, tp_ops.transformer_tp_specs(net))
    opt = ClippedAdam(net.parameters(), 1e-3)
    tp_ops.sharded_init_opt_state(opt, net)
    state, metrics = make_impala_train_step(mesh=mesh)(
        make_train_state(net, opt), batch)
    qkv = net.blocks[0].attn.qkv.weight
    if tp > 1 and tuple(qkv.to_local().shape) == tuple(qkv.shape):
        raise RuntimeError("tp parameters not actually distributed")
    return f"tp={tp} loss {_finite(metrics['total_loss']):.6f}"


def _leg_pp(n: int, device):
    import numpy as np
    import torch

    from ..parallel import pipeline
    from ..parallel.mesh import make_mesh, shard_batch

    pp = _largest_divisor(n, 4)
    mesh = make_mesh(dp=n // pp, pp=pp, device=device)
    rng = np.random.default_rng(0)
    F, mb, n_micro = 8, 2, 2 * pp
    stages = [{"w": torch.from_numpy((rng.standard_normal((F, F)) * 0.3)
                                     .astype(np.float32)).to(device)}
              for _ in range(pp)]
    x = torch.from_numpy(rng.standard_normal((n_micro, mb, F)).astype(
        np.float32)).to(device)
    mine = {k: v.requires_grad_() for k, v in pipeline.stage_slice(
        pipeline.stack_stage_params(stages), mesh).items()}
    local = shard_batch(mesh, pipeline.shard_microbatches(x, pp),
                        axis_name="pp")
    y = pipeline.pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]), mine,
                                local, mesh)
    loss = torch.sum(y ** 2)
    loss.backward()
    return (f"pp={pp} loss {_finite(loss):.6f} |grad|_1 "
            f"{_grad_l1([mine['w'].grad]):.6f}")


def _leg_ep(n: int, device):
    import numpy as np
    import torch

    from ..parallel.mesh import make_mesh
    from ..parallel.moe import moe_ffn_sharded, moe_params

    ep = _largest_divisor(n, 4)
    mesh = make_mesh(dp=n // ep, ep=ep, device=device)
    g = mesh.get_local_rank("ep")
    # Equal token shards: every rank seats the same capacity.
    T, D, H, E = (16 if 16 % ep == 0 else 16 * ep), 8, 12, ep
    params = moe_params(D, H, E, device=device,
                        generator=torch.Generator().manual_seed(0))
    local = {"router": params["router"].requires_grad_(),
             "w_up": params["w_up"][g:g + 1].clone().requires_grad_(),
             "w_down": params["w_down"][g:g + 1].clone().requires_grad_()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    xs = x.to(device).chunk(ep)[g]
    top_k = min(2, E)  # E=1 at prime rank counts
    y, aux = moe_ffn_sharded(local, xs, T // ep, mesh=mesh, top_k=top_k)
    loss = torch.sum(y ** 2) + 0.01 * aux["load_balance_loss"]
    loss.backward()
    return (f"ep={ep} loss {_finite(loss):.6f} |grad|_1 "
            f"{_grad_l1(p.grad for p in local.values()):.6f}")


LEGS = (("dp", _leg_dp), ("sp", _leg_sp), ("tp", _leg_tp),
        ("pp", _leg_pp), ("ep", _leg_ep))


def dryrun_body(n: int, rank: int, store_path: str, backend: str) -> None:
    """One rank of the dry run."""
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank) if backend == "nccl" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        for name, leg in LEGS:
            line = leg(n, device)
            if rank == 0:
                print(f"dryrun leg {name} ok: {line}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, timeout: float = TIMEOUT_S) -> str:
    """Run the dry run on ``n`` ranks in child processes; returns the
    last line. Raises if a rank fails or the run outlasts ``timeout``."""
    import torch

    backend = "nccl" if torch.cuda.is_available() and \
        torch.cuda.device_count() >= n else "gloo"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "moolib_tpu_torch.tools.dryrun_multichip",
             "--body", str(n), str(r), store, backend], env=env)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for r, p in enumerate(procs):
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if rc != 0:
                    raise RuntimeError(f"dry run rank {r} exited {rc}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    device = "cuda" if backend == "nccl" else "cpu"
    line = f"dryrun_multichip({n}) ok on {n} {device} ranks ({backend})"
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--body"]:
        n, rank, store, backend = argv[1:5]
        dryrun_body(int(n), int(rank), store, backend)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
