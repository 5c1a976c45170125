#!/usr/bin/env python3
"""Allreduce throughput of the port's two planes: the twin of
``bench_allreduce.py``.

    python3 bench_allreduce_torch.py [--peers 4] [--sizes 65536 1048576 8388608]
                                     [--psum-backend nccl|gloo] [--psum-ranks N]

1. ``dcn_rpc_tree``: one OS process per peer (spawned), each a
   ``moolib_tpu_torch`` Rpc in one Group behind a port Broker in this
   process, all over loopback. Per size: one warm-up round, then 5 timed
   rounds of an f32 sum of that many floats; every result is checked
   (the sum of the ranks).
2. The psum plane (``bench_ici_psum``'s twin): one process per rank in a
   ``torch.distributed`` world, an ``all_reduce`` of each of
   ``PSUM_SIZES`` floats, one warm-up and 10 timed rounds. Over NCCL it
   runs on ``torch.cuda.device_count()`` cards and is named
   ``nccl_psum``; over gloo it runs ``--psum-ranks`` host processes and
   is named ``cpu_psum_protocol_check``, as the reference labels a psum
   that is no interconnect measurement. With one device it prints the
   reference's single-device note and nothing else.

Each prints one JSON line per size with the reference's keys:
{"plane", "peers", "mb", "ms", "gbps"}, where gbps is the algorithm
bandwidth (each peer contributes and receives the whole buffer once a
round). Rows for a trend store wait for ROADMAP queue A item 12.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import json
import threading
import time

SIZES = (2**16, 2**20, 2**23)
ROUNDS = 5


def _tree_worker(rank: int, n_peers: int, addr: str, sizes, out_q):
    """One peer: join the group, then reduce each size once to warm up and
    ROUNDS times timed; rank 0 reports the mean round time."""
    import numpy as np

    import moolib_tpu_torch
    from moolib_tpu_torch.rpc import Group

    moolib_tpu_torch.set_log_level("error")
    rpc = moolib_tpu_torch.Rpc(f"bench-{rank}")
    rpc.listen("127.0.0.1:0")
    rpc.connect(addr)
    group = Group(rpc, group_name="bench", timeout=120.0)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        group.update()
        if len(group.members) == n_peers and group.active():
            break
        time.sleep(0.02)
    else:
        out_q.put(("error", rank, "group never stabilized"))
        rpc.close()
        return

    stop = threading.Event()

    def pump():
        while not stop.is_set():
            group.update()
            time.sleep(0.05)

    threading.Thread(target=pump, daemon=True).start()
    try:
        for size in sizes:
            data = np.full(size, float(rank), np.float32)
            group.all_reduce(f"warm.{size}", data).result(timeout=120)
            t0 = time.perf_counter()
            for r in range(ROUNDS):
                result = group.all_reduce(f"r{r}.{size}", data).result(
                    timeout=120)
            dt = (time.perf_counter() - t0) / ROUNDS
            expect = float(sum(range(n_peers)))
            if not (result[0] == expect and result[-1] == expect):
                raise RuntimeError(f"sum {result[0]} != {expect}")
            if rank == 0:
                out_q.put(("result", size, dt))
    except (asyncio.CancelledError, concurrent.futures.CancelledError):
        raise  # never swallow task cancellation
    except Exception as e:
        out_q.put(("error", rank, f"{type(e).__name__}: {e}"))
    finally:
        stop.set()
        group.close()
        rpc.close()


def bench_rpc_tree(n_peers: int = 4, sizes=SIZES, timeout: float = 300.0):
    """Run the tree allreduce sweep; returns the JSON rows it printed."""
    import multiprocessing as mp

    import moolib_tpu_torch
    from moolib_tpu_torch.rpc.broker import Broker

    moolib_tpu_torch.set_log_level("error")
    broker_rpc = moolib_tpu_torch.Rpc("broker")
    broker_rpc.listen("127.0.0.1:0")
    addr = broker_rpc.debug_info()["listen"][0]
    broker = Broker(broker_rpc)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            broker.update()
            time.sleep(0.02)

    threading.Thread(target=pump, daemon=True).start()
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_tree_worker,
                         args=(i, n_peers, addr, tuple(sizes), out_q),
                         daemon=True)
             for i in range(n_peers)]
    for p in procs:
        p.start()
    rows = []
    try:
        for _ in sizes:
            kind, a, b = out_q.get(timeout=timeout)
            if kind == "error":
                raise RuntimeError(f"worker {a}: {b}")
            size, dt = a, b
            row = {"plane": "dcn_rpc_tree", "peers": n_peers,
                   "mb": round(size * 4 / 1e6, 2),
                   "ms": round(dt * 1e3, 2),
                   "gbps": round(size * 4 * n_peers / dt / 1e9, 3)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        stop.set()
        broker_rpc.close()
    return rows


PSUM_SIZES = (2**20, 2**23, 2**25)
PSUM_ROUNDS = 10
PSUM_PLANES = {"nccl": "nccl_psum", "gloo": "cpu_psum_protocol_check"}


def _psum_worker(rank: int, n: int, store_path: str, backend: str, sizes,
                 out_q) -> None:
    """One rank: reduce each size once to warm up and PSUM_ROUNDS times
    timed; rank 0 reports the mean round time. Every result is checked
    (the sum over ranks of 1)."""
    import torch
    import torch.distributed as dist

    try:
        device = torch.device("cuda", rank) if backend == "nccl" \
            else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        for size in sizes:
            x = torch.ones(size, device=device)
            dist.all_reduce(x)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PSUM_ROUNDS):
                x.fill_(1.0)
                dist.all_reduce(x)
            if device.type == "cuda":
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / PSUM_ROUNDS
            if not (float(x[0]) == n and float(x[-1]) == n):
                raise RuntimeError(f"psum {float(x[0])} != {n}")
            if rank == 0:
                out_q.put(("result", size, dt))
        dist.destroy_process_group()
    except Exception as e:  # reported to the parent, which raises
        out_q.put(("error", rank, f"{type(e).__name__}: {e}"))


def bench_psum(backend: str = "nccl", n_ranks=None, sizes=PSUM_SIZES,
               timeout: float = 300.0):
    """The psum plane over ``backend`` (``"nccl"``: one process per card;
    ``"gloo"``: ``n_ranks`` host processes); returns the JSON rows it
    printed."""
    import multiprocessing as mp
    import os
    import tempfile

    if backend not in PSUM_PLANES:
        raise ValueError(f"backend must be one of {sorted(PSUM_PLANES)}")
    plane = PSUM_PLANES[backend]
    if backend == "nccl":
        import torch

        n = torch.cuda.device_count() if n_ranks is None else n_ranks
    else:
        n = 2 if n_ranks is None else n_ranks
    if n < 2:
        row = {"plane": plane, "peers": n,
               "note": "single device: psum is a no-op, nothing to measure"}
        print(json.dumps(row), flush=True)
        return [row]
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_psum_worker,
                             args=(r, n, store, backend, tuple(sizes), out_q),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        try:
            for _ in sizes:
                kind, a, b = out_q.get(timeout=timeout)
                if kind == "error":
                    raise RuntimeError(f"rank {a}: {b}")
                row = {"plane": plane, "peers": n,
                       "mb": round(a * 4 / 1e6, 2),
                       "ms": round(b * 1e3, 2),
                       "gbps": round(a * 4 * n / b / 1e9, 3)}
                print(json.dumps(row), flush=True)
                rows.append(row)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                    help="floats per reduce")
    ap.add_argument("--psum-backend", choices=sorted(PSUM_PLANES),
                    default="nccl")
    ap.add_argument("--psum-ranks", type=int, default=None,
                    help="ranks of the psum plane (default: the cards for "
                         "nccl, 2 for gloo)")
    args = ap.parse_args(argv)
    bench_rpc_tree(args.peers, args.sizes)
    bench_psum(args.psum_backend, args.psum_ranks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
