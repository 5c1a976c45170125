#!/usr/bin/env python3
"""Allreduce throughput of the port's RPC tree: the twin of
``bench_allreduce.py``'s ``dcn_rpc_tree`` plane.

    python3 bench_allreduce_torch.py [--peers 4] [--sizes 65536 1048576 8388608]

One OS process per peer (spawned), each a ``moolib_tpu_torch`` Rpc in one
Group behind a port Broker in this process, all over loopback. Per size:
one warm-up round, then 5 timed rounds of an f32 sum of that many floats;
every result is checked (the sum of the ranks). Prints one JSON line per
size with the reference's keys: {"plane": "dcn_rpc_tree", "peers", "mb",
"ms", "gbps"}, where gbps is the algorithm bandwidth (each peer
contributes and receives the whole buffer once a round). The reference's
second plane, a psum over the devices' interconnect, has no port yet
(ROADMAP queue A, item 11, multi-device): the script says so on one line
of its own. Rows for a trend store wait for item 12. Imports nothing of
JAX or of the JAX package.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                    help="floats per reduce")
    args = ap.parse_args(argv)
    bench_rpc_tree(args.peers, args.sizes)
    print("bench_allreduce_torch: the ici_psum plane (a psum over the "
          "devices' interconnect) waits for ROADMAP queue A item 11 "
          "(multi-device)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
