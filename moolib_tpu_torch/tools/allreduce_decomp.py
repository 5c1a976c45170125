"""Decomposition of the tree-allreduce loopback benchmark; the twin of the
reference's ``tools/allreduce_decomp.py``.

It measures the host's primitive costs (single-core memcpy, numpy
elementwise add, cross-process unix-socket transfer, the port's RPC
small-call overhead), derives the roofline of an n-peer binary-tree
allreduce whose peers all share this host's cores (the loopback bench
topology: all peers + broker on one host), and compares it with the
measured tree bandwidth of ``bench_allreduce_torch.bench_rpc_tree``.

The host's core count is read (``os.cpu_count()``) and reported as
``cpu_count``: a loopback allreduce time-slices every peer's copies,
adds and syscalls onto those cores, so the measured "GB/s" is an
aggregate-CPU number, not a per-link bandwidth. On a real multi-host
deployment each peer runs its ~4 copy passes per payload on its own
cores, and per-link wire bandwidth binds instead.

Tree cost model (per full payload of S bytes, binary tree, p peers):

- hops: 2*(p-1) socket transfers of S bytes (up the tree + broadcast
  down), each costing S / socket_GBps core-seconds (send+recv side
  combined — measured cross-process, so both sides' CPU is included);
- merges: each interior node merges one payload per child, p-1 adds of S
  bytes at the measured np.add rate;
- per-message overhead: ceil(S/chunk) chunks * 2*(p-1) data messages * 2
  (request + response) * measured per-call RPC overhead;
- reassembly: one S-byte concatenate at memcpy rate.

Usage::

    python -m moolib_tpu_torch.tools.allreduce_decomp [--json OUT] \\
        [--peers 4] [--mb 32] [--skip-measured]
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import socket
import sys
import time
from contextlib import redirect_stdout

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _time(f, reps=8):
    f()
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    return (time.perf_counter() - t0) / reps


def measure_primitives(nbytes: int) -> dict:
    n = nbytes // 4
    a = np.ones(n, np.float32)
    b = np.ones(n, np.float32)
    out = np.empty_like(a)

    memcpy_s = _time(lambda: np.copyto(out, a))
    add_s = _time(lambda: np.add(a, b, out=out))

    # Cross-process unix socket: includes BOTH sides' CPU, which is
    # exactly the loopback-topology cost.
    payload = memoryview(bytearray(1 << 20))
    reps = max(8, nbytes // (1 << 20))
    r, w = socket.socketpair()
    for s in (r, w):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    pid = os.fork()
    if pid == 0:
        w.close()
        buf = bytearray(1 << 20)
        got = 0
        target = reps * len(payload)
        while got < target:
            got += r.recv_into(buf)
        os._exit(0)
    r.close()
    t0 = time.perf_counter()
    for _ in range(reps):
        w.sendall(payload)
    os.waitpid(pid, 0)
    sock_s_per_mb = (time.perf_counter() - t0) / reps
    w.close()

    return {
        "nproc": os.cpu_count(),
        "memcpy_gbps": round(nbytes / memcpy_s / 1e9, 2),
        "np_add_payload_gbps": round(nbytes / add_s / 1e9, 2),
        "socket_xproc_gbps": round((1 << 20) / sock_s_per_mb / 1e9, 2),
        "_memcpy_s_per_byte": memcpy_s / nbytes,
        "_add_s_per_byte": add_s / nbytes,
        "_sock_s_per_byte": sock_s_per_mb / (1 << 20),
    }


def measure_rpc_overhead() -> float:
    """Per-call overhead of a small round trip between two port Rpcs
    (seconds)."""
    from .. import set_log_level
    from ..rpc import Rpc

    set_log_level("error")
    a = Rpc("decomp-a")
    a.listen("127.0.0.1:0")
    addr = a.debug_info()["listen"][0]
    b = Rpc("decomp-b")
    b.connect(addr)
    a.define("nop", lambda: None, inline=True)
    try:
        for _ in range(20):
            b.sync("decomp-a", "nop")
        reps = 300
        t0 = time.perf_counter()
        for _ in range(reps):
            b.sync("decomp-a", "nop")
        return (time.perf_counter() - t0) / reps
    finally:
        a.close()
        b.close()


def tree_roofline(
    prims: dict, rpc_call_s: float, nbytes: int, peers: int, chunk: int
) -> dict:
    # Binary tree with p peers: every peer except the root has one parent
    # edge; each edge carries the payload up once and the result down once.
    hops = 2 * (peers - 1)
    # Each parent merges one incoming payload per child = (p-1) merges total.
    merges = peers - 1
    hop_s = hops * nbytes * prims["_sock_s_per_byte"]
    merge_s = merges * nbytes * prims["_add_s_per_byte"]
    n_chunks = math.ceil(nbytes / chunk)
    msg_s = n_chunks * hops * 2 * rpc_call_s / 2  # req+resp; resp ~half cost
    reassembly_s = nbytes * prims["_memcpy_s_per_byte"]
    total = hop_s + merge_s + msg_s + reassembly_s
    return {
        "hop_s": round(hop_s, 4),
        "merge_s": round(merge_s, 4),
        "msg_overhead_s": round(msg_s, 4),
        "reassembly_s": round(reassembly_s, 4),
        "total_s": round(total, 4),
        "roofline_gbps": round(nbytes / total / 1e9, 3),
    }


def decompose(peers: int, nbytes: int, measured: bool = True) -> dict:
    """Primitives, RPC overhead, the roofline and (``measured``) the tree
    bench's own reading at this size."""
    from ..rpc.group import _CHUNK_BYTES

    prims = measure_primitives(nbytes)
    rpc_call_s = measure_rpc_overhead()
    roof = tree_roofline(prims, rpc_call_s, nbytes, peers, _CHUNK_BYTES)
    out = {
        "cpu_count": os.cpu_count(),
        "host_primitives": {
            k: v for k, v in prims.items() if not k.startswith("_")
        },
        "rpc_small_call_us": round(rpc_call_s * 1e6, 1),
        "chunk_bytes": _CHUNK_BYTES,
        "single_core_tree_roofline": roof,
        "interpretation": (
            f"all peers share this host's {os.cpu_count()} core(s), so the "
            "loopback tree measures aggregate CPU per byte, not per-link "
            "bandwidth; measured/roofline close to 1.0 means the framework "
            "adds little on top of unavoidable copies+adds+syscalls"
        ),
    }
    if measured:
        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        import bench_allreduce_torch

        buf = io.StringIO()
        with redirect_stdout(buf):
            rows = bench_allreduce_torch.bench_rpc_tree(
                n_peers=peers, sizes=(nbytes // 4,)
            )
        out["measured"] = rows[-1]
        out["measured_over_roofline"] = round(
            rows[-1]["gbps"] / roof["roofline_gbps"], 3
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--mb", type=float, default=32.0)
    ap.add_argument("--skip-measured", action="store_true",
                    help="only compute the roofline (no tree run)")
    args = ap.parse_args(argv)

    out = decompose(args.peers, int(args.mb * (1 << 20)),
                    measured=not args.skip_measured)
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
