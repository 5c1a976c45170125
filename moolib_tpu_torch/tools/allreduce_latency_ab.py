"""Injected-latency A/B: depth-bounded chunk pipelining vs one monolithic
message through the tree allreduce; the twin of the reference's
``tools/allreduce_latency_ab.py``.

On one host there is no cross-host concurrency for chunking to exploit,
so extra messages are pure overhead
(:mod:`moolib_tpu_torch.tools.allreduce_decomp`). The design
justification for chunking is different hardware: on a real network,
hop i's link transfer overlaps hop i+1's merge on ANOTHER host. This
harness shows that win without a second host by injecting per-link
transfer latency: every peer's async write path sleeps ``bytes /
link_bw`` before writing (an ``asyncio.sleep``, so injected delays on
DIFFERENT peers overlap in wall time like independent NIC links, while
the host still pays all real serialization/copy costs).

Tree math for p=4 (depth 2, 2(p-1)=6 hop-payloads, but the critical path
is 4 link-serialized payloads: leaf->mid, mid->root, root->mid,
mid->leaf): unchunked wall time ~= 4 * S/bw; with k pipelined chunks the
critical path is ~ (4 + k - 1) * S/(k*bw) — at k=4 that is a ~2.3x
speedup once link latency dominates host compute.

The speedup also goes to the trend store as a device-suite row when
``$MOOLIB_TRENDS`` names one (:func:`moolib_tpu_torch.bench.harness.
append_device_trend`).

Usage::

    python -m moolib_tpu_torch.tools.allreduce_latency_ab [--json OUT] \\
        [--mb 8] [--link-mbps 100] [--peers 4]
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def install_link_latency(rpc, s_per_byte: float):
    """Wrap ``rpc``'s write path with a per-byte transfer delay.

    The sync fast path (``Rpc._write_now``) is disabled so every send
    flows through the awaitable ``Rpc._write``, which sleeps the
    simulated wire time BEFORE the real write. Sleeps are asyncio:
    per-peer event loops overlap them like independent links."""
    real_write = rpc._write

    async def delayed_write(conn, frames):
        import asyncio

        try:
            nbytes = sum(len(f) for f in frames)
        except TypeError:
            nbytes = 0
        if nbytes > 4096:  # control traffic stays fast; payloads pay wire
            await asyncio.sleep(nbytes * s_per_byte)
        await real_write(conn, frames)

    rpc._write = delayed_write
    rpc._write_now = lambda conn, frames: False


def run_ab(n_peers: int, nbytes: int, link_mbps: float, rounds: int = 3):
    """In-process peers (each Rpc owns its event loop thread, so injected
    delays overlap across peers) running chunked-vs-unchunked reduces."""
    import numpy as np

    from .. import set_log_level
    from ..rpc import Rpc
    from ..rpc.broker import Broker
    from ..rpc.group import Group

    set_log_level("error")
    s_per_byte = 1.0 / (link_mbps * 1e6)

    broker_rpc = Rpc("broker")
    broker_rpc.listen("127.0.0.1:0")
    addr = broker_rpc.debug_info()["listen"][0]
    broker = Broker(broker_rpc)
    stop = threading.Event()

    def pump_broker():
        while not stop.is_set():
            broker.update()
            time.sleep(0.02)

    threading.Thread(target=pump_broker, daemon=True).start()

    rpcs, groups = [], []
    pump_stop = threading.Event()
    try:
        for i in range(n_peers):
            r = Rpc(f"ab-{i}")
            rpcs.append(r)
            r.listen("127.0.0.1:0")
            r.connect(addr)
            install_link_latency(r, s_per_byte)
            groups.append(Group(r, group_name="ab", timeout=600.0))

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            for g in groups:
                g.update()
            if all(len(g.members) == n_peers and g.active() for g in groups):
                break
            time.sleep(0.02)
        else:
            raise RuntimeError("group never stabilized")

        def pump():
            while not pump_stop.is_set():
                for g in groups:
                    g.update()
                time.sleep(0.05)

        threading.Thread(target=pump, daemon=True).start()

        def timed_reduce(tag: str, chunk_bytes):
            data = [np.full(nbytes // 4, float(i), np.float32)
                    for i in range(n_peers)]
            # Warmup round (routes dialed, buffers grown).
            futs = [g.all_reduce(f"warm.{tag}", d, chunk_bytes=chunk_bytes)
                    for g, d in zip(groups, data)]
            for f in futs:
                f.result(timeout=600)
            times = []
            for r in range(rounds):
                t0 = time.perf_counter()
                futs = [g.all_reduce(f"{tag}.{r}", d, chunk_bytes=chunk_bytes)
                        for g, d in zip(groups, data)]
                res = [f.result(timeout=600) for f in futs]
                times.append(time.perf_counter() - t0)
                expect = sum(range(n_peers))
                assert abs(float(res[0][0]) - expect) < 1e-5
            return min(times)

        t_unchunked = timed_reduce("mono", chunk_bytes=0)
        t_chunked = timed_reduce("chunk", chunk_bytes=max(1, nbytes // 4))
    finally:
        pump_stop.set()
        stop.set()
        for g in groups:
            g.close()
        for r in rpcs:
            r.close()
        broker_rpc.close()

    return {
        "peers": n_peers,
        "mb": round(nbytes / 1e6, 2),
        "link_mbps": link_mbps,
        "injected_wire_s_per_payload": round(nbytes * s_per_byte, 4),
        "unchunked_s": round(t_unchunked, 4),
        "chunked_depth4_s": round(t_chunked, 4),
        "chunked_speedup": round(t_unchunked / t_chunked, 2),
        "note": (
            "asyncio-injected per-link transfer delay; delays overlap "
            "across peers like independent NIC links while the host "
            "still pays real serialize/copy costs. Complements the "
            "loopback decomposition where chunking measurably loses "
            "(no concurrency to exploit)."
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--link-mbps", type=float, default=100.0)
    ap.add_argument("--peers", type=int, default=4)
    args = ap.parse_args(argv)

    row = run_ab(args.peers, int(args.mb * (1 << 20)), args.link_mbps)
    print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(row, f, indent=1)

    # Harness-schema trend row (no-op unless MOOLIB_TRENDS is set): the
    # chunked-pipeline speedup at this injected link speed is the number
    # that must not regress.
    from ..bench.harness import append_device_trend

    append_device_trend(
        f"allreduce_chunked_speedup_{args.link_mbps:g}mbps",
        row["chunked_speedup"], "x",
        "python -m moolib_tpu_torch.tools.allreduce_latency_ab "
        f"--mb {args.mb:g} --link-mbps {args.link_mbps:g} "
        f"--peers {args.peers}",
        extra={k: row[k] for k in
               ("peers", "mb", "link_mbps", "unchunked_s",
                "chunked_depth4_s")},
    )


if __name__ == "__main__":
    main()
