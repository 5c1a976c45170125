"""Serving-tier load generator of the port: throughput/latency curves for
an in-process fleet, with an optional mid-run replica kill to watch
failover keep the tail bounded; the twin of the reference's
``tools/serving_load.py``.

Stands up ``--replicas`` N replica peers and a router (loopback,
OS-assigned ports — the ``ServingFleet`` the chaos scenarios use, its
replicas on ``--device``, the card unless ``cpu``), drives
``--requests`` requests from ``--concurrency`` closed-loop workers, and
prints one JSON report: qps, latency quantiles, outcome counts by kind,
and the router's serving counters. With ``--kill-after N`` one replica
is killed (connections + peer) after N completed requests — the report
then shows the failover cost instead of a hole in the curve.

Usage::

    python -m moolib_tpu_torch.tools.serving_load --replicas 3 --requests 600
    python -m moolib_tpu_torch.tools.serving_load --replicas 3 \\
        --requests 600 --kill-after 100 [--device cpu]
    python -m moolib_tpu_torch.tools.serving_load --budget 2.0 --concurrency 16
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import json
import sys
import threading
import time

import numpy as np

from ..serving import error_kind
from ..testing.scenarios import ServingFleet
from ..utils import set_log_level


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--replicas", type=int, default=3)
    parser.add_argument("--requests", type=int, default=600)
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--budget", type=float, default=8.0,
                        help="per-request budget (seconds)")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--kill-after", type=int, default=None, metavar="N",
                        help="kill one replica after N completed requests")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="the replicas' device (default: the card)")
    args = parser.parse_args(argv)

    set_log_level("error")
    fleet = ServingFleet(args.replicas, batch_size=args.batch_size,
                         seed=args.seed, device=args.device)
    lock = threading.Lock()
    latencies: list = []
    errors: dict = {}
    killed = threading.Event()
    count = {"n": 0}
    try:
        fleet.wait_routable(args.replicas)
        x = np.ones(4, np.float32)
        fleet.router.infer(x, budget_s=args.budget)  # warm the path

        per = [args.requests // args.concurrency] * args.concurrency
        for i in range(args.requests % args.concurrency):
            per[i] += 1

        def maybe_kill():
            if (args.kill_after is not None and not killed.is_set()
                    and count["n"] >= args.kill_after):
                killed.set()
                fleet.replica_rpcs[0].close()
                print(f"# killed {fleet.replica_rpcs[0].get_name()} after "
                      f"{count['n']} requests", file=sys.stderr)

        def worker(k):
            for _ in range(per[k]):
                t1 = time.perf_counter()
                try:
                    fleet.router.infer(x, budget_s=args.budget)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except Exception as e:
                    kind = error_kind(e)
                    with lock:
                        errors[kind] = errors.get(kind, 0) + 1
                        count["n"] += 1
                    continue
                dt = time.perf_counter() - t1
                with lock:
                    latencies.append(dt)
                    count["n"] += 1
                maybe_kill()

        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(args.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=args.requests * (args.budget + 5))
            if t.is_alive():
                raise RuntimeError(
                    "load worker hung: a request neither completed nor "
                    "failed fast"
                )
        wall = time.perf_counter() - t0
        latencies.sort()
        reg = fleet.router_rpc.telemetry.registry
        svc = fleet.service
        report = {
            "replicas": args.replicas,
            "requests": args.requests,
            "concurrency": args.concurrency,
            "device": str(fleet.replicas[0].device),
            "killed_one": killed.is_set(),
            "ok": len(latencies),
            "errors": errors,
            "qps": round(len(latencies) / wall, 1),
            "latency_s": {
                "p50": _quantile(latencies, 0.5),
                "p90": _quantile(latencies, 0.9),
                "p99": _quantile(latencies, 0.99),
                "max": latencies[-1] if latencies else None,
            },
            "router": {
                "requests": reg.value("serving_router_requests_total",
                                      service=svc),
                "ok": reg.value("serving_router_ok_total", service=svc),
                "retried": reg.value("serving_retried_total", service=svc),
                "probe_misses": reg.value("serving_probe_misses_total",
                                          service=svc),
            },
            "routable_at_end": fleet.router.routable(),
        }
        print(json.dumps(report))
        return 0 if not errors else 1
    finally:
        fleet.close()


if __name__ == "__main__":
    sys.exit(main())
