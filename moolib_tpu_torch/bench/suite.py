"""The CPU-proxy perf suite of the port: the reference's 15 hot-path rows
(:mod:`moolib_tpu.bench.suite`), in its order, under its names, units,
directions and ``extra`` keys, run on the port's modules.

==============================  ============================================
benchmark                       hot path it guards
==============================  ============================================
``rpc_echo_latency_s``          the port's ``Rpc`` dispatch floor over
                                loopback (serialize, loop hop, wire,
                                dispatch, respond)
``rpc_payload_gbps``            large-payload RPC throughput over loopback
                                TCP
``rpc_shm_payload_gbps``        the same echo over the same-host shm ring
                                lane; errors if payloads fell back to TCP
``allreduce_tree_gbps``         4-peer loopback ``Group`` tree allreduce
``batcher_fill_s``              the two-stage ``Batcher``'s fill latency
``envpool_steps_per_s``         trivial-env ``EnvPool`` dispatch ceiling
                                (plus the supervision-overhead A/B in
                                ``extra``, budget-gated < 5%)
``envpool_recovery_s``          SIGKILL one worker -> first post-respawn
                                step
``serial_encode_gbps`` /        the port's serial codec on a tensor
``serial_decode_gbps``          payload
``statestore_replicate_gbps``   ``StateStore`` publish to one loopback
                                replica
``serving_qps`` /               ``Router`` + 2 ``Replica``s closed loop,
``serving_p99_latency_s``       the model a torch ``x @ w`` on ``device``
``fleet_rollout_s``             one canary rollout through a
                                ``FleetSpec.small`` cohort whose replicas
                                serve on ``device``
``e2e_learner_step_s``          the port's IMPALA train step on
                                ``A2CNet`` on ``device`` inside a
                                ``Hotwatch(d2h=0, h2d=0, max_compiles=0)``
                                window; a stray synchronous read turns the
                                row into an error row
``parity_check_s``              one ``ParityWatch`` replay of that step
==============================  ============================================

The host rows measure the host on any device; the serving, fleet,
learner and parity rows run their models on ``device`` (the card unless
``device="cpu"``). No row needs a second card.

Every benchmark follows the harness protocol (warmup + repeats +
trimmed stats, ``time.perf_counter`` only), listens on OS-assigned ports,
attaches a telemetry-registry snapshot where the reference does, and
stamps a reproduce command. ``smoke=True`` shrinks sizes and repeats.

Module-level imports stay light (no torch): an ``EnvPool`` worker
unpickles :class:`TrivialEnv` from this module.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .harness import BenchResult, clock, measure, trimmed_stats

__all__ = ["CPU_PROXY_SUITE", "ROWS", "TrivialEnv", "run_suite"]

SUITE_NAME = "cpu-proxy"

#: Each row's unit and direction, the reference's.
ROWS = {
    "rpc_echo_latency_s": ("s/call", "lower"),
    "rpc_payload_gbps": ("GB/s", "higher"),
    "rpc_shm_payload_gbps": ("GB/s", "higher"),
    "allreduce_tree_gbps": ("GB/s", "higher"),
    "batcher_fill_s": ("s/batch", "lower"),
    "envpool_steps_per_s": ("env-steps/s", "higher"),
    "envpool_recovery_s": ("s", "lower"),
    "serial_encode_gbps": ("GB/s", "higher"),
    "serial_decode_gbps": ("GB/s", "higher"),
    "statestore_replicate_gbps": ("GB/s", "higher"),
    "serving_qps": ("req/s", "higher"),
    "serving_p99_latency_s": ("s", "lower"),
    "fleet_rollout_s": ("s", "lower"),
    "e2e_learner_step_s": ("s", "lower"),
    "parity_check_s": ("s", "lower"),
}


def _cmd(name: str, smoke: bool, device=None) -> str:
    return (
        f"python -m moolib_tpu_torch.tools.perf --suite {SUITE_NAME} "
        f"--only {name}" + (" --smoke" if smoke else "")
        + (" --device cpu" if device is not None and device.type == "cpu"
           else "")
    )


#: Per-benchmark trend-tolerance overrides: the reference's, its
#: observed run-to-run variance of each proxy on a shared host. These
#: bands make the trend gate a structural-slowdown detector (2x-class
#: steps) rather than a flake source.
TREND_TOLERANCE = {
    "rpc_echo_latency_s": 0.5,
    "rpc_payload_gbps": 0.5,
    "rpc_shm_payload_gbps": 0.5,
    "allreduce_tree_gbps": 0.5,
    "batcher_fill_s": 0.5,
    "envpool_steps_per_s": 0.4,
    "envpool_recovery_s": 0.65,
    "serial_encode_gbps": 0.65,
    "serial_decode_gbps": 0.65,
    "statestore_replicate_gbps": 0.65,
    "serving_qps": 0.5,
    "serving_p99_latency_s": 0.65,
    "fleet_rollout_s": 0.65,
    "e2e_learner_step_s": 0.5,
    "parity_check_s": 0.5,
}

def _result(name: str, value, unit, direction, smoke, stats=None,
            telemetry=None, extra=None, error=None) -> BenchResult:
    return BenchResult(
        metric=name, value=value, unit=unit, direction=direction,
        suite=SUITE_NAME, smoke=smoke, cmd=_cmd(name, smoke),
        stats=stats or {}, telemetry=telemetry, extra=extra or {},
        error=error, tol=TREND_TOLERANCE.get(name),
    )


def _row(name: str, value, smoke, **kw) -> BenchResult:
    """A measured row, with the unit and direction of :data:`ROWS`."""
    unit, direction = ROWS[name]
    return _result(name, value, unit, direction, smoke, **kw)


def _compact_summary(s):
    """Round one stepscope loop summary down to a row-sized attachment."""
    return {
        "steps": s["steps"],
        "wall_s": round(s["wall_s"], 6),
        "phases": {k: round(v, 6) for k, v in s["phases"].items()},
        "fractions": {k: round(v, 6) for k, v in s["fractions"].items()},
    }


def _stepscope_extra(snapshot, loop):
    """Compact phase-ledger attachment for a row's ``extra``: the named
    loop's per-phase seconds and derived fractions reconstructed from a
    registry snapshot (None when the loop never recorded a step)."""
    from ..telemetry import summarize_stepscope

    s = summarize_stepscope(snapshot).get(loop)
    return None if s is None else _compact_summary(s)


# -- RPC echo + payload -------------------------------------------------------


def _echo_cohort(transports=None):
    from ..rpc import Rpc
    from ..telemetry import Telemetry
    from ..utils import set_log_level

    set_log_level("error")
    # ONE shared Telemetry for both peers (gauges are peer-labelled for
    # exactly this case), so the attached snapshot carries the client's
    # rpc_client_latency_seconds AND the server's rpc_server_handle_seconds
    # — the budget layer gates both sides of the call.
    tel = Telemetry("perfwatch-echo")
    a = Rpc("perfwatch-client", telemetry=tel)
    b = Rpc("perfwatch-server", telemetry=tel)
    if transports is not None:
        # Pin the lane under test: the TCP baseline row must not let the
        # same-host shm lane silently carry its payloads (and vice versa
        # the shm row asserts its bytes really rode shm).
        a.set_transports(transports)
        b.set_transports(transports)
    b.define("echo", lambda x: x)
    b.listen("127.0.0.1:0")  # OS-assigned: parallel CI jobs must coexist
    a.connect(b.debug_info()["listen"][0])
    return a, b


def bench_rpc_echo(smoke: bool, device=None) -> BenchResult:
    """Per-call latency of a loopback echo — the RPC dispatch floor."""
    repeats = 150 if smoke else 500
    a, b = _echo_cohort()
    try:
        samples = measure(
            lambda: a.sync("perfwatch-server", "echo", 1),
            warmup=20, repeats=repeats,
        )
        stats = trimmed_stats(samples)
        stats["samples"] = stats["samples"][:16]  # keep trend rows small
        return _row(
            "rpc_echo_latency_s", stats["median"],
            smoke, stats=stats, telemetry=b.telemetry.snapshot(),
        )
    finally:
        a.close()
        b.close()


#: Concurrent in-flight echoes per payload-throughput rep: throughput
#: benchmarks measure the pipelined regime (gradient pushes, rollout
#: uploads, allreduce chunks all overlap calls), not serial round-trip
#: latency — that's rpc_echo_latency_s's job.
_PAYLOAD_DEPTH = 4


def _payload_rep(a, arr, depth=_PAYLOAD_DEPTH):
    futs = [a.async_("perfwatch-server", "echo", arr)
            for _ in range(depth)]
    for f in futs:
        f.result(120)


def bench_rpc_payload(smoke: bool, device=None) -> BenchResult:
    """Pipelined round-trip throughput of large tensor payloads through
    the RPC plane over loopback TCP (depth-4 concurrent echoes; each
    rep moves 2 x depth x the array bytes)."""
    nbytes = (4 << 20) if smoke else (32 << 20)
    repeats = 4 if smoke else 8
    arr = np.ones(nbytes // 4, np.float32)
    a, b = _echo_cohort(transports={"tcp"})
    try:
        samples = measure(
            lambda: _payload_rep(a, arr), warmup=2, repeats=repeats,
        )
        stats = trimmed_stats(samples)
        gbps = 2 * nbytes * _PAYLOAD_DEPTH / stats["median"] / 1e9
        return _row(
            "rpc_payload_gbps", gbps, smoke,
            stats=stats, telemetry=b.telemetry.snapshot(),
            extra={"payload_mb": round(nbytes / 1e6, 1),
                   "depth": _PAYLOAD_DEPTH},
        )
    finally:
        a.close()
        b.close()


def bench_rpc_shm_payload(smoke: bool, device=None) -> BenchResult:
    """The rpc_payload pipelined echo over the same-host shm ring lane
    (spill-slot writes on the sender, zero-copy mapped receive) — the
    acceptance row of the shm lane, compared against ``rpc_payload_gbps``. The
    row errors (null value) if the payloads did not actually ride the
    lane — a silent TCP fallback must never masquerade as an shm
    measurement; ``extra`` carries the measured shm byte count as
    evidence."""
    nbytes = (4 << 20) if smoke else (32 << 20)
    repeats = 4 if smoke else 8
    arr = np.ones(nbytes // 4, np.float32)
    a, b = _echo_cohort(transports={"tcp", "shm"})
    try:
        # The lane rendezvous rides the greeting + one offer/accept RTT.
        a.sync("perfwatch-server", "echo", 1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            peer = a._peers.get("perfwatch-server")
            if peer and "shm" in peer.conns:
                break
            time.sleep(0.02)
        else:
            raise RuntimeError("shm lane never came up on loopback")
        reg = a.telemetry.registry
        base_shm = reg.value("rpc_bytes_out_total", transport="shm") or 0
        warmup = 2  # also settles lane EWMAs
        samples = measure(
            lambda: _payload_rep(a, arr), warmup=warmup, repeats=repeats,
        )
        shm_bytes = (
            reg.value("rpc_bytes_out_total", transport="shm") or 0
        ) - base_shm
        # shm_bytes accumulated across warmup reps too (the snapshot
        # predates measure()), so count them in `sent` — else the 0.8
        # headroom silently loosens to ~0.5 and a run where half the
        # measured-phase payloads fell back to TCP still passes.
        sent = (repeats + warmup) * _PAYLOAD_DEPTH * nbytes
        if shm_bytes < 0.8 * sent:  # headroom: the 5% exploration bandit
            raise RuntimeError(
                f"payloads fell back to TCP mid-run ({shm_bytes} shm "
                f"bytes for {sent} sent)"
            )
        stats = trimmed_stats(samples)
        gbps = 2 * nbytes * _PAYLOAD_DEPTH / stats["median"] / 1e9
        return _row(
            "rpc_shm_payload_gbps", gbps, smoke,
            stats=stats, telemetry=b.telemetry.snapshot(),
            extra={"payload_mb": round(nbytes / 1e6, 1),
                   "depth": _PAYLOAD_DEPTH,
                   "shm_bytes_out": int(shm_bytes)},
        )
    finally:
        a.close()
        b.close()


# -- loopback tree allreduce --------------------------------------------------


def bench_allreduce_tree(smoke: bool, device=None) -> BenchResult:
    """4-peer in-process Group tree allreduce over loopback TCP — the
    Accumulator's DCN reduce plane with the wire taken out, so what
    remains is serialization + copy + protocol cost."""
    from ..rpc import Rpc
    from ..rpc.broker import Broker
    from ..rpc.group import Group
    from ..utils import set_log_level

    set_log_level("error")
    n_peers = 4
    nbytes = (256 << 10) if smoke else (4 << 20)
    rounds = 3 if smoke else 6

    broker_rpc = Rpc("perfwatch-broker")
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
    try:
        for i in range(n_peers):
            r = Rpc(f"perfwatch-ar-{i}")
            r.listen("127.0.0.1:0")
            r.connect(addr)
            g = Group(r, group_name="perfwatch",
                      broker_name="perfwatch-broker", timeout=120.0)
            rpcs.append(r)
            groups.append(g)
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
            while not stop.is_set():
                for g in groups:
                    g.update()
                time.sleep(0.05)

        threading.Thread(target=pump, daemon=True).start()

        data = [np.full(nbytes // 4, float(i), np.float32)
                for i in range(n_peers)]

        def one_round(tag):
            futs = [g.all_reduce(tag, d) for g, d in zip(groups, data)]
            res = [f.result(timeout=120) for f in futs]
            assert abs(float(res[0][0]) - sum(range(n_peers))) < 1e-5
            return res

        one_round("warm")
        samples = []
        for r in range(rounds):
            t0 = clock()
            one_round(f"r{r}")
            samples.append(clock() - t0)
        stats = trimmed_stats(samples)
        # Algorithm bandwidth (bench_allreduce.py convention): each peer
        # contributes + receives the full buffer once per round.
        gbps = nbytes * n_peers / stats["median"] / 1e9
        return _row(
            "allreduce_tree_gbps", gbps, smoke,
            stats=stats, telemetry=rpcs[0].telemetry.snapshot(),
            extra={"peers": n_peers, "mb": round(nbytes / 1e6, 2)},
        )
    finally:
        stop.set()
        for g in groups:
            g.close()
        for r in rpcs:
            r.close()
        broker_rpc.close()


# -- batcher fill -------------------------------------------------------------


def bench_batcher_fill(smoke: bool, device=None) -> BenchResult:
    """First-item-to-emitted-batch latency of the two-stage Batcher — the
    acting plane's staging cost at trivial item size."""
    from ..ops.batcher import Batcher
    from ..telemetry import global_telemetry

    bs = 64
    repeats = 20 if smoke else 60
    item = {"obs": np.zeros((4, 4), np.float32), "r": np.float32(0.0)}
    batcher = Batcher(bs, name="perfwatch")
    try:
        def fill_one():
            for _ in range(bs):
                batcher.stack(item)
            batcher.get(timeout=10)

        samples = measure(fill_one, warmup=2, repeats=repeats)
        stats = trimmed_stats(samples)
        stats["samples"] = stats["samples"][:16]
        snap = global_telemetry().snapshot()
        return _row(
            "batcher_fill_s", stats["median"], smoke,
            stats=stats, telemetry=snap, extra={"batch_size": bs},
        )
    finally:
        batcher.close()


# -- envpool ------------------------------------------------------------------


class TrivialEnv:
    """Near-zero-cost env (module-level so it pickles into spawn
    workers): the benchmark measures pool machinery, not env physics."""

    def __init__(self, seed: int):
        self.seed = seed
        self.obs = np.array([seed, 0.0], np.float32)

    def reset(self):
        return self.obs, {}

    def step(self, action):
        return self.obs, 0.0, False, False, {}

    def close(self):
        pass


def _envpool_rate(pool, bs: int, n: int) -> float:
    """Double-buffered env-steps/s over ``n`` loop iterations."""
    a = np.zeros(bs, np.int64)
    for b in (0, 1):
        pool.step(b, a).result(30)
    t0 = clock()
    f0 = pool.step(0, a)
    f1 = pool.step(1, a)
    for _ in range(n):
        f0.result(30)
        f0 = pool.step(0, a)
        f1.result(30)
        f1 = pool.step(1, a)
    f0.result(30)
    f1.result(30)
    return (2 * n + 2) * bs / (clock() - t0)


def bench_envpool_steps(smoke: bool, device=None) -> BenchResult:
    """Double-buffered trivial-env steps/s through the full EnvPool
    dispatch path (slab writes, ring dispatch, worker step loop).

    Also measures the SUPERVISION overhead on the healthy path (the
    headline pool runs with the default supervisor; a second pool runs
    ``supervise=False``) in ``extra["supervision_overhead_frac"]`` —
    budget-gated < 5%. The overhead question is structural (heartbeat
    writes, mark scans), not a load statistic, so the A/B runs adjacent
    pass pairs (supervised, then unsupervised: both see the same host
    load) and takes one minus the median of the pairs' rate ratios,
    about 10,000 loop iterations a mode. The reference takes the best of
    3 passes a mode; on a host whose load moves from pass to pass (a
    card machine's shared cores) that estimate broke the budget on one
    run and passed on the next over the same code (PERF.md §6)."""
    from ..envpool import EnvPool
    from ..telemetry import global_telemetry

    bs = 64 if smoke else 128
    n = 100 if smoke else 400
    pool = EnvPool(TrivialEnv, num_processes=1, batch_size=bs,
                   num_batches=2, name="perfwatch-sup")
    raw = EnvPool(TrivialEnv, num_processes=1, batch_size=bs,
                  num_batches=2, supervise=False, name="perfwatch-raw")
    try:
        value = _envpool_rate(pool, bs, n)
        m = max(10, n // 4)
        ratios = []
        sup_best = raw_best = 0.0
        for _ in range(max(30, 10000 // m)):
            sup = _envpool_rate(pool, bs, m)
            raw_rate = _envpool_rate(raw, bs, m)
            ratios.append(sup / raw_rate)
            sup_best, raw_best = max(sup_best, sup), max(raw_best, raw_rate)
        overhead = max(0.0, 1.0 - statistics.median(ratios))
        batches = 2 * n + 2
        dt = batches * bs / value
        snap = global_telemetry().snapshot()
        # The pools' built-in StepScopes already attributed every batch
        # (env_wait / staging / batch_fill) into the global registry;
        # pin the composition snapshot to the row so the perf ledger
        # shows WHERE the batch time went, not just the rate.
        stepscope = _stepscope_extra(snap, "envpool")
        return _row(
            "envpool_steps_per_s", value, smoke,
            stats={"n": batches, "mean": dt / batches, "total_s": dt},
            telemetry=snap,
            extra={"batch_size": bs, "procs": 1,
                   "supervision_overhead_frac": round(overhead, 4),
                   "supervised_best": sup_best,
                   "unsupervised_best": raw_best,
                   "stepscope": stepscope},
        )
    finally:
        pool.close()
        raw.close()


def bench_envpool_recovery(smoke: bool, device=None) -> BenchResult:
    """Kill-to-first-post-respawn-step wall time: SIGKILL one worker of a
    supervised pool, then drive retries until a step completes — the
    env-tier failover budget (detection + respawn + handshake + retry).
    Dominated by worker-process spawn (a fresh interpreter importing the
    env module), so the budget is a catastrophe guard, not a latency
    target."""
    import os
    import signal as _signal

    from ..envpool import EnvPool, WorkerDied
    from ..telemetry import global_telemetry

    bs = 8
    reps = 2 if smoke else 3
    pool = EnvPool(TrivialEnv, num_processes=2, batch_size=bs,
                   num_batches=1, restart_backoff=0.05,
                   name="perfwatch-recovery")
    try:
        a = np.zeros(bs, np.int64)
        pool.step(0, a).result(30)
        samples = []
        for r in range(reps):
            victim = r % 2
            t0 = clock()
            os.kill(pool._procs[victim].pid, _signal.SIGKILL)
            while True:
                try:
                    pool.step(0, a).result(30)
                    break
                except WorkerDied:
                    time.sleep(0.01)
            samples.append(clock() - t0)
        stats = trimmed_stats(samples)
        snap = global_telemetry().snapshot()
        return _row(
            "envpool_recovery_s", stats["median"], smoke,
            stats=stats, telemetry=snap,
            extra={"procs": 2, "reps": reps},
        )
    finally:
        pool.close()


# -- serial encode / decode ---------------------------------------------------


def _serial_payload(nbytes: int):
    return {
        "obs": np.arange(nbytes // 4, dtype=np.float32),
        "meta": {"step": 7, "done": False, "tag": "perfwatch"},
        "rewards": [1.0, 2.0, 3.0],
    }


def bench_serial_encode(smoke: bool, device=None) -> BenchResult:
    """serialize() throughput on a tensor-bearing payload (zero-copy
    framing: the cost is metadata encoding + iovec assembly)."""
    from ..rpc import serial

    nbytes = (4 << 20) if smoke else (32 << 20)
    repeats = 10 if smoke else 30
    obj = _serial_payload(nbytes)
    total = serial.frames_len(serial.serialize(1, 2, obj))
    samples = measure(
        lambda: serial.serialize(1, 2, obj), warmup=2, repeats=repeats
    )
    stats = trimmed_stats(samples)
    return _row(
        "serial_encode_gbps", total / stats["median"] / 1e9, smoke,
        stats=stats,
        extra={"frame_mb": round(total / 1e6, 1)},
    )


def bench_serial_decode(smoke: bool, device=None) -> BenchResult:
    """deserialize_body() throughput on the same payload (zero-copy
    views over an aligned receive buffer). ``extra`` carries the A/B
    against the forced-copy arm (``copy_tensors=True``, the
    pre-zero-copy behavior): ``copy_decode_gbps`` and the resulting
    ``zero_copy_speedup`` — direct evidence the multi-MB tensor copy is
    gone from the receive path."""
    from ..rpc import serial

    nbytes = (4 << 20) if smoke else (32 << 20)
    repeats = 10 if smoke else 30
    frames = serial.serialize(1, 2, _serial_payload(nbytes))
    wire = b"".join(bytes(f) for f in frames)
    body_arr = serial.alloc_aligned(len(wire) - serial.HEADER.size)
    body_arr[:] = np.frombuffer(wire, np.uint8)[serial.HEADER.size:]
    body = memoryview(body_arr)
    total = len(wire)

    def decode():
        rid, fid, obj = serial.deserialize_body(body)
        assert rid == 1 and fid == 2
        return obj

    samples = measure(decode, warmup=2, repeats=repeats)
    stats = trimmed_stats(samples)
    value = total / stats["median"] / 1e9
    # A/B control arm: same frame, tensors force-copied out.
    copy_samples = measure(
        lambda: serial.deserialize_body(body, copy_tensors=True),
        warmup=1, repeats=max(3, repeats // 2),
    )
    copy_gbps = total / trimmed_stats(copy_samples)["median"] / 1e9
    return _row(
        "serial_decode_gbps", value, smoke, stats=stats,
        extra={"frame_mb": round(total / 1e6, 1),
               "copy_decode_gbps": round(copy_gbps, 3),
               "zero_copy_speedup": round(value / copy_gbps, 2)},
    )


# -- durable state (statestore) -----------------------------------------------


def bench_statestore_replicate(smoke: bool, device=None) -> BenchResult:
    """Durable-state publish throughput: one committed model version
    through the full replication pipeline — encode, chunk + per-chunk
    sha256, crash-atomic local write (fsync'd staging + rename), then
    the offer/ingest/commit push to one loopback replica. GB/s of state
    made peer-durable; the CPU proxy under the ``ss_publish`` ->
    ``ss_replicate`` path the host-loss scenario depends on."""
    import tempfile

    from ..statestore import StateStore

    nbytes = (4 << 20) if smoke else (16 << 20)
    repeats = 4 if smoke else 8
    state = {"w": np.ones(nbytes // 4, np.float32)}
    a, b = _echo_cohort()
    version = [0]
    with tempfile.TemporaryDirectory() as td:
        store_a = StateStore(td + "/a", a, keep_versions=2, name="bench-a")
        store_b = StateStore(td + "/b", b, keep_versions=2, name="bench-b")
        try:

            def rep():
                version[0] += 1
                acks = store_a.publish(version[0], state,
                                       peers=("perfwatch-server",))
                if not all(acks.values()):
                    raise RuntimeError(f"publish not fully acked: {acks}")

            samples = measure(rep, warmup=1, repeats=repeats)
            stats = trimmed_stats(samples)
            gbps = nbytes / stats["median"] / 1e9
            return _row(
                "statestore_replicate_gbps", gbps,
                smoke, stats=stats, telemetry=a.telemetry.snapshot(),
                extra={"payload_mb": round(nbytes / 1e6, 1),
                       "versions": version[0]},
            )
        finally:
            store_a.close()
            store_b.close()
            a.close()
            b.close()


# -- serving tier -------------------------------------------------------------

#: One serving load run feeds BOTH serving rows (qps and p99 are two
#: views of the same closed loop). Keyed by (smoke, device); populated by
#: whichever serving bench runs first in this process, so ``--only
#: serving_p99_latency_s`` still works.
_SERVING_CACHE: Dict = {}


def _serving_load(smoke: bool, device) -> Dict:
    """Closed-loop load through a router + 2 in-process replicas with a
    padded, batched ``x @ w`` model on ``device`` — the serving tier's
    full hot path: admission, dynamic batching, deadline propagation,
    load-aware dispatch."""
    import torch

    from ..rpc import Rpc
    from ..serving import Replica, Router
    from ..utils import set_log_level

    set_log_level("error")
    n_requests = 240 if smoke else 1200
    concurrency = 8
    batch_size = 8
    params = {"w": torch.eye(16, device=device) * 2.0}

    def model(p, x):
        return x @ p["w"]

    rpcs, reps = [], []
    router_rpc = None
    router = None
    try:
        for i in range(2):
            r = Rpc(f"perfwatch-rep{i}")
            r.listen("127.0.0.1:0")  # OS-assigned: parallel CI jobs coexist
            reps.append(Replica(r, model, params, version=1,
                                batch_size=batch_size, pad=True,
                                device=device))
            rpcs.append(r)
        router_rpc = Rpc("perfwatch-router")
        for r in rpcs:
            router_rpc.connect(r.debug_info()["listen"][0])
        router = Router(router_rpc, [r.get_name() for r in rpcs],
                        probe_interval_s=0.1, attempt_timeout_s=5.0,
                        seed=0)
        deadline = clock() + 30
        while len(router.routable()) < 2:
            if clock() > deadline:
                raise RuntimeError("serving fleet never became routable")
            time.sleep(0.02)
        x = np.ones(16, np.float32)
        for _ in range(2 * batch_size):  # warm both replicas
            router.infer(x, budget_s=30.0)

        lock = threading.Lock()
        latencies: list = []
        errors: list = []
        per = n_requests // concurrency

        def worker():
            for _ in range(per):
                t1 = clock()
                try:
                    router.infer(x, budget_s=30.0)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except Exception as e:
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
                    continue
                dt = clock() - t1
                with lock:
                    latencies.append(dt)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(concurrency)]
        t0 = clock()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = clock() - t0
        if errors or len(latencies) != per * concurrency:
            raise RuntimeError(
                f"serving load errored: {len(errors)} failures "
                f"(first: {errors[:1]})"
            )
        latencies.sort()
        return {
            "qps": len(latencies) / wall,
            "p99_s": latencies[min(int(0.99 * len(latencies)),
                                   len(latencies) - 1)],
            "p50_s": latencies[len(latencies) // 2],
            "requests": len(latencies),
            "concurrency": concurrency,
            "telemetry": router_rpc.telemetry.snapshot(),
        }
    finally:
        if router is not None:
            router.close()
        if router_rpc is not None:
            router_rpc.close()
        for rep in reps:
            rep.close()
        for r in rpcs:
            r.close()


def _serving_cached(smoke: bool, device) -> Dict:
    key = (smoke, str(device))
    run = _SERVING_CACHE.get(key)
    if run is None:
        run = _serving_load(smoke, device)
        _SERVING_CACHE[key] = run
    return run


def bench_serving_qps(smoke: bool, device=None) -> BenchResult:
    """Closed-loop serving throughput (router + 2 replicas, batched
    ``x @ w`` on the device) — requests/s across 8 concurrent callers."""
    run = _serving_cached(smoke, device)
    return _row(
        "serving_qps", run["qps"], smoke,
        stats={"n": run["requests"], "p50": run["p50_s"],
               "p99": run["p99_s"]},
        telemetry=run["telemetry"],
        extra={"concurrency": run["concurrency"], "replicas": 2},
    )


def bench_serving_p99(smoke: bool, device=None) -> BenchResult:
    """End-to-end p99 request latency of the same serving load — the
    tail the robustness layer exists to keep bounded."""
    run = _serving_cached(smoke, device)
    return _row(
        "serving_p99_latency_s", run["p99_s"], smoke,
        stats={"n": run["requests"], "p50": run["p50_s"]},
        telemetry=run["telemetry"],
        extra={"concurrency": run["concurrency"], "replicas": 2},
    )


# -- fleet tier ---------------------------------------------------------------


def bench_fleet_rollout(smoke: bool, device=None) -> BenchResult:
    """Wall time of one zero-downtime canary rollout (canary publish ->
    weighted settle -> promote) through a ``FleetSpec.small`` cohort,
    its replicas on the device, under closed-loop load. The 0.5s settle
    window is a constant floor; spec materialization is excluded,
    dropped requests turn the row into an error row."""
    from ..fleet import FleetSpec
    from ..testing.scenarios import FleetHarness, _run_load
    from ..utils import set_log_level

    set_log_level("error")
    settle_s = 0.5
    spec = FleetSpec.small(replicas=3, routers=1, learners=0,
                           env_workers=0, settle_s=settle_s)
    n_requests = 160 if smoke else 640
    harness = FleetHarness(spec, standby=False, device=device)
    lock = threading.Lock()
    try:
        harness.wait_routable(3)
        ctl = harness.controller
        ctl.publish_model({"scale": np.float32(3.0)}, 2)
        outcomes: list = []
        threads = _run_load(harness.router, n_requests, 4, 8.0,
                            outcomes, lock)
        t0 = clock()
        state = ctl.start_rollout(version=2, wait=True)
        dt = clock() - t0
        for t in threads:
            t.join(timeout=120)
        if state != "promoted":
            raise RuntimeError(f"rollout ended {state}, not promoted")
        bad = [r for r in outcomes if r[0] != "ok"]
        if bad:
            raise RuntimeError(
                f"rollout dropped {len(bad)} accepted requests "
                f"(first: {bad[:1]})"
            )
        return _row(
            "fleet_rollout_s", dt, smoke,
            stats={"settle_s": settle_s, "requests": len(outcomes)},
            telemetry=ctl.rpc.telemetry.snapshot(),
            extra={"replicas": 3,
                   "canary_weight": spec.rollout.canary_weight},
        )
    finally:
        harness.close()


# -- learner e2e steady state -------------------------------------------------


def _a2c_setup(smoke: bool, device):
    """The learner rows' model and batch: ``A2CNet`` (one hidden layer of
    32) and a seeded numpy batch uploaded onto ``device`` — the
    reference's shapes."""
    import torch

    from ..models import A2CNet

    t_dim, b_dim, f_dim, a_dim = (4, 4, 5, 3) if smoke else (8, 16, 5, 3)
    gen = torch.Generator(device).manual_seed(0)
    net = A2CNet(a_dim, f_dim, hidden_sizes=(32,), device=device,
                 generator=gen)
    rng = np.random.default_rng(1)
    host = {
        "obs": rng.standard_normal((t_dim + 1, b_dim, f_dim),
                                   dtype=np.float32),
        "done": rng.random((t_dim + 1, b_dim)) < 0.1,
        "rewards": rng.standard_normal((t_dim + 1, b_dim),
                                       dtype=np.float32),
        "actions": rng.integers(0, a_dim, (t_dim, b_dim)),
        "behavior_logits": np.zeros((t_dim, b_dim, a_dim), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    batch["core_state"] = ()
    return net, batch, [t_dim, b_dim, f_dim, a_dim]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_e2e_learner_step(smoke: bool, device=None) -> BenchResult:
    """Steady-state IMPALA train-step time of the port (``A2CNet``, SGD)
    on the device, measured INSIDE a hotwatch window: the row's
    ``extra`` records the window's transfer/compile accounting, and any
    unbudgeted synchronous read or pageable upload (one stray ``.item()``
    in the step path) turns the whole row into an error row."""
    import torch

    from ..learner import ImpalaConfig, make_impala_train_step, make_train_state
    from ..telemetry import StepScope, Telemetry
    from ..testing.hotwatch import Hotwatch

    steps = 10 if smoke else 50
    net, batch, shape = _a2c_setup(smoke, device)
    state = make_train_state(net, torch.optim.SGD(net.parameters(), 1e-3))
    # Private telemetry: the bench's phase ledger must not accumulate
    # into the process-global registry other rows snapshot.
    scope = StepScope("bench_learner_step",
                      telemetry=Telemetry("perfwatch-stepscope"))
    step = make_impala_train_step(config=ImpalaConfig(), stepscope=scope)
    # The batch lives on the device before the window opens: the steady
    # state under test is the learner path, not the host->device feed.
    for _ in range(3):  # warmup: first-touch allocs, cuBLAS set-up
        state, metrics = step(state, batch)
    _sync(device)

    hw = Hotwatch(d2h=0, h2d=0, max_compiles=0, label="e2e_learner_step",
                  enabled=True, device=device)

    def run_window():
        nonlocal state
        with hw:
            for _ in range(steps):
                with scope.step():
                    state, metrics = step(state, batch)
        _sync(device)

    samples = [s / steps for s in measure(
        run_window, warmup=1, repeats=3 if smoke else 5
    )]
    stats = trimmed_stats(samples)
    stepscope = _compact_summary(scope.summary())
    scope.close()
    return _row(
        "e2e_learner_step_s", stats["median"], smoke,
        stats=stats,
        extra={
            "stepscope": stepscope,
            # The acceptance numbers: zero steady-state synchronous reads,
            # no kernel build across the window. A violation raises out
            # of run_window, so reaching here proves them — recorded
            # anyway so the trend rows show the contract being checked.
            "steady_d2h": hw.d2h,
            "staged_async": hw.staged,
            "compile_delta": hw.compile_delta,
            "steps_per_window": steps,
            "batch": shape,
        },
    )


# -- paritywatch gate cost ----------------------------------------------------


def bench_parity_check(smoke: bool, device=None) -> BenchResult:
    """Wall cost of one ParityWatch bitwise-replay check of the seeded
    A2C update: two step executions, each from the same seeded state (the
    port's step updates its model in place, so every run rebuilds it),
    plus the flatten + byte compare of the new parameters and metrics.
    The check itself must PASS inside the timer."""
    import copy

    import torch

    from ..learner import ImpalaConfig, make_impala_train_step, make_train_state
    from ..testing.paritywatch import ParityWatch

    net, batch, shape = _a2c_setup(smoke, device)
    step = make_impala_train_step(config=ImpalaConfig())

    def run_once():
        model = copy.deepcopy(net)
        state = make_train_state(model,
                                 torch.optim.SGD(model.parameters(), 1e-3))
        state, metrics = step(state, batch)
        return ({n: p.detach() for n, p in state.model.named_parameters()},
                metrics)

    run_once()  # warmup: first-touch allocs outside the timed check
    _sync(device)

    watch = ParityWatch(label="bench_parity_check", enabled=True)

    samples = measure(lambda: watch.check(run_once), warmup=1,
                      repeats=3 if smoke else 5)
    stats = trimmed_stats(samples)
    return _row(
        "parity_check_s", stats["median"], smoke,
        stats=stats,
        extra={
            "runs_per_check": watch.runs,
            "batch": shape,
        },
    )


# -- registry -----------------------------------------------------------------

CPU_PROXY_SUITE: Dict[str, Callable[..., BenchResult]] = {
    "rpc_echo_latency_s": bench_rpc_echo,
    "rpc_payload_gbps": bench_rpc_payload,
    "rpc_shm_payload_gbps": bench_rpc_shm_payload,
    "allreduce_tree_gbps": bench_allreduce_tree,
    "batcher_fill_s": bench_batcher_fill,
    "envpool_steps_per_s": bench_envpool_steps,
    "envpool_recovery_s": bench_envpool_recovery,
    "serial_encode_gbps": bench_serial_encode,
    "serial_decode_gbps": bench_serial_decode,
    "statestore_replicate_gbps": bench_statestore_replicate,
    "serving_qps": bench_serving_qps,
    "serving_p99_latency_s": bench_serving_p99,
    "fleet_rollout_s": bench_fleet_rollout,
    "e2e_learner_step_s": bench_e2e_learner_step,
    "parity_check_s": bench_parity_check,
}


def run_suite(
    *,
    smoke: bool = False,
    only: Optional[List[str]] = None,
    max_seconds: Optional[float] = None,
    log: Callable[[str], None] = lambda s: None,
    device=None,
) -> List[BenchResult]:
    """Run the suite in declaration order, the device rows on ``device``
    (:func:`~moolib_tpu_torch.utils.device.resolve_device`: the card
    unless given; raises without one). A benchmark that raises is
    recorded as a null-value row (error string, no value) rather than
    aborting the run; once ``max_seconds`` of wall clock is spent,
    remaining benchmarks are recorded as wall-clock-cap nulls so the
    stage stays bounded and the skip is on the record."""
    names = list(CPU_PROXY_SUITE)
    if only:
        unknown = set(only) - set(names)
        if unknown:
            raise ValueError(f"unknown benchmark(s): {sorted(unknown)}")
        names = [n for n in names if n in set(only)]
    from ..utils.device import resolve_device

    device = resolve_device(device)
    t0 = clock()
    out: List[BenchResult] = []
    for name in names:
        if max_seconds is not None and clock() - t0 > max_seconds:
            out.append(_result(
                name, None, "", "higher", smoke,
                error=f"skipped: suite wall-clock cap {max_seconds}s "
                f"exhausted after {clock() - t0:.1f}s",
            ))
            continue
        log(f"running {name} ({'smoke' if smoke else 'full'}) ...")
        t1 = clock()
        try:
            r = CPU_PROXY_SUITE[name](smoke, device)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            r = _result(
                name, None, "", "higher", smoke,
                error=f"{type(e).__name__}: {e}"[:500],
            )
        r.cmd = _cmd(name, smoke, device)  # reproduces on this device
        log(f"  {name}: "
            + (f"{r.value:.6g} {r.unit}" if r.value is not None
               else f"NULL ({r.error})")
            + f" [{clock() - t1:.1f}s]")
        out.append(r)
    return out
