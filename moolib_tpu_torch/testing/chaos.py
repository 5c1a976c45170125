"""chaosnet — deterministic fault injection for the RPC/Group/Accumulator
stack; the counterpart of :mod:`moolib_tpu.testing.chaos`, on the port's
``Rpc``, ``EnvPool`` and disk-fault seam. The same seed and the same
message sequence give the same decisions and the same event log in both
packages.

Podracer-style architectures treat preemption and peer loss as the steady
state; this module makes those conditions a first-class, *seeded* input
instead of something only the real network can produce. A
:class:`FaultPlan` composes fault primitives — message
drop/delay/duplicate/reorder by endpoint-name pattern, bidirectional peer
partition and heal, per-peer slow links, keepalive blackholes — and a
:class:`ChaosNet` installs the plan on live :class:`~moolib_tpu_torch.rpc.Rpc`
instances through the hook contract in :mod:`moolib_tpu_torch.rpc.faults`.

Determinism contract
--------------------

Every *decision* the plan makes is a pure function of (a) the seed and
(b) the sequence of messages presented to :meth:`FaultPlan.decide` — no
wall clock, no global RNG, no ambient state. The plan records every
injected action in :attr:`FaultPlan.events` (a list of :class:`Event`
tuples with a monotonically increasing ``seq``), so:

- Replaying the same scripted message sequence through two plans built
  with the same seed yields byte-identical event logs.
- A failing scenario reproduces from its seed: rebuild the plan with the
  same seed and rules, re-run the scenario, diff the logs.

On a *live* cluster the message sequence itself depends on scheduling
(keepalive cadence, retry timing), so live event logs are reproducible at
the decision level, not the interleaving level — the scenario suite
therefore asserts *invariants* (no duplicate execution, no lost acked
call, collectives complete-or-error) rather than exact live logs.

Injected faults are indistinguishable from real network behavior at the
seams: a dropped send updates the sender's bookkeeping exactly as a sent
message would (so pokes/resends engage), and a duplicated recv re-enters
dispatch exactly like a transport-level duplicate (so rid suppression is
what is actually under test).
"""

from __future__ import annotations

import threading
from collections import namedtuple
from fnmatch import fnmatchcase
from random import Random
from typing import Any, Dict, List, Optional, Set

from ..rpc.faults import DELAY, DROP, DUP, PASS_VERDICT, Verdict
from ..telemetry import Telemetry, global_telemetry
from ..rpc.rpc import (
    FID_ACK,
    FID_ERROR,
    FID_FNF,
    FID_GREETING,
    FID_KEEPALIVE,
    FID_LOOKING_FOR_PEER,
    FID_NACK,
    FID_PEER_FOUND,
    FID_POKE,
    FID_SHM_ACCEPT,
    FID_SHM_OFFER,
    FID_SUCCESS,
    fid_for,
)
from ..utils import get_logger

log = get_logger("chaos")

__all__ = ["Event", "FaultPlan", "ChaosNet", "CONTROL_NAMES",
           "ProcFaultPlan", "ProcChaos", "ResourceFaultPlan",
           "ResourceChaos"]

#: Control-plane fids get stable ``@``-prefixed endpoint names so rules can
#: target them by pattern (e.g. ``blackhole_keepalive`` drops "@keepalive").
CONTROL_NAMES = {
    FID_GREETING: "@greeting",
    FID_SUCCESS: "@success",
    FID_ERROR: "@error",
    FID_FNF: "@fnf",
    FID_KEEPALIVE: "@keepalive",
    FID_LOOKING_FOR_PEER: "@lookingForPeer",
    FID_PEER_FOUND: "@peerFound",
    FID_ACK: "@ack",
    FID_NACK: "@nack",
    FID_POKE: "@poke",
    FID_SHM_OFFER: "@shmOffer",
    FID_SHM_ACCEPT: "@shmAccept",
}

#: One injected event. ``seq`` is a per-plan monotonic counter; ``arg``
#: carries the action parameter (delay seconds, duplicate copies), which
#: for seeded draws (reorder) is itself deterministic from the seed.
Event = namedtuple("Event", "seq kind action me peer endpoint rid arg")


class _Rule:
    __slots__ = ("kind", "endpoint", "direction", "peer", "p", "arg",
                 "after", "count", "matched", "fired")

    def __init__(self, kind: str, endpoint: str, direction: str, peer: str,
                 p: float, arg, after: int, count: Optional[int]):
        if direction not in ("send", "recv", "both"):
            raise ValueError(f"bad direction {direction!r}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"bad probability {p!r}")
        self.kind = kind
        self.endpoint = endpoint
        self.direction = direction
        self.peer = peer
        self.p = p
        self.arg = arg
        self.after = int(after)
        self.count = count
        self.matched = 0  # messages this rule matched (pre-p, post-after)
        self.fired = 0    # actions actually injected

    def exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count


class FaultPlan:
    """A seeded, composable fault scenario.

    Rule methods return ``self`` so scenarios read as one chain::

        plan = FaultPlan(seed=7).drop("step*", p=0.3).delay("grad*", 0.02)

    Rules are evaluated in declaration order; the first rule that fires
    wins. Dynamic topology faults (partitions, slow links, keepalive
    blackholes) are checked before the rule list — a partition is
    absolute. All state is guarded by one lock: live Rpc loops on several
    threads consult the same plan concurrently.
    """

    def __init__(self, seed: int = 0, telemetry: Optional[Telemetry] = None):
        self.seed = int(seed)
        self._rng = Random(self.seed)
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._seq = 0
        self.events: List[Event] = []     # injected actions (deterministic)
        self.observed: List[Event] = []   # organic observations (conn drops)
        self._partitions: Set[frozenset] = set()
        self._slow_links: Dict[str, float] = {}
        self._keepalive_holes: Set[str] = set()
        # Telemetry mirror of the event log: every injected action bumps
        # chaos_injected_total{kind=...} (organic observations go to
        # chaos_observed_total{kind=...}), and with tracing enabled each
        # injection lands as an instant event on the shared trace
        # timeline — right next to the latency it caused. Counters are
        # process-cumulative, so the per-kind baseline snapshot taken at
        # first use keeps verify_telemetry()/telemetry_counts()
        # plan-relative.
        self._tel = telemetry if telemetry is not None else global_telemetry()
        self._tel_counters: Dict[str, Any] = {}
        self._tel_base: Dict[str, float] = {}
        self._obs_counters: Dict[str, Any] = {}

    # -- rules ----------------------------------------------------------------

    def drop(self, endpoint: str = "*", *, direction: str = "send",
             peer: str = "*", p: float = 1.0, after: int = 0,
             count: Optional[int] = None) -> "FaultPlan":
        """Drop matching messages (loss). ``after`` skips the first N
        matches; ``count`` bounds total injections; ``p`` fires each match
        with seeded probability."""
        return self._rule("drop", endpoint, direction, peer, p, None,
                          after, count)

    def delay(self, endpoint: str = "*", seconds: float = 0.05, *,
              direction: str = "send", peer: str = "*", p: float = 1.0,
              after: int = 0, count: Optional[int] = None) -> "FaultPlan":
        """Delay matching messages by a fixed amount (latency spike)."""
        return self._rule("delay", endpoint, direction, peer, p,
                          float(seconds), after, count)

    def duplicate(self, endpoint: str = "*", copies: int = 1, *,
                  direction: str = "recv", peer: str = "*", p: float = 1.0,
                  after: int = 0,
                  count: Optional[int] = None) -> "FaultPlan":
        """Deliver matching messages ``1 + copies`` times. Defaults to the
        recv seam: duplicate *delivery* of an already-received rid is the
        duplicate-suppression contract under test."""
        return self._rule("duplicate", endpoint, direction, peer, p,
                          int(copies), after, count)

    def reorder(self, endpoint: str = "*", window: float = 0.05, *,
                direction: str = "send", peer: str = "*", p: float = 1.0,
                after: int = 0, count: Optional[int] = None) -> "FaultPlan":
        """Reorder matching messages by holding each back a seeded-random
        amount in [0, window) — messages whose draws invert their spacing
        arrive out of order. The draw consumes the plan RNG, so the delay
        sequence is deterministic from the seed."""
        return self._rule("reorder", endpoint, direction, peer, p,
                          float(window), after, count)

    def _rule(self, kind, endpoint, direction, peer, p, arg, after,
              count) -> "FaultPlan":
        with self._lock:
            self._rules.append(
                _Rule(kind, endpoint, direction, peer, p, arg, after, count)
            )
        return self

    # -- dynamic topology -----------------------------------------------------

    def partition(self, a: str, b: str) -> "FaultPlan":
        """Bidirectionally drop everything between peers ``a`` and ``b``
        (including greetings, so reconnects cannot re-bind) until
        :meth:`heal`."""
        with self._lock:
            self._partitions.add(frozenset((a, b)))
            self._log_locked("partition", "start", a, b, None, None, None)
        return self

    def heal(self, a: str, b: str) -> "FaultPlan":
        with self._lock:
            self._partitions.discard(frozenset((a, b)))
            self._log_locked("partition", "heal", a, b, None, None, None)
        return self

    def slow_link(self, peer: str, seconds: float) -> "FaultPlan":
        """Shape latency: delay every message to/from ``peer`` by
        ``seconds`` (explicit rules still win — they are checked first)."""
        with self._lock:
            self._slow_links[peer] = float(seconds)
            self._log_locked("slow_link", "start", None, peer, None, None,
                             float(seconds))
        return self

    def heal_link(self, peer: str) -> "FaultPlan":
        with self._lock:
            self._slow_links.pop(peer, None)
            self._log_locked("slow_link", "heal", None, peer, None, None,
                             None)
        return self

    def blackhole_keepalive(self, peer: str) -> "FaultPlan":
        """Silently eat keepalives to/from ``peer`` while everything else
        flows — the half-open-link scenario that liveness probing (4
        silent intervals -> teardown) exists to detect."""
        with self._lock:
            self._keepalive_holes.add(peer)
            self._log_locked("keepalive_blackhole", "start", None, peer,
                             None, None, None)
        return self

    def heal_keepalive(self, peer: str) -> "FaultPlan":
        with self._lock:
            self._keepalive_holes.discard(peer)
            self._log_locked("keepalive_blackhole", "heal", None, peer,
                             None, None, None)
        return self

    # -- the decision engine --------------------------------------------------

    def decide(self, direction: str, me: str, peer: Optional[str],
               endpoint: str, rid: int) -> Verdict:
        """Verdict for one message — THE deterministic core. Pure in
        (seed, sequence of calls); every injected action is logged."""
        with self._lock:
            # 1. Partitions are absolute (and logged per message: the
            # event log is the replayable record of what was injected).
            if peer is not None and frozenset((me, peer)) in self._partitions:
                self._log_locked("partitioned", DROP, me, peer, endpoint,
                                 rid, None)
                return (DROP, None)
            # 2. Keepalive blackholes: control traffic only.
            if (peer in self._keepalive_holes
                    and endpoint == "@keepalive"):
                self._log_locked("keepalive_blackhole", DROP, me, peer,
                                 endpoint, rid, None)
                return (DROP, None)
            # 3. Declared rules, first fire wins.
            for rule in self._rules:
                if rule.exhausted():
                    continue
                if rule.direction != "both" and rule.direction != direction:
                    continue
                if not fnmatchcase(endpoint, rule.endpoint):
                    continue
                if rule.peer != "*" and (
                    peer is None or not fnmatchcase(peer, rule.peer)
                ):
                    continue
                rule.matched += 1
                if rule.matched <= rule.after:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                if rule.kind == "drop":
                    self._log_locked("drop", DROP, me, peer, endpoint, rid,
                                     None)
                    return (DROP, None)
                if rule.kind == "delay":
                    self._log_locked("delay", DELAY, me, peer, endpoint,
                                     rid, rule.arg)
                    return (DELAY, rule.arg)
                if rule.kind == "duplicate":
                    self._log_locked("duplicate", DUP, me, peer, endpoint,
                                     rid, rule.arg)
                    return (DUP, rule.arg)
                if rule.kind == "reorder":
                    held = self._rng.uniform(0.0, rule.arg)
                    self._log_locked("reorder", DELAY, me, peer, endpoint,
                                     rid, held)
                    return (DELAY, held)
            # 4. Slow links shape whatever no rule claimed.
            if peer is not None and peer in self._slow_links:
                seconds = self._slow_links[peer]
                self._log_locked("slow_link", DELAY, me, peer, endpoint,
                                 rid, seconds)
                return (DELAY, seconds)
        return PASS_VERDICT

    # -- bookkeeping ----------------------------------------------------------

    def _log_locked(self, kind, action, me, peer, endpoint, rid, arg):
        self.events.append(
            Event(self._seq, kind, action, me, peer, endpoint, rid, arg)
        )
        self._seq += 1
        # Black-box mirror: every injected action is also a typed flight
        # event, so a merged incident timeline shows the fault right next
        # to the state transitions it caused (the recorder lock is a leaf
        # under the plan lock).
        fr = self._tel.flight
        if fr.on:
            fr.record("chaos", kind=kind, action=str(action), peer=peer,
                      endpoint=endpoint)
        c = self._tel_counters.get(kind)
        if c is None:
            c = self._tel.registry.counter("chaos_injected_total", kind=kind)
            self._tel_counters[kind] = c
            self._tel_base[kind] = c.value
        c.inc()
        if self._tel.tracing:
            self._tel.traces.add_instant(
                f"chaos {kind}", "chaos", pid=me or "chaos",
                args={"action": str(action), "peer": peer,
                      "endpoint": endpoint, "rid": rid,
                      # Wire rules log numeric args (delay seconds, copy
                      # counts); disk rules log the destination basename
                      # — a string must not blow up the tracing branch.
                      "arg": (None if arg is None
                              else float(arg)
                              if isinstance(arg, (int, float)) else
                              str(arg))},
            )

    def observe(self, kind: str, me: str, peer: Optional[str], detail: str):
        """Record an organic observation (kept OUT of the injected-event
        log so seed-replay comparisons stay exact)."""
        with self._lock:
            self.observed.append(
                Event(len(self.observed), kind, "observe", me, peer, None,
                      None, detail)
            )
            c = self._obs_counters.get(kind)
            if c is None:
                c = self._tel.registry.counter(
                    "chaos_observed_total", kind=kind
                )
                self._obs_counters[kind] = c
            c.inc()
            if self._tel.tracing:
                self._tel.traces.add_instant(
                    f"chaos observed {kind}", "chaos", pid=me or "chaos",
                    args={"peer": peer, "detail": str(detail)},
                )

    def summary(self) -> Dict[str, int]:
        """Injected-action counts by kind — the soak tool's report unit."""
        with self._lock:
            out: Dict[str, int] = {}
            for e in self.events:
                out[e.kind] = out.get(e.kind, 0) + 1
            return out

    def telemetry_counts(self) -> Dict[str, int]:
        """Per-kind injected counts as recorded in the telemetry registry,
        relative to this plan's first use of each kind (the registry is
        process-cumulative across plans)."""
        with self._lock:
            return {
                k: int(round(c.value - self._tel_base[k]))
                for k, c in self._tel_counters.items()
            }

    def verify_telemetry(self) -> None:
        """Assert the registry's injected-fault counters exactly match the
        event log — the contract ``tools/chaos_soak.py --smoke`` (via the
        canonical scenarios) enforces on every run. Raises
        ``AssertionError`` on any divergence."""
        with self._lock:
            want: Dict[str, int] = {}
            for e in self.events:
                want[e.kind] = want.get(e.kind, 0) + 1
            got = {
                k: int(round(c.value - self._tel_base[k]))
                for k, c in self._tel_counters.items()
            }
        if got != want:
            raise AssertionError(
                f"telemetry fault counters diverge from the injected-event "
                f"log: registry={got} events={want}"
            )


class ProcFaultPlan(FaultPlan):
    """Seeded plan for PROCESS-level faults against the env-worker tier —
    the ``testing.chaos`` discipline extended below the wire: target
    selection is pure in the seed (:meth:`pick`), every applied action
    lands in the same replayable ordered event log as the wire faults
    (``proc_kill`` / ``proc_stop`` / ``proc_cont`` / ``proc_raise``
    events, mirrored into ``chaos_injected_total{kind}`` so
    :meth:`verify_telemetry` covers them), and a failing scenario
    reproduces from its seed alone.

    The plan only *decides*; :class:`ProcChaos` applies the decisions to
    a live :class:`~moolib_tpu_torch.envpool.EnvPool`'s worker slots.
    """

    def pick(self, n: int) -> int:
        """Seeded target draw in ``[0, n)`` — THE decision primitive:
        pure in (seed, sequence of ``pick`` calls), like
        :meth:`FaultPlan.decide` for wire faults."""
        if n < 1:
            raise ValueError(f"pick(n) needs n >= 1, got {n!r}")
        with self._lock:
            return self._rng.randrange(int(n))


class ProcChaos:
    """Applies a :class:`ProcFaultPlan`'s decisions to a live EnvPool.

    Worker slots are addressed by index — after a respawn the slot
    addresses the *replacement* process, so a plan can keep injecting
    into the same logical slice. Faults:

    - :meth:`kill` — SIGKILL (worker death: exit class),
    - :meth:`wedge` / :meth:`resume` — SIGSTOP / SIGCONT (the hung-step
      watchdog's class; SIGKILL terminates stopped processes, so a
      wedged worker needs no resume before the watchdog reaps it),
    - :meth:`inject_exception` — SIGUSR1, raised in-process as an
      uncatchable crash (the unpickleable-env-crash class).
    """

    def __init__(self, plan: ProcFaultPlan, pool):
        self.plan = plan
        self.pool = pool

    def _apply(self, slot: int, sig, kind: str, action: str) -> None:
        import os

        pid = self.pool._procs[slot].pid
        os.kill(pid, sig)
        with self.plan._lock:
            self.plan._log_locked(kind, action, None, f"worker{slot}",
                                  None, None, slot)

    def kill(self, slot: int) -> None:
        """SIGKILL the worker in ``slot`` (supervised death + respawn)."""
        import signal as _signal

        self._apply(slot, _signal.SIGKILL, "proc_kill", "kill")

    def wedge(self, slot: int) -> None:
        """SIGSTOP the worker in ``slot`` — the hung-step watchdog must
        distinguish it from a merely slow worker and reap it."""
        import signal as _signal

        self._apply(slot, _signal.SIGSTOP, "proc_stop", "stop")

    def resume(self, slot: int) -> None:
        """SIGCONT a previously wedged worker (heal before the watchdog
        fires — the slow-but-alive branch of the scenario space)."""
        import signal as _signal

        self._apply(slot, _signal.SIGCONT, "proc_cont", "cont")

    def inject_exception(self, slot: int) -> None:
        """Raise an uncatchable exception inside the worker via SIGUSR1
        (``envpool.pool._InjectedCrash``): always the worker-crash class,
        never absorbed by the poison-env quarantine guards."""
        import signal as _signal

        self._apply(slot, _signal.SIGUSR1, "proc_raise", "raise")


class _DiskRule:
    """One resource-exhaustion rule: inject ``errno_code`` when a disk
    operation matching (op glob, path glob) occurs, with the same
    after/count bounding discipline as the wire rules."""

    __slots__ = ("kind", "errno_code", "op", "path", "after", "count",
                 "matched", "fired")

    def __init__(self, kind: str, errno_code: int, op: str, path: str,
                 after: int, count: Optional[int]):
        self.kind = kind
        self.errno_code = errno_code
        self.op = op
        self.path = path
        self.after = int(after)
        self.count = count
        self.matched = 0
        self.fired = 0

    def exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count


class ResourceFaultPlan(ProcFaultPlan):
    """Seeded plan for RESOURCE-exhaustion faults — the chaos discipline
    extended to the durability tier: injected ``ENOSPC`` (disk full) and
    ``EMFILE`` (fd exhaustion) at the crash-atomic write seams
    (:mod:`moolib_tpu_torch.utils.diskio` — checkpoint and statestore writes
    both flow through them). Decisions are pure in (seed, sequence of
    disk operations presented); every injection lands in the same
    replayable ordered event log (kinds ``enospc`` / ``emfile``, the
    logged ``arg`` is the destination *basename* so staging-dir nonces
    and tmpdirs cannot break replay identity) and mirrors into
    ``chaos_injected_total{kind}`` like every other injected fault.

    :class:`ResourceChaos` installs the plan on the process-wide diskio
    hook; rules scope by path glob (match against the root-relative
    destination path), so one member's store can fill while its peers'
    disks stay healthy.

    Also inherits :meth:`ProcFaultPlan.pick` — the seeded target draw
    the bit-flip scenario uses to choose which replica/byte to corrupt.
    """

    def __init__(self, seed: int = 0, telemetry: Optional[Telemetry] = None):
        super().__init__(seed, telemetry)
        self._disk_rules: List[_DiskRule] = []

    def enospc(self, path: str = "*", *, op: str = "write", after: int = 0,
               count: Optional[int] = None) -> "ResourceFaultPlan":
        """Inject ``OSError(ENOSPC)`` on matching writes/fsyncs — the
        disk-full class. ``op`` globs over ``open``/``write``/``fsync``;
        ``after`` skips the first N matching operations (land the
        failure mid-bundle), ``count`` bounds total injections."""
        import errno

        return self._disk_rule("enospc", errno.ENOSPC, op, path, after,
                               count)

    def emfile(self, path: str = "*", *, op: str = "open", after: int = 0,
               count: Optional[int] = None) -> "ResourceFaultPlan":
        """Inject ``OSError(EMFILE)`` on matching opens — the
        fd-exhaustion class."""
        import errno

        return self._disk_rule("emfile", errno.EMFILE, op, path, after,
                               count)

    def _disk_rule(self, kind, errno_code, op, path, after,
                   count) -> "ResourceFaultPlan":
        with self._lock:
            self._disk_rules.append(
                _DiskRule(kind, errno_code, op, path, after, count)
            )
        return self

    def decide_disk(self, op: str, path: str) -> Optional[OSError]:
        """Verdict for one disk operation — deterministic like
        :meth:`FaultPlan.decide`: first non-exhausted rule whose op AND
        path globs match (post-``after``) fires. Returns the OSError to
        raise (tagged with ``statestore_op`` so the failure counters
        label the seam) or None to pass."""
        import os as _os

        with self._lock:
            for rule in self._disk_rules:
                if rule.exhausted():
                    continue
                if not fnmatchcase(op, rule.op):
                    continue
                if not fnmatchcase(path, rule.path):
                    continue
                rule.matched += 1
                if rule.matched <= rule.after:
                    continue
                rule.fired += 1
                self._log_locked(rule.kind, "raise", None, None, op, None,
                                 _os.path.basename(path))
                e = OSError(rule.errno_code,
                            f"injected {rule.kind} ({op} {path})")
                e.statestore_op = op
                return e
        return None


class ResourceChaos:
    """Installs a :class:`ResourceFaultPlan` on the process-wide disk
    fault hook (:mod:`moolib_tpu_torch.utils.diskio`). ``root`` relativizes
    the paths rules match against (operations outside ``root`` match
    with their absolute path — so a rule's path glob can still pin one
    store's directory while everything else passes untouched)::

        plan = ResourceFaultPlan(seed).enospc("v*/c*.bin", after=1,
                                              count=1)
        with ResourceChaos(plan, root=store.root):
            ...   # the second chunk write inside store.root fails
    """

    def __init__(self, plan: ResourceFaultPlan, root: Optional[str] = None):
        import os as _os

        self.plan = plan
        self.root = None if root is None else _os.path.abspath(root)

    def _hook(self, op: str, path: str) -> None:
        import os as _os

        p = _os.path.abspath(path)
        if self.root is not None:
            rel = _os.path.relpath(p, self.root)
            if not rel.startswith(".."):
                # Inside root: match the relative path, with staging-dir
                # components rewritten to their FINAL version name
                # (".stage-v000…42-<nonce>" -> "v000…42") so rules
                # written against the committed layout ("v*/c*.bin")
                # hit the staged write of that same file — and the
                # nonce can never enter rule matching or the event log.
                parts = []
                for x in rel.split(_os.sep):
                    if x.startswith(".stage-"):
                        bits = x.split("-")
                        x = bits[1] if len(bits) > 1 else x
                    parts.append(x)
                p = "/".join(parts)
        err = self.plan.decide_disk(op, p)
        if err is not None:
            raise err

    def __enter__(self) -> "ResourceChaos":
        from ..utils import diskio

        diskio.install_disk_fault_hook(self._hook)
        return self

    def __exit__(self, *exc):
        from ..utils import diskio

        diskio.uninstall_disk_fault_hook()


class _RpcFaultHooks:
    """Adapter: one per attached Rpc, translating wire-seam callbacks into
    :meth:`FaultPlan.decide` calls (the :mod:`moolib_tpu_torch.rpc.faults`
    contract)."""

    __slots__ = ("_net", "_name")

    def __init__(self, net: "ChaosNet", rpc):
        self._net = net
        self._name = rpc.get_name()

    def filter_send(self, rpc, conn, rid, fid, frames) -> Verdict:
        return self._net.plan.decide(
            "send", self._name, conn.peer_name,
            self._net.endpoint_name(fid), rid,
        )

    def filter_recv(self, rpc, conn, rid, fid, obj) -> Verdict:
        peer = conn.peer_name
        if peer is None and fid == FID_GREETING and isinstance(obj, dict):
            # Greetings are how a conn ACQUIRES its name; match on the
            # claimed name so partitions block re-binding too.
            peer = obj.get("name")
        return self._net.plan.decide(
            "recv", self._name, peer, self._net.endpoint_name(fid), rid,
        )

    def on_conn_drop(self, rpc, conn, why: str):
        self._net.plan.observe("conn_drop", self._name, conn.peer_name, why)


class ChaosNet:
    """Installs a :class:`FaultPlan` on live Rpc instances.

    Usage::

        plan = FaultPlan(seed=7).drop("inc", count=1)
        with ChaosNet(plan, [client, server]) as net:
            ...
            net.kill_conns(client, "server")   # injected conn kill

    Both endpoints of a link should be attached when using partitions:
    the send seam cannot name a peer before the greeting binds the
    connection, so partition enforcement for fresh dials happens on the
    receiver's greeting.
    """

    def __init__(self, plan: FaultPlan, rpcs=()):
        self.plan = plan
        self._rpcs: List[Any] = []
        self._fid_names: Dict[int, str] = dict(CONTROL_NAMES)
        self._names_lock = threading.Lock()
        for rpc in rpcs:
            self.attach(rpc)

    # -- lifecycle ------------------------------------------------------------

    def attach(self, rpc) -> "ChaosNet":
        rpc.install_fault_hooks(_RpcFaultHooks(self, rpc))
        self._rpcs.append(rpc)
        self._absorb_names(rpc)
        return self

    def detach_all(self):
        for rpc in self._rpcs:
            # Sync teardown of a possibly-closed Rpc: uninstall is a plain
            # attribute clear, nothing cancellable runs here.
            try:
                rpc.uninstall_fault_hooks()
            except Exception:  # moolint: disable=swallow-cancelled
                pass
        self._rpcs.clear()

    def __enter__(self) -> "ChaosNet":
        return self

    def __exit__(self, *exc):
        self.detach_all()

    # -- endpoint naming ------------------------------------------------------

    def register_endpoints(self, names) -> "ChaosNet":
        """Teach the net endpoint names not defined on any attached Rpc
        (fids are hashes — they cannot be inverted, only recognized)."""
        with self._names_lock:
            for name in names:
                self._fid_names[fid_for(name)] = name
        return self

    def _absorb_names(self, rpc):
        with self._names_lock:
            for fid, (name, _fn) in list(rpc._functions.items()):
                self._fid_names[fid] = name

    def endpoint_name(self, fid: int) -> str:
        name = self._fid_names.get(fid)
        if name is not None:
            return name
        # Lazy refresh: an endpoint defined after attach (or on a peer
        # attached later) becomes resolvable the first time it is seen.
        for rpc in self._rpcs:
            entry = rpc._functions.get(fid)
            if entry is not None:
                with self._names_lock:
                    self._fid_names[fid] = entry[0]
                return entry[0]
        return f"fid:{fid}"

    # -- imperative faults ----------------------------------------------------

    def kill_conns(self, rpc, peer: str = "*", wait: float = 5.0,
                   transport: str = "*") -> int:
        """Kill ``rpc``'s live connections to peers matching ``peer`` (an
        injected connection loss — reconnect/resend machinery takes over).
        ``transport`` narrows the kill to matching lanes (e.g. ``"shm"``
        for the segment-death scenario: the socket lanes survive and
        in-flight traffic must fail over onto them). Returns the number
        of connections killed; blocks up to ``wait`` seconds for the
        teardown to run on the IO loop."""
        result: Dict[str, int] = {}
        done = threading.Event()

        def doit():
            n = 0
            try:
                for p in list(rpc._peers.values()):
                    if not fnmatchcase(p.name, peer):
                        continue
                    for conn in list(p.conns.values()):
                        if not fnmatchcase(conn.transport, transport):
                            continue
                        rpc._drop_conn(conn, "chaos: injected conn kill")
                        n += 1
                if peer == "*":
                    for conn in list(rpc._anon_conns):
                        if not fnmatchcase(conn.transport, transport):
                            continue
                        rpc._drop_conn(conn, "chaos: injected conn kill")
                        n += 1
            finally:
                result["n"] = n
                with self.plan._lock:
                    self.plan._log_locked(
                        "conn_kill", "kill", rpc.get_name(), peer, None,
                        None, n,
                    )
                done.set()

        rpc._loop.call_soon_threadsafe(doit)
        if wait:
            done.wait(wait)
        return result.get("n", 0)

    def partition(self, a: str, b: str) -> "ChaosNet":
        self.plan.partition(a, b)
        return self

    def heal(self, a: str, b: str) -> "ChaosNet":
        self.plan.heal(a, b)
        return self
