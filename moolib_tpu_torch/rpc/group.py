"""Group membership view + async tree allreduce over RPC; the
counterpart of :mod:`moolib_tpu.rpc.group`, wire-compatible with it:
port and reference members can reduce together in one group, through
either package's Broker.

Capability parity with the reference's Group/AllReduce services
(reference: src/group.h — GroupService client view :330-491 pinging the
broker and swapping member lists on syncId change; AllReduceService
:508-788: binary-tree reduce up / broadcast down with out-of-order arrival
parking, per-op naming "{syncId}.{group}::{name}", builtin Sum/Product/
Min/Max or arbitrary local op, and cancellation of in-flight ops on
membership change).

This is the elastic path between independently failing processes
(gradients, stats, leader election). The reduce runs on the host: leaves
are numpy arrays, except ``bfloat16``, which numpy lacks without
``ml_dtypes`` and which the port therefore holds as a ``torch.bfloat16``
CPU tensor (what the port's wire decodes it to). A torch CPU tensor of
any other dtype enters as its numpy view; a CUDA tensor is refused, so
that no collective hides a blocking device-to-host copy (stage it first,
:func:`~moolib_tpu_torch.utils.stage_host_async`). ``np.add`` on
``ml_dtypes`` bf16 and torch's CPU bf16 add both round each partial
once, so a bf16 sum is bitwise the reference's.

REDUCTION-ORDER CONTRACT (bit-replay): for a fixed member list and fixed
payloads, ``all_reduce`` produces *bitwise-identical* results regardless
of peer arrival timing. Node ``i`` folds strictly in child-index order —
``own ⊕ subtree(2i+1) ⊕ subtree(2i+2)`` — buffering any child partial
that arrives ahead of a lower-index sibling instead of merging it on
arrival. The full reduction order is therefore a pure function of the
membership list and the tree shape. Floating-point reductions are NOT
reassociated by scheduling jitter; seeded learning parity can diff
results across runs and hosts at the bit level. A future
hierarchical or quantized allreduce that wants a different order must
renegotiate this contract explicitly — in its op naming/versioning —
not drift it silently. Exception: a straggler write-off
(``straggler_timeout``) commits a partial over the *present* subset, in
the same fixed order over that subset; under-quorum handling is the
caller's job (see ``all_reduce``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import secrets
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils import get_logger, nest
from .rpc import Future, Rpc, RpcError

log = get_logger("group")

__all__ = ["Group", "AllReduce", "REDUCE_OPS"]


def _is_array(x) -> bool:
    """A host array leaf: a numpy array or a torch (bf16) CPU tensor.
    Chunk eligibility counts both, as the reference counts its
    ``ml_dtypes`` bf16 arrays, so that every member of a mixed group
    decides alike."""
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _host_leaf(x):
    """One payload leaf in the form the host reduce takes: a CUDA tensor
    is refused; a torch CPU tensor becomes its numpy view unless it is
    bf16; a numpy bf16 array (``ml_dtypes``, where something imported it)
    becomes a torch bf16 tensor over the same bits. Anything else passes
    through unchanged."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError(
                f"allreduce payload leaf on {x.device}: the host reduce "
                "takes host leaves; stage device tensors first "
                "(moolib_tpu_torch.utils.stage_host_async)"
            )
        x = x.detach()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    if isinstance(x, np.ndarray) and x.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)
    return x


def _binary(np_fn, torch_fn):
    # A leaf is a torch tensor on every member's side or on none (bf16).
    def op(a, b):
        if isinstance(a, torch.Tensor):
            return torch_fn(a, b)
        return np_fn(a, b)

    return op


_sum = _binary(np.add, torch.add)
_prod = _binary(np.multiply, torch.mul)
_min = _binary(np.minimum, torch.minimum)
_max = _binary(np.maximum, torch.maximum)


REDUCE_OPS: Dict[str, Callable] = {
    "sum": _sum,
    "product": _prod,
    "min": _min,
    "max": _max,
}

# Elementwise builtin ops can be reduced chunk-by-chunk; large payloads are
# split into a BOUNDED number of pieces (pipeline depth _CHUNK_DEPTH) that
# flow through the tree as independent concurrent sub-ops, overlapping hop
# i's transfer with hop i+1's merge on DIFFERENT hosts. Chunk size floors
# at _CHUNK_BYTES: depth beyond ~4 only multiplies per-message overhead
# (measured: on a single-core loopback — zero cross-host concurrency to
# exploit — chunking is pure overhead, so the floor keeps the message
# count small; on multi-host DCN the depth-4 pipeline is the win; the
# reference's injected-latency A/B, tools/allreduce_latency_ab.py,
# demonstrates the overlap win without a second host).
#
# CLUSTER-WIDE CONSISTENCY: chunk geometry (sub-op keys name#cN + chunk
# boundaries) is derived from the chunk size, so every member of a reduce
# MUST use the same value or the round stalls until timeout. Callers with
# a negotiation channel should pass an explicitly agreed ``chunk_bytes``
# to ``all_reduce`` (the Accumulator carries it through its count round,
# min-merged, so mixed env settings converge instead of livelocking);
# bare ``all_reduce`` users fall back to this env default, which must
# then be identical on every host — including across rolling upgrades
# that change the default.
_ELEMENTWISE = frozenset({_sum, _prod, _min, _max})
_CHUNK_BYTES = int(__import__("os").environ.get(
    "MOOLIB_TPU_ALLREDUCE_CHUNK", 1 << 23
))
_CHUNK_DEPTH = 4
#: Public default for callers that negotiate chunk geometry themselves.
CHUNK_BYTES_DEFAULT = _CHUNK_BYTES


class AllReduce(Future):
    """Future for one collective op (reference surface: moolib.AllReduce)."""

    def __init__(self, op_key: str):
        super().__init__()
        self.op_key = op_key


class _Op:
    __slots__ = ("key", "data", "op_fn", "children", "received",
                 "future", "started", "index", "members", "forwarded",
                 "owns", "lock", "q_deadline", "pending", "next_child",
                 "seen")

    def __init__(self, key, data, op_fn, index, members, future,
                 straggler_timeout: Optional[float] = None):
        self.key = key
        self.data = data
        self.op_fn = op_fn
        self.index = index
        self.members = members
        n = len(members)
        self.children = [
            c for c in (2 * index + 1, 2 * index + 2) if c < n
        ]
        self.received = 0
        self.future = future
        self.started = time.monotonic()
        self.forwarded = False
        # Fixed reduction order (see module docstring): partials that
        # arrive ahead of a lower-index sibling buffer here until the
        # prefix fills in; next_child indexes the first child (in
        # ascending-index order) not yet merged, and seen drops
        # duplicate deliveries from the same child before the forward.
        self.pending: Dict[int, Any] = {}
        self.next_child = 0
        self.seen: set = set()
        # data starts as the CALLER's arrays (never mutated); after the
        # first merge it is op-private and later merges may go in-place.
        self.owns = False
        self.lock = threading.Lock()  # serializes merges of this op
        # Straggler write-off deadline (quorum rounds): an interior node
        # past it forwards whatever partial it has instead of stalling the
        # whole tree on one slow child. Staged by subtree height so nodes
        # nearer the root wait longer — partials from below get a chance
        # to arrive before the level above writes them off. Leaves never
        # wait for anyone, so they carry no deadline.
        if straggler_timeout is None or not self.children:
            self.q_deadline = None
        else:
            h = _subtree_height(index, n)
            self.q_deadline = self.started + float(straggler_timeout) * (
                1.0 + 0.5 * max(0, h - 1)
            )


class Group:
    """Client-side membership view + collectives for one named group.

    Mirrors the reference Python surface (reference: src/moolib.cc
    GroupWrapper): ``update()`` from the training loop, ``members``/
    ``sync_id`` properties, ``all_reduce(name, data, op)``.
    """

    _PING_INTERVAL = 1.0  # reference pings every <=4s (src/group.h:425-451)

    def __init__(self, rpc: Rpc, broker_name: str = "broker",
                 group_name: str = "default", timeout: float = 10.0,
                 sort_order: int = 0):
        self.rpc = rpc
        self.broker_name = broker_name
        self.group_name = group_name
        self.timeout = timeout
        self.sort_order = sort_order
        # Broker-dark grace: how long the last sync stays trusted after
        # the broker goes silent. Within the window the group keeps its
        # membership (peer-to-peer collectives still work without the
        # broker); past it, callers (e.g. the Accumulator) should degrade
        # instead of queueing rounds that can only time out.
        self.broker_grace = max(3.0 * timeout, 15.0)
        self._grace_explicit = False  # set_broker_grace pins it
        self._closed = False  # close() idempotence latch
        self._lock = threading.RLock()
        self._sync_id: Optional[str] = None
        self._members: List[str] = []
        self._last_ping = 0.0
        self._ping_inflight = False
        self._last_broker_contact = time.monotonic()  # optimistic start
        self._broker_dark_logged = False
        # Incarnation nonce: rides every ping so the broker can tell a
        # restarted process reusing its old peer name from the dead
        # incarnation it replaces (stale sequence/epoch state must never
        # be attributed to the new process — see Broker._ping).
        self._incarnation = secrets.token_hex(8)
        # Broker failover: an ordered candidate list (primary first).
        # While the current authority stays silent past the failover
        # threshold, update() rotates to the next candidate; a standby
        # broker re-materializes the epoch from cohort gossip (pings
        # carry sync_id + member list) and serves within one ping
        # interval of being adopted.
        self._broker_candidates: List[str] = []
        self._failover_after = 3.0 * self._PING_INTERVAL
        self._active: Dict[str, _Op] = {}
        self._parked: Dict[str, List[tuple]] = {}
        # Results that arrived for ops we have not STARTED yet. Before
        # quorum commits this was impossible (a result required every
        # member's op active); now a round can commit while a stalled
        # member has not begun its local op — dropping that share would
        # strand the member on a sequence number the cohort has moved
        # past, permanently. Parked results complete the op the moment
        # it starts; stale ones age out via _expire_ops.
        self._parked_shares: Dict[str, tuple] = {}  # key -> (result, ts)
        # Keys whose LOCAL op already reached an outcome by expiry: a
        # share arriving for one of these is the dead round's result —
        # parking it would let a same-key retry complete instantly with
        # stale data. Entries clear when the key is started again and
        # age out with the op timeout.
        self._expired_keys: Dict[str, float] = {}
        # Telemetry (per-Rpc registry; one source of truth for round and
        # broker-health accounting — broker_connected()/broker_silence()
        # stay as thin views over the same state the gauges read).
        reg = rpc.telemetry.registry
        g = group_name
        # Flight recorder (moolib_tpu/flightrec): epoch/membership and
        # broker-authority transitions land in the peer's black box.
        self._flight = rpc.telemetry.flight
        self._m_rounds = reg.counter("group_rounds_total", group=g)
        self._m_round_dur = reg.histogram("group_round_seconds", group=g)
        self._m_rounds_expired = reg.counter(
            "group_rounds_expired_total", group=g
        )
        self._m_rounds_cancelled = reg.counter(
            "group_rounds_cancelled_total", group=g
        )
        self._m_resyncs = reg.counter("group_resyncs_total", group=g)
        self._m_dark_seconds = reg.counter(
            "group_broker_dark_seconds_total", group=g
        )
        self._m_failovers = reg.counter(
            "group_broker_failovers_total", group=g
        )
        # Quorum/straggler machinery: interior partial forwards vs root
        # partial commits (a committed round that wrote stragglers off).
        self._m_partial_forwards = reg.counter(
            "group_partial_forwards_total", group=g
        )
        self._m_partial_commits = reg.counter(
            "group_partial_commits_total", group=g
        )
        self._dark_mark = time.monotonic()  # last dark-time accrual point
        # Weakref: the registry outlives this Group; a strong `self` in
        # the gauge closures would pin it (and every parked payload)
        # after close(). close() unregisters the series.
        wself = weakref.ref(self)
        self._gauge_names = (
            "group_members", "group_broker_silence_seconds",
            "group_broker_connected", "group_ping_inflight",
            "group_ops_active", "group_ops_parked",
        )
        reg.gauge_fn("group_members", lambda: len(wself()._members), group=g)
        reg.gauge_fn("group_broker_silence_seconds",
                     lambda: wself().broker_silence(), group=g)
        reg.gauge_fn("group_broker_connected",
                     lambda: 1.0 if wself().broker_connected() else 0.0,
                     group=g)
        reg.gauge_fn("group_ping_inflight",
                     lambda: 1.0 if wself()._ping_inflight else 0.0, group=g)
        reg.gauge_fn("group_ops_active",
                     lambda: len(wself()._active), group=g)
        reg.gauge_fn("group_ops_parked",
                     lambda: len(wself()._parked), group=g)
        self._shared_state(rpc).register(self)

    # Per-Rpc shared dispatch for the three service functions.
    class _Shared:
        def __init__(self, rpc: Rpc):
            self.groups: Dict[str, "Group"] = {}
            # inline=True: the tree's per-hop cost is dominated by thread
            # handoffs at high chunk rates; these handlers are short (a
            # chunk-sized elementwise reduce at most) and never block. Heavy
            # completion work (pytree reassembly) is explicitly offloaded —
            # see _completion_executor.
            # The _Shared registrar is a per-Rpc singleton (one per
            # `rpc._moolib_group_shared`): these endpoints serve every
            # Group the rpc ever hosts and die with the rpc itself, so
            # there is deliberately no per-Group undefine.
            rpc.define("GroupService::update", self._on_update, inline=True)  # lifelint: intentional -- per-Rpc singleton endpoint, lives for the rpc's lifetime
            rpc.define("AllReduceService::reduce", self._on_reduce,  # lifelint: intentional -- per-Rpc singleton endpoint, lives for the rpc's lifetime
                       inline=True)
            rpc.define("AllReduceService::share", self._on_share, inline=True)  # lifelint: intentional -- per-Rpc singleton endpoint, lives for the rpc's lifetime

        def register(self, group: "Group"):
            self.groups[group.group_name] = group

        def _on_update(self, group_name, sync_id, members):
            g = self.groups.get(group_name)
            if g is not None:
                g._apply_sync(sync_id, members)
            return True

        def _on_reduce(self, op_key, payload, sender=None):
            # sender is the child's member index — the key the fixed
            # reduction order merges by. Peers from before the order
            # contract omit it and fall back to arrival-order merging.
            g = self.groups.get(_group_of(op_key))
            if g is not None:
                g._reduce_in(op_key, payload, sender)
            return True

        def _on_share(self, op_key, result):
            g = self.groups.get(_group_of(op_key))
            if g is not None:
                g._share_in(op_key, result)
            return True

    @staticmethod
    def _shared_state(rpc: Rpc) -> "Group._Shared":
        shared = getattr(rpc, "_moolib_group_shared", None)
        if shared is None:
            shared = Group._Shared(rpc)
            rpc._moolib_group_shared = shared
        return shared

    # -- membership ----------------------------------------------------------

    def set_broker_name(self, name: str):
        """Point future pings at a different broker peer (reference:
        Group::setBrokerName, src/moolib.cc:2256). Resets the ping gate: a
        ping still in flight to a dead broker would otherwise block the
        first ping to the new one for the full RPC timeout — far longer
        than the membership expiry this failover exists to beat."""
        self.broker_name = str(name)
        self._ping_inflight = False
        self._last_ping = 0.0
        # Fresh authority, fresh grace window (broker_dark_seconds stops
        # accruing the moment a standby is promoted).
        self._last_broker_contact = time.monotonic()
        self._broker_dark_logged = False

    def set_broker_candidates(self, names: List[str],
                              failover_after: Optional[float] = None):
        """Enable automatic broker failover over an ordered candidate
        list (primary first). When the current authority has been silent
        for ``failover_after`` seconds (default: 3 ping intervals),
        ``update()`` rotates to the next candidate and pings it on the
        very next tick — a live standby therefore takes over within one
        ping interval of the switch. Rotation is cyclic, so a restarted
        primary is retried once every standby has had its window."""
        self._broker_candidates = [str(n) for n in names]
        if failover_after is not None:
            self._failover_after = float(failover_after)

    def _promote_next_broker(self):
        cands = self._broker_candidates
        try:
            i = cands.index(self.broker_name)
        except ValueError:
            i = -1
        nxt = cands[(i + 1) % len(cands)]
        log.warning(
            "group %s: broker %r silent for %.1fs — failing over to %r",
            self.group_name, self.broker_name, self.broker_silence(), nxt,
        )
        self._m_failovers.inc()
        if self._flight.on:
            self._flight.record("broker_promote", group=self.group_name,
                                old=self.broker_name, new=nxt,
                                silence_s=round(self.broker_silence(), 3))
        self.set_broker_name(nxt)

    def set_timeout(self, seconds: float):
        """Collective/membership timeout (reference: Group::setTimeout,
        src/moolib.cc:2257). Re-derives the broker grace window unless it
        was pinned by an explicit ``set_broker_grace``."""
        self.timeout = float(seconds)
        if not self._grace_explicit:
            self.broker_grace = max(3.0 * self.timeout, 15.0)

    def set_sort_order(self, order: int):
        """Member-list sort priority carried with pings — lower sorts
        first, influencing rank/tree position (reference:
        Group::setSortOrder, src/moolib.cc:2258)."""
        self.sort_order = int(order)

    def set_broker_grace(self, seconds: float):
        """How long the last membership sync stays trusted while the
        broker is unreachable (see ``broker_connected``). Pins the value:
        later ``set_timeout`` calls no longer re-derive it."""
        self.broker_grace = float(seconds)
        self._grace_explicit = True

    def broker_silence(self) -> float:
        """Seconds since the broker was last heard from (a pong or a
        membership push)."""
        return time.monotonic() - self._last_broker_contact

    def broker_connected(self) -> bool:
        """True while the broker has been heard from within the grace
        window. The group keeps its last sync either way — a dark broker
        cannot change membership, so the sorted member list (and every
        peer's tree position) stays valid until the broker returns and
        pushes a fresh epoch; peers rejoin with their same sort order via
        the very next ping."""
        return self.broker_silence() <= self.broker_grace

    def name(self) -> str:
        """Group name (reference: Group::name, src/moolib.cc:2261)."""
        return self.group_name

    @property
    def sync_id(self) -> Optional[str]:
        return self._sync_id

    @property
    def members(self) -> List[str]:
        return list(self._members)

    @property
    def rank(self) -> Optional[int]:
        with self._lock:
            try:
                return self._members.index(self.rpc.get_name())
            except ValueError:
                return None

    def active(self) -> bool:
        return self._sync_id is not None and self.rpc.get_name() in self._members

    def update(self):
        """Heartbeat; call regularly from the training loop
        (reference: GroupService::update client side, src/group.h:394-490)."""
        now = time.monotonic()
        # Broker failover: rotate to the next candidate once the current
        # authority has been silent past the failover threshold. Checked
        # before the ping gate so the promotion ping goes out on THIS
        # tick (set_broker_name re-opens the gate).
        if (self._broker_candidates
                and self.broker_silence() > self._failover_after):
            self._promote_next_broker()
            now = time.monotonic()
        # Ping-gate watchdog: a ping to a dead/restarting broker errors
        # only at the full RPC timeout (~30s), which would gate the NEXT
        # ping — and therefore rejoin after a broker restart — behind it.
        # Write the ping off as lost after a few intervals instead; a
        # late pong is harmless (membership is epoch-keyed).
        if (self._ping_inflight
                and now - self._last_ping
                > max(4.0 * self._PING_INTERVAL, min(self.timeout, 10.0))):
            self._ping_inflight = False
        if not self._ping_inflight and now - self._last_ping >= self._PING_INTERVAL:
            self._ping_inflight = True
            self._last_ping = now

            def on_pong(result, error):
                self._ping_inflight = False
                if error is not None:
                    log.debug("broker ping failed: %s", error)
                else:
                    self._last_broker_contact = time.monotonic()
                    self._broker_dark_logged = False

            try:
                # sync_id + member list are the gossip a promoted standby
                # re-materializes the epoch from (see Broker._ping); the
                # incarnation nonce distinguishes a restarted process
                # reusing this peer name from its dead predecessor.
                self.rpc.async_callback(
                    self.broker_name, "BrokerService::ping", on_pong,
                    self.group_name, self.rpc.get_name(), self.timeout,
                    self._sync_id, self.sort_order,
                    self._incarnation, self.members,
                )
            except BaseException:
                # Synchronous dispatch failure (closing rpc, bad peer):
                # re-open the ping gate or membership never recovers —
                # on_pong will never run to clear it.
                self._ping_inflight = False
                raise
        # Broker-dark seconds accrue between update() ticks while dark —
        # the counter form of broker_silence() that survives recoveries.
        dark_now = not self.broker_connected()
        mark, self._dark_mark = self._dark_mark, now
        if dark_now and now > mark:
            self._m_dark_seconds.inc(now - mark)
        if dark_now and not self._broker_dark_logged:
            self._broker_dark_logged = True
            if self._flight.on:
                self._flight.record("broker_dark", group=self.group_name,
                                    broker=self.broker_name,
                                    silence_s=round(self.broker_silence(), 3))
            log.warning(
                "group %s: broker %r silent for %.1fs (grace %.1fs) — "
                "keeping last membership (%d members), rejoining on the "
                "next pong with sort_order=%d",
                self.group_name, self.broker_name, self.broker_silence(),
                self.broker_grace, len(self._members), self.sort_order,
            )
        self._expire_ops()

    def _apply_sync(self, sync_id: str, members: List[str]):
        # A push IS broker contact (restarted brokers push before the
        # next pong lands).
        self._last_broker_contact = time.monotonic()
        self._broker_dark_logged = False
        with self._lock:
            if sync_id == self._sync_id:
                self._members = list(members)
                return
            old = self._sync_id
            self._sync_id = sync_id
            self._members = list(members)
            # Cancel every in-flight op from the previous epoch
            # (reference: src/group.h:453-460).
            cancelled = list(self._active.values())
            self._active.clear()
            # Drop parks of the epoch we are leaving (provably stale). Parks
            # under any OTHER id stay: a faster peer may already be reducing
            # in an epoch whose push hasn't reached us (they age out via
            # _expire_ops if that epoch never arrives).
            if old is not None:
                for key in [k for k in self._parked if _is_current(k, old)]:
                    del self._parked[key]
                for key in [k for k in self._parked_shares
                            if _is_current(k, old)]:
                    del self._parked_shares[key]
                for key in [k for k in self._expired_keys
                            if _is_current(k, old)]:
                    del self._expired_keys[key]
        self._m_resyncs.inc()
        if self._flight.on:
            self._flight.record("group_epoch", group=self.group_name,
                                sync_id=str(sync_id)[:16],
                                members=list(members),
                                cancelled=len(cancelled))
        if cancelled:
            self._m_rounds_cancelled.inc(len(cancelled))
            pool = _completion_executor()
            for op in cancelled:
                # Fire-and-forget by design: _set_exception only completes
                # the op future (never raises), so the worker future is
                # empty by construction.
                pool.submit(  # moolint: disable=dropped-future
                    op.future._set_exception,
                    RpcError(
                        f"allreduce {op.key} cancelled: membership changed"
                    ),
                )
        if old is not None:
            log.info("group %s: resync %s -> %s (%d members)",
                     self.group_name, old[:8], sync_id[:8], len(members))

    def _expire_ops(self):
        now = time.monotonic()
        expired = []
        force = []
        with self._lock:
            for key, op in list(self._active.items()):
                if now - op.started > self.timeout:
                    del self._active[key]
                    self._expired_keys[key] = now
                    expired.append(op)
                elif (op.q_deadline is not None and not op.forwarded
                        and now >= op.q_deadline
                        and op.received < len(op.children)):
                    # Straggler deadline: write the missing children off
                    # and move the partial along (outside this lock — the
                    # forced forward takes op.lock first, like a merge).
                    force.append(op)
            for key, ts in list(self._expired_keys.items()):
                if now - ts > self.timeout:
                    del self._expired_keys[key]
            for key, parked in list(self._parked.items()):
                self._parked[key] = [
                    p for p in parked if now - p[2] <= self.timeout
                ]
                if not self._parked[key]:
                    del self._parked[key]
            for key, (_res, ts) in list(self._parked_shares.items()):
                if now - ts > self.timeout:
                    del self._parked_shares[key]
        for op in force:
            self._force_forward(op)
        if expired:
            self._m_rounds_expired.inc(len(expired))
            # Diagnosability under partial failure: a round that starves
            # because membership cannot heal (broker dark) reads
            # differently from one that starved under a live broker (a
            # slow/partitioned peer). The CURRENT authority is named so a
            # post-failover error points at the standby, not the corpse.
            dark = "" if self.broker_connected() else (
                f" (broker {self.broker_name!r} silent for "
                f"{self.broker_silence():.1f}s — membership cannot heal "
                "until it returns)"
            )
            pool = _completion_executor()
            for op in expired:
                # Fire-and-forget by design: _set_exception never raises.
                pool.submit(  # moolint: disable=dropped-future
                    op.future._set_exception,
                    RpcError(f"allreduce {op.key} timed out{dark}"),
                )

    # -- allreduce -----------------------------------------------------------

    def all_reduce(self, name: str, data: Any,
                   op: Union[str, Callable] = "sum",
                   chunk_bytes: Optional[int] = None,
                   straggler_timeout: Optional[float] = None) -> AllReduce:
        """Start an async tree allreduce; returns a Future
        (reference: AllReduceService::allReduce, src/group.h:687-787).

        Multi-MB payloads under elementwise builtin ops are chunked into
        concurrent sub-ops for pipelined transfer. ``chunk_bytes``
        overrides the env default (0 disables chunking entirely); chunk
        geometry determines sub-op keys and boundaries, so it must be
        IDENTICAL on every member — pass a negotiated value (as the
        Accumulator does through its count round) when members may be
        configured differently.

        Leaves are host values (see the module docstring); a CUDA tensor
        raises ``TypeError``.

        ``straggler_timeout`` enables quorum-style partial commits: an
        interior node that has waited past the (height-staged) deadline
        forwards its partial sum without the missing children, and the
        root commits whatever arrived — every member then receives the
        SAME partial result. The group layer only provides the
        mechanism; callers that need a K-of-N commit rule must encode
        participation in the payload (as the Accumulator does) and
        reject under-quorum results identically on every member.
        Straggler ops are never chunked: a partial cut of independent
        sub-ops could commit different participant sets per chunk.
        Callers MUST use unique per-round op names with
        ``straggler_timeout`` (as the Accumulator's seq/attempt-suffixed
        keys do): a written-off child's late payload parks under the
        round's key, and reusing that key would drain the stale payload
        into the next round as a fresh contribution."""
        op_fn = _resolve_op(op)
        data = nest.map_structure(_host_leaf, data)
        floor = _CHUNK_BYTES if chunk_bytes is None else int(chunk_bytes)
        threshold = 2 * floor if floor else (1 << 62)
        if op_fn in _ELEMENTWISE and floor and straggler_timeout is None:
            leaves = nest.flatten(data)
            if (
                all(_is_array(x) for x in leaves)
                and sum(_nbytes(x) for x in leaves) > threshold
            ):
                return self._all_reduce_chunked(
                    name, data, leaves, op_fn, floor
                )
        return self._all_reduce_one(name, data, op_fn,
                                    straggler_timeout=straggler_timeout)

    def _all_reduce_one(self, name: str, data: Any, op_fn: Callable,
                        straggler_timeout: Optional[float] = None
                        ) -> AllReduce:
        with self._lock:
            if self._sync_id is None or not self._members:
                raise RpcError(
                    f"group {self.group_name!r} not synchronized yet"
                )
            me = self.rpc.get_name()
            if me not in self._members:
                raise RpcError(f"{me!r} is not a member of {self.group_name!r}")
            index = self._members.index(me)
            key = f"{self._sync_id}.{self.group_name}::{name}"
            if key in self._active:
                raise RpcError(f"allreduce {name!r} already in flight")
            fut = AllReduce(key)
            op_obj = _Op(key, data, op_fn, index, list(self._members), fut,
                         straggler_timeout=straggler_timeout)
            self._active[key] = op_obj
            # A retry of a previously-expired key starts FRESH: future
            # shares for it are live again.
            self._expired_keys.pop(key, None)
            parked = self._parked.pop(key, [])
            parked_share = self._parked_shares.pop(key, None)
        # Unconditional, like every other Group counter: per-round cadence
        # costs nothing, and a telemetry toggle mid-run must not make
        # rounds_total diverge from rounds_expired/cancelled (>100% ratios).
        self._m_rounds.inc()
        if parked_share is not None:
            # The cohort already committed this round without us (quorum
            # write-off while this op had not started): complete from the
            # parked result instead of reducing toward a round that is
            # over. _share_in pops the op, re-shares to children, and
            # completes the future.
            self._share_in(key, parked_share[0])
            return fut
        # Drain early arrivals from children (reference: src/group.h:771-783).
        for p_key, payload, _ts, p_sender in parked:
            self._reduce_in(p_key, payload, p_sender)
        self._maybe_forward(op_obj)
        return fut

    def _all_reduce_chunked(self, name: str, data: Any, leaves: List[Any],
                            op_fn: Callable, chunk_floor: int) -> AllReduce:
        """Split an elementwise reduce into concurrent ~chunk_floor sub-ops.

        Chunk boundaries depend only on the leaf shapes and chunk_floor
        (which callers must ensure is identical on every member — see
        all_reduce), so all peers produce matching sub-op keys. Each
        sub-op's payload is a flat list of array views; the parent future
        reassembles the original pytree when the last sub-op lands."""
        # Bounded pipeline depth: chunk = max(floor, total/_CHUNK_DEPTH).
        total_bytes = sum(_nbytes(x) for x in leaves)
        chunk_bytes = max(
            chunk_floor, -(-total_bytes // _CHUNK_DEPTH)
        )
        pieces: List[tuple] = []  # (leaf_idx, flat view)
        for li, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                flat = leaf.contiguous().reshape(-1)
                itemsize, size = flat.element_size(), flat.numel()
            else:
                flat = np.ascontiguousarray(leaf).reshape(-1)
                itemsize, size = flat.itemsize, flat.size
            per = max(1, chunk_bytes // max(1, itemsize))
            if _nbytes(flat) <= chunk_bytes:
                pieces.append((li, flat))
            else:
                for s in range(0, size, per):
                    pieces.append((li, flat[s:s + per]))
        groups: List[List[tuple]] = []
        cur: List[tuple] = []
        cur_bytes = 0
        for p in pieces:
            if cur and cur_bytes + _nbytes(p[1]) > chunk_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += _nbytes(p[1])
        if cur:
            groups.append(cur)

        parent = AllReduce(f"{self._sync_id}.{self.group_name}::{name}")
        results: List[Any] = [None] * len(groups)
        remaining = [len(groups)]
        done_lock = threading.Lock()
        reassembler = _merge_executor()

        def reassemble():
            per_leaf: Dict[int, List[Any]] = {}
            for group, res in zip(groups, results):
                for (li, _view), arr in zip(group, res):
                    per_leaf.setdefault(li, []).append(
                        arr if isinstance(arr, torch.Tensor)
                        else np.asarray(arr))
            out_leaves = []
            for li, leaf in enumerate(leaves):
                parts = per_leaf[li]
                if len(parts) == 1:
                    flat = parts[0]
                elif isinstance(parts[0], torch.Tensor):
                    flat = torch.cat(parts)
                else:
                    flat = np.concatenate(parts)
                out_leaves.append(flat.reshape(tuple(leaf.shape)))
            return nest.unflatten_as(data, out_leaves)

        def make_cb(gi):
            def cb(fut):
                try:
                    res = fut.result(timeout=0)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError) as e:
                    # A cancelled sub-op cancels the whole chunked reduce:
                    # fail the parent, then PROPAGATE (never swallow
                    # cancellation — the invoker decides what it means).
                    parent._set_exception(e)
                    raise
                except Exception as e:
                    parent._set_exception(e)
                    return
                with done_lock:
                    results[gi] = res
                    remaining[0] -= 1
                    last = remaining[0] == 0
                if last:
                    # The multi-MB concatenate runs on the merge pool; the
                    # parent's completion (which runs user done-callbacks
                    # inline) hops to the completion pool so a blocking
                    # user callback can never occupy a merge thread.
                    # The four submits below are fire-and-forget by
                    # design: _set_exception/_set_result never raise, and
                    # finish() reports every outcome through the parent
                    # future itself.
                    def finish():
                        try:
                            result = reassemble()
                        except (asyncio.CancelledError,
                                concurrent.futures.CancelledError) as e:
                            # Merge-pool cancellation: fail the parent so
                            # waiters wake, and re-raise.
                            _completion_executor().submit(  # moolint: disable=dropped-future
                                parent._set_exception, e
                            )
                            raise
                        except Exception as e:  # defensive: shape mismatch
                            _completion_executor().submit(  # moolint: disable=dropped-future
                                parent._set_exception, e
                            )
                            return
                        _completion_executor().submit(  # moolint: disable=dropped-future
                            parent._set_result, result
                        )
                    reassembler.submit(finish)  # moolint: disable=dropped-future
            return cb

        subs = []
        for gi, group in enumerate(groups):
            payload = [arr for (_li, arr) in group]
            subs.append(self._all_reduce_one(f"{name}#c{gi}", payload, op_fn))
        for gi, f in enumerate(subs):
            f.add_done_callback(make_cb(gi))
        return parent

    def _reduce_in(self, op_key: str, payload, sender: Optional[int] = None):
        """A child's partial arrived (reference: reduce, src/group.h:570-629)."""
        with self._lock:
            op = self._active.get(op_key)
            if op is None:
                # Park arrivals for ops we haven't started — including ones
                # under a sync id we haven't APPLIED yet: epoch pushes race
                # the first reduces of the new epoch, so a "foreign" id may
                # be the future, not the past (epoch ids are opaque). Truly
                # stale parks age out via _expire_ops; parks for epochs we
                # skip entirely are pruned on resync.
                self._parked.setdefault(op_key, []).append(
                    (op_key, payload, time.monotonic(), sender)
                )
                return
        if op.op_fn not in _ELEMENTWISE:
            # Custom ops (e.g. the Accumulator's gradient-bundle merge) can
            # be arbitrarily heavy and must not run on the inline RPC IO
            # thread — and must not share a pool with user done-callbacks
            # that may block on collectives (see _merge_executor). Per-op
            # merge ordering is guaranteed by op.lock in _merge_and_forward,
            # NOT by pool width. Fire-and-forget by design: a failed custom
            # merge surfaces as the op's timeout, exactly like a lost hop.
            _merge_executor().submit(  # moolint: disable=dropped-future
                self._merge_and_forward, op, payload, sender
            )
            return
        self._merge_and_forward(op, payload, sender)

    def _merge_and_forward(self, op: "_Op", payload,
                           sender: Optional[int] = None):
        # The heavy merge runs OUTSIDE the group-wide lock (inline handlers
        # on the RPC IO thread contend on it for every message); op.lock
        # serializes merges of this op only. In-place mutation of op.data
        # off the global lock is safe: merges are the only writers (op.lock
        # serialized) and _maybe_forward only forwards after the last merge.
        with op.lock:
            with self._lock:
                if self._active.get(op.key) is not op:
                    return  # cancelled/expired while queued
                if op.forwarded:
                    # Already sent upward (straggler write-off, or a
                    # duplicate delivery after the normal forward): a
                    # merge now would mutate arrays the transport may
                    # still be serializing, and could never be forwarded
                    # anyway. The contribution is written off at this
                    # node; quorum callers re-contribute it next round.
                    return
                if sender is None:
                    # Pre-contract peer (no sender index on the wire):
                    # arrival-order merge, the old behavior.
                    payloads = [payload]
                else:
                    if sender in op.seen or sender not in op.children:
                        # Duplicate delivery (retry/race) or not our
                        # child: merging would double-count it.
                        return
                    op.seen.add(sender)
                    op.pending[sender] = payload
                    # Fixed reduction order: fold only the contiguous
                    # prefix of children (ascending index) that has
                    # arrived; anything after a gap stays buffered.
                    payloads = []
                    while (op.next_child < len(op.children)
                           and op.children[op.next_child] in op.pending):
                        payloads.append(
                            op.pending.pop(op.children[op.next_child])
                        )
                        op.next_child += 1
                    if not payloads:
                        return  # buffered behind a lower-index sibling
                data, owns = op.data, op.owns
            for p in payloads:
                if not (owns and _apply_inplace(op.op_fn, data, p)):
                    data = _apply(op.op_fn, data, p)
                    owns = op.op_fn in _ELEMENTWISE
            with self._lock:
                if self._active.get(op.key) is not op:
                    return
                op.data = data
                op.owns = owns
                op.received += len(payloads)
        self._maybe_forward(op)

    def _maybe_forward(self, op: _Op):
        with self._lock:
            if op.received < len(op.children):
                return
            if self._active.get(op.key) is not op:
                return  # cancelled meanwhile
            if op.forwarded:
                return  # one-shot: parked drains/races must not double-send
            op.forwarded = True
            data = op.data
            index = op.index
            members = op.members
        if index == 0:
            # Root: result complete; broadcast down (src/group.h:553-568).
            self._share_in(op.key, data)
        else:
            parent = members[(index - 1) // 2]
            self.rpc.async_callback(
                parent, "AllReduceService::reduce",
                _log_err(f"reduce->{parent}"), op.key, data, index,
            )

    def _force_forward(self, op: _Op):
        """Straggler write-off: forward/commit the partial sum without the
        children that missed the deadline. Takes ``op.lock`` before the
        group lock — the same order as a merge — so a concurrent in-place
        merge can never be torn by the snapshot, and the ``forwarded``
        gate it sets makes later arrivals at this node no-ops.

        Partials buffered behind the straggler (arrived, but gapped off
        from the merged prefix) are folded in first — still in ascending
        child-index order, so the partial over the PRESENT subset keeps
        the fixed reduction order the module docstring pins."""
        with op.lock:
            with self._lock:
                if self._active.get(op.key) is not op or op.forwarded:
                    return
                op.forwarded = True
                late = [op.pending.pop(c) for c in
                        op.children[op.next_child:] if c in op.pending]
                data, owns = op.data, op.owns
                index = op.index
                members = op.members
                missing = len(op.children) - op.received - len(late)
            for p in late:
                if not (owns and _apply_inplace(op.op_fn, data, p)):
                    data = _apply(op.op_fn, data, p)
                    owns = op.op_fn in _ELEMENTWISE
            if late:
                with self._lock:
                    if self._active.get(op.key) is not op:
                        return
                    op.data = data
                    op.owns = owns
                    op.received += len(late)
        log.warning(
            "allreduce %s: straggler deadline passed — %s without %d "
            "child contribution(s)",
            op.key, "committing" if index == 0 else "forwarding partial",
            missing,
        )
        if index == 0:
            self._m_partial_commits.inc()
            self._share_in(op.key, data)
        else:
            self._m_partial_forwards.inc()
            parent = members[(index - 1) // 2]
            self.rpc.async_callback(
                parent, "AllReduceService::reduce",
                _log_err(f"reduce->{parent}"), op.key, data, index,
            )

    def _share_in(self, op_key: str, result):
        """Result broadcast from the parent (reference: share,
        src/group.h:631-654)."""
        with self._lock:
            op = self._active.pop(op_key, None)
            if op is None:
                if op_key in self._expired_keys:
                    # Our op for this key already FAILED at the local
                    # timeout: this share is the dead round's result.
                    # Parking it would hand a same-key retry a stale
                    # answer; the caller already got its error.
                    return
                # A result for an op we haven't started (possible once
                # quorum commits exist: the cohort committed without us).
                # Park it — the op completes from here the moment our
                # caller starts it, instead of stranding this member on a
                # sequence the cohort has already advanced past.
                self._parked_shares[op_key] = (result, time.monotonic())
                return
        # Round duration: local start to result arrival (roots measure
        # the full tree reduce; leaves measure their stake in it).
        self._m_round_dur.observe(time.monotonic() - op.started)
        for c in op.children:
            child = op.members[c]
            self.rpc.async_callback(
                child, "AllReduceService::share",
                _log_err(f"share->{child}"), op_key, result,
            )
        # Service handlers run inline on the RPC IO thread; user
        # done-callbacks (e.g. Accumulator gradient commits) must not — a
        # blocked callback would stall every connection on this Rpc.
        # Fire-and-forget by design: _set_result never raises.
        _completion_executor().submit(  # moolint: disable=dropped-future
            op.future._set_result, result
        )

    def close(self):
        if self._closed:  # the close() idempotence contract
            return
        self._closed = True
        reg = self.rpc.telemetry.registry
        for name in self._gauge_names:
            reg.unregister(name, group=self.group_name)
        shared = getattr(self.rpc, "_moolib_group_shared", None)
        if shared is not None:
            shared.groups.pop(self.group_name, None)


# -- helpers ----------------------------------------------------------------


_completion_pool = None
_merge_pool = None
_completion_pool_lock = threading.Lock()


def _completion_executor():
    """Executor for USER-FACING allreduce future completions.

    Deliberately NOT the Rpc function executor (user handlers may block on
    allreduce futures from those threads) and deliberately more than one
    thread: a done-callback that synchronously waits on ONE other collective
    still makes progress. Contract (same as the reference's scheduler
    callbacks): done-callbacks must not block indefinitely — a callback
    chain deeper than the pool width can still starve itself. Internal
    reduce progress (custom-op merges, chunk reassembly) runs on the
    SEPARATE _merge_executor so blocking user callbacks can never starve
    the collectives they are waiting on."""
    global _completion_pool
    with _completion_pool_lock:
        if _completion_pool is None:
            import concurrent.futures

            _completion_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="allreduce-complete"
            )
        return _completion_pool


def _merge_executor():
    """Executor for INTERNAL reduce progress: custom-op merges and chunk
    reassembly. Separate from the user-callback pool because a user
    done-callback is allowed to block on another collective — if merges
    queued behind such callbacks in one shared pool, four blocking
    callbacks would deadlock the group layer (the merges their collectives
    need could never run). Per-op merge ordering comes from op.lock, not
    pool width, so two threads are about parallel reassembly, not
    correctness."""
    global _merge_pool
    with _completion_pool_lock:
        if _merge_pool is None:
            import concurrent.futures

            _merge_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="allreduce-merge"
            )
        return _merge_pool


def _resolve_op(op) -> Callable:
    if callable(op):
        return op
    fn = REDUCE_OPS.get(op)
    if fn is None:
        raise RpcError(f"unknown reduce op {op!r}; one of {sorted(REDUCE_OPS)}")
    return fn


def _apply(op_fn, a, b):
    """Builtin ops apply leaf-wise over trees; custom ops get whole payloads
    (reference: ReduceVariant dispatch vs python op, src/group.h:230-262)."""
    if op_fn in (_sum, _prod, _min, _max):
        return nest.map_structure(op_fn, a, b)
    return op_fn(a, b)


_INPLACE_UFUNC = {_sum: (np.add, torch.add),
                  _prod: (np.multiply, torch.mul),
                  _min: (np.minimum, torch.minimum),
                  _max: (np.maximum, torch.maximum)}


def _inplace_pair(x, y) -> bool:
    if isinstance(x, np.ndarray):
        return (x.ndim > 0 and x.flags.writeable
                and isinstance(y, np.ndarray) and x.shape == y.shape
                and x.dtype == y.dtype)
    # A torch leaf of op-owned data is a result this node allocated.
    return (isinstance(x, torch.Tensor) and x.ndim > 0
            and isinstance(y, torch.Tensor) and x.shape == y.shape
            and x.dtype == y.dtype)


def _apply_inplace(op_fn, a, b) -> bool:
    """Leaf-wise ``ufunc(a, b, out=a)`` merge, skipping an allocation (and
    its page-fault pass) per interior-node merge. Only attempted when every
    ``a`` leaf is an op-owned writable array matching its ``b`` leaf in
    type, shape and dtype; returns False untouched otherwise so the caller
    falls back to the allocating path."""
    fns = _INPLACE_UFUNC.get(op_fn)
    if fns is None:
        return False
    la, lb = nest.flatten(a), nest.flatten(b)
    if len(la) != len(lb):
        return False
    if not all(_inplace_pair(x, y) for x, y in zip(la, lb)):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            fns[1](x, y, out=x)
        else:
            fns[0](x, y, out=x)
    return True


def _subtree_height(index: int, n: int) -> int:
    """Height of the binary-tree subtree rooted at ``index`` in an
    ``n``-member tree (0 for a leaf). Deterministic in (index, n), so
    every member stages the same straggler deadlines."""
    h = 0
    level = [index]
    while True:
        nxt = [c for p in level for c in (2 * p + 1, 2 * p + 2) if c < n]
        if not nxt:
            return h
        h += 1
        level = nxt


def _group_of(op_key: str) -> str:
    # "{sync_id}.{group}::{name}"
    rest = op_key.split(".", 1)[1]
    return rest.split("::", 1)[0]


def _is_current(op_key: str, sync_id: Optional[str]) -> bool:
    return sync_id is not None and op_key.startswith(sync_id + ".")


def _log_err(what: str):
    def cb(result, error):
        if error is not None:
            log.debug("%s failed: %s", what, error)

    return cb
