"""Named-peer RPC over asyncio TCP/unix transports; the counterpart of
:mod:`moolib_tpu.rpc.rpc`, wire-compatible with it (the same frames,
function ids, greeting and shm rendezvous), so port and reference peers
call each other.

Capability parity with the reference's RPC core (reference: src/rpc.{h,cc} —
named peers, define/undefine, async/sync calls with typed payloads, deferred
returns, reliability with resend-on-reconnect and duplicate suppression,
request timeouts, gossip peer discovery, transport selection, debug_info;
Python surface src/moolib.cc:1949-2164).

Architecture notes (host control plane):
- Each ``Rpc`` owns one asyncio event loop on a dedicated IO thread. All
  public methods are thread-safe and marshal onto that loop (the reference
  instead runs callbacks on a global C++ thread pool, src/async.{h,cc}).
- User-defined functions execute on a shared ThreadPoolExecutor so they may
  block, hold the GIL, or launch CUDA work without stalling the IO loop
  (reference: scheduler thread hop before FImpl::call, src/rpc.cc:2832-2874).
- TCP gives per-connection ordering/reliability; cross-connection reliability
  (peer restarts, transport switches) uses the reference's scheme in
  simplified form: outgoing requests are buffered until a response arrives,
  resent on reconnect, expired by a timeout thread; receivers suppress
  duplicate rids and replay cached responses (reference: Incoming/Outgoing
  buckets src/rpc.cc:1106-1184, recent-rid memory :568-597).
- Transports: ``tcp``, ``unix`` (abstract namespace), and ``shm`` — a
  same-host shared-memory ring lane (:mod:`.shmring`) rendezvoused over
  the greeting: peers advertise a host boot identity, and when it
  matches (and both sides have shm enabled — ``MOOLIB_TPU_SHM=0``
  disables), the peer with the smaller id creates the segment and
  offers it over the socket lane (``FID_SHM_OFFER``/``FID_SHM_ACCEPT``).
  Per-send transport choice prefers the lowest EWMA-latency live
  connection — the reference's softmax bandit (src/rpc.cc:640-716)
  degenerates to this with few transports; the interface
  (``set_transports``, per-transport latency in ``debug_info``) is
  preserved, and a dead shm lane simply loses its connection entry, so
  traffic degrades to TCP instead of erroring.
- Peer discovery: on greeting, peers exchange names + listen addresses; a
  call to an unknown peer name asks every connected peer
  ``lookingForPeer`` and connects to any address that comes back
  (reference: findPeersImpl gossip, src/rpc.cc:2332-2446).
"""

from __future__ import annotations

import asyncio
import atexit
import concurrent.futures
import hashlib
import heapq
import itertools
import math
import os
import pickle
import random as _pyrandom
import secrets
import socket as pysocket
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import Telemetry, global_telemetry, spans_to_chrome
from ..utils import Ewma, get_logger
from . import serial, shmring

log = get_logger("rpc")

# Wire sentinel for trace-id propagation: when the caller's telemetry has
# tracing enabled, the user payload (args, kwargs) is wrapped as
# (_TRACE_TAG, trace_id, payload) and unconditionally unwrapped in
# _on_request — so caller and handler spans of one call share the id.
# Cannot collide with user payloads: those are always 2-tuples.
_TRACE_TAG = "__mtr__"

# Wire sentinel for deadline propagation (the serving tier's router→replica
# budget): a call made via ``Rpc.call_with_deadline`` wraps the payload as
# (_DEADLINE_TAG, remaining_budget_seconds, payload). The budget is a
# *relative* remaining allowance (never an absolute wall time — peer clocks
# are not comparable); the receiver re-anchors it against its own monotonic
# clock and exposes it to handlers (``respond.deadline`` /
# ``RpcDeferredReturn.deadline`` / queue-entry expiry) so servers can shed
# work whose budget cannot cover service. Nested INSIDE the trace wrap when
# both apply. Cannot collide with user payloads: those are always 2-tuples.
_DEADLINE_TAG = "__mdl__"

__all__ = ["Rpc", "RpcError", "Future", "Queue", "RpcDeferredReturn"]

# Control function ids (reference: ReqType words, src/rpc.h:94-108).
FID_GREETING = 1
FID_SUCCESS = 2
FID_ERROR = 3
FID_FNF = 4
FID_KEEPALIVE = 5
FID_LOOKING_FOR_PEER = 6
FID_PEER_FOUND = 7
FID_ACK = 8
FID_NACK = 9
FID_POKE = 10
FID_SHM_OFFER = 11   # same-host rendezvous: creator -> attacher
FID_SHM_ACCEPT = 12  # attacher's verdict (ok / refusal + why)
FID_USER_BASE = 1000  # reference: reqCallOffset(1000)

_DEFAULT_TIMEOUT = 30.0
# Write-buffer high-water mark: multi-MB gradient bundles should stream out
# without pausing the writer on every transport buffer fill.
_WRITE_HIGH_WATER = 8 * 1024 * 1024
# Response-cache byte ceiling: exactly-once replies are cached for
# poke-driven resends, but large replies (a __telemetry scrape with spans
# can run to MBs) must not pin unbounded RSS under a long-lived poller.
_RESPONSE_CACHE_MAX_BYTES = 64 * 1024 * 1024


def fid_for(name: str) -> int:
    """Function name -> stable 32-bit id (reference hashes with MurmurHash3,
    src/rpc.cc:1766-1768; any stable hash serves the same contract)."""
    h = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
    return FID_USER_BASE + h % (2**32 - FID_USER_BASE)


class RpcError(RuntimeError):
    pass


def _check_wait_timeout(timeout, what: str):
    """Validate a *wait* timeout (``Future.result``/``exception``).

    The two documented sentinels are ``None`` (wait forever) and ``0``
    (non-blocking poll: return/raise immediately — the accumulator and
    group drain loops rely on it). Anything negative or non-finite is a
    programming error, not a policy: silently treating ``-5`` or ``nan``
    as "no wait" hides the bug at the call site. Returns the validated
    value."""
    if timeout is None:
        return None
    t = float(timeout)
    if t < 0 or not math.isfinite(t):
        raise ValueError(
            f"{what}: timeout must be None (wait forever), 0 (poll), or a "
            f"positive finite number of seconds, got {timeout!r}"
        )
    return t


def _check_budget(seconds, what: str) -> float:
    """Validate a *deadline* duration (``set_timeout``, per-call budgets).

    These values feed the deadline wheel: ``0`` would expire every call
    before its first send, ``inf``/``nan`` crash the wheel's slot
    arithmetic (``int(inf / tick)`` raises) — both are undefined-behavior
    territory, so they are rejected eagerly with a clear error."""
    s = float(seconds)
    if s <= 0 or not math.isfinite(s):
        raise ValueError(
            f"{what}: must be a positive finite number of seconds, "
            f"got {seconds!r}"
        )
    return s


class Future:
    """RPC future bridging threads and asyncio.

    Mirrors the reference Future (reference: src/moolib.cc:201-393 —
    result/result(timeout)/wait/done/cancel/exception plus ``__await__``
    via the caller's running loop).
    """

    def __init__(self):
        self._cf: concurrent.futures.Future = concurrent.futures.Future()

    # -- completion (internal) ----------------------------------------------

    def _set_result(self, value):
        if not self._cf.done():
            self._cf.set_result(value)

    def _set_exception(self, exc: BaseException):
        if not self._cf.done():
            self._cf.set_exception(exc)

    # -- public surface ------------------------------------------------------

    def result(self, timeout: Optional[float] = None):
        timeout = _check_wait_timeout(timeout, "Future.result")
        try:
            return self._cf.result(timeout)
        except concurrent.futures.TimeoutError:
            raise TimeoutError("Future.result timed out") from None

    def wait(self, timeout: Optional[float] = None) -> bool:
        try:
            self._cf.exception(timeout)
            return True
        except concurrent.futures.TimeoutError:
            return False
        except concurrent.futures.CancelledError:
            return True

    def done(self) -> bool:
        return self._cf.done()

    def cancel(self) -> bool:
        return self._cf.cancel()

    def exception(self, timeout: Optional[float] = None):
        timeout = _check_wait_timeout(timeout, "Future.exception")
        try:
            return self._cf.exception(timeout)
        except concurrent.futures.TimeoutError:
            raise TimeoutError("Future.exception timed out") from None

    def add_done_callback(self, fn: Callable[["Future"], None]):
        self._cf.add_done_callback(lambda _cf: fn(self))

    def __await__(self):
        return asyncio.wrap_future(self._cf).__await__()

    __iter__ = __await__


class RpcDeferredReturn:
    """Handle for replying to a call outside the handler (reference:
    src/rpc.h RpcDeferredReturn<T>, surfaced by define_deferred).

    When the caller propagated a deadline (``Rpc.call_with_deadline``),
    ``deadline`` holds the receiver-side ``time.monotonic()`` instant the
    caller's budget expires at and ``budget`` the propagated allowance in
    seconds; both are ``None`` for plain calls."""

    def __init__(self, respond: Callable[[Any, Optional[str]], None]):
        self._respond = respond
        self._done = False
        self.deadline: Optional[float] = getattr(respond, "deadline", None)
        self.budget: Optional[float] = getattr(respond, "budget", None)

    def __call__(self, value=None):
        if self._done:
            raise RpcError("deferred return already used")
        self._done = True
        self._respond(value, None)

    def error(self, message: str):
        if self._done:
            raise RpcError("deferred return already used")
        self._done = True
        self._respond(None, message)


class Queue:
    """Awaitable call queue (reference: src/moolib.cc:433-576,1936-1948).

    Two ways to fill it, mirroring the reference: ``define_queue`` pushes
    RPC calls (yields ``(return_cb, args, kwargs)``, optionally coalescing
    up to batch_size waiting calls per get), or construct one standalone
    (``moolib_tpu_torch.Queue()``) and ``enqueue`` items locally — awaiting then
    yields each item as enqueued."""

    _RAW = object()  # marks locally-enqueued entries (yielded verbatim)

    def __init__(self, rpc: Optional["Rpc"] = None, name: str = "",
                 batch_size: Optional[int] = None,
                 dynamic_batching: bool = False,
                 timeout: Optional[Callable[[], float]] = None):
        self._rpc = rpc
        self.name = name
        self.batch_size = batch_size
        self.dynamic_batching = dynamic_batching
        # Standalone queues have no RPC deadline to honor: entries keep
        # forever (a finite default would silently drop old items).
        self._timeout = timeout or (lambda: float("inf"))
        self._cond = threading.Condition()
        self._entries: deque = deque()  # (expiry, return_cb, args, kwargs)
        self._closed = False
        self._async_waiters: List[Tuple[Any, Any]] = []  # (loop, event)

    def _push(self, return_cb, args, kwargs, deadline=None):
        # Locally-enqueued items have no caller deadline to honor — they
        # keep forever even on an RPC-bound queue (whose _timeout is the
        # RPC timeout; stamping _RAW entries with it would silently drop
        # idle-queue items, unlike the standalone-queue contract).
        expiry = (
            float("inf") if return_cb is self._RAW
            else time.monotonic() + self._timeout()
        )
        if deadline is not None:
            # Caller-propagated budget (call_with_deadline): the entry is
            # worthless past it — expire at the earlier of the two.
            expiry = min(expiry, deadline)
        with self._cond:
            self._entries.append((expiry, return_cb, args, kwargs))
            self._cond.notify_all()
            waiters, self._async_waiters = self._async_waiters, []
        for loop, event in waiters:
            loop.call_soon_threadsafe(event.set)

    def enqueue(self, item: Any):
        """Add a local item; a get/await yields it verbatim (reference:
        QueueWrapper::enqueue, src/moolib.cc:1941). Only for non-batched
        queues — coalescing is defined over RPC call triples. Items never
        expire (RPC entries on the same queue still honor the caller's
        deadline)."""
        if self.batch_size is not None:
            raise RpcError(
                "enqueue() is only supported on non-batched queues"
            )
        self._push(self._RAW, item, None)

    def _pop_locked(self):
        """Expire stale entries, then pop up to batch_size live ones.

        An expired RPC entry gets an explicit error reply instead of a
        silent drop: for a deadline-stamped entry the caller is still
        waiting (its budget just ran out of queue headroom) and a fast
        ``DeadlineExceeded`` beats discovering the loss at the RPC
        deadline; for a default-expiry entry the caller's future already
        timed out, so the late reply is dropped client-side — harmless
        either way, and the server's answered-ness bookkeeping stays
        truthful (no rid parked forever in "still executing")."""
        now = time.monotonic()
        # Deadline-stamped entries (call_with_deadline) make expiries
        # NON-monotone in arrival order — a short-budget entry can sit
        # behind a long-lived head — so the sweep must walk the whole
        # queue, not just the head. Entry counts are bounded by the
        # server's admission/backpressure, so the scan is cheap.
        if self._entries and any(e[0] < now for e in self._entries):
            live: deque = deque()
            for entry in self._entries:
                if entry[0] >= now:
                    live.append(entry)
                    continue
                _expiry, cb, _args, _kwargs = entry
                if cb is self._RAW or not hasattr(cb, "error"):
                    continue
                try:
                    cb.error(
                        "DeadlineExceeded: request expired in the server "
                        f"queue {self.name!r} before service"
                    )
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except Exception:
                    pass  # reply plumbing gone (conn down): nothing owed
            self._entries = live
        if not self._entries:
            return None
        if self.batch_size is None:
            n = 1
        else:
            n = min(len(self._entries), self.batch_size)
        if not self.dynamic_batching and self.batch_size is not None:
            if len(self._entries) < self.batch_size:
                return None  # fixed batching waits for a full batch
            n = self.batch_size
        out = [self._entries.popleft() for _ in range(n)]
        return out

    def _format(self, popped):
        from ..utils import nest

        if self.batch_size is None:
            _, cb, args, kwargs = popped[0]
            if cb is self._RAW:
                return args  # locally enqueued item, yielded verbatim
            return cb, args, kwargs
        cbs = [p[1] for p in popped]
        argss = [p[2] for p in popped]
        kwargss = [p[3] for p in popped]
        batched_args = (
            nest.stack_fields(argss) if argss and argss[0] else tuple()
        )
        batched_kwargs = (
            nest.stack_fields(kwargss) if kwargss and kwargss[0] else {}
        )

        def return_cb(result):
            results = nest.unstack_fields(result, len(cbs))
            for cb, r in zip(cbs, results):
                cb(r)

        def _error(msg):
            for cb in cbs:
                cb.error(msg)

        return_cb.error = _error
        return_cb.batch_size = len(cbs)
        return return_cb, batched_args, batched_kwargs

    def get(self, timeout: Optional[float] = None):
        """Blocking get -> (return_cb, args, kwargs)."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                popped = self._pop_locked()
                if popped:
                    return self._format(popped)
                if self._closed:
                    raise RpcError(f"queue {self.name!r} closed")
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("Queue.get timed out")
                # No periodic poll needed: only _push (notifies) or _close
                # (notifies) can change _pop_locked's outcome — expired
                # entries alone never make a new batch poppable.
                self._cond.wait(timeout=remaining)

    async def get_async(self):
        loop = asyncio.get_running_loop()
        while True:
            event = asyncio.Event()
            with self._cond:
                popped = self._pop_locked()
                if popped:
                    return self._format(popped)
                if self._closed:
                    raise RpcError(f"queue {self.name!r} closed")
                self._async_waiters.append((loop, event))
            # Woken by _push or _close (both signal registered waiters);
            # nothing else can change _pop_locked's outcome, so no timeout.
            await event.wait()

    def __aiter__(self):
        return self

    async def __anext__(self):
        return await self.get_async()

    def __await__(self):
        """``await queue`` -> next entry (reference: QueueWrapper::await,
        src/moolib.cc:1947)."""
        return self.get_async().__await__()

    def _close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            waiters, self._async_waiters = self._async_waiters, []
        for loop, event in waiters:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass


class _Conn:
    """One live connection (reference: RpcConnectionImpl over a transport)."""

    __slots__ = (
        "transport", "sock", "proto", "peer_name", "peer_id", "outbound",
        "latency", "last_recv", "last_send", "created", "explicit_addr",
        "m_out", "m_in", "m_lat", "dropped",
    )

    def __init__(self, transport: str, sock, proto: "_FrameProtocol",
                 outbound: bool):
        self.transport = transport
        self.sock = sock          # asyncio Transport
        self.proto = proto
        self.outbound = outbound  # we dialed it (vs accepted)
        self.peer_name: Optional[str] = None
        self.peer_id: Optional[str] = None
        self.latency = Ewma(alpha=0.25)
        self.last_recv = time.monotonic()
        self.last_send = time.monotonic()
        self.created = time.monotonic()
        self.explicit_addr: Optional[str] = None
        self.dropped = False      # _drop_conn ran (idempotence latch)
        # Per-transport wire counters + lane latency histogram
        # (rpc_bytes_{out,in}_total{transport=}, rpc_lane_latency_seconds
        # {transport=}), bound by the owning Rpc right after construction
        # so the hot path pays one attribute access, not a registry probe.
        self.m_out = self.m_in = self.m_lat = None

    def is_closing(self) -> bool:
        return self.sock is None or self.sock.is_closing()

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            # Sync transport teardown: no await point can deliver a task
            # cancellation here, and close() failures are moot.
            except Exception:  # moolint: disable=swallow-cancelled
                pass


class _FrameProtocol(asyncio.BufferedProtocol):
    """Zero-copy frame receiver.

    asyncio's StreamReader tops out well below loopback line rate on
    multi-MB bodies (extra buffer copies + 256KB recv chunks); this
    BufferedProtocol hands the kernel a view directly into the frame being
    assembled (``recv_into`` semantics), reaching raw-socket throughput —
    the asyncio-native equivalent of the reference's iovec socket reads
    (reference: src/transports/socket.cc scatter/gather path).
    """

    def __init__(self, rpc: "Rpc", transport_name: str,
                 outbound: bool = False):
        self._rpc = rpc
        self._transport_name = transport_name
        self._outbound = outbound
        self.conn: Optional[_Conn] = None
        self._head = bytearray(serial.HEADER.size)
        self._head_got = 0
        self._body: Optional[bytearray] = None
        self._body_got = 0
        self._can_write = asyncio.Event()
        self._can_write.set()

    # -- connection lifecycle -------------------------------------------------

    def connection_made(self, transport):
        transport.set_write_buffer_limits(high=_WRITE_HIGH_WATER)
        # Default kernel socket buffers (~208KB) fragment multi-MB frames
        # into dozens of partial sendmsg calls + readiness wakeups per
        # message; 4MB buffers let a whole chunk move per syscall pair.
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(
                    pysocket.SOL_SOCKET, pysocket.SO_SNDBUF, 1 << 22
                )
                sock.setsockopt(
                    pysocket.SOL_SOCKET, pysocket.SO_RCVBUF, 1 << 22
                )
            except OSError as e:
                # Never silent: an unexpectedly small socket buffer turns
                # multi-MB frames into dozens of partial writes per
                # message — exactly the kind of perf mystery the
                # telemetry layer exists to surface. Record it.
                log.debug(
                    "%s: failed to size %s socket buffers: %s",
                    self._rpc._name, self._transport_name, e,
                )
                # Unconditional (like the wheel-entry counter): a config
                # problem must be countable even with telemetry off.
                self._rpc._m_sockopt_fail.inc()
        self.conn = _Conn(
            self._transport_name, transport, self, self._outbound
        )
        self._rpc._bind_lane_metrics(self.conn)
        self._rpc._register_conn(self.conn)

    def connection_lost(self, exc):
        self._can_write.set()
        if self.conn is not None:
            self._rpc._drop_conn(self.conn, f"connection lost: {exc}")

    def eof_received(self):
        return False  # close on EOF

    # -- write flow control ---------------------------------------------------

    def pause_writing(self):
        self._can_write.clear()

    def resume_writing(self):
        self._can_write.set()

    # -- zero-copy read path --------------------------------------------------

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._body is None:
            return memoryview(self._head)[self._head_got:]
        return memoryview(self._body)[self._body_got:]

    def buffer_updated(self, nbytes: int):
        conn = self.conn
        if conn is None:
            return
        conn.last_recv = time.monotonic()
        while nbytes:
            if self._body is None:
                self._head_got += nbytes
                nbytes = 0
                if self._head_got == len(self._head):
                    magic, body_len = serial.HEADER.unpack(self._head)
                    self._head_got = 0
                    if magic != serial.MAGIC:
                        self._rpc._drop_conn(
                            conn, "bad magic (corrupt stream)"
                        )
                        return
                    # alloc_aligned (np.empty under the hood, never
                    # bytearray: bytearray(n) zero-fills, a full extra
                    # write pass over every multi-MB body), 64-byte
                    # aligned so the frame layout's body-offset padding
                    # makes every tensor decode an aligned view — the
                    # zero-copy receive path, no copy fallback.
                    self._body = serial.alloc_aligned(body_len)
                    self._body_got = 0
            else:
                self._body_got += nbytes
                nbytes = 0
                if self._body_got == len(self._body):
                    body, self._body = self._body, None
                    rpc = self._rpc
                    if rpc.telemetry.on:
                        rpc._m_bytes_in.inc(serial.HEADER.size + len(body))
                        conn.m_in.inc(serial.HEADER.size + len(body))
                    try:
                        rid, fid, obj = serial.deserialize_body(
                            memoryview(body)
                        )
                        self._rpc._dispatch(conn, rid, fid, obj)
                    # Sync protocol callback (no awaits): a decode/dispatch
                    # error must drop the conn, never escape into the loop.
                    except Exception as e:  # moolint: disable=swallow-cancelled
                        log.error(
                            "frame dispatch error on %s: %s",
                            conn.peer_name, e,
                        )
                        self._rpc._drop_conn(conn, f"protocol error: {e}")
                        return


class _Peer:
    __slots__ = ("name", "peer_id", "addresses", "conns", "finding", "found_event")

    def __init__(self, name: str):
        self.name = name
        self.peer_id: Optional[str] = None
        self.addresses: List[str] = []
        self.conns: Dict[str, _Conn] = {}
        self.finding = False
        self.found_event: Optional[asyncio.Event] = None


class _Outgoing:
    __slots__ = ("rid", "peer_name", "fname", "frames", "future", "deadline",
                 "sent_at", "conn", "poked_at", "acked", "next_slot",
                 "t0", "wall0", "trace_id", "reroute")

    def __init__(self, rid, peer_name, fname, frames, future, deadline):
        self.rid = rid
        self.peer_name = peer_name
        self.fname = fname
        self.frames = frames
        self.future = future
        self.deadline = deadline
        self.sent_at = time.monotonic()
        self.conn: Optional[_Conn] = None
        self.poked_at = 0.0
        self.acked = False
        # Deadline-wheel slot this call is scheduled in (see
        # _sched_out): stale heap entries are skipped when they disagree.
        self.next_slot = -1
        # Telemetry: submission instants (monotonic for the latency
        # histogram — covers resends, unlike sent_at — and wall-clock for
        # span placement) plus the propagated trace id, None untraced.
        self.t0 = self.sent_at
        self.wall0 = 0.0
        self.trace_id: Optional[str] = None
        # False = fail fast on connection loss / unroutable peer instead
        # of silently re-routing until the deadline: a serving router
        # wants the error NOW so it can retry on a *different* replica
        # (transport-level patience would eat the caller's whole budget).
        self.reroute = True


def _boot_id() -> str:
    """Host boot identity for reachability gating: unix-socket addresses are
    only dialable by peers sharing this id (reference tags ipc addresses the
    same way, src/transports/ipc.cc:280-315)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return pysocket.gethostname()


_BOOT_ID = _boot_id()


_live_rpcs: "weakref.WeakSet[Rpc]" = weakref.WeakSet()


@atexit.register
def _cleanup_live_rpcs():
    # Reference closes leaked Rpcs at module teardown (src/moolib.cc:1519-1532).
    for rpc in list(_live_rpcs):
        try:
            rpc.close()
        # atexit teardown: nothing to cancel, nothing to report to.
        except Exception:  # moolint: disable=swallow-cancelled
            pass


class Rpc:
    def __init__(self, name: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None):
        self._name = name or f"rpc-{secrets.token_hex(8)}"
        self._peer_id = secrets.token_hex(16)
        self._timeout = _DEFAULT_TIMEOUT
        # Liveness probing: keepalive after this much send-silence; a
        # connection silent (nothing received) for 4 intervals is torn down
        # and its in-flight requests re-routed (reference: 4 failed probes
        # close the connection, src/rpc.cc:1625-1665).
        self._keepalive_interval = 2.0
        # Request-level reliability: poke the server about an unanswered
        # request after max(4x EWMA latency, this floor); a NACK (server
        # never saw it) triggers an immediate resend over the current best
        # transport (reference: processTimeout, src/rpc.cc:1414-1498).
        self._poke_min = 0.5
        self._transports = {"tcp", "unix", "shm"}
        # Same-host shm lane policy gate: MOOLIB_TPU_SHM=0 turns the lane
        # off for THIS peer only — it neither offers nor accepts, and
        # interops cleanly with enabled peers (they just stay on TCP).
        # Read per-Rpc (not at import) so tests can flip it per peer.
        self._shm_enabled = (
            os.environ.get("MOOLIB_TPU_SHM", "1").lower()
            not in ("0", "false", "off", "no")
            and shmring.shm_supported()
        )
        # Host identity for shm reachability gating (instance attribute so
        # a test can spoof one peer's identity): matching boot ids is what
        # authorizes an shm offer — a segment path means nothing across
        # hosts.
        self._boot_id = _BOOT_ID
        # peer_id -> {"lane": ShmLane, "peer": name, "state":
        # "offered"|"up"}. Lanes are per peer PAIR; the entry exists from
        # offer (creator) / attach (attacher) until the shm conn drops or
        # close().
        self._shm_pairs: Dict[str, dict] = {}
        # transport -> (bytes-out counter, bytes-in counter, lane latency
        # histogram) — the per-transport telemetry family, cached so the
        # wire hot path pays one dict probe per connection setup, zero
        # per message.
        self._lane_m: Dict[str, tuple] = {}
        self._functions: Dict[int, Tuple[str, Callable]] = {}
        self._queues: Dict[str, Queue] = {}
        self._peers: Dict[str, _Peer] = {}
        self._listen_addrs: List[str] = []
        self._servers: List[Any] = []
        self._outgoing: Dict[int, _Outgoing] = {}
        # Deadline wheel: in-flight calls scheduled by next-attention time
        # in a min-heap of (slot, seq, out). The 100ms timeout tick pops
        # only DUE entries instead of scanning every in-flight call — the
        # reference shards request tracking into buckets for the same
        # reason (reference: Incoming/Outgoing buckets, src/rpc.cc:
        # 1106-1184). Rescheduling pushes a fresh entry and bumps
        # out.next_slot; stale entries are lazily skipped on pop.
        self._out_heap: list = []
        self._sched_seq = itertools.count()
        self._rid_counter = itertools.count(1)
        self._recent_rids: "OrderedDict[Tuple[str, int], bool]" = OrderedDict()
        self._response_cache: "OrderedDict[Tuple[str, int], List[Any]]" = OrderedDict()
        self._response_cache_bytes = 0
        # Guards cache + byte-count updates: respond() runs on executor
        # worker threads and deferred-reply threads concurrently, and an
        # unsynchronized read-modify-write on the byte counter drifts.
        self._response_cache_lock = threading.Lock()
        self._anon_conns: List[_Conn] = []
        self._explicit: Dict[str, dict] = {}  # addr -> {conn, last_try}
        self._closed = False
        self._batchers: Dict[str, Any] = {}
        # Fault-injection hooks (the rpc/faults.py contract) — None
        # in production, so every seam is a single attribute check.
        self._faults = None
        # Explicit-reconnect backoff: capped exponential with FULL jitter
        # (delay ~ U[0, backoff]) so a healed partition never produces a
        # synchronized redial stampede across the cohort. Seedable for
        # deterministic tests via set_reconnect_backoff.
        self._dial_backoff_base = 0.5
        self._dial_backoff_cap = 5.0
        self._dial_rng = _pyrandom.Random()

        # Telemetry: this peer's registry + trace buffer. The unified
        # source of truth for the wire-level counters debug_info() used to
        # track ad-hoc; hot seams guard on `telemetry.on` so disabled-mode
        # cost is one attribute check per message.
        self.telemetry = (
            telemetry if telemetry is not None else Telemetry(self._name)
        )
        # Black-box flight recorder (moolib_tpu_torch/flightrec): typed state
        # transitions (conn lifecycle, resends, timeouts) recorded at the
        # seams below behind the recorder's own one-attribute gate. The
        # skew hook shifts this peer's *reported* flightrec clock — the
        # clock-alignment test surface (set_flightrec_skew), 0 in
        # production.
        self._flight = self.telemetry.flight
        self._flightrec_skew_us = 0
        reg = self.telemetry.registry
        self._m_bytes_out = reg.counter("rpc_bytes_sent_total")
        self._m_bytes_in = reg.counter("rpc_bytes_received_total")
        self._m_resends = reg.counter("rpc_resends_total")
        self._m_pokes = reg.counter("rpc_pokes_total")
        self._m_conn_drops = reg.counter("rpc_conn_drops_total")
        self._m_timeouts = reg.counter("rpc_calls_timed_out_total")
        # Wheel-entry processing count (observability / stress tests):
        # always incremented — it replaces the pre-telemetry ad-hoc field
        # that debug_info() exposed, and the timeout loop only touches DUE
        # entries so the counter stays O(events).
        self._m_timeout_entries = reg.counter(
            "rpc_timeout_wheel_entries_total"
        )
        # Socket-buffer sizing failures (SO_SNDBUF/SO_RCVBUF rejected):
        # always incremented — an unexpectedly small buffer is a perf
        # mystery this counter exists to pre-answer.
        self._m_sockopt_fail = reg.counter("rpc_sockopt_failures_total")
        # Response-cache evictions forced by shm spill-slot pressure
        # (see _reclaim_response_cache).
        self._m_cache_pressure = reg.counter(
            "rpc_response_cache_pressure_reclaims_total"
        )
        # Weakref, same contract as Group/Accumulator/EnvPoolServer: a
        # shared/global Telemetry outlives this Rpc, and a strong `self`
        # would pin the closed peer (conns, executor) in its registry.
        # close() unregisters both series. The peer label keeps two Rpcs
        # sharing one Telemetry from replacing (and, on close,
        # unregistering) each other's gauges.
        wself = weakref.ref(self)
        reg.gauge_fn("rpc_inflight_calls", lambda: len(wself()._outgoing),
                     peer=self._name)
        reg.gauge_fn("rpc_peers", lambda: len(wself()._peers),
                     peer=self._name)
        # Per-endpoint series caches ({name: (calls Counter, latency
        # Histogram)}) — one dict probe on the hot path instead of a
        # registry get-or-create per message.
        self._tel_client: Dict[str, tuple] = {}
        self._tel_server: Dict[str, tuple] = {}

        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=_executor_workers(), thread_name_prefix=f"{self._name}-fn"
        )
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(  # lifelint: intentional -- the asyncio loop's own tasks (bound coroutines) pin self regardless of the Thread target; Rpc lifetime is the explicit close() contract + atexit backstop
            target=self._loop_main, name=f"{self._name}-io", daemon=True
        )
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        _live_rpcs.add(self)
        # Export surface: every Rpc is scrapeable by any peer (JSON or
        # Prometheus text; see docs/observability.md for the scrape
        # how-to and tools/telemetry_dump.py for a cohort-wide dump).
        self.define("__telemetry", self._serve_telemetry)
        # Incident surface: any peer (tools/incident_report.py) can pull
        # this peer's frozen flight bundle, sample its clock for offset
        # estimation, or ask it to write a bundle to disk.
        self.define("__flightrec", self._serve_flightrec)

    # -- loop plumbing -------------------------------------------------------

    def _loop_main(self):
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.create_task(self._timeout_loop())
        self._loop.run_forever()
        # Drain pending tasks on shutdown.
        for task in asyncio.all_tasks(self._loop):
            task.cancel()
        try:
            self._loop.run_until_complete(asyncio.sleep(0))
        # Shutdown drain on a stopping loop: cancellations of the drained
        # tasks are the POINT here, not a signal to propagate.
        except Exception:  # moolint: disable=swallow-cancelled
            pass
        self._loop.close()

    def _call_soon(self, coro) -> concurrent.futures.Future:
        if self._closed:
            raise RpcError("Rpc is closed")
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    # -- naming --------------------------------------------------------------

    def set_name(self, name: str):
        if self._peers or self._listen_addrs:
            raise RpcError("set_name must be called before listen/connect")
        self._name = name

    def get_name(self) -> str:
        return self._name

    def set_timeout(self, seconds: float):
        self._timeout = _check_budget(seconds, "Rpc.set_timeout")

    def set_keepalive_interval(self, seconds: float):
        """Silence probe cadence; a connection that stays silent for 4
        intervals is closed and its in-flight calls re-routed."""
        self._keepalive_interval = float(seconds)

    def set_reconnect_backoff(self, base: float = 0.5, cap: float = 5.0,
                              seed: Optional[int] = None):
        """Tune (and optionally seed) the explicit-reconnect backoff.

        After each failed dial of a ``connect()``-registered address the
        backoff doubles from ``base`` up to ``cap``; the actual wait is
        drawn uniformly from [0, backoff] (full jitter), so a cohort of
        peers redialing one healed endpoint spreads its attempts instead
        of stampeding in lockstep. A successful dial resets to ``base``.
        ``seed`` makes the jitter sequence deterministic for tests."""
        if base <= 0 or cap < base:
            raise RpcError("need 0 < base <= cap")
        self._dial_backoff_base = float(base)
        self._dial_backoff_cap = float(cap)
        if seed is not None:
            self._dial_rng = _pyrandom.Random(seed)

    def install_fault_hooks(self, hooks):
        """Install a fault-injection hooks object (the
        :mod:`moolib_tpu_torch.rpc.faults` contract) on this Rpc's wire seams.
        Testing-only: hooks run inline on the IO loop for every message."""
        self._faults = hooks

    def uninstall_fault_hooks(self):
        self._faults = None

    def set_flightrec_skew(self, skew_us: int):
        """TEST HOOK: shift the wall clock this peer reports on its
        ``__flightrec`` endpoint (the ``op="time"`` sample and every
        timestamp in the ``op="snapshot"`` wire bundle) by ``skew_us`` —
        a coherent simulation of a peer whose clock is off, so the
        clock-alignment pipeline is testable on one host. On-disk
        ``op="capture"`` bundles keep the true local clock. Production
        default is 0."""
        self._flightrec_skew_us = int(skew_us)

    def set_transports(self, transports):
        ts = set(transports)
        unknown = ts - {"tcp", "unix", "ipc", "shm"}
        if unknown:
            raise RpcError(f"unknown transports {sorted(unknown)}")
        if "ipc" in ts:  # reference naming: ipc == unix sockets
            ts.discard("ipc")
            ts.add("unix")
        self._transports = ts

    # -- listen / connect ----------------------------------------------------

    def listen(self, addr: str):
        """Listen on 'host:port', 'tcp://host:port', or 'unix:path'."""
        self._call_soon(self._listen(addr)).result()

    async def _listen(self, addr: str):
        scheme, target = _split_addr(addr)
        if scheme == "unix":
            server = await self._loop.create_unix_server(
                lambda: self._accept_proto("unix"), path=_unix_path(target)
            )
            self._servers.append(server)
            # Advertise with the host boot-id so remote hosts skip the dial
            # (reference: ipc reachability keys, src/transports/ipc.cc:280-315).
            self._listen_addrs.append(f"unix:{_BOOT_ID}:{target}")
            return
        host, port = _host_port(target)
        server = await self._loop.create_server(
            lambda: self._accept_proto("tcp"), host=host, port=port
        )
        self._servers.append(server)
        if port == 0:
            port = server.sockets[0].getsockname()[1]
        self._listen_addrs.append(f"tcp://{_advertise_host(host)}:{port}")
        # Also open an abstract unix socket for same-host peers (the
        # reference auto-creates its ipc transport alongside tcp).
        if "unix" in self._transports:
            upath = f"moolib-tpu-{self._peer_id[:16]}"
            try:
                userver = await self._loop.create_unix_server(
                    lambda: self._accept_proto("unix"), path=_unix_path(upath)
                )
                self._servers.append(userver)
                self._listen_addrs.append(f"unix:{_BOOT_ID}:{upath}")
            except OSError:
                pass

    def _accept_proto(self, transport_name: str) -> "_FrameProtocol":
        return _FrameProtocol(self, transport_name)

    def connect(self, addr: str):
        """Connect to a peer address. Explicit connections auto-reconnect
        until close() (reference: src/rpc.cc:1535-1541); transient dial
        failures are retried by the timeout loop, so a connect() racing the
        remote's listen() heals itself."""
        if self._closed:
            raise RpcError("Rpc is closed")

        def register():
            if addr in self._explicit:
                return  # idempotent: never reset a live registration
            self._explicit[addr] = {
                "conn": None, "last_try": 0.0, "dialing": False,
                # Capped exponential backoff + full jitter (see
                # set_reconnect_backoff): "backoff" is the current ceiling,
                # "delay" the jittered wait before the next redial.
                "backoff": self._dial_backoff_base,
                "delay": 0.0,
            }
            self._loop.create_task(self._dial_explicit(addr))

        try:
            self._loop.call_soon_threadsafe(register)
        except RuntimeError as e:
            raise RpcError(f"Rpc is closed: {e}") from None

    async def _dial_explicit(self, addr: str):
        entry = self._explicit.get(addr)
        if entry is None or self._closed or entry["dialing"]:
            return
        if entry["conn"] is not None and not entry["conn"].is_closing():
            return
        entry["dialing"] = True
        entry["last_try"] = time.monotonic()
        try:
            conn = await self._connect_addr(addr)
            if conn is not None:
                conn.explicit_addr = addr
                entry["conn"] = conn
                # Success: reset the schedule. A later drop redials after
                # ~base (not instantly — a crash-looping peer would turn
                # instant redials into a tight connect spin).
                entry["backoff"] = self._dial_backoff_base
                entry["delay"] = self._dial_backoff_base
            else:
                # Failure: full jitter over the current ceiling, then
                # double the ceiling (capped). Jitter over the WHOLE
                # interval — not [b/2, b] — is what de-synchronizes a
                # cohort that lost the same endpoint at the same instant.
                backoff = entry.get("backoff", self._dial_backoff_base)
                entry["delay"] = self._dial_rng.uniform(0.0, backoff)
                entry["backoff"] = min(
                    self._dial_backoff_cap, backoff * 2.0
                )
        finally:
            entry["dialing"] = False

    async def _connect_addr(self, addr: str) -> Optional[_Conn]:
        scheme, target = _split_addr(addr)
        try:
            if scheme == "unix":
                if "unix" not in self._transports:
                    return None
                if ":" in target:
                    boot, _, path = target.partition(":")
                    if boot != _BOOT_ID:
                        return None  # different host: its unix socket is
                        # unreachable, don't waste a dial
                    target = path
                _t, proto = await self._loop.create_unix_connection(
                    lambda: _FrameProtocol(self, "unix", outbound=True),
                    path=_unix_path(target),
                )
            else:
                if "tcp" not in self._transports:
                    return None
                host, port = _host_port(target)
                _t, proto = await self._loop.create_connection(
                    lambda: _FrameProtocol(self, "tcp", outbound=True),
                    host, port,
                )
        except OSError as e:
            log.debug("connect %s failed: %s", addr, e)
            return None
        return proto.conn  # registered (and greeted) by connection_made

    def _register_conn(self, conn: _Conn):
        """Called by the protocol for both accepted and dialed connections;
        the greeting exchange later binds the conn to a named peer."""
        self._anon_conns.append(conn)
        self._loop.create_task(self._send_greeting(conn))

    async def _send_greeting(self, conn: _Conn):
        payload = {
            "name": self._name,
            "peer_id": self._peer_id,
            "addresses": list(self._listen_addrs),
            # Same-host shm rendezvous: the boot identity gates the lane
            # (matching ids == same kernel == the segment is mappable);
            # "shm" advertises willingness, so a MOOLIB_TPU_SHM=0 peer
            # interops with an enabled one by simply never rendezvousing.
            "boot_id": self._boot_id,
            "shm": bool(self._shm_enabled and "shm" in self._transports),
        }
        await self._write(conn, serial.serialize(0, FID_GREETING, payload))

    # -- wire ----------------------------------------------------------------

    def _fault_send_consumed(self, conn: _Conn, frames: List[Any]) -> bool:
        """Consult the installed fault hooks for an outgoing message —
        LOOP THREAD ONLY. Returns True when the hooks consumed the send
        (dropped or rescheduled it); the caller then reports success, so
        an injected drop is indistinguishable from network loss."""
        faults = self._faults
        if faults is None:
            return False
        from .faults import frame_ids

        try:
            rid, fid = frame_ids(frames)
            action, arg = faults.filter_send(self, conn, rid, fid, frames)
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            # A buggy scenario must not silently corrupt the experiment:
            # surface it as a protocol error on this connection.
            log.error("fault hook failed on send: %s", e)
            self._drop_conn(conn, f"fault hook error: {e}")
            return True
        if action == "drop":
            conn.last_send = time.monotonic()
            return True
        if action == "delay":
            conn.last_send = time.monotonic()
            self._loop.call_later(
                float(arg), self._fault_write_later, conn, frames
            )
            return True
        if action == "dup":
            for _ in range(int(arg)):
                self._loop.call_soon(self._fault_write_later, conn, frames)
        return False  # pass (and the dup original) proceed normally

    def _fault_write_later(self, conn: _Conn, frames: List[Any]):
        """Deferred raw write for injected delay/duplicate deliveries.
        Bypasses the hooks (the verdict already happened) and flow
        control (chaos traffic is test-sized)."""
        if self._closed or conn.is_closing():
            return
        try:
            conn.sock.writelines(frames)
            conn.last_send = time.monotonic()
        except (ConnectionError, OSError) as e:
            self._drop_conn(conn, f"write failed: {e}")

    async def _write(self, conn: _Conn, frames: List[Any]):
        try:
            if conn.is_closing():
                raise ConnectionError("connection is closing")
            if self._faults is not None and \
                    self._fault_send_consumed(conn, frames):
                return
            conn.sock.writelines(frames)
            conn.last_send = time.monotonic()
            if self.telemetry.on:
                n = serial.frames_len(frames)
                self._m_bytes_out.inc(n)
                conn.m_out.inc(n)
            # Flow control: wait while the transport's write buffer is above
            # its high-water mark (the drain() equivalent).
            if not conn.proto._can_write.is_set():
                await conn.proto._can_write.wait()
        except (ConnectionError, OSError) as e:
            self._drop_conn(conn, f"write failed: {e}")
            raise

    def _write_detached(self, conn: _Conn, frames: List[Any]):
        """Fire-and-forget ``_write`` — LOOP THREAD ONLY. For replies,
        acks and control messages whose loss is covered by another
        mechanism (poke/resend, re-offer): ``_write``'s own failure path
        already tears the connection down (``_drop_conn``), and its
        re-raise exists for *awaiting* callers — route through
        ``_write_quiet`` so a send racing a closing connection cannot
        spam the event loop's 'Task exception was never retrieved'
        reporter (cancellation still propagates: a cancelled task is
        not an unretrieved exception)."""
        self._loop.create_task(self._write_quiet(conn, frames))

    def _write_now(self, conn: _Conn, frames: List[Any]) -> bool:
        """Synchronous fast-path write — LOOP THREAD ONLY.

        Skips the create_task/coroutine round-trip of ``_write`` (one extra
        loop iteration per message, which dominates the allreduce tree's
        per-chunk cost at high message rates). Returns False when the
        connection is closing or flow control is engaged, in which case the
        caller falls back to the awaitable path.
        """
        if conn.is_closing() or not conn.proto._can_write.is_set():
            return False
        if self._faults is not None and \
                self._fault_send_consumed(conn, frames):
            return True  # consumed by injection == "sent" to the caller
        try:
            conn.sock.writelines(frames)
            conn.last_send = time.monotonic()
            if self.telemetry.on:
                n = serial.frames_len(frames)
                self._m_bytes_out.inc(n)
                conn.m_out.inc(n)
            return True
        except (ConnectionError, OSError) as e:
            self._drop_conn(conn, f"write failed: {e}")
            return False

    def _drop_conn(self, conn: _Conn, why: str):
        # Idempotence latch: one real teardown can reach here twice
        # (e.g. an shm doorbell-write failure tears the lane down via
        # its on_down callback, then the surfaced ConnectionError lands
        # in _write's except) — counters, flightrec conn_down, and the
        # chaos on_conn_drop seam must each fire exactly once per drop.
        if conn.dropped:
            return
        conn.dropped = True
        log.debug("%s: drop_conn %s %s peer=%s closing=%s (%s)",
                  self._name, conn.transport,
                  "out" if conn.outbound else "in",
                  conn.peer_name, conn.is_closing(), why)
        if self.telemetry.on:
            self._m_conn_drops.inc()
        if self._flight.on:
            self._flight.record("conn_down",
                                peer=conn.peer_name or "?",
                                transport=conn.transport, why=why)
        if self._faults is not None:
            # Observation-only: scenario engines log the teardown. Hook
            # errors are swallowed here on purpose — _drop_conn must
            # complete (it runs inside error paths already).
            try:
                self._faults.on_conn_drop(self, conn, why)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except Exception as e:
                log.error("fault hook failed on conn drop: %s", e)
        conn.close()
        if conn.transport == "shm" and conn.peer_id is not None:
            # The lane dies with its conn: free the pair slot so a future
            # reconnect/greeting can rendezvous a fresh lane. (conn.close
            # above already closed the lane, unlinking creator files.)
            entry = self._shm_pairs.get(conn.peer_id)
            if entry is not None and entry.get("lane") is conn.sock:
                self._shm_pairs.pop(conn.peer_id, None)
        elif conn.peer_id is not None:
            # A socket conn died mid-rendezvous: an entry stuck in
            # "offered" whose offer/accept rode THIS conn can never
            # complete (the reply was pinned to the dead stream) — free
            # the slot and the never-used segment, or every future
            # greeting hits `peer_id in self._shm_pairs` and the pair is
            # stuck on TCP for the life of the process.
            entry = self._shm_pairs.get(conn.peer_id)
            if (entry is not None and entry.get("state") == "offered"
                    and entry.get("conn") is conn):
                self._shm_pairs.pop(conn.peer_id, None)
                entry["lane"].close()
        if conn in self._anon_conns:
            self._anon_conns.remove(conn)
        if conn.explicit_addr is not None:
            entry = self._explicit.get(conn.explicit_addr)
            if entry is not None and entry["conn"] is conn:
                entry["conn"] = None  # timeout loop re-dials
        if conn.peer_name:
            peer = self._peers.get(conn.peer_name)
            if peer and peer.conns.get(conn.transport) is conn:
                del peer.conns[conn.transport]
                log.debug("%s: lost %s connection to %s (%s)",
                          self._name, conn.transport, conn.peer_name, why)
                # Resend in-flight requests over another route when possible.
                self._loop.create_task(self._resend_for(conn))

    async def _resend_for(self, dead: _Conn):
        for out in list(self._outgoing.values()):
            if out.conn is dead and not out.future.done():
                if not out.reroute:
                    # Fail-fast contract (call_with_deadline): connection
                    # loss is an explicit error NOW, not a silent re-route
                    # — the caller owns failover and still has budget to
                    # spend on a different peer.
                    self._outgoing.pop(out.rid, None)
                    out.future._set_exception(RpcError(
                        f"connection to {out.peer_name} lost before reply "
                        f"to {out.fname!r} (reroute disabled)"
                    ))
                    continue
                if self.telemetry.on:
                    self._m_resends.inc()
                if self._flight.on:
                    self._flight.record("call_resend",
                                        peer=out.peer_name or "?",
                                        endpoint=out.fname)
                try:
                    await self._route_and_send(out)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # task cancellation propagates
                except Exception:
                    pass  # timeout loop will expire it

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, conn: _Conn, rid: int, fid: int, obj):
        faults = self._faults
        if faults is not None:
            # Recv seam: a hook exception propagates into the frame
            # protocol's dispatch guard, which drops the connection — a
            # buggy scenario surfaces as a protocol error, never silence.
            action, arg = faults.filter_recv(self, conn, rid, fid, obj)
            if action == "drop":
                return
            if action == "delay":
                self._loop.call_later(
                    float(arg), self._dispatch_now, conn, rid, fid, obj
                )
                return
            if action == "dup":
                for _ in range(int(arg)):
                    self._loop.call_soon(
                        self._dispatch_now, conn, rid, fid, obj
                    )
        self._dispatch_now(conn, rid, fid, obj)

    def _dispatch_now(self, conn: _Conn, rid: int, fid: int, obj):
        if fid == FID_GREETING:
            self._on_greeting(conn, obj)
        elif fid == FID_KEEPALIVE:
            pass
        elif fid == FID_LOOKING_FOR_PEER:
            self._on_looking_for_peer(conn, rid, obj)
        elif fid == FID_PEER_FOUND:
            self._on_peer_found(obj)
        elif fid == FID_POKE:
            self._on_poke(conn, rid)
        elif fid == FID_SHM_OFFER:
            self._on_shm_offer(conn, obj)
        elif fid == FID_SHM_ACCEPT:
            self._on_shm_accept(conn, obj)
        elif fid == FID_ACK:
            out = self._outgoing.get(rid)
            if out is not None:
                out.acked = True
        elif fid == FID_NACK:
            # Server never saw the request (lost in a connection teardown):
            # resend immediately over the current best route.
            out = self._outgoing.get(rid)
            if out is not None and not out.future.done():
                if self.telemetry.on:
                    self._m_resends.inc()
                if self._flight.on:
                    self._flight.record("call_resend",
                                        peer=out.peer_name or "?",
                                        endpoint=out.fname)
                self._loop.create_task(self._send_out(out))
        elif fid in (FID_SUCCESS, FID_ERROR, FID_FNF):
            self._on_response(conn, rid, fid, obj)
        elif fid >= FID_USER_BASE:
            self._on_request(conn, rid, fid, obj)
        else:
            log.error("unknown control fid %d", fid)

    def _on_greeting(self, conn: _Conn, obj):
        name = obj["name"]
        if obj["peer_id"] == self._peer_id:
            # Self-connection: drop (reference: onGreeting rejects self).
            self._drop_conn(conn, "self connection")
            return
        existing = self._peers.get(name)
        if (existing is not None and existing.peer_id is not None
                and existing.peer_id != obj["peer_id"]):
            live = any(
                not c.is_closing() for c in existing.conns.values()
            )
            if live:
                # Two distinct live peers claiming one name would corrupt
                # routing (reference: onGreeting rejects the collision,
                # src/rpc.cc:2184-2330). Last-writer must NOT win.
                log.error(
                    "%s: rejecting greeting: name %r already claimed by a "
                    "live peer with a different id", self._name, name,
                )
                self._drop_conn(conn, "peer name collision")
                return
            # Restarted incarnation reusing the name: stale addresses and
            # dead conns belong to the old identity — start clean. An shm
            # lane offered to (or shared with) the dead incarnation is
            # garbage too: the shm conn drop above pops established
            # lanes; sweep any still-pending offer by peer name.
            existing.addresses.clear()
            for old_conn in list(existing.conns.values()):
                self._drop_conn(old_conn, "stale incarnation")
            for pid, entry in list(self._shm_pairs.items()):
                if entry.get("peer") == name:
                    self._shm_pairs.pop(pid, None)
                    entry["lane"].close()
        conn.peer_name = name
        conn.peer_id = obj["peer_id"]
        if conn in self._anon_conns:
            self._anon_conns.remove(conn)
        peer = self._peers.setdefault(name, _Peer(name))
        peer.peer_id = obj["peer_id"]
        for a in obj.get("addresses", []):
            if a not in peer.addresses:
                peer.addresses.append(a)
        log.debug(
            "%s: greeting from %s on %s %s conn", self._name, name,
            "outbound" if conn.outbound else "inbound", conn.transport,
        )
        old = peer.conns.get(conn.transport)
        if old is not None and old is not conn:
            if (not old.is_closing() and old.outbound != conn.outbound):
                # Simultaneous cross-dial: both sides dialed at once. Each
                # side must keep the SAME socket or each ends up holding the
                # conn the other just closed (deadlocking the pair). Rule
                # both sides agree on: keep the conn dialed by the peer with
                # the smaller peer_id.
                keep_outbound = self._peer_id < obj["peer_id"]
                if conn.outbound != keep_outbound:
                    self._drop_conn(conn, "cross-dial loser")
                    return
                self._drop_conn(old, "cross-dial loser")
            else:
                # Same direction (a reconnect): the dialer knows best —
                # newest wins. Or old is already closing.
                self._drop_conn(old, "replaced by newer connection")
        peer.conns[conn.transport] = conn
        if self._flight.on:
            self._flight.record("conn_up", peer=name,
                                transport=conn.transport)
        if peer.found_event is not None:
            peer.found_event.set()
        # Same-host rendezvous: maybe open the zero-copy shm lane
        # alongside this socket lane (transport selection arbitrates).
        self._maybe_offer_shm(conn, obj)
        # Flush anything waiting on this peer.
        self._loop.create_task(self._flush_unrouted(peer))

    async def _flush_unrouted(self, peer: _Peer):
        for out in list(self._outgoing.values()):
            if out.peer_name == peer.name and out.conn is None:
                try:
                    await self._route_and_send(out)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # task cancellation propagates
                except Exception:
                    pass

    def _on_looking_for_peer(self, conn: _Conn, rid: int, obj):
        name = obj["name"]
        found: List[str] = []
        peer = self._peers.get(name)
        if peer:
            found = list(peer.addresses)
        if name == self._name:
            found = list(self._listen_addrs)
        if found:
            payload = {"name": name, "addresses": found}
            self._write_detached(
                conn, serial.serialize(0, FID_PEER_FOUND, payload)
            )

    def _on_peer_found(self, obj):
        name = obj["name"]
        peer = self._peers.setdefault(name, _Peer(name))
        for a in obj.get("addresses", []):
            if a not in peer.addresses:
                peer.addresses.append(a)
        if not peer.conns:
            self._loop.create_task(self._dial_peer(peer))

    async def _dial_peer(self, peer: _Peer):
        for addr in list(peer.addresses):
            if peer.conns:
                return
            if peer.found_event is None or peer.found_event.is_set():
                peer.found_event = asyncio.Event()
            conn = await self._connect_addr(addr)
            if conn is not None:
                # The greeting exchange binds the conn to the peer and sets
                # found_event (_on_greeting); await it instead of polling.
                # Timeout covers a peer that accepts but never greets.
                try:
                    await asyncio.wait_for(peer.found_event.wait(), timeout=2.0)
                except asyncio.TimeoutError:
                    continue  # next address
                if peer.conns:
                    return

    # -- same-host shm lane (rendezvous + delivery) --------------------------

    def _bind_lane_metrics(self, conn: _Conn):
        """Attach the per-transport telemetry family to a fresh conn —
        one registry probe at connection setup, one attribute access per
        message after."""
        m = self._lane_m.get(conn.transport)
        if m is None:
            reg = self.telemetry.registry
            m = (
                reg.counter("rpc_bytes_out_total",
                            transport=conn.transport),
                reg.counter("rpc_bytes_in_total",
                            transport=conn.transport),
                reg.histogram("rpc_lane_latency_seconds",
                              transport=conn.transport),
            )
            self._lane_m[conn.transport] = m
        conn.m_out, conn.m_in, conn.m_lat = m

    def _maybe_offer_shm(self, conn: _Conn, obj: dict):
        """Creator side of the rendezvous — LOOP THREAD ONLY. Runs on
        every greeting; a lane is offered when both peers are shm-willing
        and share a boot identity, and this peer holds the smaller id
        (one deterministic creator per pair, no cross-offer races)."""
        if not self._shm_enabled or "shm" not in self._transports:
            return
        if not obj.get("shm") or obj.get("boot_id") != self._boot_id:
            return
        peer_id = obj["peer_id"]
        if self._peer_id >= peer_id or peer_id in self._shm_pairs:
            return
        try:
            lane = shmring.ShmLane.create()
        except (OSError, ValueError) as e:
            log.debug("%s: shm lane create failed (%s); staying on %s",
                      self._name, e, conn.transport)
            return
        self._shm_pairs[peer_id] = {
            "lane": lane, "peer": conn.peer_name, "state": "offered",
            # The rendezvous conversation is pinned to this socket (the
            # attacher replies on the conn the offer arrived on): if it
            # dies first, the accept can never arrive — _drop_conn frees
            # the slot so the next greeting offers a fresh lane.
            "conn": conn,
        }
        payload = lane.offer_payload()
        payload["boot_id"] = self._boot_id
        self._write_detached(
            conn, serial.serialize(0, FID_SHM_OFFER, payload)
        )

    def _on_shm_offer(self, conn: _Conn, obj):
        """Attacher side: map the creator's segment, mount the lane, and
        answer. Any failure is a refusal, never an error — both sides
        then simply stay on the socket lanes."""
        ok, why = False, ""
        if conn.peer_name is None:
            why = "offer before greeting"
        elif not self._shm_enabled or "shm" not in self._transports:
            why = "shm disabled"
        elif obj.get("boot_id") != self._boot_id:
            why = "different host (boot id mismatch)"
        elif conn.peer_id in self._shm_pairs:
            why = "lane already exists"
        else:
            try:
                lane = shmring.ShmLane.attach(obj)
                self._shm_pairs[conn.peer_id] = {
                    "lane": lane, "peer": conn.peer_name, "state": "up",
                }
                self._register_shm_conn(
                    conn.peer_name, conn.peer_id, lane, outbound=False
                )
                ok = True
            except (OSError, ValueError, KeyError, TypeError) as e:
                why = f"attach failed: {type(e).__name__}: {e}"
                log.debug("%s: refusing shm offer from %s: %s",
                          self._name, conn.peer_name, why)
        self._write_detached(conn, serial.serialize(
            0, FID_SHM_ACCEPT, {"ok": ok, "why": why}
        ))

    def _on_shm_accept(self, conn: _Conn, obj):
        """Creator side: the attacher's verdict. ok -> mount our half;
        refusal -> tear the never-used lane down (unlinks the segment)."""
        entry = self._shm_pairs.get(conn.peer_id)
        if entry is None or entry.get("state") != "offered":
            return
        lane = entry["lane"]
        if not (isinstance(obj, dict) and obj.get("ok")):
            log.debug("%s: shm offer refused by %s: %s", self._name,
                      conn.peer_name,
                      obj.get("why") if isinstance(obj, dict) else obj)
            self._shm_pairs.pop(conn.peer_id, None)
            lane.close()
            return
        try:
            lane.open_tx()
        except OSError as e:
            log.debug("%s: shm doorbell open failed: %s", self._name, e)
            self._shm_pairs.pop(conn.peer_id, None)
            lane.close()
            return
        entry["state"] = "up"
        entry.pop("conn", None)  # rendezvous done: stop pinning the socket
        # Both sides are mounted (the attacher opened everything before
        # its accept, open_tx just completed): drop the /dev/shm names
        # now so no SIGKILL of either peer can ever leak them.
        lane.unlink_now()
        self._register_shm_conn(
            conn.peer_name, conn.peer_id, lane, outbound=True
        )

    def _register_shm_conn(self, peer_name: str, peer_id: str,
                           lane, outbound: bool) -> _Conn:
        """Mount a ready lane as a live connection: from here on the shm
        lane is an ordinary transport — EWMA selection, keepalives,
        fault-hook seams, resend-on-drop all apply unchanged."""
        conn = _Conn("shm", lane, lane, outbound)
        conn.peer_name = peer_name
        conn.peer_id = peer_id
        self._bind_lane_metrics(conn)
        peer = self._peers.setdefault(peer_name, _Peer(peer_name))
        old = peer.conns.get("shm")
        if old is not None and old is not conn:
            self._drop_conn(old, "replaced by newer shm lane")
        peer.conns["shm"] = conn
        lane.set_reclaim(self._reclaim_response_cache)
        lane.start(
            self._loop,
            lambda wire: self._shm_deliver(conn, wire),
            lambda why: self._drop_conn(conn, f"shm lane down: {why}"),
        )
        if self._flight.on:
            self._flight.record("conn_up", peer=peer_name, transport="shm")
        log.debug("%s: shm lane up to %s (%s)", self._name, peer_name,
                  lane.path)
        self._loop.create_task(self._flush_unrouted(peer))
        return conn

    def _shm_deliver(self, conn: _Conn, wire: memoryview):
        """Per-frame delivery from the lane's ring drain — LOOP THREAD
        ONLY, the shm mirror of ``_FrameProtocol.buffer_updated``: same
        telemetry, same recv fault seam (via ``_dispatch``), same
        drop-the-conn containment for decode errors."""
        conn.last_recv = time.monotonic()
        if self.telemetry.on:
            self._m_bytes_in.inc(len(wire))
            conn.m_in.inc(len(wire))
        try:
            magic, body_len = serial.HEADER.unpack(
                wire[:serial.HEADER.size]
            )
            if magic != serial.MAGIC or (
                body_len != len(wire) - serial.HEADER.size
            ):
                raise ValueError("bad shm frame header")
            rid, fid, obj = serial.deserialize_body(
                wire[serial.HEADER.size:]
            )
            self._dispatch(conn, rid, fid, obj)
        # Sync lane callback (no awaits): a decode/dispatch error must
        # drop the lane (degrading to TCP), never escape into the drain.
        except Exception as e:  # moolint: disable=swallow-cancelled
            log.error("shm frame dispatch error on %s: %s",
                      conn.peer_name, e)
            self._drop_conn(conn, f"protocol error: {e}")

    # -- requests (server side) ---------------------------------------------

    def _on_request(self, conn: _Conn, rid: int, fid: int, obj):
        peer_name = conn.peer_name or "?"
        # Trace-id unwrap is UNCONDITIONAL (the caller's tracing flag
        # decided the wrapping; the payload must come out right either
        # way). User payloads are always (args, kwargs) 2-tuples, so the
        # 3-tuple sentinel cannot collide.
        trace_id = None
        if (type(obj) is tuple and len(obj) == 3
                and obj[0] == _TRACE_TAG):
            trace_id, obj = obj[1], obj[2]
        # Deadline unwrap, same unconditional contract (nested inside the
        # trace wrap when both ride): re-anchor the propagated remaining
        # budget against OUR monotonic clock — wall clocks across peers
        # are not comparable, relative budgets are.
        budget = None
        if (type(obj) is tuple and len(obj) == 3
                and obj[0] == _DEADLINE_TAG):
            budget, obj = float(obj[1]), obj[2]
        # Key by peer_id: a restarted peer reusing a name (and rids) must be
        # executed fresh, never served a previous incarnation's cache
        # (reference: PeerId-based identity, src/rpc.cc:455-487).
        key = (conn.peer_id or peer_name, rid)
        if key in self._recent_rids:
            cached = self._response_cache.get(key)
            if cached is not None:
                self._write_detached(conn, cached)
            return  # duplicate (resend after reconnect): suppress re-execution
        self._mark_recent(key)
        entry = self._functions.get(fid)
        if log.isEnabledFor(10):
            log.debug("%s: request rid=%d %s from %s", self._name, rid,
                      entry[0] if entry else f"fid {fid}", peer_name)
        if entry is None:
            self._loop.create_task(
                self._write(
                    conn, serial.serialize(rid, FID_FNF, f"unknown function id {fid}")
                )
            )
            return
        fname, handler = entry
        tel = self.telemetry
        sm = None
        t0 = wall0 = 0.0
        if tel.on or tel.tracing:
            t0 = time.monotonic()
            if tel.tracing:  # wall clock only places spans; skip otherwise
                wall0 = time.time()
        if tel.on:
            sm = self._tel_server.get(fname)
            if sm is None:
                reg = tel.registry
                sm = (
                    reg.counter("rpc_server_calls_total", endpoint=fname),
                    reg.histogram("rpc_server_handle_seconds",
                                  endpoint=fname),
                )
                self._tel_server[fname] = sm
            sm[0].inc()

        def respond(value, error_msg):
            if sm is not None:
                sm[1].observe(time.monotonic() - t0)
            if tel.tracing and wall0:  # wall0==0: tracing flipped mid-call
                tel.traces.add_span(
                    f"handle {fname}", "rpc", pid=self._name,
                    ts_us=int(wall0 * 1e6),
                    dur_us=int((time.time() - wall0) * 1e6),
                    trace_id=trace_id,
                    args={"peer": peer_name, "rid": rid,
                          "error": error_msg is not None},
                )
            if error_msg is None:
                frames = serial.serialize(rid, FID_SUCCESS, value)
            else:
                frames = serial.serialize(rid, FID_ERROR, error_msg)
            self._cache_response(key, frames)
            def _send():
                # Up to two routing attempts: _write_now returning False
                # with the conn closing means the write RAISED and dropped
                # it — retrying the same dead target would only produce an
                # unconsumed task exception; re-route via another live conn
                # instead. False with the conn still open is flow control:
                # the awaitable path on the same conn is correct. If no
                # route remains, the reply stays in the response cache and
                # the client's poke replays it (the reliability backstop).
                for _ in range(2):
                    peer = self._peers.get(peer_name)
                    if peer and peer.conns:
                        target = _best_conn(peer)
                    elif not conn.is_closing():
                        target = conn
                    else:
                        return
                    if target is None or self._write_now(target, frames):
                        return
                    if not target.is_closing():
                        self._loop.create_task(
                            self._write_quiet(target, frames)
                        )
                        return
            try:
                self._loop.call_soon_threadsafe(_send)
            except RuntimeError:
                pass  # Rpc closed while a handler was finishing: reply moot

        if budget is not None:
            # Handler-visible deadline surface: define_deferred exposes it
            # as dr.deadline, define_queue stamps queue-entry expiry with
            # it, and admission layers (serving) read it to shed work
            # whose budget cannot cover service.
            respond.budget = budget
            respond.deadline = time.monotonic() + budget
        handler(respond, obj)

    def _mark_recent(self, key):
        # False = received, still executing; _cache_response flips it to
        # True (answered) so the poke path can tell "still working" apart
        # from "answered but the reply frames were evicted".
        self._recent_rids[key] = False
        while len(self._recent_rids) > 65536:
            self._recent_rids.popitem(last=False)

    def _cache_response(self, key, frames):
        # Bounded by entry count AND bytes: large replies (a __telemetry
        # scrape with spans can run to MBs) must not pin unbounded RSS
        # when a poller scrapes for hours. An evicted reply is NOT
        # silently droppable — exactly-once forbids re-execution — so
        # eviction degrades a lost-reply recovery from replay to a fast
        # explicit error (see _on_poke), never a hang.
        with self._response_cache_lock:
            old = self._response_cache.pop(key, None)
            if old is not None:
                self._response_cache_bytes -= serial.frames_len(old)
            self._response_cache[key] = frames
            self._response_cache_bytes += serial.frames_len(frames)
            if key in self._recent_rids:
                self._recent_rids[key] = True  # answered
            while len(self._response_cache) > 1 and (
                len(self._response_cache) > 4096
                or self._response_cache_bytes > _RESPONSE_CACHE_MAX_BYTES
            ):
                _k, evicted = self._response_cache.popitem(last=False)
                self._response_cache_bytes -= serial.frames_len(evicted)

    def _reclaim_response_cache(self):
        """Shm slot-pressure reclaim (mounted on every lane): cached
        exactly-once replies hold zero-copy views over spill slots, so a
        full cache can pin a whole direction's slots and starve the
        peer's allocator into the slow chunked path. Shed the oldest
        half (by bytes) — the accepted degradation is the same as
        ordinary cache eviction: a replay of an evicted reply gets the
        explicit evicted-reply error (see ``_on_poke``), never
        re-execution, and the freed views release their slots
        synchronously via refcount."""
        if self.telemetry.on:
            self._m_cache_pressure.inc()
        with self._response_cache_lock:
            target = self._response_cache_bytes / 2
            while (self._response_cache
                   and self._response_cache_bytes > target):
                _k, evicted = self._response_cache.popitem(last=False)
                self._response_cache_bytes -= serial.frames_len(evicted)

    def _on_poke(self, conn: _Conn, rid: int):
        """Server side of the poke protocol: the client asks whether we ever
        received request ``rid``. Known + answered -> replay the cached
        response; known + still executing -> ACK (keep waiting); answered
        but reply evicted from the cache -> explicit error (re-execution
        would break exactly-once; hanging to the timeout helps nobody);
        unknown -> NACK (client resends)."""
        key = (conn.peer_id or conn.peer_name or "?", rid)
        answered = self._recent_rids.get(key)
        if answered is None:
            frames = serial.serialize(rid, FID_NACK, None)
        else:
            cached = self._response_cache.get(key)
            if cached is not None:
                frames = cached
            elif answered:
                frames = serial.serialize(
                    rid, FID_ERROR,
                    "reply evicted from the response cache before delivery "
                    "(result lost; the call was executed exactly once)",
                )
            else:
                frames = serial.serialize(rid, FID_ACK, None)
        self._write_detached(conn, frames)

    def _on_response(self, conn: _Conn, rid: int, fid: int, obj):
        out = self._outgoing.pop(rid, None)
        if out is None:
            return
        rtt = time.monotonic() - out.sent_at
        # Attribute the RTT to the lane that carried the REQUEST, not
        # whichever lane the server chose for the reply: with multiple
        # lanes per peer (shm + tcp) the reply often rides a different
        # one, and crediting the arrival lane would leave the request
        # lane's EWMA forever unmeasured at 0.0 — argmin would then pin
        # all traffic to it blind. An unmeasured lane still attracts
        # exactly one probe call (EWMA 0.0 wins its first argmin tie).
        lane = out.conn if (
            out.conn is not None and not out.conn.is_closing()
        ) else conn
        lane.latency.add(rtt)
        tel = self.telemetry
        if tel.on:
            # Lane-labelled RTT: the same sample the EWMA transport
            # selector consumes, exported per transport so the shm-vs-tcp
            # arbitration is observable (docs/observability.md).
            lane.m_lat.observe(rtt)
            cm = self._tel_client.get(out.fname)
            if cm is not None:
                # Full-call latency (submission to response, resends
                # included) — what a caller actually waited.
                cm[1].observe(time.monotonic() - out.t0)
        if tel.tracing and out.trace_id is not None:
            tel.traces.add_span(
                f"call {out.fname}", "rpc", pid=self._name,
                ts_us=int(out.wall0 * 1e6),
                dur_us=int((time.time() - out.wall0) * 1e6),
                trace_id=out.trace_id,
                args={"peer": out.peer_name, "rid": rid,
                      "ok": fid == FID_SUCCESS},
            )
        if fid == FID_SUCCESS:
            out.future._set_result(obj)
        elif fid == FID_FNF:
            out.future._set_exception(
                RpcError(f"function {out.fname!r} not found on {out.peer_name!r}")
            )
        else:
            out.future._set_exception(RpcError(str(obj)))

    # -- define (server registration) ---------------------------------------

    def define(self, name: str, fn: Optional[Callable] = None, *,
               batch_size: Optional[int] = None, device: Optional[Any] = None,
               pad: bool = False, inline: bool = False):
        """Register ``fn`` as callable by peers under ``name``.

        Tensor arguments arrive as **read-only** numpy views aliasing the
        receive buffer (zero-copy); handlers that mutate in place must copy
        first (``np.array(x)``). A ``bfloat16`` leaf arrives as a
        ``torch.bfloat16`` CPU tensor over the same bytes (see
        :mod:`.serial`). Replies may hold torch tensors, on any device.

        With ``batch_size``, concurrent calls are stacked into one batched
        call and replies unbatched (reference: src/moolib.cc:1007-1062).
        With ``pad=True`` the stacked leading dim is always exactly
        ``batch_size`` (short batches are padded by repeating row 0 and the
        reply sliced back) — keeps shapes static, so a handler that
        captures or compiles per shape does so once. With ``device`` (a
        batched define only) the stacked arguments reach the handler as
        torch tensors on that device, staged by
        :func:`~moolib_tpu_torch.ops.batcher.stage_batch` (pinned,
        asynchronous for CUDA); without it they stay numpy.
        Usable as a decorator when ``fn`` is omitted.

        ``inline=True`` runs the handler directly on the IO thread instead
        of the executor — for short, non-blocking handlers this removes two
        thread hops per call, which dominates at high message rates (the
        reference similarly dispatches trivial service callbacks without a
        scheduler hop). Inline handlers must never block.
        """
        if fn is None:
            return lambda f: (self.define(name, f, batch_size=batch_size,
                                          device=device, pad=pad,
                                          inline=inline), f)[1]
        if batch_size is not None:
            queue = self.define_queue(
                name, batch_size=batch_size, dynamic_batching=True
            )
            worker = threading.Thread(
                target=_batched_server_loop,
                args=(queue, fn, device, batch_size if pad else None,
                      self.telemetry, batch_size),
                name=f"{self._name}-batch-{name}",
                daemon=True,
            )
            worker.start()
            self._batchers[name] = (queue, worker)
            return fn

        def handler(respond, obj):
            args, kwargs = obj
            def run():
                try:
                    respond(fn(*args, **kwargs), None)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError) as e:
                    # Tell the caller the call died. On the executor path
                    # PROPAGATE the cancellation; an inline handler runs
                    # synchronously inside the frame protocol's dispatch,
                    # where a re-raise would hit its catch-all and drop
                    # the whole connection (killing every other in-flight
                    # call) — the error response is the propagation there.
                    respond(None, f"{type(e).__name__}: call cancelled")
                    if not inline:
                        raise
                except Exception as e:
                    respond(None, f"{type(e).__name__}: {e}")
            if inline:
                run()
            else:
                # Fire-and-forget by design: every outcome of run() —
                # including the cancellation re-raise above — reaches the
                # caller through respond(); the worker future is empty.
                self._executor.submit(run)  # moolint: disable=dropped-future

        self._functions[fid_for(name)] = (name, handler)
        return fn

    def define_deferred(self, name: str, fn: Callable):
        """Register ``fn(deferred_return, *args, **kwargs)``; the handler
        replies later via the RpcDeferredReturn handle."""

        def handler(respond, obj):
            args, kwargs = obj
            dr = RpcDeferredReturn(respond)
            def run():
                try:
                    fn(dr, *args, **kwargs)
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError) as e:
                    # Report, then propagate — never swallow cancellation.
                    if not dr._done:
                        dr.error(f"{type(e).__name__}: call cancelled")
                    raise
                except Exception as e:
                    if not dr._done:
                        dr.error(f"{type(e).__name__}: {e}")
            # Fire-and-forget by design: outcomes flow through the
            # deferred-return handle, not the worker future.
            self._executor.submit(run)  # moolint: disable=dropped-future

        self._functions[fid_for(name)] = (name, handler)

    def define_queue(self, name: str, *, batch_size: Optional[int] = None,
                     dynamic_batching: bool = False) -> Queue:
        queue = Queue(self, name, batch_size, dynamic_batching,
                      lambda: self._timeout)
        self._queues[name] = queue

        def handler(respond, obj):
            args, kwargs = obj

            def cb(value=None):
                respond(value, None)

            cb.error = lambda msg: respond(None, str(msg))
            # Propagated caller deadline (call_with_deadline), if any:
            # visible to queue consumers and bounds the entry's expiry.
            cb.deadline = getattr(respond, "deadline", None)
            queue._push(cb, args, kwargs, deadline=cb.deadline)

        self._functions[fid_for(name)] = (name, handler)
        return queue

    def defined(self, name: str) -> bool:
        """Whether ``name`` currently has a registered handler — the
        runtime mirror of moolint's ``rpc-define-collision``: a second
        ``define`` under the same name silently replaces the first (both
        hash to one fid), so services registering a family of endpoints
        should refuse a name that is already taken."""
        return fid_for(name) in self._functions

    def undefine(self, name: str):
        self._functions.pop(fid_for(name), None)
        q = self._queues.pop(name, None)
        if q:
            q._close()
        self._batchers.pop(name, None)

    # -- calls (client side) -------------------------------------------------

    def async_(self, peer: str, func: str, *args, **kwargs) -> Future:
        return self._start_call(peer, func, args, kwargs, None, True)

    def call_with_deadline(self, peer: str, func: str, budget_s: float,
                           *args, reroute: bool = False,
                           **kwargs) -> Future:
        """Call ``func`` with a propagated per-request deadline.

        ``budget_s`` (positive, finite) is the remaining time allowance:
        it caps this call's own expiry at ``min(budget_s, set_timeout)``
        AND rides the wire (see ``_DEADLINE_TAG``) so the receiving peer
        can shed the work when the budget can no longer cover its service
        time (``respond.deadline``/``RpcDeferredReturn.deadline``, queue
        entries expire at the propagated instant). Note the budget is
        stamped into the frames at submission — a reconnect resend reuses
        the stamp, so a receiver after a resend sees a slightly generous
        remaining budget; the caller-side expiry is exact regardless.

        ``reroute=False`` (the default here, unlike ``async_``) makes the
        call fail fast with an explicit error when the connection to the
        peer dies or the peer is unroutable, instead of silently
        re-routing/redialing until the deadline: failover to a different
        peer is the caller's decision (the serving router retries
        elsewhere with the budget that is still left)."""
        budget = _check_budget(budget_s, "Rpc.call_with_deadline")
        return self._start_call(peer, func, args, kwargs, budget, reroute)

    def _start_call(self, peer: str, func: str, args, kwargs,
                    budget: Optional[float], reroute: bool) -> Future:
        fut = Future()
        rid = (next(self._rid_counter) << 1) | 1
        log.debug("%s: call %s::%s rid=%d", self._name, peer, func, rid)
        tel = self.telemetry
        payload: Any = (args, kwargs)
        if budget is not None:
            payload = (_DEADLINE_TAG, budget, payload)
        trace_id = None
        if tel.tracing:
            # Trace-id propagation: ride the payload (see _TRACE_TAG);
            # the handler side unwraps unconditionally.
            trace_id = f"{self._peer_id[:8]}-{rid:x}"
            payload = (_TRACE_TAG, trace_id, payload)
        if tel.on:
            cm = self._tel_client.get(func)
            if cm is None:
                reg = tel.registry
                cm = (
                    reg.counter("rpc_client_calls_total", endpoint=func),
                    reg.histogram("rpc_client_latency_seconds",
                                  endpoint=func),
                )
                self._tel_client[func] = cm
            cm[0].inc()
        frames = serial.serialize(rid, fid_for(func), payload)
        expiry = self._timeout if budget is None \
            else min(self._timeout, budget)
        out = _Outgoing(rid, peer, func, frames, fut,
                        time.monotonic() + expiry)
        out.reroute = reroute
        if trace_id is not None:
            out.trace_id = trace_id
            out.wall0 = time.time()
        def submit():
            self._outgoing[rid] = out
            # Fast path: route + write synchronously when the peer has a
            # live, unblocked connection (the common steady-state case).
            p = self._peers.get(out.peer_name)
            if p is not None and p.conns:
                conn = _best_conn(p)
                if conn is not None:
                    out.conn = conn
                    out.sent_at = time.monotonic()
                    if self._write_now(conn, out.frames):
                        self._sched_out(
                            out, self._next_check(out, out.sent_at)
                        )
                        return
                    out.conn = None
            self._loop.create_task(self._send_out(out))
            # Unrouted (or routing async): first wheel check one tick out.
            self._sched_out(out, time.monotonic() + self._TICK)
        self._loop.call_soon_threadsafe(submit)
        return fut

    def async_callback(self, peer: str, func: str, callback: Callable,
                       *args, **kwargs) -> Future:
        fut = self.async_(peer, func, *args, **kwargs)

        def on_done(f: Future):
            exc = f._cf.exception()
            if exc is not None:
                callback(None, exc)
            else:
                callback(f._cf.result(), None)

        fut.add_done_callback(on_done)
        return fut

    def sync(self, peer: str, func: str, *args, **kwargs):
        # The deadline wheel guarantees completion within self._timeout
        # (captured at dispatch), so the margin only matters when the IO
        # loop itself is wedged — then a TimeoutError beats hanging the
        # caller forever with no error path.
        return self.async_(peer, func, *args, **kwargs).result(
            self._timeout + 30.0
        )

    def bulk(self, calls, *, window: int = 8,
             timeout: Optional[float] = None):
        """Bounded-window bulk fetch: issue ``calls`` — an iterable of
        ``(peer, func, args_tuple)`` — keeping at most ``window`` in
        flight, and return ``[(result, error), ...]`` in call order.
        Per-call failures (RpcError/TimeoutError) are captured in the
        pair, never raised, so one dead holder costs one entry — the
        statestore's chunk-pull/push primitive, where the caller retries
        failed items against a different peer. Cancellation always
        propagates."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        per_call = self._timeout if timeout is None else float(timeout)
        calls = list(calls)
        results: List[Any] = [None] * len(calls)
        inflight: "deque[Tuple[int, Future]]" = deque()

        def settle(idx: int, fut: Future):
            try:
                results[idx] = (fut.result(timeout=per_call + 30.0), None)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError) as e:
                results[idx] = (None, e)

        for i, (peer, func, args) in enumerate(calls):
            inflight.append((i, self.async_(peer, func, *args)))
            if len(inflight) >= window:
                settle(*inflight.popleft())
        while inflight:
            settle(*inflight.popleft())
        return results

    async def _write_quiet(self, conn: _Conn, frames: List[Any]):
        """Awaitable write that swallows connection failures — for replies
        whose loss is covered by another mechanism (the poke/response-cache
        replay), where a raised-but-unconsumed task exception is noise."""
        try:
            await self._write(conn, frames)
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError):
            raise  # only write FAILURES are quiet, not cancellation
        except Exception:
            pass

    async def _send_out(self, out: _Outgoing):
        try:
            await self._route_and_send(out)
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError):
            raise  # task cancellation propagates
        except Exception:
            pass  # stays queued; flushed on connect or expired by timeout

    async def _route_and_send(self, out: _Outgoing):
        peer = self._peers.get(out.peer_name)
        if peer is None or not peer.conns:
            out.conn = None
            await self._find_peer(out.peer_name)
            peer = self._peers.get(out.peer_name)
            if peer is None or not peer.conns:
                return
        conn = _best_conn(peer)
        out.conn = conn
        out.sent_at = time.monotonic()
        await self._write(conn, out.frames)

    async def _find_peer(self, name: str):
        """Gossip discovery (reference: findPeersImpl, src/rpc.cc:2332-2433)."""
        peer = self._peers.setdefault(name, _Peer(name))
        if peer.conns or peer.finding:
            return
        peer.finding = True
        try:
            if peer.addresses:
                await self._dial_peer(peer)
                if peer.conns:
                    return
            payload = {"name": name}
            frames = serial.serialize(0, FID_LOOKING_FOR_PEER, payload)
            for other in list(self._peers.values()):
                if other.name == name:
                    continue
                conn = _best_conn(other) if other.conns else None
                if conn is not None:
                    try:
                        await self._write(conn, frames)
                    except (asyncio.CancelledError,
                            concurrent.futures.CancelledError):
                        raise  # task cancellation propagates
                    except Exception:
                        pass
        finally:
            peer.finding = False

    # -- timeouts / keepalive ------------------------------------------------

    _TICK = 0.1  # timeout-wheel resolution (matches the loop period)

    def _sched_out(self, out: _Outgoing, when: float):
        """(Re)schedule ``out`` on the deadline wheel — LOOP THREAD ONLY."""
        slot = int(when / self._TICK)
        out.next_slot = slot
        heapq.heappush(self._out_heap, (slot, next(self._sched_seq), out))

    def _next_check(self, out: _Outgoing, now: float) -> float:
        """Earliest future instant this call needs attention: unrouted
        calls retry every tick; un-acked ones at their next poke time;
        acked ones on a slower re-poke grace."""
        if out.conn is None:
            return now + self._TICK
        lat = out.conn.latency.value or 0.0
        poke_after = min(max(4.0 * lat, self._poke_min), self._timeout / 2)
        if out.acked:
            # An ACK means "received, still executing" — NOT "the reply
            # is guaranteed to arrive": the reply can still die with the
            # connection that carries it (e.g. a zombie shm lane the
            # server wrote into before noticing peer death). Re-poke on
            # a 4x grace so a lost reply degrades to a bounded re-ask
            # (cached-response replay), never a silent wait until the
            # call deadline.
            poke_after = max(4.0 * poke_after, 2.0)
        return min(out.deadline, max(out.sent_at, out.poked_at) + poke_after)

    async def _timeout_loop(self):
        """Expire calls, retry unrouted sends, keepalive idle connections
        (reference: timeoutThreadEntry, src/rpc.cc:1667-1760).

        In-flight call bookkeeping is O(due entries), not O(in-flight):
        the deadline wheel only surfaces calls whose next poke/expiry/
        retry time has arrived (an acting plane with thousands of
        concurrent calls costs this loop nothing between events)."""
        while not self._closed:
            try:
                now = time.monotonic()
                ka = self._keepalive_interval
                cur_slot = int(now / self._TICK)
                heap = self._out_heap
                while heap and heap[0][0] <= cur_slot:
                    slot, _seq, out = heapq.heappop(heap)
                    if out.next_slot != slot:
                        continue  # superseded by a newer schedule
                    rid = out.rid
                    if self._outgoing.get(rid) is not out:
                        continue  # answered (response path popped it)
                    if out.future.done():
                        self._outgoing.pop(rid, None)
                        continue
                    self._m_timeout_entries.inc()
                    if now >= out.deadline:
                        self._outgoing.pop(rid, None)
                        if self.telemetry.on:
                            self._m_timeouts.inc()
                        if self._flight.on:
                            self._flight.record("call_timeout",
                                                peer=out.peer_name or "?",
                                                endpoint=out.fname)
                        out.future._set_exception(
                            RpcError(
                                f"call to {out.peer_name}::{out.fname} "
                                "timed out"
                            )
                        )
                        continue
                    if out.conn is None:
                        await self._send_out(out)
                        if out.conn is None and not out.reroute:
                            # Fail-fast contract: the peer is unroutable
                            # (no live conn and the re-route attempt just
                            # failed) — error now instead of redialing
                            # until the deadline. The first wheel check is
                            # one tick after submission, so a dial racing
                            # the call still gets that window to land.
                            self._outgoing.pop(rid, None)
                            out.future._set_exception(RpcError(
                                f"no route to {out.peer_name} for "
                                f"{out.fname!r} (reroute disabled)"
                            ))
                            continue
                    else:
                        # Unanswered: poke the server after a
                        # latency-scaled silence so a request lost in a
                        # connection handover is resent well before the
                        # deadline (reference: src/rpc.cc:1414-1498).
                        # ACKed calls re-poke too, on a 4x grace (see
                        # _next_check): the reply itself can be lost with
                        # the lane that carried it, and the re-ask
                        # replays the cached response.
                        lat = out.conn.latency.value or 0.0
                        poke_after = min(
                            max(4.0 * lat, self._poke_min), self._timeout / 2
                        )
                        if out.acked:
                            poke_after = max(4.0 * poke_after, 2.0)
                        if now - max(out.sent_at, out.poked_at) > poke_after:
                            out.poked_at = now
                            out.acked = False  # re-arm: answer or re-ACK
                            peer = self._peers.get(out.peer_name)
                            conn = _best_conn(peer) if peer and peer.conns \
                                else None
                            if conn is None:
                                out.conn = None  # re-route on next check
                            else:
                                if self.telemetry.on:
                                    self._m_pokes.inc()
                                try:
                                    await self._write(
                                        conn,
                                        serial.serialize(
                                            out.rid, FID_POKE, None
                                        ),
                                    )
                                except (asyncio.CancelledError,
                                        concurrent.futures.CancelledError):
                                    raise
                                except Exception:
                                    pass
                    self._sched_out(
                        out, max(self._next_check(out, now), now + self._TICK)
                    )
                # Re-dial dropped/failed explicit connections on their
                # jittered backoff schedule (see _dial_explicit).
                for addr, entry in list(self._explicit.items()):
                    conn = entry["conn"]
                    dead = conn is None or conn.is_closing()
                    if (dead and not entry["dialing"]
                            and now - entry["last_try"]
                            > entry.get("delay", 1.0)):
                        self._loop.create_task(self._dial_explicit(addr))
                # Keepalive silent conns; tear down half-open ones. Both
                # sides keepalive when idle, so a healthy peer is never
                # recv-silent for 4 intervals — hitting that means the peer
                # host froze or died without RST and in-flight calls must be
                # re-routed now, not at expiry (reference: rpc.cc:1625-1665).
                for peer in list(self._peers.values()):
                    for conn in list(peer.conns.values()):
                        if now - conn.last_recv > 4.0 * ka:
                            self._drop_conn(
                                conn,
                                f"silent for {now - conn.last_recv:.1f}s "
                                f"(> 4 keepalive intervals)",
                            )
                        elif now - conn.last_send > ka:
                            try:
                                await self._write(
                                    conn, serial.serialize(0, FID_KEEPALIVE, None)
                                )
                            except (asyncio.CancelledError,
                                    concurrent.futures.CancelledError):
                                raise
                            except Exception:
                                pass
                # Anonymous conns that never complete a greeting are GC'd.
                for conn in list(self._anon_conns):
                    if now - conn.last_recv > max(4.0 * ka, 10.0):
                        self._drop_conn(conn, "no greeting")
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # loop shutdown: let the task die cancelled
            except Exception as e:
                log.error("timeout loop error: %s", e)
            await asyncio.sleep(0.1)

    # -- introspection / lifecycle ------------------------------------------

    def debug_info(self) -> dict:
        """Per-peer transport/latency info (reference: src/rpc.cc:1598-1623).

        Thin view over the telemetry registry for everything countable —
        the registry is the one source of truth (``in_flight``,
        ``timeout_entries_processed``, and the ``telemetry`` wire counters
        all read from it); only live connection/backoff structure is
        assembled here."""
        reg = self.telemetry.registry
        info = {"name": self._name, "listen": list(self._listen_addrs),
                "in_flight": int(
                    reg.value("rpc_inflight_calls", peer=self._name) or 0
                ),
                # Wheel-entry processing count: stress tests assert this
                # stays O(events), not O(in-flight x ticks).
                "timeout_entries_processed":
                    int(self._m_timeout_entries.value),
                # Wire-level counters, straight from the registry.
                "telemetry": {
                    "bytes_sent": int(self._m_bytes_out.value),
                    "bytes_received": int(self._m_bytes_in.value),
                    "resends": int(self._m_resends.value),
                    "pokes": int(self._m_pokes.value),
                    "conn_drops": int(self._m_conn_drops.value),
                    "calls_timed_out": int(self._m_timeouts.value),
                },
                # Explicit-reconnect schedule (backoff/jitter state), so
                # tests and operators can see redial pacing per address.
                # list(): connect() registers entries on the loop thread
                # while any thread may call debug_info.
                "explicit": {
                    addr: {
                        "connected": (
                            e["conn"] is not None
                            and not e["conn"].is_closing()
                        ),
                        "backoff": e.get("backoff"),
                        "delay": e.get("delay"),
                    }
                    for addr, e in list(self._explicit.items())
                },
                "peers": {}}
        for peer in self._peers.values():
            info["peers"][peer.name] = {
                "addresses": list(peer.addresses),
                "connections": {
                    t: {
                        "latency_ms": c.latency.value * 1e3,
                        "age_s": time.monotonic() - c.created,
                    }
                    for t, c in peer.conns.items()
                },
            }
        return info

    def _serve_telemetry(self, fmt: str = "json", spans: bool = False):
        """Handler for the auto-defined ``__telemetry`` endpoint.

        ``fmt="json"`` returns ``{"name", "metrics", "peers", ["trace"]}``
        where ``metrics`` merges the process-global registry (batchers,
        env pools, chaos plans, example loops) under this peer's own — so
        any peer's scrape shows the whole process — and ``peers`` lists
        this peer's dialable neighbours so a scraper can crawl the cohort
        (tools/telemetry_dump.py). ``fmt="prometheus"`` returns the text
        exposition of the same merged view. With ``spans=True`` (JSON
        only) the Chrome-trace export of this peer's spans plus the
        process-global buffer rides along."""
        tel = self.telemetry
        gt = global_telemetry()
        if fmt in ("prometheus", "prom", "text"):
            if tel is gt:
                return tel.prometheus()
            return gt.prometheus() + tel.prometheus()
        metrics = {} if tel is gt else gt.snapshot()
        metrics.update(tel.snapshot())
        # Advertise dialable neighbours (peers with known addresses) so a
        # scraper dialed into ONE peer can crawl the whole cohort — the
        # connection table only gossips on demand, never spontaneously.
        out = {"name": self._name, "metrics": metrics,
               "peers": sorted(p.name for p in list(self._peers.values())
                               if p.addresses and p.name != self._name)}
        if spans:
            all_spans = tel.traces.spans()
            if tel is not gt:
                all_spans = all_spans + gt.traces.spans()
            all_spans.sort(key=lambda s: (s.ts, s.pid, s.name))
            out["trace"] = spans_to_chrome(all_spans)
        return out

    def _serve_flightrec(self, op: str = "snapshot", trigger: str = "api",
                         detail: str = ""):
        """Handler for the auto-defined ``__flightrec`` endpoint — the
        incident surface ``tools/incident_report.py`` crawls.

        - ``op="time"``: ``{"name", "time_us"}`` — a minimal wall-clock
          sample for NTP-style offset estimation (the caller brackets the
          call and keeps the min-RTT sample; see
          :func:`moolib_tpu_torch.flightrec.merge.estimate_offset`).
        - ``op="snapshot"`` (default): freeze and return this peer's
          bundle (flight events + spans + metrics + thread stacks +
          fingerprint, process-global state merged in) without touching
          disk, plus the dialable-neighbour list so one address crawls
          the cohort, plus the paths of bundles already captured on
          disk here.
        - ``op="capture"``: write an incident bundle to this peer's disk
          (trigger/detail recorded) and return its path — the
          "dying cohort: freeze everything NOW" verb.

        The ``set_flightrec_skew`` test hook shifts the *wire-served*
        clock — the ``op="time"`` sample and the ``op="snapshot"``
        bundle — so the alignment pipeline is exercisable on one host.
        On-disk captures (``op="capture"``) are real local evidence and
        stay in the process's true clock.
        """
        from ..flightrec.bundle import shift_bundle_ts, snapshot_bundle
        from ..flightrec.capture import capture_incident, recent_captures
        from ..telemetry import now_us

        skew = self._flightrec_skew_us
        if op == "time":
            return {"name": self._name, "time_us": now_us() + skew}
        if op == "capture":
            path = capture_incident(
                trigger, detail or "requested via __flightrec",
                telemetry=self.telemetry,
            )
            return {"name": self._name, "path": path}
        if op != "snapshot":
            raise RpcError(f"__flightrec: unknown op {op!r}")
        bundle = snapshot_bundle(
            self.telemetry, trigger="scrape",
            detail=detail or "live __flightrec snapshot",
        )
        if skew:
            bundle = shift_bundle_ts(bundle, skew)
        return {
            "name": self._name,
            "time_us": now_us() + skew,
            "bundle": bundle,
            "peers": sorted(p.name for p in list(self._peers.values())
                            if p.addresses and p.name != self._name),
            "captured": recent_captures(),
        }

    @property
    def name(self):
        return self._name

    def close(self):
        if self._closed:
            return
        self._closed = True
        reg = self.telemetry.registry
        reg.unregister("rpc_inflight_calls", peer=self._name)
        reg.unregister("rpc_peers", peer=self._name)
        for q in self._queues.values():
            q._close()
        for out in self._outgoing.values():
            out.future._set_exception(RpcError("Rpc closed"))

        def shutdown():
            for peer in self._peers.values():
                for conn in peer.conns.values():
                    conn.close()
            for conn in self._anon_conns:
                conn.close()
            # Mounted lanes closed with their conns above; this sweeps
            # offered-but-never-accepted lanes so the creator's segment
            # and doorbell files are unlinked deterministically (the
            # weakref finalizer is only the abandoned-object backstop).
            for entry in list(self._shm_pairs.values()):
                entry["lane"].close()
            self._shm_pairs.clear()
            for server in self._servers:
                server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(shutdown)
            self._thread.join(timeout=5)
        except RuntimeError:
            pass
        self._executor.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- helpers ----------------------------------------------------------------


def _executor_workers() -> int:
    import moolib_tpu_torch

    n = moolib_tpu_torch.get_max_threads()
    return n if n is not None else min(32, (os.cpu_count() or 4))


def _batched_server_loop(queue: Queue, fn: Callable, device,
                         pad_to: Optional[int],
                         telemetry: Optional[Telemetry] = None,
                         target_bs: Optional[int] = None):
    """Server-side dynamic batching for define(batch_size=) (reference:
    src/moolib.cc:1007-1062 — stack requests, one call, unbatch replies).
    With ``device``, the stacked batch reaches ``fn`` as torch tensors on
    that device (the reference's ``jax.device_put``)."""
    from ..ops.batcher import stage_batch
    from ..telemetry import FRACTION_EDGES
    from ..utils import nest

    fill_hist = None
    if telemetry is not None and target_bs:
        fill_hist = telemetry.registry.histogram(
            "rpc_batch_fill_fraction", edges=FRACTION_EDGES,
            endpoint=queue.name,
        )
    while True:
        try:
            return_cb, args, kwargs = queue.get(timeout=1.0)
        except TimeoutError:
            continue
        except RpcError:
            return  # queue closed
        try:
            n = return_cb.batch_size
            if fill_hist is not None and telemetry.on:
                fill_hist.observe(n / target_bs)
            if pad_to is not None and n < pad_to:
                def _pad(x):
                    if isinstance(x, torch.Tensor):  # a bfloat16 leaf
                        return torch.cat(
                            [x, x[:1].expand(pad_to - n, *x.shape[1:])]
                        )
                    reps = np.concatenate(
                        [x, np.repeat(np.asarray(x[:1]), pad_to - n, axis=0)]
                    )
                    return reps
                args = nest.map_structure(_pad, args)
                kwargs = nest.map_structure(_pad, kwargs)
            if device is not None:
                args = stage_batch(args, device)
                kwargs = stage_batch(kwargs, device)
            result = fn(*args, **kwargs)
            if pad_to is not None and n < pad_to:
                result = nest.slice_fields(result, 0, n)
            return_cb(result)
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError) as e:
            # Fail the whole batch to its callers, then propagate.
            return_cb.error(f"{type(e).__name__}: batch cancelled")
            raise
        except Exception as e:
            log.error("batched handler %s failed: %s", queue.name, e)
            return_cb.error(f"{type(e).__name__}: {e}")


# Fraction of sends routed by softmax sampling instead of pure argmin, so a
# transport that measured slow once (and then idled) keeps getting occasional
# traffic to refresh its latency EWMA (reference: the softmax transport
# bandit, src/rpc.cc:640-716; pure argmin never re-explores).
_BANDIT_EXPLORE = 0.05
_bandit_rng = _pyrandom.Random(0x6D6F6F)


#: Tie-break order among equal-EWMA transports: shm (zero-copy, no
#: kernel round-trips) over unix over tcp. Fresh lanes all start at
#: EWMA 0.0, so this rank also decides which unmeasured lane gets the
#: first send — after which real samples take over.
_TRANSPORT_RANK = {"shm": 0, "unix": 1, "tcp": 2}


def _best_conn(peer: _Peer) -> Optional[_Conn]:
    """Min-EWMA-latency live connection (shm, then unix, wins ties),
    with epsilon softmax exploration across transports."""
    conns = list(peer.conns.items())
    if not conns:
        return None
    if len(conns) > 1 and _bandit_rng.random() < _BANDIT_EXPLORE:
        lats = [c.latency.value for _, c in conns]
        lo = min(lats)
        # Temperature tracks the spread so even a much-slower transport
        # keeps a real probability (the whole point is re-measuring it).
        temp = max((max(lats) - lo) / 2.0, 1e-6)
        weights = [math.exp(-(l - lo) / temp) for l in lats]
        r = _bandit_rng.random() * sum(weights)
        for (_, conn), w in zip(conns, weights):
            r -= w
            if r <= 0:
                return conn
        return conns[-1][1]
    best, best_key = None, None
    for t, conn in conns:
        key = (conn.latency.value, _TRANSPORT_RANK.get(t, 3))
        if best_key is None or key < best_key:
            best, best_key = conn, key
    return best


def _split_addr(addr: str) -> Tuple[str, str]:
    if addr.startswith("unix:"):
        return "unix", addr[len("unix:"):]
    if addr.startswith("tcp://"):
        return "tcp", addr[len("tcp://"):]
    return "tcp", addr


def _unix_path(target: str) -> str:
    # Abstract namespace (no filesystem entry), like the reference's
    # abstract unix sockets (src/transports/socket.cc:207-222).
    if target.startswith("\0") or target.startswith("/"):
        return target
    return "\0" + target


def _host_port(target: str) -> Tuple[str, int]:
    host, _, port = target.rpartition(":")
    if not host:
        raise RpcError(f"address {target!r} needs host:port")
    return host, int(port)


def _advertise_host(host: str) -> str:
    if host in ("0.0.0.0", "::", ""):
        return pysocket.gethostbyname(pysocket.gethostname())
    return host
