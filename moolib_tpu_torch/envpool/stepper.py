"""Multi-client env serving: one EnvPool, many stepper clients over RPC;
the counterpart of :mod:`moolib_tpu.envpool.stepper` on the port's
``Rpc``. The wire is the reference's, so a port :class:`RemoteEnvStepper`
can step a reference ``EnvPoolServer`` and the other way round.

The pool's shared-memory data plane stays process-local to the serving
peer, and clients — local or remote actors — drive it through the
named-peer RPC layer. Usage::

    # env-server peer
    pool = EnvPool(create_env, num_processes=4, batch_size=32, num_batches=4)
    server = EnvPoolServer(rpc, pool)           # defines envpool::* functions

    # any peer (same or different process/host)
    stepper = RemoteEnvStepper(rpc, "env-server")   # acquires a buffer
    fut = stepper.step(actions)                     # -> future of step dict
    out = fut.result(timeout=60)                    # obs/reward/done/stats

Each client owns one of the pool's ``num_batches`` buffers, so clients
double-buffer *against each other*: while client A's batch steps in the
workers, client B's batch is in flight too.

Failure model: a dead env worker surfaces to clients as a retry-safe
``WorkerDied:`` wire error (the serving tier's
:func:`~moolib_tpu_torch.serving.error_kind` taxonomy classifies it
``worker_died``); :meth:`RemoteEnvStepper.step` futures transparently
retry those against the same lease — the pool guarantees a retried step
never re-steps a slice that already completed — and re-acquire the lease
when theirs was reclaimed (``lease_timeout`` expiry after an actor died
silently)."""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from typing import Optional

import numpy as np

from ..rpc import RpcError
from ..telemetry.stepscope import StepScope
from ..utils.logging import get_logger
from .pool import _check_wait_timeout

log = get_logger("envstepper")

__all__ = ["EnvPoolServer", "RemoteEnvStepper"]


class EnvPoolServer:
    """Serve an :class:`EnvPool` to N stepper clients over an ``Rpc`` peer.

    Defines (under ``name::``):
      - ``info()`` -> {batch_size, num_batches, action_shape, action_dtype}
      - ``acquire(client)`` -> dedicated batch index for that client
      - ``release(batch_index)`` -> return a buffer to the free list
      - ``step(batch_index, action, client)`` -> step-result dict. Served
        as a DEFERRED return: the handler dispatches into the pool and
        replies from the pool's completion thread, so N concurrent clients
        occupy zero executor threads while their envs step (the reference
        serves 256 clients on semaphores, src/env.h:46 — not on a
        thread-per-step)

    A dead client's buffer is reclaimed by lease expiry: a buffer whose
    owner hasn't stepped for ``lease_timeout`` seconds may be handed to a
    new client on acquire (an actor SIGKILL must not remove env capacity
    forever — elasticity is the framework's flagship property).

    Worker death inside the pool maps to a retry-safe ``WorkerDied:`` wire
    error (never a hang): the deferred reply carries the exception type as
    its prefix, which :func:`moolib_tpu_torch.serving.error_kind` classifies as
    ``worker_died`` so clients know a same-lease retry is safe.
    """

    def __init__(self, rpc, pool, name: str = "envpool",
                 lease_timeout: float = 60.0):
        if rpc.defined(f"{name}::info"):
            # Refuse BEFORE registering anything: a second server under
            # the same name would silently replace the first one's
            # handlers (same fid) and steal its clients mid-step.
            raise RuntimeError(
                f"an EnvPoolServer named {name!r} is already registered "
                "on this Rpc; pass a distinct name="
            )
        self.rpc = rpc
        self.pool = pool
        self.name = name
        self.lease_timeout = lease_timeout
        self._lock = threading.Lock()
        self._closed = False
        self._free = list(range(pool.num_batches))
        self._owners: dict = {}
        self._last_step: dict = {}
        self._inflight: dict = {}  # batch_index -> EnvStepperFuture
        # Telemetry (per-Rpc registry): served-step latency + lease churn
        # + the step-error taxonomy the failover path rides on.
        reg = rpc.telemetry.registry
        self._m_steps = reg.counter("envpool_served_steps_total", pool=name)
        self._m_step_dur = reg.histogram(
            "envpool_served_step_seconds", pool=name
        )
        self._m_reclaims = reg.counter(
            "envpool_lease_reclaims_total", pool=name
        )
        self._m_step_errors = reg.counter(
            "envpool_served_step_errors_total", pool=name
        )
        # Step-phase attribution: every served
        # step is one batch_fill-shaped step of the serving loop — the
        # server never blocks a thread on it (deferred reply), so the
        # whole dispatch->completion span is fill time, stamped from the
        # completion callback via the overlap-safe observe_step path.
        self._scope = StepScope(f"{name}_served", telemetry=rpc.telemetry)
        # Weakref: the registry outlives this server; a strong `self`
        # would pin the pool's shared-memory slabs after close(), which
        # also unregisters these series.
        wself = weakref.ref(self)
        reg.gauge_fn("envpool_buffers_free", lambda: len(wself()._free),
                     pool=name)
        reg.gauge_fn("envpool_clients", lambda: len(wself()._owners),
                     pool=name)
        rpc.define(f"{name}::info", self._info)
        rpc.define(f"{name}::acquire", self._acquire)
        rpc.define(f"{name}::release", self._release)
        rpc.define_deferred(f"{name}::step", self._step)

    def _info(self):
        action = self.pool._views[0]["action"]
        return {
            "batch_size": self.pool.batch_size,
            "num_batches": self.pool.num_batches,
            "action_shape": tuple(action.shape[1:]),
            "action_dtype": str(action.dtype),
        }

    def _acquire(self, client: str):
        with self._lock:
            if not self._free:
                self._reclaim_expired_locked()
            if not self._free:
                raise RuntimeError(
                    f"all {self.pool.num_batches} env buffers are taken; "
                    "raise num_batches to serve more concurrent clients"
                )
            # A buffer whose last step FAILED (WorkerDied) still carries
            # the previous owner's repair state; handing it out as-is
            # would make the new client's first step a same-action retry
            # of the OLD owner's action (its action silently ignored).
            # reset_batch forgets that state — or reports the failed
            # batch is still settling (a surviving worker mid-step), in
            # which case the lease is refused fast and the client
            # re-acquires momentarily.
            for i, cand in enumerate(self._free):
                if self.pool.reset_batch(cand):
                    idx = self._free.pop(i)
                    break
            else:
                raise RuntimeError(
                    "env buffers are settling after a worker failure; "
                    "re-acquire shortly"
                )
            self._owners[idx] = client
            self._last_step[idx] = time.monotonic()
            log.info("env buffer %d -> client %s", idx, client)
            return idx

    def _reclaim_expired_locked(self):
        now = time.monotonic()
        for idx, owner in list(self._owners.items()):
            if (
                now - self._last_step.get(idx, now) > self.lease_timeout
                and not self.pool.busy(idx)
            ):
                log.warning(
                    "reclaiming env buffer %d from silent client %s",
                    idx, owner,
                )
                self._m_reclaims.inc()
                del self._owners[idx]
                self._free.append(idx)

    def _release(self, batch_index: int, client: Optional[str] = None):
        with self._lock:
            owner = self._owners.get(batch_index)
            if owner is None:
                return False
            if client is not None and owner != client:
                # Stale release from a lease-evicted client: the buffer
                # belongs to someone else now — do not free it under them.
                return False
            del self._owners[batch_index]
        # Decide under the same lock that _step dispatches under: busy=True
        # implies _inflight holds the CURRENT step's future (dispatch and
        # bookkeeping are atomic in _step), so the busy-with-stale-future
        # and busy-with-no-future races cannot occur.
        with self._lock:
            busy = self.pool.busy(batch_index)
            inflight = self._inflight.get(batch_index) if busy else None
            if not busy:
                self._free.append(batch_index)
                return True
        # The closing client still has a step executing; freeing the buffer
        # now would hand the next client a busy buffer. Free it from the
        # pool's completion callback instead of polling.

        def free_after(_fut):
            with self._lock:
                if not self.pool.busy(batch_index):
                    self._free.append(batch_index)
                else:
                    log.warning(
                        "env buffer %d still busy after release; leaked",
                        batch_index,
                    )

        inflight.add_done_callback(free_after)
        return True

    def _step(self, deferred, batch_index: int, action,
              client: Optional[str] = None):
        # Ownership check: a stale step racing a release/re-acquire must
        # never touch a buffer that now belongs to someone else.
        with self._lock:
            owner = self._owners.get(batch_index)
            if client is not None and owner != client:
                raise RuntimeError(
                    f"env buffer {batch_index} is not owned by {client!r} "
                    f"(owner: {owner!r}); re-acquire before stepping"
                )
            self._last_step[batch_index] = time.monotonic()
            # Dispatch + bookkeeping atomically: _release's busy check under
            # this lock must always see the future belonging to the current
            # in-flight step (never busy-without-future or a stale one).
            # pool.step raises WorkerDied synchronously while a replacement
            # worker is respawning — the executor's error reply carries the
            # type-name prefix, so the client's retry loop sees it typed.
            fut = self.pool.step(batch_index, np.asarray(action))
            self._inflight[batch_index] = fut
        tel_on = self.rpc.telemetry.on
        if tel_on:
            self._m_steps.inc()
        t0 = time.monotonic()

        # Reply from the pool's completion thread: no serving thread is
        # held while the workers step (the backpressure the old blocking
        # handler provided comes from the deferred reply instead).
        def on_done(f):
            if tel_on:
                dur = time.monotonic() - t0
                self._m_step_dur.observe(dur)
                self._scope.observe_step(dur, {"batch_fill": dur})
            try:
                deferred(f.result(timeout=0))
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError) as e:
                # Tell the waiting client the step died, then PROPAGATE
                # the cancellation instead of eating it.
                deferred.error(f"{type(e).__name__}: step cancelled")
                raise
            except Exception as e:
                # The type-name prefix IS the wire taxonomy: "WorkerDied:
                # ..." classifies as worker_died (retry-safe) client-side.
                self._m_step_errors.inc()
                deferred.error(f"{type(e).__name__}: {e}")

        fut.add_done_callback(on_done)

    def close(self):
        if self._closed:  # the close() idempotence contract
            return
        self._closed = True
        self._scope.close()
        reg = self.rpc.telemetry.registry
        for gname in ("envpool_buffers_free", "envpool_clients"):
            reg.unregister(gname, pool=self.name)
        for fn in ("info", "acquire", "release", "step"):
            try:
                self.rpc.undefine(f"{self.name}::{fn}")
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow cancellation, even in teardown
            except Exception:
                pass


class _RetryingStepFuture:
    """Future for one logical remote step, with transparent failover.

    ``result()`` retries *safe* failures: ``worker_died`` wire errors
    (the pool's exactly-once retry contract makes a same-action re-step
    safe) and lease loss (``not owned`` — the server reclaimed the lease
    while this client was silent; re-acquire, then re-step). Retries use
    capped-exponential backoff and are bounded by ``max_retries`` and the
    caller's ``result`` timeout. Follows the ``Future`` contract:
    ``timeout=None`` waits forever, ``0`` is a non-blocking poll (no
    retries — retrying requires waiting), negative/non-finite raise
    ``ValueError``."""

    def __init__(self, stepper: "RemoteEnvStepper", action):
        self._stepper = stepper
        self._action = action
        self._attempts = 0
        self._fut = stepper._send(action)

    def result(self, timeout: Optional[float] = None):
        timeout = _check_wait_timeout(timeout, "step.result")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        st = self._stepper
        while True:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            try:
                return self._fut.result(left)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except RpcError as e:
                from ..serving import error_kind

                msg = str(e)
                st.last_error = msg
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if (self._attempts >= st.max_retries
                        or (remaining is not None and remaining <= 0)):
                    raise
                if error_kind(e) == "worker_died":
                    pass  # same lease; the pool's retry is exactly-once
                elif "not owned" in msg or "re-acquire" in msg:
                    st._reacquire()  # lease was reclaimed: take a new one
                else:
                    raise  # not a failure class a retry can fix
                self._attempts += 1
                st.retries_total += 1
                delay = min(st.retry_backoff_cap,
                            st.retry_backoff * (2 ** (self._attempts - 1)))
                if remaining is not None:
                    delay = min(delay, remaining)
                time.sleep(delay)
                self._fut = st._send(self._action)

    def exception(self, timeout: Optional[float] = None):
        timeout = _check_wait_timeout(timeout, "step.exception")
        try:
            self.result(timeout)
            return None
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except TimeoutError:
            raise  # the WAIT timed out: the step is not done yet
        except Exception as e:
            return e


class RemoteEnvStepper:
    """Client handle: step a (possibly remote) peer's EnvPool.

    Acquires a dedicated buffer on construction; ``step`` is asynchronous,
    so N clients (threads, processes, or hosts) overlap their batches in
    the one pool's workers. Step futures transparently retry
    ``worker_died`` failures (same lease, same action — exactly-once by
    the pool's repair contract) and re-acquire a reclaimed lease; pass
    ``retry=False`` to get the raw RPC future instead.
    """

    def __init__(self, rpc, server: str, name: str = "envpool",
                 timeout: float = 60.0, max_retries: int = 8,
                 retry_backoff: float = 0.05,
                 retry_backoff_cap: float = 1.0):
        self.rpc = rpc
        self.server = server
        self.name = name
        self.timeout = timeout
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_backoff_cap = float(retry_backoff_cap)
        self.retries_total = 0
        self.reacquires_total = 0
        self.last_error: Optional[str] = None
        info = rpc.async_(server, f"{name}::info").result(timeout)
        self.batch_size = info["batch_size"]
        self.num_batches = info["num_batches"]
        self.batch_index = rpc.async_(
            server, f"{name}::acquire", rpc.get_name()
        ).result(timeout)
        self._closed = False

    def _send(self, action):
        return self.rpc.async_(
            self.server, f"{self.name}::step", self.batch_index,
            action, self.rpc.get_name(),
        )

    def _reacquire(self):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                self.batch_index = self.rpc.async_(
                    self.server, f"{self.name}::acquire", self.rpc.get_name()
                ).result(self.timeout)
                break
            except RpcError as e:
                # A freed buffer can briefly refuse leases while a failed
                # batch settles (a surviving worker mid-step) — that is a
                # retry-in-a-moment, not a refusal.
                if "settling" in str(e) and time.monotonic() < deadline:
                    time.sleep(0.05)
                    continue
                raise
        self.reacquires_total += 1
        log.warning("lease re-acquired: env buffer %d", self.batch_index)

    def step(self, action, *, retry: bool = True):
        """Async batched step on this client's buffer -> future of the
        step-result dict (obs fields, reward, done, episode stats). With
        ``retry=True`` (default) the future fails over per the class
        docstring; ``retry=False`` returns the raw RPC future."""
        if self._closed:
            raise RuntimeError("RemoteEnvStepper is closed")
        action = np.asarray(action)
        if not retry:
            return self._send(action)
        return _RetryingStepFuture(self, action)

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self.rpc.async_(
                    self.server, f"{self.name}::release", self.batch_index,
                    self.rpc.get_name(),
                ).result(10.0)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # cancellation propagates; lease expiry reclaims
            except Exception:
                pass  # server gone: buffer dies with it
