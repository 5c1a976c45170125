"""Model replica: admission-controlled dynamic batching of inference
requests, health snapshot, hot model swap, graceful drain.

The counterpart of :mod:`moolib_tpu.serving.replica` with the same batch
loop: admission (bounded queue, deadline shed, ``Overloaded`` /
``DeadlineExceeded`` refusals as explicit errors), then a worker thread
that coalesces admitted requests (up to ``batch_size``, with a short
linger), stacks them, optionally pads to a static shape, stages them to
the device with :func:`~moolib_tpu_torch.ops.batcher.stage_batch`, runs
``model_fn(params, batch)`` and unbatches the replies, copied back to
numpy.

Bound to an :class:`~moolib_tpu_torch.rpc.Rpc` (``Replica(rpc, ...)``),
the replica owns four endpoints on it, named ``{service}.*`` so several
services can share a peer:

- ``{service}.infer(x)`` — one request (deadline from the caller's
  ``call_with_deadline``), answered with the reply;
- ``{service}.health()`` — the router's probe: inflight, queue,
  latency, ``draining`` and ``model_version``;
- ``{service}.load(params, version)`` — hot model swap; for a module,
  ``params`` is its state_dict as it arrives off the wire (numpy
  leaves, or ``bfloat16`` tensors);
- ``{service}.drain()`` — graceful departure.

With ``rpc=None`` requests arrive through :meth:`Replica.submit`, which
hands the same deferred-return shape the RPC layer would to the same
``_on_infer`` path and returns a :class:`concurrent.futures.Future`.

Telemetry (``service``-labelled, as in the reference):
``serving_batches_total``, ``serving_batch_rows_total``, the
``serving_batch_fill_fraction`` histogram, the ``serving_model_version``
and ``serving_inflight`` gauges, the admission queue's ``serving_*``
series, and the ``{service}_replica`` step-phase ledger (``queue_wait``,
``linger``, ``infer`` per served batch).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import copy
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..ops.batcher import stage_batch
from ..rpc import Rpc, RpcError
from ..telemetry import FRACTION_EDGES, Telemetry, global_telemetry
from ..telemetry.stepscope import StepScope
from ..utils import nest
from ..utils.device import resolve_device
from .admission import AdmissionQueue, DeadlineExceeded, Overloaded

__all__ = ["Replica", "ENDPOINT_SUFFIXES"]

log = logging.getLogger("moolib_tpu_torch.serving")

#: The endpoint family a bound Replica registers: ``{service}.{suffix}``.
ENDPOINT_SUFFIXES = ("infer", "health", "load", "drain")


class _LocalDeferredReturn:
    """Reply handle of one local request, shaped like the RPC layer's
    deferred return: call it with the value, or ``.error(message)``;
    ``deadline`` is the request's monotonic deadline or None."""

    __slots__ = ("_future", "deadline")

    def __init__(self, future: concurrent.futures.Future,
                 deadline: Optional[float]):
        self._future = future
        self.deadline = deadline

    def __call__(self, value=None):
        self._future.set_result(value)

    def error(self, message: str):
        self._future.set_exception(RpcError(message))


def _serve_entry(wref, stop):
    """Serve-thread entry: the thread holds the Replica only for one
    bounded batch tick (a 0.1s pop plus any admitted batch), so a replica
    dropped without close() is still collectable."""
    while not stop.is_set():
        replica = wref()
        if replica is None:
            return
        replica._serve_once()
        del replica


def _to_host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _wire_tensor(x) -> torch.Tensor:
    """A state_dict leaf as it arrives off the wire (a read-only numpy
    view, or a ``bfloat16`` tensor over the receive buffer) as a tensor
    of its own."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return torch.from_numpy(np.array(x))


class Replica:
    """A serving replica.

    ``model_fn(params, batch)`` maps a leading-batch-dim structure of
    tensors on ``device`` to a leading-batch-dim structure; ``params``
    (for example the model module itself) is hot-swappable via
    :meth:`set_model`. ``pad=True`` repeats row 0 up to ``batch_size``
    so the model always sees one shape. ``device`` defaults to the card
    and raises without one; pass ``device="cpu"`` to serve on the CPU.

    Bound to ``rpc`` it records into ``rpc.telemetry`` (unless
    ``telemetry`` is given), its gauges labelled ``peer=rpc.get_name()``,
    and refuses a service whose endpoints are already defined there.
    Without an RPC binding the replica has no peer identity: it records
    into ``telemetry`` (default :func:`~moolib_tpu_torch.telemetry.
    global_telemetry`) with no ``peer`` label. So run at most one live
    unbound replica per ``service`` on one ``Telemetry``: a second one
    would replace the first's gauges (``serving_inflight``, the queue
    depth, the scope's fractions), and closing either unregisters them.
    """

    def __init__(self, rpc: Optional[Rpc],
                 model_fn: Callable[[Any, Any], Any],
                 params: Any = None, *, version: int = 0,
                 service: str = "serve", batch_size: int = 8,
                 max_queue: int = 64, linger_s: float = 0.002,
                 device: Optional[Union[str, torch.device]] = None,
                 pad: bool = False, shed_safety: float = 1.0,
                 telemetry: Optional[Telemetry] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size!r}")
        if rpc is not None:
            for suffix in ENDPOINT_SUFFIXES:
                name = f"{service}.{suffix}"
                if rpc.defined(name):
                    # A silent re-define would clobber another service's
                    # handlers.
                    raise RpcError(
                        f"endpoint {name!r} is already defined on this "
                        "Rpc: another Replica (or service) with the same "
                        "service name is registered; pick a distinct "
                        "service="
                    )
        self.rpc = rpc
        self._peer = rpc.get_name() if rpc is not None else None
        self.service = service
        self.batch_size = int(batch_size)
        self.linger_s = float(linger_s)
        self.device = resolve_device(device)
        self.pad = bool(pad)
        self._model_fn = model_fn
        self._model_lock = threading.Lock()
        self._params = params
        self._version = int(version)
        self._closed = False
        self._stop = threading.Event()

        if telemetry is not None:
            tel = telemetry
        else:
            tel = rpc.telemetry if rpc is not None else global_telemetry()
        reg = tel.registry
        self._tel = tel
        # The peer label keeps two same-service replicas sharing one
        # Telemetry from replacing or cross-unregistering each other's
        # gauges (the Rpc inflight/peers gauge rule).
        self._gauge_labels = {"service": service}
        if self._peer is not None:
            self._gauge_labels["peer"] = self._peer
        self.admission = AdmissionQueue(max_queue, service=service,
                                        peer=self._peer, telemetry=tel,
                                        shed_safety=shed_safety)
        self._m_batches = reg.counter("serving_batches_total",
                                      service=service)
        self._m_rows = reg.counter("serving_batch_rows_total",
                                   service=service)
        self._m_fill = reg.histogram("serving_batch_fill_fraction",
                                     edges=FRACTION_EDGES, service=service)
        self._m_version = reg.gauge("serving_model_version", service=service)
        self._m_version.set(float(self._version))
        # Step-phase attribution: each served batch is one step of the
        # serve loop — queue_wait (blocked in get_batch before the first
        # entry), linger (the deliberate coalescing window), infer
        # (stack/stage/model/replies). Idle ticks that pop nothing record
        # no step, so the fractions describe served traffic.
        self._scope = StepScope(f"{service}_replica", telemetry=tel)
        # Weakref gauge: a shared or global Telemetry must never pin a
        # closed replica; close() unregisters the series.
        wself = weakref.ref(self)
        reg.gauge_fn("serving_inflight",
                     lambda: wself().admission.inflight,
                     **self._gauge_labels)

        if rpc is not None:
            rpc.define_deferred(f"{service}.infer", self._on_infer)
            rpc.define(f"{service}.health", self.health)
            rpc.define(f"{service}.load", self._on_load)
            rpc.define_deferred(f"{service}.drain", self._on_drain)

        prefix = f"{self._peer}-" if self._peer is not None else ""
        self._worker = threading.Thread(
            target=_serve_entry, args=(weakref.ref(self), self._stop),
            name=f"{prefix}{service}-serve", daemon=True,
        )
        self._worker.start()

    # -- requests ------------------------------------------------------------

    def submit(self, x: Any, deadline: Optional[float] = None
               ) -> concurrent.futures.Future:
        """Submit one request (a structure of numpy arrays without the
        batch axis); ``deadline`` is a ``time.monotonic()`` instant. The
        future resolves to the reply (numpy leaves) or raises
        :class:`RpcError` whose message starts ``Overloaded:`` or
        ``DeadlineExceeded:`` on a refusal."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._on_infer(_LocalDeferredReturn(fut, deadline), x)
        return fut

    def _on_infer(self, dr, x):
        try:
            self.admission.admit((dr, x), deadline=dr.deadline)
        except Overloaded as e:
            dr.error(f"Overloaded: {e}")
        except DeadlineExceeded as e:
            dr.error(f"DeadlineExceeded: {e}")

    def health(self) -> Dict[str, Any]:
        """Load/liveness snapshot, cheap enough to answer under full load
        (it never touches the model lock)."""
        adm = self.admission
        return {
            "name": self._peer,
            "service": self.service,
            "inflight": adm.inflight,
            "queue_depth": adm.depth,
            "capacity": adm.capacity,
            "p50_service_s": adm.service_p50(),
            "draining": adm.draining,
            "model_version": self._version,
            "batch_size": self.batch_size,
        }

    # -- model management ----------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    def set_model(self, params: Any, version: int) -> None:
        """Hot model swap: the new params serve from the next batch; the
        batch in flight keeps the params it captured."""
        with self._model_lock:
            self._params = params
            self._version = int(version)
        self._m_version.set(float(version))
        log.info("%s%s: model swapped to version %s",
                 f"{self._peer}/" if self._peer else "", self.service,
                 version)

    def _on_load(self, params, version):
        """The ``load`` endpoint. When the served params are a module,
        ``params`` is a state_dict off the wire: it is loaded into a copy
        of the module (on the module's device), and the copy is swapped
        in, so the batch in flight keeps the module it captured."""
        with self._model_lock:
            current = self._params
        if isinstance(current, torch.nn.Module):
            module = copy.deepcopy(current)
            module.load_state_dict(
                {k: _wire_tensor(v) for k, v in params.items()}
            )
            params = module
        self.set_model(params, version)
        return int(version)

    def _on_drain(self, dr):
        ok = self.drain(timeout=60.0)
        dr({"drained": bool(ok), "name": self._peer})

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful departure: refuse new admissions, serve out what was
        admitted, return True once nothing is queued or in flight."""
        return self.admission.drain(timeout=timeout)

    # -- the batch loop ------------------------------------------------------

    def _serve_once(self):
        """One bounded serve tick (pop + batch)."""
        t_tick = time.monotonic()
        try:
            serve, shed = self.admission.get_batch(
                self.batch_size, timeout=0.1, linger=self.linger_s
            )
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            log.error("serve loop pop failed: %s", e)
            return
        pop_s = time.monotonic() - t_tick
        if shed:
            for dr, _x in shed:
                self._reply_error(
                    dr,
                    "DeadlineExceeded: remaining budget cannot cover "
                    "the observed p50 service time (shed in queue)",
                )
            self.admission.fail(len(shed), shed=True)
        if not serve:
            return
        infer_s = self._run_batch(serve)
        if infer_s is not None and self._tel.on:
            # get_batch blocks for the first entry, then lingers up to
            # linger_s to coalesce — the split below attributes at most
            # the configured linger to the coalescing window and the
            # rest of the pop to queue_wait (the exact boundary is
            # internal to the admission queue's condvar).
            wall = time.monotonic() - t_tick
            linger = min(pop_s, self.linger_s) if self.linger_s > 0 else 0.0
            self._scope.observe_step(wall, {
                "queue_wait": max(pop_s - linger, 0.0),
                "linger": linger,
                "infer": infer_s,
            })

    def _run_batch(self, serve) -> Optional[float]:
        """Serve one admitted batch; returns the batch service time in
        seconds, or None when the batch failed (callers got errors)."""
        n = len(serve)
        t0 = time.monotonic()
        with self._model_lock:
            params = self._params
        xs = [x for _dr, x in serve]
        try:
            batch = nest.stack_fields(xs)
            if self.pad and n < self.batch_size:
                # Static-shape padding: repeat row 0, slice the reply
                # back to the real rows.
                def _pad(x):
                    return np.concatenate(
                        [x, np.repeat(np.asarray(x[:1]),
                                      self.batch_size - n, axis=0)]
                    )

                batch = nest.map_structure(_pad, batch)
            batch = stage_batch(batch, self.device)
            with torch.no_grad():  # grad mode is per thread
                out = self._model_fn(params, batch)
            out = nest.map_structure(_to_host, out)
            if self.pad and n < self.batch_size:
                out = nest.slice_fields(out, 0, n)
            results = nest.unstack_fields(out, n)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            for dr, _x in serve:
                self._reply_error(dr, "CancelledError: batch cancelled")
            self.admission.fail(n)
            raise
        except Exception as e:
            log.error("%s: model batch failed: %s", self.service, e)
            for dr, _x in serve:
                self._reply_error(dr, f"{type(e).__name__}: {e}")
            self.admission.fail(n)
            return None
        dt = time.monotonic() - t0
        for (dr, _x), r in zip(serve, results):
            self._reply(dr, r)
        self.admission.done(n, dt / n)
        if self._tel.on:
            self._m_batches.inc()
            self._m_rows.inc(n)
            self._m_fill.observe(n / self.batch_size)
        return dt

    @staticmethod
    def _reply(dr, value):
        try:
            dr(value)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            log.debug("reply dropped: %s", e)

    @staticmethod
    def _reply_error(dr, msg):
        try:
            dr.error(msg)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            log.debug("error reply dropped: %s", e)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Hard stop: undefine the endpoint family (when bound), stop the
        batch loop and unregister this replica's gauges (its counters and
        histograms stay, like every cumulative series). For a graceful
        departure call :meth:`drain` first."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self.rpc is not None:
            for suffix in ENDPOINT_SUFFIXES:
                self.rpc.undefine(f"{self.service}.{suffix}")
        self.admission.close()
        self._worker.join(timeout=5)
        self._scope.close()
        self._tel.registry.unregister("serving_inflight",
                                      **self._gauge_labels)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
