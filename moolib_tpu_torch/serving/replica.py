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

The RPC binding is not ported yet: requests arrive through
:meth:`Replica.submit`, which hands the same deferred-return shape the
RPC layer would to the same ``_on_infer`` path and returns a
:class:`concurrent.futures.Future`.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..ops.batcher import stage_batch
from ..utils import nest
from ..utils.device import resolve_device
from .admission import AdmissionQueue, DeadlineExceeded, Overloaded, RpcError

__all__ = ["Replica"]

log = logging.getLogger("moolib_tpu_torch.serving")


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


class Replica:
    """A serving replica.

    ``model_fn(params, batch)`` maps a leading-batch-dim structure of
    tensors on ``device`` to a leading-batch-dim structure; ``params``
    (for example the model module itself) is hot-swappable via
    :meth:`set_model`. ``pad=True`` repeats row 0 up to ``batch_size``
    so the model always sees one shape. ``device`` defaults to the card
    and raises without one; pass ``device="cpu"`` to serve on the CPU.
    """

    def __init__(self, rpc: None, model_fn: Callable[[Any, Any], Any],
                 params: Any = None, *, version: int = 0,
                 service: str = "serve", batch_size: int = 8,
                 max_queue: int = 64, linger_s: float = 0.002,
                 device: Optional[Union[str, torch.device]] = None,
                 pad: bool = False, shed_safety: float = 1.0):
        if rpc is not None:
            raise NotImplementedError(
                "Replica has no RPC binding yet (ROADMAP queue A: the RPC "
                "binding of Replica); pass rpc=None and use submit()"
            )
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size!r}")
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
        self.admission = AdmissionQueue(max_queue, service=service,
                                        shed_safety=shed_safety)
        self._worker = threading.Thread(
            target=_serve_entry, args=(weakref.ref(self), self._stop),
            name=f"{service}-serve", daemon=True,
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
        log.info("%s: model swapped to version %s", self.service, version)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful departure: refuse new admissions, serve out what was
        admitted, return True once nothing is queued or in flight."""
        return self.admission.drain(timeout=timeout)

    # -- the batch loop ------------------------------------------------------

    def _serve_once(self):
        """One bounded serve tick (pop + batch)."""
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
        if shed:
            for dr, _x in shed:
                self._reply_error(
                    dr,
                    "DeadlineExceeded: remaining budget cannot cover "
                    "the observed p50 service time (shed in queue)",
                )
            self.admission.fail(len(shed))
        if serve:
            self._run_batch(serve)

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
        """Hard stop: stop the batch loop. For a graceful departure call
        :meth:`drain` first."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.admission.close()
        self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
