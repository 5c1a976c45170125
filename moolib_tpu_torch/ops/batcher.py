"""Dynamic tensor batcher and the host-to-device staging of a completed
batch; the counterpart of :mod:`moolib_tpu.ops.batcher`.

Nested dict/list/tuple structures of tensors or numpy arrays are
accumulated with either ``stack`` (new leading batch dim; only full
batches are emitted) or ``cat`` (concatenate along an existing dim;
overflow past ``batch_size`` is split and carried into the next batch).
``get`` blocks until a completed batch exists.

With a ``device``, a completed batch is assembled on the host and moved
by :func:`stage_batch` on the producer's thread; the consumer's stream
waits on an event recorded after that upload, so a batch is never read
on the card before it has landed. Card leaves (an LSTM state the act
step left on the card) stay where they are: ``cat`` concatenates them
on the card without a host sync.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Union

import numpy as np
import torch

from ..telemetry import global_telemetry
from ..utils import nest

__all__ = ["Batcher", "stage_batch"]


def stage_batch(batch: Any, device: Union[str, torch.device]) -> Any:
    """Every leaf becomes a contiguous host tensor and moves to ``device``.

    For a CUDA device the host copy is pinned and the upload is
    asynchronous on the current stream, so it overlaps whatever the host
    does next; the caching host allocator keeps the pinned block alive
    until the copy has run."""
    device = torch.device(device)

    def _stage(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x)
        )
        if device.type == "cuda" and t.device.type == "cpu":
            return t.contiguous().pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return nest.map_structure(_stage, batch)


def _structure(tree: Any) -> Any:
    """``tree`` with every leaf replaced by 0: equal for equal structures."""
    return nest.map_structure(lambda _: 0, tree)


class _Slot:
    """Ordered placeholder in the ready queue: reserved under the lock at
    batch-completion time, filled outside the lock after host assembly and
    (optional) H2D staging, so transfers never block other producers or
    consumers on the Condition. ``event`` is recorded after a card
    upload on the producer's stream; the consumer's stream waits on it."""

    __slots__ = ("batch", "done", "event")

    def __init__(self):
        self.batch = None
        self.done = False
        self.event = None


class Batcher:
    def __init__(
        self,
        batch_size: int,
        device: Optional[Any] = None,
        dim: int = 0,
        dims: Optional[dict] = None,
        name: str = "batcher",
    ):
        """``dims`` maps top-level dict keys to a per-key batch axis
        overriding ``dim`` — e.g. learn-unrolls are [T, B, ...] (dim=1) but
        their ``core_state`` leaves are [B, ...] (dims={'core_state': 0}).
        ``name`` labels this batcher's telemetry series (several batchers
        sharing a name share counters). ``device`` (None: batches stay on
        the host) is where completed batches are staged."""
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = batch_size
        self.device = None if device is None else torch.device(device)
        self.dim = dim
        self.dims = dict(dims) if dims else None
        self._lock = threading.Condition()
        self._pending_stack: list = []  # items awaiting a full stack batch
        self._pending_cat: list = []  # trees awaiting cat; rows counted below
        self._pending_cat_rows = 0
        self._ready: deque = deque()  # completed (host-side) batches
        self._closed = False
        self._async_waiters: list = []  # (loop, asyncio.Event) for __await__
        # Telemetry (process-global registry: batchers have no peer
        # identity): emitted batches/rows + time-to-fill per batch.
        self._tel = global_telemetry()
        reg = self._tel.registry
        self._m_batches = reg.counter("batcher_batches_total", batcher=name)
        self._m_rows = reg.counter("batcher_rows_total", batcher=name)
        self._m_fill_dur = reg.histogram("batcher_fill_seconds",
                                         batcher=name)
        self._fill_t0: Optional[float] = None  # first item of current batch

    # -- producer side ------------------------------------------------------

    def stack(self, tree: Any) -> None:
        """Add one unbatched structure; emits when batch_size items gathered."""
        with self._lock:
            self._check_open()
            if self._tel.on and not self._pending_stack:
                self._fill_t0 = time.monotonic()
            self._pending_stack.append(tree)
            if len(self._pending_stack) < self.batch_size:
                return
            items, self._pending_stack = (
                self._pending_stack[: self.batch_size],
                self._pending_stack[self.batch_size :],
            )
            slot = _Slot()
            self._ready.append(slot)
            self._record_emit_locked(1, self.batch_size)
        # Assemble + stage outside the lock.
        self._fill(slot, *self._stage(self._stack_trees(items)))

    def cat(self, tree: Any) -> None:
        """Add an already-batched structure; splits/carries past batch_size."""
        with self._lock:
            self._check_open()
            treedef = _structure(tree)
            rows = None
            for key, sub in self._keyed(tree):
                ax = self._axis_for(key)
                for leaf in nest.flatten(sub):
                    r = leaf.shape[ax]
                    if rows is None:
                        rows = r
                    elif r != rows:
                        raise ValueError(
                            f"inconsistent batch axis in cat(): {r} != {rows}"
                        )
            if rows is None:
                raise ValueError("cat() of an empty structure")
            if self._pending_cat:
                prev = _structure(self._pending_cat[0])
                if treedef != prev:
                    raise ValueError(
                        f"cat() tree structure mismatch: {treedef} != {prev}"
                    )
            if self._tel.on and not self._pending_cat:
                self._fill_t0 = time.monotonic()
            self._pending_cat.append(tree)
            self._pending_cat_rows += rows
            if self._pending_cat_rows < self.batch_size:
                return
            # One merge, then all full-batch slices in a single pass.
            merged = (
                self._cat_trees(self._pending_cat)
                if len(self._pending_cat) > 1
                else self._pending_cat[0]
            )
            total = self._pending_cat_rows
            n_full, remainder = divmod(total, self.batch_size)
            raws = [
                self._slice_tree(
                    merged, i * self.batch_size, (i + 1) * self.batch_size
                )
                for i in range(n_full)
            ]
            if remainder:
                rest = self._slice_tree(merged, total - remainder, total)
                # Copy: a view would pin the whole merged buffer in memory
                # (a card leaf's copy is queued on its stream, no sync).
                self._pending_cat = [
                    nest.map_structure(
                        lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else np.array(x),
                        rest,
                    )
                ]
            else:
                self._pending_cat = []
            self._pending_cat_rows = remainder
            slots = [_Slot() for _ in raws]
            self._ready.extend(slots)
            self._record_emit_locked(len(slots), len(slots) * self.batch_size)
        # Stage the emitted batches outside the lock, in reserved order.
        for slot, raw in zip(slots, raws):
            self._fill(slot, *self._stage(raw))

    def flush(self) -> bool:
        """Emit whatever is pending as a *partial* batch (leading dim <
        ``batch_size``). Returns True when a batch was emitted, False when
        nothing was pending.

        The serving-style dynamic-batching primitive: a latency-bound
        consumer that has waited its linger budget takes the short batch
        now instead of holding requests hostage for a full one. Consumers
        that rely on static shapes (jitted handlers) should pad the
        result themselves or avoid flush()."""
        with self._lock:
            self._check_open()
            if self._pending_stack:
                items, self._pending_stack = self._pending_stack, []
                slot = _Slot()
                self._ready.append(slot)
                self._record_emit_locked(1, len(items))
                raw = None
            elif self._pending_cat:
                items = None
                raw = (
                    self._cat_trees(self._pending_cat)
                    if len(self._pending_cat) > 1
                    else self._pending_cat[0]
                )
                rows = self._pending_cat_rows
                self._pending_cat = []
                self._pending_cat_rows = 0
                slot = _Slot()
                self._ready.append(slot)
                self._record_emit_locked(1, rows)
            else:
                return False
        # Assemble + stage outside the lock (same contract as stack/cat).
        batch = raw if items is None else self._stack_trees(items)
        self._fill(slot, *self._stage(batch))
        return True

    # -- consumer side ------------------------------------------------------

    def empty(self) -> bool:
        """True when no completed batch is ready (reference get/empty contract)."""
        with self._lock:
            return not (self._ready and self._ready[0].done)

    def ready(self) -> int:
        """Number of completed batches waiting to be consumed — lets callers
        apply backpressure (drop/skip) instead of queueing unboundedly."""
        with self._lock:
            return sum(1 for s in self._ready if s.done)

    def size(self) -> int:
        """Reference-surface alias for :meth:`ready` (reference:
        BatcherWrapper::size, src/moolib.cc:1915 — 'size of the batched
        queue')."""
        return self.ready()

    def __await__(self):
        """Awaitable get(): ``await batcher`` yields the next completed
        batch without blocking the event loop (reference: the Batcher is
        awaitable with asyncio, BatcherWrapper::await, src/moolib.cc:1929).

        Event-driven and cancel-safe: the awaiter registers an
        asyncio.Event that producers set via call_soon_threadsafe (the
        Queue.get_async pattern) — no idle wakeups, no added delivery
        latency, and a cancelled awaiter consumes nothing (a blocking
        ``get`` parked on an executor would survive cancellation, hang
        shutdown, and steal the next batch from the caller's fallback
        path)."""
        import asyncio

        async def anext_batch():
            loop = asyncio.get_running_loop()
            while True:
                event = asyncio.Event()
                with self._lock:
                    if self._ready and self._ready[0].done:
                        slot = self._ready.popleft()
                        # Wake producers parked in wait_below.
                        self._lock.notify_all()
                        return self._consume(slot)
                    if self._closed:
                        raise RuntimeError("Batcher is closed")
                    self._async_waiters.append((loop, event))
                await event.wait()

        return anext_batch().__await__()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Block until a completed batch is available and return it.

        Raises TimeoutError on timeout and RuntimeError if closed while
        waiting with nothing buffered.
        """
        with self._lock:
            if not self._lock.wait_for(
                lambda: (self._ready and self._ready[0].done) or self._closed,
                timeout=timeout,
            ):
                raise TimeoutError("Batcher.get timed out")
            if not (self._ready and self._ready[0].done):
                raise RuntimeError("Batcher is closed")
            slot = self._ready.popleft()
            # Wake producers parked in wait_below (backpressure release).
            self._lock.notify_all()
        return self._consume(slot)

    def wait_below(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until fewer than ``n`` completed batches are queued (or the
        batcher closes). The event-driven producer-side backpressure
        primitive: wakes on actual consumption instead of polling
        ``ready()`` in a sleep loop. Returns False on timeout."""
        with self._lock:
            return self._lock.wait_for(
                lambda: self._closed
                or sum(1 for s in self._ready if s.done) < n,
                timeout=timeout,
            )

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
            waiters, self._async_waiters = self._async_waiters, []
        for loop, event in waiters:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass

    # -- internals ----------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Batcher is closed")

    def _record_emit_locked(self, n_batches: int, n_rows: int) -> None:
        """Telemetry at batch-completion time (under self._lock)."""
        if not self._tel.on:
            return
        self._m_batches.inc(n_batches)
        self._m_rows.inc(n_rows)
        now = time.monotonic()
        if self._fill_t0 is not None:
            self._m_fill_dur.observe(now - self._fill_t0)
        # cat() carry-over rows start the next batch's fill immediately —
        # without restamping here, the "first item" stamps in add()/cat()
        # never fire again (pending is never empty) and the fill histogram
        # goes silent after the first remainder.
        self._fill_t0 = (
            now if (self._pending_stack or self._pending_cat) else None
        )

    # Per-key batch-axis plumbing (dims=): a top-level dict key may carry its
    # batch dimension on a different axis than self.dim.

    def _axis_for(self, key) -> int:
        if key is None or not self.dims:
            return self.dim
        return self.dims.get(key, self.dim)

    def _keyed(self, tree):
        if self.dims and isinstance(tree, dict):
            return list(tree.items())
        return [(None, tree)]

    def _stack_trees(self, items):
        if self.dims and isinstance(items[0], dict):
            return {
                k: nest.stack_fields(
                    [it[k] for it in items], axis=self._axis_for(k)
                )
                for k in items[0]
            }
        return nest.stack_fields(items, axis=self.dim)

    def _cat_trees(self, trees):
        if self.dims and isinstance(trees[0], dict):
            return {
                k: nest.cat_fields(
                    [t[k] for t in trees], axis=self._axis_for(k)
                )
                for k in trees[0]
            }
        return nest.cat_fields(trees, axis=self.dim)

    def _slice_tree(self, tree, start, stop):
        if self.dims and isinstance(tree, dict):
            return {
                k: nest.slice_fields(v, start, stop, self._axis_for(k))
                for k, v in tree.items()
            }
        return nest.slice_fields(tree, start, stop, self.dim)

    def _fill(self, slot: "_Slot", batch: Any, event=None) -> None:
        with self._lock:
            slot.batch = batch
            slot.event = event
            slot.done = True
            self._lock.notify_all()
            waiters, self._async_waiters = self._async_waiters, []
        for loop, event in waiters:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass  # waiter's loop already closed

    def _stage(self, batch: Any):
        """Dispatch H2D staging at batch-completion time (producer side), so
        the asynchronous upload overlaps accumulation of the next batch.
        Returns the batch and, for a card, an event recorded after the
        upload on the producer thread's current stream (None otherwise)."""
        if self.device is None:
            return batch, None
        batch = stage_batch(batch, self.device)
        if self.device.type != "cuda":
            return batch, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return batch, event

    def _consume(self, slot: "_Slot") -> Any:
        """The batch of a popped slot. A card upload ran on the
        producer's stream: the consumer thread's current stream waits on
        its event (on the device; the host does not wait), so no kernel
        the consumer queues next reads the batch before it has landed."""
        if slot.event is not None:
            torch.cuda.current_stream(self.device).wait_event(slot.event)
        return slot.batch
