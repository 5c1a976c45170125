"""Cluster-wide stats aggregation over the group allreduce; a copy of
:mod:`moolib_tpu.parallel.stats` on the port's ``Group``.

Capability parity with the reference's ``GlobalStatsAccumulator``
(reference: examples/common/__init__.py:65-121 — cluster-wide stats survive
peer failures: nothing is lost on a failed reduce and nothing double-counts
on a retried one).

Design notes — this deliberately *improves* on the reference's delta
protocol: deltas require exactly-once reduction, but a tree allreduce over an
elastic group can deliver a late partial from a timed-out round into the next
round with the same name (it gets parked and drained — see
``Group.all_reduce``), double-counting the delta. Instead each peer
contributes its full **cumulative snapshot** tagged ``(peer, round)`` and the
reduce op is a union that keeps the highest round per peer — fully
idempotent, so duplicate delivery, loss, and retry are all harmless. The
global view is the fold of the last known snapshot of every peer ever seen
(a departed peer's contribution is retained, matching the reference's
merged-delta semantics).

The allreduce is asynchronous — ``enqueue_global_stats`` starts it and
returns; completion is observed via callback, so the training loop never
blocks on stats.

Contract: the local ``stats`` passed in must be **cumulative** (never reset
between enqueues); use separate Stats for per-interval console logging.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict

from ..rpc import Group, RpcError
from ..utils import get_logger
from ..utils.stats import StatMax, StatMean, StatSum, Stats

log = get_logger("stats")

__all__ = ["GlobalStatsAccumulator"]


def _union_max_round(a: Dict, b: Dict) -> Dict:
    """Reduce op: {peer: (round, snapshot)} union keeping the newest round."""
    out = dict(a)
    for peer, (rnd, snap) in b.items():
        if peer not in out or out[peer][0] < rnd:
            out[peer] = (rnd, snap)
    return out


def _kind_of(stat) -> str:
    return type(stat).__name__  # StatSum | StatMean | StatMax | ...


# Wire kind tag -> class. An explicit whitelist: the tag arrives from remote
# peers, so it must never be resolved via getattr on a module (that would let
# a peer instantiate arbitrary module attributes).
_STAT_KINDS = {cls.__name__: cls for cls in (StatSum, StatMean, StatMax)}


def _stat_from_kind(kind: str):
    """Instantiate a zeroed stat from its wire kind tag, so keys tracked
    only by remote peers still appear in the global view."""
    cls = _STAT_KINDS.get(kind)
    if cls is None:
        return None
    return _zeroed(cls())


def _zeroed(stat):
    z = copy.deepcopy(stat)
    for f in ("value", "sum", "count"):
        if hasattr(z, f):
            setattr(z, f, float("-inf") if isinstance(z, StatMax) else 0.0)
    return z


class GlobalStatsAccumulator:
    """Aggregate a :class:`Stats` dict across all peers of a ``Group``.

    Usage (reference: examples/vtrace/experiment.py global stats path)::

        gsa = GlobalStatsAccumulator(group, local_stats)
        # each logging interval:
        gsa.enqueue_global_stats()   # non-blocking
        gsa.global_stats.results()   # cluster-wide view (eventually consistent)
    """

    def __init__(self, group: Group, stats: Stats):
        self.group = group
        self.stats = stats  # must be cumulative: do not reset between enqueues
        self.global_stats: Stats = Stats(
            {k: _zeroed(v) for k, v in stats.items()}
        )
        self._lock = threading.Lock()
        # Last known (round, snapshot) per peer, including departed peers.
        self._known: Dict[str, tuple] = {}
        self._round = 0
        self._inflight = False

    def _snapshot(self) -> Dict:
        """Cumulative snapshot of local stats: {key: (kind, value-vs-zero)}."""
        return {
            k: (_kind_of(stat), stat.diff(_zeroed(stat)))
            for k, stat in self.stats.items()
        }

    def enqueue_global_stats(self) -> bool:
        """Start an async allreduce of per-peer snapshots; returns False if
        one is already in flight or the group is not synchronized."""
        with self._lock:
            if self._inflight:
                return False
            self._round += 1
            payload = {self.group.rpc.get_name(): (self._round, self._snapshot())}
            self._inflight = True
        try:
            fut = self.group.all_reduce("global_stats", payload, _union_max_round)
        except RpcError as e:
            log.debug("global stats reduce not started: %s", e)
            with self._lock:
                self._inflight = False
            return False
        fut.add_done_callback(self._on_done)
        return True

    def _on_done(self, fut):
        with self._lock:
            self._inflight = False
            err = fut.exception(timeout=0)
            if err is not None:
                # Nothing to salvage or replay: snapshots are cumulative, the
                # next round carries everything again.
                log.debug("global stats reduce failed: %s", err)
                return
            for peer, (rnd, snap) in fut.result(timeout=0).items():
                old = self._known.get(peer)
                if old is None or old[0] < rnd:
                    self._known[peer] = (rnd, snap)
            self._rebuild_locked()

    def _rebuild_locked(self):
        new = {}
        kinds = {}
        for _rnd, snap in self._known.values():
            for k, (kind, v) in snap.items():
                if k not in new:
                    stat = _stat_from_kind(kind)
                    if stat is None:
                        log.debug("unknown stat kind %r for %r", kind, k)
                        continue
                    new[k] = stat
                    kinds[k] = kind
                if kinds.get(k) != kind:
                    # Peers disagree on the stat type for this key; merging
                    # would corrupt (tuple vs float deltas) — skip this peer's
                    # contribution rather than poison the round.
                    log.debug("stat kind mismatch for %r: %r vs %r",
                              k, kinds.get(k), kind)
                    continue
                new[k].merge(v)
        # Atomic rebind: readers call global_stats.results() without the lock
        # from the training loop; never mutate the published dict in place.
        self.global_stats = Stats(new)

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight
