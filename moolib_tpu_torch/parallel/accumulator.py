"""Accumulator: elastic data-parallel gradient accumulation; the
counterpart of :mod:`moolib_tpu.parallel.accumulator`, wire-compatible
with it (the count tuple, the op keys and the chunk geometry are the
reference's, so port and reference peers can share a group).

Capability parity with the reference's Accumulator (reference:
src/accumulator.{h,cc} — leader election by max (model_version, name)
allreduce :581-626; count-then-reduce virtual-batch protocol :1005-1078;
reduced gradients divided and handed to the user :425-462; joiners request
model/optimizer/user state from the leader :464-488, 719-759; polling
contract documented at src/moolib.cc:1645-1862).

This class reduces *host-level* gradient trees over the RPC tree
allreduce with the reference's virtual-batch-size semantics and elastic
membership. Host bundles hold numpy arrays for every dtype numpy has and
``torch.bfloat16`` CPU tensors for bf16 (see :mod:`..rpc.group`). Card
tensors handed to ``reduce_gradients`` are staged into pinned host memory
asynchronously (:func:`~moolib_tpu_torch.utils.stage_host_async`) and
become host arrays on an RPC completion thread, never on the training
thread; the reduced mean comes back as host arrays, which the caller
uploads (pinned, non-blocking: :func:`~moolib_tpu_torch.ops.stage_batch`)
before its apply step.

Round protocol (stall-free): every member's ``update()`` drives small
*count rounds* continuously — each round sums (batch_size, n_grads)
contributed since the last round (zero for idle/unsynced peers, the
built-in equivalent of ``skip_gradients``). All peers observe identical
count totals, so when the cumulative count crosses ``virtual_batch_size``
every peer deterministically joins the same *gradient round*, shipping its
accumulated local gradient sum (or None). The reduced sum is divided by the
total sample count and surfaced via ``has_gradients()``/
``result_gradients()``.

Quorum rounds (``min_quorum``): by default every member must contribute
to every round (a stalled member fails the round at the collective
timeout). With ``min_quorum=K`` configured, the group layer writes
stragglers off at a (height-staged) per-round deadline and the round
commits with K-of-N contributions: the result carries the participating
member set, the gradient mean divides by the *participating* sample
count, members the commit provably excluded re-contribute their bundles
into the next round (never double-applied), and a result below quorum is
rejected identically on every member and retried. The requested quorum
is negotiated through the count allreduce (strictest wins) so all
members always apply the same commit rule.

Pipelining (``parallel_gradients`` > 1, reference:
set_parallel_gradients / the in-flight reduction ring,
src/accumulator.cc:251-256): count rounds keep running while gradient
rounds are still reducing, and up to ``parallel_gradients`` reduced
results may queue unapplied — so one network round-trip of latency overlaps
with the next virtual batch's compute instead of serializing into it.
Gradient-round *starts* remain deterministic (they are triggered inside
count-round completions, which are totally ordered), and results are
released to the user strictly in round order even when the underlying
reductions complete out of order.

Drift healing (reference: periodic leader buffer/model re-broadcast,
src/accumulator.cc:761-795): the leader re-pushes its full state to every
member each ``state_broadcast_interval`` seconds; members apply it when
they have nothing unapplied locally. A peer whose params drifted (missed
round, fp divergence) converges back to the leader's canonical copy
without ever requesting a resync.

Gradient convention: ``reduce_gradients(grads, batch_size)`` expects
**batch-sum** gradients (mean-gradient * batch_size); the result handed
back is the proper per-sample mean over the virtual batch.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

import torch

# stage_host_async: the shared staging idiom — the training thread stages
# and returns; the numpy conversion happens on an RPC completion thread
# once the count round resolves (the reference's async pinned-memory
# copies, src/accumulator.cc:941-980).
from ..telemetry.stepscope import StepScope
from ..utils import get_logger, nest, stage_host_async as _stage_host_async
from ..rpc.group import Group, _host_leaf, _sum
from ..rpc.rpc import Rpc, RpcError

log = get_logger("accumulator")

__all__ = ["Accumulator"]


def _host_array(x):
    """One leaf as a host array: a staged copy once it has landed, a torch
    CPU tensor as its numpy view (bf16 stays a torch tensor, as
    :func:`..rpc.group._host_leaf` has it), anything else through
    ``np.asarray``. A CUDA tensor raises: gradients must come staged and
    a ``get_state`` callback copies its state to the host itself, under
    the lock that orders it against the apply step."""
    result = getattr(x, "result", None)
    if result is not None and hasattr(x, "is_ready"):
        x = result()
    x = _host_leaf(x)
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_numpy_tree(tree):
    return nest.map_structure(_host_array, tree)


def _materialize_parts(parts):
    """Convert staged contribution trees to numpy and sum them (None for
    an empty list). Runs OFF the training thread, after the async D2H
    staged in :func:`_stage_host_async` has had a round-trip to finish."""
    out = None
    for p in parts:
        out = _tree_add(out, _to_numpy_tree(p))
    return out


def _tree_is_ready(tree) -> bool:
    """True when converting ``tree`` to numpy would not block: every staged
    leaf's copy has landed (its event has completed; host leaves trivially
    qualify). Non-blocking."""
    for leaf in nest.flatten(tree):
        ready = getattr(leaf, "is_ready", None)
        if ready is None:
            continue
        try:
            if not ready():
                return False
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception:
            return False
    return True


def _tree_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    # asarray: np.add on two 0-d arrays returns a numpy SCALAR, which would
    # make chunk eligibility (an all-array check in rpc/group.py) diverge
    # between peers that accumulated 2+ contributions and peers that did
    # not — divergent wire formats deadlock the round. A bf16 leaf is a
    # torch tensor and adds as one.
    return nest.map_structure(_add_leaves, a, b)


def _add_leaves(x, y):
    out = _sum(x, y)
    return out if isinstance(out, torch.Tensor) else np.asarray(out)


def _elect_max(a, b):
    return max(a, b)


class _LeafSpec:
    """Shape/dtype of one bundle leaf. A class, not a tuple: template trees
    run through nest.map_structure, which would recurse into tuples."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def _leaf_dtype(x):
    """The dtype of the leaf's host form: ``torch.bfloat16`` for bf16, a
    numpy dtype otherwise. Attribute first: converting a staged leaf
    would wait for its copy, which the reduce_gradients fast path must
    never do."""
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return dt
        return torch.empty((), dtype=dt).numpy().dtype
    dt = np.dtype(dt) if dt is not None else np.asarray(x).dtype
    return torch.bfloat16 if dt.name == "bfloat16" else dt


def _leaf_shape(x):
    shape = getattr(x, "shape", None)
    return tuple(shape) if shape is not None else np.shape(x)


def _bundle_spec(tree):
    return nest.map_structure(
        lambda x: _LeafSpec(_leaf_shape(x), _leaf_dtype(x)), tree
    )


def _zeros(spec: _LeafSpec):
    if spec.dtype == torch.bfloat16:
        return torch.zeros(spec.shape, dtype=torch.bfloat16)
    return np.zeros(spec.shape, spec.dtype)


def _grad_merge(a, b):
    """Merge (bundle_or_none, n_grads) pairs."""
    (ba, na), (bb, nb) = a, b
    return (_tree_add(ba, bb), na + nb)


def _qgrad_merge(a, b):
    """Merge quorum-round (bundle_or_none, n_grads, batch_sum, names)
    tuples. ``names`` unions the participating members, so the committed
    result is self-describing: every member — straggler included — can
    tell from the share alone whether its own contribution made the sum
    (and must therefore re-contribute it next round)."""
    (ba, na, sa, ma), (bb, nb, sb, mb) = a, b
    return (_tree_add(ba, bb), na + nb, sa + sb, ma + mb)


def _q_strictest(qa: int, qb: int) -> int:
    """Merge two requested quorums; 0 encodes require-all (the strictest
    possible request, so it dominates)."""
    if qa == 0 or qb == 0:
        return 0
    return max(qa, qb)


def _count_merge(a, b):
    """Merge (batch_size, n_grads, has_template, requested_vbs,
    chunk_bytes, requested_quorum, names) tuples.

    The count result is identical on every peer (it is an allreduce), so
    it doubles as the NEGOTIATION channel for everything the following
    gradient round must agree on:

    - ``has_template`` ANDs across members: the chunked builtin-sum wire
      format (pipelined through the tree, see rpc/group.py chunking) is
      only legal when EVERY member can construct a structurally-identical
      payload, i.e. owns a bundle template. A fresh joiner flips one round
      back to the None-tolerant custom merge, then learns the template
      from that round's result.
    - ``requested_vbs`` MAXes across members: the virtual-batch threshold
      each completion compares against is the ALLREDUCED value, so a
      ``set_virtual_batch_size`` call racing in-flight count rounds can
      never make peers disagree about whether a round triggered (a purely
      local threshold could fire on one peer's completion and not
      another's, silently desynchronizing gradient means).
    - ``chunk_bytes`` MINs across members: chunk geometry (sub-op keys +
      boundaries) must be identical cluster-wide or every large reduce
      stalls to timeout; negotiating it here means peers with mismatched
      ``MOOLIB_TPU_ALLREDUCE_CHUNK`` settings — or a rolling upgrade that
      changes the default — converge on the smallest value (0, i.e.
      chunking-disabled anywhere, disables it everywhere) instead of
      livelocking. NOTE the count tuple itself is a protocol surface:
      peers must run the same framework version (tuple arity is not
      negotiated).
    - ``requested_quorum`` merges STRICTEST across members (0 = require
      all, which dominates; else max): every completion then applies the
      same K-of-N commit rule to the same round, so a partially-forwarded
      result is accepted or rejected identically cluster-wide.
    - ``names`` unions the members whose contribution actually reached
      the committed sum — under straggler write-offs that may be a
      strict subset of the membership, and a member missing from it
      knows to re-contribute its snapshot next round."""
    (bsa, nga, ta, va, ca, qa, ma), (bsb, ngb, tb, vb, cb, qb, mb) = a, b
    return (bsa + bsb, nga + ngb, ta and tb, max(va, vb), min(ca, cb),
            _q_strictest(qa, qb), ma + mb)


class Accumulator:
    """Elastic DP gradient accumulator over a broker-managed group.

    Polling surface mirrors the reference (reference: src/moolib.cc
    :1645-1862): ``update()`` every iteration, then check ``connected()``,
    ``wants_gradients()``/``has_gradients()``, call
    ``reduce_gradients(grads, batch_size)`` or ``skip_gradients()``, apply
    the result, ``zero_gradients()``.
    """

    def __init__(
        self,
        rpc: Rpc,
        group: Optional[Group] = None,
        broker_name: str = "broker",
        group_name: str = "default",
        virtual_batch_size: int = 1,
        get_state: Optional[Callable[[], Any]] = None,
        set_state: Optional[Callable[[Any], None]] = None,
        timeout: float = 10.0,
        parallel_gradients: int = 1,
        state_broadcast_interval: Optional[float] = 600.0,
        chunk_bytes: Optional[int] = None,
        min_quorum: Optional[int] = None,
        straggler_timeout: Optional[float] = None,
    ):
        # Validate BEFORE any side effect: creating the Group registers
        # service handlers on the rpc, which must not happen for a
        # constructor call that raises.
        if virtual_batch_size < 1:
            raise ValueError("virtual_batch_size must be >= 1")
        if min_quorum is not None and min_quorum < 1:
            raise ValueError("min_quorum must be >= 1 (or None for all)")
        if straggler_timeout is not None and not straggler_timeout > 0:
            raise ValueError("straggler_timeout must be positive")
        if rpc.defined("AccumulatorService::requestState"):
            # Same-fid clobbering: a second Accumulator on one Rpc would
            # silently replace the first one's state handlers.
            raise RuntimeError(
                "an Accumulator is already registered on this Rpc; "
                "one Rpc peer hosts at most one Accumulator"
            )
        self.rpc = rpc
        self.group = group or Group(
            rpc, broker_name=broker_name, group_name=group_name, timeout=timeout
        )
        self._owns_group = group is None
        self.virtual_batch_size = int(virtual_batch_size)
        self._get_state = get_state
        self._set_state = set_state

        self._lock = threading.RLock()
        self._model_version = 0
        self._epoch: Optional[str] = None       # sync_id this state belongs to
        self._leader: Optional[str] = None
        self._electing = False
        self._synced = False                     # model state is current
        self._state_req_inflight = False
        self._state_req_at = 0.0                 # watchdog for the above
        self._state_req_token = 0                # supersession for the above
        # Consecutive collective failures observed while the broker was
        # dark: once nonzero, new rounds/elections are deferred until the
        # broker returns (membership cannot heal without it, so every new
        # round could only join the timeout queue). Reset on any success,
        # epoch reset, or broker recovery (the gate checks liveness too).
        self._dark_failures = 0

        self._seq = 0                            # count-round sequence
        self._attempt = 0                        # retry suffix for count keys
        self._gseq = 0                           # gradient-round sequence
        self._round_inflight = False
        self._grads_inflight = 0                 # concurrent gradient rounds
        self._cumulative_bs = 0                  # global, same on all peers
        self._parallel = max(1, int(parallel_gradients))
        # Out-of-order completions park here until released in gseq order.
        self._grad_outcomes: Dict[int, Optional[Tuple[Any, int]]] = {}
        self._release_gseq = 0
        self._broadcast_interval = state_broadcast_interval
        self._last_broadcast = time.monotonic()
        self._applying_push = False  # pauses result release during a push

        # User grad contributions since the last count round. Kept as a
        # LIST of unconverted (possibly still-on-device) trees: the sum and
        # the numpy conversion are deferred to an RPC completion thread
        # (_materialize_parts), so reduce_gradients never blocks the
        # training thread on a device transfer.
        self._pending_parts: list = []
        self._pending_bs = 0
        self._pending_ngrads = 0
        # Bundle shape/dtype spec — once known, gradient rounds negotiate
        # the chunked builtin-sum wire format (see _count_merge docstring).
        # Survives epochs: it describes the model, not the membership.
        self._bundle_template: Optional[Any] = None
        # Cached zeros payload for skipped chunked rounds: the group layer
        # never mutates caller payloads (copy-on-first-merge), so one
        # allocation serves every skipped round instead of an O(model)
        # build under the lock each time.
        self._zeros_bundle: Optional[Any] = None
        # Local chunk-geometry preference, negotiated through the count
        # round (min across members — see _count_merge) so heterogeneous
        # env settings converge instead of stalling collectives.
        from ..rpc.group import CHUNK_BYTES_DEFAULT

        self._chunk_bytes = (
            CHUNK_BYTES_DEFAULT if chunk_bytes is None else int(chunk_bytes)
        )
        self._neg_chunk: Optional[int] = None    # last negotiated value
        # Quorum rounds: commit with K-of-N contributions once the
        # straggler deadline passes instead of failing the whole round on
        # one stalled member. None = require every member (the default,
        # and the pre-quorum behavior). The requested value rides the
        # count allreduce (strictest-merge, see _count_merge) so every
        # member applies the same commit rule; the straggler deadline is
        # a local write-off knob and needs only rough agreement.
        self._min_quorum = None if min_quorum is None else int(min_quorum)
        self._straggler_timeout = (
            max(0.5, min(2.0, self.group.timeout / 4.0))
            if straggler_timeout is None else float(straggler_timeout)
        )
        # Last NEGOTIATED quorum (out of the count allreduce). Straggler
        # write-offs key off THIS, not the local config: under mixed
        # config the strictest-merge yields require-all, and writing
        # stragglers off against a require-all commit rule would reject
        # every partial round forever (livelock) where plain waiting
        # would have succeeded within the timeout. Until the first
        # negotiation lands (None), rounds run require-all with no
        # write-offs — strictly safe.
        self._neg_quorum: Optional[int] = None
        self._last_participation: Optional[Tuple[int, int]] = None
        self._committed_bundle = None            # counted, awaiting grad round
        self._committed_bs = 0
        self._committed_ngrads = 0

        # Released results in round order: (mean grads, count, version_after).
        self._results: deque = deque()
        self._result_version = 0  # model version the latest result produces
        self._user_has_contributed = False
        # Durability seam (see set_durability_hook).
        self._durability_hook: Optional[Callable[[int], None]] = None

        # Telemetry (per-Rpc registry): cumulative round/election counters
        # live HERE — get_gradient_stats() is a thin view over them plus
        # the live protocol state the gauge callbacks read.
        reg = rpc.telemetry.registry
        # Flight recorder (moolib_tpu/flightrec): leader/election and
        # round commit/reject/write-off transitions land in the peer's
        # black box. A *storm* of consecutive failed rounds (one failure
        # is routine under chaos; a run of them is a wedged cohort's
        # signature) triggers an incident auto-capture.
        self._flight = rpc.telemetry.flight
        self._storm_failures = 0  # consecutive failed rounds (any kind)
        self._storm_threshold = 3
        # Capture-due marker: 0 = none; otherwise the failure count
        # SNAPSHOTTED when the threshold was crossed (a later commit
        # resets _storm_failures, and the forensic record must describe
        # the storm that fired the trigger, not the state at drain
        # time). Set under _lock, drained by update() outside it.
        self._storm_capture_due = 0
        self._m_count_rounds = reg.counter("acc_count_rounds_total")
        self._m_count_round_failures = reg.counter(
            "acc_count_round_failures_total"
        )
        self._m_grad_rounds = reg.counter("acc_gradient_rounds_total")
        self._m_chunked_rounds = reg.counter(
            "acc_chunked_gradient_rounds_total"
        )
        self._m_grad_round_dur = reg.histogram("acc_gradient_round_seconds")
        self._m_rounds_empty = reg.counter("acc_gradient_rounds_empty_total")
        self._m_rounds_failed = reg.counter(
            "acc_gradient_rounds_failed_total"
        )
        self._m_elections = reg.counter("acc_elections_total")
        self._m_user_skips = reg.counter("acc_skip_gradients_total")
        # Quorum-round telemetry: rounds committed below full
        # participation (count vs gradient), member-contributions written
        # off across those commits, rounds rejected for missing quorum,
        # this peer's own late re-contributions, and the per-round
        # participation fraction.
        self._m_partial_count_rounds = reg.counter(
            "acc_partial_count_rounds_total"
        )
        self._m_partial_grad_rounds = reg.counter(
            "acc_partial_gradient_rounds_total"
        )
        self._m_quorum_rejected = reg.counter("acc_quorum_rejected_total")
        self._m_writeoffs = reg.counter("acc_straggler_writeoffs_total")
        self._m_recontributed = reg.counter("acc_recontributed_total")
        self._m_participation = reg.histogram("acc_round_participation")
        # Step-phase attribution for gradient rounds (docs/observability
        # .md): each completed round is one "step" whose ledger splits
        # round lifetime into local_reduce (host-side materialization of
        # staged contribution parts, timed in reduce_gradients) and
        # wire_wait (everything else: the tree reduction itself). The
        # per-round local-reduce accumulator is guarded by _lock like the
        # parts list it times.
        self._scope = StepScope("acc_grad_round", telemetry=rpc.telemetry)
        self._scope_local_s = 0.0
        # The registry outlives this Accumulator; a strong `self` in the
        # gauge closures would pin model-sized buffers (_zeros_bundle,
        # _committed_bundle, _results) after close(). A dead ref scrapes
        # as NaN until close() unregisters the series.
        wself = weakref.ref(self)
        self._gauge_names = (
            "acc_model_version", "acc_results_queued",
            "acc_gradient_rounds_inflight", "acc_synced", "acc_is_leader",
            "acc_dark_failures",
        )
        reg.gauge_fn("acc_model_version", lambda: wself()._model_version)
        reg.gauge_fn("acc_results_queued", lambda: len(wself()._results))
        reg.gauge_fn("acc_gradient_rounds_inflight",
                     lambda: wself()._grads_inflight)
        reg.gauge_fn("acc_synced",
                     lambda: 1.0 if wself()._synced else 0.0)
        reg.gauge_fn("acc_is_leader",
                     lambda: 1.0 if wself().is_leader() else 0.0)
        reg.gauge_fn("acc_dark_failures", lambda: wself()._dark_failures)

        self._endpoint_names = (
            "AccumulatorService::requestState",
            "AccumulatorService::pushState",
        )
        rpc.define(
            "AccumulatorService::requestState", self._serve_state
        )
        rpc.define(
            "AccumulatorService::pushState", self._on_push_state
        )
        self._closed = False

    # -- reference-parity introspection --------------------------------------

    @property
    def model_version(self) -> int:
        return self._model_version

    def set_model_version(self, v: int):
        """Set before joining so a checkpoint holder wins leader election
        (reference: src/moolib.cc:1808-1821)."""
        with self._lock:
            self._model_version = int(v)
            self._result_version = int(v)

    def set_durability_hook(self, fn: Optional[Callable[[int], None]]):
        """Install (or clear, with None) the durability hook: called with
        each newly applied model version at ``zero_gradients`` time —
        when the caller's params embody that version — outside the lock.
        :class:`~moolib_tpu_torch.statestore.Replicator` uses it to stream
        committed versions to replica peers without ever stalling a
        gradient round; the hook itself must be cheap (note and
        return)."""
        with self._lock:
            self._durability_hook = fn

    def is_leader(self) -> bool:
        # Under the (reentrant) lock: election writes _leader on RPC
        # callback threads, and settle paths read it mid-round — an
        # unlocked read could see a half-applied election.
        with self._lock:
            return self._leader == self.rpc.get_name()

    def get_leader(self) -> Optional[str]:
        """Name of the current leader, or None before the first election
        (reference: get_leader, src/moolib.cc)."""
        with self._lock:
            return self._leader

    def connected(self) -> bool:
        # Same discipline as is_leader(): update() clears _leader under
        # the lock mid-re-election; an unlocked read here would report
        # the cohort disconnected for that window.
        with self._lock:
            return self.group.active() and self._leader is not None

    def set_virtual_batch_size(self, n: int):
        """Change the virtual batch size (reference:
        set_virtual_batch_size, src/moolib.cc). Takes effect at a
        deterministic round boundary: the value rides the count allreduce
        (members MAX their requests), so even calls racing in-flight
        rounds cannot make peers disagree about when a gradient round
        triggered. Members should still converge on one value — until
        they do, the largest request governs."""
        if n < 1:
            raise ValueError("virtual_batch_size must be >= 1")
        with self._lock:
            self.virtual_batch_size = int(n)

    def set_parallel_gradients(self, n: int):
        """Allow up to ``n`` gradient reductions in flight / unapplied
        (reference: set_parallel_gradients, src/moolib.cc)."""
        if n < 1:
            raise ValueError("parallel_gradients must be >= 1")
        with self._lock:
            self._parallel = int(n)

    def wants_gradients(self) -> bool:
        with self._lock:
            return (
                self.connected()
                and self._synced
                # In-flight reductions count against the cap too — otherwise
                # a fast producer over a slow network piles up unbounded overlap
                # (and unbounded gradient staleness).
                and len(self._results) + self._grads_inflight < self._parallel
                and not self._user_has_contributed
            )

    def has_gradients(self) -> bool:
        return bool(self._results)

    def result_gradients(self) -> Tuple[Any, int]:
        """-> (mean gradient pytree, virtual batch count) for the OLDEST
        unapplied round; ``zero_gradients`` consumes it."""
        with self._lock:
            if not self._results:
                raise RpcError("no reduced gradients available")
            mean, count, _version = self._results[0]
            return mean, count

    def result_model_version(self) -> int:
        """Model version that applying the current (or most recent) reduced
        gradients produces. Unlike ``model_version`` this does not advance
        concurrently between ``has_gradients()`` and a later read, so it is
        the right label for checkpoints of just-updated params."""
        with self._lock:
            if self._results:
                return self._results[0][2]
            return self._result_version

    # -- user contributions ---------------------------------------------------

    def reduce_gradients(self, grads: Any, batch_size: int):
        """Contribute batch-sum gradients; they enter the next count round
        (reference: reduceImpl, src/accumulator.cc:880-1003). CUDA tensor
        leaves are staged to pinned host memory and never waited for
        here; host leaves (numpy, torch CPU) are taken as they are."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        # Non-blocking: start the D2H transfers, convert later off-thread.
        tree = _stage_host_async(grads)
        with self._lock:
            # Opportunistic compaction BOUNDS staging-buffer retention in
            # the steady state: older parts whose async transfers have
            # completed (is_ready — a non-blocking check) fold into one
            # host-numpy bundle, releasing their pinned buffers, so the
            # pending list pins at most ~2 staged trees (the newest, plus
            # any still in flight) regardless of how slow a count
            # round is. An eager copy would free them at once but block
            # the training thread to do it.
            if len(self._pending_parts) >= 2:
                done_parts = []
                while self._pending_parts and _tree_is_ready(
                    self._pending_parts[0]
                ):
                    done_parts.append(self._pending_parts.pop(0))
                if done_parts:
                    t0 = time.monotonic()
                    self._pending_parts.insert(
                        0, _materialize_parts(done_parts)
                    )
                    self._scope_local_s += time.monotonic() - t0
            self._pending_parts.append(tree)
            self._pending_bs += int(batch_size)
            self._pending_ngrads += 1
            self._user_has_contributed = True
            if self._bundle_template is None:
                self._bundle_template = _bundle_spec(tree)

    def skip_gradients(self):
        """Explicitly contribute nothing this cycle (reference contract)."""
        # Unconditional like every other Accumulator counter: per-round
        # cadence, and a telemetry toggle must not skew counter ratios.
        self._m_user_skips.inc()
        with self._lock:
            self._user_has_contributed = True

    def zero_gradients(self):
        """Consume the oldest reduced result; re-enables wants_gradients."""
        hook = None
        version = None
        with self._lock:
            if self._results:
                _mean, _count, version = self._results.popleft()
                self._result_version = version
                hook = self._durability_hook
            self._user_has_contributed = False
        if hook is not None and version is not None:
            # The durability seam (statestore.Replicator):
            # at THIS instant the caller's params embody `version` (the
            # contract is apply-then-zero), so it is the one moment a
            # (version, state) pair can be snapshotted untorn. The hook
            # must only *note* the version (the replicator's worker does
            # the slow work) — and it runs outside the lock either way.
            try:
                hook(version)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except Exception as e:  # durability must not break training
                log.error("durability hook failed for v%d: %s", version, e)

    # -- heartbeat ------------------------------------------------------------

    def update(self):
        """Drive membership, leader election, state sync, and reduce rounds
        (reference: AccumulatorImpl::update, src/accumulator.cc:519-666)."""
        self.group.update()
        sync_id = self.group.sync_id
        if sync_id is None:
            return
        with self._lock:
            if sync_id != self._epoch:
                self._reset_epoch(sync_id)
            # Leader loss without an epoch change should be impossible
            # (the broker always mints a fresh sync id when membership
            # changes) — but a vanished leader would wedge state sync and
            # every future round, so verify and force re-election rather
            # than trust the invariant under chaos.
            if (self._leader is not None
                    and not self._electing
                    and self.group.active()
                    and self._leader not in self.group.members):
                log.warning(
                    "%s: leader %s vanished from the member list — "
                    "forcing re-election", self.rpc.get_name(), self._leader,
                )
                self._leader = None
            # Broker-dark degradation: collectives are peer-to-peer and
            # keep working while the broker is down — but once one FAILS
            # with the broker dark, the membership view is provably
            # unhealable until the broker returns, so starting more
            # rounds/elections would only queue more guaranteed timeouts.
            broker_dark = not self.group.broker_connected()
            degraded = broker_dark and self._dark_failures > 0
            if self._electing or self._leader is None:
                if not degraded:
                    self._maybe_elect()
                return
            if not self._synced:
                # Watchdog: a state request to a vanished leader errors
                # only at the full RPC timeout; write it off after the
                # group timeout so re-election/resync is not gated on it.
                if (self._state_req_inflight
                        and time.monotonic() - self._state_req_at
                        > max(self.group.timeout, 5.0)):
                    self._state_req_inflight = False
                self._maybe_request_state()
            # Drive one count round at a time; unsynced/idle peers
            # contribute zeros so collectives never stall. With pipelining,
            # counting continues while gradient rounds are still reducing.
            if not degraded and not self._round_inflight and (
                self._parallel > 1 or self._grads_inflight == 0
            ):
                self._start_count_round()
        self._maybe_broadcast_state()  # outside the lock: get_state may be slow
        # Round-failure-storm incident capture, OUTSIDE the lock (capture
        # writes a bundle and dumps every thread's stack): the due flag
        # was set under the lock by _note_round_failure_locked.
        with self._lock:
            storm_n = self._storm_capture_due
            self._storm_capture_due = 0
        if storm_n:
            from ..flightrec.capture import maybe_capture

            maybe_capture(
                "round_failure_storm",
                f"{storm_n} consecutive failed rounds on "
                f"{self.rpc.get_name()}",
                telemetry=self.rpc.telemetry,
            )

    # -- epoch / election -----------------------------------------------------

    def _reset_epoch(self, sync_id: str):
        log.info("%s: new epoch %s", self.rpc.get_name(), sync_id[:8])
        self._epoch = sync_id
        self._leader = None
        self._electing = False
        self._synced = False
        self._state_req_inflight = False
        self._seq = 0
        self._attempt = 0
        self._gseq = 0
        self._round_inflight = False
        self._grads_inflight = 0
        self._dark_failures = 0
        self._neg_quorum = None  # renegotiated with the new membership
        self._grad_outcomes.clear()
        self._release_gseq = 0
        self._cumulative_bs = 0
        # Pending user grads survive a resync; committed ones were bound to
        # the old epoch's (now discarded) counts and merge back into pending
        # so they are re-counted and re-reduced in the new epoch.
        if self._committed_bundle is not None:
            self._pending_parts.insert(0, self._committed_bundle)
        self._pending_bs += self._committed_bs
        self._pending_ngrads += self._committed_ngrads
        self._committed_bundle = None
        self._committed_bs = 0
        self._committed_ngrads = 0

    def _maybe_elect(self):
        if self._electing or not self.group.active():
            return
        self._electing = True
        epoch = self._epoch

        def done(fut):
            try:
                version, leader = fut.result(timeout=0)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                # Election cancelled mid-flight (epoch teardown): restore
                # the retry gate, then PROPAGATE — cancellation swallowed
                # here would wedge _electing until the next epoch.
                with self._lock:
                    self._electing = False
                raise
            except Exception as e:
                with self._lock:
                    self._electing = False  # retried next update()
                    if self._epoch == epoch:
                        self._dark_failures += 1
                        log.debug("election failed: %s", e)
                return
            with self._lock:
                if self._epoch != epoch:
                    return
                self._electing = False
                self._dark_failures = 0
                self._leader = leader
                if self._flight.on:
                    self._flight.record(
                        "acc_leader", leader=leader, version=int(version),
                        is_self=leader == self.rpc.get_name(),
                    )
                if leader == self.rpc.get_name():
                    self._synced = True
                elif self._model_version >= version:
                    self._synced = True
                else:
                    self._synced = self._set_state is None
                log.info(
                    "%s: leader=%s v%d (me v%d, synced=%s)",
                    self.rpc.get_name(), leader, version,
                    self._model_version, self._synced,
                )
                self._release_ready_locked()  # anything parked while unsynced

        try:
            fut = self.group.all_reduce(
                "acc.elect", (self._model_version, self.rpc.get_name()),
                op=_elect_max,
            )
        except RpcError:
            self._electing = False
            return
        self._m_elections.inc()
        if self._flight.on:
            self._flight.record("acc_election",
                                epoch=str(epoch)[:16] if epoch else None)
        fut.add_done_callback(done)

    # -- state sync -----------------------------------------------------------

    def _serve_state(self):
        """Leader-side state service (reference:
        AccumulatorService::requestModel / modelUpdate)."""
        if self._get_state is None:
            raise RpcError("no get_state callback configured")
        with self._lock:
            # _model_version bumps when a reduced result becomes available,
            # BEFORE the user applies it, so the version that matches the
            # params is _model_version - len(_results) -- but only while
            # no queued result is being applied. The user applies the
            # oldest result, then zero_gradients() pops it: in between,
            # the params embody a result still counted as unapplied, and
            # the reference serves that torn pair (the joiner is then one
            # update ahead of its version for good). While a result is
            # queued the pair is unknowable here: refuse, and the joiner's
            # next update() asks again.
            if self._results:
                raise RpcError("state busy: a reduced result is queued for "
                               "its apply; request again")
            version = self._model_version
            state = _to_numpy_tree(self._get_state())
            # Every round before this cursor is inside the state: the
            # joiner must not apply it again (see _maybe_request_state).
            cursor = {"epoch": self._epoch, "release_gseq": self._release_gseq}
        return {"state": state, "model_version": version, **cursor}

    def _maybe_request_state(self):
        if self._state_req_inflight or self._set_state is None:
            return
        leader = self._leader
        if leader is None or leader == self.rpc.get_name():
            return
        self._state_req_at = time.monotonic()
        self._state_req_token += 1
        token = self._state_req_token
        self._state_req_inflight = True
        epoch = self._epoch

        def on_state(result, error):
            with self._lock:
                if token != self._state_req_token:
                    # Superseded: the watchdog wrote this request off and a
                    # newer one owns the gate — applying this (possibly
                    # older) snapshot now could regress applied state.
                    return
                if self._epoch != epoch or error is not None:
                    self._state_req_inflight = False
                    if error is not None:
                        log.debug("state request failed: %s", error)
                    return
                version = result["model_version"]
                # Results released before the sync are superseded by the
                # state: the user must not apply one on top of it. (One
                # being applied now lands before set_state, which the
                # user orders after it; its zero_gradients pops nothing.)
                self._results.clear()
            # Apply outside the lock: user callback may be slow (an upload).
            # The request gate stays closed until the apply has finished:
            # the reference reopens it here, so an update() during a slow
            # set_state sends a new request whose token supersedes this
            # one, the finished apply no longer marks the peer synced, and
            # a peer polled faster than its set_state runs never syncs.
            try:
                self._set_state(result["state"])
            finally:
                with self._lock:
                    if token == self._state_req_token:
                        self._state_req_inflight = False
            with self._lock:
                if self._epoch == epoch and token == self._state_req_token:
                    # Rounds settle on each member at its own time: the
                    # leader may have applied a round (it is inside the
                    # state) that this peer has not settled yet, or the
                    # other way round. Results park while unsynced; the
                    # ones before the leader's cursor are dropped, the
                    # rest released on top of the state. (A reference
                    # leader sends no cursor.)
                    cursor = result.get("release_gseq")
                    if cursor is not None and result.get("epoch") == epoch:
                        cursor = int(cursor)
                        for g in [g for g in self._grad_outcomes
                                  if g < cursor]:
                            del self._grad_outcomes[g]
                        self._release_gseq = max(self._release_gseq, cursor)
                    self._model_version = version
                    self._result_version = version
                    self._synced = True
                    self._release_ready_locked()
                    log.info("%s: state synced at v%d",
                             self.rpc.get_name(), version)

        try:
            self.rpc.async_callback(
                leader, "AccumulatorService::requestState", on_state
            )
        except BaseException:
            # Synchronous dispatch failure: without this restore the
            # request gate wedges and the peer never re-requests state
            # (on_state will never run to clear it).
            self._state_req_inflight = False
            raise

    def _maybe_broadcast_state(self):
        """Leader-side periodic full-state re-push to every member
        (reference: the 12s buffer / 600s model re-broadcast,
        src/accumulator.cc:761-795). Heals silent drift — a peer whose
        params diverged converges back without requesting anything."""
        if self._broadcast_interval is None or self._get_state is None:
            return
        with self._lock:
            if not self.is_leader() or not self._synced:
                return
            if self._results:
                return  # a result may be mid-apply: see _serve_state
            now = time.monotonic()
            if now - self._last_broadcast < self._broadcast_interval:
                return
            self._last_broadcast = now
            members = [
                m for m in self.group.members if m != self.rpc.get_name()
            ]
            if not members:
                return
            version = self._model_version - len(self._results)
            cursor = self._release_gseq
        # get_state (a full-model D2H in real use) must NOT run under the
        # lock — it would stall every RPC-thread round callback. Instead
        # verify after the fact that no result was released (cursor) or
        # applied (version formula) while we were copying; if one was, the
        # (state, version) pair may be torn, so skip this tick and let the
        # next interval broadcast.
        payload = {
            "state": _to_numpy_tree(self._get_state()),
            "model_version": version,
        }
        with self._lock:
            if (
                self._model_version - len(self._results) != version
                or self._release_gseq != cursor
            ):
                return
        for m in members:
            self.rpc.async_callback(
                m, "AccumulatorService::pushState",
                lambda _r, _e: None,  # best effort; next interval retries
                payload,
            )

    def _on_push_state(self, payload):
        """Member-side application of a leader state push."""
        if self._set_state is None:
            return False
        with self._lock:
            version = int(payload["model_version"])
            if self.is_leader() or self._applying_push:
                return False
            # Only apply when nothing is queued, parked, OR still reducing
            # locally: a round whose update is already inside the pushed
            # leader state could otherwise settle after the push and be
            # applied a second time by the training thread.
            if (
                self._results
                or self._grad_outcomes
                or self._grads_inflight
                or version < self._model_version
            ):
                return False
            # Freeze result release for the duration of the (slow, outside
            # the lock) apply: a result released + applied by the training
            # thread mid-apply would be silently clobbered by this push.
            self._applying_push = True
        try:
            self._set_state(payload["state"])  # outside the lock: an upload
        finally:
            with self._lock:
                self._applying_push = False
                if version >= self._model_version:
                    self._model_version = version
                    self._result_version = version
                    self._synced = True
                self._release_ready_locked()  # drain anything parked
        return True

    # -- reduce rounds ---------------------------------------------------------

    def _start_count_round(self):
        epoch = self._epoch
        seq = self._seq
        # Snapshot pending contributions for this round; they only commit if
        # the round SUCCEEDS (a failed round's counts never reached the
        # cluster, so its gradients must not enter a later grad round with
        # an unreported sample count).
        if (
            self._synced
            and len(self._results) + self._grads_inflight < self._parallel
        ):
            snap_parts = self._pending_parts
            snap_bs = self._pending_bs
            snap_ng = self._pending_ngrads
            self._pending_parts = []
            self._pending_bs = 0
            self._pending_ngrads = 0
        else:
            snap_parts, snap_bs, snap_ng = [], 0, 0
        self._round_inflight = True

        def restore_snapshot_locked():
            # snap_parts holds either the raw staged trees or, post-
            # materialization, the single summed numpy bundle — both
            # re-enter the pending list unchanged (order preserved: the
            # snapshot predates anything contributed since).
            self._pending_parts = snap_parts + self._pending_parts
            self._pending_bs += snap_bs
            self._pending_ngrads += snap_ng

        def done(fut):
            nonlocal snap_parts, snap_bs, snap_ng
            try:
                (total_bs, total_ng, all_templ, eff_vbs,
                 neg_chunk, eff_q, names) = fut.result(timeout=0)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                # The in-flight reduction was CANCELLED (elastic membership
                # change tearing down the round): restore the snapshot and
                # re-arm the round/poll gates exactly like a failure, then
                # PROPAGATE. Before moolint this fell into the broad
                # handler's compaction path or — worse — escaped it,
                # skipping the bookkeeping and wedging _round_inflight
                # forever. Compaction is skipped: raw staged parts restore
                # fine and the epoch reset usually re-counts them anyway.
                with self._lock:
                    restore_snapshot_locked()
                    if self._epoch == epoch:
                        self._round_inflight = False
                        self._attempt += 1
                        self._user_has_contributed = False
                raise
            except Exception as round_exc:
                # Compact the snapshot to ONE host-numpy bundle before
                # restoring (off the training thread, outside the lock):
                # repeated count-round failures re-open wants_gradients
                # each retry, and an uncompacted backlog would retain one
                # full staged gradient tree per retry — a pinned-memory
                # leak an eager numpy copy would not have. Compaction
                # failure (a device error) keeps the raw parts and
                # retries later — it must never abort before the locked
                # bookkeeping below, which would wedge _round_inflight
                # forever (callback exceptions are swallowed upstream).
                cancelled = None
                if snap_parts:
                    try:
                        snap_parts = [_materialize_parts(snap_parts)]
                    except (asyncio.CancelledError,
                            concurrent.futures.CancelledError) as e:
                        # Never swallow cancellation — but re-raise only
                        # AFTER the locked bookkeeping below, or
                        # _round_inflight wedges (see comment above).
                        cancelled = e
                    # Guarded by the deferred-raise handler above — the
                    # rule only sees an immediate `raise`:
                    except Exception as e:  # moolint: disable=swallow-cancelled
                        log.error("gradient compaction failed "
                                  "(kept staged): %s", e)
                self._m_count_round_failures.inc()
                with self._lock:
                    restore_snapshot_locked()
                    self._note_round_failure_locked(
                        "count", seq, str(round_exc)
                    )
                    if self._epoch == epoch:
                        self._round_inflight = False
                        self._dark_failures += 1  # gates retries if dark
                        # Retry under a fresh key: parked partials from the
                        # failed attempt must never merge into the retry.
                        self._attempt += 1
                        # The user answered this round's poll; re-open the
                        # wants_gradients window for the retry.
                        self._user_has_contributed = False
                if cancelled is not None:
                    raise cancelled
                return
            # The count succeeded: materialize + sum the staged device
            # trees HERE — on the RPC completion thread, outside the lock.
            # This is where the deferred D2H from reduce_gradients actually
            # lands; by now the async transfers have had a full count-round
            # RTT to complete, so this is normally a wait-free fetch.
            #
            # Materialization failure (device died between dispatch and
            # readback) must not abort this callback: the cluster already
            # counted our batch contribution, so the round proceeds with
            # our bundle DROPPED (the same semantics as a peer dying
            # mid-round, which the elastic protocol tolerates) — silently
            # wedging _round_inflight would stall the whole cohort.
            cancelled = None
            if snap_parts:
                try:
                    snap_parts = [_materialize_parts(snap_parts)]
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError) as e:
                    # Never swallow cancellation — but the cluster already
                    # counted our contribution, so run the same
                    # drop-the-bundle bookkeeping as a failed readback
                    # FIRST and re-raise after the locked section below
                    # (aborting here would wedge _round_inflight).
                    cancelled = e
                    snap_parts = []
                    snap_bs = 0
                    snap_ng = 0
                # Guarded by the deferred-raise handler above — the rule
                # only sees an immediate `raise`:
                except Exception as e:  # moolint: disable=swallow-cancelled
                    log.error(
                        "gradient readback failed; dropping %d staged "
                        "contribution(s) from this round: %s",
                        snap_ng, e,
                    )
                    snap_parts = []
                    snap_bs = 0
                    snap_ng = 0
            snap_bundle = snap_parts[0] if snap_parts else None
            try:
                self._commit_count_round_locked(
                    epoch, seq, snap_bundle, snap_bs, snap_ng,
                    restore_snapshot_locked,
                    total_bs, all_templ, eff_vbs, neg_chunk, eff_q, names,
                )
            finally:
                if cancelled is not None:
                    raise cancelled

        try:
            fut = self.group.all_reduce(
                f"acc.count.{seq}.{self._attempt}",
                (snap_bs, snap_ng, self._bundle_template is not None,
                 self.virtual_batch_size, self._chunk_bytes,
                 0 if self._min_quorum is None else self._min_quorum,
                 (self.rpc.get_name(),)),
                op=_count_merge,
                # Straggler write-offs only when the NEGOTIATED quorum
                # (strictest across members, from the previous count
                # round) names fewer members than the roster: a partial
                # result against a require-all commit rule could only
                # ever be rejected, so writing stragglers off would
                # livelock rounds that plain waiting wins.
                straggler_timeout=(
                    self._straggler_timeout
                    if (self._neg_quorum is not None
                        and 0 < self._neg_quorum < len(self.group.members))
                    else None
                ),
            )
        except RpcError:
            with self._lock:
                restore_snapshot_locked()
                self._round_inflight = False
            return
        fut.add_done_callback(done)

    def _note_round_failure_locked(self, kind: str, seq: int, error: str):
        """One failed round (count or gradient) into the black box; a run
        of ``_storm_threshold`` consecutive failures marks an incident
        capture as due (performed by ``update()`` outside the lock —
        capture writes files and dumps stacks, never under ``_lock``)."""
        if self._flight.on:
            self._flight.record("acc_round_failure", kind=kind,
                                seq=int(seq), error=str(error)[:200])
        self._storm_failures += 1
        if self._storm_failures == self._storm_threshold:
            self._storm_capture_due = self._storm_failures

    def _repend_locked(self, bundle, bs, ngrads):
        """Return an already-committed contribution to the pending list so
        it re-enters a later count round — the path for contributions a
        quorum commit provably excluded (never double-applied: the
        committed sum demonstrably lacks them)."""
        if bundle is not None:
            self._pending_parts.insert(0, bundle)
        self._pending_bs += bs
        self._pending_ngrads += ngrads

    def _commit_count_round_locked(self, epoch, seq, snap_bundle, snap_bs,
                                   snap_ng, restore_snapshot_locked,
                                   total_bs, all_templ, eff_vbs, neg_chunk,
                                   eff_q, names):
        """Locked tail of a successful count round: apply the quorum
        commit rule, commit the snapshot, advance the sequence, and
        trigger the gradient round when the allreduced cumulative count
        crosses the virtual batch size."""
        with self._lock:
            if self._epoch != epoch:
                # Success for a dead epoch: counts were discarded by the
                # reset, so re-contribute in the new epoch.
                restore_snapshot_locked()
                return
            self._round_inflight = False
            # The negotiated quorum gates the NEXT round's straggler
            # write-offs (recorded from rejected rounds too — the
            # negotiation itself succeeded either way).
            self._neg_quorum = int(eff_q)
            # Membership is epoch-stable (a change mints a new sync id,
            # which cancels the round), so this is the round's roster.
            n = len(self.group.members) or 1
            required = n if eff_q <= 0 else min(int(eff_q), n)
            if len(names) < required:
                # Below quorum: every member sees the same result and
                # rejects identically — the partial totals are discarded,
                # the snapshot re-enters pending, and the round retries
                # under a fresh attempt key.
                self._m_quorum_rejected.inc()
                if self._flight.on:
                    self._flight.record(
                        "acc_round_reject", kind="count", seq=int(seq),
                        participants=len(names), required=int(required),
                    )
                restore_snapshot_locked()
                self._attempt += 1
                self._user_has_contributed = False
                return
            self._dark_failures = 0
            self._seq = seq + 1
            self._m_count_rounds.inc()
            self._storm_failures = 0  # a committed round ends any storm
            if self._flight.on:
                self._flight.record(
                    "acc_round_commit", kind="count", seq=int(seq),
                    participants=len(names), members=int(n),
                )
            # A count round resolved the current wants_gradients poll;
            # peers may contribute again toward the (still unfilled)
            # virtual batch — all-skip cycles must not livelock
            # (reference: wantsGradients re-arms each cycle,
            # src/moolib.cc:1645-1862).
            self._user_has_contributed = False
            if self.rpc.get_name() in names:
                self._committed_bundle = _tree_add(
                    self._committed_bundle, snap_bundle
                )
                self._committed_bs += snap_bs
                self._committed_ngrads += snap_ng
            else:
                # Written off this round: total_bs provably excludes this
                # snapshot, so it re-enters pending and is re-counted by
                # the next round (late contribution, never lost and never
                # double-counted).
                if snap_bs or snap_ng or snap_bundle is not None:
                    self._m_recontributed.inc()
                restore_snapshot_locked()
            if len(names) < n:
                self._m_partial_count_rounds.inc()
                self._m_writeoffs.inc(n - len(names))
                if self._flight.on:
                    self._flight.record(
                        "acc_writeoff", kind="count", seq=int(seq),
                        written_off=n - len(names),
                    )
            self._cumulative_bs += total_bs
            # eff_vbs and all_templ are identical on every member
            # (they came out of the allreduce), so every member makes
            # the same trigger decision and picks the same wire format
            # — regardless of when a local set_virtual_batch_size call
            # landed relative to this completion.
            self._neg_chunk = neg_chunk
            if eff_vbs <= self._cumulative_bs:
                self._start_grad_round(
                    self._cumulative_bs, chunked=bool(all_templ),
                    chunk_bytes=neg_chunk, quorum=int(eff_q),
                )

    def _release_ready_locked(self):
        """Release contiguous settled rounds to the user, in gseq order.
        Paused while a leader state push is being applied (_applying_push):
        a result released mid-apply could be applied by the training thread
        and then silently clobbered by the older pushed state."""
        if self._applying_push or not self._synced:
            # Unsynced, a result may be one the state about to arrive
            # already holds: park it until the sync says which.
            return
        while self._release_gseq in self._grad_outcomes:
            out = self._grad_outcomes.pop(self._release_gseq)
            self._release_gseq += 1
            if out is None:
                continue  # failed round or nobody contributed
            self._model_version += 1
            # Third element: version of the params a user holds AFTER
            # applying this result — lets callers label checkpoints
            # race-free while _model_version keeps moving on RPC threads.
            self._results.append((out[0], out[1], self._model_version))

    def _start_grad_round(self, count: int, chunked: bool = False,
                          chunk_bytes: Optional[int] = None,
                          quorum: int = 0):
        """All peers enter deterministically once counts cross the virtual
        batch size (reference: startReduce, src/accumulator.cc:1005-1033).

        The round key (gseq) is claimed at START — grad-round starts are
        triggered inside count-round completions, which are totally ordered,
        so keys agree across peers even with several rounds in flight.

        ``chunked`` and ``chunk_bytes`` (both negotiated through the count
        round, identical on every member): the payload becomes
        ``{"b": bundle-or-zeros, "n": [ng]}`` under the BUILTIN sum — the
        group layer then pipelines it through the tree as a bounded number
        of concurrent chunks (size ``max(chunk_bytes, total/_CHUNK_DEPTH)``,
        see rpc/group.py) with in-place merges, where the None-tolerant
        custom merge ships one monolithic message per hop. Non-contributors
        pay a zeros bundle; contributors (the common steady-state case) pay
        nothing extra.

        ``quorum`` (negotiated through the count round that triggered this
        round, identical on every member; 0 = require all): when it names
        fewer members than the roster, the round runs in quorum mode — a
        monolithic custom merge that carries (bundle, n_grads, batch_sum,
        names) so the straggler write-offs the group layer performs at
        the straggler deadline stay visible in the result. A committed
        quorum round divides by the PARTICIPATING batch sum, members
        missing from ``names`` re-contribute their bundle next round, and
        a result below quorum is rejected identically everywhere. Quorum
        rounds are never chunked (a partial cut of independent sub-ops
        could commit different participant sets per chunk).
        """
        epoch = self._epoch
        gseq = self._gseq
        self._gseq = gseq + 1
        bundle = self._committed_bundle
        ngrads = self._committed_ngrads
        bs_stake = self._committed_bs
        self._committed_bundle = None
        self._committed_bs = 0
        self._committed_ngrads = 0
        n_start = len(self.group.members) or 1
        quorum_mode = 0 < quorum < n_start
        required = n_start if quorum <= 0 else min(int(quorum), n_start)
        if quorum_mode:
            chunked = False
        # Telemetry before the gate raise: nothing between raising
        # _grads_inflight and handing off to the collective may throw.
        round_t0 = time.monotonic()
        self._m_grad_rounds.inc()
        if chunked:
            self._m_chunked_rounds.inc()
        self._grads_inflight += 1
        self._cumulative_bs = 0

        def settle_locked(outcome):
            """Park this round's outcome, release any now-contiguous ones."""
            self._grads_inflight -= 1
            if gseq < self._release_gseq:
                return  # inside the state a sync brought (on_state)
            self._grad_outcomes[gseq] = outcome
            self._release_ready_locked()

        def done(fut):
            try:
                if chunked:
                    res = fut.result(timeout=0)
                    total_ng = int(res["n"][0])
                    total_bundle = res["b"] if total_ng > 0 else None
                    q_names = q_bs = None
                elif quorum_mode:
                    (total_bundle, total_ng, q_bs,
                     q_names) = fut.result(timeout=0)
                else:
                    total_bundle, total_ng = fut.result(timeout=0)
                    q_names = q_bs = None
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                # Cancelled mid-reduction (membership change): settle this
                # round as failed so the release cursor keeps up with the
                # cluster, mark for resync, then PROPAGATE the
                # cancellation instead of eating it.
                with self._lock:
                    if self._epoch == epoch:
                        settle_locked(None)
                        if self._set_state is not None \
                                and not self.is_leader():
                            self._synced = False
                raise
            except Exception as e:
                self._m_rounds_failed.inc()
                with self._lock:
                    self._note_round_failure_locked("gradient", gseq, str(e))
                    if self._epoch == epoch:
                        settle_locked(None)
                        self._dark_failures += 1
                        # Peers that completed this round applied an update we
                        # missed: our params are now stale. Force a state
                        # re-request from the leader instead of training on.
                        if self._set_state is not None and not self.is_leader():
                            self._synced = False
                        log.debug("gradient round failed: %s", e)
                return
            round_dt = time.monotonic() - round_t0
            self._m_grad_round_dur.observe(round_dt)
            with self._lock:
                local_s = self._scope_local_s
                self._scope_local_s = 0.0
            # Outside _lock (telemetry-outside-locks discipline); the
            # round's wire_wait is its lifetime minus this peer's own
            # local-reduce work in the window.
            self._scope.observe_step(
                round_dt,
                {"local_reduce": min(local_s, round_dt),
                 "wire_wait": max(round_dt - local_s, 0.0)},
            )
            with self._lock:
                if self._epoch != epoch:
                    return
                self._dark_failures = 0
                divisor = count
                if quorum_mode:
                    if len(q_names) < required:
                        # Below quorum: identical result on every member,
                        # so everyone rejects, discards the partial sum,
                        # and re-pends its own stake for the next round.
                        self._m_quorum_rejected.inc()
                        if self._flight.on:
                            self._flight.record(
                                "acc_round_reject", kind="gradient",
                                seq=int(gseq), participants=len(q_names),
                                required=int(required),
                            )
                        self._repend_locked(bundle, bs_stake, ngrads)
                        settle_locked(None)
                        return
                    self._m_participation.observe(len(q_names) / n_start)
                    self._last_participation = (len(q_names), n_start)
                    if len(q_names) < n_start:
                        self._m_partial_grad_rounds.inc()
                        self._m_writeoffs.inc(n_start - len(q_names))
                        if self._flight.on:
                            self._flight.record(
                                "acc_writeoff", kind="gradient",
                                seq=int(gseq),
                                written_off=n_start - len(q_names),
                            )
                    if self.rpc.get_name() not in q_names:
                        # My bundle provably missed the committed sum:
                        # late contribution — it re-enters pending and
                        # lands in a later round, never double-applied.
                        if bundle is not None:
                            self._m_recontributed.inc()
                        self._repend_locked(bundle, bs_stake, ngrads)
                    # The mean divides by the PARTICIPATING batch sum:
                    # written-off samples are not in the numerator, so
                    # they must not be in the denominator either.
                    divisor = q_bs
                if total_bundle is None or (quorum_mode and q_bs <= 0):
                    self._m_rounds_empty.inc()
                    settle_locked(None)  # nobody contributed
                    return
                if self._bundle_template is None:
                    # Joiner: the first observed result teaches the wire
                    # shape, flipping future rounds to the chunked format.
                    self._bundle_template = _bundle_spec(total_bundle)
                mean = nest.map_structure(
                    lambda x: x / divisor, total_bundle
                )
                self._storm_failures = 0  # a committed round ends any storm
                if self._flight.on:
                    self._flight.record(
                        "acc_round_commit", kind="gradient", seq=int(gseq),
                        participants=(len(q_names) if quorum_mode
                                      else n_start),
                        members=int(n_start),
                    )
                settle_locked((mean, divisor))

        try:
            if chunked:
                if bundle is not None:
                    payload_bundle = bundle
                else:
                    if self._zeros_bundle is None:
                        self._zeros_bundle = nest.map_structure(
                            _zeros, self._bundle_template,
                        )
                    payload_bundle = self._zeros_bundle
                fut = self.group.all_reduce(
                    f"acc.grads.{gseq}",
                    {"b": payload_bundle,
                     "n": np.array([ngrads], np.int64)},
                    op="sum",
                    chunk_bytes=chunk_bytes,
                )
            elif quorum_mode:
                fut = self.group.all_reduce(
                    f"acc.grads.{gseq}",
                    (bundle, ngrads, bs_stake, (self.rpc.get_name(),)),
                    op=_qgrad_merge,
                    straggler_timeout=self._straggler_timeout,
                )
            else:
                fut = self.group.all_reduce(
                    f"acc.grads.{gseq}", (bundle, ngrads), op=_grad_merge
                )
        except RpcError as e:
            # Mirror the async-failure path so this peer's release cursor
            # doesn't fall permanently behind the cluster's round keys.
            # (Lock already held here: _start_grad_round runs inside
            # _commit_count_round_locked's critical section.)
            self._m_rounds_failed.inc()
            self._note_round_failure_locked("gradient", gseq, str(e))
            settle_locked(None)
            if self._set_state is not None and not self.is_leader():
                self._synced = False
            return
        fut.add_done_callback(done)

    # -- misc -----------------------------------------------------------------

    def get_gradient_stats(self) -> dict:
        """Stats dict (reference surface) — a thin view: cumulative round
        counters read from the telemetry registry (the one source of
        truth; also scrapeable on the Rpc's ``__telemetry`` endpoint),
        per-epoch sequence numbers and liveness flags read from the live
        protocol state the registry's gauge callbacks export."""
        with self._lock:
            return {
                "model_version": self._model_version,
                "cumulative_batch_size": self._cumulative_bs,
                # Per-epoch protocol sequences (reset on resync); the
                # cross-epoch cumulative counts are acc_count_rounds_total
                # / acc_gradient_rounds_total in the registry.
                "count_rounds": self._seq,
                "gradient_rounds": self._gseq,
                "chunked_gradient_rounds":
                    int(self._m_chunked_rounds.value),
                "negotiated_chunk_bytes": self._neg_chunk,
                "gradient_rounds_inflight": self._grads_inflight,
                "results_queued": len(self._results),
                "parallel_gradients": self._parallel,
                "leader": self._leader,
                "synced": self._synced,
                "broker_connected": self.group.broker_connected(),
                "dark_failures": self._dark_failures,
                "elections": int(self._m_elections.value),
                "skipped_rounds": int(self._m_rounds_empty.value),
                "min_quorum": self._min_quorum,
                "negotiated_quorum": self._neg_quorum,
                "last_participation": self._last_participation,
                "quorum_rejected": int(self._m_quorum_rejected.value),
                "straggler_writeoffs": int(self._m_writeoffs.value),
                "recontributed": int(self._m_recontributed.value),
            }

    def close(self):
        if self._closed:
            return
        self._closed = True
        reg = self.rpc.telemetry.registry
        for name in self._gauge_names:
            reg.unregister(name)
        self._scope.close()
        for name in self._endpoint_names:
            self.rpc.undefine(name)
        if self._owns_group:
            self.group.close()
