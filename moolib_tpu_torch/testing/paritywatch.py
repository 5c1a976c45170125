"""paritywatch: bitwise replay checks; the port's twin of
:mod:`moolib_tpu.testing.paritywatch`.

A seeded computation must be **bitwise** reproducible, and the Group
allreduce tree must produce bit-identical results no matter in which
order the peers show up (the reduction-order contract pinned in
rpc/group.py's module docstring).

Two checks:

- :class:`ParityWatch` runs a seeded callable ``runs`` times (default
  twice) in one process and compares the result trees bit-for-bit.
  On divergence it raises :class:`ParityViolation` naming the first
  divergent leaf *path*, its dtype/shape, how many elements differ,
  the first differing element pair, and the maximum ULP distance —
  the report a numerics bisect actually needs, not a bare "arrays
  differ". ``rtol``/``atol`` opt out of bitwise into a tolerance
  compare for callers that knowingly reassociate.
- :func:`allreduce_order_parity` stands up a real N-peer Group cohort
  over loopback TCP, runs one allreduce round per arrival permutation —
  staggering each peer's op start to force different interleavings at
  the interior nodes — and asserts every peer in every permutation got
  the *same bits*. Payloads mix exponents so any reassociation would
  actually change the bits.

Leaves may be numpy arrays, numpy scalars, Python numbers or torch
tensors on any device (a card tensor is copied to the host first). They
are compared by their raw bits. A torch dtype without a numpy twin
(``bfloat16``, the ``float8`` family) is viewed as the signed integer of
its width, and its ULP distance is computed on that view; its dtype is
named as torch names it (``bfloat16``), and its differing pair is printed
as floats.

Comparison is bitwise by design: tolerances hide exactly the class of
bug (order-dependent summation, dtype drift) this gate exists to
catch. ULP distance is reported, never thresholded.

Off switch: ``MOOLIB_TPU_PARITYWATCH=0`` (or ``enabled=False``) turns
:meth:`ParityWatch.check` into a single plain call — nothing is
re-run, nothing compared.

Usage (the gate's shape)::

    watch = ParityWatch(label="a2c-update")
    out = watch.check(lambda: one_update(seed=0))  # runs twice, raises
    # ParityViolation on the first divergent leaf — or returns the
    # first run's result. The callable owns its seeding: a torch train
    # step updates its model in place, so each run rebuilds the state.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ParityWatch", "ParityViolation", "parity_enabled",
           "flatten_with_paths", "ulp_distance", "allreduce_order_parity",
           "order_sensitive_payloads", "tree_fixed_fold"]

#: numpy kind 'f' covers f2/f4/f8; extension float dtypes (ml_dtypes'
#: bfloat16 / float8 family, registered with kind 'V') are matched by
#: name so their ULP distance still computes through the uint view.
_EXT_FLOAT_NAMES = ("bfloat16", "float8")


class ParityViolation(AssertionError):
    """Two runs (or two peers) that must agree bit-for-bit did not;
    the message names the first divergent leaf, dtype, element count,
    first differing pair, and max ULP distance."""


def parity_enabled(default: bool = True) -> bool:
    """The environment gate: ``MOOLIB_TPU_PARITYWATCH=0`` disables
    every :class:`ParityWatch` in the process; anything else leaves
    ``default``."""
    v = os.environ.get("MOOLIB_TPU_PARITYWATCH", "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return False
    if v in ("1", "on", "true", "yes"):
        return True
    return default


def _is_floatish(dtype: np.dtype) -> bool:
    return dtype.kind == "f" or any(
        n in dtype.name for n in _EXT_FLOAT_NAMES
    )


class _Leaf:
    """One leaf on the host: ``bits`` (a contiguous numpy array holding
    the leaf's raw bits: the array itself, or a same-width integer view
    of a torch dtype numpy lacks), ``values`` (what the differing pair
    and a tolerance compare read), its dtype ``name`` and whether it is
    a float."""

    __slots__ = ("bits", "values", "name", "floatish")

    def __init__(self, x: Any):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            self.name = str(t.dtype).rsplit(".", 1)[-1]
            self.floatish = t.is_floating_point()
            try:
                self.bits = t.numpy()
                self.values = self.bits
            except TypeError:  # no numpy dtype: bfloat16, float8_*
                width = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                         8: torch.int64}[t.element_size()]
                self.bits = t.view(width).numpy()
                self.values = t.to(torch.float64).numpy()
            return
        a = np.ascontiguousarray(np.asarray(x))
        self.bits = self.values = a
        self.name = a.dtype.name
        self.floatish = _is_floatish(a.dtype)

    @property
    def shape(self) -> tuple:
        return self.bits.shape


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's canonical traversal
    order: dict keys are SORTED (what ``nest.flatten`` does — the reason
    plain dict payloads are replay-deterministic), sequences
    keep positional order, ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:  # mixed/unorderable keys: sort like repr
            keys = sorted(tree, key=repr)
        out: List[Tuple[str, Any]] = []
        for k in keys:
            out.extend(flatten_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)  # namedtuple: field order
        out = []
        for i, v in enumerate(tree):
            part = f".{fields[i]}" if fields else f"[{i}]"
            out.extend(flatten_with_paths(v, prefix + part))
        return out
    return [(prefix or "<root>", tree)]


def _float_rank(a: np.ndarray) -> np.ndarray:
    """Map float bit patterns to uint64 ranks monotonic in the float
    ordering, so ``|rank(a) - rank(b)|`` is the ULP distance (adjacent
    representable values differ by 1; -0.0 and +0.0 are adjacent)."""
    bits = 8 * a.dtype.itemsize
    u = np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")
    u = u.astype(np.uint64)
    sign = np.uint64(1) << np.uint64(bits - 1)
    full = (np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(64 - bits))
    return np.where(u & sign, full - u, u + sign)


def ulp_distance(a: Any, b: Any) -> int:
    """Max ULP distance between two same-dtype float arrays or tensors
    (units in the last place: the number of representable values between
    the most-divergent element pair). NaN bit patterns compare by their
    raw rank — two different NaNs have a nonzero distance, which is
    exactly what a bitwise gate wants to surface."""
    la, lb = _Leaf(a), _Leaf(b)
    if la.name != lb.name or not la.floatish:
        raise ValueError(
            f"ulp_distance wants same-dtype float arrays, got "
            f"{la.name}/{lb.name}"
        )
    ra, rb = _float_rank(la.bits), _float_rank(lb.bits)
    diff = np.where(ra > rb, ra - rb, rb - ra)  # exact in uint64
    return int(diff.max()) if diff.size else 0


def _first_divergence(a: _Leaf, b: _Leaf) -> Tuple[int, tuple, int]:
    """(differing element count, first differing index, max ULP or -1)
    for two same-dtype same-shape leaves that are not byte-identical."""
    if a.bits.dtype.kind == "V" and not a.floatish:
        return 1, (), -1  # opaque records: no elementwise view
    if a.floatish:
        ar = _float_rank(a.bits).reshape(-1)
        br = _float_rank(b.bits).reshape(-1)
        mask = ar != br
        ulp = int(np.where(ar > br, ar - br, br - ar).max())
    else:
        mask = a.bits.reshape(-1) != b.bits.reshape(-1)
        ulp = -1
    n = int(mask.sum())
    if n == 0:  # bytes differed but values did not (e.g. padding)
        return 0, (), ulp
    flat_idx = int(np.argmax(mask))
    idx = tuple(
        int(i) for i in np.unravel_index(flat_idx, a.shape)
    ) if a.shape else ()
    return n, idx, ulp


class ParityWatch:
    """Bitwise replay gate for seeded computations.

    Parameters
    ----------
    runs:
        How many times :meth:`check` invokes the callable (default 2);
        every run is compared against the first.
    rtol, atol:
        ``None``/``None`` (default) is the bitwise contract. Setting
        either switches :meth:`compare` to ``np.allclose`` — the
        explicit opt-out for callers that knowingly reassociate; the
        divergence report still includes the ULP distance so the
        opt-out's cost stays visible.
    enabled:
        ``None`` consults :func:`parity_enabled`; ``False`` makes
        :meth:`check` a single plain call.
    label:
        Names the gate in violation messages.
    """

    def __init__(self, *, runs: int = 2, rtol: Optional[float] = None,
                 atol: Optional[float] = None,
                 enabled: Optional[bool] = None,
                 label: str = "paritywatch"):
        if runs < 2:
            raise ValueError("runs must be >= 2 (nothing to compare)")
        self.runs = int(runs)
        self.rtol = rtol
        self.atol = atol
        self.label = label
        self.enabled = parity_enabled() if enabled is None else bool(enabled)

    @property
    def bitwise(self) -> bool:
        return self.rtol is None and self.atol is None

    # -- comparison core ------------------------------------------------------

    def compare(self, ref: Any, other: Any,
                context: str = "run 2 vs run 1") -> None:
        """Assert ``other`` equals ``ref`` (bitwise, or within
        rtol/atol when opted out); raise :class:`ParityViolation` at
        the first divergent leaf otherwise. Device arrays are
        materialized to host — this is a test harness, not a hot
        path."""
        ref_leaves = flatten_with_paths(ref)
        other_leaves = flatten_with_paths(other)
        if [p for p, _ in ref_leaves] != [p for p, _ in other_leaves]:
            rp = [p for p, _ in ref_leaves]
            op = [p for p, _ in other_leaves]
            extra = [p for p in op if p not in rp][:3]
            gone = [p for p in rp if p not in op][:3]
            raise ParityViolation(
                f"{self.label}: pytree STRUCTURE diverged ({context}): "
                f"{len(rp)} vs {len(op)} leaves"
                + (f"; new paths {extra}" if extra else "")
                + (f"; missing paths {gone}" if gone else "")
            )
        for (path, a_raw), (_p, b_raw) in zip(ref_leaves, other_leaves):
            a, b = _Leaf(a_raw), _Leaf(b_raw)
            if a.name != b.name:
                raise ParityViolation(
                    f"{self.label}: leaf {path} changed dtype "
                    f"({context}): {a.name} vs {b.name} — promotion "
                    f"or precision drift between runs"
                )
            if a.shape != b.shape:
                raise ParityViolation(
                    f"{self.label}: leaf {path} changed shape "
                    f"({context}): {a.shape} vs {b.shape}"
                )
            if a.bits.tobytes() == b.bits.tobytes():
                continue
            if not self.bitwise and a.floatish:
                if np.allclose(np.asarray(a.values, np.float64),
                               np.asarray(b.values, np.float64),
                               rtol=self.rtol or 0.0,
                               atol=self.atol or 0.0, equal_nan=True):
                    continue
            n, idx, ulp = _first_divergence(a, b)
            if n == 0 and self.bitwise:
                continue  # byte padding noise, values identical
            first = ""
            if idx is not None and a.bits.size:
                av0 = a.values[idx] if a.shape else a.values[()]
                bv0 = b.values[idx] if b.shape else b.values[()]
                first = (f"; first at index {idx}: "
                         f"{av0.item()!r} vs {bv0.item()!r}")
            ulp_s = f"; max ULP distance {ulp}" if ulp >= 0 else ""
            mode = "bitwise" if self.bitwise else (
                f"rtol={self.rtol} atol={self.atol}")
            raise ParityViolation(
                f"{self.label}: first divergent leaf at {path} "
                f"({context}, {mode}): dtype={a.name} shape={a.shape} "
                f"{n}/{a.bits.size} element(s) differ{first}{ulp_s}"
            )

    # -- the replay gate ------------------------------------------------------

    def check(self, fn: Callable[..., Any], *args: Any,
              **kwargs: Any) -> Any:
        """Call ``fn(*args, **kwargs)`` ``runs`` times and compare
        every result pytree against the first, bit-for-bit. Returns
        the first run's result. The callable owns its own seeding —
        the gate proves the *computation* is replay-deterministic, so
        ``fn`` must thread identical seeds/state into every run (a
        torch model updated in place is rebuilt for each run)."""
        ref = fn(*args, **kwargs)
        if not self.enabled:
            return ref
        for k in range(1, self.runs):
            out = fn(*args, **kwargs)
            self.compare(ref, out, context=f"run {k + 1} vs run 1")
        return ref


# -- allreduce arrival-order invariance ---------------------------------------

#: Default arrival permutations for a 4-peer cohort: identity, full
#: reversal, and an interleave that swaps sibling subtrees at the root.
_DEFAULT_PERMS: Tuple[Tuple[int, ...], ...] = (
    (0, 1, 2, 3), (3, 2, 1, 0), (2, 0, 3, 1),
)


def order_sensitive_payloads(n_peers: int, size: int = 1024,
                             seed: int = 0) -> List[np.ndarray]:
    """Per-peer fp32 payloads with mixed exponents, so any
    reassociation of the sum actually changes the result bits (a
    uniform payload would hide an order bug behind symmetric values)."""
    rng = np.random.default_rng(seed)
    scales = [1e6, 1.0, 1e-3, 3e2, 1e-6, 7.0]
    return [
        (rng.standard_normal(size) * scales[i % len(scales)]).astype(
            np.float32
        )
        for i in range(n_peers)
    ]


def tree_fixed_fold(payloads_in_member_order: List[np.ndarray],
                    op: Callable = np.add) -> np.ndarray:
    """The host-side reference for rpc/group.py's reduction-order
    contract: node ``i`` folds ``own ⊕ subtree(2i+1) ⊕ subtree(2i+2)``
    in child-index order. ``payloads_in_member_order`` indexes by TREE
    position (the group's member-list order, which the broker's join
    order decides — not necessarily construction order)."""
    n = len(payloads_in_member_order)

    def fold(i: int) -> np.ndarray:
        acc = payloads_in_member_order[i]
        for c in (2 * i + 1, 2 * i + 2):
            if c < n:
                acc = op(acc, fold(c))
        return acc

    return fold(0)


def allreduce_order_parity(
    n_peers: int = 4,
    perms: Sequence[Sequence[int]] = _DEFAULT_PERMS,
    payloads: Optional[List[np.ndarray]] = None,
    stagger_s: float = 0.05,
    timeout: float = 120.0,
) -> np.ndarray:
    """Stand up a real ``n_peers`` Group cohort over loopback TCP and
    prove the allreduce is participant-arrival-order invariant: one
    reduce round per permutation in ``perms``, with each peer's op
    started ``stagger_s`` apart in the permuted order (so partials hit
    the interior nodes in different interleavings), asserting every
    peer in every round returned the SAME BITS — and that those bits
    equal :func:`tree_fixed_fold` over the actual membership order,
    i.e. the documented contract, not merely *some* stable order.
    Returns the reference result array.

    This is the runtime pin for the reduction-order contract in
    rpc/group.py: before the fixed child-index merge, the root's fold
    of its two subtrees followed arrival timing and this check flakes;
    with the contract it must never."""
    from ..rpc import Rpc
    from ..rpc.broker import Broker
    from ..rpc.group import Group
    from ..utils import set_log_level

    for perm in perms:
        if sorted(perm) != list(range(n_peers)):
            raise ValueError(f"{perm} is not a permutation of "
                             f"range({n_peers})")
    if payloads is None:
        payloads = order_sensitive_payloads(n_peers)
    if len(payloads) != n_peers:
        raise ValueError("need one payload per peer")

    set_log_level("error")
    broker_rpc = Rpc("parity-broker")
    broker_rpc.listen("127.0.0.1:0")
    addr = broker_rpc.debug_info()["listen"][0]
    broker = Broker(broker_rpc)
    stop = threading.Event()

    def pump_broker():
        while not stop.is_set():
            broker.update()
            time.sleep(0.02)

    threading.Thread(target=pump_broker, daemon=True).start()

    rpcs: List[Any] = []
    groups: List[Any] = []
    watch = ParityWatch(label="allreduce-order", enabled=True)
    try:
        for i in range(n_peers):
            r = Rpc(f"parity-ar-{i}")
            r.listen("127.0.0.1:0")
            r.connect(addr)
            g = Group(r, group_name="parity",
                      broker_name="parity-broker", timeout=timeout)
            rpcs.append(r)
            groups.append(g)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            for g in groups:
                g.update()
            if all(len(g.members) == n_peers and g.active()
                   for g in groups):
                break
            time.sleep(0.02)
        else:
            raise RuntimeError("parity cohort never stabilized")
        # Tree position = member-list order (broker join order), so the
        # host-side contract fold must be computed from it, not from
        # construction order.
        by_name = {r.get_name(): payloads[i] for i, r in enumerate(rpcs)}
        expected = tree_fixed_fold(
            [by_name[m] for m in groups[0].members]
        )

        def pump():
            while not stop.is_set():
                for g in groups:
                    g.update()
                time.sleep(0.05)

        threading.Thread(target=pump, daemon=True).start()

        reference = expected  # every peer/round must match the contract
        for ri, perm in enumerate(perms):
            tag = f"order-{ri}"
            futs: Dict[int, Any] = {}
            for pos, peer in enumerate(perm):
                if pos and stagger_s:
                    time.sleep(stagger_s)
                futs[peer] = groups[peer].all_reduce(
                    tag, payloads[peer].copy()
                )
            results = {p: np.asarray(f.result(timeout=timeout))
                       for p, f in futs.items()}
            for peer in range(n_peers):
                watch.compare(
                    reference, results[peer],
                    context=f"arrival order {tuple(perm)}, peer {peer} "
                            f"vs the host-side fixed fold",
                )
        return reference
    finally:
        stop.set()
        for g in groups:
            g.close()
        for r in rpcs:
            r.close()
        broker_rpc.close()
