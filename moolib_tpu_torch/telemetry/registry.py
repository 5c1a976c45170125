"""Metrics registry: counters, gauges, fixed-log-bucket histograms; the
counterpart of :mod:`moolib_tpu.telemetry.registry`, with the same
series ids, bucket edges, value formatting and Prometheus text, so a
snapshot or a scrape of either package reads the same.

Prometheus-shaped but dependency-free, and tuned for hot paths:

- **lock-cheap**: every metric guards its state with one
  ``threading.Lock`` whose critical section is a single float/int update.
- **near-zero when disabled**: instrument sites guard on
  ``Telemetry.on`` (one attribute load + branch) and skip metric lookups,
  timestamps, and recording entirely.
- **deterministic snapshots**: :meth:`Registry.snapshot` orders series by
  their canonical id, so two registries holding the same state produce
  byte-identical JSON regardless of metric creation order.

Histograms use *fixed log buckets* (default: powers of two from 1µs to
64s) exported Prometheus-style as cumulative ``le`` counts — bucket edges
use ``value <= edge`` semantics, so a value exactly on an edge lands in
that edge's bucket, zero lands in the first bucket, and +Inf in the
implicit ``+Inf`` bucket (NaN observations are dropped: they carry no
ordering and would poison ``sum``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import math
import os
import re
import threading
from bisect import bisect_left, insort
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_TIME_EDGES",
    "FRACTION_EDGES",
    "EXPORT_QUANTILES",
    "DEFAULT_LABEL_CARDINALITY",
    "OVERFLOW_LABEL",
    "parse_prometheus",
    "quantile_from_export",
]

#: Label value a series family's overflow folds into once the family has
#: seen :data:`DEFAULT_LABEL_CARDINALITY` distinct values (env override
#: ``MOOLIB_TPU_LABEL_CARDINALITY``). Wire-controlled strings (peer
#: names, endpoint names, stepscope phase labels) reach the registry as
#: label values; without a cap one misbehaving/malicious peer could mint
#: an unbounded number of series and explode every scrape.
OVERFLOW_LABEL = "other"

#: Default cap on distinct values per (metric name, label key) family.
DEFAULT_LABEL_CARDINALITY = 64

#: Default histogram edges: powers of two covering 1µs .. 64s — the
#: latency range of everything from an inline dispatch to a timed-out
#: DCN collective, in 27 buckets.
DEFAULT_TIME_EDGES: Tuple[float, ...] = tuple(
    2.0 ** e for e in range(-20, 7)
)

#: Edges for ratios in [0, 1] (batch fill fractions): eighths.
FRACTION_EDGES: Tuple[float, ...] = tuple(i / 8.0 for i in range(1, 9))

#: Quantiles stamped into every histogram export: JSON ``p50``/``p95``/
#: ``p99`` keys and Prometheus ``{quantile="..."}`` samples, so p50/p99
#: read straight off a scraped snapshot.
EXPORT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


def _quantile_from_cum(
    edges: Sequence[float], cum: Sequence[int], q: float
) -> Optional[float]:
    """Quantile estimate from cumulative bucket counts (``+Inf`` last).

    Log-bucket interpolation: within a bucket whose lower edge is
    positive, the mass is assumed log-uniform (matching the power-of-two
    default edges), so the estimate is ``lo * (hi/lo)**frac``; the first
    bucket (lower edge 0) interpolates linearly. Two exactness anchors
    keep the estimator honest and the tests pinnable:

    - a rank landing exactly on a cumulative bucket boundary returns that
      bucket's upper edge *exactly* (no interpolation drift);
    - ranks inside the implicit ``+Inf`` bucket clamp to the largest
      finite edge (there is no upper edge to interpolate toward), so the
      estimate is a stated lower bound rather than an invention.

    Returns ``None`` for an empty histogram. Monotone non-decreasing in
    ``q`` by construction.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = cum[-1]
    if total <= 0:
        return None
    target = q * total
    if target <= 0:
        # q == 0: the lower edge of the first non-empty bucket.
        i = next(j for j, c in enumerate(cum) if c > 0)
        return float(edges[i - 1]) if i > 0 else 0.0
    i = bisect_left(cum, target)
    if i >= len(edges):
        return float(edges[-1])  # +Inf bucket: clamp, lower bound
    if cum[i] == target:
        return float(edges[i])  # exact boundary hit: the edge itself
    prev = cum[i - 1] if i > 0 else 0
    frac = (target - prev) / (cum[i] - prev)
    lo = float(edges[i - 1]) if i > 0 else 0.0
    hi = float(edges[i])
    if lo > 0.0:
        return lo * (hi / lo) ** frac
    return lo + (hi - lo) * frac


def quantile_from_export(series: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile estimate from an exported histogram series dict (the
    ``{"type": "histogram", "edges": [...], "buckets": [...]}`` shape a
    :meth:`Registry.snapshot` or a ``__telemetry`` scrape carries) — so
    p50/p99 come straight from existing snapshots with no live object.
    """
    if series.get("type") != "histogram":
        raise ValueError(
            f"quantiles need a histogram series, got {series.get('type')!r}"
        )
    return _quantile_from_cum(series["edges"], series["buckets"], q)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def series_id(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Canonical Prometheus-style series id, also the snapshot key."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _export(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Value that can go up and down."""

    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def _export(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self._value}


class _GaugeFn:
    """Gauge whose value is computed at snapshot time from a callback —
    zero hot-path cost for values the owner already tracks (queue depths,
    in-flight counts, booleans)."""

    kind = "gauge"
    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], float]):
        self.fn = fn

    @property
    def value(self) -> float:
        try:
            return float(self.fn())
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception:
            # The owner may be mid-teardown (closed Rpc); a scrape must
            # degrade to NaN, not fail the whole snapshot.
            return float("nan")

    def _export(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with ``value <= edge`` bucket semantics.

    Buckets are stored non-cumulatively; exports are cumulative (and
    therefore monotone non-decreasing across buckets), matching the
    Prometheus text format. The final ``+Inf`` bucket is implicit.
    """

    kind = "histogram"
    __slots__ = ("_lock", "edges", "_counts", "_sum", "_count")

    def __init__(self, edges: Optional[Tuple[float, ...]] = None):
        edges = tuple(float(e) for e in (edges or DEFAULT_TIME_EDGES))
        if not edges or any(
            b <= a for a, b in zip(edges, edges[1:])
        ) or not all(math.isfinite(e) for e in edges):
            raise ValueError("edges must be finite and strictly increasing")
        self.edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)  # last slot: +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN: unordered, would poison sum
            return
        # bisect_left: v exactly on an edge lands in that edge's (<=)
        # bucket; v above every edge (incl. +inf) lands in +Inf.
        i = bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[int]:
        """Cumulative bucket counts, ending with the +Inf total."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for c in counts:
            running += c
            out.append(running)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Log-bucket quantile estimate (see :func:`_quantile_from_cum`);
        ``None`` while the histogram is empty."""
        return _quantile_from_cum(self.edges, self.cumulative(), q)

    def _export(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, running = [], 0
        for c in counts:
            running += c
            cum.append(running)
        out = {
            "type": "histogram",
            "edges": list(self.edges),
            "buckets": cum,  # cumulative, +Inf last — monotone by construction
            "sum": s,
            "count": total,
        }
        for q in EXPORT_QUANTILES:
            # None (not NaN) while empty: snapshots must stay strict JSON.
            out[f"p{q * 100:g}"] = _quantile_from_cum(self.edges, cum, q)
        return out


class RollingQuantile:
    """Windowed quantile estimate over the last ``window`` observations.

    The registry :class:`Histogram` is cumulative-forever — right for
    monotone exports, wrong for *control* decisions: an admission layer
    shedding on "observed p50 service time" must track the CURRENT
    regime, or one slow cold first batch (lazy kernel loading, cuDNN
    set-up) inflates the estimate for the life of the process. This is a
    plain ring buffer (not an exported metric type — pair it with a
    Histogram when the series should also be scrapeable): O(1) observe,
    O(window log window) quantile on a copied snapshot, thread-safe."""

    __slots__ = ("_lock", "_ring", "_idx", "_window")

    def __init__(self, window: int = 128):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        self._window = int(window)
        self._lock = threading.Lock()
        self._ring: List[float] = []
        self._idx = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN: unordered, would poison the sort
            return
        with self._lock:
            if len(self._ring) < self._window:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self._window

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile of the window; ``None`` while empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q!r}")
        with self._lock:
            vals = list(self._ring)
        if not vals:
            return None
        vals.sort()
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class Registry:
    """Named collection of metrics with get-or-create semantics.

    Series identity is ``(name, sorted(labels))``; asking for an existing
    series returns the existing object (so concurrent components share
    counters safely), asking with a conflicting metric type raises.

    Label cardinality is capped per (metric name, label key) family at
    ``label_cardinality`` distinct values (default
    :data:`DEFAULT_LABEL_CARDINALITY`, env
    ``MOOLIB_TPU_LABEL_CARDINALITY``): the value that would exceed the
    cap is folded into the :data:`OVERFLOW_LABEL` series and
    ``telemetry_label_overflow_total`` counts every folded lookup — a
    wire-controlled peer/endpoint/phase name can cost at most one extra
    series per family, never an unbounded scrape.
    """

    def __init__(self, label_cardinality: Optional[int] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._sorted_keys: List[Tuple[str, Tuple[Tuple[str, str], ...]]] = []
        if label_cardinality is None:
            label_cardinality = int(os.environ.get(
                "MOOLIB_TPU_LABEL_CARDINALITY", DEFAULT_LABEL_CARDINALITY
            ))
        self._label_cap = max(1, int(label_cardinality))
        # (metric name, label key) -> distinct values admitted so far.
        # Monotone: unregister() does NOT return capacity — a family that
        # churned through the cap once keeps folding, so a recreate loop
        # cannot defeat the guard.
        self._label_values: Dict[Tuple[str, str], Set[str]] = {}

    # -- creation -------------------------------------------------------------

    def _key(self, name: str, labels: Dict[str, Any], admit: bool = False):
        """Canonical ``(name, sorted-label-items)`` key with the
        cardinality guard applied: once a (name, label-key) family holds
        ``label_cardinality`` distinct values, any unseen value folds to
        :data:`OVERFLOW_LABEL` and ``telemetry_label_overflow_total``
        counts the fold. ``admit`` marks creation-path lookups — only
        those may claim one of the family's value slots (reads and
        unregisters observe, never consume, capacity)."""
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        items = tuple(sorted((k, str(v)) for k, v in labels.items()))
        folded: Optional[List[Tuple[str, str]]] = None
        overflowed = False
        for i, (k, v) in enumerate(items):
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
            if v == OVERFLOW_LABEL:
                continue
            fam = (name, k)
            seen = self._label_values.get(fam)
            if seen is not None and v in seen:
                continue
            with self._lock:
                seen = self._label_values.setdefault(fam, set())
                if v in seen:
                    continue
                if len(seen) < self._label_cap:
                    if admit:
                        seen.add(v)
                    continue
            if folded is None:
                folded = list(items)
            folded[i] = (k, OVERFLOW_LABEL)
            overflowed = True
        if folded is not None:
            items = tuple(folded)
        if overflowed and name != "telemetry_label_overflow_total":
            self._get_or_create(
                "telemetry_label_overflow_total", {}, Counter, Counter
            ).inc()
        return name, items

    def _get_or_create(self, name, labels, factory, cls):
        key = self._key(name, labels, admit=True)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = factory()
                    self._metrics[key] = m
                    insort(self._sorted_keys, key)
                    return m
        # Type check on every non-creating return — including the metric a
        # racing thread created between the unlocked probe and the lock.
        if not isinstance(m, cls) and not (
            cls is Gauge and isinstance(m, _GaugeFn)
        ):
            raise ValueError(
                f"metric {series_id(*key)} already registered as "
                f"{type(m).__name__}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(name, labels, Counter, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(name, labels, Gauge, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        """Get-or-create; ``edges`` only applies at creation time (the
        whole point of fixed buckets is that they never move)."""
        return self._get_or_create(
            name, labels, lambda: Histogram(edges), Histogram
        )

    def gauge_fn(self, name: str, fn: Callable[[], float], **labels) -> None:
        """Register (or replace) a snapshot-time gauge callback. Replace
        semantics matter: a component recreated under the same identity
        (a Group re-registered on the same Rpc) must not leave a stale
        closure reading its dead predecessor."""
        key = self._key(name, labels, admit=True)
        with self._lock:
            existing = self._metrics.get(key)
            if isinstance(existing, _GaugeFn):
                existing.fn = fn
                return
            if existing is not None:
                raise ValueError(
                    f"metric {series_id(*key)} already registered as "
                    f"{type(existing).__name__}"
                )
            self._metrics[key] = _GaugeFn(fn)
            insort(self._sorted_keys, key)

    def unregister(self, name: str, **labels) -> bool:
        """Remove a series (any kind). Component ``close()`` paths use
        this so a torn-down Group/Accumulator/EnvPoolServer stops
        exporting stale series — and, for ``gauge_fn`` closures, stops
        being pinned by the registry for the Rpc's lifetime. Returns
        whether the series existed."""
        key = self._key(name, labels)
        with self._lock:
            if self._metrics.pop(key, None) is None:
                return False
            i = bisect_left(self._sorted_keys, key)
            if i < len(self._sorted_keys) and self._sorted_keys[i] == key:
                del self._sorted_keys[i]
            return True

    # -- reads ----------------------------------------------------------------

    def value(self, name: str, **labels) -> Optional[float]:
        """Current scalar value of a counter/gauge series (None when the
        series does not exist; histograms have no scalar value)."""
        m = self._metrics.get(self._key(name, labels))
        if m is None or isinstance(m, Histogram):
            return None
        return m.value

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic point-in-time export: ``{series_id: series}``,
        ordered by series id. Values are plain JSON/wire-serializable
        types, so a snapshot travels the RPC plane as-is."""
        with self._lock:
            keys = list(self._sorted_keys)
            metrics = {k: self._metrics[k] for k in keys}
        out: Dict[str, Dict[str, Any]] = {}
        for key in keys:
            out[series_id(*key)] = metrics[key]._export()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the registry."""
        snap_items = []
        with self._lock:
            keys = list(self._sorted_keys)
            metrics = {k: self._metrics[k] for k in keys}
        for key in keys:
            snap_items.append((key, metrics[key]))
        lines: List[str] = []
        typed: set = set()
        for (name, labels), m in snap_items:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                exp = m._export()
                for edge, c in zip(exp["edges"], exp["buckets"]):
                    le = labels + (("le", _format_value(edge)),)
                    lines.append(f"{series_id(name + '_bucket', le)} {c}")
                le = labels + (("le", "+Inf"),)
                lines.append(
                    f"{series_id(name + '_bucket', le)} {exp['buckets'][-1]}"
                )
                lines.append(
                    f"{series_id(name + '_sum', labels)} "
                    f"{_format_value(exp['sum'])}"
                )
                lines.append(
                    f"{series_id(name + '_count', labels)} {exp['count']}"
                )
                for q in EXPORT_QUANTILES:
                    # Summary-style quantile samples next to the buckets
                    # (empty histogram -> NaN, the Prometheus idiom).
                    qv = exp[f"p{q * 100:g}"]
                    ql = labels + (("quantile", f"{q:g}"),)
                    lines.append(
                        f"{series_id(name, ql)} "
                        f"{_format_value(float('nan') if qv is None else qv)}"
                    )
            else:
                lines.append(
                    f"{series_id(name, labels)} {_format_value(m.value)}"
                )
        return "\n".join(lines) + "\n"


def _format_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


_PROM_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'          # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'  # labels
    r' (-?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|\+?Inf|NaN))$'  # value
)


def parse_prometheus(text: str) -> Dict[str, float]:
    """Strict parser for the exposition format :meth:`Registry.prometheus`
    emits — the scrape-round-trip validator used by the tests and the CI
    smoke stage. Raises ``ValueError`` on any malformed sample line."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(
                f"unparseable prometheus line {lineno}: {line!r}"
            )
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out
