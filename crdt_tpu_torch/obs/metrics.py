"""Typed metric registry: counters, gauges and log2-bucketed histograms
(the port of the JAX package's ``obs/metrics.py``, with the naming
helpers of its ``obs/namespace.py``).

The port keeps its counts as plain integers behind functions and report
fields; a registry is filled only at read time, by the publisher
(:mod:`~crdt_tpu_torch.obs.publish`), which copies those counts in under
the JAX package's metric names.  A registry's *sources* are the
callables that do that copy: :meth:`MetricsRegistry.refresh` runs them,
and every read boundary (a scrape, a fleet capture, ``/healthz``) calls
it first.  :meth:`MetricsRegistry.put` sets an absolute value, which is
how a source writes.

Dependency-free: no torch, no numpy.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

#: the Prometheus metric-name prefix every exported name carries (the JAX
#: package's, so its dashboards and alerts read the port unchanged)
PROM_PREFIX = "crdt_tpu"

_SAN = {ord(c): "_" for c in ".-/ "}


def sanitize(name: str) -> str:
    """Dotted internal metric name -> Prometheus-legal name body."""
    out = name.translate(_SAN)
    return "".join(c if c.isalnum() or c == "_" else "_" for c in out)


def prometheus_name(name: str, kind: str) -> str:
    """``crdt_tpu_<sanitized>``, with ``_total`` for counters."""
    base = f"{PROM_PREFIX}_{sanitize(name)}"
    return f"{base}_total" if kind == "counter" else base


class Counter:
    """A monotonically increasing event count (``inc`` locks itself)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """A point-in-time level; last write wins."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)


def log2_bucket(v: float) -> int:
    """The log2 bucket exponent of one observation: bucket ``e`` holds
    ``(2**(e-1), 2**e]``; non-positive values land in
    :attr:`Histogram.ZERO_BUCKET`."""
    if v > 0.0:
        m, e = math.frexp(v)
        return e - 1 if m == 0.5 else e
    return Histogram.ZERO_BUCKET


class Histogram:
    """Log2-bucketed distribution with count, sum, min and max.  Also the
    local accumulator of a module that keeps a distribution as plain
    state (the serve loop's latencies, the stability tracker's ages)."""

    ZERO_BUCKET = -1075  # below the smallest subnormal double's exponent

    __slots__ = ("name", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        e = log2_bucket(v)
        self.buckets[e] = self.buckets.get(e, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s observations in."""
        for e, c in other.buckets.items():
            self.buckets[e] = self.buckets.get(e, 0) + c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def copy(self) -> "Histogram":
        h = Histogram(self.name)
        h.merge(self)
        return h

    def cumulative(self) -> Iterator[Tuple[float, int]]:
        """``(upper_bound, cumulative_count)`` in ascending bound order."""
        running = 0
        for e in sorted(self.buckets):
            running += self.buckets[e]
            bound = 0.0 if e == self.ZERO_BUCKET else math.ldexp(1.0, e)
            yield bound, running


class MetricsRegistry:
    """Named metrics behind one lock; a name is one type for good
    (re-registering it as another raises ``ValueError``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()    # one refresh at a time
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sources: List[Callable[["MetricsRegistry"], None]] = []

    def _claim(self, name: str, kind: str) -> None:
        for other_kind, table in (("counter", self._counters), ("gauge", self._gauges),
                                  ("histogram", self._histograms)):
            if other_kind != kind and name in table:
                raise ValueError(f"metric {name!r} is already a {other_kind}, "
                                 f"cannot re-register as a {kind}")

    def _get(self, kind: str, name: str):
        # the caller holds the lock
        table, cls = {"counter": (self._counters, Counter), "gauge": (self._gauges, Gauge),
                      "histogram": (self._histograms, Histogram)}[kind]
        m = table.get(name)
        if m is None:
            self._claim(name, kind)
            m = table[name] = cls(name)
        return m

    # -- typed handles ------------------------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._get("histogram", name)

    # -- one-shot observations ----------------------------------------------------

    def counter_inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._get("counter", name).inc(n)

    def gauge_set(self, name: str, v: float) -> None:
        with self._lock:
            self._get("gauge", name).set(v)

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            self._get("histogram", name).observe(v)

    def observe_aggregate(self, name: str, buckets: Dict[int, int], count: int, total: float,
                          vmin: float, vmax: float) -> None:
        """Merge a locally aggregated log2 distribution into ``name`` in one
        lock acquisition."""
        if count <= 0:
            return
        with self._lock:
            h = self._get("histogram", name)
            for e, c in buckets.items():
                h.buckets[e] = h.buckets.get(e, 0) + c
            h.count += count
            h.sum += total
            h.min = min(h.min, vmin)
            h.max = max(h.max, vmax)

    def put(self, kind: str, name: str, value) -> None:
        """Set ``name`` to an absolute value: a count for a counter, a level
        for a gauge, a :class:`Histogram` whose state a histogram takes."""
        with self._lock:
            m = self._get(kind, name)
            if kind == "histogram":
                m.count, m.sum, m.min, m.max = value.count, value.sum, value.min, value.max
                m.buckets = dict(value.buckets)
            elif kind == "counter":
                m.value = int(value)
            else:
                m.value = float(value)

    # -- read-time sources --------------------------------------------------------

    def add_source(self, source: Callable[["MetricsRegistry"], None]) -> None:
        """Run ``source(registry)`` at every :meth:`refresh`."""
        with self._lock:
            self._sources.append(source)

    def refresh(self) -> None:
        """Run every source: the registry then holds the counts as they are
        now.  Refreshes run one at a time, so a refresh that read its
        counts earlier never writes them over a later one's (a scraped
        counter never goes back).  The sources run outside the metrics
        lock, so readers do not wait for them."""
        with self._refresh_lock:
            with self._lock:
                sources = list(self._sources)
            for source in sources:
                source(self)

    # -- snapshots ----------------------------------------------------------------

    def snapshot(self) -> dict:
        """``{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: {count, sum, min, max, buckets}}}``, untorn."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {
                    k: {"count": h.count, "sum": h.sum,
                        "min": (None if h.count == 0 else h.min),
                        "max": (None if h.count == 0 else h.max),
                        "buckets": dict(h.buckets)}
                    for k, h in self._histograms.items()},
            }

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: c.value for k, c in self._counters.items()}

    def reset(self) -> None:
        """Forget every metric (the sources stay)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-global registry: the kernel observatory and the flight
    recorder publish into it (:func:`~crdt_tpu_torch.obs.publish.
    process_source`)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            from . import publish

            _DEFAULT = MetricsRegistry()
            _DEFAULT.add_source(publish.process_source)
    return _DEFAULT
