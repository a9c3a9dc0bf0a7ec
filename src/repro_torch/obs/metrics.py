"""Process-local metrics: counters, gauges, log-scale histogram sketches.

Port of ``repro.obs.metrics`` (numpy only; the port keeps its own copy).
One `MetricsRegistry` per process or per simulated endpoint, holding three
sink kinds:

  * `Counter`  — monotonically increasing float/int total;
  * `Gauge`    — last-set value (plus the observed max);
  * `Histogram`— fixed-bucket log-scale sketch with mergeable counts and
    percentile queries (p50/p90/p99/p999).

Every latency the simulator reports is read from these sketches.
Bucketing: geometric buckets at ``GROWTH = 2**(1/32)`` per step (~2.2%
relative width) spanning [LO, LO * GROWTH**N).  `percentile()` linearly
interpolates between the bucket midpoints holding the adjacent order
statistics (np.percentile's default method), so

    |sketch_pXX - exact_pXX| <= exact_pXX * (GROWTH - 1)

and ``merge()`` of two sketches is exactly the sketch of the concatenated
samples (bucket counts add).  These sinks are host-side state: hot paths
record at flush boundaries (a transport ``post()``, a simulator round).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# log-scale bucket geometry: 32 buckets per octave over ~40 octaves
# (1e-3 .. ~1e9, microseconds in practice) — one int per touched bucket
GROWTH = 2.0 ** (1.0 / 32.0)
LO = 1e-3
N_BUCKETS = 1344            # 42 octaves: LO * 2**42 ~ 4.4e9
_LOG_GROWTH = math.log(GROWTH)
_PCTS = (50.0, 90.0, 99.0, 99.9)


class Counter:
    """Monotonic total.  ``inc`` accepts floats (e.g. microseconds)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value + running max (the SLO "worst observed" lane)."""

    __slots__ = ("value", "max")

    def __init__(self):
        self.value = 0.0
        self.max = float("-inf")

    def set(self, v: float) -> None:
        self.value = float(v)
        if v > self.max:
            self.max = float(v)


class Histogram:
    """Fixed-bucket log-scale sketch; see the module docstring for the
    exactness bound.  Values <= 0 land in the underflow bucket (reported
    as 0.0 by percentile queries); values past the top land in overflow.
    """

    __slots__ = ("buckets", "underflow", "overflow", "count", "total",
                 "vmin", "vmax")

    def __init__(self):
        self.buckets: Dict[int, int] = {}   # sparse: bucket index -> count
        self.underflow = 0
        self.overflow = 0
        self.count = 0
        self.total = 0.0                    # exact sum (for the mean)
        self.vmin = float("inf")
        self.vmax = float("-inf")

    @staticmethod
    def bucket_of(v: float) -> int:
        return int(math.floor(math.log(v / LO) / _LOG_GROWTH))

    @staticmethod
    def bucket_mid(i: int) -> float:
        # geometric midpoint of [LO*G^i, LO*G^(i+1))
        return LO * GROWTH ** (i + 0.5)

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v < LO:
            self.underflow += 1
            return
        i = self.bucket_of(v)
        if i >= N_BUCKETS:
            self.overflow += 1
            return
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def record_many(self, values: Iterable[float]) -> None:
        a = np.asarray(list(values) if not isinstance(values, np.ndarray)
                       else values, np.float64).ravel()
        if a.size == 0:
            return
        self.count += int(a.size)
        self.total += float(a.sum())
        self.vmin = min(self.vmin, float(a.min()))
        self.vmax = max(self.vmax, float(a.max()))
        lo = a < LO
        self.underflow += int(lo.sum())
        a = a[~lo]
        if a.size == 0:
            return
        idx = np.floor(np.log(a / LO) / _LOG_GROWTH).astype(np.int64)
        hi = idx >= N_BUCKETS
        self.overflow += int(hi.sum())
        for i, c in zip(*np.unique(idx[~hi], return_counts=True)):
            self.buckets[int(i)] = self.buckets.get(int(i), 0) + int(c)

    def _order_stat(self, k: int) -> float:
        """0-indexed order statistic as a bucket midpoint: underflow
        first (reported 0.0), then the sparse buckets in index order,
        overflow last (reported as the exact max — best honest answer)."""
        if k < self.underflow:
            return 0.0
        seen = self.underflow
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if k < seen:
                return self.bucket_mid(i)
        return self.vmax

    def percentile(self, q: float) -> float:
        """Value at percentile ``q`` in [0, 100]; 0.0 on an empty sketch.

        Linear interpolation between adjacent order statistics at
        fractional ranks — `np.percentile`'s default method over the
        bucket midpoints, so a sketch percentile tracks the sorted-list
        one even when the rank lands exactly between two modes (e.g. a
        50/50 read/write mix whose p50 IS the boundary midpoint).  The
        error bound survives interpolation: a convex combination of two
        values each within relative error e of their true order stats is
        within e of the true interpolated value."""
        if self.count == 0:
            return 0.0
        pos = q / 100.0 * (self.count - 1)
        k = int(math.floor(pos))
        k = min(max(k, 0), self.count - 1)
        lo = self._order_stat(k)
        frac = pos - k
        if frac <= 0.0 or k + 1 > self.count - 1:
            return lo
        hi = self._order_stat(k + 1)
        return lo + frac * (hi - lo)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.underflow += other.underflow
        self.overflow += other.overflow
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def to_dict(self) -> dict:
        return {
            "count": self.count, "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "underflow": self.underflow, "overflow": self.overflow,
            "buckets": {str(i): c for i, c in sorted(self.buckets.items())},
            "percentiles": {f"p{f'{p:g}'.replace('.', '')}":
                            self.percentile(p) for p in _PCTS},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.count = int(d["count"])
        h.total = float(d["sum"])
        h.underflow = int(d.get("underflow", 0))
        h.overflow = int(d.get("overflow", 0))
        h.buckets = {int(i): int(c) for i, c in d.get("buckets", {}).items()}
        if h.count:
            h.vmin = float(d.get("min", 0.0))
            h.vmax = float(d.get("max", 0.0))
        return h


@dataclasses.dataclass(frozen=True)
class _Key:
    name: str
    labels: Tuple[Tuple[str, str], ...]

    def __str__(self) -> str:
        if not self.labels:
            return self.name
        inner = ",".join(f"{k}={v}" for k, v in self.labels)
        return f"{self.name}{{{inner}}}"


def _key(name: str, labels: dict) -> _Key:
    return _Key(name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """Label-keyed sink table.  ``counter/gauge/histogram`` get-or-create
    the sink for (name, labels); `merge` folds another registry in
    (counters add, histograms merge, gauges keep the max — the merged
    view answers "worst anywhere", the per-node registries keep the
    per-node answer)."""

    def __init__(self):
        self.counters: Dict[_Key, Counter] = {}
        self.gauges: Dict[_Key, Gauge] = {}
        self.histograms: Dict[_Key, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self.counters.get(k)
        if c is None:
            c = self.counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self.gauges.get(k)
        if g is None:
            g = self.gauges[k] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        k = _key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = Histogram()
        return h

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Read a counter without creating it (stats()-view helper)."""
        c = self.counters.get(_key(name, labels))
        return c.value if c is not None else default

    def find_histograms(self, name: str) -> Dict[str, Histogram]:
        """{label-string: hist} for every histogram with this name."""
        return {str(k): h for k, h in self.histograms.items()
                if k.name == name}

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for k, c in other.counters.items():
            self.counters.setdefault(k, Counter()).inc(c.value)
        for k, g in other.gauges.items():
            mine = self.gauges.setdefault(k, Gauge())
            mine.set(max(g.value, mine.max if mine.max != float("-inf")
                         else g.value, g.max))
        for k, h in other.histograms.items():
            self.histograms.setdefault(k, Histogram()).merge(h)
        return self

    def to_dict(self) -> dict:
        """The flat metrics-JSON view of every sink."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for k, c in self.counters.items():
            out["counters"][str(k)] = c.value
        for k, g in self.gauges.items():
            out["gauges"][str(k)] = {"value": g.value, "max": g.max}
        for k, h in self.histograms.items():
            out["histograms"][str(k)] = h.to_dict()
        return out

    def is_empty(self) -> bool:
        return not (self.counters or self.gauges or self.histograms)


def percentiles_from(hist: Optional[Histogram],
                     pcts=(50.0, 99.0)) -> Dict[str, float]:
    """{"p50_us": ..., "p99_us": ...} — the one shape every bench section
    reports latency in, always computed from a sketch."""
    return {f"p{f'{p:g}'.replace('.', '')}_us":
            (hist.percentile(p) if hist is not None else 0.0) for p in pcts}
