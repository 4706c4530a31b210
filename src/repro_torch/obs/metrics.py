"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The measurement plane the rest of the port reports into; a copy of the JAX
package's ``obs/metrics.py``. Three deliberate constraints shape it:

* **Dependency-free and allocation-light.** A counter increment is one
  attribute add on a long-lived object — cheap enough to sit on the
  serving fold path and the engine dispatch path. No
  prometheus client, no background threads, no locks (the runners are
  single-threaded host loops; a real transport front-end would own its
  own registry per worker).

* **Series identity is (name, labels).** ``registry.counter("x", k="v")``
  get-or-creates, so call sites never hold module globals; repeated
  lookups return the same instrument. ``snapshot()`` flattens every
  series to ``name{k=v,...} -> float`` — the stable export surface the
  JSONL sink writes and ``benchmarks/check_regression.py``-style diffing
  consumes.

* **Merging is a pure function over snapshots.** ``merge_snapshots``
  sums counter/histogram series and last-wins gauges, and
  ``export_snapshot`` gates emission on process 0. The port runs in one
  process until its distributed substrate (Slice E, ROADMAP.md), so the
  gate is open.

Histograms are fixed-bucket (prometheus-style cumulative ``le`` edges):
``observe`` is a bisect + two adds, and ``quantile`` reconstructs
percentiles by linear interpolation inside the winning bucket — accuracy
is bounded by bucket width, pinned against numpy percentiles in
tests/test_obs.py.
"""
from __future__ import annotations

import bisect
import math
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

# Default edges suit the latencies the port measures: sub-ms kernel
# dispatches up to minute-scale round cadences (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _series_key(name: str, labels: Mapping[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic float counter; ``inc`` only goes up."""

    __slots__ = ("key", "value")

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """Last-written value (queue depth, current K, arrival-rate estimate)."""

    __slots__ = ("key", "value")

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with cumulative-``le`` export.

    ``counts[i]`` is the number of observations ``<= buckets[i]``
    exclusive of earlier buckets; the final slot is the +inf overflow.
    """

    __slots__ = ("key", "buckets", "counts", "sum", "count")

    def __init__(self, key: str, buckets: Iterable[float] = DEFAULT_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev
                            for prev, nxt in zip(edges, edges[1:])):
            raise ValueError(f"histogram {key}: bucket edges must be "
                             f"strictly increasing and non-empty: {edges}")
        self.key = key
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, x)] += 1
        self.sum += x
        self.count += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile by linear interpolation in the bucket
        holding the target rank (NaN when empty; the top finite edge when
        the rank lands in the +inf overflow bucket)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank and c:
                if i == len(self.buckets):  # +inf overflow: no upper edge
                    return self.buckets[-1]
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i]
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create instrument store with a flat-dict export.

    One registry per measurement domain: the module-level
    ``default_registry()`` serves the engine/benchmark paths, while a
    ``ServingController`` owns a private registry by default so two
    controllers in one process never alias counters.
    """

    def __init__(self):
        self._series: Dict[str, Any] = {}

    def _get(self, cls, name: str, labels: Mapping[str, Any],
             *args) -> Any:
        key = _series_key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = cls(key, *args)
        elif not isinstance(inst, cls):
            raise TypeError(f"series {key} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``series-key -> value`` export (histograms expand to
        cumulative ``_bucket{le=..}`` series plus ``_sum`` / ``_count``),
        sorted for stable diffing."""
        out: Dict[str, float] = {}
        for key, inst in self._series.items():
            if isinstance(inst, Histogram):
                base, labels = _split_key(key)
                cum = 0
                for edge, c in zip(inst.buckets + (math.inf,), inst.counts):
                    cum += c
                    le = "+Inf" if math.isinf(edge) else repr(edge)
                    out[_series_key(f"{base}_bucket",
                                    {**labels, "le": le})] = float(cum)
                out[_series_key(f"{base}_sum", labels)] = float(inst.sum)
                out[_series_key(f"{base}_count", labels)] = float(inst.count)
            else:
                out[key] = float(inst.value)
        return dict(sorted(out.items()))

    def gauge_keys(self) -> frozenset:
        """Series keys that must NOT be summed across processes (pass to
        ``merge_snapshots``): gauges are point-in-time reads."""
        return frozenset(k for k, inst in self._series.items()
                         if isinstance(inst, Gauge))

    def reset(self) -> None:
        self._series.clear()


def _split_key(key: str) -> Tuple[str, Dict[str, str]]:
    if "{" not in key:
        return key, {}
    base, inner = key[:-1].split("{", 1)
    labels = dict(kv.split("=", 1) for kv in inner.split(",") if kv)
    return base, labels


def merge_snapshots(snaps: Iterable[Dict[str, float]],
                    gauge_keys: Iterable[str] = ()) -> Dict[str, float]:
    """Combine per-process snapshots into one: counter and histogram
    series sum; series named in ``gauge_keys`` (point-in-time reads —
    ``MetricsRegistry.gauge_keys()``) keep the last value seen. The
    multi-process merge path runs this over per-process JSONL snapshots
    on process 0."""
    gauges = frozenset(gauge_keys)
    out: Dict[str, float] = {}
    for snap in snaps:
        for key, v in snap.items():
            out[key] = v if key in gauges else out.get(key, 0.0) + v
    return dict(sorted(out.items()))


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-global registry (engine, benchmarks, launchers)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def export_snapshot(registry: Optional[MetricsRegistry] = None,
                    gate=None) -> Optional[Dict[str, float]]:
    """Process-0-gated snapshot: the dict on process 0, None elsewhere.

    ``gate`` defaults to ``obs.sink.is_process_zero`` (the port is one
    process until Slice E, so it is always open); the injectable gate
    keeps the multi-process behaviour unit-testable.
    """
    if gate is None:
        from repro_torch.obs.sink import is_process_zero as gate
    if not gate():
        return None
    return (registry or default_registry()).snapshot()
