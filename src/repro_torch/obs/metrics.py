"""Typed metric instruments behind a single internally-locked registry.

The port of ``repro.obs.metrics``.

Three instrument kinds, all keyed ``(name, labels)`` where ``labels`` is
a sorted tuple of ``(key, value)`` string pairs:

- **counters** — monotonic ints (``inc``);
- **gauges** — last-write-wins floats (``set_gauge``), plus snapshot-time
  *collectors* so derived state (hop-stat EMAs, live view counts) can be
  exported without any hot-path cost;
- **histograms** — geometric log-bucketed (``observe``) with exact
  count/sum/min/max and p50/p90/p99 extraction.

The registry lock is minted through ``repro_torch.core._locks`` (name
``metrics._lock``, rank 80 in the reference's ``tools/lockorder.py``); the
import happens lazily inside ``__init__`` to keep this module import-cycle
free.  Rank 80 sits
above every ``core`` lock because instrument updates happen while stats
or WAL locks are held, never the other way round.

``IoStatsView`` and ``StatsView`` are read-only ``Mapping`` facades that
keep the historical ``log.io_stats["key"]`` / ``wal.stats["records"]``
read idiom working on top of registry counters.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable, Iterable, Iterator

__all__ = ["Histogram", "IoStatsView", "MetricsRegistry", "StatsView"]

# Geometric buckets: upper bound of bucket i is BASE * FACTOR**i.  With
# BASE=1e-9 and FACTOR=2 the 64 buckets span ~1ns .. ~1.8e10, covering
# both latencies in seconds and batch sizes in rows.
BUCKET_BASE = 1e-9
BUCKET_FACTOR = 2.0
N_BUCKETS = 64

_LOG_FACTOR = math.log(BUCKET_FACTOR)


def bucket_index(value: float) -> int:
    """Index of the geometric bucket whose upper bound covers ``value``."""
    if value <= BUCKET_BASE:
        return 0
    idx = int(math.ceil(math.log(value / BUCKET_BASE) / _LOG_FACTOR - 1e-9))
    if idx < 0:
        return 0
    if idx >= N_BUCKETS:
        return N_BUCKETS - 1
    return idx


def bucket_upper(idx: int) -> float:
    return BUCKET_BASE * BUCKET_FACTOR**idx


def _label_key(labels: dict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Histogram:
    """Sparse log-bucketed histogram with exact count/sum/min/max."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bucket_index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """Approximate quantile ``q`` in [0, 1] from the bucket walk.

        Returns the upper bound of the bucket where the cumulative count
        crosses ``q * count``, clamped to the exact observed [min, max].
        """
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                est = bucket_upper(idx)
                return max(self.vmin, min(est, self.vmax))
        return self.vmax

    def merge(self, other: "Histogram") -> None:
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "buckets": sorted(self.buckets.items()),
            "bucket_base": BUCKET_BASE,
            "bucket_factor": BUCKET_FACTOR,
        }

    @classmethod
    def from_dict(cls, payload: Mapping) -> "Histogram":
        h = cls()
        for idx, n in payload.get("buckets", ()):
            h.buckets[int(idx)] = int(n)
        h.count = int(payload.get("count", 0))
        h.total = float(payload.get("sum", 0.0))
        if h.count:
            h.vmin = float(payload.get("min", 0.0))
            h.vmax = float(payload.get("max", 0.0))
        return h


class MetricsRegistry:
    """All instruments for one store (or one shard) under a single lock.

    ``Collector`` callables run at snapshot time *outside* the registry
    lock (they may take lower-ranked core locks) and yield
    ``(name, labels_dict, value)`` gauge triples.
    """

    def __init__(self, name: str = "dslog") -> None:
        self.name = name
        from repro_torch.core import _locks  # lazy: core imports this module

        self._lock = _locks.new_lock("metrics._lock")
        self._counters: dict[tuple, int] = {}
        self._gauges: dict[tuple, float] = {}
        self._histograms: dict[tuple, Histogram] = {}
        self._collectors: list[Callable[[], Iterable[tuple]]] = []

    # -- counters ---------------------------------------------------------

    def seed_counters(self, names: Iterable[str]) -> None:
        """Pre-register unlabeled counters at zero so reads/`in` work."""
        with self._lock:
            for name in names:
                self._counters.setdefault((name, ()), 0)

    def inc(self, name: str, n: int = 1, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def counter_value(self, name: str, **labels) -> int:
        key = (name, _label_key(labels))
        with self._lock:
            return self._counters.get(key, 0)

    def counters_flat(self) -> dict[str, int]:
        """Unlabeled counters as a plain dict (the ``io_stats`` surface).

        Labeled series fold into their base name so aggregate counts
        (e.g. per-path ``queries``) stay visible through the dict view.
        """
        with self._lock:
            out: dict[str, int] = {}
            for (name, labels), val in self._counters.items():
                if not labels:
                    out[name] = out.get(name, 0) + val
                elif name not in out:
                    out[name] = val
                else:
                    out[name] += val
            return out

    # -- gauges -----------------------------------------------------------

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def register_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- histograms -------------------------------------------------------

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram()
            hist.observe(value)

    def histogram(self, name: str, **labels) -> Histogram | None:
        key = (name, _label_key(labels))
        with self._lock:
            return self._histograms.get(key)

    def percentiles(self, name: str, **labels) -> dict[str, float]:
        hist = self.histogram(name, **labels)
        if hist is None:
            return {"count": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": hist.count,
            "p50": hist.percentile(0.50),
            "p90": hist.percentile(0.90),
            "p99": hist.percentile(0.99),
        }

    # -- snapshot / merge -------------------------------------------------

    def snapshot(self) -> dict:
        """Structured dump of every instrument, collectors included."""
        with self._lock:
            counters = [
                {"name": name, "labels": dict(labels), "value": val}
                for (name, labels), val in sorted(self._counters.items())
            ]
            gauges = {key: val for key, val in self._gauges.items()}
            histograms = [
                {"name": name, "labels": dict(labels), **hist.to_dict()}
                for (name, labels), hist in sorted(self._histograms.items())
            ]
            collectors = list(self._collectors)
        # Collectors run outside the registry lock: they may take core
        # locks that rank below metrics._lock.
        for fn in collectors:
            try:
                triples = list(fn())
            except Exception:
                continue
            for name, labels, value in triples:
                gauges[(name, _label_key(labels))] = float(value)
        return {
            "registry": self.name,
            "counters": counters,
            "gauges": [
                {"name": name, "labels": dict(labels), "value": val}
                for (name, labels), val in sorted(gauges.items())
            ],
            "histograms": histograms,
        }

    @staticmethod
    def merge_snapshots(snapshots: Iterable[dict], name: str = "merged") -> dict:
        """Sum counters/histograms and sum gauges across registries.

        Series merge by ``(name, labels)`` union — instruments minted by
        only one child still appear in the merged view.
        """
        counters: dict[tuple, int] = {}
        gauges: dict[tuple, float] = {}
        histograms: dict[tuple, Histogram] = {}
        for snap in snapshots:
            for row in snap.get("counters", ()):
                key = (row["name"], _label_key(row.get("labels", {})))
                counters[key] = counters.get(key, 0) + int(row["value"])
            for row in snap.get("gauges", ()):
                key = (row["name"], _label_key(row.get("labels", {})))
                gauges[key] = gauges.get(key, 0.0) + float(row["value"])
            for row in snap.get("histograms", ()):
                key = (row["name"], _label_key(row.get("labels", {})))
                hist = histograms.get(key)
                if hist is None:
                    histograms[key] = Histogram.from_dict(row)
                else:
                    hist.merge(Histogram.from_dict(row))
        return {
            "registry": name,
            "counters": [
                {"name": n, "labels": dict(l), "value": v}
                for (n, l), v in sorted(counters.items())
            ],
            "gauges": [
                {"name": n, "labels": dict(l), "value": v}
                for (n, l), v in sorted(gauges.items())
            ],
            "histograms": [
                {"name": n, "labels": dict(l), **h.to_dict()}
                for (n, l), h in sorted(histograms.items())
            ],
        }


class IoStatsView(Mapping):
    """Live read-only ``io_stats`` facade over a registry's counters.

    ``dict(view)``, ``view[key]``, ``view.get``, and ``key in view`` all
    behave like the historical guarded dict; mutation goes through
    ``MetricsRegistry.inc`` (enforced by dslint's ``metric-registry``
    rule in ``core/``).
    """

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry) -> None:
        self._registry = registry

    def __getitem__(self, key: str) -> int:
        flat = self._registry.counters_flat()
        return flat[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry.counters_flat())

    def __len__(self) -> int:
        return len(self._registry.counters_flat())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"IoStatsView({self._registry.counters_flat()!r})"


class StatsView(Mapping):
    """Read-only alias view: short legacy key -> registry counter name."""

    __slots__ = ("_registry", "_aliases")

    def __init__(self, registry: MetricsRegistry, aliases: Mapping) -> None:
        self._registry = registry
        self._aliases = dict(aliases)

    def __getitem__(self, key: str) -> int:
        return self._registry.counter_value(self._aliases[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._aliases)

    def __len__(self) -> int:
        return len(self._aliases)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"StatsView({dict(self)!r})"
