"""Telemetry for the port: the metrics registry and per-query tracing.

``repro_torch.obs`` mirrors ``repro.obs`` without ``export`` (the
``telemetry.json`` sidecar and Prometheus exposition ride persistence,
which the port has not reached yet):

- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms behind
  one internally-locked :class:`MetricsRegistry`; ``DSLog.io_stats`` is a
  live read-only view over it.
- :mod:`repro_torch.obs.trace` — off-by-default per-query span trees.
"""

from repro_torch.obs.metrics import (
    Histogram,
    IoStatsView,
    MetricsRegistry,
    StatsView,
)
from repro_torch.obs.trace import QueryTrace, Span, maybe_span

__all__ = [
    "Histogram",
    "IoStatsView",
    "MetricsRegistry",
    "StatsView",
    "QueryTrace",
    "Span",
    "maybe_span",
]
