"""Telemetry for the port: the metrics registry and per-query tracing.

``repro_torch.obs`` mirrors ``repro.obs``:

- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms behind
  one internally-locked :class:`MetricsRegistry`; ``DSLog.io_stats`` is a
  live read-only view over it.
- :mod:`repro_torch.obs.trace` — off-by-default per-query span trees.
- :mod:`repro_torch.obs.export` — ``telemetry.json`` snapshot schema,
  Prometheus text exposition, and the ``health()`` report.
"""

from repro_torch.obs.metrics import (
    Histogram,
    IoStatsView,
    MetricsRegistry,
    StatsView,
)
from repro_torch.obs.trace import QueryTrace, Span, maybe_span
from repro_torch.obs.export import (
    TELEMETRY_SCHEMA,
    health,
    parse_prometheus,
    render_prometheus,
    telemetry_snapshot,
    validate_telemetry,
)

__all__ = [
    "Histogram",
    "IoStatsView",
    "MetricsRegistry",
    "StatsView",
    "QueryTrace",
    "Span",
    "maybe_span",
    "TELEMETRY_SCHEMA",
    "health",
    "parse_prometheus",
    "render_prometheus",
    "telemetry_snapshot",
    "validate_telemetry",
]
