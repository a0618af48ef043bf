"""Telemetry for the port: the metrics registry and per-query tracing.

``repro_torch.obs`` mirrors ``repro.obs``:

- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms behind
  one internally-locked :class:`MetricsRegistry`; ``DSLog.io_stats`` is a
  live read-only view over it.
- :mod:`repro_torch.obs.trace` — off-by-default per-query span trees:
  ``prov_query(trace=True)`` makes its trace the process's active one,
  and the planner, the executor and ``kernels/ops.py`` open their spans
  (``planner.*``, ``query.*``, ``kernel_launch``, ``ops.*``) through
  ``trace.span``.  With no active trace a span site is one load and one
  ``None`` test.  While ``torch.profiler`` records, every span is also a
  ``dslog::<name>`` range on the profiler's timeline, as are the store
  build's always-on stage timers (``trace.timed``, histogram
  ``ingest_seconds{stage=...}``).
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
