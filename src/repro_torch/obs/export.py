"""Telemetry export: JSON snapshot schema, Prometheus text, health report.

The port of ``repro.obs.export``: the same ``telemetry.json`` envelope, so
the reference's ``validate_telemetry`` accepts a sidecar the port wrote.
``telemetry_snapshot(store)`` wraps ``store.metrics_snapshot()`` in the
``dslog-telemetry/v1`` envelope that both store types persist as a
``telemetry.json`` sidecar on checkpoint.  ``validate_telemetry`` is the
schema check used by tests and the CI smoke step; ``render_prometheus``
emits the text exposition format and ``parse_prometheus`` is the
minimal line validator the smoke step asserts with.  ``health``
combines registry red-flag heuristics with the port's ``fsck`` findings
JSON (``repro_torch.tools.fsck``).
"""

from __future__ import annotations

import json
import time

__all__ = [
    "TELEMETRY_SCHEMA",
    "telemetry_snapshot",
    "validate_telemetry",
    "render_prometheus",
    "parse_prometheus",
    "health",
]

TELEMETRY_SCHEMA = "dslog-telemetry/v1"


def telemetry_snapshot(store) -> dict:
    """Full telemetry envelope for a ``DSLog`` or ``ShardedDSLog``."""
    snap = store.metrics_snapshot()
    return {
        "schema": TELEMETRY_SCHEMA,
        "store": type(store).__name__,
        "root": getattr(store, "root", None),
        "generated_at": time.time(),
        **snap,
    }


def validate_telemetry(obj) -> dict:
    """Schema check; raises ``ValueError`` with a precise path on failure.

    Returns ``{"counters": n, "gauges": n, "histograms": n}`` so callers
    can assert non-emptiness.
    """
    if not isinstance(obj, dict):
        raise ValueError("telemetry: top level must be an object")
    if obj.get("schema") != TELEMETRY_SCHEMA:
        raise ValueError(f"telemetry: schema must be {TELEMETRY_SCHEMA!r}")
    for field in ("store", "registry"):
        if not isinstance(obj.get(field), str):
            raise ValueError(f"telemetry: {field!r} must be a string")
    for section in ("counters", "gauges", "histograms"):
        rows = obj.get(section)
        if not isinstance(rows, list):
            raise ValueError(f"telemetry: {section!r} must be a list")
        for i, row in enumerate(rows):
            where = f"telemetry: {section}[{i}]"
            if not isinstance(row, dict):
                raise ValueError(f"{where} must be an object")
            if not isinstance(row.get("name"), str):
                raise ValueError(f"{where}.name must be a string")
            if not isinstance(row.get("labels"), dict):
                raise ValueError(f"{where}.labels must be an object")
            if section == "histograms":
                for field in ("count", "sum", "min", "max", "p50", "p90", "p99"):
                    if not isinstance(row.get(field), (int, float)):
                        raise ValueError(f"{where}.{field} must be numeric")
                buckets = row.get("buckets")
                if not isinstance(buckets, list) or not all(
                    isinstance(b, (list, tuple)) and len(b) == 2 for b in buckets
                ):
                    raise ValueError(f"{where}.buckets must be [index, count] pairs")
            else:
                if not isinstance(row.get("value"), (int, float)):
                    raise ValueError(f"{where}.value must be numeric")
    return {
        "counters": len(obj["counters"]),
        "gauges": len(obj["gauges"]),
        "histograms": len(obj["histograms"]),
    }


def _prom_name(name: str, prefix: str) -> str:
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"{prefix}_{safe}"


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def render_prometheus(snapshot: dict, prefix: str = "dslog") -> str:
    """Prometheus text exposition (0.0.4) for a telemetry snapshot."""
    lines: list[str] = []
    seen_types: set[str] = set()

    def type_line(name: str, kind: str) -> None:
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in snapshot.get("counters", ()):
        name = _prom_name(row["name"], prefix) + "_total"
        type_line(name, "counter")
        lines.append(f"{name}{_prom_labels(row['labels'])} {row['value']}")
    for row in snapshot.get("gauges", ()):
        name = _prom_name(row["name"], prefix)
        type_line(name, "gauge")
        lines.append(f"{name}{_prom_labels(row['labels'])} {row['value']}")
    for row in snapshot.get("histograms", ()):
        name = _prom_name(row["name"], prefix)
        type_line(name, "histogram")
        base = row.get("bucket_base", 1e-9)
        factor = row.get("bucket_factor", 2.0)
        cum = 0
        for idx, count in row.get("buckets", ()):
            cum += count
            le = base * factor ** int(idx)
            lines.append(f"{name}_bucket{_prom_labels(row['labels'], {'le': repr(le)})} {cum}")
        lines.append(f"{name}_bucket{_prom_labels(row['labels'], {'le': '+Inf'})} {row['count']}")
        lines.append(f"{name}_sum{_prom_labels(row['labels'])} {row['sum']}")
        lines.append(f"{name}_count{_prom_labels(row['labels'])} {row['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> int:
    """Validate exposition text line-by-line; returns the sample count.

    Not a full parser — enough to catch malformed names, labels, or
    values, which is what the CI smoke step asserts.
    """
    samples = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        body = line
        if "{" in body:
            name, rest = body.split("{", 1)
            if "}" not in rest:
                raise ValueError(f"prometheus line {lineno}: unterminated labels")
            labels, value_part = rest.rsplit("}", 1)
            for pair in labels.split(","):
                if "=" not in pair:
                    raise ValueError(f"prometheus line {lineno}: bad label {pair!r}")
                k, v = pair.split("=", 1)
                if not k.strip() or not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"prometheus line {lineno}: bad label {pair!r}")
        else:
            parts = body.split()
            if len(parts) != 2:
                raise ValueError(f"prometheus line {lineno}: expected 'name value'")
            name, value_part = parts
        name = name.strip()
        if not name or not (name[0].isalpha() or name[0] == "_"):
            raise ValueError(f"prometheus line {lineno}: bad metric name {name!r}")
        value = value_part.strip().split()[0]
        float(value)  # raises ValueError on malformed sample
        samples += 1
    return samples


def _flag(flags: list, severity: str, name: str, detail: str) -> None:
    flags.append({"severity": severity, "flag": name, "detail": detail})


def health(store, run_fsck: bool = True) -> dict:
    """Red-flag report: registry heuristics + ``fsck`` findings JSON."""
    snap = telemetry_snapshot(store)
    counters = {}
    for row in snap.get("counters", ()):
        counters[row["name"]] = counters.get(row["name"], 0) + row["value"]
    hists = {}
    for row in snap.get("histograms", ()):
        if not row["labels"]:
            hists[row["name"]] = row

    flags: list[dict] = []
    replayed = counters.get("wal_replayed", 0)
    if replayed:
        _flag(
            flags,
            "warning",
            "wal-replayed",
            f"{replayed} WAL records replayed on open (unclean shutdown)",
        )
    fsync = hists.get("wal_fsync_seconds")
    if fsync and fsync["count"] >= 8 and fsync["p99"] > 0.25:
        _flag(
            flags,
            "warning",
            "fsync-slow",
            f"fsync p99 {fsync['p99'] * 1e3:.1f}ms over {fsync['count']} syncs",
        )
    made = counters.get("views_materialized", 0)
    killed = counters.get("views_invalidated", 0)
    if made >= 4 and killed > 4 * made:
        _flag(
            flags,
            "warning",
            "views-thrashing",
            f"{killed} invalidations for {made} materializations",
        )
    hits = counters.get("cache_hits", 0)
    misses = counters.get("cache_misses", 0)
    if hits + misses >= 64 and hits < (hits + misses) * 0.01:
        _flag(
            flags,
            "info",
            "cache-cold",
            f"answer-cache hit rate {hits}/{hits + misses}",
        )

    fsck_report = None
    ok = True
    if run_fsck and getattr(store, "root", None):
        try:
            from repro_torch.tools.fsck import fsck_store

            fsck_report = fsck_store(store.root).to_json()
            # findings follow the shared analysis-tool schema
            # (tools/findings.py): rule = fsck category, message = detail
            for finding in fsck_report.get("findings", ()):
                if finding.get("severity") == "error":
                    ok = False
                    _flag(
                        flags,
                        "error",
                        f"fsck:{finding.get('rule')}",
                        finding.get("message", ""),
                    )
        except Exception as exc:  # fsck must never take the store down
            _flag(flags, "info", "fsck-unavailable", repr(exc))

    return {
        "ok": ok and not any(f["severity"] == "error" for f in flags),
        "flags": flags,
        "fsck": fsck_report,
        "counters": counters,
        "generated_at": snap["generated_at"],
    }


def dump_json(snapshot: dict) -> str:
    return json.dumps(snapshot, indent=2, sort_keys=True)
