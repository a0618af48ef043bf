"""Telemetry inspector for DSLog stores (``python -m repro_torch.tools.dstat``).

The port of ``repro.tools.dstat``: the same subcommands, output and exit
codes, on the port's ``obs.export`` schema check and Prometheus renderer.

Reads the write-only ``telemetry.json`` sidecar a store refreshes on every
checkpoint (see :func:`repro_torch.obs.export.telemetry_snapshot`) and renders it
without importing or opening the store itself — safe to point at a
directory a live writer owns.

Subcommands::

    python -m repro_torch.tools.dstat dump  ROOT [--json | --prometheus]
    python -m repro_torch.tools.dstat watch ROOT [--interval 2.0] [--count N]
    python -m repro_torch.tools.dstat diff  A B

* ``dump`` — human-readable counters / gauges / histogram percentiles; or
  the validated snapshot verbatim (``--json``); or Prometheus text
  exposition (``--prometheus``).
* ``watch`` — re-read the sidecar every ``--interval`` seconds and print
  the counters that changed since the previous read (top-style delta
  view).  ``--count`` bounds the number of reads (0 = forever).
* ``diff`` — counter and histogram-count deltas between two snapshots
  (older first); each operand is a ``telemetry.json`` path or a store
  root containing one.

Exit status: 0 on success, 2 on unreadable/invalid input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.obs.export import render_prometheus, validate_telemetry

__all__ = ["load_snapshot", "format_snapshot", "diff_snapshots", "main"]


def _snapshot_path(target: str) -> str:
    """Resolve a CLI operand to a telemetry.json path."""
    if os.path.isdir(target):
        return os.path.join(target, "telemetry.json")
    return target


def load_snapshot(target: str) -> dict:
    """Load and schema-validate a snapshot from a file or store root."""
    path = _snapshot_path(target)
    with open(path, "rb") as f:
        snap = json.loads(f.read().decode("utf-8"))
    validate_telemetry(snap)
    return snap


def _counter_map(snap: dict) -> dict[str, int]:
    """Counters flattened to ``name{k=v,...}`` -> value."""
    out: dict[str, int] = {}
    for row in snap.get("counters", []):
        labels = row.get("labels") or {}
        key = row["name"]
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = f"{key}{{{inner}}}"
        out[key] = out.get(key, 0) + int(row["value"])
    return out


def _histogram_rows(snap: dict) -> list[tuple[str, dict]]:
    rows = []
    for row in snap.get("histograms", []):
        labels = row.get("labels") or {}
        key = row["name"]
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = f"{key}{{{inner}}}"
        rows.append((key, row))
    return rows


def format_snapshot(snap: dict) -> str:
    """Human-readable dump: counters, gauges, histogram percentiles."""
    lines = [
        f"registry: {snap.get('registry', '?')}"
        f"  store: {snap.get('store', '?')}  root: {snap.get('root', '?')}"
    ]
    counters = _counter_map(snap)
    if counters:
        lines.append("counters:")
        width = max(len(k) for k in counters)
        for key in sorted(counters):
            lines.append(f"  {key:<{width}}  {counters[key]}")
    gauges = snap.get("gauges", [])
    if gauges:
        lines.append("gauges:")
        for row in sorted(gauges, key=lambda r: (r["name"], str(r["labels"]))):
            labels = row.get("labels") or {}
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            name = f"{row['name']}{{{inner}}}" if inner else row["name"]
            lines.append(f"  {name}  {row['value']:g}")
    hists = _histogram_rows(snap)
    if hists:
        lines.append("histograms:")
        for key, row in sorted(hists):
            lines.append(
                f"  {key}  count={row['count']} sum={row['sum']:.6g} "
                f"min={row['min']:.3g} p50={row['p50']:.3g} "
                f"p90={row['p90']:.3g} p99={row['p99']:.3g} "
                f"max={row['max']:.3g}"
            )
    return "\n".join(lines)


def diff_snapshots(old: dict, new: dict) -> dict:
    """Counter and histogram-count deltas between two snapshots.

    Keys present on either side participate; a counter that only exists in
    ``new`` diffs against zero.  Unchanged series are omitted.
    """
    oc, nc = _counter_map(old), _counter_map(new)
    counters = {
        key: nc.get(key, 0) - oc.get(key, 0)
        for key in sorted(set(oc) | set(nc))
        if nc.get(key, 0) != oc.get(key, 0)
    }
    oh = {k: r["count"] for k, r in _histogram_rows(old)}
    nh = {k: r["count"] for k, r in _histogram_rows(new)}
    histograms = {
        key: nh.get(key, 0) - oh.get(key, 0)
        for key in sorted(set(oh) | set(nh))
        if nh.get(key, 0) != oh.get(key, 0)
    }
    return {"counters": counters, "histograms": histograms}


def _cmd_dump(args: argparse.Namespace) -> int:
    snap = load_snapshot(args.target)
    if args.json:
        print(json.dumps(snap, indent=2))
    elif args.prometheus:
        print(render_prometheus(snap), end="")
    else:
        print(format_snapshot(snap))
    return 0


def _cmd_watch(args: argparse.Namespace) -> int:
    prev: dict | None = None
    reads = 0
    while True:
        try:
            snap = load_snapshot(args.target)
        except (OSError, ValueError) as exc:
            print(f"dstat: {exc}", file=sys.stderr)
            snap = None
        if snap is not None:
            if prev is None:
                print(format_snapshot(snap))
            else:
                delta = diff_snapshots(prev, snap)
                changed = {**delta["counters"], **delta["histograms"]}
                stamp = time.strftime("%H:%M:%S")
                if changed:
                    body = "  ".join(
                        f"{k}{v:+d}" for k, v in sorted(changed.items())
                    )
                    print(f"[{stamp}] {body}")
                else:
                    print(f"[{stamp}] (no change)")
            prev = snap
        reads += 1
        if args.count and reads >= args.count:
            return 0
        time.sleep(args.interval)


def _cmd_diff(args: argparse.Namespace) -> int:
    old = load_snapshot(args.old)
    new = load_snapshot(args.new)
    delta = diff_snapshots(old, new)
    if args.json:
        print(json.dumps(delta, indent=2))
        return 0
    if not delta["counters"] and not delta["histograms"]:
        print("no change")
        return 0
    for section in ("counters", "histograms"):
        if delta[section]:
            print(f"{section}:")
            for key, val in delta[section].items():
                print(f"  {key}  {val:+d}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.dstat",
        description="inspect a DSLog store's telemetry.json sidecar",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    dump = sub.add_parser("dump", help="print one snapshot")
    dump.add_argument("target", help="store root or telemetry.json path")
    fmt = dump.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true", help="raw validated JSON")
    fmt.add_argument(
        "--prometheus", action="store_true", help="Prometheus text exposition"
    )
    dump.set_defaults(fn=_cmd_dump)

    watch = sub.add_parser("watch", help="poll the sidecar, print deltas")
    watch.add_argument("target", help="store root or telemetry.json path")
    watch.add_argument("--interval", type=float, default=2.0)
    watch.add_argument(
        "--count", type=int, default=0, help="stop after N reads (0 = forever)"
    )
    watch.set_defaults(fn=_cmd_watch)

    diff = sub.add_parser("diff", help="delta between two snapshots")
    diff.add_argument("old", help="older snapshot (root or file)")
    diff.add_argument("new", help="newer snapshot (root or file)")
    diff.add_argument("--json", action="store_true")
    diff.set_defaults(fn=_cmd_diff)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as exc:
        print(f"dstat: {exc}", file=sys.stderr)
        return 2
    except ValueError as exc:
        print(f"dstat: invalid telemetry: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
