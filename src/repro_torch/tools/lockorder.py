"""The declared lock-order table for ``repro_torch.core``.

A copy of ``repro.tools.lockorder``'s, rank for rank: the reference's static
lint (``dslint``) resolves the port's locks against its own table by
(module stem, attribute), and the port's race detector checks the same
ranks at runtime.

Both analysis layers consume this module: ``dslint`` checks syntactically
nested ``with`` acquisitions against it, and ``racecheck`` checks the actual
per-thread acquisition order at runtime.  A thread may only acquire a lock
whose rank is *strictly greater* than every lock it already holds (reentrant
re-acquisition of the same RLock object is exempt).

Rank order (outermost → innermost):

1.  ``shard._shard_load_lock`` — serialises lazy shard materialisation on a
    ``ShardedDSLog``; taken before any per-shard state is touched.
2.  ``views._lock`` — ``ViewManager`` state (materialized views, route
    heat, the answer cache).  Invalidation hooks fire while a shard is
    being absorbed (load lock held), so it nests inside the load lock; view
    composition and blob loads happen *outside* it, so it stays above
    ``table._lock``.
3.  ``table._lock`` — per-``TableHandle`` single-fire load latch; the loader
    may bump store I/O meters, so it sits above the stats locks.
4.  ``commit._flush_mutex`` — the durability barrier: held across "write
    dirty state, then flush the WAL", so it must be *outside* ``wal._lock``.
    This is the one place the code deviates from the naive
    catalog → shard → wal → commit reading of the subsystem layering: the
    commit pipeline is the WAL's *caller* during a flush, never the other
    way round, so commit locks rank above (outside) the WAL lock.
5.  ``commit._lock`` — protects the pipeline's dirty/LSN bookkeeping; nested
    inside ``_flush_mutex`` by ``CommitPipeline._flush_dirty``.
6.  ``wal._lock`` — serialises appends/flushes on one ``WriteAheadLog``.
7.  ``shard._stats_lock`` — ``ShardedDSLog`` I/O + hop-stats meters (leaf).
8.  ``catalog._stats_lock`` — ``DSLog`` I/O + hop-stats meters (leaf).
9.  ``autotune._lock`` — a ``GeometryTuner``'s winner table.  Measurement
    runs *outside* it (runners execute real workloads that take stats
    locks); the lock only guards table reads/writes, so it is a leaf that
    callers holding any stats lock may still take.
10. ``metrics._lock`` — a ``MetricsRegistry``'s instrument table.  Every
    counter/histogram update may fire while any of the locks above is
    held (WAL appends, commit flushes, stats bookkeeping), so the
    registry lock is a leaf below all of them and takes no other lock.
11. ``trace._lock`` — a ``QueryTrace``'s span-attach lock.  Span exit
    reads counter deltas (``metrics._lock``) *before* attaching, so the
    trace lock nests innermost of all.

Lock names are ``"<module stem>.<attribute>"``; every lock constructed via
``repro_torch.core._locks`` carries one.
"""

from __future__ import annotations

LOCK_ORDER: dict[str, int] = {
    "shard._shard_load_lock": 10,
    "views._lock": 15,
    "table._lock": 20,
    "commit._flush_mutex": 30,
    "commit._lock": 40,
    "wal._lock": 50,
    "shard._stats_lock": 60,
    "catalog._stats_lock": 70,
    "autotune._lock": 75,
    "metrics._lock": 80,
    "trace._lock": 90,
}

#: One-line role per lock, for generated documentation (README table).
LOCK_ROLES: dict[str, str] = {
    "shard._shard_load_lock": "serialises lazy shard materialisation on a `ShardedDSLog`",
    "views._lock": "`ViewManager` state: materialized views, route heat, answer cache",
    "table._lock": "per-`TableHandle` single-fire blob-load latch",
    "commit._flush_mutex": "group-commit durability barrier (held across write-then-flush)",
    "commit._lock": "commit pipeline dirty/LSN bookkeeping",
    "wal._lock": "serialises appends/flushes on one `WriteAheadLog`",
    "shard._stats_lock": "`ShardedDSLog` I/O + hop-stats meters",
    "catalog._stats_lock": "`DSLog` I/O + hop-stats meters",
    "autotune._lock": "`GeometryTuner` winner table (measurement runs outside it)",
    "metrics._lock": "a `MetricsRegistry`'s instrument table (leaf)",
    "trace._lock": "a `QueryTrace`'s span-attach lock (innermost)",
}

#: (module stem, attribute name) → declared lock name, for the static pass.
#: ``self.log._stats_lock`` inside ``shard.py`` resolves through the module
#: stem, so facade code touching its own stats lock maps correctly.
STATIC_LOCKS: dict[tuple[str, str], str] = {
    ("shard", "_shard_load_lock"): "shard._shard_load_lock",
    ("views", "_lock"): "views._lock",
    ("shard", "_stats_lock"): "shard._stats_lock",
    ("catalog", "_stats_lock"): "catalog._stats_lock",
    # planner accumulates EXPLAIN ANALYZE measurements under the owning
    # store's stats lock (self.log._stats_lock)
    ("planner", "_stats_lock"): "catalog._stats_lock",
    ("table", "_lock"): "table._lock",
    ("wal", "_lock"): "wal._lock",
    ("commit", "_lock"): "commit._lock",
    ("commit", "_flush_mutex"): "commit._flush_mutex",
    ("autotune", "_lock"): "autotune._lock",
    ("metrics", "_lock"): "metrics._lock",
    ("trace", "_lock"): "trace._lock",
}


def rank(name: str) -> int | None:
    """Rank of a declared lock name; ``None`` for locks outside the table."""
    return LOCK_ORDER.get(name)


def ranked() -> list[tuple[str, int]]:
    """``(name, rank)`` pairs, outermost (lowest rank) first."""
    return sorted(LOCK_ORDER.items(), key=lambda kv: kv[1])


def markdown_table() -> str:
    """The lock-rank table as GitHub markdown (the README embeds this
    between ``<!-- lockorder:begin -->`` / ``<!-- lockorder:end -->``
    markers; a test regenerates it so the docs can't drift)."""
    lines = ["| Rank | Lock | Guards |", "|-----:|------|--------|"]
    for name, r in ranked():
        role = LOCK_ROLES.get(name, "")
        lines.append(f"| {r} | `{name}` | {role} |")
    return "\n".join(lines)


def main(argv: "list[str] | None" = None) -> int:
    """``python -m repro_torch.tools.lockorder [--markdown|--json]``"""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.lockorder",
        description="print the declared lock-order table",
    )
    ap.add_argument("--markdown", action="store_true", help="README table")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)
    if args.markdown:
        print(markdown_table())
    elif args.json:
        print(json.dumps({"lock_order": dict(ranked())}, indent=2))
    else:
        for name, r in ranked():
            print(f"{r:>3}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
