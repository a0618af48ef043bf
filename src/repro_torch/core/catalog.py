"""DSLog — the lineage storage manager (paper §III, §V, §VI).

The port of ``repro.core.catalog``: the same manifest, blob and WAL bytes,
so either package opens a store the other wrote.  The catalog owns:

* named, shape-declared **Arrays** (§III.A ``Array``),
* **lineage entries** — ProvRC-compressed backward (+ optionally forward)
  tables between array pairs (§III.A ``Lineage``),
* the **lineage DAG** (:class:`~repro_torch.core.graph.LineageGraph`) —
  built incrementally as entries arrive (with cycle rejection) and rebuilt
  from the manifest on load,
* **operation registrations** that bundle multiple lineage entries under an
  operation signature and drive automatic reuse prediction (§VI),
* **persistence** — a versioned JSON manifest plus one packed binary blob
  per table (optionally zlib-compressed, i.e. ProvRC-GZip).  Reloaded
  tables are *lazy* (:class:`~repro_torch.core.table.TableHandle`): a blob
  deserializes the first time a query or stat actually touches it, and
  ``save()`` rewrites only entries added since the last save/load (dirty
  tracking).  Op records and the
  :class:`~repro_torch.core.reuse.ReusePredictor` state round-trip too;
* **durability** — :meth:`DSLog.open` attaches a write-ahead log, group
  commit and a writer lease; :meth:`DSLog.load` replays the log's tail;
* **materialized views** and the answer cache
  (:class:`~repro_torch.core.views.ViewManager`).

Multi-hop ``prov_query`` (§V) comes in two forms, both served by the
cost-based :class:`~repro_torch.core.planner.QueryPlanner`, whose dense
joins run on the store's ``device``:

* ``prov_query(path, cells)`` — the paper's explicit array path;
* ``prov_query(src, dst, cells)`` — graph form: the planner routes over the
  lineage DAG itself, merging converging branches at fan-in arrays.

Growth beyond the paper: :meth:`DSLog.compact` vacuums blobs orphaned by
:meth:`DSLog.drop_lineage` and predictor updates; :meth:`DSLog.version`
mints ``acc@k`` names for in-place ops; executed hops feed their true pair
counts back into the manifest (:meth:`DSLog.record_hop` /
:meth:`DSLog.hop_measurement`) so replanning uses measured selectivities;
and :class:`~repro_torch.core.shard.ShardedDSLog` serves this whole surface
over N independently persisted shards.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.kernels.autotune import GeometryTuner
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs.export import telemetry_snapshot
from repro_torch.obs.metrics import IoStatsView, MetricsRegistry
from repro_torch.obs.trace import QueryTrace, activated, maybe_span, timed

from . import _locks
from .commit import CommitPipeline, WriterLease
from .graph import CycleError, LineageGraph
from .index import IntervalIndex
from .planner import QueryPlanner
from .provrc import compress
from .query import QueryBox
from .relation import LineageRelation
from .reuse import (
    ReusePredictor,
    sig_key_base,
    sig_key_dim,
    sig_key_gen,
)
from .table import CompressedTable, TableHandle
from .views import ViewManager
from .wal import WAL_FILENAME, WalRecord, WriteAheadLog

__all__ = ["DSLog", "ArrayDef", "LineageEntry"]

# Tables at or above this row count get their key index built and persisted
# at save time, so a reloaded catalog serves its first selective query
# without paying the O(n log n) sort.
_INDEX_PERSIST_MIN_ROWS = 4096

_MANIFEST_VERSION = 3

# Constructor options that open() may apply to an already-loaded store.
# (reuse_m lands on the predictor: the ctor only forwards it there.)
_OPEN_OVERRIDES = ("store_forward", "compress_method", "gzip", "hop_decay", "reuse_m")

# Counters pre-seeded at zero in every store registry so reads and `in`
# checks on the io_stats view behave like a dict.
SEED_COUNTERS = (
    "tables_loaded",
    "tables_written",
    "manifests_written",
    "sig_tables_written",
    "bytes_written",
    # batched plan-step execution: packed dense dispatches (device kernel
    # launches, or their CPU-twin equivalents), how many joins rode each,
    # and pack occupancy (rows used vs padded)
    "kernel_launches",
    "joins_packed",
    "batch_rows",
    "batch_rows_padded",
    # tile schedule of those dispatches: tiles actually evaluated vs the
    # cross-product tiles the block-diagonal layout skipped
    "batch_tiles_visited",
    "batch_tiles_skipped",
    # every join a query runs, by the route it took: the interval index,
    # the dense kernel (one batched dispatch's segment, or a per-hop
    # range_join_mask launch), the dense numpy path
    "joins_index",
    "joins_dense_kernel",
    "joins_dense_twin",
    # query-side boxes (the pooled distinct frontier boxes) of every join a
    # query runs, whichever route and engine ran it
    "frontier_boxes",
    # index-routed joins a CUDA executor ran as a kernel segment instead
    # (query.index_to_kernel; counted in joins_dense_kernel too)
    "joins_index_to_kernel",
    # kernel segments whose table side was already resident on the device,
    # and those that packed and uploaded it (CompressedTable.kernel_pack)
    "table_packs_resident",
    "table_packs_built",
    # materialized views + answer cache (repro/core/views.py)
    "view_hits",
    "view_misses",
    "cache_hits",
    "cache_misses",
    "views_materialized",
    "views_demoted",
    "views_invalidated",
)


def _apply_open_overrides(log, ctor_kw: dict) -> None:
    for key, val in ctor_kw.items():
        if key not in _OPEN_OVERRIDES:
            raise TypeError(
                f"unknown store option {key!r} for open(); valid on an "
                f"existing store: {', '.join(_OPEN_OVERRIDES)}"
            )
        if key == "reuse_m" and not hasattr(log, "reuse_m"):
            log.predictor.m = int(val)
        else:
            setattr(log, key, val)
            if key == "reuse_m":
                log.predictor.m = int(val)

# Cost-feedback aging: every new hop measurement decays the accumulated
# (pairs, qrows) mass by this factor before adding its own, so the measured
# selectivity is an exponential moving average — replanning stays honest
# after the workload shifts instead of being pinned to ancient traffic.
_DEFAULT_HOP_DECAY = 0.9
# ...and the accumulated qrows mass is capped, bounding how much history a
# shifted workload has to out-shout (the "sample cap" of the EMA).
_HOP_SAMPLE_CAP = 1e6


def _sig_blob_name(key: str, label: str) -> str:
    """Stable per-(signature, pair-label) blob name.

    Deterministic naming is what makes per-signature dirty tracking work: a
    re-saved signature overwrites its own blobs, a clean signature's blobs
    are never touched, and blobs orphaned by a rejected signature are
    recognizable to :meth:`DSLog.compact`.
    """
    h = hashlib.sha1(key.encode()).hexdigest()[:10]
    return f"sig_{h}_{label.replace(':', '-')}.prvc"


def _atomic_write(path: str, payload: str) -> None:
    """Crash-safe manifest write: temp file + fsync + atomic rename, so a
    torn save can never leave a half-written ``catalog.json`` behind."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_blob(path: str, blob: bytes) -> None:
    """Write a manifest-referenced blob durably (write + fsync).

    The manifest only becomes visible through :func:`_atomic_write`'s
    rename; every blob it references must already be on stable storage by
    then, or a crash right after the rename could publish a manifest
    pointing at torn blobs.  Module-level because ``ShardedDSLog`` borrows
    the ``DSLog`` writer methods that call it.
    """
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def is_catalog_blob(fn: str) -> bool:
    """Is ``fn`` a blob the catalog owns (and may therefore vacuum)?

    Shared by :func:`_vacuum_dir`'s sweep and ``repro_torch.tools.fsck``'s
    orphan-blob check so GC and verification agree on ownership.
    """
    return (
        (fn.startswith("lineage_") and fn.endswith((".prvc", ".idx")))
        or (fn.startswith("sig_") and fn.endswith(".prvc"))
        or (fn.startswith("view_") and fn.endswith(".prvc"))
    )


def manifest_referenced_files(
    lineage_recs, predictor_chunk, views_chunk=None
) -> set[str]:
    """The blob closure of a manifest: every file its records reference.

    ``lineage_recs`` is an iterable of persisted lineage records (the
    manifest's ``lineage`` list, or ``DSLog._persisted.values()`` — same
    schema); ``predictor_chunk``/``views_chunk`` are the manifest's
    ``predictor``/``views`` chunks or ``None``.  Single source of truth
    shared by :meth:`DSLog.compact` and ``repro_torch.tools.fsck``, so the
    vacuum and the orphan check can't drift.
    """
    referenced = {"catalog.json"}
    for rec in lineage_recs:
        for key in ("file", "idx", "fwd", "fwd_idx"):
            if rec.get(key):
                referenced.add(rec[key])
    if predictor_chunk:
        for rec in predictor_chunk.get("sigs", []):
            referenced.update(rec.get("tables", {}).values())
    if views_chunk:
        for rec in views_chunk.get("views", []):
            for key in ("file", "fwd"):
                if rec.get(key):
                    referenced.add(rec[key])
    return referenced


def _vacuum_dir(root: str, referenced: set[str]) -> dict[str, int]:
    """Delete catalog-owned blob files under ``root`` not in ``referenced``.

    Only files matching the catalog's own naming patterns
    (:func:`is_catalog_blob`) are candidates; anything else in the
    directory is left alone.
    """
    removed = reclaimed = 0
    for fn in os.listdir(root):
        path = os.path.join(root, fn)
        if not os.path.isfile(path) or fn in referenced:
            continue
        if not is_catalog_blob(fn):
            continue
        reclaimed += os.path.getsize(path)
        os.remove(path)
        removed += 1
    return {"files_removed": removed, "bytes_reclaimed": reclaimed}


@dataclass
class ArrayDef:
    name: str
    shape: tuple[int, ...]


class LineageEntry:
    """Compressed lineage between an op input (src) and op output (dst).

    After ``DSLog.load`` the tables are :class:`TableHandle`s: reading
    :attr:`backward` / :attr:`forward` deserializes the blob on first touch.
    Row counts (:meth:`backward_rows` / :meth:`forward_rows`) come from the
    manifest, so the planner can cost a hop without any I/O.
    """

    def __init__(
        self,
        lineage_id: int,
        src: str,
        dst: str,
        backward: "CompressedTable | TableHandle",
        forward: "CompressedTable | TableHandle | None" = None,
        op_name: str | None = None,
        reused_from: str | None = None,
    ):
        self.lineage_id = lineage_id
        self.src = src  # input array name
        self.dst = dst  # output array name
        self.op_name = op_name
        self.reused_from = reused_from
        self._bwd = backward
        self._fwd = forward

    # ------------------------------------------------------------------ #
    @property
    def backward(self) -> CompressedTable:
        """Backward table (keys = dst axes); loads a lazy handle."""
        if isinstance(self._bwd, TableHandle):
            return self._bwd.get()
        return self._bwd

    @property
    def forward(self) -> CompressedTable | None:
        """Forward table (keys = src axes) or None; loads a lazy handle."""
        if isinstance(self._fwd, TableHandle):
            return self._fwd.get()
        return self._fwd

    @property
    def has_forward(self) -> bool:
        """Whether a forward materialization exists, without loading it."""
        return self._fwd is not None

    @property
    def backward_loaded(self) -> bool:
        return not isinstance(self._bwd, TableHandle) or self._bwd.loaded

    @property
    def forward_loaded(self) -> bool:
        if self._fwd is None:
            return False
        return not isinstance(self._fwd, TableHandle) or self._fwd.loaded

    @property
    def backward_rows(self) -> int:
        if isinstance(self._bwd, TableHandle):
            return self._bwd.rows
        return self._bwd.n_rows

    @property
    def forward_rows(self) -> int | None:
        if self._fwd is None:
            return None
        if isinstance(self._fwd, TableHandle):
            return self._fwd.rows
        return self._fwd.n_rows

    def peek_table(self, stored: str) -> CompressedTable | None:
        """The materialized table, or None while the blob is unloaded."""
        obj = self._bwd if stored == "backward" else self._fwd
        if obj is None or isinstance(obj, CompressedTable):
            return obj
        return obj._table

    def __repr__(self) -> str:  # keep the old dataclass-ish readability
        state = "loaded" if self.backward_loaded else "lazy"
        return (
            f"LineageEntry(id={self.lineage_id}, {self.src!r}->{self.dst!r}, "
            f"op={self.op_name!r}, {state})"
        )


@dataclass
class _OpRecord:
    op_name: str
    in_arrs: tuple[str, ...]
    out_arrs: tuple[str, ...]
    op_args: Any
    lineage_ids: list[int] = field(default_factory=list)
    reused: str | None = None


def _json_safe(op_args: Any) -> Any:
    """Best-effort JSON projection of op args for the manifest.

    Non-JSON args degrade to a repr marker: the op record survives the
    round-trip, but signature keys derived from it will no longer match the
    original live object (document-level caveat, not an error).
    """
    try:
        json.dumps(op_args)
        return op_args
    except TypeError:
        return {"__repr__": repr(op_args)}


class DSLog:
    """The lineage index service, on one device.

    ``device`` is where dense θ-joins run (queries and view composition):
    ``"cuda"`` (the default) launches the CUDA range-join kernels and
    raises at construction when CUDA is not available; ``"cpu"`` is the
    reference's interpret mode (the numpy twin, or the kernels' plain
    PyTorch versions under ``planner.executor``'s ``engine="kernel"``).
    """

    def __init__(
        self,
        root: str | None = None,
        store_forward: bool = True,
        compress_method: str = "auto",
        reuse_m: int = 1,
        gzip: bool = True,
        hop_decay: float = _DEFAULT_HOP_DECAY,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.root = root
        self.store_forward = store_forward
        self.compress_method = compress_method
        self.gzip = gzip
        self.hop_decay = float(hop_decay)
        self.arrays: dict[str, ArrayDef] = {}
        self.lineage: dict[int, LineageEntry] = {}
        self.by_pair: dict[tuple[str, str], list[int]] = {}
        self.graph = LineageGraph()
        self.ops: list[_OpRecord] = []
        self.predictor = ReusePredictor(m=reuse_m)
        self.planner = QueryPlanner(self)
        self.views = ViewManager(self)
        # measured launch geometries for the batched join engines, persisted
        # as an autotune.json sidecar and consulted by planner.executor
        self.autotune = GeometryTuner()
        self._next_id = 0
        # persistence bookkeeping: which entries need (re)writing, the
        # manifest records of already-persisted entries, and lazy-I/O
        # counters that tests/benchmarks assert on.
        self._dirty: set[int] = set()
        self._persisted: dict[int, dict] = {}
        self._predictor_chunk: dict | None = None
        # non-blob manifest state (arrays, ops, versions, hop stats) changed
        # since the last save/load
        self._meta_dirty = False
        self._stats_lock = _locks.new_rlock("catalog._stats_lock")
        # measured per-hop selectivities: "lid:stored:side" -> [pairs, qrows]
        self.hop_stats: dict[str, list[float]] = _locks.guard_mapping(
            {}, self._stats_lock, "DSLog.hop_stats"
        )
        # versioned-name counters for in-place ops: base name -> latest k
        self._versions: dict[str, int] = {}
        # telemetry: all I/O meters live in the registry (internally
        # locked, rank above _stats_lock); io_stats is a live read-only
        # dict view over its unlabeled counters.
        self.metrics = MetricsRegistry("dslog")
        self.metrics.seed_counters(SEED_COUNTERS)
        self.metrics.register_collector(self._collect_gauges)
        self.io_stats = IoStatsView(self.metrics)
        # durability subsystem (attached by open()/load(); None = legacy
        # explicit-save store with no write-ahead log)
        self._wal: WriteAheadLog | None = None
        self._pipeline: CommitPipeline | None = None
        self._lease: WriterLease | None = None
        self._wal_lsn = 0  # manifest checkpoint LSN: replay starts past it
        self._replaying = False
        self._closed = False
        if root:
            os.makedirs(root, exist_ok=True)

    def _bump(self, key: str, n: int = 1) -> None:
        self.metrics.inc(key, n)

    def _collect_gauges(self):
        """Snapshot-time gauges: hop-stat EMAs and view-manager state.

        Runs outside the registry lock (it takes ``_stats_lock`` /
        ``views._lock``), so derived state exports with zero hot-path
        cost.
        """
        with self._stats_lock:
            hops = {k: tuple(v) for k, v in self.hop_stats.items()}
        # Cap the per-hop series so a huge store exports a bounded page.
        top = sorted(hops.items(), key=lambda kv: -kv[1][0])[:32]
        for key, (pairs, qrows) in top:
            yield ("hop_pairs_ema", {"hop": key}, pairs)
            yield ("hop_qrows_ema", {"hop": key}, qrows)
        try:
            vstats = self.views.stats()
        except Exception:
            return
        for name, val in vstats.items():
            if isinstance(val, (int, float)):
                yield (f"views_{name}", {}, val)

    def metrics_snapshot(self) -> dict:
        """Structured dump of every instrument (see ``repro_torch.obs``)."""
        return self.metrics.snapshot()

    def health(self, run_fsck: bool = True) -> dict:
        """Registry red-flags + ``fsck`` findings (``repro_torch.obs.export``)."""
        from repro_torch.obs.export import health as _health

        return _health(self, run_fsck=run_fsck)

    def _drop_hop_stats(self, lineage_id: int) -> None:
        """Forget measured selectivities for one entry, under the stats lock.

        Deletes in place — never rebinds ``hop_stats`` — so concurrent
        readers (and the race detector's guard wrapper) keep observing the
        same mapping object.
        """
        with self._stats_lock:
            stale = [
                k for k in self.hop_stats if int(k.split(":", 1)[0]) == lineage_id
            ]
            for k in stale:
                del self.hop_stats[k]

    @property
    def dirty(self) -> bool:
        """Anything (entries, predictor, views, or manifest metadata)
        unsaved?"""
        return (
            bool(self._dirty)
            or self.predictor.dirty
            or self._meta_dirty
            or self.views.dirty
        )

    # ------------------------------------------------------------------ #
    # Durable concurrent ingest: WAL, group commit, leases, recovery
    # ------------------------------------------------------------------ #
    @classmethod
    def open(
        cls,
        root: str,
        *,
        durability: str = "group",
        flush_interval: float = 0.005,
        max_batch: int = 256,
        lease_ttl: float = 300.0,
        device="cuda",
        **ctor_kw,
    ) -> "DSLog":
        """Open ``root`` as the store's (single) writer, durably.

        Acquires the directory's writer lease (a second concurrent open
        raises :class:`~repro_torch.core.commit.LeaseHeldError`), loads the
        manifest if one exists, replays the write-ahead log tail past the
        last checkpoint — truncating any torn trailing record — and
        attaches a :class:`~repro_torch.core.commit.CommitPipeline` so every
        subsequent mutation is logged before it is acknowledged.

        ``durability`` is ``"group"`` (default: one fsync per
        ``flush_interval`` / ``max_batch`` batch), ``"sync"`` (fsync per
        record), or ``"manual"`` (fsync only at :meth:`commit` /
        :meth:`checkpoint`).  ``device`` is the store's (see the class
        doc).  Use as a context manager::

            with DSLog.open("/data/lineage") as log:
                log.add_lineage(...)
            # exit = checkpoint (incremental save + log truncation),
            # lease release
        """
        device = resolve_device(device)
        os.makedirs(root, exist_ok=True)
        lease = WriterLease.acquire(root, ttl=lease_ttl)
        try:
            if os.path.exists(os.path.join(root, "catalog.json")):
                log = cls.load(root, device=device)
                _apply_open_overrides(log, ctor_kw)
            else:
                log = cls(root=root, device=device, **ctor_kw)
            if log._wal is None:
                # fresh store, or an existing store opened durably for the
                # first time: create the log (replays nothing).  A crashed
                # store's log was already replayed by load() above.
                log._attach_wal()
            log._wal.repair()  # we hold the lease: torn tails may be cut
            log._pipeline = CommitPipeline(
                durability, flush_interval, max_batch, metrics=log.metrics
            )
            log._pipeline.attach(log._wal)
            log._lease = lease
            return log
        except BaseException:
            lease.release()
            raise

    def __enter__(self) -> "DSLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, checkpoint: bool = True) -> None:
        """Flush, optionally checkpoint, and release the writer lease.

        ``checkpoint=False`` leaves the WAL as the only record of unsaved
        work (the next open replays it) — what a crashed writer looks like,
        minus the torn tail.  A store that was merely ``load()``-ed (no
        lease held) never checkpoints on close: truncating the log without
        the lease could destroy a live writer's records.  Idempotent.
        """
        if self._closed:
            return
        self._closed = True
        try:
            if self._pipeline is not None:
                self._pipeline.commit()
            if self._wal is not None:
                if checkpoint and self._lease is not None:
                    self.checkpoint()
                else:
                    self._wal.flush(sync=True)
        finally:
            if self._pipeline is not None:
                self._pipeline.close()
            if self._wal is not None:
                self._wal.close()
                self._wal = None
            if self._lease is not None:
                self._lease.release()
                self._lease = None

    def commit(self) -> None:
        """Durability barrier: every logged mutation is on disk on return."""
        if self._pipeline is not None:
            self._pipeline.commit()
        elif self._wal is not None:
            self._wal.flush(sync=True)

    def checkpoint(self) -> None:
        """Fold the WAL into the manifest: incremental save + truncation."""
        self.save()

    def mark_dirty(self, lineage_id: int) -> None:
        """Declare an entry's tables mutated in place.

        The catalog's dirty tracking only sees *new* entries; a workflow
        that edits a stored table in place must call this so the mutation
        is (a) logged to the WAL now — an explicit invalidation record
        carrying the current table bytes, so a crash cannot silently revert
        it — and (b) rewritten by the next checkpoint.  Cached interval
        indexes and stale hop measurements for the entry are dropped.
        """
        if lineage_id not in self.lineage:
            raise KeyError(f"no lineage entry {lineage_id}")
        e = self.lineage[lineage_id]
        bwd = e.backward  # a mutated table is necessarily resident
        bwd.invalidate_index()
        fwd = e.forward
        if fwd is not None:
            fwd.invalidate_index()
        self._dirty.add(lineage_id)
        self._meta_dirty = True
        self._drop_hop_stats(lineage_id)
        self.views.on_mutation(lineage_id)
        blobs = [self._serialize(bwd)]
        meta = {"id": lineage_id, "fwd": fwd is not None}
        if fwd is not None:
            blobs.append(self._serialize(fwd))
        self._wal_append_entry("dirty", meta, blobs)

    # -- internal plumbing --------------------------------------------- #
    def _attach_wal(
        self,
        pipeline: CommitPipeline | None = None,
        truncate: bool = False,
    ) -> int:
        """Open (or create) the root's WAL and replay its tail past the
        manifest checkpoint LSN.  Returns the number of replayed records.

        ``truncate=True`` (torn-tail repair) is reserved for callers that
        hold the store's writer lease — a plain ``load()`` must never
        mutate a log a live writer may still be appending to."""
        assert self.root is not None
        if self._wal is None:
            self._wal = WriteAheadLog(
                os.path.join(self.root, WAL_FILENAME), metrics=self.metrics
            )
        if pipeline is not None:
            self._pipeline = pipeline
            pipeline.attach(self._wal)
        replayed = self._wal.recover(self._wal_lsn, truncate=truncate)
        for rec in replayed:
            self._replay_record(rec)
        if replayed:
            self._bump("wal_replayed", len(replayed))
        return len(replayed)

    def _wal_emit(
        self, wal: WriteAheadLog | None, rtype: str, meta: dict, blobs=()
    ) -> None:
        if wal is None or self._replaying:
            return
        # legacy single-writer stores append without a lease by design:
        # they flush synchronously (below) and never truncate, so a torn
        # tail is the worst a crash leaves.  Truncation stays lease-gated
        # in the save()/checkpoint paths.
        with timed(self.metrics, "ingest_seconds", "wal_append"):
            wal.append(rtype, meta, blobs)  # dsflow: ignore[wal-lease]
        if self._pipeline is not None:
            self._pipeline.notify(wal)
        else:  # no pipeline attached (plain load): stay conservative
            wal.flush(sync=True)

    def _wal_append_root(self, rtype: str, meta: dict, blobs=()) -> None:
        """Log a store-level record (arrays, ops, versions, predictor)."""
        self._wal_emit(self._wal, rtype, meta, blobs)

    def _wal_append_entry(self, rtype: str, meta: dict, blobs=()) -> None:
        """Log an entry-level record (entry bytes, in-place invalidation)."""
        self._wal_emit(self._wal, rtype, meta, blobs)

    def _serialize(self, table: CompressedTable) -> bytes:
        """A table's stored bytes (the ``serialize`` stage of the build)."""
        with timed(self.metrics, "ingest_seconds", "serialize"):
            return table.serialize(compress=self.gzip)

    def _entry_wal_record(self, entry: LineageEntry) -> tuple[dict, list]:
        blobs = [self._serialize(entry.backward)]
        meta = {
            "id": entry.lineage_id,
            "src": entry.src,
            "dst": entry.dst,
            "op": entry.op_name,
            "reused": entry.reused_from,
            "src_shape": list(self.arrays[entry.src].shape),
            "dst_shape": list(self.arrays[entry.dst].shape),
            "fwd": entry.has_forward,
        }
        if entry.has_forward:
            blobs.append(self._serialize(entry.forward))
        return meta, blobs

    def _replay_store_record(self, rec: WalRecord) -> bool:
        """Apply one *store-level* record (array/version/op/obs).  Returns
        False for record types the caller must handle itself.  Caller holds
        ``_replaying``.
        """
        t, m = rec.type, rec.meta
        if t == "array":
            self.define_array(m["name"], tuple(m["shape"]))
        elif t == "version":
            base = m["base"]
            self._versions[base] = max(self._versions.get(base, 0), int(m["k"]))
            self._meta_dirty = True
        elif t == "op":
            self.ops.append(
                _OpRecord(
                    m["op"],
                    tuple(m["in"]),
                    tuple(m["out"]),
                    m["args"],
                    list(m["lids"]),
                    m.get("reused"),
                )
            )
            self._meta_dirty = True
        elif t == "obs":
            captured = {
                label: CompressedTable.deserialize(bytes(blob))
                for label, blob in zip(m["labels"], rec.blobs)
            }
            shapes_token = tuple(tuple(int(x) for x in s) for s in m["shapes"])
            self.predictor.observe(m["dim"], m["gen"], shapes_token, captured)
        else:
            return False
        return True

    def _replay_record(self, rec: WalRecord) -> None:
        """Apply one recovered WAL record to in-memory state.

        Replayed mutations are dirty (the manifest has not seen them) and
        must not re-log themselves — ``_replaying`` gates the WAL hooks.
        """
        t, m = rec.type, rec.meta
        self._replaying = True
        try:
            if self._replay_store_record(rec):
                pass
            elif t == "entry":
                bwd = CompressedTable.deserialize(bytes(rec.blobs[0]))
                fwd = (
                    CompressedTable.deserialize(bytes(rec.blobs[1]))
                    if m.get("fwd")
                    else None
                )
                self.arrays.setdefault(
                    m["src"], ArrayDef(m["src"], tuple(m["src_shape"]))
                )
                self.arrays.setdefault(
                    m["dst"], ArrayDef(m["dst"], tuple(m["dst_shape"]))
                )
                nxt = self._next_id
                self._next_id = int(m["id"])
                self._insert_entry(
                    m["src"], m["dst"], bwd, fwd, m.get("op"), m.get("reused")
                )
                self._next_id = max(nxt, int(m["id"]) + 1)
            elif t == "drop":
                if int(m["id"]) in self.lineage:
                    self.drop_lineage(int(m["id"]))
            elif t == "dirty":
                lid = int(m["id"])
                e = self.lineage.get(lid)
                if e is not None:
                    e._bwd = CompressedTable.deserialize(bytes(rec.blobs[0]))
                    if m.get("fwd") and len(rec.blobs) > 1:
                        e._fwd = CompressedTable.deserialize(bytes(rec.blobs[1]))
                    self._dirty.add(lid)
                    self._meta_dirty = True
                    # replay fires the same precise invalidation the live
                    # mark_dirty call did — views/answers over this entry's
                    # route must not survive recovery
                    self.views.on_mutation(lid)
            # unknown record types are skipped: forward compatibility
        finally:
            self._replaying = False

    # ------------------------------------------------------------------ #
    # Array / lineage definition (paper §III.A)
    # ------------------------------------------------------------------ #
    def define_array(self, name: str, shape: tuple[int, ...]) -> ArrayDef:
        arr = ArrayDef(name, tuple(int(d) for d in shape))
        self.arrays[name] = arr
        self._meta_dirty = True
        self._wal_append_root("array", {"name": name, "shape": list(arr.shape)})
        return arr

    # ------------------------------------------------------------------ #
    # Versioned array names for in-place ops (acc@1 → acc@2 → …)
    # ------------------------------------------------------------------ #
    def version(self, name: str, shape: tuple[int, ...] | None = None) -> str:
        """Mint (and define) the next versioned name for ``name``.

        The lineage DAG rejects self-lineage (``acc → acc``), so in-place /
        accumulator-style updates must be logged under fresh names.  Each
        call returns ``base@k`` with ``k`` increasing from 1; the new array
        is auto-defined with ``shape`` (or the latest version's shape when
        omitted), so the idiom is::

            prev = log.latest_version("acc")
            cur = log.version("acc")
            log.add_lineage(prev, cur, relation)

        Version counters persist in the manifest, so a reloaded catalog
        keeps minting from where it left off.
        """
        base = name.split("@", 1)[0]
        if shape is None:
            prev = self.latest_version(base)
            if prev in self.arrays:
                shape = self.arrays[prev].shape
        k = self._versions.get(base, 0) + 1
        self._versions[base] = k
        new = f"{base}@{k}"
        if shape is not None:
            self.define_array(new, shape)
        self._meta_dirty = True
        self._wal_append_root("version", {"base": base, "k": k})
        return new

    def latest_version(self, name: str) -> str:
        """Current name of ``name``: ``base@k`` after k ``version()`` calls,
        the base name itself before the first."""
        base = name.split("@", 1)[0]
        k = self._versions.get(base, 0)
        return base if k == 0 else f"{base}@{k}"

    def add_lineage(
        self,
        src: str,
        dst: str,
        relation: LineageRelation,
        op_name: str | None = None,
        tables: tuple[CompressedTable, CompressedTable | None] | None = None,
        reused_from: str | None = None,
    ) -> LineageEntry:
        """Ingest one captured relation (src = op input, dst = op output).

        Raises :class:`~repro_torch.core.graph.CycleError` (leaving the
        catalog untouched) when the new edge would make the lineage DAG
        cyclic.
        """
        self._check_shapes(src, dst, relation)
        if tables is not None:
            bwd, fwd = tables
        else:
            with timed(self.metrics, "ingest_seconds", "compress"):
                bwd = compress(relation, "backward", self.compress_method)
                fwd = (
                    compress(relation, "forward", self.compress_method)
                    if self.store_forward
                    else None
                )
        return self._insert_entry(src, dst, bwd, fwd, op_name, reused_from)

    def _insert_entry(
        self,
        src: str,
        dst: str,
        bwd: CompressedTable,
        fwd: CompressedTable | None,
        op_name: str | None,
        reused_from: str | None = None,
    ) -> LineageEntry:
        # cycle check first: a rejected edge must not leave a half-inserted
        # entry (graph.add_edge mutates nothing when it raises)
        self.graph.add_edge(src, dst, self._next_id)
        entry = LineageEntry(
            self._next_id, src, dst, bwd, fwd, op_name, reused_from
        )
        self._next_id += 1
        self.lineage[entry.lineage_id] = entry
        self.by_pair.setdefault((src, dst), []).append(entry.lineage_id)
        self._dirty.add(entry.lineage_id)
        self._meta_dirty = True
        self.views.on_new_edge(src, dst)
        if self._wal is not None and not self._replaying:
            meta, blobs = self._entry_wal_record(entry)
            self._wal_append_entry("entry", meta, blobs)
        return entry

    def _remove_entry(self, lineage_id: int) -> None:
        """Undo one :meth:`_insert_entry` (multi-entry rollback)."""
        e = self.lineage.pop(lineage_id)
        ids = self.by_pair[(e.src, e.dst)]
        ids.remove(lineage_id)
        if not ids:
            del self.by_pair[(e.src, e.dst)]
        self.graph.remove_edge(e.src, e.dst, lineage_id)
        self._dirty.discard(lineage_id)
        self._meta_dirty = True

    def drop_lineage(self, lineage_id: int) -> None:
        """Remove one lineage entry from the catalog.

        The entry leaves the graph, pair index, and op records immediately;
        its persisted blobs (if any) stay on disk until :meth:`compact`
        vacuums them — mirroring how dirty-tracked saves never delete files.
        """
        if lineage_id not in self.lineage:
            raise KeyError(f"no lineage entry {lineage_id}")
        self._remove_entry(lineage_id)
        self._persisted.pop(lineage_id, None)
        self._drop_hop_stats(lineage_id)
        self.views.on_mutation(lineage_id)
        for op in self.ops:
            if lineage_id in op.lineage_ids:
                op.lineage_ids.remove(lineage_id)
        self._wal_append_root("drop", {"id": lineage_id})

    # ------------------------------------------------------------------ #
    # Planner cost-model feedback (measured per-hop selectivities)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _hop_key(lineage_id: int, stored: str, frontier_on: str) -> str:
        return f"{lineage_id}:{stored}:{frontier_on}"

    def record_hop(
        self,
        lineage_id: int,
        stored: str,
        frontier_on: str,
        pairs: int,
        qrows: int,
    ) -> None:
        """Fold the true pair count one executed hop produced into the
        measured selectivity — an exponential moving average (each new
        measurement decays the accumulated mass by ``hop_decay``) with a
        sample cap, so the feedback tracks workload shifts instead of
        averaging over all history.  Thread-safe (parallel execution calls
        this from worker threads)."""
        if lineage_id < 0:  # view hop: the ViewManager keeps its own EMA
            return self.views.record_hop(
                lineage_id, stored, frontier_on, pairs, qrows
            )
        with self._stats_lock:
            st = self.hop_stats.setdefault(
                self._hop_key(lineage_id, stored, frontier_on), [0.0, 0.0]
            )
            st[0] = st[0] * self.hop_decay + float(pairs)
            st[1] = st[1] * self.hop_decay + float(qrows)
            if st[1] > _HOP_SAMPLE_CAP:
                scale = _HOP_SAMPLE_CAP / st[1]
                st[0] *= scale
                st[1] *= scale
            self._meta_dirty = True

    def hop_measurement(
        self, lineage_id: int, stored: str, frontier_on: str
    ) -> float | None:
        """Measured pairs-per-query-box for one hop, or None if never run."""
        if lineage_id < 0:
            return self.views.hop_measurement(lineage_id, stored, frontier_on)
        st = self.hop_stats.get(self._hop_key(lineage_id, stored, frontier_on))
        if not st or st[1] <= 0:
            return None
        return st[0] / st[1]

    def _check_shapes(self, src: str, dst: str, rel: LineageRelation) -> None:
        if src in self.arrays and self.arrays[src].shape != rel.in_shape:
            raise ValueError(
                f"array {src} declared {self.arrays[src].shape}, lineage says {rel.in_shape}"
            )
        if dst in self.arrays and self.arrays[dst].shape != rel.out_shape:
            raise ValueError(
                f"array {dst} declared {self.arrays[dst].shape}, lineage says {rel.out_shape}"
            )
        self.arrays.setdefault(src, ArrayDef(src, rel.in_shape))
        self.arrays.setdefault(dst, ArrayDef(dst, rel.out_shape))

    # ------------------------------------------------------------------ #
    # Operation registration with automatic reuse (§III.A, §VI)
    # ------------------------------------------------------------------ #
    def register_operation(
        self,
        op_name: str,
        in_arrs: list[str],
        out_arrs: list[str],
        capture: Callable[[], dict[tuple[int, int], LineageRelation]] | None = None,
        op_args: Any = None,
        reuse: bool | None = None,
    ) -> _OpRecord:
        """Register one executed operation and its lineage.

        ``capture()`` returns ``{(out_pos, in_pos): relation}``.  When reuse
        is enabled (default) and a confirmed signature mapping exists, the
        capture callable is *not* invoked — the stored tables are linked
        instead (this is the paper's capture-bypass).
        """
        in_arrs, out_arrs = tuple(in_arrs), tuple(out_arrs)
        in_shapes = tuple(self.arrays[a].shape for a in in_arrs)
        out_shapes = tuple(self.arrays[a].shape for a in out_arrs)
        dim_key = sig_key_dim(op_name, in_shapes + out_shapes, op_args)
        gen_key = sig_key_gen(op_name, op_args)
        shapes_token = in_shapes + out_shapes
        rec = _OpRecord(op_name, in_arrs, out_arrs, op_args)
        use_reuse = reuse if reuse is not None else True

        pair_shapes = {}
        for oi, oname in enumerate(out_arrs):
            for ii, iname in enumerate(in_arrs):
                pair_shapes[f"{oi}:{ii}"] = (
                    self.arrays[oname].shape,
                    self.arrays[iname].shape,
                )

        if use_reuse:
            decision = self.predictor.lookup(
                dim_key, gen_key, shapes_token, pair_shapes
            )
            if decision.reused:
                assert decision.tables is not None
                try:
                    for label, bwd in decision.tables.items():
                        oi, ii = (int(x) for x in label.split(":"))
                        entry = self._insert_entry(
                            in_arrs[ii],
                            out_arrs[oi],
                            bwd,
                            self._derive_forward(bwd)
                            if self.store_forward
                            else None,
                            op_name,
                            reused_from=decision.source,
                        )
                        rec.lineage_ids.append(entry.lineage_id)
                except CycleError:
                    self._rollback_op(rec)
                    raise
                rec.reused = decision.source
                self.ops.append(rec)
                self._wal_append_root("op", self._op_wal_meta(rec))
                return rec

        if capture is None:
            raise ValueError(
                f"no confirmed reuse mapping for {op_name} and no capture given"
            )
        with timed(self.metrics, "ingest_seconds", "capture"):
            rels = capture()
        captured_tables: dict[str, CompressedTable] = {}
        try:
            for (oi, ii), rel in rels.items():
                entry = self.add_lineage(
                    in_arrs[ii], out_arrs[oi], rel, op_name=op_name
                )
                rec.lineage_ids.append(entry.lineage_id)
                captured_tables[f"{oi}:{ii}"] = entry.backward
        except CycleError:
            self._rollback_op(rec)
            raise
        if use_reuse:
            self.predictor.observe(dim_key, gen_key, shapes_token, captured_tables)
            if self._wal is not None and not self._replaying:
                labels = sorted(captured_tables)
                self._wal_append_root(
                    "obs",
                    {
                        "dim": dim_key,
                        "gen": gen_key,
                        "shapes": [list(s) for s in shapes_token],
                        "labels": labels,
                    },
                    [self._serialize(captured_tables[label]) for label in labels],
                )
        self.ops.append(rec)
        self._wal_append_root("op", self._op_wal_meta(rec))
        return rec

    @staticmethod
    def _op_wal_meta(rec: _OpRecord) -> dict:
        return {
            "op": rec.op_name,
            "in": list(rec.in_arrs),
            "out": list(rec.out_arrs),
            "args": _json_safe(rec.op_args),
            "lids": list(rec.lineage_ids),
            "reused": rec.reused,
        }

    def _rollback_op(self, rec: _OpRecord) -> None:
        """Registration is atomic: a mid-op CycleError (one pair of a
        multi-entry op closes a cycle) must not leave the already-inserted
        sibling entries behind."""
        for lid in reversed(rec.lineage_ids):
            self._remove_entry(lid)
        rec.lineage_ids.clear()

    def _derive_forward(self, bwd: CompressedTable) -> CompressedTable | None:
        """Forward table from a reused backward table (via decompress only
        when small; otherwise serve forward queries with the inverse join)."""
        if bwd.n_rows <= 4096:
            with timed(self.metrics, "ingest_seconds", "derive_forward"):
                rel = bwd.decompress()
                return compress(rel, "forward", self.compress_method)
        return None

    # ------------------------------------------------------------------ #
    # Multi-hop queries (§V) — both forms served by the planner
    # ------------------------------------------------------------------ #
    def prov_query(
        self,
        *args,
        merge: bool = True,
        parallel: int | None = None,
        batched: bool | None = None,
        trace: bool = False,
    ) -> "QueryBox | dict | tuple":
        """Lineage between cells of two arrays.

        Two call forms::

            prov_query(path, cells)        # explicit array path (paper §V)
            prov_query(src, dst, cells)    # planner routes over the DAG

        In graph form the planner infers direction (forward when ``dst`` is
        downstream of ``src``), merges converging branches at fan-in arrays,
        and picks the cheapest stored materialization per hop.  ``dst`` may
        be a sequence of array names — the result is then a dict
        ``{name: QueryBox}``.  ``parallel=N`` executes independent plan
        branches on an N-thread pool.  ``batched`` picks the join engine
        (default ``planner.batched``): packed frontier execution through
        the :class:`~repro_torch.core.query.BatchedJoinExecutor` vs the
        per-hop join loop — results are bit-identical either way.

        ``trace=True`` returns ``(result, QueryTrace)`` instead: a span
        tree (``plan`` and ``execute`` with their instrument deltas, the
        executor's and the kernels' spans below ``execute`` — see
        :mod:`repro_torch.obs.trace` — hops, cache probe, view race) with
        per-span wall time, mirrored as ``dslog::`` ranges while
        ``torch.profiler`` records.  Tracing never changes the answer.
        """
        form = self._parse_query_args(args)
        if form[0] == "path":
            _, path, cells, m_override = form
            if m_override is not None:
                merge = m_override
            res = self.prov_query_batch(
                path,
                [cells],
                merge=merge,
                parallel=parallel,
                batched=batched,
                trace=trace,
            )
            if trace:
                res, tr = res
                return res[0], tr
            return res[0]
        _, src, dst, cells = form
        res = self.prov_query_batch(
            src,
            dst,
            [cells],
            merge=merge,
            parallel=parallel,
            batched=batched,
            trace=trace,
        )
        tr = None
        if trace:
            res, tr = res
        if isinstance(res, dict):
            res = {name: boxes[0] for name, boxes in res.items()}
        else:
            res = res[0]
        return (res, tr) if trace else res

    def prov_query_batch(
        self,
        *args,
        merge: bool = True,
        parallel: int | None = None,
        batched: bool | None = None,
        trace: bool = False,
    ) -> "list[QueryBox] | dict[str, list[QueryBox]] | tuple":
        """Answer many independent queries in one pass (both call forms).

        The plan is computed once; each hop runs through the batched θ-join
        (shared index probes, deduplicated boxes across in-flight queries).
        ``trace=True`` returns ``(result, QueryTrace)``.
        """
        tr = QueryTrace(registry=self.metrics) if trace else None
        workers = parallel if parallel is not None else 0
        use_batched = self.planner.batched if batched is None else batched
        engine = (
            "parallel"
            if workers and workers > 1
            else ("batched" if use_batched else "serial")
        )
        t0 = time.perf_counter()
        try:
            with activated(tr):
                out, path_label = self._query_batch_impl(
                    args, merge, parallel, batched, tr, engine
                )
        finally:
            if tr is not None:
                tr.finish()
        # per-path query latency: cache hit / view shortcut / full plan,
        # split by execution engine
        self.metrics.observe(
            "query_seconds", time.perf_counter() - t0, path=path_label, engine=engine
        )
        self.metrics.inc("queries", path=path_label)
        return (out, tr) if trace else out

    def _query_batch_impl(
        self, args, merge, parallel, batched, tr, engine
    ) -> tuple:
        """Body of :meth:`prov_query_batch`; returns ``(result, path)``
        where ``path`` labels how the answer was produced (``"cache"`` /
        ``"view"`` / ``"planned"`` / explicit-``"path"`` form)."""
        form = self._parse_query_args(args)
        if form[0] == "path":
            _, path, queries, m_override = form
            if m_override is not None:
                merge = m_override
            if len(path) < 2:
                raise ValueError("path needs at least two arrays")
            if not queries:
                return [], "path"
            boxes = self._as_boxes(path[0], queries)
            with maybe_span(tr, "plan", kind="plan", deltas=True, form="path") as sp:
                plan = self.planner.plan_path(path, frontier=boxes, batched=batched)
                sp.attrs["est_cost"] = round(plan.est_cost, 3)
            with maybe_span(tr, "execute", kind="execute", deltas=True, engine=engine):
                out = self.planner.execute(
                    plan, boxes, merge=merge, parallel=parallel, batched=batched
                )[path[-1]]
            return out, "path"
        _, src, dst, queries = form
        multi = not isinstance(dst, str)
        targets = list(dst) if multi else [dst]
        if not queries:
            return ({t: [] for t in targets} if multi else []), "planned"
        boxes = self._as_boxes(src, queries)
        # answer cache first, planner second: an exact repeat (same source,
        # targets, and canonicalized cell boxes) never plans at all
        ckey = self.views.cache_key(src, targets, boxes, merge)
        hit = self.views.cache_get(ckey) if ckey is not None else None
        if tr is not None:
            tr.event(
                "cache_probe",
                kind="cache",
                cacheable=ckey is not None,
                hit=hit is not None,
            )
        if hit is not None:
            return (hit if multi else hit[dst]), "cache"
        if ckey is not None:
            self.views.note_route(src, targets)
        # plans are cell-independent: a hot route replans only after an
        # invalidation, admission, or demotion changes the shortcut race
        with maybe_span(tr, "plan", kind="plan", deltas=True, form="graph") as sp:
            plan = self.views.plan_get(src, targets, batched)
            sp.attrs["memo"] = plan is not None
            if plan is None:
                plan = self.planner.plan(
                    src, targets, frontier=boxes, batched=batched
                )
                self.views.plan_put(src, targets, batched, plan)
            sp.attrs["est_cost"] = round(plan.est_cost, 3)
        path_label = (
            "view"
            if any(
                c.lineage_id < 0
                for steps in plan.steps.values()
                for step in steps
                for c in step.choices
            )
            else "planned"
        )
        with maybe_span(tr, "execute", kind="execute", deltas=True, engine=engine):
            out = self.planner.execute(
                plan, boxes, merge=merge, parallel=parallel, batched=batched
            )
        if ckey is not None:
            self.views.cache_put(ckey, out, src, targets, plan)
        return (out if multi else out[dst]), path_label

    def _as_boxes(
        self, name: str, queries: Sequence["np.ndarray | QueryBox"]
    ) -> list[QueryBox]:
        shape = self.arrays[name].shape
        return [
            q if isinstance(q, QueryBox) else QueryBox.from_cells(shape, q)
            for q in queries
        ]

    @staticmethod
    def _parse_query_args(args: tuple) -> tuple:
        """Dispatch ``(path, q)`` vs ``(src, dst, q)`` positional forms.

        The path form also takes ``merge`` as a trailing positional
        argument, ``(path, q, merge)``, as the reference does.
        """
        if len(args) == 2:
            path, q = args
            if isinstance(path, str):
                raise TypeError(
                    "prov_query(src, dst, cells) needs a dst argument; "
                    "the two-argument form takes a path list"
                )
            return ("path", list(path), q, None)
        if len(args) == 3:
            src, dst, q = args
            if not isinstance(src, str):
                if isinstance(q, (bool, np.bool_)):
                    return ("path", list(src), dst, bool(q))
                raise TypeError(
                    "graph-form prov_query takes a source array name; "
                    "for the path form pass merge as a keyword"
                )
            if not isinstance(dst, (str, list, tuple, set, frozenset)):
                raise TypeError("dst must be an array name or a sequence of names")
            return ("graph", src, dst, q)
        raise TypeError(
            f"prov_query takes (path, cells) or (src, dst, cells); got "
            f"{len(args)} positional arguments"
        )

    # ------------------------------------------------------------------ #
    # Persistence (manifest v2: lazy handles, dirty tracking, reuse state)
    # ------------------------------------------------------------------ #
    def save(self, checkpoint_wal: bool = True) -> None:
        """Write the catalog under ``root``, incrementally.

        Only entries added since the last ``save()``/``load()`` have their
        blobs (and index sidecars) written; already-persisted entries keep
        their files and manifest records verbatim — a lazily loaded entry is
        never even deserialized by a save.  The JSON manifest itself is
        always rewritten (it is small).

        With a WAL attached this is a checkpoint: the manifest records the
        log's end LSN and the log truncates afterwards.  ``checkpoint_wal=
        False`` defers the truncation (the log's records stay, and replay
        skips them through the recorded LSN).
        """
        if not self.root:
            raise ValueError("DSLog opened without a root directory")
        meta = {
            "version": _MANIFEST_VERSION,
            "arrays": {n: list(a.shape) for n, a in self.arrays.items()},
            "lineage": [],
            "next_id": self._next_id,
            "ops": [
                {
                    "op": op.op_name,
                    "in": list(op.in_arrs),
                    "out": list(op.out_arrs),
                    "args": _json_safe(op.op_args),
                    "lineage_ids": list(op.lineage_ids),
                    "reused": op.reused,
                }
                for op in self.ops
            ],
            "versions": dict(self._versions),
            "hops": {k: list(v) for k, v in self.hop_stats.items()},
            "hop_decay": self.hop_decay,
        }
        if self._wal is not None:
            # checkpoint: make every logged record durable, stamp the end
            # LSN into the manifest, and truncate the log afterwards —
            # a crash between the two replays nothing twice (LSN skip).
            self.commit()
            meta["wal_lsn"] = self._wal.end_lsn
        for e in self.lineage.values():
            rec = self._persisted.get(e.lineage_id)
            if rec is None or e.lineage_id in self._dirty:
                rec = self._write_entry(e)
                self._persisted[e.lineage_id] = rec
            meta["lineage"].append(rec)
        self._dirty.clear()

        if self._predictor_chunk is None or self.predictor.dirty:
            self._predictor_chunk = self._write_predictor()
        meta["predictor"] = self._predictor_chunk
        meta["views"] = self.views.manifest_chunk(self._write_view_blob)
        _atomic_write(
            os.path.join(self.root, "answers.json"),
            json.dumps(self.views.cache_chunk()),
        )
        _atomic_write(
            os.path.join(self.root, "autotune.json"),
            json.dumps(self.autotune.to_manifest()),
        )
        self.autotune.dirty = False
        # telemetry snapshot rides every checkpoint (write-only sidecar:
        # load() never restores it, counters restart from zero)
        _atomic_write(
            os.path.join(self.root, "telemetry.json"),
            json.dumps(telemetry_snapshot(self)),
        )

        payload = json.dumps(meta)
        _atomic_write(os.path.join(self.root, "catalog.json"), payload)
        self._bump("manifests_written")
        self._bump("bytes_written", len(payload))
        self._meta_dirty = False
        # Truncate only as the leased owner: a save() on a merely
        # load()-ed store must not cut a log a live writer may be appending
        # to — its records stay, and replay skips them via the wal_lsn just
        # recorded.
        if self._wal is not None and checkpoint_wal and self._lease is not None:
            self._wal_lsn = self._wal.checkpoint()

    def _write_entry(self, e: LineageEntry) -> dict:
        fn = f"lineage_{e.lineage_id}.prvc"
        blob = self._serialize(e.backward)
        _write_blob(os.path.join(self.root, fn), blob)
        self._bump("tables_written")
        self._bump("bytes_written", len(blob))
        rec = {
            "id": e.lineage_id,
            "src": e.src,
            "dst": e.dst,
            "file": fn,
            "op": e.op_name,
            "reused": e.reused_from,
            "rows": e.backward.n_rows,
            "fwd": None,
            "fwd_rows": None,
            "idx": self._save_index(e.backward, f"lineage_{e.lineage_id}.idx"),
            "fwd_idx": None,
        }
        if e.forward is not None:
            fwd_fn = f"lineage_{e.lineage_id}_fwd.prvc"
            blob = self._serialize(e.forward)
            _write_blob(os.path.join(self.root, fwd_fn), blob)
            self._bump("tables_written")
            self._bump("bytes_written", len(blob))
            rec["fwd"] = fwd_fn
            rec["fwd_rows"] = e.forward.n_rows
            rec["fwd_idx"] = self._save_index(
                e.forward, f"lineage_{e.lineage_id}_fwd.idx"
            )
        return rec

    def _write_view_blob(self, fn: str, table: CompressedTable) -> None:
        blob = self._serialize(table)
        _write_blob(os.path.join(self.root, fn), blob)
        self._bump("tables_written")
        self._bump("bytes_written", len(blob))

    def _view_lsns(self) -> dict[str, int]:
        """End LSN of every WAL a view's route could be invalidated
        through — for a single store, just its own log."""
        return {"": self._wal.end_lsn if self._wal is not None else 0}

    def _write_predictor(self) -> dict:
        assert self.root is not None
        root = self.root

        def save_table(key: str, label: str, tbl: CompressedTable) -> str:
            fn = _sig_blob_name(key, label)
            blob = self._serialize(tbl)
            _write_blob(os.path.join(root, fn), blob)
            self._bump("sig_tables_written")
            self._bump("bytes_written", len(blob))
            return fn

        return self.predictor.state_manifest(save_table)

    def _save_index(self, table: CompressedTable, fn: str) -> str | None:
        """Persist the key index next to its table: already-built indexes are
        always written; large tables get one built eagerly so reloads start
        warm.  Small, index-less tables write nothing (dense is fine)."""
        assert self.root is not None
        cached = table.cached_key_index()
        if cached is None and table.n_rows < _INDEX_PERSIST_MIN_ROWS:
            return None
        idx = cached if cached is not None else table.key_index()
        blob = idx.to_bytes()
        _write_blob(os.path.join(self.root, fn), blob)
        self._bump("bytes_written", len(blob))
        return fn

    @staticmethod
    def _load_index(root: str, fn: str | None, table: CompressedTable) -> None:
        if not fn:
            return
        path = os.path.join(root, fn)
        if not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                table.attach_key_index(
                    IntervalIndex.from_bytes(f.read(), table.key_lo, table.key_hi)
                )
        except ValueError:
            pass  # stale sidecar: fall back to lazy rebuild

    def _make_handle(self, fn: str, idx_fn: str | None, rows) -> TableHandle:
        assert self.root is not None
        root = self.root

        def load() -> CompressedTable:
            with open(os.path.join(root, fn), "rb") as f:
                t = CompressedTable.deserialize(f.read())
            DSLog._load_index(root, idx_fn, t)
            return t

        def on_load() -> None:
            # fired from TableHandle.get under arbitrary threads (parallel
            # plan execution) — must take the stats lock like every meter
            self._bump("tables_loaded")

        return TableHandle(load, None if rows is None else int(rows), on_load)

    @staticmethod
    def load(root: str, device="cuda") -> "DSLog":
        """Reopen a catalog without deserializing any table blob.

        Arrays, the lineage DAG, op records, and the reuse-predictor state
        load eagerly (they are small JSON plus the few signature tables);
        every lineage table becomes a lazy handle that resolves on first
        touch — ``io_stats["tables_loaded"]`` counts those resolutions.
        Manifests from v1 (pre-graph) load too; they simply have no ops or
        predictor state to restore.

        **Crash recovery** happens here: when a write-ahead log is present
        (the store was opened with :meth:`open`), its tail past the
        manifest's checkpoint LSN is replayed — torn trailing records
        truncated — so a store whose writer died mid-ingest reopens equal
        to a synchronous-save oracle of every durably logged mutation.  A
        crash *before the first checkpoint* leaves a WAL with no manifest
        at all; that loads too, from an empty catalog plus replay.
        ``device`` is the store's (see the class doc).
        """
        log = DSLog(root=root, device=device)
        manifest = os.path.join(root, "catalog.json")
        if not os.path.exists(manifest) and os.path.exists(
            os.path.join(root, WAL_FILENAME)
        ):
            log._attach_wal()
            return log
        with open(manifest) as f:
            meta = json.load(f)
        if meta.get("sharded"):
            raise ValueError(
                f"{root!r} holds a sharded catalog root; open it with "
                "repro_torch.core.shard.ShardedDSLog.load"
            )
        version = int(meta.get("version", 1))
        for n, shp in meta["arrays"].items():
            log.define_array(n, tuple(shp))
        for rec in meta["lineage"]:
            bwd = log._make_handle(rec["file"], rec.get("idx"), rec.get("rows"))
            fwd = None
            if rec["fwd"]:
                fwd = log._make_handle(
                    rec["fwd"], rec.get("fwd_idx"), rec.get("fwd_rows")
                )
            e = LineageEntry(
                rec["id"], rec["src"], rec["dst"], bwd, fwd, rec["op"], rec["reused"]
            )
            log.lineage[e.lineage_id] = e
            log.by_pair.setdefault((e.src, e.dst), []).append(e.lineage_id)
            log._persisted[e.lineage_id] = rec
        log.graph = LineageGraph.from_pairs(log.by_pair)
        log._next_id = meta["next_id"]
        if version >= 2:
            for op in meta.get("ops", []):
                log.ops.append(
                    _OpRecord(
                        op["op"],
                        tuple(op["in"]),
                        tuple(op["out"]),
                        op["args"],
                        list(op["lineage_ids"]),
                        op["reused"],
                    )
                )
            chunk = meta.get("predictor")
            if chunk is not None:

                def load_table(fn: str) -> CompressedTable:
                    with open(os.path.join(root, fn), "rb") as f:
                        return CompressedTable.deserialize(f.read())

                log.predictor = ReusePredictor.from_manifest(chunk, load_table)
                log._predictor_chunk = chunk
        log._versions = {
            k: int(v) for k, v in meta.get("versions", {}).items()
        }
        with log._stats_lock:
            log.hop_stats.update(
                {k: [float(x) for x in v] for k, v in meta.get("hops", {}).items()}
            )
        log.hop_decay = float(meta.get("hop_decay", log.hop_decay))
        log._meta_dirty = False
        log._wal_lsn = int(meta.get("wal_lsn", 0))
        # views + cached answers restore BEFORE WAL replay: replayed
        # entry/drop/dirty records then fire the same precise invalidation
        # they did live, so nothing stale survives recovery
        log.views.load_chunk(
            meta.get("views"),
            lambda fn, rows: log._make_handle(fn, None, rows),
        )
        answers = os.path.join(root, "answers.json")
        if os.path.exists(answers):
            try:
                with open(answers) as f:
                    log.views.load_cache_chunk(json.load(f))
            except (ValueError, KeyError):
                pass  # torn/stale sidecar: start with a cold cache
        autotune = os.path.join(root, "autotune.json")
        if os.path.exists(autotune):
            try:
                with open(autotune) as f:
                    log.autotune.load_manifest(json.load(f))
            except ValueError:
                pass  # torn sidecar: start with a cold geometry table
        if os.path.exists(os.path.join(root, WAL_FILENAME)):
            log._attach_wal()
        return log

    # ------------------------------------------------------------------ #
    # Garbage collection (persistence v2 vacuum)
    # ------------------------------------------------------------------ #
    def compact(self, save: bool = True) -> dict[str, int]:
        """Vacuum blobs no longer referenced by the catalog.

        Dirty-tracked saves never delete files, so dropped entries
        (:meth:`drop_lineage`) and re-saved/rejected predictor signatures
        leave stale ``lineage_*.prvc``/``.idx`` and ``sig_*.prvc`` blobs
        behind.  ``compact()`` saves first (unless ``save=False``, for
        callers that just synced), then deletes every catalog-owned file the
        current manifest does not reference.  Returns
        ``{"files_removed": n, "bytes_reclaimed": b}``.
        """
        if not self.root:
            raise ValueError("DSLog opened without a root directory")
        if save:
            self.save()
        for lid in list(self._persisted):
            if lid not in self.lineage:
                del self._persisted[lid]
        referenced = manifest_referenced_files(
            self._persisted.values(), self._predictor_chunk
        )
        referenced |= self.views.blob_files()
        return _vacuum_dir(self.root, referenced)

    # ------------------------------------------------------------------ #
    def storage_bytes(self) -> int:
        """Packed size of every stored table (forces lazy blobs to load)."""
        total = 0
        for e in self.lineage.values():
            total += e.backward.nbytes()
            if e.forward is not None:
                total += e.forward.nbytes()
        return total
