"""Write-ahead lineage log: append-only, checksummed, torn-tail tolerant.

The port of ``repro.core.wal``: the same on-disk bytes for the same record
stream, so either package replays the other's log.

One :class:`WriteAheadLog` backs one store directory (`wal.log`); a sharded
store keeps one per shard plus a root log.  The catalog appends a record
for every durable mutation — lineage entries (with their serialized
tables), op registrations, version mints, predictor observations, explicit
``mark_dirty`` invalidations, and drops — *before* the mutation is
reflected in any manifest.  Durability then costs one buffered ``write``
per record plus an fsync amortized by the
:class:`~repro_torch.core.commit.CommitPipeline`'s group commit, instead of a
full manifest rewrite per entry.

On-disk format
--------------
::

    header:  b"DSWAL1\\n" | u64 base_lsn
    record:  u32 payload_len | u32 crc32(payload) | payload
    payload: u32 json_len | json meta (incl. "t" type, "nb" blob lengths)
             | blob_0 | blob_1 | ...

LSNs are byte offsets relative to the log's creation: ``base_lsn`` + file
offset.  A **checkpoint** (the catalog's incremental ``save()``) records
the current end LSN in the manifest and truncates the log back to a bare
header whose ``base_lsn`` is that end LSN — so LSNs stay monotonic across
truncations, and recovery can tell already-checkpointed records (LSN below
the manifest's ``wal_lsn``) from the tail that must be replayed.

Recovery (:meth:`WriteAheadLog.recover`) scans records sequentially and
stops at the first torn one — a short header, a short payload, or a crc
mismatch — truncating the file back to the last intact record boundary.
Every complete record before the tear survives; this is the prefix the
crash-recovery property test compares against the synchronous-save oracle.

Shared mode
-----------
``shared=True`` turns the log into a multi-writer append channel (the
sharded store's root log under concurrent non-exclusive writers): appends
buffer in memory and each flush takes an exclusive ``flock``, seeks to the
true end, writes the batch, fsyncs, and releases — so records from
concurrent writer processes interleave at record granularity, never
mid-record.  Shared logs are only truncated by an exclusive checkpoint.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Iterator

from repro_torch.obs.metrics import MetricsRegistry, StatsView

from . import _locks

try:  # POSIX advisory locks for shared-mode appends
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None  # type: ignore[assignment]

__all__ = ["WalRecord", "WriteAheadLog", "WAL_FILENAME"]

WAL_FILENAME = "wal.log"

_MAGIC = b"DSWAL1\n"
_HEADER_SIZE = len(_MAGIC) + 8  # magic + u64 base_lsn
_REC_HEADER = struct.Struct("<II")  # payload_len, crc32


class WalRecord:
    """One decoded log record: a type tag, JSON-safe meta, binary blobs."""

    __slots__ = ("type", "meta", "blobs", "lsn")

    def __init__(self, rtype: str, meta: dict, blobs: list[bytes], lsn: int = 0):
        self.type = rtype
        self.meta = meta
        self.blobs = blobs
        self.lsn = lsn  # end LSN: the record is durable iff lsn <= flushed end

    def __repr__(self) -> str:
        return (
            f"WalRecord({self.type!r}, lsn={self.lsn}, "
            f"blobs={[len(b) for b in self.blobs]})"
        )


def _encode(rtype: str, meta: dict, blobs: list[bytes]) -> bytes:
    head = dict(meta)
    head["t"] = rtype
    head["nb"] = [len(b) for b in blobs]
    j = json.dumps(head).encode()
    payload = struct.pack("<I", len(j)) + j + b"".join(blobs)
    return _REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes) -> WalRecord:
    (jlen,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4 : 4 + jlen])
    rtype = head.pop("t")
    sizes = head.pop("nb")
    blobs = []
    off = 4 + jlen
    for n in sizes:
        blobs.append(payload[off : off + n])
        off += n
    return WalRecord(rtype, head, blobs)


class WriteAheadLog:
    """Append-only record log over one file, with torn-tail recovery.

    Exclusive mode (default) keeps the file handle open and tracks the end
    offset in memory; shared mode buffers appends and writes them under an
    ``flock`` so several processes can interleave whole records.
    """

    def __init__(self, path: str, shared: bool = False, metrics=None):
        self.path = path
        self.shared = bool(shared)
        self._lock = _locks.new_lock("wal._lock")
        self._pending: list[bytes] = []  # shared mode: unwritten records
        self._f = None
        self._end = _HEADER_SIZE  # exclusive mode: current file offset
        self._shared_good = _HEADER_SIZE  # shared mode: verified boundary
        self.base_lsn = 0
        # meters live in the (internally locked) registry — the owning
        # store's when attached, a private one for standalone logs; the
        # legacy ``wal.stats["records"]`` read surface is an alias view.
        if metrics is None:
            metrics = MetricsRegistry("wal")
        self.metrics = metrics
        metrics.seed_counters(
            ("wal_records", "wal_flushes", "wal_syncs", "wal_bytes")
        )
        self.stats = StatsView(
            metrics,
            {
                "records": "wal_records",
                "flushes": "wal_flushes",
                "syncs": "wal_syncs",
                "bytes": "wal_bytes",
            },
        )
        self._open()

    # ------------------------------------------------------------------ #
    def _open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        exists = os.path.exists(self.path)
        self._f = open(self.path, "r+b" if exists else "w+b")
        if self.shared:
            def init_shared():
                self._ensure_header()
                # last verified intact boundary; each flush re-verifies
                # only the records other writers appended since
                self._shared_good = self._boundary_from(_HEADER_SIZE)

            self._flocked(init_shared)
        else:
            self._ensure_header()
            # position appends at the last *intact* record boundary, never
            # blind EOF: after a torn write, new records overwrite the torn
            # bytes instead of being stranded behind them
            self._scan(2**62, [], truncate=False)

    def _ensure_header(self) -> None:
        self._f.seek(0, os.SEEK_END)
        if self._f.tell() < _HEADER_SIZE:
            self._f.seek(0)
            self._f.write(_MAGIC + struct.pack("<Q", 0))
            self._f.flush()
            self.base_lsn = 0
        else:
            self._f.seek(0)
            magic = self._f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{self.path!r} is not a DSLog WAL")
            (self.base_lsn,) = struct.unpack("<Q", self._f.read(8))

    def _boundary_from(self, start: int) -> int:
        """Offset of the last intact record boundary at or after ``start``
        (call with the file/flock held as appropriate)."""
        self._f.seek(start)
        good = start
        while True:
            hdr = self._f.read(_REC_HEADER.size)
            if len(hdr) < _REC_HEADER.size:
                return good
            plen, crc = _REC_HEADER.unpack(hdr)
            payload = self._f.read(plen)
            if len(payload) < plen or zlib.crc32(payload) != crc:
                return good
            good += _REC_HEADER.size + plen

    def _flocked(self, fn):
        if fcntl is not None:
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
        try:
            return fn()
        finally:
            if fcntl is not None:
                fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)

    # ------------------------------------------------------------------ #
    @property
    def end_lsn(self) -> int:
        """LSN one past the last appended record (pending included)."""
        if self.shared:
            size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
            size = max(size, _HEADER_SIZE)
            return self.base_lsn + (size - _HEADER_SIZE) + sum(
                len(b) for b in self._pending
            )
        return self.base_lsn + (self._end - _HEADER_SIZE)

    @staticmethod
    def file_has_records(path: str) -> bool:
        """Whether a log file on disk holds any record bytes past its
        header (cheap stat — no open, no scan)."""
        try:
            return os.path.getsize(path) > _HEADER_SIZE
        except OSError:
            return False

    @staticmethod
    def file_end_lsn(path: str) -> int:
        """End LSN of a log file on disk without opening it as a live log.

        Read-only frame scan up to the last intact record boundary (a torn
        tail contributes nothing — recovery would discard it too).  Returns
        ``0`` for a missing or non-WAL file.  Used by stale-view checks
        that need a shard's LSN horizon without loading the shard.
        """
        try:
            with open(path, "rb") as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    return 0
                raw = f.read(8)
                if len(raw) < 8:
                    return 0
                (base,) = struct.unpack("<Q", raw)
                good = _HEADER_SIZE
                while True:
                    hdr = f.read(_REC_HEADER.size)
                    if len(hdr) < _REC_HEADER.size:
                        break
                    plen, crc = _REC_HEADER.unpack(hdr)
                    payload = f.read(plen)
                    if len(payload) < plen or zlib.crc32(payload) != crc:
                        break
                    good += _REC_HEADER.size + plen
                return base + (good - _HEADER_SIZE)
        except OSError:
            return 0

    @property
    def has_records(self) -> bool:
        if self._pending:
            return True
        if self.shared:
            return os.path.getsize(self.path) > _HEADER_SIZE
        return self._end > _HEADER_SIZE

    # ------------------------------------------------------------------ #
    def append(self, rtype: str, meta: dict, blobs: list[bytes] | tuple = ()) -> int:
        """Buffer one record; returns its end LSN.

        In shared mode the return value is ``-1``: concurrent writers move
        the true end, which is only pinned down at flush (computing it here
        would cost a stat syscall per record on the ingest hot path)."""
        data = _encode(rtype, meta, list(blobs))
        with self._lock:
            if self.shared:
                self._pending.append(data)
                lsn = -1
            else:
                self._f.seek(self._end)
                self._f.write(data)
                self._end += len(data)
                lsn = self.base_lsn + (self._end - _HEADER_SIZE)
            self.metrics.inc("wal_records")
            self.metrics.inc("wal_bytes", len(data))
            return lsn

    def flush(self, sync: bool = True) -> None:
        """Push buffered records to the OS (and optionally to disk).

        The fsync happens *outside* the append lock: a concurrent writer
        keeps appending (into the next batch) while this batch hardens —
        the property that makes group commit actually overlap ingest with
        disk latency instead of serializing behind it.
        """
        with self._lock:
            if self.shared and self._pending:
                batch, self._pending = self._pending, []

                def write_batch():
                    # append at the last *intact* record boundary, not
                    # blind EOF: a crashed writer's torn tail gets
                    # overwritten instead of stranding our fsynced records
                    # behind it (where the next exclusive repair() would
                    # discard them).  Only bytes appended since our last
                    # verification are re-scanned.
                    good = self._boundary_from(self._shared_good)
                    self._f.seek(good)
                    for data in batch:
                        self._f.write(data)
                    self._f.flush()
                    end = self._f.tell()
                    if end < os.path.getsize(self.path):
                        self._f.truncate(end)  # shrank past a long tear
                    self._shared_good = end

                # shared-mode appends MUST flock under wal._lock: the
                # flock serialises against *other processes* on the root
                # log, and releasing our own lock first would let a second
                # thread interleave a batch between boundary verification
                # and the write
                self._flocked(write_batch)  # dsflow: ignore[lock-fsync]
            else:
                self._f.flush()
            fd = self._f.fileno()
        self.metrics.inc("wal_flushes")
        if sync:
            t0 = time.perf_counter()
            os.fsync(fd)
            self.metrics.inc("wal_syncs")
            self.metrics.observe("wal_fsync_seconds", time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    def recover(self, min_lsn: int = 0, truncate: bool = False) -> list[WalRecord]:
        """Scan the log and return intact records whose end LSN is past
        ``min_lsn`` (the manifest's checkpoint LSN).

        Safe on a freshly created log (returns ``[]``).  The tear point is
        the first record with a short header, short payload, or crc
        mismatch; everything after it is ignored.  With ``truncate=True``
        the file is also cut back to the last intact boundary — pass that
        ONLY while holding the store's writer lease: a plain read-only
        ``load()`` must never mutate a log a live writer may be appending
        to (its in-flight record looks exactly like a torn tail).
        Exclusive-mode appends overwrite the torn region regardless (the
        write offset rewinds to the last intact boundary); physical
        truncation matters for the *shared* root log, whose appends seek to
        the file end.
        """
        out: list[WalRecord] = []
        with self._lock:
            if self.shared:
                # the scan must not race a concurrent appender in another
                # process; flock under wal._lock is the point of shared
                # mode (cold path: runs once per open, not per query)
                # dsflow: ignore[lock-fsync]
                return self._flocked(lambda: self._scan(min_lsn, out, truncate))
            return self._scan(min_lsn, out, truncate)

    def repair(self) -> None:
        """Truncate any torn tail (call only as the leased/exclusive owner)."""
        self.recover(min_lsn=2**62, truncate=True)

    def _scan(
        self, min_lsn: int, out: list[WalRecord], truncate: bool
    ) -> list[WalRecord]:
            self._f.flush()
            size = os.path.getsize(self.path)
            self._f.seek(_HEADER_SIZE)
            off = _HEADER_SIZE
            good = off
            while True:
                hdr = self._f.read(_REC_HEADER.size)
                if len(hdr) < _REC_HEADER.size:
                    break
                plen, crc = _REC_HEADER.unpack(hdr)
                payload = self._f.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    break
                off += _REC_HEADER.size + plen
                good = off
                lsn = self.base_lsn + (good - _HEADER_SIZE)
                if lsn > min_lsn:
                    rec = _decode_payload(payload)
                    rec.lsn = lsn
                    out.append(rec)
            if truncate and good < size:  # torn tail: drop it
                self._f.truncate(good)
                self._f.flush()
            if not self.shared:
                # exclusive appends resume at the last intact boundary, so
                # torn bytes are overwritten even without truncation
                self._end = good
            return out

    def replay(self, min_lsn: int = 0) -> Iterator[WalRecord]:
        """Iterate intact records past ``min_lsn`` without truncating."""
        return iter(self.recover(min_lsn))

    # ------------------------------------------------------------------ #
    def checkpoint(self) -> int:
        """Truncate the log after its contents reached the manifest.

        Resets the file to a bare header whose ``base_lsn`` is the old end
        LSN, keeping LSNs monotonic.  Returns the new base LSN.  Never call
        this on a shared log unless the caller holds exclusive ownership
        (the sharded store's exclusive-mode checkpoint).
        """
        with self._lock:
            end = self.base_lsn + (
                (os.path.getsize(self.path) if self.shared else self._end)
                - _HEADER_SIZE
            )
            self._pending.clear()
            self._f.seek(0)
            self._f.write(_MAGIC + struct.pack("<Q", end))
            self._f.truncate(_HEADER_SIZE)
            self._f.flush()
            # the truncation and its fsync must be atomic w.r.t. appenders
            # on this log: releasing wal._lock between them could fsync a
            # header an interleaved append already grew past (cold path)
            os.fsync(self._f.fileno())  # dsflow: ignore[lock-fsync]
            self.base_lsn = end
            self._end = _HEADER_SIZE
            self._shared_good = _HEADER_SIZE
            return end

    def close(self) -> None:
        if self._f is not None:
            try:
                self.flush(sync=False)
            except ValueError:  # already closed underneath us
                pass
            self._f.close()
            self._f = None

    def __repr__(self) -> str:
        mode = "shared" if self.shared else "exclusive"
        return f"WriteAheadLog({self.path!r}, {mode}, end_lsn={self.end_lsn})"
