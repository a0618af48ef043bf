"""Group commit and writer leases for the write-ahead lineage log.

The port of ``repro.core.commit``.  The lease file (``writer.lock``) is
the reference's, so a writer from either package blocks an ``open`` of the
same directory from the other.

Two pieces sit between the catalog and :mod:`~repro_torch.core.wal`:

* :class:`CommitPipeline` — batches WAL durability.  Appends are buffered
  writes; the pipeline decides *when* the expensive ``fsync`` happens:

  - ``"sync"``     — every record is fsynced immediately (the per-entry
    synchronous baseline of the ingest ablation),
  - ``"group"``    — records accumulate and one fsync covers the whole
    batch, fired when ``max_batch`` records are pending or ``flush_interval``
    seconds elapse (a lazily started background flusher), whichever first,
  - ``"manual"``   — durability only at explicit :meth:`commit` /
    checkpoint (useful for tests and bulk loads).

  ``commit()`` is the durability barrier: it returns once every record
  appended so far is on disk.

* :class:`WriterLease` — one-writer-per-directory mutual exclusion via an
  atomically created lock file recording ``{pid, host, uuid}``.  A second
  acquire raises :class:`LeaseHeldError` while the holder is alive and
  steals the lease when the holding process is gone (crashed writers never
  wedge the store).  The sharded store hands out one lease per shard plus a
  root lock, so one writer *per shard* can ingest concurrently.

Leases are same-host advisory locks (pid liveness + lock-file atomicity),
matching the repo's single-node store layout; a multi-node deployment would
swap this class for a distributed lock without touching the catalog.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid

from repro_torch.obs.metrics import MetricsRegistry, StatsView

from . import _locks
from .wal import WriteAheadLog

__all__ = ["CommitPipeline", "WriterLease", "LeaseHeldError"]


class LeaseHeldError(RuntimeError):
    """Another live writer holds the lease (double-open is an error)."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, owned by another uid
        return True
    return True


class WriterLease:
    """Exclusive writer lock over one store (or shard) directory.

    The lock file is created with ``O_CREAT | O_EXCL`` (atomic on POSIX);
    its JSON body names the holder.  Staleness: a same-host lease whose pid
    is dead is stolen; a different-host lease falls back to ``ttl`` seconds
    since the last :meth:`refresh` (mtime).
    """

    FILENAME = "writer.lock"

    def __init__(self, path: str, owner: dict, token: str):
        self.path = path
        self.owner = owner
        self.token = token
        self._released = False

    # ------------------------------------------------------------------ #
    @classmethod
    def acquire(
        cls, directory: str, ttl: float = 300.0, what: str = "store"
    ) -> "WriterLease":
        """Take the directory's writer lease or raise :class:`LeaseHeldError`."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, cls.FILENAME)
        token = uuid.uuid4().hex
        owner = {"pid": os.getpid(), "host": socket.gethostname(), "token": token}
        body = json.dumps(owner).encode()
        for _ in range(2):  # second pass after stealing a stale lease
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                holder = cls._read_holder(path)
                if holder is not None and not cls._is_stale(path, holder, ttl):
                    raise LeaseHeldError(
                        f"{what} {directory!r} already has a live writer "
                        f"(pid {holder.get('pid')} on {holder.get('host')}); "
                        f"close it before opening another"
                    )
                # Stale (crashed writer / unreadable file): steal by atomic
                # rename to a name only we know — two concurrent stealers
                # cannot both succeed, and neither can delete a lease a
                # third process just acquired (plain remove would).
                grave = f"{path}.stale.{token}"
                try:
                    os.rename(path, grave)
                    os.remove(grave)
                except FileNotFoundError:
                    pass  # another stealer won the rename; retry the create
                continue
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            return cls(path, owner, token)
        raise LeaseHeldError(f"could not acquire writer lease in {directory!r}")

    @staticmethod
    def holder(directory: str) -> dict | None:
        """The recorded holder of a directory's lease file, or None."""
        return WriterLease._read_holder(
            os.path.join(directory, WriterLease.FILENAME)
        )

    @classmethod
    def held(cls, directory: str, ttl: float = 300.0) -> bool:
        """Whether a *live* writer currently holds the directory's lease."""
        path = os.path.join(directory, cls.FILENAME)
        holder = cls._read_holder(path)
        return holder is not None and not cls._is_stale(path, holder, ttl)

    @staticmethod
    def _read_holder(path: str) -> dict | None:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError):
            return {}  # unreadable body: decided by staleness below

    @staticmethod
    def _is_stale(path: str, holder: dict, ttl: float) -> bool:
        if holder.get("host") == socket.gethostname() and "pid" in holder:
            return not _pid_alive(int(holder["pid"]))
        try:
            return time.time() - os.path.getmtime(path) > ttl
        except OSError:
            return True

    # ------------------------------------------------------------------ #
    def refresh(self) -> None:
        """Bump the lease mtime (cross-host ttl keep-alive)."""
        try:
            os.utime(self.path)
        except OSError:  # pragma: no cover - lease dir vanished
            pass

    def release(self) -> None:
        """Drop the lease if we still hold it (idempotent)."""
        if self._released:
            return
        self._released = True
        holder = self._read_holder(self.path)
        if holder and holder.get("token") == self.token:
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass

    def __enter__(self) -> "WriterLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class CommitPipeline:
    """Schedules WAL fsyncs: per-record, per-batch (group commit), or manual.

    One pipeline serves every log of one store (the root log plus any shard
    logs): a single flush pass makes all of them durable together, so a
    batch spanning shards costs one fsync per *touched* log, not per
    record.  The background flusher thread starts lazily on the first
    grouped append and stops at :meth:`close`.
    """

    def __init__(
        self,
        mode: str = "group",
        flush_interval: float = 0.005,
        max_batch: int = 256,
        metrics=None,
    ):
        if mode not in ("sync", "group", "manual"):
            raise ValueError(f"unknown durability mode {mode!r}")
        self.mode = mode
        self.flush_interval = float(flush_interval)
        self.max_batch = int(max_batch)
        self._wals: list[WriteAheadLog] = []
        self._dirty: set[int] = set()  # indexes into _wals with pending bytes
        self._pending = 0
        self._lock = _locks.new_lock("commit._lock")
        # serializes whole flush passes: commit() must wait out a flush the
        # background thread already snapshotted (its fsync may still be in
        # flight after _dirty was cleared) before honoring the barrier
        self._flush_mutex = _locks.new_lock("commit._flush_mutex")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.metrics = None
        self.stats = None
        self.bind_metrics(metrics or MetricsRegistry("commit"))

    # ------------------------------------------------------------------ #
    def bind_metrics(self, registry) -> None:
        """(Re)target the pipeline's instruments at ``registry``.

        Both ``open()`` paths build the pipeline before the store object
        exists, so the store registry is bound post-hoc; counts recorded
        under the interim private registry carry over.
        """
        registry.seed_counters(
            ("commit_records", "commit_group_flushes", "commit_synced_records")
        )
        if self.metrics is not None and self.metrics is not registry:
            for key, val in self.metrics.counters_flat().items():
                if val:
                    registry.inc(key, val)
        self.metrics = registry
        self.stats = StatsView(
            registry,
            {
                "records": "commit_records",
                "group_flushes": "commit_group_flushes",
                "synced_records": "commit_synced_records",
            },
        )

    def attach(self, wal: WriteAheadLog) -> WriteAheadLog:
        with self._lock:
            if wal not in self._wals:
                self._wals.append(wal)
        return wal

    def notify(self, wal: WriteAheadLog) -> None:
        """One record was appended to ``wal``; schedule its durability."""
        with self._lock:
            if wal not in self._wals:
                self._wals.append(wal)
            self._dirty.add(self._wals.index(wal))
            self._pending += 1
            pending = self._pending
        self.metrics.inc("commit_records")
        if self.mode == "sync":
            self._flush_dirty()
        elif self.mode == "group":
            if pending >= self.max_batch:
                self._flush_dirty()
            else:
                self._ensure_thread()
                self._wake.set()

    def commit(self) -> None:
        """Durability barrier: every appended record is on disk on return."""
        self._flush_dirty(force=True)

    # ------------------------------------------------------------------ #
    def _flush_dirty(self, force: bool = False) -> None:
        # every append reaches us through notify(), so _dirty names exactly
        # the logs with unsynced records — the barrier never has to fsync a
        # clean log (force only means "flush even a below-batch remainder").
        # _flush_mutex makes the pass atomic from a barrier's perspective:
        # a commit() arriving while the background flusher is mid-fsync
        # (dirty set already cleared) blocks here until that fsync lands.
        with self._flush_mutex:
            with self._lock:
                if not self._dirty and not force:
                    return
                targets = [self._wals[i] for i in sorted(self._dirty)]
                flushed = self._pending
                self._dirty.clear()
                self._pending = 0
            for wal in targets:
                t0 = time.perf_counter()
                wal.flush(sync=True)
                # group-commit visibility latency: one sample per touched
                # log per pass (the WAL itself meters the raw fsync)
                self.metrics.observe(
                    "commit_flush_seconds", time.perf_counter() - t0
                )
            if flushed:
                self.metrics.inc("commit_group_flushes")
                self.metrics.inc("commit_synced_records", flushed)
                self.metrics.observe("commit_batch_records", float(flushed))

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="dslog-group-commit", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            # collect a batch window, then flush whatever accumulated
            self._stop.wait(self.flush_interval)
            self._flush_dirty()

    def close(self) -> None:
        """Flush everything and stop the flusher (idempotent)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._flush_dirty(force=True)

    def __repr__(self) -> str:
        return (
            f"CommitPipeline(mode={self.mode!r}, "
            f"interval={self.flush_interval}, max_batch={self.max_batch}, "
            f"records={self.stats['records']})"
        )
