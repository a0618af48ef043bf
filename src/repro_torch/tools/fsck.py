"""``fsck`` — deep on-disk verifier for DSLog stores (layer 3).

The port of ``repro.tools.fsck``: the same checks, findings and exit codes
on the same store layout (either package's stores).  It reads files only
and needs no device.

Usage::

    python -m repro_torch.tools.fsck <store-root> [--json]

Opens nothing for writing and never mutates the store: every check reads
raw bytes (WAL scanning reimplemented read-only here rather than through
``WriteAheadLog``, whose constructor opens the file ``r+``).  Checks:

* **manifest ↔ blob closure** — every ``TableHandle`` the manifest would
  mint resolves to a decodable blob (no dangling handles), and no
  catalog-owned ``lineage_*``/``sig_*``/``.idx`` file is orphaned.  The
  closure comes from ``repro_torch.core.catalog.manifest_referenced_files``
  — the exact helper ``compact()``'s vacuum uses, so GC and verification
  cannot disagree.
* **WAL integrity** — header magic, ``base_lsn`` ≤ the manifest's
  checkpoint LSN, per-record crc32.  A file that simply ends mid-record is
  an honest torn tail (warning: recovery truncates it); a crc mismatch
  with intact records *after* it is mid-log corruption (error: those
  records would be silently discarded).
* **DAG acyclicity** and, on sharded roots, **shard-map agreement**: every
  edge's recorded shard matches its dst array's shard, boundary records
  match a recomputation from the edge list, and each edge's entry exists in
  the owning shard (unless that shard still has WAL records pending —
  legitimate after a crash between shard save and root save).
* **interval invariants** — each blob's ``lo ≤ hi`` per attribute,
  ``val_ref`` within the key arity, row counts equal to the manifest's.
* **materialized views** — every view blob decodes, every lineage id on a
  view's route still exists, and no WAL holds an invalidation the view
  predates: a ``dirty``/``drop`` record for an id on the route, or an
  ``entry`` record landing inside the route (an endpoint upstream of the
  view's source and one downstream of its target), with an LSN past the
  view's recorded horizon for that log, makes the view **stale** (error —
  its rows no longer describe the store).  The answer-cache sidecar
  (``answers.json``) must parse; a torn sidecar is a warning (reopen
  starts cold).
* **lease / writer-slot liveness** — stale ``writer.lock`` files and
  writer-presence slots left by dead processes (warning).

Severities: ``error`` (store integrity violated), ``warn`` (legitimate
crash debris / GC backlog), ``info``.  Exit codes: **0** no errors (warns
allowed — a crashed-but-recoverable store passes), **1** at least one
error, **2** usage error / path is not a store.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import zlib
from dataclasses import dataclass

from repro_torch.core.catalog import is_catalog_blob, manifest_referenced_files
from repro_torch.core.commit import WriterLease, _pid_alive
from repro_torch.core.table import CompressedTable
from repro_torch.core.wal import _HEADER_SIZE, _MAGIC, _REC_HEADER, WAL_FILENAME

# how far past a bad record we look for intact records that would be lost
_RESYNC_SCAN_CAP = 4 << 20


@dataclass
class Finding:
    severity: str  # "error" | "warn" | "info"
    category: str
    path: str
    detail: str

    def __str__(self) -> str:
        return f"{self.severity}: [{self.category}] {self.path}: {self.detail}"


class Report:
    def __init__(self, root: str):
        self.root = root
        self.findings: list[Finding] = []
        self.checked: dict[str, int] = {
            "blobs": 0,
            "wal_records": 0,
            "entries": 0,
            "shards": 0,
            "views": 0,
        }

    def add(self, severity: str, category: str, path: str, detail: str) -> None:
        self.findings.append(Finding(severity, category, path, detail))

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    def categories(self) -> set[str]:
        return {f.category for f in self.findings}

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> dict:
        # findings use the shared analysis-tool schema (tools/findings.py):
        # the rule is the fsck category, the message its detail, and line is
        # 0 — findings are about on-disk store objects, not source lines
        from .findings import finding_dict

        return {
            "root": self.root,
            "ok": self.ok,
            "checked": dict(self.checked),
            "findings": [
                finding_dict(
                    "fsck", f.category, f.severity, f.path, 0, f.detail
                )
                for f in self.findings
            ],
        }


# --------------------------------------------------------------------------
# WAL scanning (read-only reimplementation of the record framing)
# --------------------------------------------------------------------------


def _check_wal(report: Report, path: str, manifest_lsn: int | None) -> None:
    rel = os.path.relpath(path, report.root)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        report.add("error", "wal-header", rel, f"unreadable: {exc}")
        return
    if len(data) < _HEADER_SIZE:
        # an honest crash can tear the header of a just-created log;
        # recovery rewrites it, losing nothing that was ever acknowledged
        report.add("warn", "wal-header", rel, f"short header ({len(data)} bytes)")
        return
    if data[: len(_MAGIC)] != _MAGIC:
        report.add("error", "wal-header", rel, "bad magic")
        return
    (base_lsn,) = struct.unpack_from("<Q", data, len(_MAGIC))
    if manifest_lsn is not None and base_lsn > manifest_lsn:
        report.add(
            "error",
            "wal-lsn",
            rel,
            f"base_lsn {base_lsn} is past the manifest checkpoint LSN "
            f"{manifest_lsn}: records between them are unrecoverable",
        )
    off = _HEADER_SIZE
    end = len(data)
    while off < end:
        if end - off < _REC_HEADER.size:
            report.add(
                "warn",
                "wal-torn-tail",
                rel,
                f"{end - off} trailing bytes form no record header "
                f"(recovery truncates to offset {off})",
            )
            return
        length, crc = _REC_HEADER.unpack_from(data, off)
        body_at = off + _REC_HEADER.size
        if end - body_at < length:
            report.add(
                "warn",
                "wal-torn-tail",
                rel,
                f"record at offset {off} claims {length} bytes, only "
                f"{end - body_at} present (torn tail)",
            )
            return
        payload = data[body_at : body_at + length]
        if zlib.crc32(payload) != crc:
            report.add(
                "error",
                "wal-crc",
                rel,
                f"crc mismatch on complete record at offset {off}",
            )
            _resync_scan(report, rel, data, body_at + length)
            return
        try:
            (jlen,) = struct.unpack_from("<I", payload, 0)
            json.loads(payload[4 : 4 + jlen])
        except (struct.error, ValueError) as exc:
            report.add(
                "error",
                "wal-record",
                rel,
                f"record at offset {off} has valid crc but undecodable "
                f"payload: {exc}",
            )
        report.checked["wal_records"] += 1
        off = body_at + length


def _resync_scan(report: Report, rel: str, data: bytes, start: int) -> None:
    """After a bad record: do intact records follow it?  Then this is not a
    torn tail — recovery would silently discard durable records."""
    end = min(len(data), start + _RESYNC_SCAN_CAP)
    off = start
    while off + _REC_HEADER.size <= end:
        length, crc = _REC_HEADER.unpack_from(data, off)
        body_at = off + _REC_HEADER.size
        if 0 < length <= end - body_at and zlib.crc32(
            data[body_at : body_at + length]
        ) == crc:
            report.add(
                "error",
                "wal-crc",
                rel,
                f"intact record found at offset {off}, past the corrupt "
                "one: mid-log corruption strands durable records",
            )
            return
        off += 1


# --------------------------------------------------------------------------
# blob checks
# --------------------------------------------------------------------------


def _check_blob(
    report: Report,
    directory: str,
    fn: str,
    expect_rows: int | None,
) -> None:
    rel = os.path.relpath(os.path.join(directory, fn), report.root)
    path = os.path.join(directory, fn)
    if not os.path.isfile(path):
        report.add("error", "dangling-handle", rel, "manifest references a missing blob")
        return
    try:
        with open(path, "rb") as f:
            table = CompressedTable.deserialize(f.read())
    except Exception as exc:
        report.add("error", "blob-decode", rel, f"undecodable table blob: {exc}")
        return
    report.checked["blobs"] += 1
    if expect_rows is not None and table.n_rows != int(expect_rows):
        report.add(
            "error",
            "blob-invariant",
            rel,
            f"manifest says {expect_rows} rows, blob holds {table.n_rows}",
        )
    if (table.key_lo > table.key_hi).any():
        report.add("error", "blob-invariant", rel, "key interval with lo > hi")
    if (table.val_lo > table.val_hi).any():
        report.add("error", "blob-invariant", rel, "value interval with lo > hi")
    if table.n_rows and (
        (table.val_ref < -1) | (table.val_ref >= table.n_key)
    ).any():
        report.add(
            "error",
            "blob-invariant",
            rel,
            f"val_ref outside [-1, {table.n_key})",
        )


# --------------------------------------------------------------------------
# materialized-view checks
# --------------------------------------------------------------------------


def _scan_wal_payloads(path: str) -> list[tuple[str, dict, int]]:
    """Decoded ``(type, meta, end_lsn)`` for every intact record (read-only;
    integrity findings are ``_check_wal``'s job — here a bad frame just ends
    the scan, exactly as recovery would)."""
    out: list[tuple[str, dict, int]] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out
    if len(data) < _HEADER_SIZE or data[: len(_MAGIC)] != _MAGIC:
        return out
    (base_lsn,) = struct.unpack_from("<Q", data, len(_MAGIC))
    off = _HEADER_SIZE
    while len(data) - off >= _REC_HEADER.size:
        length, crc = _REC_HEADER.unpack_from(data, off)
        body_at = off + _REC_HEADER.size
        if len(data) - body_at < length:
            break
        payload = data[body_at : body_at + length]
        if zlib.crc32(payload) != crc:
            break
        try:
            (jlen,) = struct.unpack_from("<I", payload, 0)
            head = json.loads(payload[4 : 4 + jlen])
            rtype = head.pop("t")
            head.pop("nb", None)
        except (struct.error, ValueError):
            break
        off = body_at + length
        out.append((rtype, head, base_lsn + (off - _HEADER_SIZE)))
    return out


def _reach(adj: dict[str, set[str]], start: str) -> set[str]:
    seen = {start}
    frontier = [start]
    while frontier:
        for nxt in adj.get(frontier.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


def _check_views(
    report: Report,
    directory: str,
    views_chunk: dict | None,
    known_lids: set[int],
    known_arrays: set[str],
    base_edges: list[tuple[int, str, str]],
    wal_paths: dict[str, str],
) -> None:
    """Blob closure, route closure, and WAL-precise staleness for every
    persisted view.  ``base_edges`` is the manifest's ``(lid, src, dst)``
    list; ``wal_paths`` maps each key of a view's ``lsns`` horizon dict to
    its log file."""
    rel_manifest = os.path.relpath(
        os.path.join(directory, "catalog.json"), report.root
    )
    recs = list(views_chunk.get("views", [])) if views_chunk else []
    sidecar = os.path.join(directory, "answers.json")
    if os.path.exists(sidecar):
        rel = os.path.relpath(sidecar, report.root)
        try:
            with open(sidecar) as f:
                chunk = json.load(f)
            for ent in chunk.get("answers", []):
                ent["key"], ent["boxes"]  # shape probe
        except (OSError, ValueError, KeyError, TypeError) as exc:
            report.add(
                "warn",
                "answer-cache",
                rel,
                f"torn answer-cache sidecar ({exc}); reopen starts cold",
            )
    if not recs:
        return

    for rec in recs:
        report.checked["views"] += 1
        vid = rec.get("id")
        _check_blob(report, directory, rec["file"], rec.get("rows"))
        if rec.get("fwd"):
            _check_blob(report, directory, rec["fwd"], rec.get("fwd_rows"))
        for lid in rec.get("lids", []):
            if int(lid) not in known_lids:
                report.add(
                    "error",
                    "view-stale",
                    rel_manifest,
                    f"view {vid} composes lineage id {lid}, which the "
                    "manifest no longer holds",
                )
        for name in rec.get("arrays", []):
            if name not in known_arrays:
                report.add(
                    "error",
                    "view-stale",
                    rel_manifest,
                    f"view {vid} spans array {name!r}, which the manifest "
                    "no longer declares",
                )

    # WAL-precise staleness: replay each log's tail against the views,
    # firing the same rules the live invalidation hooks apply.
    for key, wal_path in sorted(wal_paths.items()):
        records = _scan_wal_payloads(wal_path)
        if not records:
            continue
        rel_wal = os.path.relpath(wal_path, report.root)
        fwd: dict[str, set[str]] = {}
        bwd: dict[str, set[str]] = {}
        by_lid: dict[int, tuple[str, str]] = {}
        for lid, src, dst in base_edges:
            fwd.setdefault(src, set()).add(dst)
            bwd.setdefault(dst, set()).add(src)
            by_lid[lid] = (src, dst)
        for rtype, m, lsn in records:
            horizon = lambda rec: int(rec.get("lsns", {}).get(key, 0))
            if rtype == "entry":
                src, dst = m["src"], m["dst"]
                fwd.setdefault(src, set()).add(dst)
                bwd.setdefault(dst, set()).add(src)
                by_lid[int(m["id"])] = (src, dst)
                up = _reach(bwd, src)
                down = _reach(fwd, dst)
                for rec in recs:
                    if (
                        lsn > horizon(rec)
                        and rec["src"] in up
                        and rec["dst"] in down
                    ):
                        report.add(
                            "error",
                            "view-stale",
                            rel_wal,
                            f"entry {m['id']} ({src}->{dst}, LSN {lsn}) lands "
                            f"on view {rec.get('id')}'s route past its "
                            f"horizon {horizon(rec)}",
                        )
            elif rtype in ("dirty", "drop"):
                lid = int(m["id"])
                if rtype == "drop" and lid in by_lid:
                    src, dst = by_lid.pop(lid)
                    fwd.get(src, set()).discard(dst)
                    bwd.get(dst, set()).discard(src)
                for rec in recs:
                    if lsn > horizon(rec) and lid in [
                        int(x) for x in rec.get("lids", [])
                    ]:
                        report.add(
                            "error",
                            "view-stale",
                            rel_wal,
                            f"{rtype} record for entry {lid} (LSN {lsn}) "
                            f"invalidates view {rec.get('id')} past its "
                            f"horizon {horizon(rec)}",
                        )


# --------------------------------------------------------------------------
# lease / writer-slot checks
# --------------------------------------------------------------------------


def _check_lease(report: Report, directory: str) -> None:
    path = os.path.join(directory, WriterLease.FILENAME)
    if not os.path.exists(path):
        return
    rel = os.path.relpath(path, report.root)
    try:
        with open(path) as f:
            holder = json.load(f)
    except (OSError, ValueError):
        report.add("warn", "stale-lease", rel, "unreadable lease file")
        return
    import socket

    if holder.get("host") == socket.gethostname() and "pid" in holder:
        if _pid_alive(int(holder["pid"])):
            report.add(
                "warn",
                "live-writer",
                rel,
                f"pid {holder['pid']} holds the writer lease; on-disk "
                "state may be mid-commit (findings may be transient)",
            )
        else:
            report.add(
                "warn",
                "stale-lease",
                rel,
                f"lease held by dead pid {holder['pid']} (crashed writer; "
                "the next open steals it)",
            )
    else:
        report.add("info", "foreign-lease", rel, f"lease held on host {holder.get('host')!r}")


def _check_writer_slots(report: Report, root: str) -> None:
    slots_dir = os.path.join(root, "writers")
    if not os.path.isdir(slots_dir):
        return
    import socket

    for slot in sorted(os.listdir(slots_dir)):
        sub = os.path.join(slots_dir, slot)
        holder = WriterLease.holder(sub)
        rel = os.path.relpath(sub, report.root)
        if holder is None:
            report.add("warn", "stale-lease", rel, "empty writer-presence slot")
            continue
        if holder.get("host") == socket.gethostname() and "pid" in holder:
            if not _pid_alive(int(holder["pid"])):
                report.add(
                    "warn",
                    "stale-lease",
                    rel,
                    f"writer slot held by dead pid {holder['pid']}",
                )
            else:
                report.add("warn", "live-writer", rel, f"pid {holder['pid']} is writing")


# --------------------------------------------------------------------------
# single-store (one DSLog directory: plain store or one shard)
# --------------------------------------------------------------------------


def _check_dag_acyclic(report: Report, rel: str, edges: list[tuple[str, str]]) -> None:
    adj: dict[str, list[str]] = {}
    for src, dst in edges:
        adj.setdefault(src, []).append(dst)
    WHITE, GREY, BLACK = 0, 1, 2
    colour: dict[str, int] = {}

    def visit(node: str) -> bool:
        colour[node] = GREY
        for nxt in adj.get(node, ()):
            c = colour.get(nxt, WHITE)
            if c == GREY:
                report.add(
                    "error",
                    "dag-cycle",
                    rel,
                    f"lineage graph contains a cycle through {nxt!r}",
                )
                return False
            if c == WHITE and not visit(nxt):
                return False
        colour[node] = BLACK
        return True

    for node in list(adj):
        if colour.get(node, WHITE) == WHITE:
            if not visit(node):
                return


def _check_store_dir(report: Report, directory: str) -> dict | None:
    """All checks for one DSLog directory; returns its parsed manifest."""
    rel_manifest = os.path.relpath(os.path.join(directory, "catalog.json"), report.root)
    manifest_path = os.path.join(directory, "catalog.json")
    wal_path = os.path.join(directory, WAL_FILENAME)
    meta: dict | None = None
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            report.add("error", "manifest-parse", rel_manifest, f"unparseable manifest: {exc}")
            meta = None
    elif not os.path.exists(wal_path):
        report.add(
            "error",
            "manifest-parse",
            rel_manifest,
            "no manifest and no WAL: not a store directory",
        )
        return None

    manifest_lsn = None
    lineage_recs: list[dict] = []
    predictor_chunk = None
    if meta is not None:
        manifest_lsn = int(meta.get("wal_lsn", 0)) if "wal_lsn" in meta else None
        lineage_recs = list(meta.get("lineage", []))
        predictor_chunk = meta.get("predictor")

    if os.path.exists(wal_path):
        _check_wal(report, wal_path, manifest_lsn)

    for rec in lineage_recs:
        report.checked["entries"] += 1
        _check_blob(report, directory, rec["file"], rec.get("rows"))
        if rec.get("fwd"):
            _check_blob(report, directory, rec["fwd"], rec.get("fwd_rows"))
        for key in ("idx", "fwd_idx"):
            if rec.get(key):
                path = os.path.join(directory, rec[key])
                if not os.path.isfile(path):
                    report.add(
                        "error",
                        "dangling-handle",
                        os.path.relpath(path, report.root),
                        "manifest references a missing index sidecar",
                    )

    if predictor_chunk:
        for sig in predictor_chunk.get("sigs", []):
            for fn in sig.get("tables", {}).values():
                _check_blob(report, directory, fn, None)

    if meta is not None:
        _check_dag_acyclic(
            report,
            rel_manifest,
            [(rec["src"], rec["dst"]) for rec in lineage_recs],
        )
        _check_views(
            report,
            directory,
            meta.get("views"),
            {int(rec["id"]) for rec in lineage_recs},
            set(meta.get("arrays", {})),
            [(int(r["id"]), r["src"], r["dst"]) for r in lineage_recs],
            {"": wal_path} if os.path.exists(wal_path) else {},
        )
        # orphan sweep with the exact closure compact() vacuums against
        referenced = manifest_referenced_files(
            lineage_recs, predictor_chunk, meta.get("views")
        )
        for fn in sorted(os.listdir(directory)):
            if not os.path.isfile(os.path.join(directory, fn)):
                continue
            if fn in referenced or not is_catalog_blob(fn):
                continue
            report.add(
                "warn",
                "orphan-blob",
                os.path.relpath(os.path.join(directory, fn), report.root),
                "catalog-owned blob not referenced by the manifest "
                "(compact() reclaims it)",
            )

    _check_lease(report, directory)
    return meta


# --------------------------------------------------------------------------
# sharded root
# --------------------------------------------------------------------------


def _wal_has_records(directory: str) -> bool:
    path = os.path.join(directory, WAL_FILENAME)
    try:
        return os.path.getsize(path) > _HEADER_SIZE
    except OSError:
        return False


def _check_sharded_root(report: Report, root: str, meta: dict) -> None:
    rel_manifest = os.path.relpath(os.path.join(root, "catalog.json"), report.root)
    n_shards = int(meta.get("n_shards", 0))
    arrays = meta.get("arrays", {})
    edges = meta.get("edges", [])
    boundary = meta.get("boundary", [])

    for name, rec in arrays.items():
        shard = int(rec.get("shard", -1))
        if not (0 <= shard < n_shards):
            report.add(
                "error",
                "shard-map",
                rel_manifest,
                f"array {name!r} assigned to shard {shard} of {n_shards}",
            )

    seen_lids: dict[int, int] = {}
    shard_manifests: dict[int, dict | None] = {}
    shard_pending: dict[int, bool] = {}
    for k in range(n_shards):
        sub = os.path.join(root, f"shard_{k:02d}")
        shard_pending[k] = _wal_has_records(sub)
        if os.path.isdir(sub):
            report.checked["shards"] += 1
            shard_manifests[k] = _check_store_dir(report, sub)
        else:
            shard_manifests[k] = None

    shard_entry_ids: dict[int, set[int]] = {}
    for k, smeta in shard_manifests.items():
        if smeta is not None:
            shard_entry_ids[k] = {int(r["id"]) for r in smeta.get("lineage", [])}

    for src, dst, lid, shard in edges:
        lid, shard = int(lid), int(shard)
        if lid in seen_lids:
            report.add(
                "error",
                "shard-map",
                rel_manifest,
                f"lineage id {lid} appears on shards {seen_lids[lid]} and {shard}",
            )
        seen_lids[lid] = shard
        if not (0 <= shard < n_shards):
            report.add(
                "error",
                "shard-map",
                rel_manifest,
                f"edge {src}->{dst} (id {lid}) on shard {shard} of {n_shards}",
            )
            continue
        dst_rec = arrays.get(dst)
        if dst_rec is not None and int(dst_rec.get("shard", -1)) != shard:
            report.add(
                "error",
                "shard-map",
                rel_manifest,
                f"edge {src}->{dst} (id {lid}) recorded on shard {shard}, "
                f"but array {dst!r} lives on shard {dst_rec.get('shard')}",
            )
        if shard in shard_entry_ids and lid not in shard_entry_ids[shard]:
            if not shard_pending.get(shard):
                report.add(
                    "error",
                    "shard-map",
                    rel_manifest,
                    f"root references entry {lid} that shard {shard}'s "
                    "manifest does not hold (and its WAL is empty)",
                )

    # boundary table must equal a recomputation from the edge list
    expect_boundary = set()
    for src, dst, lid, shard in edges:
        src_rec = arrays.get(src)
        if src_rec is not None and int(src_rec.get("shard", -1)) != int(shard):
            expect_boundary.add(int(lid))
    got_boundary = {int(rec[0]) for rec in boundary}
    for lid in sorted(expect_boundary - got_boundary):
        report.add(
            "error",
            "shard-map",
            rel_manifest,
            f"edge {lid} crosses shards but is missing from the boundary table",
        )
    for lid in sorted(got_boundary - expect_boundary):
        report.add(
            "error",
            "shard-map",
            rel_manifest,
            f"boundary table lists edge {lid}, which does not cross shards",
        )

    _check_dag_acyclic(
        report, rel_manifest, [(src, dst) for src, dst, _, _ in edges]
    )

    # root dir: WAL, predictor blobs, orphans, leases, writer slots
    manifest_lsn = int(meta["wal_lsn"]) if "wal_lsn" in meta else None
    wal_path = os.path.join(root, WAL_FILENAME)
    if os.path.exists(wal_path):
        _check_wal(report, wal_path, manifest_lsn)
    predictor_chunk = meta.get("predictor")
    if predictor_chunk:
        for sig in predictor_chunk.get("sigs", []):
            for fn in sig.get("tables", {}).values():
                _check_blob(report, root, fn, None)
    # whole-route views live on the root; any log (root or shard) can
    # hold the record that staled one
    view_wals = {}
    if os.path.exists(wal_path):
        view_wals["root"] = wal_path
    for k in range(n_shards):
        sub_wal = os.path.join(root, f"shard_{k:02d}", WAL_FILENAME)
        if os.path.exists(sub_wal):
            view_wals[f"shard_{k:02d}"] = sub_wal
    _check_views(
        report,
        root,
        meta.get("views"),
        {int(lid) for _, _, lid, _ in edges},
        set(arrays),
        [(int(lid), src, dst) for src, dst, lid, _ in edges],
        view_wals,
    )
    referenced = manifest_referenced_files((), predictor_chunk, meta.get("views"))
    for fn in sorted(os.listdir(root)):
        if not os.path.isfile(os.path.join(root, fn)):
            continue
        if fn in referenced or not is_catalog_blob(fn):
            continue
        report.add(
            "warn",
            "orphan-blob",
            os.path.relpath(os.path.join(root, fn), report.root),
            "catalog-owned blob not referenced by the root manifest",
        )
    _check_lease(report, root)
    _check_writer_slots(report, root)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def fsck_store(root: str) -> Report:
    """Verify the store rooted at ``root``; never mutates anything."""
    report = Report(root)
    manifest_path = os.path.join(root, "catalog.json")
    meta = None
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            meta = None  # _check_store_dir re-reports the parse failure
    if meta is not None and meta.get("sharded"):
        _check_sharded_root(report, root, meta)
    else:
        _check_store_dir(report, root)
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.fsck",
        description="deep on-disk verifier for DSLog stores (read-only)",
    )
    ap.add_argument("root", help="store root directory")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"fsck: {args.root!r} is not a directory", file=sys.stderr)
        return 2
    if not (
        os.path.exists(os.path.join(args.root, "catalog.json"))
        or os.path.exists(os.path.join(args.root, WAL_FILENAME))
    ):
        print(f"fsck: {args.root!r} holds no manifest or WAL", file=sys.stderr)
        return 2
    report = fsck_store(args.root)
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in report.findings:
            print(f)
        state = "clean" if report.ok else "CORRUPT"
        print(
            f"fsck: {state}: {report.checked['entries']} entries, "
            f"{report.checked['blobs']} blobs, "
            f"{report.checked['views']} views, "
            f"{report.checked['wal_records']} wal records, "
            f"{report.checked['shards']} shards checked; "
            f"{len(report.errors)} error(s), {len(report.warnings)} warning(s)"
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
