"""The port's store tools vs the JAX package's: fsck, mkstore, dstat, the
race detector and the lock table.

* ``fsck``: both verifiers on each damaged store of
  ``tests/test_tools_fsck.py`` (built by either package) report the same
  findings (severity, category, path and detail) and counts, and both CLIs
  exit with the same codes.
* ``mkstore --device cpu`` builds the reference's store, file for file,
  and both verifiers pass it.
* ``dstat`` prints the reference's golden ``diff`` output and the same
  ``dump``/``watch`` output.
* the port's ``racecheck`` flags the scenarios of
  ``tests/test_tools_race.py`` as the reference's does, and the port's
  ``_locks`` mints its instruments under ``DSLOG_RACE_DETECT``.
* the port's lock table equals the reference's, rank for rank.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

import repro.core.capture as jC
import repro.core.catalog as jcat
import repro.core.shard as jshard
import repro.tools.dstat as jdstat
import repro.tools.fsck as jfsck
import repro.tools.lockorder as jlockorder
import repro.tools.mkstore as jmkstore
import repro.tools.racecheck as jrace
import repro_torch.core.capture as tC
import repro_torch.core.catalog as tcat
import repro_torch.core.shard as tshard
import repro_torch.tools.dstat as tdstat
import repro_torch.tools.fsck as tfsck
import repro_torch.tools.lockorder as tlockorder
import repro_torch.tools.mkstore as tmkstore
import repro_torch.tools.racecheck as trace

from test_tools_dstat import NEW, OLD
from test_torch_shard import _assert_same_tree, _ingest_random_dag

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
_HEADER = 15  # WAL magic + base_lsn
_MAGIC_LEN = 7  # b"DSWAL1\n"
# (shard module, catalog module, capture module, mkstore module, kwargs)
PKGS = {
    "ref": (jshard, jcat, jC, jmkstore, {}),
    "port": (tshard, tcat, tC, tmkstore, {"device": "cpu"}),
}


# --------------------------------------------------------------------------- #
# fsck on damaged stores
# --------------------------------------------------------------------------- #
def _edit_json(path):
    with open(path) as f:
        return json.load(f)


def _write_json(path, meta):
    with open(path, "w") as f:
        json.dump(meta, f)


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _record_wals(root):
    return sorted(
        os.path.join(d, "wal.log") for d, _, files in os.walk(root)
        if "wal.log" in files and os.path.getsize(os.path.join(d, "wal.log")) > _HEADER
    )


def _live_wal_store(pkg, root):
    shard, _, C, _, kw = PKGS[pkg]
    log = shard.ShardedDSLog.open(root, 4, **kw)
    _ingest_random_dag(log, C, 6, seed=11)
    log.commit()
    log.close(checkpoint=False)
    wals = _record_wals(root)
    assert wals
    return wals


def _built(pkg, root, n_shards=2, n_ops=6):
    _, _, _, mk, kw = PKGS[pkg]
    mk.build_store(root, n_shards=n_shards, n_ops=n_ops, seed=5, **kw)


def _first_blob(root, n_shards):
    for k in range(n_shards):
        meta = _edit_json(os.path.join(root, f"shard_{k:02d}", "catalog.json"))
        if meta.get("lineage"):
            return os.path.join(root, f"shard_{k:02d}", meta["lineage"][0]["file"])
    raise AssertionError("no blob")


def _clean_sharded(pkg, root):
    _built(pkg, root, n_shards=4, n_ops=10)


def _clean_single(pkg, root):
    _, cat, C, _, kw = PKGS[pkg]
    log = cat.DSLog.open(root, **kw)
    log.add_lineage("a", "b", C.identity_lineage((8, 8)))
    log.add_lineage("b", "c", C.roll_lineage((8, 8), 2, 0))
    log.save()
    log.close()


def _torn_tail(pkg, root):
    wals = _live_wal_store(pkg, root)
    with open(wals[0], "r+b") as f:
        f.truncate(os.path.getsize(wals[0]) - 3)


def _crc_flip(pkg, root):
    victim = _live_wal_store(pkg, root)[0]
    with open(victim, "rb") as f:
        data = f.read()
    length, _ = struct.unpack_from("<II", data, _HEADER)
    _flip_byte(victim, _HEADER + 8 + length // 2)


def _lsn_skew(pkg, root):
    _built(pkg, root)
    meta = _edit_json(os.path.join(root, "catalog.json"))
    with open(os.path.join(root, "wal.log"), "r+b") as f:
        f.seek(_MAGIC_LEN)
        f.write(struct.pack("<Q", int(meta["wal_lsn"]) + 1000))


def _orphan(pkg, root):
    _built(pkg, root)
    with open(os.path.join(root, "shard_00", "lineage_9999.prvc"), "wb") as f:
        f.write(b"\x00" * 32)


def _dangling(pkg, root):
    _built(pkg, root)
    os.unlink(_first_blob(root, 2))


def _blob_flip(pkg, root):
    _built(pkg, root)
    victim = _first_blob(root, 2)
    _flip_byte(victim, os.path.getsize(victim) // 2)


def _shard_map(pkg, root):
    _built(pkg, root, n_shards=4, n_ops=8)
    path = os.path.join(root, "catalog.json")
    meta = _edit_json(path)
    src, dst, lid, shard = meta["edges"][0]
    meta["edges"][0] = [src, dst, lid, (int(shard) + 1) % 4]
    _write_json(path, meta)


def _unparseable(pkg, root):
    _built(pkg, root)
    _flip_byte(os.path.join(root, "catalog.json"), 0)


def _dag_cycle(pkg, root):
    _clean_single(pkg, root)
    path = os.path.join(root, "catalog.json")
    meta = _edit_json(path)
    back = dict(meta["lineage"][0])
    back["id"], back["src"], back["dst"] = 999, "c", "a"
    meta["lineage"].append(back)
    _write_json(path, meta)


def _stale_lease(pkg, root):
    _built(pkg, root)
    proc = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True)
    with open(os.path.join(root, "writer.lock"), "w") as f:
        json.dump({"pid": int(proc.stdout), "host": socket.gethostname(), "token": "x"}, f)


def _dropped_not_vacuumed(pkg, root):
    shard, _, C, _, kw = PKGS[pkg]
    log = shard.ShardedDSLog.open(root, 4, **kw)
    ids = _ingest_random_dag(log, C, 8, seed=13)
    log.save()
    for lid in ids[1:4]:
        log.drop_lineage(lid)
    log.save()
    log.close()


DAMAGES = {
    "clean-sharded": (_clean_sharded, set(), True),
    "clean-single": (_clean_single, set(), True),
    "torn-tail": (_torn_tail, {"wal-torn-tail"}, True),
    "crc-flip": (_crc_flip, {"wal-crc"}, False),
    "lsn-skew": (_lsn_skew, {"wal-lsn"}, False),
    "orphan": (_orphan, {"orphan-blob"}, True),
    "dangling": (_dangling, {"dangling-handle"}, False),
    "blob-flip": (_blob_flip, None, False),
    "shard-map": (_shard_map, {"shard-map"}, False),
    "unparseable": (_unparseable, {"manifest-parse"}, False),
    "dag-cycle": (_dag_cycle, {"dag-cycle"}, False),
    "stale-lease": (_stale_lease, {"stale-lease"}, True),
    "dropped": (_dropped_not_vacuumed, {"orphan-blob"}, True),
}


def _findings(report):
    return sorted((f.severity, f.category, f.path, f.detail) for f in report.findings)


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("damage", sorted(DAMAGES))
def test_fsck_matches_reference_on_damaged_stores(tmp_path, damage, writer):
    make, expect, ok = DAMAGES[damage]
    root = str(tmp_path / "s")
    make(writer, root)
    got, want = tfsck.fsck_store(root), jfsck.fsck_store(root)
    assert _findings(got) == _findings(want)
    assert got.checked == want.checked and got.ok == want.ok == ok
    if expect is None:  # a flipped blob byte fails decoding or an invariant
        assert {"blob-decode", "blob-invariant"} & got.categories()
    else:
        assert expect <= got.categories()
        if not expect:
            assert got.findings == []
    assert got.to_json() == want.to_json()


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env)


def test_fsck_cli_exit_codes_match_reference(tmp_path):
    root = str(tmp_path / "s")
    _built("port", root)
    empty = tmp_path / "empty"
    empty.mkdir()
    cases = []
    for label in ("clean", "corrupt", "missing", "empty"):
        if label == "corrupt":
            _flip_byte(os.path.join(root, "catalog.json"), 0)
        target = {"missing": str(tmp_path / "nonexistent"), "empty": str(empty)}.get(label, root)
        runs = {m: _cli(m, target) for m in ("repro_torch.tools.fsck", "repro.tools.fsck")}
        got, want = runs["repro_torch.tools.fsck"], runs["repro.tools.fsck"]
        assert got.returncode == want.returncode, label
        assert got.stdout == want.stdout, label
        cases.append(got.returncode)
        if label == "corrupt":
            js = _cli("repro_torch.tools.fsck", target, "--json")
            assert js.returncode == 1 and not json.loads(js.stdout)["ok"]
    assert cases == [0, 1, 2, 2]


# --------------------------------------------------------------------------- #
# mkstore
# --------------------------------------------------------------------------- #
def test_mkstore_cpu_builds_the_reference_store(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    r = _cli("repro_torch.tools.mkstore", port, "--device", "cpu", "--shards", "4")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"mkstore: {port}: ") and "'probe_cells': " in r.stdout
    stats = jmkstore.build_store(ref, n_shards=4)
    assert r.stdout.strip().endswith(str(stats))
    for fsck in (tfsck, jfsck):
        report = fsck.fsck_store(port)
        assert report.ok and report.findings == [], [str(f) for f in report.findings]
        assert report.checked["shards"] == 4 and report.checked["entries"] > 0
    _assert_same_tree(port, ref)


def test_mkstore_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: the default device is valid")
    r = _cli("repro_torch.tools.mkstore", str(tmp_path / "s"))
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


# --------------------------------------------------------------------------- #
# dstat
# --------------------------------------------------------------------------- #
def test_dstat_diff_golden_output(tmp_path, capsys):
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(OLD))
    new.write_text(json.dumps(NEW))
    assert tdstat.main(["diff", str(old), str(new)]) == 0
    assert capsys.readouterr().out == (
        "counters:\n"
        "  queries  +7\n"
        "  wal_appends  +15\n"
        "histograms:\n"
        "  flush_seconds  +6\n"
    )
    assert tdstat.diff_snapshots(OLD, NEW) == jdstat.diff_snapshots(OLD, NEW)


@pytest.mark.parametrize("args", [
    ["dump", "{root}"], ["dump", "{root}", "--json"], ["dump", "{root}", "--prometheus"],
    ["watch", "{root}", "--count", "2", "--interval", "0"],
    ["diff", "{old}", "{root}", "--json"], ["diff", "{root}", "{root}"],
    ["dump", "{bad}"], ["diff", "{missing}", "{root}"],
])
def test_dstat_output_matches_reference(tmp_path, capsys, args):
    store = str(tmp_path / "s")
    log = tshard.ShardedDSLog.open(store, 2, device="cpu")
    _ingest_random_dag(log, tC, 4, seed=1)
    log.prov_query("a0", "a4", np.array([[1, 1]]))
    log.close()  # checkpoint: writes telemetry.json
    (tmp_path / "old.json").write_text(json.dumps(OLD))
    (tmp_path / "bad.json").write_text(json.dumps({"schema": "nope"}))
    names = {"root": store, "old": str(tmp_path / "old.json"),
             "bad": str(tmp_path / "bad.json"), "missing": str(tmp_path / "nope.json")}
    argv = [a.format(**names) for a in args]
    outs = []
    for mod in (tdstat, jdstat):
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        outs.append((rc, cap.out, cap.err))
    assert outs[0] == outs[1]
    assert outs[0][0] == (2 if args[1] in ("{bad}", "{missing}") else 0)


# --------------------------------------------------------------------------- #
# The race detector (tests/test_tools_race.py's scenarios, on both modules)
# --------------------------------------------------------------------------- #
@pytest.fixture
def detect(monkeypatch):
    monkeypatch.setenv("DSLOG_RACE_DETECT", "1")
    trace.reset()
    jrace.reset()
    yield monkeypatch
    trace.reset()
    jrace.reset()


def _nested(rc, outer, inner, **kw):
    a, b = rc.InstrumentedLock(outer, **kw), rc.InstrumentedLock(inner, **kw)
    with a:
        with b:
            pass


def _rlock_reentry(rc):
    lock = rc.InstrumentedLock("catalog._stats_lock", reentrant=True)
    with lock:
        with lock:
            pass


def _cross_thread_cycle(rc):
    a, b = rc.InstrumentedLock("t.A"), rc.InstrumentedLock("t.B")
    for first, second in ((a, b), (b, a)):
        def run(x=first, y=second):
            with x:
                with y:
                    pass
        t = threading.Thread(target=run)
        t.start()
        t.join()


def _guarded_dict_unguarded(rc):
    guard = rc.InstrumentedLock("catalog._stats_lock", reentrant=True)
    rc.GuardedDict({"n": 0}, guard, "DSLog.io_stats")["n"] = 1


def _guarded_dict_clean(rc):
    guard = rc.InstrumentedLock("catalog._stats_lock", reentrant=True)
    stats = rc.GuardedDict({"n": 3}, guard, "DSLog.io_stats")
    assert stats["n"] == 3 and stats.get("missing") is None  # reads unchecked
    with guard:
        stats["n"] = 1
        stats.update(m=2)
        stats.setdefault("k", [])
        del stats["m"]
    assert stats == {"n": 1, "k": []}


def _guarded_list_unguarded(rc):
    guard = rc.InstrumentedLock("shard._shard_load_lock")
    shards = rc.GuardedList([None, None], guard, "ShardedDSLog._shards")
    shards[0] = object()


def _guarded_list_clean(rc):
    guard = rc.InstrumentedLock("shard._shard_load_lock")
    shards = rc.GuardedList([None, None], guard, "ShardedDSLog._shards")
    with guard:
        shards[1] = object()
        shards.append(None)


RACE_SCENARIOS = {
    # name: (scenario, a substring one finding must hold, or None = clean)
    "declared-order": (lambda rc: _nested(rc, "commit._flush_mutex", "wal._lock"), None),
    "rank-violation": (lambda rc: _nested(rc, "wal._lock", "commit._lock"), "lock-order"),
    "same-rank": (lambda rc: _nested(rc, "table._lock", "table._lock"), "lock-order"),
    "rlock-reentry": (_rlock_reentry, None),
    "cross-thread-cycle": (_cross_thread_cycle, "lock-cycle"),
    "dict-unguarded": (_guarded_dict_unguarded, "unguarded-mutation"),
    "dict-clean": (_guarded_dict_clean, None),
    "list-unguarded": (_guarded_list_unguarded, "unguarded-mutation"),
    "list-clean": (_guarded_list_clean, None),
}


def _strip_where(findings):
    # a finding names its call site, which differs between the two modules
    return sorted(f.split(" at ")[0].split(" (edge seen")[0] for f in findings)


@pytest.mark.parametrize("scenario", sorted(RACE_SCENARIOS))
def test_racecheck_flags_the_reference_scenarios(detect, scenario):
    run, expect = RACE_SCENARIOS[scenario]
    results = []
    for rc in (trace, jrace):
        rc.reset()
        run(rc)
        results.append((rc.findings(), sorted(rc.edges())))
        rc.reset()
    (got, got_edges), (want, want_edges) = results
    assert _strip_where(got) == _strip_where(want)
    assert got_edges == want_edges
    if expect is None:
        assert got == []
    else:
        assert any(expect in f for f in got)


def test_racecheck_stops_when_env_cleared(detect):
    guard = trace.InstrumentedLock("catalog._stats_lock", reentrant=True)
    stats = trace.GuardedDict({}, guard, "DSLog.io_stats")
    detect.delenv("DSLOG_RACE_DETECT")
    stats["n"] = 1
    assert trace.findings() == []


def test_port_locks_factory_follows_the_env(detect):
    from repro_torch.core import _locks

    lock, rlock = _locks.new_lock("wal._lock"), _locks.new_rlock("catalog._stats_lock")
    assert isinstance(lock, trace.InstrumentedLock) and not lock.reentrant
    assert isinstance(rlock, trace.InstrumentedLock) and rlock.reentrant
    assert not isinstance(lock, jrace.InstrumentedLock)  # the port's own detector
    assert isinstance(_locks.guard_mapping({"a": 1}, rlock, "x"), trace.GuardedDict)
    assert isinstance(_locks.guard_sequence([None], lock, "y"), trace.GuardedList)
    detect.delenv("DSLOG_RACE_DETECT")
    assert not isinstance(_locks.new_lock("wal._lock"), trace.InstrumentedLock)
    plain = _locks.guard_mapping({"a": 1}, None, "x")
    assert type(plain) is dict and type(_locks.guard_sequence([1], None, "y")) is list


def test_port_store_end_to_end_clean_under_detector(detect, tmp_path):
    log = tcat.DSLog.open(str(tmp_path / "s"), device="cpu")
    assert isinstance(log._stats_lock, trace.InstrumentedLock)
    log.add_lineage("a", "b", tC.identity_lineage((8, 8)))
    log.add_lineage("b", "c", tC.roll_lineage((8, 8), 2, 0))
    log.prov_query("a", "c", np.array([[1, 2]]))
    log.save()
    log.close()
    assert trace.findings() == []
    assert ("commit._flush_mutex", "wal._lock") in trace.edges()
    assert jrace.edges() == {}  # nothing of the port reached the reference's registry


# --------------------------------------------------------------------------- #
# The lock table
# --------------------------------------------------------------------------- #
def test_lock_table_equals_the_reference():
    assert tlockorder.LOCK_ORDER == jlockorder.LOCK_ORDER
    assert tlockorder.ranked() == jlockorder.ranked()
    assert tlockorder.LOCK_ROLES == jlockorder.LOCK_ROLES
    assert tlockorder.STATIC_LOCKS == jlockorder.STATIC_LOCKS
    assert tlockorder.markdown_table() == jlockorder.markdown_table()
    assert all(tlockorder.rank(n) == jlockorder.rank(n) for n in jlockorder.LOCK_ORDER)
