"""The port's sharded store vs the JAX package's, on the same random DAGs.

Both packages' ``ShardedDSLog`` ingest the same seeded op streams
(``tests/test_shard.py``'s random DAG: a chain with a two-input fan-in every
third op, 8 x 8 arrays) at N = 1, 2 and 4 shards, under the hash and the
affinity policy.  They must give the same answers (as bytes, tolerance 0),
the same plans, exchanges and ``boxes_exchanged``, and write the same root
and shard manifests and blobs; each package must load the other's root, and
recover a torn-write crash to the same store.  Leases taken by one package
block the other.  The port runs with ``device="cpu"``.

The module runs under the port's race detector (``DSLOG_RACE_DETECT=1``,
``repro_torch.tools.racecheck``) through its own autouse fixture; the
reference's stores, which run beside the port's, are held to the
reference's detector in the same fixture.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

import repro.core.capture as jC
import repro.core.catalog as jcat
import repro.core.commit as jcommit
import repro.core.shard as jshard
import repro.tools.fsck as jfsck
import repro.tools.racecheck as jrace
import repro_torch.core.capture as tC
import repro_torch.core.catalog as tcat
import repro_torch.core.commit as tcommit
import repro_torch.core.shard as tshard
import repro_torch.core.wal as twal
import repro_torch.tools.racecheck as trace

SIDE = 8
SHAPE = (SIDE, SIDE)
_HEADER = 15  # WAL magic + base_lsn
# (shard module, capture module, catalog module, keyword arguments)
PKGS = {
    "ref": (jshard, jC, jcat, {}),
    "port": (tshard, tC, tcat, {"device": "cpu"}),
}
# sidecars that hold timings or pids: held by schema, not bytes
UNCOMPARED = {"telemetry.json", "autotune.json", "writer.lock"}


@pytest.fixture(autouse=True)
def _race_detect(monkeypatch):
    """Whole module runs under the port's dynamic lock-order / race
    detector (and the reference's, for the reference stores beside it)."""
    monkeypatch.setenv("DSLOG_RACE_DETECT", "1")
    trace.reset()
    jrace.reset()
    yield
    found = trace.findings() + jrace.findings()
    trace.reset()
    jrace.reset()
    assert not found, "race-detector findings:\n" + "\n".join(found)


def _ops(C):
    return [
        lambda rng: C.identity_lineage(SHAPE),
        lambda rng: C.flip_lineage(SHAPE, int(rng.integers(0, 2))),
        lambda rng: C.roll_lineage(SHAPE, int(rng.integers(1, 4)), 0),
        lambda rng: C.transpose_lineage(SHAPE, (1, 0)),
    ]


def _build_random_dag(logs, n_ops: int, seed: int):
    """``tests/test_shard.py``'s random DAG driven into ``logs``, a list of
    ``(store, capture module)``: the same draws for every store."""
    rng = np.random.default_rng(seed)
    names = ["a0"]
    for log, _ in logs:
        log.define_array("a0", SHAPE)
    for k in range(n_ops):
        new = f"a{k + 1}"
        prev = names[-1]
        fan_in = k % 3 == 2 and len(names) > 2
        other = names[int(rng.integers(0, len(names) - 1))] if fan_in else None
        state = rng.bit_generator.state
        for log, C in logs:
            rng.bit_generator.state = state  # same draws per store
            ops = _ops(C)
            log.define_array(new, SHAPE)
            if fan_in:
                rel_a = ops[int(rng.integers(0, len(ops)))](rng)
                rel_b = ops[int(rng.integers(0, len(ops)))](rng)
                log.register_operation(
                    f"op{k}", [prev, other], [new],
                    capture=lambda ra=rel_a, rb=rel_b: {(0, 0): ra, (0, 1): rb},
                    reuse=False,
                )
            else:
                rel = ops[int(rng.integers(0, len(ops)))](rng)
                log.register_operation(
                    f"op{k}", [prev], [new], capture=lambda r=rel: {(0, 0): r}, reuse=False,
                )
        names.append(new)
    return names


def _ingest_random_dag(log, C, n_ops: int, seed: int):
    """``tests/test_crash_recovery.py``'s stream: ``add_lineage`` along a
    chain plus random fan-in edges; returns the lineage ids."""
    ops = _ops(C)
    rng = np.random.default_rng(seed)
    names, ids = ["a0"], []
    for k in range(n_ops):
        new = f"a{k + 1}"
        ids.append(log.add_lineage(names[-1], new, ops[int(rng.integers(0, 4))](rng)).lineage_id)
        if k % 3 == 2 and len(names) > 2:
            other = names[int(rng.integers(0, len(names) - 1))]
            ids.append(log.add_lineage(other, new, ops[int(rng.integers(0, 4))](rng)).lineage_id)
        names.append(new)
    return ids


def _diamond(log, C):
    """x fans out to a and b, which fan back into z."""
    for name in ("x", "a", "b", "z"):
        log.define_array(name, SHAPE)
    log.register_operation(
        "split", ["x"], ["a", "b"],
        capture=lambda: {(0, 0): C.flip_lineage(SHAPE, 0), (1, 0): C.roll_lineage(SHAPE, 2, 1)},
        reuse=False,
    )
    log.register_operation(
        "combine", ["a", "b"], ["z"],
        capture=lambda: {(0, 0): C.identity_lineage(SHAPE), (0, 1): C.identity_lineage(SHAPE)},
        reuse=False,
    )
    return log


def _policy(shard_mod, kind, n_shards):
    if kind == "hash":
        return shard_mod.HashShardPolicy(n_shards)
    # pin the backbone's odd arrays round-robin, the rest falls back to hash
    return shard_mod.AffinityShardPolicy(
        n_shards, {f"a{k}": k % n_shards for k in range(1, 12, 2)}
    )


def _stores(n_shards, kind="hash", root=None):
    """One sharded store per package (``root`` a dict of roots, or None)."""
    out = {}
    for pkg, (shard, C, _, kw) in PKGS.items():
        out[pkg] = (
            shard.ShardedDSLog(
                n_shards=n_shards, policy=_policy(shard, kind, n_shards),
                root=None if root is None else root[pkg], **kw,
            ),
            C,
        )
    return out


def _same(got, want, ctx=""):
    assert got.shape == want.shape, ctx
    assert got.lo.tobytes() == want.lo.tobytes(), ctx
    assert got.hi.tobytes() == want.hi.tobytes(), ctx


def _cells(seed, n=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, SIDE, n), rng.integers(0, SIDE, n)], axis=1)


def _tree(root):
    """Store-relative paths of every compared file under ``root``."""
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "writers")
        for fn in files:
            if fn not in UNCOMPARED:
                out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(out)


def _assert_same_tree(a, b):
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def _answer(store, src, dst, cells):
    try:
        return store.prov_query(src, dst, cells)
    except KeyError:
        return None


def _same_answers_all_pairs(t, j, arrays, cells):
    for src in arrays:
        for dst in arrays:
            if src == dst:
                continue
            got, want = _answer(t, src, dst, cells), _answer(j, src, dst, cells)
            assert (got is None) == (want is None), (src, dst)
            if want is not None:
                _same(got, want, (src, dst))


# --------------------------------------------------------------------------- #
# Queries, plans and exchanges
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("n_ops,seed", [(6, 3), (9, 2024)])
def test_queries_match_reference(n_shards, n_ops, seed):
    stores = _stores(n_shards)
    oracle = tcat.DSLog(device="cpu")  # the port's single store
    names = _build_random_dag(list(stores.values()) + [(oracle, tC)], n_ops, seed)
    t, j = stores["port"][0], stores["ref"][0]
    cells = _cells(seed + 1)
    src, dst = names[0], names[-1]
    for s, d, q in [(src, dst, cells), (dst, src, cells[:1])]:
        for merge in (True, False):
            got = t.prov_query(s, d, q, merge=merge)
            _same(got, j.prov_query(s, d, q, merge=merge), (s, d, merge))
            assert got.cell_set() == oracle.prov_query(s, d, q, merge=merge).cell_set()
            if n_shards == 1:  # the single-store special case, to the byte
                _same(got, oracle.prov_query(s, d, q, merge=merge))
    path = names[::-1]
    for merge in (True, False):
        _same(t.prov_query(path, cells[:2], merge=merge),
              j.prov_query(path, cells[:2], merge=merge), ("path", merge))
    got_b = t.prov_query_batch(src, dst, [cells, cells[:1]])
    want_b = j.prov_query_batch(src, dst, [cells, cells[:1]])
    for g, w in zip(got_b, want_b):
        _same(g, w, "batch")
    mids = names[1: len(names) - 1: 2]
    got_m = t.prov_query(src, mids + [dst], cells)
    want_m = j.prov_query(src, mids + [dst], cells)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        _same(got_m[k], want_m[k], ("multi-target", k))
    for batched in (True, False):
        _same(t.prov_query(src, dst, cells, batched=batched, parallel=2),
              j.prov_query(src, dst, cells, batched=batched, parallel=2), ("parallel", batched))
    assert t.io_stats["boxes_exchanged"] == j.io_stats["boxes_exchanged"]
    if n_shards > 1:
        assert t.io_stats["boxes_exchanged"] > 0


def _exchanges(plan):
    return [(e.array, e.u, e.v, e.side, e.from_shard, e.to_shard, e.est_boxes, e.est_cost,
             e.shipped_boxes) for e in plan.exchanges]


@pytest.mark.parametrize("kind", ["hash", "affinity"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plans_exchanges_and_boxes_exchanged_match_reference(kind, n_shards):
    stores = _stores(n_shards, kind)
    names = _build_random_dag(list(stores.values()), 8, seed=11)
    t, j = stores["port"][0], stores["ref"][0]
    for s, d in [(names[0], names[-1]), (names[-1], names[0])]:
        pt, pj = t.planner.plan(s, [d]), j.planner.plan(s, [d])
        assert isinstance(pt, tshard.ShardedQueryPlan)
        assert pt.describe() == re.sub(r"\btpu\b", "cuda", pj.describe())
        assert pt.shards_touched() == pj.shards_touched()
        assert sorted(pt.sub_plans()) == sorted(pj.sub_plans())
        assert _exchanges(pt) == _exchanges(pj)
        cells = _cells(n_shards)
        _same(t.prov_query(s, d, cells), j.prov_query(s, d, cells), (s, d))
    assert t.io_stats["boxes_exchanged"] == j.io_stats["boxes_exchanged"]
    assert t.sgraph.boundary_edges() == j.sgraph.boundary_edges()
    assert {k: t.shard_of_array(k) for k in names} == {k: j.shard_of_array(k) for k in names}
    snap_t = t.metrics_snapshot()["counters"]
    snap_j = j.metrics_snapshot()["counters"]
    pick = lambda rows: sorted(  # noqa: E731
        (r["name"], tuple(sorted(r["labels"].items())), r["value"])
        for r in rows if r["name"] in ("exchange_boxes", "boxes_exchanged"))
    assert pick(snap_t) == pick(snap_j)


def test_fanin_across_shards_exchanges_alike():
    stores = {pkg: _diamond(shard.ShardedDSLog(
        n_shards=2, policy=shard.AffinityShardPolicy(2, {"x": 0, "a": 0, "b": 1, "z": 1}), **kw), C)
        for pkg, (shard, C, _, kw) in PKGS.items()}
    t, j = stores["port"], stores["ref"]
    fwd_t, fwd_j = t.planner.plan("x", ["z"]), j.planner.plan("x", ["z"])
    assert fwd_t.exchanges and _exchanges(fwd_t) == _exchanges(fwd_j)
    for s, d, q in [("x", "z", np.array([[2, 3], [5, 5]])), ("z", "x", np.array([[4, 4]]))]:
        _same(t.prov_query(s, d, q), j.prov_query(s, d, q), (s, d))
    assert t.io_stats["boxes_exchanged"] == j.io_stats["boxes_exchanged"] > 0
    analyzed_t = t.prov_query("x", "z", np.array([[1, 1]]), trace=True)[1]
    analyzed_j = j.prov_query("x", "z", np.array([[1, 1]]), trace=True)[1]
    kinds = lambda tr: sorted(  # noqa: E731
        (s.attrs["side"], s.attrs["boxes"]) for s in tr.spans("exchange"))
    assert kinds(analyzed_t) == kinds(analyzed_j) and kinds(analyzed_t)


# --------------------------------------------------------------------------- #
# Persistence: manifest and blob bytes, cross-loading, incremental save
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["hash", "affinity"])
def test_saved_files_match_reference(tmp_path, kind):
    roots = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    stores = _stores(4, kind, roots)
    names = _build_random_dag(list(stores.values()), 9, seed=5)
    for log, _ in stores.values():
        log.prov_query(names[-1], names[0], _cells(1))  # hop feedback lands in shard manifests
        log.save()
    tree = _tree(roots["port"])
    assert "catalog.json" in tree and sum(p.endswith("catalog.json") for p in tree) >= 3
    assert any(p.startswith("shard_") and "lineage_" in p for p in tree)
    _assert_same_tree(roots["port"], roots["ref"])


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_package_loads_the_others_root(tmp_path, reader):
    writer = "ref" if reader == "port" else "port"
    shard, C, _, kw = PKGS[writer]
    pol = shard.AffinityShardPolicy(2, {"u": 0, "v": 0, "p": 1, "q": 1})
    log = shard.ShardedDSLog(n_shards=2, root=str(tmp_path), policy=pol, **kw)
    log.add_lineage("u", "v", C.identity_lineage((6, 3)))
    log.add_lineage("p", "q", C.reduce_lineage((6, 3), 1))
    names = _build_random_dag([(log, C)], 6, seed=7)
    log.save()
    rshard, _, _, rkw = PKGS[reader]
    back = rshard.ShardedDSLog.load(str(tmp_path), **rkw)
    want = jshard.ShardedDSLog.load(str(tmp_path))
    assert back.io_stats["shards_loaded"] == 0
    assert back.graph.has_path("u", "v") and not back.graph.has_path("u", "q")
    _same(back.prov_query("v", "u", np.array([[4, 1]])), want.prov_query("v", "u", np.array([[4, 1]])))
    assert back.loaded_shards() == want.loaded_shards() == [0]
    assert back.io_stats["shards_loaded"] == 1 and back.io_stats["tables_loaded"] == 1
    _same_answers_all_pairs(back, want, names, _cells(3, 2))
    assert back.io_stats["shards_loaded"] == want.io_stats["shards_loaded"]
    if reader == "port":
        assert back.device.type == "cpu"
        assert all(back.shard(k).device.type == "cpu" for k in back.loaded_shards())


def test_incremental_save_and_compact_match_reference(tmp_path):
    roots = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    stats = {}
    for pkg, (shard, C, _, kw) in PKGS.items():
        log = shard.ShardedDSLog(n_shards=4, root=roots[pkg], **kw)
        names = _build_random_dag([(log, C)], 6, seed=3)
        log.save()
        back = shard.ShardedDSLog.load(roots[pkg], **kw)
        back.define_array("tail", SHAPE)
        back.add_lineage(names[-1], "tail", C.identity_lineage(SHAPE))
        before = dict(back.io_stats)
        back.save()
        stats[pkg] = [back.io_stats[k] - before.get(k, 0) for k in ("manifests_written", "tables_written")]
    assert stats["port"] == stats["ref"]
    _assert_same_tree(roots["port"], roots["ref"])
    removed = {}
    for pkg, (shard, C, _, kw) in PKGS.items():
        log = shard.ShardedDSLog.load(roots[pkg], **kw)
        for lid in sorted(log.lineage)[1:4]:
            log.drop_lineage(lid)
        removed[pkg] = log.compact()
    assert removed["port"] == removed["ref"] and removed["port"]["files_removed"] >= 2
    _assert_same_tree(roots["port"], roots["ref"])


def test_versions_and_hop_feedback_round_trip_alike(tmp_path):
    roots = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    out = {}
    for pkg, (shard, C, _, kw) in PKGS.items():
        log = shard.ShardedDSLog(n_shards=2, root=roots[pkg], **kw)
        log.define_array("acc", (5,))
        prev = log.latest_version("acc")
        for _ in range(3):
            cur = log.version("acc")
            log.add_lineage(prev, cur, C.identity_lineage((5,)))
            prev = cur
        res = log.prov_query("acc@3", "acc", np.array([[2]]))
        log.save()
        back = shard.ShardedDSLog.load(roots[pkg], **kw)
        out[pkg] = (res, back.latest_version("acc"), back.version("acc"),
                    {lid: back.hop_measurement(lid, "backward", "key") for lid in sorted(back.lineage)})
    _same(out["port"][0], out["ref"][0])
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][1:3] == ("acc@3", "acc@4")
    assert any(v is not None for v in out["port"][3].values())
    _assert_same_tree(roots["port"], roots["ref"])


# --------------------------------------------------------------------------- #
# Durability: torn-write crash, recovery, leases
# --------------------------------------------------------------------------- #
def _wals(root):
    return sorted(
        p for p in glob.glob(os.path.join(root, "**", "wal.log"), recursive=True)
        if os.path.getsize(p) > _HEADER
    )


@pytest.mark.parametrize("n_shards,victim,frac", [(1, 0, 0.5), (4, 0, 0.3), (4, -1, 0.8)])
def test_torn_write_crash_recovers_alike(tmp_path, n_shards, victim, frac):
    roots = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    for pkg, (shard, C, _, kw) in PKGS.items():
        log = shard.ShardedDSLog.open(roots[pkg], n_shards, **kw)
        _ingest_random_dag(log, C, 6, seed=17)
        log.checkpoint()
        _ingest_random_dag(log, C, 3, seed=18)  # names repeat: new edges on a0..a3
        log.commit()
        log.close(checkpoint=False)
    wals = {pkg: _wals(root) for pkg, root in roots.items()}
    assert [os.path.relpath(p, roots["port"]) for p in wals["port"]] == [
        os.path.relpath(p, roots["ref"]) for p in wals["ref"]]
    for a, b in zip(wals["port"], wals["ref"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    for paths in wals.values():
        path = paths[victim]
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(_HEADER + int((size - _HEADER) * frac))
    t = tshard.ShardedDSLog.load(roots["port"], device="cpu")
    j = jshard.ShardedDSLog.load(roots["ref"])
    assert sorted(t._lid_shard.items()) == sorted(j._lid_shard.items())
    assert t.io_stats.get("wal_replayed", 0) == j.io_stats.get("wal_replayed", 0) > 0
    arrays = sorted(set(j.arrays), key=lambda s: (len(s), s))
    _same_answers_all_pairs(t, j, arrays, np.array([[1, 2], [6, 7]]))
    # a leased open repairs the torn tails and checkpoints: the same files
    for pkg, (shard, _, _, kw) in PKGS.items():
        shard.ShardedDSLog.open(roots[pkg], **kw).close()
    _assert_same_tree(roots["port"], roots["ref"])
    for k in range(n_shards):
        assert not twal.WriteAheadLog.file_has_records(
            os.path.join(roots["port"], f"shard_{k:02d}", "wal.log"))


@pytest.mark.parametrize("holder", ["port", "ref"])
def test_shard_leases_block_the_other_package(tmp_path, holder):
    other = "ref" if holder == "port" else "port"
    hshard, hC, _, hkw = PKGS[holder]
    oshard, _, _, okw = PKGS[other]
    error = {"ref": jcommit.LeaseHeldError, "port": tcommit.LeaseHeldError}[other]
    root = str(tmp_path)
    hshard.ShardedDSLog.open(root, 2, **hkw).close()  # initialized root
    writer = hshard.ShardedDSLog.open(root, exclusive=False, **hkw)
    writer.add_lineage("u", "v", hC.identity_lineage(SHAPE))  # takes a shard lease
    writer.commit()
    try:
        assert writer._shard_leases
        with pytest.raises(error):
            oshard.ShardedDSLog.open(root, **okw)  # exclusive: a live writer
    finally:
        writer.close()
    excl = hshard.ShardedDSLog.open(root, **hkw)  # the root lease
    try:
        with pytest.raises(error):
            oshard.ShardedDSLog.open(root, exclusive=False, **okw)
        with pytest.raises(error):
            oshard.ShardedDSLog.open(root, **okw)
    finally:
        excl.close()
    log = oshard.ShardedDSLog.open(root, **okw)  # released: opens, replays
    assert sorted(log.by_pair) == [("u", "v")]
    log.close()


# --------------------------------------------------------------------------- #
# fsck, the device guard, the detector's reach
# --------------------------------------------------------------------------- #
def test_reference_fsck_is_clean_on_the_ports_root(tmp_path):
    root = str(tmp_path / "s")
    log = tshard.ShardedDSLog.open(root, 4, device="cpu")
    ids = _ingest_random_dag(log, tC, 8, seed=13)
    log.save()
    for lid in ids[1:4]:
        log.drop_lineage(lid)
    log.compact()
    log.prov_query("a0", "a8", np.array([[1, 2]]))
    log.close()
    report = jfsck.fsck_store(root)
    assert report.ok and report.findings == [], [str(f) for f in report.findings]
    assert report.checked["shards"] == 4 and report.checked["entries"] > 0
    health = tshard.ShardedDSLog.load(root, device="cpu").health(run_fsck=True)
    assert health["ok"] and health["fsck"]["ok"] and health["fsck"]["findings"] == []


def test_sharded_dslog_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tshard.ShardedDSLog(n_shards=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tshard.ShardedDSLog.open(str(tmp_path / "s"), 2)
    assert not os.path.exists(tmp_path / "s")  # no lease, no directory was taken
    tshard.ShardedDSLog.open(str(tmp_path / "s"), 2, device="cpu").close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tshard.ShardedDSLog.load(str(tmp_path / "s"))
    log = tshard.ShardedDSLog.load(str(tmp_path / "s"), device="cpu")
    assert log.device.type == "cpu"
    assert log.planner.executor._device.type == "cpu"


def test_port_locks_are_instrumented_under_the_detector(tmp_path):
    log = tshard.ShardedDSLog.open(str(tmp_path / "s"), 4, device="cpu")
    assert isinstance(log._shard_load_lock, trace.InstrumentedLock)
    assert isinstance(log._stats_lock, trace.InstrumentedLock)
    assert isinstance(log._shards, trace.GuardedList)
    ids = _ingest_random_dag(log, tC, 7, seed=2)
    log.close()
    # a cold load, then parallel plan execution races worker threads onto
    # cold shards: the load latch and the stats locks are exercised
    back = tshard.ShardedDSLog.open(str(tmp_path / "s"), device="cpu")
    assert back.loaded_shards() == []
    res = back.prov_query("a0", "a7", np.array([[1, 2], [6, 7]]), parallel=4, batched=False)
    assert res.n_rows > 0 and len(back.loaded_shards()) > 1
    back.close()
    assert len(ids) >= 7
    edges = trace.edges()
    assert any("shard._shard_load_lock" in e for e in edges), sorted(edges)

