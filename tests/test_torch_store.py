"""The port's durable store vs the JAX package's, on the same record streams.

Both packages ingest the same seeded streams — small fig 8/9 workflows and a
small accel DAG, registered as operations with reuse on — into stores opened
with ``DSLog.open``, answer the same queries, checkpoint, crash and recover.
The files they write must be the same bytes (``catalog.json``, ``wal.log``,
``answers.json`` and every table, index, signature and view blob); each
package must load the other's store and answer alike; and the views, the
answer cache and reuse must make the same decisions.  ``telemetry.json``
and ``autotune.json`` hold timings and are held by schema instead.

Answers are compared as bytes (tolerance 0).  The port runs with
``device="cpu"``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.capture as jC
import repro.core.commit as jcommit
import repro.core.views as jviews
import repro.obs.export as jexport
import repro.tools.fsck as fsck
import repro_torch.core as tcore
import repro_torch.core.capture as tC
import repro_torch.core.commit as tcommit
import repro_torch.core.views as tviews
import repro_torch.obs.export as texport

SEED = 20240527
PKGS = {"ref": (jcore, jC, {}), "port": (tcore, tC, {"device": "cpu"})}
VIEW_STATS = (
    "view_hits", "view_misses", "cache_hits", "cache_misses",
    "views_materialized", "views_demoted", "views_invalidated",
)
# sidecars that hold timings: held by schema, not bytes
UNCOMPARED = {"telemetry.json", "autotune.json", "writer.lock"}


# --------------------------------------------------------------------------- #
# Record streams (benchmarks/fig89_query.py workflows, cut to test size)
# --------------------------------------------------------------------------- #
def _rank(shape):
    # generalized (gen_sig) reuse keys on the op and its args alone; naming
    # the rank keeps an identity from being instantiated at another rank
    return {"rank": len(shape)}


def _random_ops(seed, side=12, n_ops=5):
    rng = np.random.default_rng(seed)
    shape, ops = (side, side), []
    for _ in range(n_ops):
        k = int(rng.integers(0, 8))
        s = shape
        if k < 3:
            ops.append(("identity", _rank(s), lambda C, s=s: C.identity_lineage(s)))
        elif k == 3:
            ops.append(("flip", {"axis": 0}, lambda C, s=s: C.flip_lineage(s, 0)))
        elif k == 4:
            sh = int(rng.integers(1, 5))
            ops.append(("roll", {"shift": sh}, lambda C, s=s, sh=sh: C.roll_lineage(s, sh, 0)))
        elif k == 5:
            perm = tuple(reversed(range(len(s))))
            ops.append(("transpose", {"perm": list(perm)},
                        lambda C, s=s, p=perm: C.transpose_lineage(s, p)))
        elif k == 6:
            n = int(np.prod(s))
            ops.append(("reshape", {"to": [n]}, lambda C, s=s, n=n: C.reshape_lineage(s, (n,))))
        else:
            vals = rng.random(s)
            ops.append(("sort", {"axis": -1}, lambda C, v=vals: C.sort_lineage(v, axis=-1)))
        shape = ops[-1][2](jC).out_shape
    return ops


def _relational_ops(n=200):
    rng = np.random.default_rng(3)
    lk, rk = rng.integers(0, n // 2, n), rng.integers(0, n // 2, n // 2)

    def join(C):
        return C.inner_join_lineage(lk, rk, 3, 2)[0]

    out = join(jC).out_shape
    return [
        ("join", None, join),
        ("identity", _rank(out), lambda C: C.identity_lineage(out)),
        ("reduce", {"axis": 1}, lambda C: C.reduce_lineage(out, 1)),
        ("identity", _rank((1,)), lambda C: C.identity_lineage((out[0],))),
        ("identity", _rank((1,)), lambda C: C.identity_lineage((out[0],))),
    ]


WORKFLOWS = {
    "image": [
        ("slice", {"step": 2}, lambda C: C.slice_lineage((16, 16), (0, 0), (16, 16), (2, 2))),
        ("identity", _rank((8, 8)), lambda C: C.identity_lineage((8, 8))),
        ("transpose", {"perm": [1, 0]}, lambda C: C.transpose_lineage((8, 8), (1, 0))),
        ("flip", {"axis": 1}, lambda C: C.flip_lineage((8, 8), 1)),
        ("reduce", {"axis": 1}, lambda C: C.reduce_lineage((8, 8), 1)),
    ],
    "relational": _relational_ops(),
    "resnet": [
        ("conv2d", {"k": 3}, lambda C: C.conv2d_lineage(12, 12, 3, 3)),
        ("identity", _rank((10, 10)), lambda C: C.identity_lineage((10, 10))),
        ("conv2d", {"k": 3}, lambda C: C.conv2d_lineage(10, 10, 3, 3)),
        ("identity", _rank((8, 8)), lambda C: C.identity_lineage((8, 8))),
        ("reduce", {"axes": [0, 1]}, lambda C: C.reduce_lineage((8, 8), (0, 1))),
    ],
    "random0": _random_ops(0),
    "random1": _random_ops(1),
}


def _ingest(log, C, wf):
    """Register ``wf``'s operations (reuse on); returns the array names."""
    ops = WORKFLOWS[wf]
    names = [f"{wf}_a0"]
    log.define_array(names[0], ops[0][2](C).in_shape)
    for k, (op, args, make) in enumerate(ops):
        rel = make(C)
        names.append(f"{wf}_a{k + 1}")
        log.define_array(names[-1], rel.out_shape)
        log.register_operation(op, [names[k]], [names[k + 1]],
                               capture=lambda r=rel: {(0, 0): r}, op_args=args)
    return names


def _accel(log, core, shape=(64, 64), branches=3, hops=2):
    """``src`` fans out to ``branches`` chains of random bijections that fan
    back into ``out``, each registered as its own operation.  A bijection
    of 4,096 cells does not compress: its tables persist their key index."""
    rng = np.random.default_rng(0)
    n = int(np.prod(shape))
    cells = np.stack(np.unravel_index(np.arange(n), shape), axis=1).astype(np.int64)
    log.define_array("src", shape)
    log.define_array("out", shape)
    for b in range(branches):
        prev = "src"
        for h in range(hops + 1):
            name = "out" if h == hops else f"b{b}h{h}"
            if h < hops:
                log.define_array(name, shape)
            rel = core.LineageRelation(shape, shape, cells, cells[rng.permutation(n)])
            rel = rel.canonical()
            log.register_operation("perm", [prev], [name], capture=lambda r=rel: {(0, 0): r},
                                   op_args={"branch": b, "hop": h})
            prev = name


def _queries(names, n_queries=5):
    """Graph-form queries on each workflow's end-to-end route, both ways:
    varying cells (heat admits views) and one repeat (the answer cache)."""
    out = []
    for wf_names in names:
        src, dst = wf_names[0], wf_names[-1]
        rng = np.random.default_rng(SEED + len(out))
        for i in range(n_queries):
            out.append((src, dst, i % 2, rng))
        out.append((src, dst, 0, None))
        out.append((dst, src, 1, None))
    return out


def _run_queries(log, queries):
    res = []
    for src, dst, k, rng in queries:
        shape = log.arrays[src].shape
        n = int(np.prod(shape))
        if rng is None:
            flat = np.arange(min(3, n))
        else:
            flat = np.random.default_rng(k * 1000 + n).choice(n, size=min(4, n), replace=False)
        cells = np.stack(np.unravel_index(flat, shape), axis=1)
        res.append(log.prov_query(src, dst, cells))
    return res


def _same(got, want, ctx=""):
    assert got.shape == want.shape, ctx
    assert got.lo.tobytes() == want.lo.tobytes(), ctx
    assert got.hi.tobytes() == want.hi.tobytes(), ctx


def _same_answers(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"answer {i}")


def _stats(log):
    return {k: log.io_stats[k] for k in VIEW_STATS}


def _replayed(log):
    return dict(log.io_stats).get("wal_replayed", 0)


def _files(root):
    return sorted(f for f in os.listdir(root) if f not in UNCOMPARED)


def _assert_same_files(a, b):
    assert _files(a) == _files(b)
    for fn in _files(a):
        with open(os.path.join(a, fn), "rb") as fa, open(os.path.join(b, fn), "rb") as fb:
            assert fa.read() == fb.read(), fn


def _wal(root):
    with open(os.path.join(root, "wal.log"), "rb") as f:
        return f.read()


# --------------------------------------------------------------------------- #
# One checkpointed store per package, shared by the read-only tests
# --------------------------------------------------------------------------- #
FIRST = ("image", "relational", "resnet")
SECOND = ("random0", "random1")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both packages: open, ingest FIRST, commit (WAL bytes), query, check-
    point (file bytes), ingest SECOND + the accel DAG, query, checkpoint."""
    base = tmp_path_factory.mktemp("stores")
    out = {"roots": {}, "wal1": {}, "files1": {}, "answers": {}, "stats": {},
           "reused": {}, "names": None}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(base / pkg)
        log = core.DSLog.open(root, durability="group", **kw)
        names = [_ingest(log, C, wf) for wf in FIRST]
        log.commit()
        out["wal1"][pkg] = _wal(root)
        answers = _run_queries(log, _queries(names))
        log.checkpoint()
        snap = str(base / f"{pkg}_first")
        shutil.copytree(root, snap)
        out["files1"][pkg] = snap
        names += [_ingest(log, C, wf) for wf in SECOND]
        _accel(log, core)
        names.append(["src", "out"])
        answers += _run_queries(log, _queries(names[3:]))
        log.close()  # checkpoints
        out["roots"][pkg] = root
        out["answers"][pkg] = answers
        out["stats"][pkg] = _stats(log)
        out["reused"][pkg] = [op.reused for op in log.ops]
        out["names"] = names
    return out


def test_wal_bytes_equal_after_commit(stores):
    assert len(stores["wal1"]["port"]) > 1000
    assert stores["wal1"]["port"] == stores["wal1"]["ref"]


@pytest.mark.parametrize("when", ["first checkpoint", "close"])
def test_store_files_equal_after_checkpoint(stores, when):
    if when == "close":
        a, b = stores["roots"]["port"], stores["roots"]["ref"]
    else:
        a, b = stores["files1"]["port"], stores["files1"]["ref"]
    names = _files(a)
    for prefix in ("catalog.json", "wal.log", "answers.json", "lineage_", "sig_", "view_"):
        assert any(fn.startswith(prefix) for fn in names), prefix
    assert any(fn.endswith(".idx") for fn in names) or when == "first checkpoint"
    _assert_same_files(a, b)


def test_queries_views_cache_and_reuse_equal(stores):
    _same_answers(stores["answers"]["port"], stores["answers"]["ref"])
    st = stores["stats"]["port"]
    assert st == stores["stats"]["ref"]
    assert st["views_materialized"] >= 1 and st["view_hits"] >= 1 and st["cache_hits"] >= 1
    assert stores["reused"]["port"] == stores["reused"]["ref"]
    assert "gen" in stores["reused"]["port"]


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_package_loads_the_others_store(stores, reader):
    writer = "ref" if reader == "port" else "port"
    core, _, kw = PKGS[reader]
    log = core.DSLog.load(stores["roots"][writer], **kw)
    assert _replayed(log) == 0
    names = stores["names"]
    # cold cells: no cached answer, so lazy tables load
    got = [log.prov_query(n[0], n[-1], np.zeros((1, len(log.arrays[n[0]].shape)), np.int64))
           for n in names]
    ref = jcore.DSLog.load(stores["roots"]["ref"])
    want = [ref.prov_query(n[0], n[-1], np.zeros((1, len(ref.arrays[n[0]].shape)), np.int64))
            for n in names]
    _same_answers(got, want)
    assert log.io_stats["tables_loaded"] > 0
    # the persisted answer cache serves the writer's queries
    again = _run_queries(log, _queries(names[:1]))
    _same_answers(again, stores["answers"][writer][: len(again)])


def test_reference_fsck_passes_on_the_ports_store(stores):
    report = fsck.fsck_store(stores["roots"]["port"])
    assert report.ok and report.findings == [], [str(f) for f in report.findings]
    assert report.checked["entries"] > 0 and report.checked["views"] >= 1


def test_port_telemetry_passes_reference_schema(stores):
    with open(os.path.join(stores["roots"]["port"], "telemetry.json")) as f:
        counts = jexport.validate_telemetry(json.load(f))
    assert counts["counters"] > 0 and counts["histograms"] > 0
    core, _, kw = PKGS["port"]
    log = core.DSLog.load(stores["roots"]["port"], **kw)
    assert jexport.validate_telemetry(texport.telemetry_snapshot(log))["counters"] > 0
    assert jexport.parse_prometheus(texport.render_prometheus(log.metrics_snapshot())) > 0


def test_compact_removes_the_same_files(stores, tmp_path):
    removed = {}
    for pkg, (core, _, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        shutil.copytree(stores["roots"][pkg], root)
        log = core.DSLog.open(root, durability="manual", **kw)
        for lid in sorted(log.lineage)[:3]:
            log.drop_lineage(lid)
        removed[pkg] = log.compact()
        log.close()
    assert removed["port"] == removed["ref"] and removed["port"]["files_removed"] > 0
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_autotune_sidecars_cross_load_by_backend(stores):
    tables = {}
    for pkg, (core, _, kw) in PKGS.items():
        for other in PKGS:
            log = core.DSLog.load(stores["roots"][other], **kw)
            tables[(pkg, other)] = log.autotune.to_manifest()["entries"]
    # the twin's table is keyed "np|..." in both packages: each keeps the
    # other's entries, and no entry answers another backend
    for (pkg, other), entries in tables.items():
        for key, rec in entries.items():
            assert key.startswith(rec["backend"] + "|")
    log = tcore.DSLog(device="cpu")
    log.autotune.load_manifest({"version": 1, "entries": {
        "tpu|x": {"backend": "tpu", "bucket": "x", "geometry": [256, 256]}}})
    assert log.autotune.lookup("cuda", "x") is None


# --------------------------------------------------------------------------- #
# Crash recovery
# --------------------------------------------------------------------------- #
def _crashed_stores(tmp_path):
    """Both packages: checkpoint FIRST, log SECOND to the WAL only, crash."""
    roots = {}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        log = core.DSLog.open(root, durability="sync", **kw)
        for wf in FIRST[:2]:
            _ingest(log, C, wf)
        log.checkpoint()
        _ingest(log, C, SECOND[0])
        log.commit()
        log.close(checkpoint=False)
        roots[pkg] = root
    return roots


def _loaded_equal(roots, expect_replayed):
    logs = {pkg: core.DSLog.load(roots[pkg], **kw) for pkg, (core, _, kw) in PKGS.items()}
    t, j = logs["port"], logs["ref"]
    assert _replayed(t) == _replayed(j)
    assert (_replayed(t) > 0) == expect_replayed
    assert sorted(t.lineage) == sorted(j.lineage)
    assert [op.reused for op in t.ops] == [op.reused for op in j.ops]
    names = [[f"{wf}_a0", f"{wf}_a5"] for wf in FIRST[:2] + SECOND[:1]]
    names = [n for n in names if n[-1] in t.arrays]
    cells = [np.zeros((1, len(t.arrays[n[0]].shape)), np.int64) for n in names]
    _same_answers([t.prov_query(n[0], n[-1], c) for n, c in zip(names, cells)],
                  [j.prov_query(n[0], n[-1], c) for n, c in zip(names, cells)])
    return len(t.lineage)


def test_crash_recovery_replays_the_same_store(tmp_path):
    roots = _crashed_stores(tmp_path)
    assert _wal(roots["port"]) == _wal(roots["ref"])
    assert _loaded_equal(roots, expect_replayed=True) == 15


def test_torn_wal_tail_recovers_alike(tmp_path):
    roots = _crashed_stores(tmp_path)
    size = len(_wal(roots["port"]))
    for root in roots.values():
        with open(os.path.join(root, "wal.log"), "r+b") as f:
            f.truncate(size - 7)  # tears the last record
    n = _loaded_equal(roots, expect_replayed=True)
    assert n <= 15
    # a leased open repairs (cuts) the torn tail at the same byte
    for pkg, (core, _, kw) in PKGS.items():
        core.DSLog.open(roots[pkg], durability="manual", **kw).close(checkpoint=False)
    assert _wal(roots["port"]) == _wal(roots["ref"]) and len(_wal(roots["port"])) < size - 7
    for pkg, (core, _, kw) in PKGS.items():
        core.DSLog.open(roots[pkg], durability="manual", **kw).close()  # checkpoint
    _assert_same_files(roots["port"], roots["ref"])


@pytest.mark.parametrize("holder", ["port", "ref"])
def test_writer_lease_blocks_the_other_package(tmp_path, holder):
    core, _, kw = PKGS[holder]
    other = "ref" if holder == "port" else "port"
    ocore, _, okw = PKGS[other]
    error = {"ref": jcommit.LeaseHeldError, "port": tcommit.LeaseHeldError}[other]
    log = core.DSLog.open(str(tmp_path), **kw)
    try:
        with pytest.raises(error):
            ocore.DSLog.open(str(tmp_path), **okw)
    finally:
        log.close()
    ocore.DSLog.open(str(tmp_path), **okw).close()  # released: opens


def test_mark_dirty_is_logged_and_replayed_alike(tmp_path):
    roots = {}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        log = core.DSLog.open(root, durability="manual", **kw)
        _ingest(log, C, "image")
        log.checkpoint()
        e = log.lineage[1]
        e.backward.val_hi[:] = e.backward.val_hi + 0  # an in-place "mutation"
        log.mark_dirty(1)
        log.commit()
        log.close(checkpoint=False)
        roots[pkg] = root
    assert _wal(roots["port"]) == _wal(roots["ref"])
    t = tcore.DSLog.load(roots["port"], device="cpu")
    j = jcore.DSLog.load(roots["ref"])
    assert _replayed(t) == _replayed(j) == 1
    assert t.dirty and j.dirty


# --------------------------------------------------------------------------- #
# Views and the answer cache (tests/test_views.py, on both packages)
# --------------------------------------------------------------------------- #
SIDE = 8
SHAPE = (SIDE, SIDE)


def _chain_ops(C):
    return [C.flip_lineage(SHAPE, 0), C.roll_lineage(SHAPE, 2, 0),
            C.transpose_lineage(SHAPE, (1, 0)), C.identity_lineage(SHAPE),
            C.flip_lineage(SHAPE, 1)]


def _chain(log, C):
    log.define_array("a0", SHAPE)
    for k, rel in enumerate(_chain_ops(C)):
        log.define_array(f"a{k + 1}", SHAPE)
        log.add_lineage(f"a{k}", f"a{k + 1}", rel, op_name=f"op_a{k}")


def _random_dag(log, C, n_ops, seed):
    """tests/test_views.py's random DAG: a chain with a fan-in every third op."""
    ops = [
        lambda rng: C.identity_lineage(SHAPE),
        lambda rng: C.flip_lineage(SHAPE, int(rng.integers(0, 2))),
        lambda rng: C.roll_lineage(SHAPE, int(rng.integers(1, 4)), 0),
        lambda rng: C.transpose_lineage(SHAPE, (1, 0)),
    ]
    rng = np.random.default_rng(seed)
    names = ["a0"]
    log.define_array("a0", SHAPE)
    for k in range(n_ops):
        new = f"a{k + 1}"
        rel = ops[int(rng.integers(0, len(ops)))](rng)
        log.define_array(new, SHAPE)
        log.add_lineage(names[-1], new, rel, op_name=f"op{k}")
        if k % 3 == 2 and len(names) > 2:
            other = names[int(rng.integers(0, len(names) - 1))]
            log.add_lineage(other, new, ops[int(rng.integers(0, len(ops)))](rng),
                            op_name=f"op{k}b")
        names.append(new)
    return names


def test_view_admission_matches_reference():
    logs = {}
    for pkg, (core, C, kw) in PKGS.items():
        logs[pkg] = core.DSLog(**kw)
        _chain(logs[pkg], C)
    rng = np.random.default_rng(3)
    for i in range(10):
        cells = rng.integers(0, SIDE, size=(2, 2))
        _same(logs["port"].prov_query("a5", "a0", cells),
              logs["ref"].prov_query("a5", "a0", cells), f"query {i}")
    for i in range(3):
        cells = rng.integers(0, SIDE, size=(1, 2))
        _same(logs["port"].prov_query("a0", "a5", cells),
              logs["ref"].prov_query("a0", "a5", cells), f"fwd {i}")
    assert _stats(logs["port"]) == _stats(logs["ref"])
    assert logs["port"].io_stats["views_materialized"] == 1
    assert logs["port"].io_stats["view_hits"] >= 5
    assert (logs["port"].planner.plan("a5", ["a0"]).describe()
            == logs["ref"].planner.plan("a5", ["a0"]).describe().replace("tpu", "cuda"))


@pytest.mark.parametrize("n_ops,seed", [(5, 1), (7, 42), (9, 2024)])
def test_views_on_random_dags_match_reference(n_ops, seed):
    logs = {}
    for pkg, (core, C, kw) in PKGS.items():
        logs[pkg] = core.DSLog(**kw)
        names = _random_dag(logs[pkg], C, n_ops, seed)
    src, dst = names[-1], names[0]
    rng = np.random.default_rng(seed + 1)

    def check(tag):
        for i in range(6):
            cells = rng.integers(0, SIDE, size=(int(rng.integers(1, 4)), 2))
            _same(logs["port"].prov_query(src, dst, cells),
                  logs["ref"].prov_query(src, dst, cells), f"{tag} {i}")
        cells = rng.integers(0, SIDE, size=(1, 2))
        _same(logs["port"].prov_query(dst, src, cells),
              logs["ref"].prov_query(dst, src, cells), f"{tag} fwd")
        assert _stats(logs["port"]) == _stats(logs["ref"]), tag

    check("warm-up")
    pair = sorted(logs["ref"].by_pair)[int(rng.integers(0, len(logs["ref"].by_pair)))]
    for log in logs.values():
        log.mark_dirty(log.by_pair[pair][0])
    check("after mark_dirty")
    fanin = [(s, d) for (s, d) in sorted(logs["ref"].by_pair) if s != f"a{int(d[1:]) - 1}"]
    if fanin:
        for log in logs.values():
            log.drop_lineage(log.by_pair[fanin[0]][0])
        check("after drop_lineage")


def test_views_through_crash_recovery_match_reference(tmp_path):
    seed = 11
    roots = {}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        log = core.DSLog.open(root, durability="sync", **kw)
        names = _random_dag(log, C, 6, seed)
        rng = np.random.default_rng(seed)
        for _ in range(6):
            log.prov_query(names[-1], names[0], rng.integers(0, SIDE, size=(2, 2)))
        assert log.views.views
        log.save()
        pair = sorted(log.by_pair)[int(rng.integers(0, len(log.by_pair)))]
        log.mark_dirty(log.by_pair[pair][0])
        log.commit()
        log.close(checkpoint=False)  # crash: the manifest still lists the view
        roots[pkg] = root
    _assert_same_files(roots["port"], roots["ref"])
    t = tcore.DSLog.load(roots["port"], device="cpu")
    j = jcore.DSLog.load(roots["ref"])
    assert not t.views.views and not j.views.views  # replay killed the view
    rng = np.random.default_rng(seed)
    for i in range(4):
        cells = rng.integers(0, SIDE, size=(2, 2))
        _same(t.prov_query(names[-1], names[0], cells),
              j.prov_query(names[-1], names[0], cells), f"post-recovery {i}")
    assert _stats(t) == _stats(j)


def test_view_persistence_roundtrip_matches_reference(tmp_path):
    qs = [np.random.default_rng(10 + i).integers(0, SIDE, size=(2, 2)) for i in range(6)]
    re = {}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        log = core.DSLog(root=root, **kw)
        _chain(log, C)
        for q in qs:
            log.prov_query("a5", "a0", q)
        log.save()
        re[pkg] = core.DSLog.load(root, **kw)
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    for q in (qs[-1], np.array([[0, 0]])):
        _same(re["port"].prov_query("a5", "a0", q), re["ref"].prov_query("a5", "a0", q))
    assert _stats(re["port"]) == _stats(re["ref"])
    assert re["port"].io_stats["cache_hits"] == 1 and re["port"].io_stats["view_hits"] >= 1
    assert re["port"].io_stats["tables_loaded"] == re["ref"].io_stats["tables_loaded"]


def test_compose_tables_matches_reference():
    jt = [jcore.compress(r) for r in _chain_ops(jC)]
    tt = [tcore.compress(r) for r in _chain_ops(tC)]
    want = jviews.compose_route(jt[::-1])
    got = tviews.compose_route(tt[::-1], device="cpu")
    assert got.serialize() == want.serialize()
    with pytest.raises(tviews.CompositionError):
        tviews.compose_tables(tt[0], tcore.compress(tC.identity_lineage((3,))), device="cpu")


# --------------------------------------------------------------------------- #
# Reuse (tests/test_reuse.py, on both packages)
# --------------------------------------------------------------------------- #
def _reuse_stream(log, C):
    """Same-shape repeats (dim), new shapes (gen), a value-dependent op
    (rejected) and a reused reduce answering queries."""
    decisions, calls = [], []

    def reg(op, a, b, in_shape, make, op_args=None, capture=True):
        log.define_array(a, in_shape)
        rel = make()
        log.define_array(b, rel.out_shape)
        calls.append(0)

        def cap():
            calls[-1] += 1
            return {(0, 0): rel}

        rec = log.register_operation(op, [a], [b], capture=cap if capture else None,
                                     op_args=op_args)
        decisions.append((rec.reused, calls[-1]))

    for i in range(3):
        reg("neg", f"a{i}", f"b{i}", (6, 4), lambda: C.identity_lineage((6, 4)))
    for i, shape in enumerate([(9, 5), (3, 7)]):
        reg("neg", f"x{i}", f"y{i}", shape, lambda s=shape: C.identity_lineage(s),
            capture=i == 0)
    rng = np.random.default_rng(0)
    for i in range(2):
        vals = rng.random(16)
        reg("sort", f"s{i}", f"t{i}", (16,), lambda v=vals: C.sort_lineage(v))
    for i in range(3):
        reg("sumax1", f"in{i}", f"out{i}", (4, 3), lambda: C.reduce_lineage((4, 3), 1),
            op_args={"axis": 1})
    return decisions


def test_reuse_decisions_match_reference(tmp_path):
    out = {}
    for pkg, (core, C, kw) in PKGS.items():
        root = str(tmp_path / pkg)
        log = core.DSLog(root=root, reuse_m=1, **kw)
        decisions = _reuse_stream(log, C)
        statuses = {k: log.predictor.status(k) for k in sorted(log.predictor.state)}
        res = log.prov_query(["out2", "in2"], np.array([[1]]))
        log.save()
        reloaded = core.DSLog.load(root, **kw)
        out[pkg] = (decisions, statuses, res, reloaded.predictor.status(sorted(statuses)[0]))
    assert out["port"][0] == out["ref"][0]
    assert [d for d, _ in out["port"][0]].count("dim") >= 2
    assert ("gen", 0) in out["port"][0]
    assert out["port"][1] == out["ref"][1] and "rejected" in out["port"][1].values()
    _same(out["port"][2], out["ref"][2])
    assert out["port"][3] == out["ref"][3]
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_generalize_and_instantiate_match_reference():
    from repro.core import reuse as jreuse
    from repro_torch.core import reuse as treuse

    for make in (lambda C: C.reduce_lineage((4,), 0), lambda C: C.identity_lineage((5, 3))):
        jg = jreuse.generalize(jcore.compress(make(jC)))
        tg = treuse.generalize(tcore.compress(make(tC)))
        assert tg.serialize() == jg.serialize() and tg.is_symbolic
        shapes = ((1,), (9,)) if tg.n_key == 1 else ((7, 2), (7, 2))
        assert (treuse.instantiate(tg, *shapes).serialize()
                == jreuse.instantiate(jg, *shapes).serialize())


# --------------------------------------------------------------------------- #
# The quickstart flow (examples/quickstart.py, at a smaller size)
# --------------------------------------------------------------------------- #
def _quickstart(core, C, kw, root):
    log = core.DSLog(**kw)
    for name, shape in (("X", (64, 16)), ("Y", (64, 16)), ("Z", (64, 4)), ("S", (64,))):
        log.define_array(name, shape)
    rel_y, _ = C.matmul_lineage(64, 16, 4)
    log.register_operation("normalize", ["X"], ["Y"],
                           capture=lambda: {(0, 0): C.identity_lineage((64, 16))})
    log.register_operation("project", ["Y"], ["Z"], capture=lambda: {(0, 0): rel_y})
    log.register_operation("rowsum", ["Z"], ["S"],
                           capture=lambda: {(0, 0): C.reduce_lineage((64, 4), 1)})
    out = [log.storage_bytes(),
           log.prov_query(["S", "Z", "Y", "X"], np.array([[7]])),
           log.prov_query(["X", "Y", "Z", "S"], np.array([[3, 5]])),
           log.prov_query("X", "S", np.array([[3, 5]])),
           log.planner.plan("X", ["S"]).describe().replace("tpu", "cuda")]
    for i, shape in enumerate([(32, 8), (128, 16), (9, 7)]):
        log.define_array(f"A{i}", shape)
        log.define_array(f"B{i}", shape)
        rec = log.register_operation(
            "normalize", [f"A{i}"], [f"B{i}"],
            capture=(lambda s=shape: {(0, 0): C.identity_lineage(s)}) if i < 2 else None,
        )
        out.append(rec.reused)
    with core.DSLog.open(root, **kw) as disk:
        for name, shape in log.arrays.items():
            disk.define_array(name, shape.shape)
        disk.register_operation("normalize", ["X"], ["Y"],
                                capture=lambda: {(0, 0): C.identity_lineage((64, 16))})
        disk.register_operation("project", ["Y"], ["Z"], capture=lambda: {(0, 0): rel_y})
    reloaded = core.DSLog.load(root, **kw)
    out.append(reloaded.prov_query("Z", "Y", np.array([[7, 3]])))
    out.append(reloaded.io_stats["tables_loaded"])
    return out


def test_quickstart_flow_matches_reference(tmp_path):
    got = _quickstart(*PKGS["port"], str(tmp_path / "port"))
    want = _quickstart(*PKGS["ref"], str(tmp_path / "ref"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, jcore.QueryBox):
            _same(g, w)
        else:
            assert g == w
    assert got[-1] == 1 and got[5:8] == [None, "gen", "gen"]
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_open_and_load_without_device_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.DSLog.open(str(tmp_path))
    assert not os.path.exists(tmp_path / "writer.lock")  # nothing was taken
    tcore.DSLog.open(str(tmp_path), device="cpu").close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.DSLog.load(str(tmp_path))
