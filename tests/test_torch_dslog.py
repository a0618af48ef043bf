"""The port's whole slice vs the JAX package: DSLog ingest and both query
forms over the fig 8/9 workflows and the accel DAG, at small sizes, with
``merge`` and ``batched`` each on and off; plus the port's guards (no JAX,
no ``repro`` import, no hidden CPU fallback).

Inputs are made from numpy seeds and handed to both packages; answers and
stored tables are compared as bytes (tolerance 0).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.capture as jC
import repro.core.catalog as jcat
import repro.core.query as jq
import repro.core.relation as jrel
import repro_torch.core.capture as tC
import repro_torch.core.catalog as tcat
import repro_torch.core.query as tq
import repro_torch.core.relation as trel

ROOT = Path(__file__).resolve().parents[1]
SEED = 20240527
BATCH_METERS = (
    "kernel_launches", "joins_packed", "batch_rows", "batch_rows_padded",
    "batch_tiles_visited", "batch_tiles_skipped",
)


# --------------------------------------------------------------------------- #
# Workflows (benchmarks/fig89_query.py shapes, cut to test size)
# --------------------------------------------------------------------------- #
def _image(C, side=32):
    h = side
    return [
        C.slice_lineage((h, h), (0, 0), (h, h), (2, 2)),
        C.identity_lineage((h // 2, h // 2)),
        C.transpose_lineage((h // 2, h // 2), (1, 0)),
        C.flip_lineage((h // 2, h // 2), 1),
        C.reduce_lineage((h // 2, h // 2), 1),
    ]


def _relational(C, n=500):
    rng = np.random.default_rng(3)
    join_l, _ = C.inner_join_lineage(
        rng.integers(0, n // 2, n), rng.integers(0, n // 2, n // 2), 3, 2
    )
    n_out = join_l.out_shape[0]
    return [
        join_l,
        C.identity_lineage(join_l.out_shape),
        C.reduce_lineage(join_l.out_shape, 1),
        C.identity_lineage((n_out,)),
        C.identity_lineage((n_out,)),
    ]


def _resnet(C, side=16):
    s = side
    return [
        C.conv2d_lineage(s, s, 3, 3),
        C.identity_lineage((s - 2, s - 2)),
        C.conv2d_lineage(s - 2, s - 2, 3, 3),
        C.identity_lineage((s - 4, s - 4)),
        C.conv2d_lineage(s - 4, s - 4, 3, 3),
        C.identity_lineage((s - 6, s - 6)),
        C.reduce_lineage((s - 6, s - 6), (0, 1)),
    ]


def _random(C, seed, n_ops=5, n_cells=400):
    ops = [
        lambda shape, rng: C.identity_lineage(shape),
        lambda shape, rng: C.flip_lineage(shape, 0),
        lambda shape, rng: C.roll_lineage(shape, int(rng.integers(1, 5)), 0),
        lambda shape, rng: C.transpose_lineage(shape, tuple(reversed(range(len(shape))))),
        lambda shape, rng: C.reshape_lineage(shape, (int(np.prod(shape)),)),
        lambda shape, rng: C.sort_lineage(rng.random(shape), axis=-1),
    ]
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_cells))
    shape, rels = (side, side), []
    for _ in range(n_ops):
        rel = ops[int(rng.integers(0, len(ops)))](shape, rng)
        rels.append(rel)
        shape = rel.out_shape
    return rels


WORKFLOWS = {
    "image": _image,
    "relational": _relational,
    "resnet": _resnet,
    "random_s0": lambda C: _random(C, 0),
    "random_s1": lambda C: _random(C, 1),
}


def _ingest(store, rels, prefix):
    names = [f"{prefix}0"]
    store.define_array(names[0], rels[0].in_shape)
    for k, rel in enumerate(rels):
        names.append(f"{prefix}{k + 1}")
        store.define_array(names[-1], rel.out_shape)
        store.register_operation(
            f"op{k}", [names[k]], [names[k + 1]],
            capture=lambda r=rel: {(0, 0): r}, reuse=False,
        )
    return names


def _stores(workflow):
    jrels, trels = WORKFLOWS[workflow](jC), WORKFLOWS[workflow](tC)
    jlog = jcat.DSLog(store_forward=True)
    jlog.views.enabled = False  # compare planning engines, not the answer cache
    tlog = tcat.DSLog(store_forward=True, device="cpu")
    names = _ingest(jlog, jrels, "a")
    assert _ingest(tlog, trels, "a") == names
    return jlog, tlog, names, trels


def _same(got, want):
    assert got.shape == want.shape
    assert got.lo.tobytes() == want.lo.tobytes()
    assert got.hi.tobytes() == want.hi.tobytes()


def _oracle(rels, cells):
    cur = np.ravel_multi_index(cells.T, rels[0].in_shape)
    for rel in rels:
        in_r = np.ravel_multi_index(rel.in_idx.T, rel.in_shape)
        out_r = np.ravel_multi_index(rel.out_idx.T, rel.out_shape)
        cur = np.unique(out_r[np.isin(in_r, cur)])
    return set(cur.tolist())


def _pin_kernel_engine(store, mod):
    """Pin a store's batched executor to the segmented kernel path."""
    kw = {"device": "cpu"} if mod is tq else {}
    store.planner._executor = mod.BatchedJoinExecutor(
        stats=store._bump, tuner=store.autotune, engine="kernel", **kw
    )


# --------------------------------------------------------------------------- #
# Whole slice: ingest + both query forms
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("workflow", sorted(WORKFLOWS))
def test_workflow_tables_and_answers_match_reference(workflow):
    jlog, tlog, names, trels = _stores(workflow)
    for lid, je in jlog.lineage.items():
        te = tlog.lineage[lid]
        assert te.backward.serialize() == je.backward.serialize()
        assert te.forward.serialize() == je.forward.serialize()
    assert tlog.storage_bytes() == jlog.storage_bytes()
    n_cells = int(np.prod(trels[0].in_shape))
    for sel in (0.001, 0.01, 0.1):
        k = max(1, int(n_cells * sel))
        cells = np.stack(np.unravel_index(np.arange(k), trels[0].in_shape), axis=1)
        for merge in (True, False):
            for batched in (True, False):
                kw = dict(merge=merge, batched=batched)
                want = jlog.prov_query(names, cells, **kw)
                got = tlog.prov_query(names, cells, **kw)
                _same(got, want)
                _same(
                    tlog.prov_query(names[0], names[-1], cells, **kw),
                    jlog.prov_query(names[0], names[-1], cells, **kw),
                )
                if merge:
                    flat = np.ravel_multi_index(got.cells().T, got.shape)
                    assert set(flat.tolist()) == _oracle(trels, cells)
    jm, tm = dict(jlog.io_stats), dict(tlog.io_stats)
    assert {k: tm[k] for k in BATCH_METERS} == {k: jm[k] for k in BATCH_METERS}


@pytest.mark.parametrize("workflow", ["image", "resnet", "random_s1"])
def test_kernel_engine_matches_reference(workflow):
    """engine="kernel": the reference's Pallas kernels (interpret mode) vs
    the port's plain PyTorch versions, through the whole query path."""
    jlog, tlog, names, trels = _stores(workflow)
    _pin_kernel_engine(jlog, jq)
    _pin_kernel_engine(tlog, tq)
    n_cells = int(np.prod(trels[0].in_shape))
    cells = np.stack(
        np.unravel_index(np.arange(max(1, n_cells // 100)), trels[0].in_shape), axis=1
    )
    for merge in (True, False):
        _same(tlog.prov_query(names, cells, merge=merge),
              jlog.prov_query(names, cells, merge=merge))
        _same(tlog.prov_query(names[0], names[-1], cells, merge=merge),
              jlog.prov_query(names[0], names[-1], cells, merge=merge))
    assert tlog.io_stats["kernel_launches"] == jlog.io_stats["kernel_launches"] > 0


def _accel_dag(DSLog, LineageRelation, kw, shape=(24, 22), branches=10, hops=2):
    rng = np.random.default_rng(0)
    store = DSLog(store_forward=True, **kw)
    store.define_array("src", shape)
    store.define_array("out", shape)
    n = int(np.prod(shape))
    cells = np.stack(np.unravel_index(np.arange(n), shape), axis=1).astype(np.int64)
    for b in range(branches):
        prev = "src"
        for h in range(hops + 1):
            name = "out" if h == hops else f"b{b}h{h}"
            if h < hops:
                store.define_array(name, shape)
            rel = LineageRelation(shape, shape, cells, cells[rng.permutation(n)])
            store.add_lineage(prev, name, rel.canonical())
            prev = name
    return store


def test_accel_dag_matches_reference():
    jlog = _accel_dag(jcat.DSLog, jrel.LineageRelation, {})
    jlog.views.enabled = False
    tlog = _accel_dag(tcat.DSLog, trel.LineageRelation, {"device": "cpu"})
    rng = np.random.default_rng(7)
    flat = rng.choice(24 * 22, size=192, replace=False)
    cells = np.stack(np.unravel_index(flat, (24, 22)), axis=1)
    for merge in (True, False):
        for batched in (False, True):
            kw = dict(merge=merge, batched=batched)
            _same(tlog.prov_query("src", "out", cells, **kw),
                  jlog.prov_query("src", "out", cells, **kw))
        path = ["src", "b3h0", "b3h1", "out"]
        _same(tlog.prov_query(path, cells, merge=merge),
              jlog.prov_query(path, cells, merge=merge))
    for multi in (["b0h1", "out"], ("out",)):
        got = tlog.prov_query("src", multi, cells)
        want = jlog.prov_query("src", multi, cells)
        assert set(got) == set(want)
        for name in got:
            _same(got[name], want[name])
    jm, tm = dict(jlog.io_stats), dict(tlog.io_stats)
    assert {k: tm[k] for k in BATCH_METERS} == {k: jm[k] for k in BATCH_METERS}
    assert tm["batch_tiles_visited"] > 0
    # the kernel engine packs each 10-branch wave; the reference tunes its
    # geometry by timing (the port launches at a fixed one), so only the
    # answers are compared
    _pin_kernel_engine(tlog, tq)
    _same(tlog.prov_query("src", "out", cells),
          jlog.prov_query("src", "out", cells, batched=False))
    assert tlog.io_stats["batch_tiles_visited"] > tm["batch_tiles_visited"]


def test_plan_describe_and_trace_match_reference():
    jlog, tlog, names, trels = _stores("image")
    cells = np.array([[0, 0], [3, 5]])
    jplan = jlog.planner.plan_path(names)
    tplan = tlog.planner.plan_path(names)
    assert tplan.describe() == jplan.describe().replace("tpu", "cuda")
    want = jlog.prov_query(names[0], names[-1], cells)
    got, trace = tlog.prov_query(names[0], names[-1], cells, trace=True)
    _same(got, want)
    assert {"plan", "execute"} <= trace.kinds()
    assert tlog.metrics_snapshot()["registry"] == "dslog"


# --------------------------------------------------------------------------- #
# Guards
# --------------------------------------------------------------------------- #
def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops, repro_torch.obs\n"
        "import repro_torch.kernels.range_join, repro_torch.kernels._build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_smoke_script_import_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (path, mod)


def test_dslog_without_gpu_raises_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: DSLog() runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcat.DSLog()
    assert tcat.DSLog(device="cpu").device.type == "cpu"


def test_unported_surface_raises_naming_the_roadmap():
    log = tcat.DSLog(device="cpu")
    calls = [
        lambda: tcat.DSLog.open("x"), lambda: tcat.DSLog.load("x"), log.save,
        log.commit, log.checkpoint, lambda: log.mark_dirty(0), log.compact,
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    log.define_array("a", (4,))
    log.define_array("b", (4,))
    rel = tC.identity_lineage((4,))
    for reuse in (None, True):
        with pytest.raises(NotImplementedError, match="reuse"):
            log.register_operation("id", ["a"], ["b"], capture=lambda: {(0, 0): rel},
                                   reuse=reuse)
    assert log.views is None and not log.lineage


def test_register_operation_rolls_back_on_cycle():
    log = tcat.DSLog(device="cpu")
    rel = tC.identity_lineage((4,))
    log.register_operation("f", ["a"], ["b"], capture=lambda: {(0, 0): rel}, reuse=False)
    from repro_torch.core.graph import CycleError

    with pytest.raises(CycleError):
        log.register_operation(
            "g", ["b", "x"], ["a"],
            capture=lambda: {(0, 1): rel, (0, 0): rel}, reuse=False,
        )
    assert len(log.lineage) == 1 and len(log.ops) == 1


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: the smoke run would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            env=env, cwd=where, timeout=120,
        )
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
