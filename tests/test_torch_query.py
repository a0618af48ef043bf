"""Port query engine vs the JAX package's: θ-joins, box merging and the
batched executor give the same QueryBox bytes and the same io_stats batch
meters in ``repro.core.query`` (CPU, Pallas interpret mode) and
``repro_torch.core.query`` (``device="cpu"``), engines pinned to
``"kernel"`` and ``"twin"`` (tolerance 0)."""

import numpy as np
import pytest

import repro.core.query as jq
import repro.core.table as jtable
import repro_torch.core.query as tq
import repro_torch.core.table as ttable

SEED = 20240527


def _tables(nr, l=2, m=2, span=200, seed=0):
    """The same random table in both packages (the inverse joins need the
    relative value columns ``val_ref`` this builds)."""
    r = np.random.default_rng(seed)
    key_lo = r.integers(0, span, (nr, l))
    key_hi = key_lo + r.integers(0, 4, (nr, l))
    val_lo = r.integers(-3, 0, (nr, m))
    val_hi = val_lo + r.integers(0, 6, (nr, m))
    val_ref = r.integers(-1, l, (nr, m))
    args = ((span + 10,) * l, (span + 10,) * m, key_lo, key_hi, val_lo, val_hi, val_ref)
    return jtable.CompressedTable(*args), ttable.from_reference_arrays(*args)


def _boxes(shape, n, seed, span=180, width=20):
    r = np.random.default_rng(seed)
    lo = r.integers(0, span, (n, len(shape)))
    hi = lo + r.integers(0, width, (n, len(shape)))
    return jq.QueryBox(shape, lo, hi), tq.QueryBox(shape, lo, hi)


def _same(got, want):
    assert got.shape == want.shape
    assert got.lo.tobytes() == want.lo.tobytes()
    assert got.hi.tobytes() == want.hi.tobytes()


@pytest.mark.parametrize("path", ["auto", "index", "dense"])
@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("nr", [300, 2000])
def test_theta_joins_match_reference(path, merge, nr):
    jt, tt = _tables(nr, seed=SEED + nr)
    for k, inverse in enumerate((False, True)):
        shape = jt.val_shape if inverse else jt.key_shape
        jb, tb = _boxes(shape, 40, SEED + k)
        jfn = jq.theta_join_inverse if inverse else jq.theta_join
        tfn = tq.theta_join_inverse if inverse else tq.theta_join
        _same(tfn(tb, tt, merge=merge, path=path, device="cpu"),
              jfn(jb, jt, merge=merge, path=path))
        jbf = jq.theta_join_inverse_batch if inverse else jq.theta_join_batch
        tbf = tq.theta_join_inverse_batch if inverse else tq.theta_join_batch
        jb2, tb2 = _boxes(shape, 7, SEED + 10 + k)
        for g, w in zip(
            tbf([tb, tb2], tt, merge=merge, path=path, device="cpu"),
            jbf([jb, jb2], jt, merge=merge, path=path),
        ):
            _same(g, w)


def test_query_path_matches_reference():
    jt1, tt1 = _tables(500, seed=1)
    jt2, tt2 = _tables(400, seed=2)
    jb, tb = _boxes(jt1.key_shape, 12, SEED)
    for merge in (True, False):
        want = jq.query_path(jb, [(jt1, False), (jt2, True)], merge=merge)
        got = tq.query_path(tb, [(tt1, False), (tt2, True)], merge=merge, device="cpu")
        _same(got, want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merge_and_canonical_boxes_match_reference(seed):
    jb, tb = _boxes((60, 50, 40), 80, SEED + seed, span=30, width=6)
    _same(tq.merge_boxes(tb), jq.merge_boxes(jb))
    _same(tq.canonical_boxes(tb), jq.canonical_boxes(jb))


def _requests(mod, tables, boxes, merge):
    """Natural and inverse joins over several tables, dense-routed."""
    reqs = []
    for k, (table, (natural, inverse)) in enumerate(zip(tables, boxes)):
        reqs.append(mod.JoinRequest([natural], table, inverse=False, merge=merge, path="batched"))
        reqs.append(mod.JoinRequest([inverse], table, inverse=True, merge=merge, path="batched"))
    return reqs


def _executor_case(seed, n_tables):
    pairs = [_tables(int(40 + 30 * k), seed=seed + k) for k in range(n_tables)]
    j_boxes, t_boxes = [], []
    for k, (jt, _) in enumerate(pairs):
        jn, tn = _boxes(jt.key_shape, 30 + 5 * k, seed + 100 + k)
        ji, ti = _boxes(jt.val_shape, 25, seed + 200 + k)
        j_boxes.append((jn, ji))
        t_boxes.append((tn, ti))
    return [p[0] for p in pairs], [p[1] for p in pairs], j_boxes, t_boxes


@pytest.mark.parametrize("engine", ["kernel", "twin"])
@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("seed,n_tables", [(1, 1), (2, 3), (3, 5)])
def test_executor_matches_reference(engine, merge, seed, n_tables):
    """Same results and the same batch meters.  The frontiers stay under
    the autotuner's threshold, so both packages run the default geometry."""
    jtabs, ttabs, jbox, tbox = _executor_case(SEED + seed, n_tables)
    jstats, tstats = {}, {}

    def meter(stats):
        return lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n)

    jex = jq.BatchedJoinExecutor(stats=meter(jstats), interpret=True, engine=engine)
    tex = tq.BatchedJoinExecutor(stats=meter(tstats), device="cpu", engine=engine)
    want = jex.run(_requests(jq, jtabs, jbox, merge))
    got = tex.run(_requests(tq, ttabs, tbox, merge))
    assert len(got) == len(want)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            _same(g, w)
    # the port also counts each join by its route; every join here is dense
    routes = {k: tstats.pop(k) for k in ("joins_index", "joins_dense_kernel",
                                         "joins_dense_twin") if k in tstats}
    assert routes == {f"joins_dense_{engine}": jstats["joins_packed"]}
    # and each kernel segment's table side by whether it was resident: here
    # every (table, side) is met once, so every pack is built
    packs = {k: tstats.pop(k) for k in ("table_packs_built", "table_packs_resident")
             if k in tstats}
    assert packs == ({"table_packs_built": jstats["joins_packed"]} if engine == "kernel" else {})
    assert tstats == jstats
    assert tstats["batch_tiles_visited"] > 0
    assert tex.measured_waste == jex.measured_waste
    label = lambda s: s.replace("tpu", "cuda")  # noqa: E731
    for backend in ("np:cpu", "cuda"):
        assert tex.geometry_label(backend) == label(jex.geometry_label(
            "tpu" if backend == "cuda" else backend
        ))


@pytest.mark.parametrize("n_attrs", [1, 2, 63, 64, 65])
@pytest.mark.parametrize("int32_ok", [True, False])
@pytest.mark.parametrize("segmented", [True, False])
def test_dense_backend_labels_match_reference(n_attrs, int32_ok, segmented):
    want = jq.dense_backend(n_attrs, int32_ok, segmented=segmented)
    got = tq.dense_backend(n_attrs, int32_ok, segmented=segmented, device="cpu")
    assert got == want.replace("tpu", "cuda")


def test_executor_routes_overflow_to_twin_like_reference():
    """int64 coordinates never reach the kernel pack in either package."""
    jt, tt = _tables(50, seed=SEED)
    for t in (jt, tt):
        t.key_lo = t.key_lo + 2**31
        t.key_hi = t.key_hi + 2**31
    shape = jt.key_shape
    lo = np.random.default_rng(SEED).integers(0, 200, (6, 2)) + 2**31
    jb, tb = jq.QueryBox(shape, lo, lo + 5), tq.QueryBox(shape, lo, lo + 5)
    jstats, tstats = {}, {}
    meter = lambda s: (lambda key, n=1: s.__setitem__(key, s.get(key, 0) + n))  # noqa: E731
    want = jq.BatchedJoinExecutor(stats=meter(jstats), interpret=True, engine="kernel").run(
        [jq.JoinRequest([jb], jt, path="batched")]
    )
    got = tq.BatchedJoinExecutor(stats=meter(tstats), device="cpu", engine="kernel").run(
        [tq.JoinRequest([tb], tt, path="batched")]
    )
    _same(got[0][0], want[0][0])
    # the port also counts the join by its route: the twin, not the kernel
    assert tstats.pop("joins_dense_twin") == 1 and "joins_dense_kernel" not in tstats
    assert tstats == jstats


def test_executor_and_joins_refuse_cuda_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.BatchedJoinExecutor()
    _, tt = _tables(20, seed=SEED)
    _, tb = _boxes(tt.key_shape, 3, SEED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.theta_join(tb, tt)
    with pytest.raises(ValueError, match="engine"):
        tq.BatchedJoinExecutor(device="cpu", engine="pallas")
