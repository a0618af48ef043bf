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
import repro_torch.kernels.range_join as trj
from repro_torch.kernels import ops

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
    # the one lane rule the planner, the per-hop route and the executor ask
    assert trj.fits_lanes(n_attrs, segmented) == (want != "np:wide")
    if want == "np:wide":
        with pytest.raises(ValueError, match="lane capacity"):
            trj.check_lane_capacity(n_attrs, segmented=segmented)
    else:
        trj.check_lane_capacity(n_attrs, segmented=segmented)


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


def _per_cell_tables(side=200, drop=407, seed=SEED):
    """A per-cell 2-D table in both packages: one box of interval length 1
    per cell of a ``side`` x ``side`` array, ``drop`` cells left out (39,593
    rows at the defaults, as the fig 8/9 pipelines' per-cell tables), the
    value the key."""
    r = np.random.default_rng(seed)
    keep = np.sort(r.choice(side * side, side * side - drop, replace=False))
    cells = np.stack(np.unravel_index(keep, (side, side)), axis=1).astype(np.int64)
    zeros = np.zeros_like(cells)
    args = ((side, side), (side, side), cells, cells.copy(), zeros, zeros.copy(),
            np.tile(np.arange(2), (cells.shape[0], 1)))
    return jtable.CompressedTable(*args), ttable.from_reference_arrays(*args)


def _one_cell_frontier(n, side=200, seed=SEED):
    r = np.random.default_rng(seed + n)
    flat = r.choice(side * side, n, replace=False)
    lo = np.stack(np.unravel_index(flat, (side, side)), axis=1).astype(np.int64)
    return lo, lo.copy()


@pytest.mark.parametrize("engine", [None, "kernel", "twin"])
@pytest.mark.parametrize("path", ["index", "auto"])
@pytest.mark.parametrize("inverse", [False, True])
def test_executor_keeps_heavy_index_joins_on_cpu(engine, path, inverse):
    """On ``device="cpu"`` a heavy index join (3,318 one-cell boxes against
    a 39,593-row per-cell table, which a CUDA executor sends to the kernel)
    keeps the reference's route, answers and batch meters."""
    jt, tt = _per_cell_tables()
    lo, hi = _one_cell_frontier(3318)
    jb, tb = jq.QueryBox((200, 200), lo, hi), tq.QueryBox((200, 200), lo, hi)
    jstats, tstats = {}, {}
    meter = lambda s: (lambda key, n=1: s.__setitem__(key, s.get(key, 0) + n))  # noqa: E731
    jex = jq.BatchedJoinExecutor(stats=meter(jstats), interpret=True, engine=engine)
    tex = tq.BatchedJoinExecutor(stats=meter(tstats), device="cpu", engine=engine)
    want = jex.run([jq.JoinRequest([jb], jt, inverse=inverse, merge=False, path=path)])
    got = tex.run([tq.JoinRequest([tb], tt, inverse=inverse, merge=False, path=path)])
    _same(got[0][0], want[0][0])
    assert tstats.pop("joins_index") == 1
    assert tstats == jstats


def test_index_to_kernel_sends_heavy_frontiers_to_the_kernel():
    """With the shipped constants, a 3,318-box one-cell frontier against a
    39,593-row per-cell table costs the host index more than a kernel
    segment; a 10-box frontier does not."""
    _, tt = _per_cell_tables()
    index = tt.key_index()
    nr = tt.n_rows
    assert nr == 39_593
    verdicts = {}
    for n in (3318, 10):
        lo, hi = _one_cell_frontier(n)
        windows = index.probe_windows(lo, hi)
        candidates = index.estimate_candidates(lo, hi, windows)
        pairs = tq._pairs_estimate(windows, nr)
        # the estimate is the pairs' count on a per-cell table, and at most
        # the candidates
        assert pairs == pytest.approx(index.candidate_pairs(lo, hi, windows)[0].size, rel=0.05)
        assert pairs <= candidates
        verdicts[n] = tq.index_to_kernel(candidates, n, nr, windows)
    assert verdicts == {3318: True, 10: False}


def test_heavy_index_join_past_the_memory_room_stays_on_the_index(monkeypatch):
    """A CUDA executor reroutes a heavy join only while its mask fits the
    share of the device's free memory: with less room the join keeps the
    index (run here, on the host), gives the reference's answers and never
    reaches the device."""
    import torch

    _, tt = _per_cell_tables()
    lo, hi = _one_cell_frontier(3318)
    need = tq._mask_bytes(3318, tt.n_rows)
    assert need >= 3318 * tt.n_rows
    free = []

    def short_of_room(device):
        free.append(device)
        return int((need - 1) / tq.KERNEL_MASK_MEMORY_SHARE)

    monkeypatch.setattr(tq, "_device_free_bytes", short_of_room)
    stats = {}
    tex = tq.BatchedJoinExecutor(
        stats=lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n), device="cpu"
    )
    tex._device = torch.device("cuda")  # the route rule of a CUDA executor
    req = lambda: tq.JoinRequest([tq.QueryBox((200, 200), lo, hi)], tt,  # noqa: E731
                                 merge=False, path="index")
    assert tex._index_route(req(), lo, hi, tt.key_lo, tt.key_index, None)[0] == "kernel"
    got = tex.run([req()])
    want = tq.BatchedJoinExecutor(device="cpu").run([req()])
    _same(got[0][0], want[0][0])
    assert stats == {"joins_index": 1}
    assert free == [tex._device]


@pytest.mark.parametrize("case", range(12))
def test_mask_bytes_bound_the_launch_mask(case):
    """The room the rule charges a rerouted join (``_mask_bytes``) is at
    least the mask the launch allocates for it, in whichever layout the
    launch takes for a frontier of such joins."""
    r = np.random.default_rng(SEED + case)
    bq, br = tq.DEFAULT_GEOMETRY
    segs = []
    for _ in range(1 + case % 4):
        nq, nr = (int(x) for x in r.integers(1, 700, 2))
        q_lo = r.integers(0, 50, (nq, 2)).astype(np.int64)
        t_lo = r.integers(0, 50, (nr, 2)).astype(np.int64)
        segs.append((q_lo, q_lo + 1, t_lo, t_lo + 2))
    _, info = ops.segmented_range_join_pairs(segs, block_q=bq, block_r=br, device="cpu")
    nq_all = sum(s[0].shape[0] for s in segs)
    nr_all = sum(s[2].shape[0] for s in segs)
    mask = nq_all * nr_all if info["layout"] == "dense" else info["tiles_visited"] * bq * br
    assert mask <= sum(tq._mask_bytes(s[0].shape[0], s[2].shape[0]) for s in segs)


@pytest.mark.parametrize("wide", ["table", "query"])
def test_heavy_index_join_past_int32_stays_on_the_index(wide):
    """A CUDA executor never sends a join whose bounds leave the int32
    range to the kernel: the join keeps the index (run here, on the host,
    where it does not touch the device), while the same join in range would
    go to the kernel."""
    import torch

    _, tt = _per_cell_tables()
    lo, hi = _one_cell_frontier(3318)
    stats = {}
    tex = tq.BatchedJoinExecutor(
        stats=lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n), device="cpu"
    )
    tex._device = torch.device("cuda")  # the route rule of a CUDA executor
    req = tq.JoinRequest([tq.QueryBox((200, 200), lo, hi)], tt, merge=False, path="index")
    assert tex._index_route(req, lo, hi, tt.key_lo, tt.key_index, None)[0] == "kernel"
    if wide == "table":
        _, far = _per_cell_tables()
        far.key_lo, far.key_hi = far.key_lo + 2**31, far.key_hi + 2**31
        lo, hi = lo + 2**31, hi + 2**31
        table = far
    else:
        hi = hi.copy()
        hi[0, 1] = 2**31
        table = tt
    got = tex.run([tq.JoinRequest([tq.QueryBox((200, 200), lo, hi)], table, merge=False,
                                  path="index")])
    want = tq.BatchedJoinExecutor(device="cpu").run(
        [tq.JoinRequest([tq.QueryBox((200, 200), lo, hi)], table, merge=False, path="index")])
    _same(got[0][0], want[0][0])
    assert stats == {"joins_index": 1}
