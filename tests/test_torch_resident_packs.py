"""A table's join side kept packed on the device (``CompressedTable.kernel_pack``)
and handed to ``ops.segmented_range_join_pairs`` as ``r_packs``: the pair
lists equal those of the entry point's own packs and the JAX package's bit
for bit in every layout,
a repeated query builds the pack once and then reuses it, uploading only
its query side, mutation drops the pack, int64 tables never build one, and
``DSLog.prov_query`` still answers as the JAX package does.  All on the
CPU (``device="cpu"``: the kernels' plain versions, ``engine="kernel"``).
"""

import numpy as np
import pytest

import repro.core.capture as jC
import repro.core.catalog as jcat
import repro.core.query as jq
import repro.core.table as jtable
import repro.kernels.ops as jops
import repro_torch.core.capture as tC
import repro_torch.core.catalog as tcat
import repro_torch.core.query as tq
import repro_torch.core.table as ttable
from repro_torch.kernels import ops

SEED = 20240527
PACKS = ("table_packs_built", "table_packs_resident")
ROW_BYTES = ops.LANES * 4


def _tables(nr, l=2, m=2, span=120, seed=0, offset=0):
    """The same random table in both packages, relative value columns
    included (the inverse join's ``value`` side)."""
    r = np.random.default_rng(seed)
    key_lo = r.integers(0, span, (nr, l)) + offset
    key_hi = key_lo + r.integers(0, 4, (nr, l))
    val_lo = r.integers(-3, 0, (nr, m))
    val_hi = val_lo + r.integers(0, 6, (nr, m))
    val_ref = r.integers(-1, l, (nr, m))
    args = ((span + 10 + offset,) * l, (span + 10,) * m, key_lo, key_hi, val_lo, val_hi,
            val_ref)
    return jtable.CompressedTable(*args), ttable.from_reference_arrays(*args)


def _boxes(n, l, seed, span=110, width=12):
    r = np.random.default_rng(seed)
    lo = r.integers(0, span, (n, l))
    return lo, lo + r.integers(0, width, (n, l))


# (table rows, width, side) of each segment, the layout and the block sizes
_CASES = {
    "dense_one": ([(90, 2, "key")], "dense", 256),
    "dense_many": ([(90, 2, "key"), (40, 2, "key"), (70, 2, "value")], "dense", 256),
    "dense_mixed_widths": ([(50, 1, "key"), (80, 3, "value"), (30, 2, "key")], "dense", 256),
    "blockdiag": ([(150, 2, "key"), (40, 2, "value"), (130, 2, "key")], "blockdiag", 64),
    "blockdiag_mixed_widths": ([(150, 3, "key"), (70, 1, "key"), (20, 2, "value")],
                               "blockdiag", 64),
    "value_side": ([(120, 2, "value")], "dense", 256),
    "auto": ([(300, 2, "key"), (200, 2, "key"), (260, 1, "value")], "auto", 64),
    "empty_table_side": ([(0, 2, "key")], "dense", 256),
    "empty_among_many_dense": ([(60, 2, "key"), (0, 3, "key"), (40, 2, "key")], "dense", 256),
    "empty_among_many_blockdiag": ([(60, 2, "key"), (0, 3, "key"), (40, 2, "key")],
                                   "blockdiag", 64),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pairs_with_resident_packs_equal_host_packs(case):
    specs, layout, block = _CASES[case]
    segments, getters = [], []
    for k, (nr, l, side) in enumerate(specs):
        _, table = _tables(nr, l=l, m=l, seed=SEED + k)
        q_lo, q_hi = _boxes(int(20 + 17 * k), l, SEED + 50 + k)
        r_lo, r_hi = table.key_lo, table.key_hi
        if side == "value":
            r_lo, r_hi = table.value_bounds()
        segments.append((q_lo, q_hi, r_lo, r_hi))
        getters.append(lambda t=table, s=side: t.kernel_pack(s, "cpu")[0])
    kw = dict(block_q=block, block_r=block, device="cpu", layout=layout)
    want, winfo = ops.segmented_range_join_pairs(segments, **kw)
    got, ginfo = ops.segmented_range_join_pairs(segments, r_packs=getters, **kw)
    assert ginfo == winfo
    assert layout == "auto" or ginfo["layout"] == layout
    assert len(got) == len(want) == len(segments)
    for (gq, gr), (wq, wr) in zip(got, want):
        assert gq.dtype == wq.dtype == gr.dtype == wr.dtype == np.int64
        assert gq.tobytes() == wq.tobytes() and gr.tobytes() == wr.tobytes()
    assert sum(len(q) for q, _ in want) > 0 or case == "empty_table_side"
    # both launches above run one pipeline: hold them to the JAX package too,
    # whose dense layout raises where every segment's side is empty
    # (ROADMAP.md §3), so that case takes its block-diagonal answer
    ref, rinfo = jops.segmented_range_join_pairs(
        segments, block_q=block, block_r=block, interpret=True,
        layout="blockdiag" if case == "empty_table_side" else layout)
    assert case == "empty_table_side" or rinfo == ginfo
    assert len(ref) == len(got)
    for (gq, gr), (wq, wr) in zip(got, ref):
        assert gq.tobytes() == np.asarray(wq, np.int64).tobytes()
        assert gr.tobytes() == np.asarray(wr, np.int64).tobytes()
    # once resident, a launch uploads the query side alone
    before = ops.h2d_bytes
    again, _ = ops.segmented_range_join_pairs(segments, r_packs=getters, **kw)
    if ginfo["layout"] == "dense":
        q_rows = sum(s[0].shape[0] for s in segments)
    else:
        q_rows = sum(-(-s[0].shape[0] // block) * block for s in segments)
    assert ops.h2d_bytes - before == q_rows * ROW_BYTES
    for (aq, ar), (wq, wr) in zip(again, want):
        assert aq.tobytes() == wq.tobytes() and ar.tobytes() == wr.tobytes()


@pytest.mark.parametrize("layout", ["dense", "blockdiag"])
def test_assembled_r_operand_equals_the_host_pack(layout):
    """The operand made on the device from resident packs is the host
    packer's, lane for lane: segment ids, width padding and the empty pad
    rows (which the pair lists cannot show: extraction drops their pairs)."""
    segments, packs = [], []
    for k, (nr, l) in enumerate([(70, 1), (0, 2), (90, 3), (20, 2)]):
        _, table = _tables(nr, l=l, m=l, seed=SEED + k)
        segments.append((*_boxes(5, l, SEED + k), table.key_lo, table.key_hi))
        packs.append(table.kernel_pack("key", "cpu")[0])
    l_max = 3
    if layout == "blockdiag":
        parts = []
        for s in segments:
            pad = np.zeros((-s[2].shape[0] % 64, ops.LANES), np.int32)
            pad[:, :l_max] = 1  # the empty box: lo = 1, hi = 0
            parts += [ops._pack_boxes(s[2], s[3], l_max), pad]
        want = np.concatenate(parts)
        got = ops._blockdiag_schedule(segments, l_max, 64, 64, packs).r
    else:
        n_attrs = l_max + 1
        parts = []
        for seg, s in enumerate(segments):
            p = ops._pack_boxes(s[2], s[3], n_attrs)
            p[:, l_max] = p[:, n_attrs + l_max] = seg
            parts.append(p)
        want = np.concatenate(parts)
        got = ops._assemble_r(packs, segments, n_attrs, [s[2].shape[0] for s in segments],
                              l_max)
    assert got.dtype == ops.torch.int32 and got.numpy().tobytes() == want.tobytes()


def test_resident_pack_layout_and_its_checks():
    _, table = _tables(33, l=3, seed=SEED)
    pack, built = table.kernel_pack("key", "cpu")
    assert built and tuple(pack.shape) == (33, ops.LANES)
    p = pack.numpy()
    assert np.array_equal(p[:, :3], table.key_lo) and np.array_equal(p[:, 3:6], table.key_hi)
    assert not p[:, 6:].any()
    assert table.kernel_pack("key", "cpu") == (pack, False)
    seg = (*_boxes(5, 3, SEED), table.key_lo, table.key_hi)
    with pytest.raises(ValueError, match="resident packs for"):
        ops.segmented_range_join_pairs([seg, seg], device="cpu", r_packs=[lambda: pack])
    short = (seg[0], seg[1], table.key_lo[:-1], table.key_hi[:-1])
    with pytest.raises(ValueError, match="cannot serve"):
        ops.segmented_range_join_pairs([short], device="cpu", r_packs=[lambda: pack])


def _meter(stats):
    return lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n)


def _requests(mod, tables, n_q):
    """A natural and an inverse join on each table, dense-routed."""
    reqs = []
    for k, table in enumerate(tables):
        l = len(table.key_shape)
        nat = mod.QueryBox(table.key_shape, *_boxes(n_q, l, SEED + 100 + k))
        inv = mod.QueryBox(table.val_shape, *_boxes(n_q, l, SEED + 200 + k))
        reqs.append(mod.JoinRequest([nat], table, inverse=False, path="batched"))
        reqs.append(mod.JoinRequest([inv], table, inverse=True, path="batched"))
    return reqs


def _same(got, want):
    assert got.shape == want.shape
    assert got.lo.tobytes() == want.lo.tobytes() and got.hi.tobytes() == want.hi.tobytes()


@pytest.mark.parametrize("n_tables", [1, 3])
def test_repeated_query_builds_once_then_hits(n_tables):
    pairs = [_tables(60 + 20 * k, seed=SEED + k) for k in range(n_tables)]
    jtabs, ttabs = [p[0] for p in pairs], [p[1] for p in pairs]
    n_segments = 2 * n_tables  # each table's key side and value side
    table_bytes = sum(2 * t.n_rows * ROW_BYTES for t in ttabs)
    want = jq.BatchedJoinExecutor(interpret=True, engine="kernel").run(
        _requests(jq, jtabs, 9))
    stats = {}
    ex = tq.BatchedJoinExecutor(stats=_meter(stats), device="cpu", engine="kernel")
    moved, counts = [], []
    for _ in range(3):
        before = ops.h2d_bytes
        got = ex.run(_requests(tq, ttabs, 9))
        moved.append(ops.h2d_bytes - before)
        counts.append({k: stats.get(k, 0) for k in PACKS})
        for g_list, w_list in zip(got, want):
            for g, w in zip(g_list, w_list):
                _same(g, w)
    assert stats["joins_dense_kernel"] == 3 * n_segments
    assert counts == [
        {"table_packs_built": n_segments, "table_packs_resident": 0},
        {"table_packs_built": n_segments, "table_packs_resident": n_segments},
        {"table_packs_built": n_segments, "table_packs_resident": 2 * n_segments},
    ]
    # after the first launch only the query side moves: the pooled boxes
    q_rows = sum(tq._pool_boxes(r.queries)[0].shape[0] for r in _requests(tq, ttabs, 9))
    assert moved[1] == moved[2] == q_rows * ROW_BYTES
    assert moved[0] == moved[1] + table_bytes


@pytest.mark.parametrize("mutate", ["reassign", "in_place_then_invalidate"])
def test_mutation_drops_the_pack(mutate):
    jt, tt = _tables(80, seed=SEED)
    stats = {}
    ex = tq.BatchedJoinExecutor(stats=_meter(stats), device="cpu", engine="kernel")
    jex = jq.BatchedJoinExecutor(interpret=True, engine="kernel")
    for t in (jt, tt):
        t.invalidate_index()
    ex.run(_requests(tq, [tt], 7))
    assert stats["table_packs_built"] == 2
    for t in (jt, tt):
        if mutate == "reassign":
            t.key_lo = t.key_lo + 5
            t.key_hi = t.key_hi + 7
        else:
            t.key_lo += 5
            t.key_hi[...] += 7
            t.invalidate_index()
    got = ex.run(_requests(tq, [tt], 7))
    assert stats["table_packs_built"] == 4 and stats.get("table_packs_resident", 0) == 0
    assert np.array_equal(tt.kernel_pack("key", "cpu")[0].numpy()[:, 2:4], tt.key_hi)
    want = jex.run(_requests(jq, [jt], 7))
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            _same(g, w)


def test_int64_table_never_builds_a_pack():
    jt, tt = _tables(50, seed=SEED, offset=2**31)
    shape, l = tt.key_shape, len(tt.key_shape)
    lo = _boxes(6, l, SEED)[0] + 2**31
    stats = {}
    got = tq.BatchedJoinExecutor(stats=_meter(stats), device="cpu", engine="kernel").run(
        [tq.JoinRequest([tq.QueryBox(shape, lo, lo + 5)], tt, path="batched")])
    want = jq.BatchedJoinExecutor(interpret=True, engine="kernel").run(
        [jq.JoinRequest([jq.QueryBox(shape, lo, lo + 5)], jt, path="batched")])
    _same(got[0][0], want[0][0])
    assert stats["joins_dense_twin"] == 1 and not set(PACKS) & set(stats)
    assert not any(str(k).startswith("pack_") for k in tt._cache())
    with pytest.raises(ValueError, match="int32"):
        tt.kernel_pack("key", "cpu")


def _image(C, h=32):
    return [
        C.slice_lineage((h, h), (0, 0), (h, h), (2, 2)),
        C.identity_lineage((h // 2, h // 2)),
        C.transpose_lineage((h // 2, h // 2), (1, 0)),
        C.flip_lineage((h // 2, h // 2), 1),
        C.reduce_lineage((h // 2, h // 2), 1),
    ]


def test_prov_query_matches_reference_on_the_image_workflow():
    """Fig 8/9's image pipeline, both query forms, each asked twice: the
    second time every kernel segment's table side is resident."""
    logs = []
    for C, cat, q, kw in ((jC, jcat, jq, {}), (tC, tcat, tq, {"device": "cpu"})):
        log = cat.DSLog(store_forward=True, **kw)
        log.views.enabled = False
        log.planner._executor = q.BatchedJoinExecutor(
            stats=log._bump, tuner=log.autotune, engine="kernel", **kw)
        rels = _image(C)
        names = ["a0"]
        log.define_array("a0", rels[0].in_shape)
        for k, rel in enumerate(rels):
            names.append(f"a{k + 1}")
            log.define_array(names[-1], rel.out_shape)
            log.register_operation(f"op{k}", [names[k]], [names[k + 1]],
                                   capture=lambda r=rel: {(0, 0): r}, reuse=False)
        logs.append(log)
    jlog, tlog = logs
    cells = np.stack(np.unravel_index(np.arange(0, 32 * 32, 37), (32, 32)), axis=1)
    for _ in range(2):
        for merge in (True, False):
            _same(tlog.prov_query(names, cells, merge=merge),
                  jlog.prov_query(names, cells, merge=merge))
            _same(tlog.prov_query(names[::-1], np.array([[3], [9]]), merge=merge),
                  jlog.prov_query(names[::-1], np.array([[3], [9]]), merge=merge))
    stats = tlog.io_stats
    assert stats["table_packs_built"] > 0
    assert stats["table_packs_resident"] >= 3 * stats["table_packs_built"]
    assert stats["table_packs_built"] + stats["table_packs_resident"] == \
        stats["joins_dense_kernel"] > 0
