"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA GPU and skips without one: the CUDA kernels
have no CPU mode.  This file imports no JAX (the GPU machine has none), so
it runs there with::

    python -m pytest -m gpu tests/test_torch_gpu.py

The plain PyTorch versions these compare against are themselves held
against the JAX package's Pallas kernels on the CPU in
``test_torch_kernels.py``; integer outputs are compared exactly.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.core import capture as C
from repro_torch.kernels import ops
from repro_torch.kernels import range_join as rj
from repro_torch.kernels import ref
from repro_torch.kernels import run_boundary as rb

SEED = 20240527
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _packed(rng, n, n_attrs, coord=6, width=5):
    p = np.zeros((n, 128), np.int32)
    lo = rng.integers(0, coord, (n, n_attrs))
    p[:, :n_attrs] = lo
    p[:, n_attrs : 2 * n_attrs] = lo + rng.integers(0, width, (n, n_attrs))
    return p


# around the kernel's 64 x 256 block tile and its 16-byte stores, and each
# width around its four-attribute passes
_MASK_EDGES = (1, 63, 64, 65, 255, 256, 257, 1000)
_MASK_CASES = [
    (255, 257, 1), (256, 256, 2), (1, 1, 3), (33, 1000, 9), (300, 200, 64), (0, 7, 2),
]
_MASK_CASES += [(nq, nr, 1) for nq in _MASK_EDGES for nr in _MASK_EDGES
                if (nq, nr, 1) not in _MASK_CASES]
_MASK_CASES += [(65, 1000, a) for a in (1, 2, 4, 8, 9, 16, 17, 63, 64)]


@pytest.mark.parametrize("nq,nr,n_attrs", _MASK_CASES)
def test_mask_kernel_equals_plain(cuda_device, nq, nr, n_attrs):
    rng = np.random.default_rng(SEED + n_attrs)
    q = torch.from_numpy(_packed(rng, nq, n_attrs)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, nr, n_attrs)).to(cuda_device)
    before = rj.range_join_mask.launches
    got = rj.range_join_mask(q, r, n_attrs=n_attrs)
    torch.cuda.synchronize()
    # a zero-sized mask is never launched (an empty grid is invalid)
    assert rj.range_join_mask.launches == before + (1 if nq and nr else 0)
    assert torch.equal(got, ref.range_join_mask_ref(q, r, n_attrs))


def _spanning(rng, n, n_attrs, seg=None):
    """Boxes that all hold 0 and 1 (lo <= 0, hi >= 1), so a row past the
    operands staged as zeros would overlap every box; ``seg`` puts a
    segment id in the last attribute (lo = hi), as the segmented layout
    does."""
    p = np.zeros((n, 128), np.int32)
    p[:, :n_attrs] = -rng.integers(0, 4, (n, n_attrs))
    p[:, n_attrs : 2 * n_attrs] = 1 + rng.integers(0, 4, (n, n_attrs))
    if seg is not None:
        p[:, n_attrs - 1] = p[:, 2 * n_attrs - 1] = seg
    return p


@pytest.mark.parametrize("nq,nr,n_attrs,segmented", [
    (65, 257, 1, False), (63, 1000, 4, False), (129, 300, 17, False),
    (65, 257, 2, True), (200, 513, 17, True), (70, 300, 64, True),
])
def test_mask_kernel_spanning_boxes(cuda_device, nq, nr, n_attrs, segmented):
    rng = np.random.default_rng(SEED + nq + nr + n_attrs)
    seg_q = np.sort(rng.integers(0, 3, nq)) if segmented else None
    seg_r = np.sort(rng.integers(0, 3, nr)) if segmented else None
    q = torch.from_numpy(_spanning(rng, nq, n_attrs, seg_q)).to(cuda_device)
    r = torch.from_numpy(_spanning(rng, nr, n_attrs, seg_r)).to(cuda_device)
    got = rj.range_join_mask(q, r, n_attrs=n_attrs)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.range_join_mask_ref(q, r, n_attrs))


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("nq,nr", [(65, 1000), (64, 257), (1, 255)])
def test_mask_kernel_stores_stay_in_bounds(cuda_device, offset, nq, nr):
    """A raw launch into an output at every alignment writes exactly the
    mask's bytes, at the store width that alignment allows."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(SEED + offset + nr)
    q = torch.from_numpy(_spanning(rng, nq, 2)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, nr, 2)).to(cuda_device)
    buf = torch.full((nq * nr + 64,), 0xEE, dtype=torch.uint8, device=cuda_device)
    start = 16 + offset
    err = _build.load().rj_range_join_mask(
        q.data_ptr(), r.data_ptr(), buf[start:].data_ptr(), nq, nr, 2,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check_launch(err, "range_join_mask")
    torch.cuda.synchronize()
    want = ref.range_join_mask_ref(q, r, 2).reshape(-1)
    assert torch.equal(buf[start : start + nq * nr], want)
    assert bool((buf[:start] == 0xEE).all()) and bool((buf[start + nq * nr :] == 0xEE).all())


@pytest.mark.parametrize("bq,br", [(64, 64), (128, 128), (256, 256), (64, 256)])
def test_tile_kernel_equals_plain(cuda_device, bq, br):
    rng = np.random.default_rng(SEED + bq)
    q = torch.from_numpy(_packed(rng, 3 * bq, 2, coord=40)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, 5 * br, 2, coord=40)).to(cuda_device)
    # the wrapper takes the schedule on the host; the plain version indexes
    # on the card
    tq = torch.from_numpy(rng.integers(0, 3, 11).astype(np.int32))
    tr = torch.from_numpy(rng.integers(0, 5, 11).astype(np.int32))
    before = rj.range_join_tile_masks.launches
    got = rj.range_join_tile_masks(q, r, tq, tr, n_attrs=2, block_q=bq, block_r=br)
    torch.cuda.synchronize()
    assert rj.range_join_tile_masks.launches == before + 1
    want = ref.range_join_tile_masks_ref(
        q, r, tq.to(cuda_device), tr.to(cuda_device), 2, bq, br
    )
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="host"):
        rj.range_join_tile_masks(q, r, tq.to(cuda_device), tr.to(cuda_device),
                                 n_attrs=2, block_q=bq, block_r=br)


def _tile_operands(rng, n_attrs, bq, br, nqb, nrb, pads):
    """Packed operands of ``nqb`` q and ``nrb`` r blocks whose last ``pads``
    rows are the host's pad rows (lo = 1, hi = 0); the real rows alternate
    between boxes that hold 0 and 1 (they overlap the pads) and ordinary
    ones."""
    parts = []
    for n in (nqb * bq, nrb * br):
        p = _spanning(rng, n, n_attrs)
        plain = _packed(rng, n, n_attrs)
        p[1::2] = plain[1::2]
        p[n - pads :] = 0
        p[n - pads :, :n_attrs] = 1
        parts.append(p)
    return parts


# each width around the four-attribute passes, at block sizes that take
# each of the kernel's block tiles (64 q x 256, 128 or 64 r rows) and ragged
# ones
_TILE_WIDTHS = (1, 2, 3, 4, 5, 8, 9, 17, 63, 64)
_TILE_SIZES = ((32, 32), (64, 64), (64, 128), (64, 256), (128, 128), (256, 64), (256, 128),
               (256, 256), (96, 160))


@pytest.mark.parametrize("bq,br", _TILE_SIZES)
@pytest.mark.parametrize("n_attrs", _TILE_WIDTHS)
def test_tile_kernel_widths_sizes_and_pad_rows(cuda_device, n_attrs, bq, br):
    rng = np.random.default_rng(SEED + 7 * n_attrs + bq + br)
    q, r = (torch.from_numpy(p).to(cuda_device)
            for p in _tile_operands(rng, n_attrs, bq, br, 2, 3, pads=5))
    # every block pair once, then repeats
    tq = np.concatenate([np.repeat(np.arange(2), 3), rng.integers(0, 2, 5)]).astype(np.int32)
    tr = np.concatenate([np.tile(np.arange(3), 2), rng.integers(0, 3, 5)]).astype(np.int32)
    tq, tr = torch.from_numpy(tq), torch.from_numpy(tr)
    got = rj.range_join_tile_masks(q, r, tq, tr, n_attrs=n_attrs, block_q=bq, block_r=br)
    torch.cuda.synchronize()
    want = ref.range_join_tile_masks_ref(
        q, r, tq.to(cuda_device), tr.to(cuda_device), n_attrs, bq, br
    )
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("n_tiles,bq,br,n_attrs", [
    (1, 256, 256, 2), (1, 96, 160, 5), (700, 64, 64, 2), (700, 64, 64, 9), (2000, 256, 256, 4),
])
def test_tile_kernel_one_tile_and_many_waves(cuda_device, n_tiles, bq, br, n_attrs):
    """T = 1, and T past one wave of the card (where blocks take strips of
    q sub-tiles)."""
    rng = np.random.default_rng(SEED + n_tiles + n_attrs)
    q = torch.from_numpy(_packed(rng, 4 * bq, n_attrs, coord=40)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, 5 * br, n_attrs, coord=40)).to(cuda_device)
    tq = torch.from_numpy(rng.integers(0, 4, n_tiles).astype(np.int32))
    tr = torch.from_numpy(rng.integers(0, 5, n_tiles).astype(np.int32))
    got = rj.range_join_tile_masks(q, r, tq, tr, n_attrs=n_attrs, block_q=bq, block_r=br)
    torch.cuda.synchronize()
    want = ref.range_join_tile_masks_ref(
        q, r, tq.to(cuda_device), tr.to(cuda_device), n_attrs, bq, br
    )
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("bq,br", [(64, 256), (96, 160), (32, 32), (128, 128), (64, 128),
                                   (256, 64)])
def test_tile_kernel_stores_stay_in_bounds(cuda_device, offset, bq, br):
    """A raw launch into an output at every alignment writes exactly the
    tiles' bytes, at the store width the alignment and block_r allow."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(SEED + offset + br)
    q, r = (torch.from_numpy(p).to(cuda_device)
            for p in _tile_operands(rng, 2, bq, br, 2, 2, pads=3))
    tq = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32, device=cuda_device)
    tr = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32, device=cuda_device)
    n = 5 * bq * br
    buf = torch.full((n + 64,), 0xEE, dtype=torch.uint8, device=cuda_device)
    start = 16 + offset
    err = _build.load().rj_range_join_tile_masks(
        q.data_ptr(), r.data_ptr(), tq.data_ptr(), tr.data_ptr(), buf[start:].data_ptr(),
        5, bq, br, 2, torch.cuda.current_stream().cuda_stream,
    )
    _build.check_launch(err, "range_join_tile_masks")
    torch.cuda.synchronize()
    want = ref.range_join_tile_masks_ref(q, r, tq, tr, 2, bq, br).reshape(-1)
    assert torch.equal(buf[start : start + n], want)
    assert bool((buf[:start] == 0xEE).all()) and bool((buf[start + n :] == 0xEE).all())


@pytest.mark.parametrize("layout", ["dense", "blockdiag"])
def test_segmented_pairs_on_card_equal_cpu(cuda_device, layout):
    rng = np.random.default_rng(SEED)
    segs = []
    for l in (1, 2, 3, 2):
        nq, nr = int(rng.integers(50, 300)), int(rng.integers(50, 300))
        q_lo, r_lo = rng.integers(0, 60, (nq, l)), rng.integers(0, 60, (nr, l))
        segs.append((q_lo, q_lo + rng.integers(0, 6, (nq, l)),
                     r_lo, r_lo + rng.integers(0, 6, (nr, l))))
    want, winfo = ops.segmented_range_join_pairs(segs, 64, 128, device="cpu", layout=layout)
    got, ginfo = ops.segmented_range_join_pairs(segs, 64, 128, device=cuda_device,
                                                layout=layout)
    assert ginfo == winfo
    for (gq, gr), (wq, wr) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)
    # the per-hop entry point: the same pipeline's one-segment dense call
    for s, (wq, wr) in zip(segs, want):
        gq, gr = ops.range_join_pairs(*s, device=cuda_device)
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("layout,widths", [
    ("dense", (2,)), ("dense", (1, 3, 2)), ("blockdiag", (2,)), ("blockdiag", (1, 3, 2)),
])
def test_resident_packs_on_card_equal_cpu_and_stay_unchanged(cuda_device, layout, widths):
    """Segments whose table side is a resident pack on the card give the
    CPU's host-packed pair lists, and 50 launches leave the packs' bytes as
    they were (the kernels never write their operands)."""
    rng = np.random.default_rng(SEED)
    segs, tables = [], []
    for l in widths:
        nq, nr = int(rng.integers(50, 300)), int(rng.integers(200, 700))
        q_lo, r_lo = rng.integers(0, 60, (nq, l)), rng.integers(0, 60, (nr, l))
        r_hi = r_lo + rng.integers(0, 6, (nr, l))
        tables.append(core.CompressedTable(
            (70,) * l, (70,) * l, r_lo, r_hi, r_lo, r_hi, np.full((nr, l), -1)))
        segs.append((q_lo, q_lo + rng.integers(0, 6, (nq, l)), r_lo, r_hi))
    want, winfo = ops.segmented_range_join_pairs(segs, 64, 128, device="cpu", layout=layout)
    getters = [lambda t=t: t.kernel_pack("key", cuda_device)[0] for t in tables]
    packs = [get() for get in getters]
    assert all(p.device.type == "cuda" for p in packs)
    before = [p.clone() for p in packs]
    for _ in range(50):
        got, ginfo = ops.segmented_range_join_pairs(segs, 64, 128, device=cuda_device,
                                                    layout=layout, r_packs=getters)
        assert ginfo == winfo
        for (gq, gr), (wq, wr) in zip(got, want):
            np.testing.assert_array_equal(gq, wq)
            np.testing.assert_array_equal(gr, wr)
    torch.cuda.synchronize()
    assert all(t.kernel_pack("key", cuda_device)[0] is p for t, p in zip(tables, packs))
    assert all(torch.equal(p, b) for p, b in zip(packs, before))


@pytest.mark.parametrize("rels", [
    [C.slice_lineage((64, 64), (0, 0), (64, 64), (2, 2)), C.identity_lineage((32, 32)),
     C.transpose_lineage((32, 32), (1, 0)), C.reduce_lineage((32, 32), 1)],
    [C.conv2d_lineage(32, 32, 3, 3), C.identity_lineage((30, 30)),
     C.conv2d_lineage(30, 30, 3, 3)],
])
def test_dslog_on_card_equals_cpu(cuda_device, rels):
    stores = [core.DSLog(device="cpu"), core.DSLog(device=cuda_device)]
    for store in stores:
        store.define_array("a0", rels[0].in_shape)
        for k, rel in enumerate(rels):
            store.define_array(f"a{k + 1}", rel.out_shape)
            store.register_operation(f"op{k}", [f"a{k}"], [f"a{k + 1}"],
                                     capture=lambda r=rel: {(0, 0): r}, reuse=False)
    names = [f"a{k}" for k in range(len(rels) + 1)]
    cells = np.stack(np.unravel_index(np.arange(300), rels[0].in_shape), axis=1)
    before = rj.range_join_mask.launches + rj.range_join_tile_masks.launches
    for merge in (True, False):
        for args in ((names, cells), (names[0], names[-1], cells)):
            want = stores[0].prov_query(*args, merge=merge)
            got = stores[1].prov_query(*args, merge=merge)
            assert got.lo.tobytes() == want.lo.tobytes()
            assert got.hi.tobytes() == want.hi.tobytes()
    assert rj.range_join_mask.launches + rj.range_join_tile_masks.launches > before


def _per_cell_table(side=200, drop=407):
    """One box of interval length 1 per cell of a ``side`` x ``side`` array,
    ``drop`` cells left out (39,593 rows at the defaults), the value the key."""
    rng = np.random.default_rng(SEED)
    keep = np.sort(rng.choice(side * side, side * side - drop, replace=False))
    cells = np.stack(np.unravel_index(keep, (side, side)), axis=1).astype(np.int64)
    zeros = np.zeros_like(cells)
    return core.CompressedTable((side, side), (side, side), cells, cells.copy(), zeros,
                                zeros.copy(), np.tile(np.arange(2), (cells.shape[0], 1)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_boxes,rerouted", [(3318, True), (10, False)])
def test_heavy_index_join_runs_on_the_card(cuda_device, monkeypatch, inverse, n_boxes,
                                           rerouted):
    """An index-routed join of 3,318 one-cell boxes against a 39,593-row
    per-cell table runs as a kernel segment on a CUDA executor: its pairs
    are ``IntervalIndex.candidate_pairs``' in the same order, its answers
    the index route's, and ``joins_index_to_kernel`` counts it.  A 10-box
    frontier keeps the index."""
    import repro_torch.core.query as tq

    table = _per_cell_table()
    rng = np.random.default_rng(SEED + n_boxes)
    lo = np.stack(np.unravel_index(rng.choice(40_000, n_boxes, replace=False), (200, 200)),
                  axis=1).astype(np.int64)
    req = lambda: tq.JoinRequest([tq.QueryBox((200, 200), lo, lo.copy())], table,  # noqa: E731
                                 inverse=inverse, merge=False, path="index")
    want = tq.BatchedJoinExecutor(device="cpu").run([req()])
    seen, finalize = [], tq._finalize_batch

    def spy(queries, table, inverse, u_lo, u_hi, inv, ui, ri, merge):
        seen.append((u_lo, u_hi, ui, ri))
        return finalize(queries, table, inverse, u_lo, u_hi, inv, ui, ri, merge)

    monkeypatch.setattr(tq, "_finalize_batch", spy)
    stats = {}
    before = rj.range_join_mask.launches
    got = tq.BatchedJoinExecutor(
        stats=lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n),
        device=cuda_device,
    ).run([req()])
    assert got[0][0].lo.tobytes() == want[0][0].lo.tobytes()
    assert got[0][0].hi.tobytes() == want[0][0].hi.tobytes()
    ((u_lo, u_hi, ui, ri),) = seen
    index = table.val_index() if inverse else table.key_index()
    w_ui, w_ri = index.candidate_pairs(u_lo, u_hi)
    assert ui.tobytes() == w_ui.tobytes() and ri.tobytes() == w_ri.tobytes()
    if rerouted:
        assert stats["joins_index_to_kernel"] == stats["joins_dense_kernel"] == 1
        assert "joins_index" not in stats
        assert rj.range_join_mask.launches == before + 1
    else:
        assert stats == {"joins_index": 1}
        assert rj.range_join_mask.launches == before



def test_heavy_index_joins_past_the_memory_room_stay_on_the_index(cuda_device, monkeypatch):
    """Rerouted joins take the device's free memory, up to
    ``KERNEL_MASK_MEMORY_SHARE`` of it, in frontier order: with
    room for one of two heavy joins' masks the first runs on the card and
    the second keeps the index, and both give the CPU executor's answers
    and ``candidate_pairs``' pairs in the same order."""
    import repro_torch.core.query as tq

    free = tq._device_free_bytes(cuda_device)
    assert 0 < free <= torch.cuda.get_device_properties(cuda_device).total_memory
    table = _per_cell_table()
    reqs, frontiers = [], []
    for k, n_boxes in enumerate((3318, 3400)):
        rng = np.random.default_rng(SEED + k)
        lo = np.stack(np.unravel_index(rng.choice(40_000, n_boxes, replace=False),
                                       (200, 200)), axis=1).astype(np.int64)
        frontiers.append(lo)
    req = lambda: [tq.JoinRequest([tq.QueryBox((200, 200), lo, lo.copy())], table,  # noqa: E731
                                  merge=False, path="index") for lo in frontiers]
    want = tq.BatchedJoinExecutor(device="cpu").run(req())
    need = [tq._mask_bytes(lo.shape[0], table.n_rows) for lo in frontiers]
    room = need[0] + need[1] - 1
    monkeypatch.setattr(tq, "_device_free_bytes",
                        lambda device: int(room / tq.KERNEL_MASK_MEMORY_SHARE) + 1)
    seen, finalize = [], tq._finalize_batch

    def spy(queries, table, inverse, u_lo, u_hi, inv, ui, ri, merge):
        seen.append((u_lo.shape[0], u_lo, u_hi, ui, ri))
        return finalize(queries, table, inverse, u_lo, u_hi, inv, ui, ri, merge)

    monkeypatch.setattr(tq, "_finalize_batch", spy)
    stats = {}
    before = rj.range_join_mask.launches
    got = tq.BatchedJoinExecutor(
        stats=lambda key, n=1: stats.__setitem__(key, stats.get(key, 0) + n),
        device=cuda_device,
    ).run(req())
    for g, w in zip(got, want):
        assert g[0].lo.tobytes() == w[0].lo.tobytes()
        assert g[0].hi.tobytes() == w[0].hi.tobytes()
    assert stats["joins_index_to_kernel"] == stats["joins_dense_kernel"] == 1
    assert stats["joins_index"] == 1
    assert rj.range_join_mask.launches == before + 1
    index = table.key_index()
    assert sorted(n for n, *_ in seen) == [3318, 3400]
    for _, u_lo, u_hi, ui, ri in seen:
        w_ui, w_ri = index.candidate_pairs(u_lo, u_hi)
        assert ui.tobytes() == w_ui.tobytes() and ri.tobytes() == w_ri.tobytes()

def _sorted_table(rng, n, n_keys):
    p = np.zeros((n, 128), np.int32)
    for c in range(n_keys):
        p[:, c] = np.sort(rng.integers(0, 3, n))
    lo = np.sort(rng.integers(0, max(n // 2, 2), n))
    p[:, n_keys] = lo
    p[:, n_keys + 1] = lo + rng.integers(0, 3, n)
    return p


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1024, 1025])
@pytest.mark.parametrize("n_keys", [0, 1, 4, 126, 2, 3, 6, 7])
def test_run_boundary_kernel_equals_plain(cuda_device, n, n_keys):
    rng = np.random.default_rng(SEED + n + n_keys)
    p = torch.from_numpy(_sorted_table(rng, n, n_keys)).to(cuda_device)
    want = ref.run_boundaries_ref(p, n_keys)
    before = rb.run_boundaries_packed.launches
    for block_rows in (256, 1024):
        got = rb.run_boundaries_packed(p, n_keys=n_keys, block_rows=block_rows)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert rb.run_boundaries_packed.launches == before + 2


def test_run_boundary_kernel_edge_rows(cuda_device):
    """Row 0 of an all-INT32_MIN table, and the int32 wrap of hi + 1."""
    i32 = np.iinfo(np.int32)
    edge = np.full((3, 128), i32.min, np.int32)
    wrap = np.zeros((4, 128), np.int32)
    wrap[:, 1] = [0, 5, i32.min, i32.min + 1]
    wrap[:, 2] = i32.max
    # at 3 keys lo and hi sit in two 16-byte chunks; at 126 the row is full
    wrap3 = np.zeros((4, 128), np.int32)
    wrap3[:, 3] = wrap[:, 1]
    wrap3[:, 4] = i32.max
    for p, n_keys, expect in ((edge, 0, [1, 0, 0]), (edge, 1, [1, 0, 0]),
                              (edge, 7, [1, 0, 0]), (edge, 126, [1, 0, 0]),
                              (wrap, 1, [1, 1, 0, 1]), (wrap3, 3, [1, 1, 0, 1])):
        t = torch.from_numpy(p).to(cuda_device)
        got = rb.run_boundaries_packed(t, n_keys=n_keys)
        assert got.cpu().tolist() == expect
        assert torch.equal(got, ref.run_boundaries_ref(t, n_keys))
    empty = torch.zeros((0, 128), dtype=torch.int32, device=cuda_device)
    assert rb.run_boundaries_packed(empty, n_keys=1).shape == (0,)


def test_run_boundaries_wrapper_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(SEED)
    g = np.sort(rng.integers(0, 12, 3000))
    lo = rng.integers(0, 50, 3000)
    order = np.lexsort((lo, g))
    g, lo = g[order], lo[order]
    want = ops.run_boundaries([g], lo, lo + 1, device="cpu")
    got = ops.run_boundaries([g], lo, lo + 1, device=cuda_device)
    np.testing.assert_array_equal(got, want)


def test_durable_store_on_card_equals_cpu(cuda_device, tmp_path):
    """DSLog.open on the card: WAL replay, views and the answer cache give
    the CPU store's answers, and the two stores write the same files."""
    rels = [C.flip_lineage((24, 20), 0), C.roll_lineage((24, 20), 3, 0),
            C.identity_lineage((24, 20)), C.flip_lineage((24, 20), 1)]
    answers = {}
    for dev in ("cpu", cuda_device):
        root = tmp_path / str(dev)
        log = core.DSLog.open(str(root), durability="manual", device=dev)
        log.define_array("a0", (24, 20))
        for k, rel in enumerate(rels):
            log.define_array(f"a{k + 1}", (24, 20))
            log.register_operation(f"op{k}", [f"a{k}"], [f"a{k + 1}"],
                                   capture=lambda r=rel: {(0, 0): r})
        log.commit()
        log.close(checkpoint=False)
        log = core.DSLog.load(str(root), device=dev)
        rng = np.random.default_rng(SEED)
        got = [log.prov_query("a4", "a0", rng.integers(0, 20, (3, 2))) for _ in range(6)]
        got.append(log.prov_query("a4", "a0", np.array([[1, 2]])))
        got.append(log.prov_query("a4", "a0", np.array([[1, 2]])))
        assert log.io_stats["views_materialized"] == 1 and log.io_stats["cache_hits"] == 1
        answers[str(dev)] = got
        log.save()
    for g, w in zip(answers["cuda"], answers["cpu"]):
        assert g.lo.tobytes() == w.lo.tobytes() and g.hi.tobytes() == w.hi.tobytes()
    for fn in sorted(p.name for p in (tmp_path / "cpu").iterdir()):
        if fn not in ("telemetry.json", "autotune.json"):
            assert (tmp_path / "cpu" / fn).read_bytes() == (tmp_path / "cuda" / fn).read_bytes(), fn


def _tree_bytes(root):
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file() and path.name not in ("telemetry.json", "autotune.json",
                                                 "writer.lock"):
            out[str(path.relative_to(root))] = path.read_bytes()
    return out


def test_sharded_store_on_card_equals_cpu(cuda_device, tmp_path):
    """A 4-shard ShardedDSLog on the card: the CPU store's answers and
    boxes_exchanged, the same manifest and blob bytes, and the range-join
    kernels launched; a cold load answers alike."""
    rels = [C.slice_lineage((64, 64), (0, 0), (64, 64), (2, 2)), C.identity_lineage((32, 32)),
            C.transpose_lineage((32, 32), (1, 0)), C.flip_lineage((32, 32), 0),
            C.reduce_lineage((32, 32), 1)]
    names = [f"a{k}" for k in range(len(rels) + 1)]
    cells = np.stack(np.unravel_index(np.arange(300), rels[0].in_shape), axis=1)
    answers, exchanged = {}, {}
    before = rj.range_join_mask.launches + rj.range_join_tile_masks.launches
    for dev in ("cpu", cuda_device):
        root = tmp_path / str(dev)
        log = core.ShardedDSLog.open(str(root), 4, durability="manual", device=dev)
        log.define_array("a0", rels[0].in_shape)
        for k, rel in enumerate(rels):
            log.define_array(names[k + 1], rel.out_shape)
            log.register_operation(f"op{k}", [names[k]], [names[k + 1]],
                                   capture=lambda r=rel: {(0, 0): r}, reuse=False)
        got = [log.prov_query(names, cells, merge=m) for m in (True, False)]
        got.append(log.prov_query(names[0], names[-1], cells))
        got.append(log.prov_query(names[-1], names[0], np.array([[3], [17]])))
        exchanged[str(dev)] = log.io_stats["boxes_exchanged"]
        log.close()
        back = core.ShardedDSLog.load(str(root), device=dev)
        got.append(back.prov_query(names[-1], names[0], np.array([[5]])))
        answers[str(dev)] = got
    assert rj.range_join_mask.launches + rj.range_join_tile_masks.launches > before
    assert exchanged["cuda"] == exchanged["cpu"] > 0
    for g, w in zip(answers["cuda"], answers["cpu"]):
        assert g.lo.tobytes() == w.lo.tobytes() and g.hi.tobytes() == w.hi.tobytes()
    cpu, cuda = _tree_bytes(tmp_path / "cpu"), _tree_bytes(tmp_path / "cuda")
    assert sorted(cpu) == sorted(cuda) and any(k.startswith("shard_") for k in cpu)
    for fn in cpu:
        assert cpu[fn] == cuda[fn], fn


@pytest.mark.parametrize("case", ["exp", "matmul", "softmax", "roll", "tile"])
def test_capture_jacobian_on_card_equals_cpu(cuda_device, case):
    rng = np.random.default_rng(SEED)
    f, shapes = {
        "exp": (torch.exp, [(5, 4)]),
        "matmul": (lambda a, b: a @ b, [(3, 4), (4, 6)]),
        "softmax": (lambda x: torch.softmax(x, -1), [(3, 5)]),
        "roll": (lambda x: torch.roll(x, 2, 0), [(6, 2)]),
        "tile": (lambda x: torch.tile(x, (2, 2)), [(3, 2)]),
    }[case]
    args = [rng.random(s) + 0.5 for s in shapes]
    if case == "exp":
        args[0][0, 0] = -120.0  # underflows in float32: dropped on both
    want = C.capture_jacobian(f, *args, device="cpu")
    got = C.capture_jacobian(f, *args, device=cuda_device)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int16, np.bool_])
def test_run_boundaries_column_dtypes_on_card_equal_cpu(cuda_device, dtype):
    """Unsigned columns are widened on the card before the int32 range
    check (torch defines no min/max on uint16/32/64 there either)."""
    rng = np.random.default_rng(SEED)
    top = 2 if dtype is np.bool_ else 60
    g = np.sort(rng.integers(0, top, 2000)).astype(dtype)
    lo = rng.integers(0, top, 2000).astype(dtype)
    order = np.lexsort((lo, g))
    g, lo = g[order], lo[order]
    want = ops.run_boundaries([g], lo, lo, device="cpu")
    np.testing.assert_array_equal(ops.run_boundaries([g], lo, lo, device=cuda_device), want)
    if np.dtype(dtype).kind == "u" and np.dtype(dtype).itemsize >= 4:
        bad = np.array([0, np.iinfo(dtype).max], dtype)
        with pytest.raises(ValueError, match="int32"):
            ops.run_boundaries([bad], bad, bad, device=cuda_device)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-780m"])
def test_decode_on_card_equals_cpu(cuda_device, name):
    """The reduced model's decode on the card against the same weights on
    the CPU: every step's logits within 1e-4 (float32 at "highest" matmul
    precision; sums in another order), and the greedy tokens equal."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_caches, init_model

    assert torch.get_float32_matmul_precision() == "highest"
    cfg = get_arch(name).reduced()
    model = init_model(cfg, 5, device=cuda_device)
    cpu_model = copy.deepcopy(model).to("cpu")
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    caches = {d: init_caches(cfg, 2, 17, device=d) for d in ("cpu", cuda_device)}
    for t in range(16):
        tok = torch.from_numpy(tokens[:, t : t + 1])
        want, _ = decode_step(cpu_model, tok, caches["cpu"], t, cfg)
        got, _ = decode_step(model, tok.to(cuda_device), caches[cuda_device], t, cfg)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    out = generate(cfg, model, tokens[:, :8], 8, device=cuda_device)
    assert out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  generate(cfg, cpu_model, tokens[:, :8], 8, device="cpu").numpy())


# dense, MoE (einsum dispatch; sorted dispatch, whose scatter-add is
# index_put_(accumulate=True) with float atomics on the card), SSM, hybrid
_TRAIN_ARCHS = [("qwen2-0.5b", None), ("qwen2-moe-a2.7b", "einsum"), ("grok-1-314b", "sorted"),
                ("mamba2-780m", None), ("hymba-1.5b", None)]


@pytest.mark.parametrize("name,dispatch", _TRAIN_ARCHS)
def test_train_steps_on_card_equal_cpu(cuda_device, name, dispatch):
    """Three AdamW steps of the reduced model on the card against the same
    weights and batches on the CPU: loss, ce, aux, grad_norm and lr each
    step and every parameter after it within rtol = atol = 1e-4 (float32 at
    "highest" matmul precision; sums in another order)."""
    import copy
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_arch(name).reduced()
    if dispatch is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    plan = attn_plan(cfg, ShapeConfig("t", 16, 2, "train"), dp_total=1)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    model = init_model(cfg, 7, device=cuda_device)
    cpu_model = copy.deepcopy(model).to("cpu")
    opts = {"card": adamw_init(model), "cpu": adamw_init(cpu_model)}
    step = make_train_step(cfg, opt_cfg, plan)
    rng = np.random.default_rng(SEED)
    for _ in range(3):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
        model, opts["card"], got = step(model, opts["card"], {"tokens": tokens.to(cuda_device)})
        cpu_model, opts["cpu"], want = step(cpu_model, opts["cpu"], {"tokens": tokens})
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        for (n, p), q in zip(model.named_parameters(), cpu_model.parameters()):
            np.testing.assert_allclose(p.detach().cpu().numpy(), q.detach().numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=n)
    assert opts["card"]["step"].device.type == "cuda" and int(opts["card"]["step"]) == 3


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_on_card_keeps_the_gradient(cuda_device, remat):
    """Recomputation repeats the same products on the card: gradients
    within 1e-5 of remat "nothing"'s."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_model, lm_loss

    cfg = get_arch("hymba-1.5b").reduced()
    model = init_model(cfg, 3, device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (2, 16)))
    batch = {"tokens": tokens.to(cuda_device)}
    params = list(model.parameters())
    grads = {}
    for r in ("nothing", remat):
        total, _ = lm_loss(model, batch, dataclasses.replace(cfg, remat=r))
        grads[r] = torch.autograd.grad(total, params)
    for g, w in zip(grads[remat], grads["nothing"]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_train_loop_on_card_resumes_and_restores_on_cpu(cuda_device, tmp_path):
    """``train_loop`` on the card: a run resumed from its step-2 checkpoint
    gives the straight run's losses (within 1e-6), and the checkpoint's
    tensors, bf16 included, restore on the CPU and on the card alike."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_arch("qwen2-0.5b").reduced()
    shape = ShapeConfig("t", 32, 2, "train")
    kw = dict(ckpt_every=3, log_every=100, device=cuda_device,
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
    _, straight = train_loop(cfg, shape, steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    _, first = train_loop(cfg, shape, steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    _, rest = train_loop(cfg, shape, steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    np.testing.assert_allclose(first + rest, straight, rtol=0, atol=1e-6)
    mgr = CheckpointManager(str(tmp_path / "c"))
    tree = {"w": torch.randn(3, 4, device=cuda_device),
            "h": torch.randn(5, device=cuda_device).to(torch.bfloat16),
            "step": torch.tensor(4, dtype=torch.int32, device=cuda_device)}
    mgr.save(4, tree, extra={"step": 4})
    on_cpu, _ = mgr.restore(device="cpu")
    on_card, _ = mgr.restore(device=cuda_device)
    for k, v in tree.items():
        assert on_card[k].device.type == "cuda" and torch.equal(on_card[k], v)
        assert on_cpu[k].device.type == "cpu" and torch.equal(on_cpu[k], v.cpu())


# --------------------------------------------------------------------------- #
# The distributed pieces on a one-rank NCCL group (chip_smoke.py phase 12b at
# reduced()): the group lives for one test, so no other test sees it
# --------------------------------------------------------------------------- #
@pytest.fixture
def nccl_rank(cuda_device, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield torch.device("cuda:0")
    finally:
        dist.destroy_process_group()


def _reduced_qwen2():
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model, to_reference
    from repro_torch.models.convert import shape_tree, spec_tree

    cfg = get_arch("qwen2-0.5b").reduced()
    model = init_model(cfg, 3, device="cpu")
    return cfg, to_reference(model), spec_tree(model), shape_tree(model)


def _pairs(got, want):
    if isinstance(want, dict):
        for k in want:
            yield from _pairs(got[k], want[k])
    else:
        yield got, want


def test_local_mesh_and_reshard_tree_on_one_nccl_rank(nccl_rank):
    """``local_mesh(1)`` is a ``cuda`` mesh over the NCCL group, and
    ``reshard_tree`` lays the reference-layout tree on it bit for bit."""
    import torch.distributed as dist
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.launch.mesh import local_mesh

    assert dist.get_backend() == "nccl"
    mesh = local_mesh(1, device=nccl_rank)
    assert mesh.device_type == "cuda" and tuple(mesh.mesh_dim_names) == ("data", "model")
    _, tree, specs, _ = _reduced_qwen2()
    placed = reshard_tree(tree, specs, mesh)
    for dt, host in _pairs(placed, tree):
        assert dt.to_local().device.type == "cuda"
        assert torch.equal(dt.full_tensor().cpu(), torch.from_numpy(host))


def test_sharded_restore_on_one_nccl_rank(nccl_rank, tmp_path):
    """``train_loop`` on the card (a one-rank group trains as one process)
    writes a checkpoint whose ``restore(shardings=)`` equals the plain
    restore, with the unnamed leaves left plain."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.launch.train import train_loop

    cfg, _, specs, shapes = _reduced_qwen2()
    train_loop(cfg, ShapeConfig("t", 32, 2, "train"), steps=3, ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=3, log_every=100, device=nccl_rank)
    sh = param_sharding(local_mesh(1, device=nccl_rank), specs, shapes_tree=shapes)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    got, extra = mgr.restore(device=nccl_rank, shardings={"params": sh, "opt": {"m": sh, "v": sh}})
    plain, _ = mgr.restore(device="cpu")
    assert extra["step"] == 2 and not hasattr(got["opt"]["step"], "full_tensor")
    for part, want in ((got["params"], plain["params"]), (got["opt"]["m"], plain["opt"]["m"]),
                       (got["opt"]["v"], plain["opt"]["v"])):
        for dt, w in _pairs(part, want):
            assert torch.equal(dt.full_tensor().cpu(), w)


def test_placed_step_on_one_nccl_rank_equals_the_plain_step(nccl_rank):
    """``make_train_step(mesh=)`` on ``local_mesh(1)``: the parameters are
    ``DTensor``s on the card (every block whole), and two steps give the
    plain step's metrics and parameters."""
    import copy

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model
    from repro_torch.models.convert import place_model, shape_tree, spec_tree
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg, *_ = _reduced_qwen2()
    shape = ShapeConfig("t", 32, 2, "train")
    plan, opt_cfg = attn_plan(cfg, shape, 1), AdamWConfig(lr=1e-3, warmup_steps=1)
    plain = init_model(cfg, 3, device=nccl_rank)
    mesh = local_mesh(1, device=nccl_rank)
    placed = copy.deepcopy(plain)
    place_model(placed, param_sharding(mesh, spec_tree(placed), shapes_tree=shape_tree(placed)))
    assert all(isinstance(p, DTensor) and p.to_local().is_cuda for p in placed.parameters())
    runs = {}
    for name, model, m in (("plain", plain, None), ("placed", placed, mesh)):
        step, opt = make_train_step(cfg, opt_cfg, plan, mesh=m), adamw_init(model)
        gen = torch.Generator().manual_seed(SEED)
        runs[name] = []
        for _ in range(2):
            tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen).to(nccl_rank)
            model, opt, out = step(model, opt, {"tokens": tokens})
            runs[name].append([float(out[k]) for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(runs["placed"], runs["plain"], rtol=1e-6, atol=1e-6)
    for p, q in zip(placed.parameters(), plain.parameters()):
        torch.testing.assert_close(p.to_local(), q.detach(), rtol=1e-6, atol=1e-6)


def test_collectives_through_nccl_equal_one_rank_answers(nccl_rank):
    """On one rank the flash-decode combine is ``o / l`` and the ring shift
    is the stage's own output, through NCCL's reductions and send/recv."""
    from repro_torch.distributed.collectives import (flash_decode_combine,
                                                     local_partial_attention,
                                                     pipeline_stage_step)

    gen = torch.Generator(device=nccl_rank).manual_seed(SEED)
    q, k, v = (torch.randn(s, generator=gen, device=nccl_rank)
               for s in ((2, 4, 1, 16), (2, 4, 64, 16), (2, 4, 64, 16)))
    valid = (torch.arange(64, device=nccl_rank) <= 49).expand(2, 64)
    m, l, o = local_partial_attention(q, k, v, valid)
    out = flash_decode_combine(m, l, o)
    assert torch.equal(out, o / torch.clamp(l, min=1e-30)[..., None])
    s = (q @ k.transpose(-1, -2)) * 16**-0.5
    want = torch.softmax(s.masked_fill(~valid[:, None, None, :], float("-inf")), -1) @ v
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    x = torch.randn((4, 32), generator=gen, device=nccl_rank)
    assert torch.equal(pipeline_stage_step(lambda y: y * 2.0 + 1.0, x), x * 2.0 + 1.0)


# --------------------------------------------------------------------------- #
# Placed decode on 2 gloo ranks sharing the card, and a dry run on the card
# (chip_smoke.py phase 14 at reduced())
# --------------------------------------------------------------------------- #
def test_placed_decode_on_two_ranks_equals_one_card(cuda_device, tmp_path):
    """qwen2-0.5b (KV heads over the model ranks) and mamba2-780m (SSM
    states gathered for a step, a block kept) at ``reduced()`` on a (1, 2)
    mesh of 2 ``gloo`` ranks sharing the card (``_dist_port.py
    cardserve``), against one card's decode of the same weights and
    prompts: every step's logits within 1e-4, greedy tokens equal."""
    from _dist_port import spawn

    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_caches, init_model

    rng = np.random.default_rng(SEED)
    prompts = {a: rng.integers(0, 256, (2, 8)).astype(np.int32)
               for a in ("qwen2-0.5b", "mamba2-780m")}
    np.savez(tmp_path / "card_prompts.npz", **prompts)
    ranks = spawn("cardserve", 2, str(tmp_path))
    assert [r["coord"] for r in ranks] == [[0, 0], [0, 1]]
    for arch, tokens in prompts.items():
        cfg = get_arch(arch).reduced()
        model = init_model(cfg, 5, device=cuda_device)
        caches = init_caches(cfg, 2, 16, device=cuda_device)
        tok, logits, new = torch.from_numpy(tokens[:, :1]).to(cuda_device), [], []
        for t in range(15):
            lg, caches = decode_step(model, tok, caches, t, cfg)
            logits.append(lg[:, 0].cpu())
            if t + 1 < 8:
                tok = torch.from_numpy(tokens[:, t + 1:t + 2]).to(cuda_device)
            else:
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
                new.append(tok.cpu())
        for r in range(2):
            got = np.load(tmp_path / f"cardserve.{arch}.rank{r}.npz")
            np.testing.assert_allclose(got["logits"], torch.stack(logits, 1).numpy(),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(got["tokens"], torch.cat(new, 1).numpy())


def test_dry_run_of_a_reduced_cell_on_the_card(cuda_device, tmp_path):
    """``python -m repro_torch.launch.dryrun --device cuda`` of qwen2-0.5b's
    reduced train step on a fake (2, 2) group: ``ok``, fake tensors on the
    card's device type, ``fits`` against its memory, the card named."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    done = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen2-0.5b", "--shape", "smoke_train", "--mesh", "2x2", "--reduced",
                           "--device", "cuda", "--out", str(tmp_path)],
                          env=dict(os.environ, PYTHONPATH=os.path.abspath(src)),
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with open(tmp_path / "mesh2x2" / "qwen2-0.5b__smoke_train.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["device"] == "cuda" and rec["fits"] is True
    assert rec["device_memory_bytes"] == torch.cuda.get_device_properties(0).total_memory
    assert torch.cuda.get_device_name(0) in rec["card"]
    assert rec["cost_accounted"] == rec["cost_analysis"]
