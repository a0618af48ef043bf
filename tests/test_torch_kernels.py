"""Port kernels vs the JAX package's Pallas kernels (interpret mode).

The same packed inputs, made from a numpy seed, go through
``repro.kernels`` (Pallas, ``interpret=True``) and ``repro_torch.kernels``
(the plain PyTorch versions on CPU tensors; the CUDA kernels are held
against those in ``test_torch_gpu.py``).  Integer outputs are compared
exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro.kernels.range_join as jrj
import repro.kernels.ref as jref
import repro.kernels.run_boundary as jrb
import repro_torch.kernels.ops as tops
import repro_torch.kernels.range_join as trj
import repro_torch.kernels.ref as tref
import repro_torch.kernels.run_boundary as trb

SEED = 20240527


def _packed(rng, n, n_attrs, coord=40, width=5):
    p = np.zeros((n, 128), np.int32)
    lo = rng.integers(0, coord, (n, n_attrs))
    p[:, :n_attrs] = lo
    p[:, n_attrs : 2 * n_attrs] = lo + rng.integers(0, width, (n, n_attrs))
    return p


def _boxes(rng, n, l, coord=40, width=6):
    lo = rng.integers(0, coord, (n, l))
    return lo, lo + rng.integers(0, width, (n, l))


def _segments(rng, k, widths=(1, 2, 3), max_rows=90, coords=(0, 25)):
    segs = []
    for i in range(k):
        l = int(widths[i % len(widths)])
        nq, nr = int(rng.integers(1, max_rows)), int(rng.integers(1, max_rows))
        q_lo = rng.integers(*coords, (nq, l))
        r_lo = rng.integers(*coords, (nr, l))
        segs.append(
            (q_lo, q_lo + rng.integers(0, 5, (nq, l)),
             r_lo, r_lo + rng.integers(0, 5, (nr, l)))
        )
    return segs


# --------------------------------------------------------------------------- #
# range_join_mask
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("nq", [255, 256, 257])
@pytest.mark.parametrize("nr", [255, 256, 257])
def test_mask_matches_pallas_at_block_boundaries(nq, nr):
    rng = np.random.default_rng(SEED + nq * 1000 + nr)
    q, r = _packed(rng, nq, 2), _packed(rng, nr, 2)
    want = np.asarray(
        jrj.range_join_mask(jnp.asarray(q), jnp.asarray(r), n_attrs=2, interpret=True)
    )
    got = trj.range_join_mask(torch.from_numpy(q), torch.from_numpy(r), n_attrs=2)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (nq, nr)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("n_attrs,segmented,ok", [
    (64, False, True), (63, True, True), (64, True, False), (65, False, False),
])
def test_lane_capacity_matches_reference(n_attrs, segmented, ok):
    for mod in (jrj, trj):
        if ok:
            mod.check_lane_capacity(n_attrs, segmented=segmented)
        else:
            with pytest.raises(ValueError, match="lane capacity"):
                mod.check_lane_capacity(n_attrs, segmented=segmented)


def test_mask_wide_lanes_match_pallas():
    """64 attributes fill all 128 lanes: every lane is read."""
    rng = np.random.default_rng(SEED)
    q, r = _packed(rng, 40, 64, coord=3), _packed(rng, 50, 64, coord=3)
    want = np.asarray(
        jrj.range_join_mask(jnp.asarray(q), jnp.asarray(r), n_attrs=64, interpret=True)
    )
    got = trj.range_join_mask(torch.from_numpy(q), torch.from_numpy(r), n_attrs=64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    with pytest.raises(ValueError, match="lane capacity"):
        trj.range_join_mask(torch.from_numpy(q), torch.from_numpy(r), n_attrs=65)


def test_mask_rejects_malformed_operands():
    q = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="128 lanes"):
        trj.range_join_mask(q[:, :64].contiguous(), q, n_attrs=1)
    with pytest.raises(ValueError, match="int32"):
        trj.range_join_mask(q.long(), q.long(), n_attrs=1)


# --------------------------------------------------------------------------- #
# range_join_tile_masks
# --------------------------------------------------------------------------- #
def _spanning_pads(rng, n, n_attrs, pads):
    """Packed rows: odd rows ``_packed``'s boxes, even rows boxes that hold
    0 and 1 in every attribute (lo <= 0, hi >= 1), and the last ``pads`` rows
    the segmented packer's pad rows (lo = 1, hi = 0), which the spanning
    boxes overlap."""
    p = _packed(rng, n, n_attrs, coord=6)
    p[0::2, :n_attrs] = -rng.integers(0, 4, (len(p[0::2]), n_attrs))
    p[0::2, n_attrs : 2 * n_attrs] = 1 + rng.integers(0, 4, (len(p[0::2]), n_attrs))
    p[n - pads :] = 0
    p[n - pads :, :n_attrs] = 1
    return p


# widths on both sides of the CUDA kernel's four-attribute passes, one pass
# and a sparse tail
@pytest.mark.parametrize("bq,br", [(32, 32), (64, 128), (128, 64), (64, 256)])
@pytest.mark.parametrize("n_attrs", [1, 2, 4, 5, 64])
def test_tile_masks_match_pallas(n_attrs, bq, br):
    rng = np.random.default_rng(SEED + bq + br + n_attrs)
    nqb, nrb = 3, 4
    q = _spanning_pads(rng, nqb * bq, n_attrs, pads=3)
    r = _spanning_pads(rng, nrb * br, n_attrs, pads=5)
    tile_q = rng.integers(0, nqb, 7).astype(np.int32)
    tile_r = rng.integers(0, nrb, 7).astype(np.int32)
    want = np.asarray(
        jrj.range_join_tile_masks(
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(tile_q), jnp.asarray(tile_r),
            n_attrs=n_attrs, block_q=bq, block_r=br, interpret=True,
        )
    )
    got = trj.range_join_tile_masks(
        torch.from_numpy(q), torch.from_numpy(r),
        torch.from_numpy(tile_q), torch.from_numpy(tile_r),
        n_attrs=n_attrs, block_q=bq, block_r=br,
    )
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_tile_masks_reject_bad_schedules():
    q = torch.zeros((64, 128), dtype=torch.int32)
    t = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pre-padded"):
        trj.range_join_tile_masks(q[:63], q, t, t, n_attrs=1, block_q=32, block_r=32)
    with pytest.raises(ValueError, match="outside"):
        trj.range_join_tile_masks(
            q, q, t + 2, t, n_attrs=1, block_q=32, block_r=32
        )
    with pytest.raises(ValueError, match="outside"):
        trj.range_join_tile_masks(
            q, q, t, t - 1, n_attrs=1, block_q=32, block_r=32
        )
    # the schedule is checked where it was built, on the host
    with pytest.raises(ValueError, match="host"):
        trj.range_join_tile_masks(
            q, q, t.to("meta"), t, n_attrs=1, block_q=32, block_r=32
        )
    empty = torch.zeros(0, dtype=torch.int32)
    out = trj.range_join_tile_masks(q, q, empty, empty, n_attrs=1, block_q=32, block_r=32)
    assert tuple(out.shape) == (0, 32, 32)


# --------------------------------------------------------------------------- #
# ops: packers, pair lists, info dicts
# --------------------------------------------------------------------------- #
def test_packers_give_reference_bytes():
    rng = np.random.default_rng(SEED)
    lo, hi = _boxes(rng, 37, 3)
    for n_attrs in (3, 5):
        a = jops._pack_boxes(lo, hi, n_attrs)
        b = tops._pack_boxes(lo, hi, n_attrs)
        assert a.tobytes() == b.tobytes()
        for mult in (1, 16, 64):
            assert (
                jops._pad_packed_rows(a, mult, n_attrs).tobytes()
                == tops._pad_packed_rows(b, mult, n_attrs).tobytes()
            )
    with pytest.raises(ValueError, match="int32"):
        tops._pack_boxes(lo + 2**31, hi + 2**31, 3)


@pytest.mark.parametrize("nq,nr,l", [
    (100, 300, 1), (257, 511, 2), (64, 64, 3), (1000, 50, 4), (0, 5, 2),
])
def test_range_join_pairs_match_reference(nq, nr, l):
    rng = np.random.default_rng(SEED + nq + nr + l)
    q_lo, q_hi = _boxes(rng, nq, l)
    r_lo, r_hi = _boxes(rng, nr, l)
    wq, wr = jops.range_join_pairs(q_lo, q_hi, r_lo, r_hi, interpret=True)
    gq, gr = tops.range_join_pairs(q_lo, q_hi, r_lo, r_hi, device="cpu")
    assert gq.dtype == np.int64 and gr.dtype == np.int64
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("layout", ["dense", "blockdiag", "auto"])
@pytest.mark.parametrize("seed,k,bq,br", [(1, 4, 32, 64), (2, 6, 64, 32), (3, 1, 64, 64)])
def test_segmented_pairs_and_info_match_reference(layout, seed, k, bq, br):
    segs = _segments(np.random.default_rng(SEED + seed), k)
    want, winfo = jops.segmented_range_join_pairs(
        segs, block_q=bq, block_r=br, interpret=True, layout=layout
    )
    got, ginfo = tops.segmented_range_join_pairs(
        segs, block_q=bq, block_r=br, device="cpu", layout=layout
    )
    assert ginfo == winfo
    assert len(got) == len(want)
    for (gq, gr), (wq, wr) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)


def test_blockdiag_padding_rows_never_match_like_reference():
    """Boxes spanning [<=0, >=1] graze the (lo=1, hi=0) pad rows; both
    packages drop those pairs with the same bounds filter."""
    rng = np.random.default_rng(SEED)
    segs = _segments(rng, 3, widths=(2,), max_rows=40, coords=(-4, 2))
    want, _ = jops.segmented_range_join_pairs(
        segs, block_q=32, block_r=32, interpret=True, layout="blockdiag"
    )
    got, _ = tops.segmented_range_join_pairs(
        segs, block_q=32, block_r=32, device="cpu", layout="blockdiag"
    )
    for (gq, gr), (wq, wr) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)


def test_segmented_empty_and_unknown_layout():
    assert tops.segmented_range_join_pairs([], device="cpu") == (
        jops.segmented_range_join_pairs([], interpret=True)
    )
    segs = _segments(np.random.default_rng(SEED), 2)
    with pytest.raises(ValueError, match="layout"):
        tops.segmented_range_join_pairs(segs, device="cpu", layout="ragged")


@pytest.mark.parametrize("layout", ["dense", "blockdiag", "auto"])
@pytest.mark.parametrize("empty_side", ["q", "r"])
def test_segmented_all_empty_side_follows_reference_blockdiag(layout, empty_side):
    """Every segment with an empty q side (or every one an empty r side):
    the reference's ``layout="dense"`` (and ``"auto"``, which picks dense
    here) raises in ``range_join_mask`` on a 0-row operand
    (``src/repro/kernels/ops.py:345``); its ``layout="blockdiag"`` returns
    empty pair lists.  The port gives the blockdiag answer in every layout
    (``ROADMAP.md`` §3, pinned)."""
    z = np.zeros((0, 1), np.int64)
    o = np.zeros((1, 1), np.int64)
    segs = [(z, z, o, o), (z, z, o + 3, o + 5)]
    if empty_side == "r":
        segs = [(r_lo, r_hi, q_lo, q_hi) for q_lo, q_hi, r_lo, r_hi in segs]
    want, _ = jops.segmented_range_join_pairs(segs, interpret=True, layout="blockdiag")
    got, _ = tops.segmented_range_join_pairs(segs, device="cpu", layout=layout)
    assert len(got) == len(want) == 2
    for (gq, gr), (wq, wr) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)
        assert len(gq) == len(gr) == 0


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    rng = np.random.default_rng(SEED)
    lo, hi = _boxes(rng, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.range_join_pairs(lo, hi, lo, hi)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.segmented_range_join_pairs([(lo, hi, lo, hi)])
    with pytest.raises(ValueError, match="unsupported device"):
        tops.resolve_device("meta")


# --------------------------------------------------------------------------- #
# run_boundaries_packed
# --------------------------------------------------------------------------- #
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _sorted_table(kind, n, nk, seed):
    """The reference's run-boundary sweeps (``tests/test_kernels.py``):
    ``keys`` sorted keys with lo <= hi, ``points`` lo == hi, ``pads`` one
    key at row counts off the block grid."""
    r = np.random.default_rng(seed)
    p = np.zeros((n, 128), np.int32)
    if kind == "keys":
        for c in range(nk):
            p[:, c] = np.sort(r.integers(0, 7, n))
        lo = np.sort(r.integers(0, n // 2, n))
        hi = lo + r.integers(0, 3, n)
    elif kind == "points":
        for c in range(nk):
            p[:, c] = np.sort(r.integers(0, 5, n))
        lo = hi = np.sort(r.integers(0, 40, n))
    else:
        p[:, 0] = np.sort(r.integers(0, 6, n))
        lo = np.sort(r.integers(0, max(n // 3, 2), n))
        hi = lo + r.integers(0, 3, n)
    p[:, nk] = lo
    p[:, nk + 1] = hi
    return p


@pytest.mark.parametrize("kind,n,nk,block", [
    ("keys", 512, 1, 128), ("keys", 1024, 2, 256), ("keys", 2048, 4, 512),
    ("keys", 4096, 8, 1024), ("keys", 1024, 1, 1024), ("keys", 3072, 6, 256),
    ("points", 256, 1, 256), ("points", 512, 3, 256), ("points", 1024, 5, 256),
    ("pads", 1, 1, 256), ("pads", 255, 1, 256), ("pads", 1024, 1, 256),
    ("pads", 1025, 1, 256),
])
def test_run_boundaries_match_pallas_and_oracle(kind, n, nk, block):
    p = _sorted_table(kind, n, nk, SEED + n + nk)
    want = np.asarray(jref.run_boundaries_ref(jnp.asarray(p), nk))
    pallas = np.asarray(
        jrb.run_boundaries_packed(jnp.asarray(p), n_keys=nk, block_rows=block, interpret=True)
    )
    np.testing.assert_array_equal(pallas, want)
    got = trb.run_boundaries_packed(torch.from_numpy(p), n_keys=nk, block_rows=block)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_run_boundaries_wrapper_matches_reference():
    """The inputs of the reference's ``test_run_boundaries_wrapper_vs_numpy``,
    with ``hi = lo`` and with ``hi > lo``."""
    rng = np.random.default_rng(SEED)
    n = 3000
    g = np.sort(rng.integers(0, 12, n)).astype(np.int64)
    lo = rng.integers(0, 50, n).astype(np.int64)
    order = np.lexsort((lo, g))
    g, lo = g[order], lo[order]
    for hi in (lo, lo + rng.integers(0, 3, n)):
        want = jops.run_boundaries([g], lo, hi, block_rows=512, interpret=True)
        got = tops.run_boundaries([g], lo, hi, block_rows=512, device="cpu")
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="int32"):
        tops.run_boundaries([g + 2**31], lo, lo, device="cpu")
    empty = np.zeros(0, np.int64)
    assert tops.run_boundaries([empty], empty, empty, device="cpu").shape == (0,)


@pytest.mark.parametrize("n,n_keys", [(0, 1), (1, 0), (257, 1), (1500, 4), (700, 7)])
def test_run_boundaries_device_pack_matches_reference(n, n_keys):
    """``ops.run_boundaries`` uploads only the live columns and packs on the
    device: the table has the bytes of the reference wrapper's host pack
    (``src/repro/kernels/ops.py:78-82``) and the flags are the reference's."""
    rng = np.random.default_rng(SEED + n + n_keys)
    cols = [np.sort(rng.integers(0, 4, n)) for _ in range(n_keys)]
    order = np.lexsort((rng.integers(0, n + 1, n), *cols[::-1])) if n else np.zeros(0, np.int64)
    cols = [c[order] for c in cols]
    lo = np.sort(rng.integers(0, max(n, 1), n)).astype(np.int64)
    hi = lo + rng.integers(0, 3, n)
    want = np.zeros((n, 128), np.int32)
    for c, col in enumerate(cols):
        want[:, c] = col.astype(np.int32)
    want[:, n_keys] = lo.astype(np.int32)
    want[:, n_keys + 1] = hi.astype(np.int32)
    got = tops._pack_run_columns(cols, lo, hi, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.numpy().tobytes() == want.tobytes()
    assert tops._pack_run_table(cols, lo, hi).tobytes() == want.tobytes()
    flags = tops.run_boundaries(cols, lo, hi, block_rows=256, device="cpu")
    np.testing.assert_array_equal(
        flags, jops.run_boundaries(cols, lo, hi, block_rows=256, interpret=True)
    )
    if n:
        with pytest.raises(ValueError, match="int32"):
            tops._pack_run_columns(cols, lo + 2**31, hi, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64, np.uint8,
                                   np.uint16, np.uint32, np.uint64, np.bool_])
def test_run_boundaries_every_integer_dtype_matches_reference(dtype):
    """Columns of every numpy integer type and ``bool``: the port packs them
    as the reference does (min/max are not defined on torch's uint16/32/64,
    so those columns are widened before the int32 range check), and
    out-of-range unsigned values raise in both packages."""
    rng = np.random.default_rng(SEED)
    top = 2 if dtype is np.bool_ else 100
    g = np.sort(rng.integers(0, top, 400)).astype(dtype)
    lo = rng.integers(0, top, 400).astype(dtype)
    order = np.lexsort((lo, g))
    g, lo = g[order], lo[order]
    hi = lo if dtype is np.bool_ else (lo + rng.integers(0, 3, 400).astype(dtype))
    for case in ([g], lo, hi), ([np.array([0, 0, 1], dtype)],
                                np.array([0, 1, 1], dtype), np.array([0, 1, 1], dtype)):
        want = jops.run_boundaries(*case, block_rows=256, interpret=True)
        got = tops.run_boundaries(*case, block_rows=256, device="cpu")
        np.testing.assert_array_equal(got, want)
    if np.dtype(dtype).kind == "u" and np.dtype(dtype).itemsize >= 4:
        info = np.iinfo(dtype)
        for v in (info.max, I32_MAX + 1, info.max // 2 + 3):
            bad = np.array([0, v], dtype)
            with pytest.raises(ValueError, match="int32"):
                jops.run_boundaries([bad], bad, bad, interpret=True)
            with pytest.raises(ValueError, match="int32"):
                tops.run_boundaries([bad], bad, bad, device="cpu")
        ok = np.array([0, I32_MAX], dtype)
        np.testing.assert_array_equal(tops.run_boundaries([ok], ok, ok, device="cpu"),
                                      jops.run_boundaries([ok], ok, ok, interpret=True))


def test_run_boundaries_hi_wrap_matches_reference():
    """``hi[t-1] = INT32_MAX``: ``hi + 1`` wraps to INT32_MIN in both
    packages, so any ``lo > INT32_MIN`` reads as a gap."""
    p = np.zeros((4, 128), np.int32)
    p[:, 1] = [0, 5, I32_MIN, I32_MIN + 1]
    p[:, 2] = [I32_MAX, I32_MAX, I32_MAX, I32_MAX]
    want = np.asarray(jref.run_boundaries_ref(jnp.asarray(p), 1))
    pallas = np.asarray(jrb.run_boundaries_packed(jnp.asarray(p), n_keys=1, interpret=True))
    np.testing.assert_array_equal(want, [1, 1, 0, 1])
    np.testing.assert_array_equal(pallas, want)
    got = trb.run_boundaries_packed(torch.from_numpy(p), n_keys=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nk", [0, 1])
def test_run_boundaries_int32_min_row0_follows_oracle(nk):
    """All lanes INT32_MIN: row 0 starts a run.  The port follows the
    reference oracle ``run_boundaries_ref`` and the kernel's docstring; the
    reference Pallas kernel compares row 0 with a sentinel row of INT32_MIN
    (``src/repro/kernels/run_boundary.py:83``), which this row equals, and
    returns 0 there — the divergence ROADMAP.md §3 records."""
    p = np.full((3, 128), I32_MIN, np.int32)
    want = np.asarray(jref.run_boundaries_ref(jnp.asarray(p), nk))
    np.testing.assert_array_equal(want, [1, 0, 0])
    got = trb.run_boundaries_packed(torch.from_numpy(p), n_keys=nk)
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(jrb.run_boundaries_packed(jnp.asarray(p), n_keys=nk, interpret=True))
    np.testing.assert_array_equal(pallas, [0, 0, 0])


def test_run_boundaries_rejects_malformed_tables():
    p = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="128 lanes"):
        trb.run_boundaries_packed(p[:, :64].contiguous(), n_keys=1)
    with pytest.raises(ValueError, match="int32"):
        trb.run_boundaries_packed(p.long(), n_keys=1)
    with pytest.raises(ValueError, match="block_rows"):
        trb.run_boundaries_packed(p, n_keys=1, block_rows=0)
    for n_keys in (-1, 127):
        with pytest.raises(ValueError, match="group columns"):
            trb.run_boundaries_packed(p, n_keys=n_keys)
    with pytest.raises(ValueError, match="group columns"):
        tops.run_boundaries([np.zeros(4)] * 127, np.zeros(4), np.zeros(4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tops.run_boundaries([np.zeros(4)], np.zeros(4), np.zeros(4))
    assert trb.run_boundaries_packed(p[:0], n_keys=2).shape == (0,)
    np.testing.assert_array_equal(tref.run_boundaries_ref(p, 2).numpy(), [1, 0, 0, 0])
