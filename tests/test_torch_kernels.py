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
import repro_torch.kernels.ops as tops
import repro_torch.kernels.range_join as trj

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
@pytest.mark.parametrize("bq,br", [(32, 32), (64, 128), (128, 64)])
def test_tile_masks_match_pallas(bq, br):
    rng = np.random.default_rng(SEED + bq + br)
    nqb, nrb = 3, 4
    q, r = _packed(rng, nqb * bq, 2), _packed(rng, nrb * br, 2)
    tile_q = rng.integers(0, nqb, 7).astype(np.int32)
    tile_r = rng.integers(0, nrb, 7).astype(np.int32)
    want = np.asarray(
        jrj.range_join_tile_masks(
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(tile_q), jnp.asarray(tile_r),
            n_attrs=2, block_q=bq, block_r=br, interpret=True,
        )
    )
    got = trj.range_join_tile_masks(
        torch.from_numpy(q), torch.from_numpy(r),
        torch.from_numpy(tile_q), torch.from_numpy(tile_r),
        n_attrs=2, block_q=bq, block_r=br,
    )
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
