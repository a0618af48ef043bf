"""Port compression vs the JAX package's: the same relations, made from a
numpy seed, compress to the same ``CompressedTable.serialize()`` and
``IntervalIndex.to_bytes()`` bytes in ``repro.core`` and
``repro_torch.core``, and a table serialized by either package
deserializes in the other and answers the same joins (tolerance 0)."""

import numpy as np
import pytest

import repro.core.capture as jC
import repro.core.index as jindex
import repro.core.provrc as jprovrc
import repro.core.query as jquery
import repro.core.table as jtable
import repro_torch.core.capture as tC
import repro_torch.core.index as tindex
import repro_torch.core.provrc as tprovrc
import repro_torch.core.query as tquery
import repro_torch.core.relation as trelation
import repro_torch.core.table as ttable
from repro.core.relation import LineageRelation as JRelation

SEED = 20240527
METHODS = ["paper", "vector"]


def _both(build):
    """The same relation from each package's capture module."""
    return build(jC), build(tC)


def _random_pair(seed, l, m, n, side=(2, 7)):
    rng = np.random.default_rng(seed)
    oshape = tuple(int(rng.integers(*side)) for _ in range(l))
    ishape = tuple(int(rng.integers(*side)) for _ in range(m))
    o = np.stack([rng.integers(0, s, n) for s in oshape], axis=1)
    i = np.stack([rng.integers(0, s, n) for s in ishape], axis=1)
    return (
        JRelation(oshape, ishape, o, i).canonical(),
        trelation.LineageRelation(oshape, ishape, o, i).canonical(),
    )


CASES = {
    "fig1_sum_axis1": lambda C: C.reduce_lineage((3, 2), 1),
    "fig2_aggregate_all": lambda C: C.reduce_lineage((3, 2), (0, 1)),
    "elementwise": lambda C: C.identity_lineage((6, 5)),
    "matmul": lambda C: C.matmul_lineage(4, 5, 3)[0],
    "conv1d": lambda C: C.conv1d_lineage(100, 5),
    "conv2d": lambda C: C.conv2d_lineage(12, 10, 3, 3),
    "reduce": lambda C: C.reduce_lineage((12, 7), 0),
    "softmax": lambda C: C.softmax_lineage((6, 9), -1),
    "tile": lambda C: C.tile_lineage((5, 4), (2, 3)),
    "sort": lambda C: C.sort_lineage(np.random.default_rng(0).random(128)),
    "transpose": lambda C: C.transpose_lineage((7, 4), (1, 0)),
    "slice": lambda C: C.slice_lineage((16, 16), (0, 0), (16, 16), (2, 2)),
    "inner_join": lambda C: C.inner_join_lineage(
        np.random.default_rng(3).integers(0, 50, 100),
        np.random.default_rng(4).integers(0, 50, 50), 3, 2,
    )[0],
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_both_same_bytes(case, method):
    jrel, trel = _both(CASES[case])
    assert jrel.rows().tobytes() == trel.rows().tobytes()
    jb, jf = jprovrc.compress_both(jrel, method=method)
    tb, tf = tprovrc.compress_both(trel, method=method)
    for gz in (False, True):
        assert tb.serialize(compress=gz) == jb.serialize(compress=gz)
        assert tf.serialize(compress=gz) == jf.serialize(compress=gz)


@pytest.mark.parametrize("seed,l,m", [(1, 1, 1), (2, 1, 2), (3, 2, 1), (4, 2, 2), (5, 3, 2)])
def test_random_relations_same_table_and_index_bytes(seed, l, m):
    jrel, trel = _random_pair(SEED + seed, l, m, 60)
    for direction in ("backward", "forward"):
        jt = jprovrc.compress(jrel, direction)
        tt = tprovrc.compress(trel, direction)
        assert tt.serialize() == jt.serialize()
        assert tt.key_index().to_bytes() == jt.key_index().to_bytes()
        assert tt.val_index().to_bytes() == jt.val_index().to_bytes()


def test_index_bytes_and_probes_match():
    rng = np.random.default_rng(SEED)
    lo = rng.integers(0, 50, (200, 2)).astype(np.int64)
    hi = lo + rng.integers(0, 5, (200, 2))
    jidx, tidx = jindex.IntervalIndex(lo, hi), tindex.IntervalIndex(lo, hi)
    assert tidx.to_bytes() == jidx.to_bytes()
    q_lo = rng.integers(0, 50, (9, 2)).astype(np.int64)
    q_hi = q_lo + 3
    for a, b in zip(jidx.candidate_pairs(q_lo, q_hi), tidx.candidate_pairs(q_lo, q_hi)):
        np.testing.assert_array_equal(a, b)
    # cross attach: each package reads the other's sidecar
    t2 = tindex.IntervalIndex.from_bytes(jidx.to_bytes(), lo, hi)
    j2 = jindex.IntervalIndex.from_bytes(tidx.to_bytes(), lo, hi)
    np.testing.assert_array_equal(t2.order, jidx.order)
    np.testing.assert_array_equal(j2.order, tidx.order)
    with pytest.raises(ValueError):
        tindex.IntervalIndex.from_bytes(jidx.to_bytes(), lo[:10], hi[:10])


def _joins_agree(jt, tt, seed):
    """Forward and inverse θ-joins of both tables on the same boxes."""
    rng = np.random.default_rng(seed)
    for inverse in (False, True):
        shape = jt.val_shape if inverse else jt.key_shape
        lo = np.stack([rng.integers(0, s, 5) for s in shape], axis=1)
        hi = np.minimum(lo + rng.integers(0, 3, lo.shape), np.array(shape) - 1)
        jfn = jquery.theta_join_inverse if inverse else jquery.theta_join
        tfn = tquery.theta_join_inverse if inverse else tquery.theta_join
        want = jfn(jquery.QueryBox(shape, lo, hi), jt)
        got = tfn(tquery.QueryBox(shape, lo, hi), tt, device="cpu")
        assert got.lo.tobytes() == want.lo.tobytes()
        assert got.hi.tobytes() == want.hi.tobytes()


@pytest.mark.parametrize("case", ["conv2d", "inner_join", "sort", "tile"])
def test_cross_deserialization_answers_same_joins(case):
    jrel, trel = _both(CASES[case])
    jt = jprovrc.compress(jrel)
    tt = tprovrc.compress(trel)
    for gz in (False, True):
        from_ref = ttable.CompressedTable.deserialize(jt.serialize(compress=gz))
        from_port = jtable.CompressedTable.deserialize(tt.serialize(compress=gz))
        assert from_ref.serialize() == jt.serialize()
        assert from_port.serialize() == tt.serialize()
        _joins_agree(jt, from_ref, SEED)
        _joins_agree(from_port, tt, SEED + 1)
    with pytest.raises(ValueError, match="ProvRC"):
        ttable.CompressedTable.deserialize(b"not a table")


def test_from_reference_arrays_round_trips():
    jrel, _ = _both(CASES["conv2d"])
    jt = jprovrc.compress(jrel, "forward")
    tt = ttable.from_reference_arrays(
        jt.key_shape, jt.val_shape, jt.key_lo, jt.key_hi, jt.val_lo, jt.val_hi,
        jt.val_ref, jt.direction, jt.key_sym, jt.val_sym,
    )
    assert tt.serialize() == jt.serialize()
    assert tt.key_lo is not jt.key_lo  # copies, never shared buffers
    tt.key_lo[0, 0] += 1
    assert tt.serialize() != jt.serialize()
    _joins_agree(jt, ttable.CompressedTable.deserialize(jt.serialize()), SEED + 2)


def test_decompress_is_lossless_in_both_packages():
    jrel, trel = _random_pair(SEED + 9, 2, 2, 40)
    jt, tt = jprovrc.compress(jrel), tprovrc.compress(trel)
    assert tt.decompress() == trel
    assert tt.decompress().rows().tobytes() == jt.decompress().rows().tobytes()
