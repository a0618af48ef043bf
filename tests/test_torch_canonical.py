"""The port's canonical cut (``repro_torch.core.query.canonical_boxes``, one
segmented sweep per axis) against the JAX package's slab recursion
(``repro.core.query.canonical_boxes``): the same ``lo``/``hi`` bytes, shape
and dtype on random box lists of 1 to 4 axes, on edge cases, on a 2-D
answer of thousands of boxes, and for every decomposition of one cell set.
"""

import numpy as np
import pytest

import repro.core.query as jq
import repro_torch.core.query as tq


def _check(shape, lo, hi):
    """Both packages' cuts of one box list; returns the port's."""
    want = jq.canonical_boxes(jq.QueryBox(shape, lo, hi))
    q = tq.QueryBox(shape, lo, hi)
    got = tq.canonical_boxes(q)
    assert got.shape == want.shape
    assert got.lo.dtype == got.hi.dtype == want.lo.dtype == np.int64
    assert got.lo.shape == want.lo.shape and got.hi.shape == want.hi.shape
    assert got.lo.tobytes() == want.lo.tobytes()
    assert got.hi.tobytes() == want.hi.tobytes()
    if 0 < q.volume_upper() <= 1 << 20:
        assert got.cell_set() == q.cell_set()
    return got


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 17, 60])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nd", [1, 2, 3, 4])
def test_random_boxes_match_reference(nd, seed, n, dtype):
    # small spans and widths so that boxes overlap, touch and nest
    r = np.random.default_rng([nd, seed, n])
    span = int(r.integers(3, 16))
    width = int(r.integers(1, 6))
    lo = r.integers(0, span, (n, nd)).astype(dtype)
    hi = (lo + r.integers(0, width, (n, nd))).astype(dtype)
    _check((span + width,) * nd, lo, hi)


EDGE_CASES = {
    "no_boxes": ((6, 6), [], []),
    "one_box": ((6, 6), [[1, 2]], [[3, 4]]),
    "all_duplicates": ((6, 6), [[1, 2]] * 5, [[3, 4]] * 5),
    "touching_1d": ((12,), [[0], [3], [7]], [[2], [6], [9]]),
    "touching_2d": ((9, 9), [[0, 1], [3, 1], [6, 1]], [[2, 4], [5, 4], [8, 4]]),
    "one_cell_gap_1d": ((12,), [[0], [4]], [[2], [6]]),
    "one_cell_gap_2d": ((9, 9), [[0, 1], [0, 5]], [[4, 3], [4, 7]]),
    "nested": ((12, 12), [[0, 0], [2, 3], [4, 4]], [[9, 9], [5, 6], [4, 4]]),
    # slab [0, 1] and slab [3, 4] share a cross-section, a gap slab between
    "recurs_after_gap": ((8, 8), [[0, 0], [3, 0]], [[1, 3], [4, 3]]),
    # ... and after a slab with another cross-section
    "recurs_after_change": ((8, 8), [[0, 0], [2, 0], [3, 0]], [[1, 3], [2, 1], [4, 3]]),
    "overlap_on_later_axes": (
        (10, 10, 10), [[0, 0, 0], [0, 0, 3], [2, 5, 0]], [[4, 4, 4], [4, 4, 9], [6, 9, 9]]
    ),
    # coordinates so large that (slab, value) keys would overflow int64
    "huge_coordinates": (
        (1 << 62,) * 3,
        [[0, 1 << 61, 0], [1 << 60, 3, 1 << 61], [7, 1 << 61, 1 << 40]],
        [[1 << 61, 1 << 62, 1 << 50], [1 << 62, 1 << 52, 1 << 62], [1 << 61, 1 << 62, 1 << 41]],
    ),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_match_reference(case):
    shape, lo, hi = EDGE_CASES[case]
    nd = len(shape)
    lo = np.asarray(lo, np.int64).reshape(-1, nd)
    hi = np.asarray(hi, np.int64).reshape(-1, nd)
    got = _check(shape, lo, hi)
    if lo.shape[0] <= 1:
        q = tq.QueryBox(shape, lo, hi)
        assert tq.canonical_boxes(q) is q  # returned as it is
    if case.startswith(("touching", "all_duplicates")):
        assert got.n_rows == 1
    if case.startswith(("one_cell_gap", "recurs_after_gap")):
        assert got.n_rows == 2


def test_huge_random_coordinates_match_reference():
    r = np.random.default_rng(11)
    lo = r.integers(0, 1 << 61, (50, 3))
    hi = lo + r.integers(0, 1 << 58, (50, 3))
    _check((1 << 62,) * 3, lo, hi)


@pytest.mark.parametrize("kind", ["boxes", "cells"])
def test_thousands_of_boxes_in_2d_match_reference(kind):
    """As large as the wide cells' tail answers: 2,000 and more 2-D boxes."""
    r = np.random.default_rng(5)
    if kind == "boxes":
        lo = r.integers(0, 400, (2500, 2))
        hi = lo + r.integers(0, 12, (2500, 2))
    else:
        # a run of rows with holes, as single cells
        cells = np.stack(np.unravel_index(np.arange(3000, 6000), (64, 96)), axis=1)
        cells = cells[r.random(cells.shape[0]) < 0.8]
        lo = hi = cells
    assert lo.shape[0] >= 2000
    _check((420, 420), lo, hi)


@pytest.mark.parametrize("nd", [2, 3])
def test_canonical_boxes_decomposition_invariant(nd):
    """The port's cut is a function of the cell set alone."""
    rng = np.random.default_rng(nd)
    shape = (8,) * nd
    for _ in range(20):
        cells = rng.integers(0, 8, size=(int(rng.integers(1, 30)), nd))
        q = tq.QueryBox.from_cells(shape, cells)
        # a second decomposition of the same set: per-cell singletons,
        # duplicated and shuffled; a third: the first's merged boxes
        dup = np.repeat(cells, 2, axis=0)
        rng.shuffle(dup)
        q2 = tq.QueryBox.from_cells(shape, dup)
        q3 = tq.merge_boxes(q)
        c1 = tq.canonical_boxes(q)
        assert c1.cell_set() == q.cell_set()
        for other in (q2, q3):
            c = tq.canonical_boxes(other)
            assert c.lo.tobytes() == c1.lo.tobytes()
            assert c.hi.tobytes() == c1.hi.tobytes()
