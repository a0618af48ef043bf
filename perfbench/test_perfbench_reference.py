"""The plain reference against the program on the CPU at tiny sizes: sound
runs read correct, the control and the faults a run can have read not
correct."""

import numpy as np
import pytest

from perfbench.reference import lineage as L
from perfbench.reference import oracle
from perfbench.testing import run_tiny, tiny_config

QUERY_CELLS = ["fig89.query_wide", "fig89.query_point"]


@pytest.mark.parametrize("cell", QUERY_CELLS)
def test_program_matches_reference(cell):
    r = run_tiny(cell, 2**35 + 17)
    assert r["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert r["checks"]["answers_checked"]["value"] >= 2
    assert r["correct"] is True and r["attempted"] > 0


@pytest.mark.parametrize("cell", QUERY_CELLS)
def test_control_reads_not_correct(cell):
    """The control (answers widened to their bounding box) fails the
    comparison the cell makes."""
    r = run_tiny(cell, 9, control=True)
    assert r["correct"] is True
    assert r["control"]["wrong_answers"] > r["checks"]["wrong_answers"]["limit"]


def _patch_answers(monkeypatch, alter):
    from repro_torch.core import DSLog

    orig = DSLog.prov_query

    def broken(self, *args, **kw):
        return alter(orig, self, args, kw)

    monkeypatch.setattr(DSLog, "prov_query", broken)


def _shift_last_box(orig, log, args, kw):
    """One box of the answer moved by a cell, or dropped where it spans its
    whole array."""
    res = orig(log, *args, **kw)
    if res.n_rows:
        lo, hi = res.lo.copy(), res.hi.copy()
        d = res.lo.shape[1] - 1
        if hi[-1, d] + 1 < res.shape[d]:
            lo[-1, d] += 1
            hi[-1, d] += 1
        elif lo[-1, d] > 0:
            lo[-1, d] -= 1
            hi[-1, d] -= 1
        else:
            lo, hi = lo[:-1], hi[:-1]
        res = type(res)(res.shape, lo, hi)
    return res


def _half_batch(orig, log, args, kw):
    *head, cells = args
    return orig(log, *head, cells[: max(1, len(cells) // 2)], **kw)


@pytest.mark.parametrize("cell", QUERY_CELLS)
@pytest.mark.parametrize("fault", [_shift_last_box, _half_batch], ids=["answer_altered", "half_batch"])
def test_fault_reads_not_correct(monkeypatch, cell, fault):
    _patch_answers(monkeypatch, fault)
    r = run_tiny(cell, 23)
    assert r["correct"] is False
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_reference_propagates_over_fan_in():
    shape = (2, 3)
    rng = np.random.default_rng(0)
    a, b = L.sort(rng.random(shape), axis=1), L.sort(rng.random(shape), axis=0)
    edges = [("s", "x", a), ("s", "y", b), ("x", "t", L.identity(shape)),
             ("y", "t", L.identity(shape))]
    shapes = {k: shape for k in "sxyt"}
    got = oracle.propagate(edges, "s", "t", np.array([0]), shapes)
    ao, ai = a.flat()
    bo, bi = b.flat()
    assert sorted(got.tolist()) == sorted({int(ao[ai == 0][0]), int(bo[bi == 0][0])})
    back = oracle.propagate(edges, "t", "s", got, shapes)
    assert 0 in back.tolist()


def test_bounding_box_and_box_cells():
    shape = (4, 5)
    cells = np.ravel_multi_index(np.array([[0, 1], [2, 3]]).T, shape)
    assert oracle.bounding_box(shape, cells).tolist() == [1, 2, 3, 6, 7, 8, 11, 12, 13]
    assert oracle.box_cells(shape, np.array([[0, 0], [3, 4]]), np.array([[0, 1], [3, 4]])).tolist() \
        == [0, 1, 19]
