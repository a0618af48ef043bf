"""Lineage capture adapters (paper §II.A, §VII.A), ported from
``repro.core.capture``.

DSLog is agnostic to capture methodology; this module supplies two of the
three families the paper evaluates:

1. **Symbolic captures** — for data-*independent* array ops (elementwise,
   reduce, matmul, conv, reshape, slice, …) the lineage is a pure function of
   shapes/op-args, so we generate the relation directly from the op spec.
2. **Value-dependent captures** — sort/gather/group-by/inner-join lineage is
   computed from the actual values (the paper's custom tracking functions).

The third, the jacobian-sparsity oracle ``capture_jacobian``, is still to be
ported (ROADMAP.md §1 "Still to port" item 3, via
``torch.func.jacfwd``).

All generators are vectorized numpy — they routinely emit 10⁶+ row
relations for the compression benchmarks.
"""

from __future__ import annotations

import numpy as np

from .relation import LineageRelation

__all__ = [
    "all_indices",
    "identity_lineage",
    "broadcast_lineage",
    "reduce_lineage",
    "softmax_lineage",
    "matmul_lineage",
    "outer_lineage",
    "transpose_lineage",
    "reshape_lineage",
    "slice_lineage",
    "concat_lineage",
    "pad_lineage",
    "tile_lineage",
    "repeat_lineage",
    "roll_lineage",
    "flip_lineage",
    "take_lineage",
    "conv1d_lineage",
    "conv2d_lineage",
    "cumulative_lineage",
    "triangular_lineage",
    "sort_lineage",
    "group_by_lineage",
    "inner_join_lineage",
    "xai_bipartite_lineage",
]


def all_indices(shape: tuple[int, ...]) -> np.ndarray:
    """All cell indices of an array, shape ``[prod(shape), ndim]``."""
    if not shape:
        return np.zeros((1, 0), np.int64)
    n = int(np.prod(shape))
    return np.stack(
        np.unravel_index(np.arange(n, dtype=np.int64), shape), axis=1
    )


# --------------------------------------------------------------------------- #
# Data-independent (symbolic) captures
# --------------------------------------------------------------------------- #
def identity_lineage(shape) -> LineageRelation:
    """Elementwise unary op: out[i] <- in[i]."""
    shape = tuple(shape)
    idx = all_indices(shape)
    return LineageRelation(shape, shape, idx, idx)


def broadcast_lineage(in_shape, out_shape) -> LineageRelation:
    """out[b] <- in[broadcast⁻¹(b)] with numpy right-aligned broadcasting."""
    in_shape, out_shape = tuple(in_shape), tuple(out_shape)
    out = all_indices(out_shape)
    nd_in, nd_out = len(in_shape), len(out_shape)
    cols = []
    for ax_in in range(nd_in):
        ax_out = ax_in + (nd_out - nd_in)
        c = out[:, ax_out]
        if in_shape[ax_in] == 1 and out_shape[ax_out] != 1:
            c = np.zeros_like(c)
        cols.append(c)
    inn = np.stack(cols, axis=1) if cols else np.zeros((out.shape[0], 0), np.int64)
    return LineageRelation(out_shape, in_shape, out, inn)


def reduce_lineage(in_shape, axes, keepdims: bool = False) -> LineageRelation:
    """sum/mean/max/… over ``axes``: every input cell feeds its slot."""
    in_shape = tuple(in_shape)
    axes = tuple(sorted(a % len(in_shape) for a in (axes if hasattr(axes, "__len__") else [axes])))
    inn = all_indices(in_shape)
    keep = [a for a in range(len(in_shape)) if a not in axes]
    if keepdims:
        out_shape = tuple(1 if a in axes else d for a, d in enumerate(in_shape))
        out = inn.copy()
        out[:, list(axes)] = 0
    else:
        out_shape = tuple(in_shape[a] for a in keep) or (1,)
        out = inn[:, keep] if keep else np.zeros((inn.shape[0], 1), np.int64)
    return LineageRelation(out_shape, in_shape, out, inn)


def softmax_lineage(shape, axis: int) -> LineageRelation:
    """out[.., i, ..] <- in[.., i', ..] for every i' along ``axis``."""
    shape = tuple(shape)
    axis = axis % len(shape)
    base = all_indices(shape)
    n_axis = shape[axis]
    out = np.repeat(base, n_axis, axis=0)
    inn = out.copy()
    inn[:, axis] = np.tile(np.arange(n_axis, dtype=np.int64), base.shape[0])
    return LineageRelation(shape, shape, out, inn)


def matmul_lineage(M: int, K: int, N: int) -> tuple[LineageRelation, LineageRelation]:
    """C = A @ B:  C[i,j] <- A[i,k] ∀k  and  C[i,j] <- B[k,j] ∀k."""
    grid = all_indices((M, N, K))
    i, j, k = grid[:, 0], grid[:, 1], grid[:, 2]
    out = np.stack([i, j], axis=1)
    rel_a = LineageRelation((M, N), (M, K), out, np.stack([i, k], axis=1))
    rel_b = LineageRelation((M, N), (K, N), out, np.stack([k, j], axis=1))
    return rel_a, rel_b


def outer_lineage(M: int, N: int) -> tuple[LineageRelation, LineageRelation]:
    grid = all_indices((M, N))
    rel_a = LineageRelation((M, N), (M,), grid, grid[:, :1])
    rel_b = LineageRelation((M, N), (N,), grid, grid[:, 1:])
    return rel_a, rel_b


def transpose_lineage(in_shape, perm) -> LineageRelation:
    in_shape = tuple(in_shape)
    perm = tuple(p % len(in_shape) for p in perm)
    out_shape = tuple(in_shape[p] for p in perm)
    out = all_indices(out_shape)
    inn = np.empty_like(out)
    for o_ax, i_ax in enumerate(perm):
        inn[:, i_ax] = out[:, o_ax]
    return LineageRelation(out_shape, in_shape, out, inn)


def reshape_lineage(in_shape, out_shape) -> LineageRelation:
    in_shape, out_shape = tuple(in_shape), tuple(out_shape)
    n = int(np.prod(in_shape))
    flat = np.arange(n, dtype=np.int64)
    out = np.stack(np.unravel_index(flat, out_shape), axis=1)
    inn = np.stack(np.unravel_index(flat, in_shape), axis=1)
    return LineageRelation(out_shape, in_shape, out, inn)


def slice_lineage(in_shape, starts, stops, steps=None) -> LineageRelation:
    in_shape = tuple(in_shape)
    nd = len(in_shape)
    steps = steps or (1,) * nd
    out_shape = tuple(
        max(0, (stop - start + step - 1) // step)
        for start, stop, step in zip(starts, stops, steps)
    )
    out = all_indices(out_shape)
    inn = out * np.array(steps, np.int64) + np.array(starts, np.int64)
    return LineageRelation(out_shape, in_shape, out, inn)


def concat_lineage(shapes, axis: int) -> list[LineageRelation]:
    shapes = [tuple(s) for s in shapes]
    axis = axis % len(shapes[0])
    total = sum(s[axis] for s in shapes)
    out_shape = list(shapes[0])
    out_shape[axis] = total
    out_shape = tuple(out_shape)
    rels, off = [], 0
    for s in shapes:
        inn = all_indices(s)
        out = inn.copy()
        out[:, axis] += off
        rels.append(LineageRelation(out_shape, s, out, inn))
        off += s[axis]
    return rels


def pad_lineage(in_shape, pad_width) -> LineageRelation:
    in_shape = tuple(in_shape)
    out_shape = tuple(
        d + lo + hi for d, (lo, hi) in zip(in_shape, pad_width)
    )
    inn = all_indices(in_shape)
    out = inn + np.array([lo for lo, _ in pad_width], np.int64)
    return LineageRelation(out_shape, in_shape, out, inn)


def tile_lineage(in_shape, reps) -> LineageRelation:
    in_shape = tuple(in_shape)
    reps = tuple(reps)
    out_shape = tuple(d * r for d, r in zip(in_shape, reps))
    out = all_indices(out_shape)
    inn = out % np.array(in_shape, np.int64)
    return LineageRelation(out_shape, in_shape, out, inn)


def repeat_lineage(in_shape, repeats: int, axis: int) -> LineageRelation:
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    out_shape = list(in_shape)
    out_shape[axis] *= repeats
    out_shape = tuple(out_shape)
    out = all_indices(out_shape)
    inn = out.copy()
    inn[:, axis] //= repeats
    return LineageRelation(out_shape, in_shape, out, inn)


def roll_lineage(in_shape, shift: int, axis: int) -> LineageRelation:
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    out = all_indices(in_shape)
    inn = out.copy()
    inn[:, axis] = (inn[:, axis] - shift) % in_shape[axis]
    return LineageRelation(in_shape, in_shape, out, inn)


def flip_lineage(in_shape, axis: int) -> LineageRelation:
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    out = all_indices(in_shape)
    inn = out.copy()
    inn[:, axis] = in_shape[axis] - 1 - inn[:, axis]
    return LineageRelation(in_shape, in_shape, out, inn)


def take_lineage(in_shape, indices: np.ndarray, axis: int) -> LineageRelation:
    """Value-dependent gather along ``axis``."""
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    indices = np.asarray(indices, np.int64).ravel()
    out_shape = list(in_shape)
    out_shape[axis] = indices.size
    out_shape = tuple(out_shape)
    out = all_indices(out_shape)
    inn = out.copy()
    inn[:, axis] = indices[out[:, axis]]
    return LineageRelation(out_shape, in_shape, out, inn)


def conv1d_lineage(n: int, k: int, stride: int = 1) -> LineageRelation:
    """Valid 1-D convolution: out[i] <- in[i·s + d], d ∈ [0, k-1]."""
    n_out = (n - k) // stride + 1
    grid = all_indices((n_out, k))
    out = grid[:, :1]
    inn = (grid[:, :1] * stride + grid[:, 1:2])
    return LineageRelation((n_out,), (n,), out, inn)


def conv2d_lineage(h: int, w: int, kh: int, kw: int, stride: int = 1) -> LineageRelation:
    h_out = (h - kh) // stride + 1
    w_out = (w - kw) // stride + 1
    grid = all_indices((h_out, w_out, kh, kw))
    out = grid[:, :2]
    inn = np.stack(
        [grid[:, 0] * stride + grid[:, 2], grid[:, 1] * stride + grid[:, 3]], axis=1
    )
    return LineageRelation((h_out, w_out), (h, w), out, inn)


def cumulative_lineage(n: int) -> LineageRelation:
    """cumsum/cumprod: out[i] <- in[j], j <= i (triangular)."""
    i, j = np.tril_indices(n)
    return LineageRelation((n,), (n,), i[:, None], j[:, None])


def triangular_lineage(b: int, s: int) -> LineageRelation:
    """Causal attention mixing: out[b, t] <- in[b, t'], t' <= t."""
    t, tp = np.tril_indices(s)
    nb = np.repeat(np.arange(b, dtype=np.int64), t.size)
    t = np.tile(t, b)
    tp = np.tile(tp, b)
    return LineageRelation(
        (b, s), (b, s), np.stack([nb, t], 1), np.stack([nb, tp], 1)
    )


# --------------------------------------------------------------------------- #
# Value-dependent captures
# --------------------------------------------------------------------------- #
def sort_lineage(values: np.ndarray, axis: int = -1) -> LineageRelation:
    """out[.., r, ..] <- in[.., argsort(values)[r], ..]."""
    values = np.asarray(values)
    axis = axis % values.ndim
    perm = np.argsort(values, axis=axis, kind="stable")
    out = all_indices(values.shape)
    inn = out.copy()
    # perm laid out in C order matches the all_indices enumeration directly
    inn[:, axis] = perm.reshape(-1)
    return LineageRelation(values.shape, values.shape, out, inn)


def group_by_lineage(keys: np.ndarray, n_cols: int) -> LineageRelation:
    """Group-by aggregate over a 2-D table: out[g, c] <- in[r, c], key[r]=g-th key."""
    keys = np.asarray(keys)
    uniq, inv = np.unique(keys, return_inverse=True)
    n = keys.size
    rows = np.arange(n, dtype=np.int64)
    out_g = inv.astype(np.int64)
    col = np.arange(n_cols, dtype=np.int64)
    out = np.stack(
        [np.repeat(out_g, n_cols), np.tile(col, n)], axis=1
    )
    inn = np.stack([np.repeat(rows, n_cols), np.tile(col, n)], axis=1)
    return LineageRelation((uniq.size, n_cols), (n, n_cols), out, inn)


def inner_join_lineage(
    left_keys: np.ndarray,
    right_keys: np.ndarray,
    left_cols: int,
    right_cols: int,
) -> tuple[LineageRelation, LineageRelation]:
    """Inner equi-join of two 2-D tables on key columns.

    Output row t = (left row i ⨝ right row j); columns are
    [left cols..., right cols...].
    """
    left_keys = np.asarray(left_keys)
    right_keys = np.asarray(right_keys)
    # sorted-merge join, vectorized
    lo = np.argsort(left_keys, kind="stable")
    ro = np.argsort(right_keys, kind="stable")
    lk, rk = left_keys[lo], right_keys[ro]
    # match counts per left row via searchsorted
    starts = np.searchsorted(rk, lk, side="left")
    ends = np.searchsorted(rk, lk, side="right")
    counts = ends - starts
    li = np.repeat(np.arange(lk.size), counts)
    offsets = np.repeat(starts, counts) + (
        np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    )
    ri = offsets
    left_rows = lo[li]
    right_rows = ro[ri]
    n_out = left_rows.size
    out_cols_total = left_cols + right_cols
    t = np.arange(n_out, dtype=np.int64)

    # lineage vs LEFT table: out[t, c] <- left[left_rows[t], c] for c < left_cols
    lc = np.arange(left_cols, dtype=np.int64)
    out_l = np.stack([np.repeat(t, left_cols), np.tile(lc, n_out)], axis=1)
    in_l = np.stack(
        [np.repeat(left_rows, left_cols), np.tile(lc, n_out)], axis=1
    )
    rel_l = LineageRelation(
        (n_out, out_cols_total), (left_keys.size, left_cols), out_l, in_l
    )
    rc = np.arange(right_cols, dtype=np.int64)
    out_r = np.stack(
        [np.repeat(t, right_cols), np.tile(rc, n_out) + left_cols], axis=1
    )
    in_r = np.stack(
        [np.repeat(right_rows, right_cols), np.tile(rc, n_out)], axis=1
    )
    rel_r = LineageRelation(
        (n_out, out_cols_total), (right_keys.size, right_cols), out_r, in_r
    )
    return rel_l, rel_r


def xai_bipartite_lineage(
    in_shape: tuple[int, ...],
    n_out: int,
    n_patches: int,
    patch: int,
    seed: int = 0,
) -> LineageRelation:
    """LIME/D-RISE-style capture: each output label cell is attributed to a
    set of contiguous 2-D patches of the input (superpixels above the
    significance threshold).  Statistically matches the paper's XAI captures:
    block-structured and therefore range-compressible."""
    rng = np.random.default_rng(seed)
    h, w = in_shape
    outs, inns = [], []
    for o in range(n_out):
        for _ in range(n_patches):
            i0 = int(rng.integers(0, max(1, h - patch)))
            j0 = int(rng.integers(0, max(1, w - patch)))
            ii, jj = np.meshgrid(
                np.arange(i0, min(h, i0 + patch)),
                np.arange(j0, min(w, j0 + patch)),
                indexing="ij",
            )
            cells = np.stack([ii.ravel(), jj.ravel()], axis=1)
            outs.append(np.full((cells.shape[0], 1), o, np.int64))
            inns.append(cells)
    return LineageRelation(
        (n_out,), in_shape, np.concatenate(outs), np.concatenate(inns)
    ).canonical()
