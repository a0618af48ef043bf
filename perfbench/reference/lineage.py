"""Lineage relations as explicit pairs, built with numpy alone.

A frozen copy of the constructors the fig 8/9 workflows use (the paper's
symbolic and value-dependent captures, arXiv:2405.17701 §II.A): each
returns a :class:`Rel`, one row per contribution ``out[out_idx[i]] <-
in[in_idx[i]]``.  The harness hands the same arrays to the program (as its
``LineageRelation``) and to the reference joins of :mod:`.oracle`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Rel:
    out_shape: tuple
    in_shape: tuple
    out_idx: np.ndarray  # int64 [N, len(out_shape)]
    in_idx: np.ndarray  # int64 [N, len(in_shape)]

    @property
    def n_pairs(self) -> int:
        return int(self.out_idx.shape[0])

    def flat(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat (row-major) cell ids of each pair: ``(out, in)``."""
        return (np.ravel_multi_index(self.out_idx.T, self.out_shape),
                np.ravel_multi_index(self.in_idx.T, self.in_shape))


def all_indices(shape) -> np.ndarray:
    n = int(np.prod(shape))
    return np.stack(np.unravel_index(np.arange(n, dtype=np.int64), shape), axis=1)


def identity(shape) -> Rel:
    shape = tuple(shape)
    idx = all_indices(shape)
    return Rel(shape, shape, idx, idx)


def reduce(in_shape, axes) -> Rel:
    in_shape = tuple(in_shape)
    axes = sorted(a % len(in_shape) for a in (axes if isinstance(axes, (list, tuple)) else [axes]))
    inn = all_indices(in_shape)
    keep = [a for a in range(len(in_shape)) if a not in axes]
    out_shape = tuple(in_shape[a] for a in keep) or (1,)
    out = inn[:, keep] if keep else np.zeros((inn.shape[0], 1), np.int64)
    return Rel(out_shape, in_shape, out, inn)


def transpose(in_shape, perm) -> Rel:
    in_shape = tuple(in_shape)
    perm = tuple(p % len(in_shape) for p in perm)
    out_shape = tuple(in_shape[p] for p in perm)
    out = all_indices(out_shape)
    inn = np.empty_like(out)
    for o_ax, i_ax in enumerate(perm):
        inn[:, i_ax] = out[:, o_ax]
    return Rel(out_shape, in_shape, out, inn)


def reshape(in_shape, out_shape) -> Rel:
    in_shape, out_shape = tuple(in_shape), tuple(out_shape)
    flat = np.arange(int(np.prod(in_shape)), dtype=np.int64)
    return Rel(out_shape, in_shape, np.stack(np.unravel_index(flat, out_shape), axis=1),
               np.stack(np.unravel_index(flat, in_shape), axis=1))


def strided_slice(in_shape, starts, stops, steps) -> Rel:
    in_shape = tuple(in_shape)
    out_shape = tuple(max(0, (b - a + s - 1) // s) for a, b, s in zip(starts, stops, steps))
    out = all_indices(out_shape)
    return Rel(out_shape, in_shape, out, out * np.array(steps, np.int64) + np.array(starts, np.int64))


def roll(in_shape, shift, axis) -> Rel:
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    out = all_indices(in_shape)
    inn = out.copy()
    inn[:, axis] = (inn[:, axis] - shift) % in_shape[axis]
    return Rel(in_shape, in_shape, out, inn)


def flip(in_shape, axis) -> Rel:
    in_shape = tuple(in_shape)
    axis = axis % len(in_shape)
    out = all_indices(in_shape)
    inn = out.copy()
    inn[:, axis] = in_shape[axis] - 1 - inn[:, axis]
    return Rel(in_shape, in_shape, out, inn)


def conv2d(h, w, kh, kw) -> Rel:
    """Valid 2-D correlation: out[i, j] <- in[i + di, j + dj]."""
    grid = all_indices((h - kh + 1, w - kw + 1, kh, kw))
    inn = np.stack([grid[:, 0] + grid[:, 2], grid[:, 1] + grid[:, 3]], axis=1)
    return Rel((h - kh + 1, w - kw + 1), (h, w), grid[:, :2], inn)


def sort(values: np.ndarray, axis: int = -1) -> Rel:
    """out[.., r, ..] <- in[.., argsort(values)[r], ..] (stable)."""
    axis = axis % values.ndim
    perm = np.argsort(values, axis=axis, kind="stable")
    out = all_indices(values.shape)
    inn = out.copy()
    inn[:, axis] = perm.reshape(-1)
    return Rel(values.shape, values.shape, out, inn)


def inner_join(left_keys: np.ndarray, right_keys: np.ndarray, left_cols: int,
               right_cols: int) -> Rel:
    """Inner equi-join of two 2-D tables; the lineage of the output (left
    columns, then right columns) against the left table."""
    lo = np.argsort(left_keys, kind="stable")
    ro = np.argsort(right_keys, kind="stable")
    lk, rk = left_keys[lo], right_keys[ro]
    starts = np.searchsorted(rk, lk, side="left")
    counts = np.searchsorted(rk, lk, side="right") - starts
    left_rows = lo[np.repeat(np.arange(lk.size), counts)]
    n_out = left_rows.size
    t = np.arange(n_out, dtype=np.int64)
    c = np.arange(left_cols, dtype=np.int64)
    out = np.stack([np.repeat(t, left_cols), np.tile(c, n_out)], axis=1)
    inn = np.stack([np.repeat(left_rows, left_cols), np.tile(c, n_out)], axis=1)
    return Rel((n_out, left_cols + right_cols), (left_keys.size, left_cols), out, inn)

