"""Relational data model for fine-grained array lineage (paper §III.B).

A :class:`LineageRelation` is the uncompressed relation
``R(b_1..b_l, a_1..a_m)`` between an *output* array ``B`` and an *input*
array ``A``: one row per contribution ``B[b...] <- A[a...]``.  Rows are
unique (set semantics), which is what makes the UCP argument of the paper's
correctness proof go through.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["LineageRelation", "axis_names"]


def axis_names(prefix: str, ndim: int) -> tuple[str, ...]:
    return tuple(f"{prefix}{i}" for i in range(ndim))


@dataclass
class LineageRelation:
    """Uncompressed lineage rows between one output and one input array."""

    out_shape: tuple[int, ...]
    in_shape: tuple[int, ...]
    # int64 [N, l] and [N, m]; row i means out_idx[i] <- in_idx[i].
    out_idx: np.ndarray = field(repr=False)
    in_idx: np.ndarray = field(repr=False)
    out_attrs: tuple[str, ...] = ()
    in_attrs: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.out_idx = np.asarray(self.out_idx, dtype=np.int64).reshape(
            -1, len(self.out_shape)
        )
        self.in_idx = np.asarray(self.in_idx, dtype=np.int64).reshape(
            -1, len(self.in_shape)
        )
        if self.out_idx.shape[0] != self.in_idx.shape[0]:
            raise ValueError("out_idx and in_idx row counts differ")
        if not self.out_attrs:
            self.out_attrs = axis_names("b", len(self.out_shape))
        if not self.in_attrs:
            self.in_attrs = axis_names("a", len(self.in_shape))

    # ------------------------------------------------------------------ #
    @property
    def n_rows(self) -> int:
        return int(self.out_idx.shape[0])

    @property
    def ndim_out(self) -> int:
        return len(self.out_shape)

    @property
    def ndim_in(self) -> int:
        return len(self.in_shape)

    def rows(self) -> np.ndarray:
        """All columns side by side: ``[b_1..b_l, a_1..a_m]``."""
        return np.concatenate([self.out_idx, self.in_idx], axis=1)

    def nbytes_raw(self) -> int:
        """Size of the row-oriented int64 materialization (the Raw baseline)."""
        return self.rows().nbytes

    # ------------------------------------------------------------------ #
    def canonical(self) -> "LineageRelation":
        """Sorted + deduplicated copy (set semantics)."""
        rows = self.rows()
        rows = np.unique(rows, axis=0)
        l = self.ndim_out
        return LineageRelation(
            self.out_shape,
            self.in_shape,
            rows[:, :l],
            rows[:, l:],
            self.out_attrs,
            self.in_attrs,
        )

    def as_set(self) -> set[tuple[int, ...]]:
        return {tuple(int(v) for v in row) for row in self.rows()}

    def __eq__(self, other: object) -> bool:  # type: ignore[override]
        if not isinstance(other, LineageRelation):
            return NotImplemented
        if self.out_shape != other.out_shape or self.in_shape != other.in_shape:
            return False
        a = np.unique(self.rows(), axis=0)
        b = np.unique(other.rows(), axis=0)
        return a.shape == b.shape and bool(np.array_equal(a, b))

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_pairs(
        out_shape: tuple[int, ...],
        in_shape: tuple[int, ...],
        pairs: "np.ndarray | list[tuple[tuple[int, ...], tuple[int, ...]]]",
    ) -> "LineageRelation":
        """Build from explicit ``(out_idx_tuple, in_idx_tuple)`` pairs."""
        if isinstance(pairs, np.ndarray):
            l = len(out_shape)
            return LineageRelation(out_shape, in_shape, pairs[:, :l], pairs[:, l:])
        out_rows = np.array([p[0] for p in pairs], dtype=np.int64).reshape(
            len(pairs), len(out_shape)
        )
        in_rows = np.array([p[1] for p in pairs], dtype=np.int64).reshape(
            len(pairs), len(in_shape)
        )
        return LineageRelation(out_shape, in_shape, out_rows, in_rows)

    @staticmethod
    def from_flat(
        out_shape: tuple[int, ...],
        in_shape: tuple[int, ...],
        out_flat: np.ndarray,
        in_flat: np.ndarray,
    ) -> "LineageRelation":
        """Build from flat (raveled) cell ids on each side."""
        out_idx = np.stack(
            np.unravel_index(np.asarray(out_flat, dtype=np.int64), out_shape), axis=1
        )
        in_idx = np.stack(
            np.unravel_index(np.asarray(in_flat, dtype=np.int64), in_shape), axis=1
        )
        return LineageRelation(out_shape, in_shape, out_idx, in_idx)
