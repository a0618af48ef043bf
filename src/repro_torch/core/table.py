"""Compressed lineage table produced by ProvRC (paper §IV).

The port of ``repro.core.table``: the same fields, dtypes and
``serialize()`` bytes, so either package reads the other's tables.  The
reference's lazy ``TableHandle`` serves persisted stores and comes with
save/load (ROADMAP.md §1 "Still to port" item 2).

Layout
------
A table stores ``N`` compressed rows over ``l`` *key* attributes and ``m``
*value* attributes.  For the canonical **backward** materialization the keys
are the output-array axes and the values the input-array axes; the
**forward** materialization swaps the roles (paper §IV.C — "a version where
output attributes can have relative indices, but input attributes are
absolute").  The query engine only ever sees (key, value) so one θ-join
implementation serves both directions.

Per row:

* ``key_lo/key_hi``  — absolute closed intervals, one per key attribute.
* ``val_lo/val_hi``  — closed intervals, one per value attribute.
* ``val_ref``        — ``-1`` ⇒ the value interval is absolute;
  ``j >= 0`` ⇒ it is a *delta* relative to key attribute ``j``
  (stored value = ``val − key_j``, so de-relativization is pure addition —
  see DESIGN.md for why we flip the paper's ``b−a`` sign convention).
* ``key_sym/val_sym`` — ``-1`` or the axis id whose *full extent* this
  interval spans; used by index reshaping for ``gen_sig`` reuse (paper §VI.B).

Row semantics (the all-to-all insight of §V.B): a row denotes the set

    { (k, v) :  k ∈ ∏_j [key_lo_j, key_hi_j],
                v_i ∈ [val_lo_i, val_hi_i]                  if ref_i == -1
                v_i − k_{ref_i} ∈ [val_lo_i, val_hi_i]      otherwise }
"""

from __future__ import annotations

import io
import json
import zlib
from dataclasses import dataclass, field, replace

import numpy as np

from .index import IntervalIndex, interval_stats
from .relation import LineageRelation

__all__ = ["CompressedTable", "from_reference_arrays"]

_MAGIC = b"PRVC1\n"

# Reassigning any of these drops the cached interval indexes (see
# ``CompressedTable.__setattr__``); for *in-place* ndarray mutation call
# ``invalidate_index()`` explicitly.
_ARRAY_FIELDS = frozenset(
    {"key_lo", "key_hi", "val_lo", "val_hi", "val_ref", "key_sym", "val_sym"}
)


def _pack_array(a: np.ndarray) -> np.ndarray:
    """Downcast to the narrowest signed integer dtype that holds the data."""
    if a.size == 0:
        return a.astype(np.int8)
    lo, hi = int(a.min()), int(a.max())
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return a.astype(dt)
    return a.astype(np.int64)


@dataclass
class CompressedTable:
    key_shape: tuple[int, ...]
    val_shape: tuple[int, ...]
    key_lo: np.ndarray = field(repr=False)
    key_hi: np.ndarray = field(repr=False)
    val_lo: np.ndarray = field(repr=False)
    val_hi: np.ndarray = field(repr=False)
    val_ref: np.ndarray = field(repr=False)
    direction: str = "backward"  # keys are op outputs (backward) or inputs
    key_sym: np.ndarray | None = field(default=None, repr=False)
    val_sym: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        l, m = len(self.key_shape), len(self.val_shape)
        self.key_lo = np.asarray(self.key_lo, np.int64).reshape(-1, l)
        self.key_hi = np.asarray(self.key_hi, np.int64).reshape(-1, l)
        self.val_lo = np.asarray(self.val_lo, np.int64).reshape(-1, m)
        self.val_hi = np.asarray(self.val_hi, np.int64).reshape(-1, m)
        self.val_ref = np.asarray(self.val_ref, np.int8).reshape(-1, m)
        if self.key_sym is None:
            self.key_sym = np.full((self.n_rows, l), -1, np.int8)
        if self.val_sym is None:
            self.val_sym = np.full((self.n_rows, m), -1, np.int8)
        if self.direction not in ("backward", "forward"):
            raise ValueError(f"bad direction {self.direction!r}")

    def __setattr__(self, name: str, value) -> None:
        if name in _ARRAY_FIELDS:
            self.__dict__.pop("_index_cache", None)
        object.__setattr__(self, name, value)

    # ------------------------------------------------------------------ #
    @property
    def n_rows(self) -> int:
        return int(self.key_lo.shape[0])

    @property
    def n_key(self) -> int:
        return len(self.key_shape)

    @property
    def n_val(self) -> int:
        return len(self.val_shape)

    @property
    def is_symbolic(self) -> bool:
        assert self.key_sym is not None and self.val_sym is not None
        return bool((self.key_sym >= 0).any() or (self.val_sym >= 0).any())

    def select(self, rows: np.ndarray) -> "CompressedTable":
        assert self.key_sym is not None and self.val_sym is not None
        return replace(
            self,
            key_lo=self.key_lo[rows],
            key_hi=self.key_hi[rows],
            val_lo=self.val_lo[rows],
            val_hi=self.val_hi[rows],
            val_ref=self.val_ref[rows],
            key_sym=self.key_sym[rows],
            val_sym=self.val_sym[rows],
        )

    # --------------------------- indexing ----------------------------- #
    def _cache(self) -> dict:
        return self.__dict__.setdefault("_index_cache", {})

    def key_index(self) -> IntervalIndex:
        """Cached interval index over the key-side intervals (lazily built)."""
        cache = self._cache()
        idx = cache.get("key")
        if idx is None:
            idx = IntervalIndex(self.key_lo, self.key_hi)
            cache["key"] = idx
        return idx

    def value_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Achievable absolute bounds of each value attribute, per row.

        Absolute attrs keep their stored interval; an attr relative to key
        ``j`` can reach ``[key_lo_j + dlo, key_hi_j + dhi]``.  These bounds
        turn the inverse join's candidate test into a plain range join.
        """
        cache = self._cache()
        vb = cache.get("vbounds")
        if vb is None:
            vb_lo = self.val_lo.astype(np.int64)
            vb_hi = self.val_hi.astype(np.int64)
            for j in range(self.n_key):
                sel = self.val_ref == j  # [N, m]
                if sel.any():
                    vb_lo[sel] += np.broadcast_to(
                        self.key_lo[:, j : j + 1], sel.shape
                    )[sel]
                    vb_hi[sel] += np.broadcast_to(
                        self.key_hi[:, j : j + 1], sel.shape
                    )[sel]
            vb = (vb_lo, vb_hi)
            cache["vbounds"] = vb
        return vb

    def val_index(self) -> IntervalIndex:
        """Cached interval index over the achievable value bounds."""
        cache = self._cache()
        idx = cache.get("val")
        if idx is None:
            idx = IntervalIndex(*self.value_bounds())
            cache["val"] = idx
        return idx

    def key_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-key-attribute ``(mean interval length, span)``, cached.

        Fed to the planner's closed-form cost model; invalidated together
        with the interval indexes when the interval columns change.
        """
        cache = self._cache()
        st = cache.get("key_stats")
        if st is None:
            st = interval_stats(self.key_lo, self.key_hi)
            cache["key_stats"] = st
        return st

    def val_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """Like :meth:`key_stats` over the achievable value bounds."""
        cache = self._cache()
        st = cache.get("val_stats")
        if st is None:
            st = interval_stats(*self.value_bounds())
            cache["val_stats"] = st
        return st

    def int32_safe(self, side: str) -> bool:
        """Whether one join side's bounds survive an int32 pack, cached.

        ``side`` is ``"key"`` (stored key intervals) or ``"value"``
        (achievable value bounds).  Gates the accelerator kernel pack and
        the int32 fast path of the blocked dense twin: out-of-range
        coordinates must take the int64 numpy route or they would silently
        wrap (the overflow bug this check exists to prevent).
        """
        cache = self._cache()
        k = f"i32_{side}"
        v = cache.get(k)
        if v is None:
            lo, hi = (
                (self.key_lo, self.key_hi)
                if side == "key"
                else self.value_bounds()
            )
            info = np.iinfo(np.int32)
            v = bool(
                lo.size == 0
                or (lo.min() >= info.min and hi.max() <= info.max)
            )
            cache[k] = v
        return v

    def dense_join_cols(self, side: str) -> tuple[np.ndarray, np.ndarray]:
        """Contiguous transposed ``[l, N]`` (lo, hi) columns for the dense
        join, downcast to int32 when :meth:`int32_safe` — cached, and
        invalidated together with the indexes on mutation.

        The blocked dense evaluation broadcasts one attribute column at a
        time; the stored ``[N, l]`` layout makes those columns strided,
        which dominates the mask cost.  One cached transpose amortizes the
        fix across every hop and every query touching the table.
        """
        cache = self._cache()
        k = f"dense_{side}"
        cols = cache.get(k)
        if cols is None:
            lo, hi = (
                (self.key_lo, self.key_hi)
                if side == "key"
                else self.value_bounds()
            )
            dt = np.int32 if self.int32_safe(side) else np.int64
            cols = (
                np.ascontiguousarray(lo.T, dtype=dt),
                np.ascontiguousarray(hi.T, dtype=dt),
            )
            cache[k] = cols
        return cols

    def cached_key_index(self) -> IntervalIndex | None:
        """The key index if one is already built/attached, without building."""
        return self._cache().get("key")

    def cached_val_index(self) -> IntervalIndex | None:
        """The value-bounds index if already built, without building."""
        return self._cache().get("val")

    def invalidate_index(self) -> None:
        """Drop cached indexes.  Reassigning an array field does this
        automatically; call this after mutating an array *in place*."""
        self.__dict__.pop("_index_cache", None)

    def attach_key_index(self, index: IntervalIndex) -> None:
        """Install a prebuilt/persisted key index (catalog reload path)."""
        if index.lo.shape != self.key_lo.shape:
            raise ValueError(
                f"index over {index.lo.shape} cannot serve table "
                f"{self.key_lo.shape}"
            )
        self._cache()["key"] = index

    # ---------------------------- size ------------------------------- #
    def nbytes(self) -> int:
        """In-memory packed size (what we report as the ProvRC storage cost)."""
        return len(self.serialize(compress=False))

    def nbytes_gzip(self) -> int:
        """ProvRC-GZip size (paper: zlib over the serialized table)."""
        return len(self.serialize(compress=True))

    # ------------------------- serialization ------------------------- #
    def serialize(self, compress: bool = False) -> bytes:
        header = {
            "key_shape": list(self.key_shape),
            "val_shape": list(self.val_shape),
            "direction": self.direction,
            "n_rows": self.n_rows,
        }
        buf = io.BytesIO()
        arrays = [
            _pack_array(self.key_lo),
            _pack_array(self.key_hi),
            _pack_array(self.val_lo),
            _pack_array(self.val_hi),
            self.val_ref,
            self.key_sym,
            self.val_sym,
        ]
        header["dtypes"] = [a.dtype.str for a in arrays]
        hdr = json.dumps(header).encode()
        buf.write(_MAGIC)
        buf.write(len(hdr).to_bytes(4, "little"))
        buf.write(hdr)
        for a in arrays:
            buf.write(np.ascontiguousarray(a).tobytes())
        payload = buf.getvalue()
        if compress:
            payload = _MAGIC + b"Z" + zlib.compress(payload, level=6)
        return payload

    @staticmethod
    def deserialize(data: bytes) -> "CompressedTable":
        if data[: len(_MAGIC) + 1] == _MAGIC + b"Z":
            data = zlib.decompress(data[len(_MAGIC) + 1 :])
        if data[: len(_MAGIC)] != _MAGIC:
            raise ValueError("not a ProvRC table blob")
        off = len(_MAGIC)
        hlen = int.from_bytes(data[off : off + 4], "little")
        off += 4
        header = json.loads(data[off : off + hlen])
        off += hlen
        key_shape = tuple(header["key_shape"])
        val_shape = tuple(header["val_shape"])
        n, l, m = header["n_rows"], len(key_shape), len(val_shape)
        shapes = [(n, l), (n, l), (n, m), (n, m), (n, m), (n, l), (n, m)]
        arrays = []
        for dt_str, shp in zip(header["dtypes"], shapes):
            dt = np.dtype(dt_str)
            cnt = shp[0] * shp[1]
            a = np.frombuffer(data, dtype=dt, count=cnt, offset=off).reshape(shp)
            off += cnt * dt.itemsize
            arrays.append(a.astype(np.int64) if a.dtype != np.int8 else a.copy())
        kl, kh, vl, vh, ref, ks, vs = arrays
        return CompressedTable(
            key_shape,
            val_shape,
            kl.astype(np.int64),
            kh.astype(np.int64),
            vl.astype(np.int64),
            vh.astype(np.int64),
            ref,
            header["direction"],
            ks.astype(np.int8),
            vs.astype(np.int8),
        )

    # -------------------------- decompression ------------------------ #
    def decompress(self) -> LineageRelation:
        """Expand back to the uncompressed relation (losslessness check).

        Only intended for testing / small tables — production queries never
        call this (that is the whole point of in-situ processing).
        """
        if self.is_symbolic:
            raise ValueError("instantiate symbolic table before decompressing")
        out_rows: list[np.ndarray] = []
        in_rows: list[np.ndarray] = []
        l, m = self.n_key, self.n_val
        for r in range(self.n_rows):
            key_ranges = [
                np.arange(self.key_lo[r, j], self.key_hi[r, j] + 1) for j in range(l)
            ]
            key_grid = np.stack(
                [g.ravel() for g in np.meshgrid(*key_ranges, indexing="ij")], axis=1
            ) if l else np.zeros((1, 0), np.int64)
            # Per key tuple, values are a product of (possibly shifted) ranges.
            val_ranges_static = []
            for i in range(m):
                val_ranges_static.append(
                    np.arange(self.val_lo[r, i], self.val_hi[r, i] + 1)
                )
            for k_row in key_grid:
                vranges = []
                for i in range(m):
                    ref = int(self.val_ref[r, i])
                    base = 0 if ref < 0 else int(k_row[ref])
                    vranges.append(val_ranges_static[i] + base)
                vgrid = np.stack(
                    [g.ravel() for g in np.meshgrid(*vranges, indexing="ij")], axis=1
                ) if m else np.zeros((1, 0), np.int64)
                out_rows.append(np.broadcast_to(k_row, (vgrid.shape[0], l)).copy())
                in_rows.append(vgrid)
        if not out_rows:
            out = np.zeros((0, l), np.int64)
            inn = np.zeros((0, m), np.int64)
        else:
            out = np.concatenate(out_rows, axis=0)
            inn = np.concatenate(in_rows, axis=0)
        if self.direction == "backward":
            rel = LineageRelation(self.key_shape, self.val_shape, out, inn)
        else:  # forward: keys are the *input* axes
            rel = LineageRelation(self.val_shape, self.key_shape, inn, out)
        return rel.canonical()


def from_reference_arrays(
    key_shape: tuple[int, ...],
    val_shape: tuple[int, ...],
    key_lo: np.ndarray,
    key_hi: np.ndarray,
    val_lo: np.ndarray,
    val_hi: np.ndarray,
    val_ref: np.ndarray,
    direction: str = "backward",
    key_sym: np.ndarray | None = None,
    val_sym: np.ndarray | None = None,
) -> CompressedTable:
    """A port table over copies of another table's numpy fields.

    ``repro.core.table.CompressedTable`` keeps the same fields with the same
    dtypes, so passing a reference table's attributes here gives a port
    table that serializes to the same bytes and answers the same joins.
    The arrays are copied: the two tables never share (and never
    invalidate each other's cached indexes through) a buffer.
    """

    def own(a):
        return None if a is None else np.array(a, copy=True)

    return CompressedTable(
        tuple(int(d) for d in key_shape),
        tuple(int(d) for d in val_shape),
        own(key_lo),
        own(key_hi),
        own(val_lo),
        own(val_hi),
        own(val_ref),
        direction,
        own(key_sym),
        own(val_sym),
    )
