"""Lineage reuse: signatures, index reshaping, automatic prediction (§VI).

The port of ``repro.core.reuse``: the same decisions and the same
``sig_*.prvc`` state manifest.

Three signature granularities map operation calls to stored lineage:

* ``base_sig(op_name, in_arrs, op_args)``   — exact input arrays must match.
* ``dim_sig(op_name, in_shapes, op_args)``  — only the input *shapes* must
  match (linear algebra, NN forward passes, …).
* ``gen_sig(op_name, op_args)``             — shape-independent: the stored
  table is *index-reshaped* into a generalized representation where every
  interval spanning a full axis extent ``[0, d_i − 1]`` is replaced by the
  symbolic extent ``D_i``; instantiating at a new shape substitutes the new
  extents (paper §VI.B, Fig 6).

:class:`ReusePredictor` implements §VI.C: on first registration a tentative
``dim_sig``/``gen_sig`` mapping is stored; the next ``m`` (default 1)
matching calls are captured normally and compared — a match promotes the
mapping to permanent (for ``gen_sig`` the confirming calls must use
*different* shapes), a mismatch marks the partial signature non-reusable
(the paper's ``cross`` misprediction case).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

from .table import CompressedTable

__all__ = [
    "generalize",
    "instantiate",
    "tables_equal",
    "sig_key_base",
    "sig_key_dim",
    "sig_key_gen",
    "ReusePredictor",
    "ReuseDecision",
]


# --------------------------------------------------------------------------- #
# Index reshaping (§VI.B)
# --------------------------------------------------------------------------- #
def generalize(table: CompressedTable) -> CompressedTable:
    """Mark every full-extent interval as symbolic (``[0, D_i − 1]``).

    Only *absolute* intervals can be generalized: a delta interval is already
    shape-free by construction, which is why the relative transformation of
    ProvRC is what makes index reshaping possible at all.
    """
    t = table
    key_sym = np.full_like(t.key_sym, -1)
    val_sym = np.full_like(t.val_sym, -1)
    for j, d in enumerate(t.key_shape):
        full = (t.key_lo[:, j] == 0) & (t.key_hi[:, j] == d - 1)
        key_sym[full, j] = j
    for i, d in enumerate(t.val_shape):
        full = (
            (t.val_ref[:, i] == -1)
            & (t.val_lo[:, i] == 0)
            & (t.val_hi[:, i] == d - 1)
        )
        val_sym[full, i] = i
    return replace(t, key_sym=key_sym, val_sym=val_sym)


def instantiate(
    table: CompressedTable,
    key_shape: tuple[int, ...],
    val_shape: tuple[int, ...],
) -> CompressedTable:
    """Substitute concrete axis extents into a generalized table."""
    t = table
    if len(key_shape) != t.n_key or len(val_shape) != t.n_val:
        raise ValueError("rank mismatch instantiating generalized table")
    key_lo, key_hi = t.key_lo.copy(), t.key_hi.copy()
    val_lo, val_hi = t.val_lo.copy(), t.val_hi.copy()
    for j, d in enumerate(key_shape):
        m = t.key_sym[:, j] >= 0
        key_lo[m, j] = 0
        key_hi[m, j] = d - 1
    for i, d in enumerate(val_shape):
        m = t.val_sym[:, i] >= 0
        val_lo[m, i] = 0
        val_hi[m, i] = d - 1
    return CompressedTable(
        key_shape,
        val_shape,
        key_lo,
        key_hi,
        val_lo,
        val_hi,
        t.val_ref.copy(),
        t.direction,
    )


def tables_equal(a: CompressedTable, b: CompressedTable) -> bool:
    """Row-order-insensitive structural equality of two compressed tables."""
    if (
        a.key_shape != b.key_shape
        or a.val_shape != b.val_shape
        or a.direction != b.direction
        or a.n_rows != b.n_rows
    ):
        return False

    def canon(t: CompressedTable) -> np.ndarray:
        cols = np.concatenate(
            [
                t.key_lo,
                t.key_hi,
                t.val_lo,
                t.val_hi,
                t.val_ref.astype(np.int64),
                t.key_sym.astype(np.int64),
                t.val_sym.astype(np.int64),
            ],
            axis=1,
        )
        return np.unique(cols, axis=0)

    ca, cb = canon(a), canon(b)
    return ca.shape == cb.shape and bool(np.array_equal(ca, cb))


def symbolic_tables_equal(a: CompressedTable, b: CompressedTable) -> bool:
    """Equality of generalized tables ignoring the captured concrete extents.

    Symbolic cells are compared by their symbol, not the stored lo/hi.
    """
    if (
        a.n_key != b.n_key
        or a.n_val != b.n_val
        or a.direction != b.direction
        or a.n_rows != b.n_rows
    ):
        return False

    def canon(t: CompressedTable) -> np.ndarray:
        key_lo, key_hi = t.key_lo.copy(), t.key_hi.copy()
        val_lo, val_hi = t.val_lo.copy(), t.val_hi.copy()
        ks, vs = t.key_sym >= 0, t.val_sym >= 0
        key_lo[ks] = 0
        key_hi[ks] = -2  # sentinel: "symbolic extent"
        val_lo[vs] = 0
        val_hi[vs] = -2
        cols = np.concatenate(
            [
                key_lo,
                key_hi,
                val_lo,
                val_hi,
                t.val_ref.astype(np.int64),
                t.key_sym.astype(np.int64),
                t.val_sym.astype(np.int64),
            ],
            axis=1,
        )
        return np.unique(cols, axis=0)

    ca, cb = canon(a), canon(b)
    return ca.shape == cb.shape and bool(np.array_equal(ca, cb))


# --------------------------------------------------------------------------- #
# Operation signatures
# --------------------------------------------------------------------------- #
def _args_repr(op_args: Any) -> str:
    try:
        return json.dumps(op_args, sort_keys=True, default=str)
    except TypeError:
        return repr(op_args)


def sig_key_base(op_name: str, in_arrs: tuple[str, ...], op_args: Any) -> str:
    return f"base::{op_name}::{','.join(in_arrs)}::{_args_repr(op_args)}"


def sig_key_dim(
    op_name: str, in_shapes: tuple[tuple[int, ...], ...], op_args: Any
) -> str:
    return f"dim::{op_name}::{in_shapes!r}::{_args_repr(op_args)}"


def sig_key_gen(op_name: str, op_args: Any) -> str:
    return f"gen::{op_name}::{_args_repr(op_args)}"


# --------------------------------------------------------------------------- #
# Automatic reuse prediction (§VI.C)
# --------------------------------------------------------------------------- #
@dataclass
class _SigState:
    kind: str  # "dim" | "gen"
    status: str = "tentative"  # tentative | confirmed | rejected
    matches: int = 0
    # map from (in_pos, out_pos) pair label -> stored table(s)
    tables: dict[str, CompressedTable] = field(default_factory=dict)
    seen_shapes: set = field(default_factory=set)


@dataclass
class ReuseDecision:
    reused: bool
    source: str | None = None  # "base" | "dim" | "gen"
    tables: dict[str, CompressedTable] | None = None


class ReusePredictor:
    """Tracks per-partial-signature reuse state across registrations.

    Persistence is dirty-tracked *per signature* (mirroring the catalog's
    per-entry ``_dirty``/``_persisted`` split): :meth:`observe` marks only
    the signatures it actually mutates, and :meth:`state_manifest` reuses
    the previously persisted record (blob names included) for every clean
    signature — so one new observation no longer rewrites every ``sig_*``
    blob on ``save()``.
    """

    def __init__(self, m: int = 1):
        self.m = m
        self.state: dict[str, _SigState] = {}
        # per-signature persistence bookkeeping
        self._dirty: set[str] = set()
        self._persisted_recs: dict[str, dict] = {}

    @property
    def dirty(self) -> bool:
        """Whether any signature changed since the last snapshot/load."""
        return bool(self._dirty)

    # ------------------------------------------------------------------ #
    def lookup(
        self,
        dim_key: str,
        gen_key: str,
        shapes_token: tuple,
        pair_shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]],
    ) -> ReuseDecision:
        """Check whether a confirmed mapping can serve this call."""
        st = self.state.get(dim_key)
        if st is not None and st.status == "confirmed":
            return ReuseDecision(True, "dim", dict(st.tables))
        st = self.state.get(gen_key)
        if st is not None and st.status == "confirmed":
            inst = {
                label: instantiate(
                    tbl, *self._inst_shapes(tbl, pair_shapes[label])
                )
                for label, tbl in st.tables.items()
            }
            return ReuseDecision(True, "gen", inst)
        return ReuseDecision(False)

    @staticmethod
    def _inst_shapes(tbl, pair):
        out_shape, in_shape = pair
        if tbl.direction == "backward":
            return out_shape, in_shape
        return in_shape, out_shape

    # ------------------------------------------------------------------ #
    def observe(
        self,
        dim_key: str,
        gen_key: str,
        shapes_token: tuple,
        captured: dict[str, CompressedTable],
    ) -> None:
        """Feed a freshly captured lineage set into the prediction machine."""
        # ---- dim_sig ---------------------------------------------------- #
        st = self.state.get(dim_key)
        if st is None:
            self.state[dim_key] = _SigState("dim", tables=dict(captured))
            self._dirty.add(dim_key)
        elif st.status in ("tentative",):
            ok = all(
                label in st.tables and tables_equal(st.tables[label], t)
                for label, t in captured.items()
            ) and len(st.tables) == len(captured)
            if ok:
                st.matches += 1
                if st.matches >= self.m:
                    st.status = "confirmed"
            else:
                st.status = "rejected"
            self._dirty.add(dim_key)
        # ---- gen_sig ---------------------------------------------------- #
        gen_tables = {label: generalize(t) for label, t in captured.items()}
        st = self.state.get(gen_key)
        if st is None:
            s = _SigState("gen", tables=gen_tables)
            s.seen_shapes.add(shapes_token)
            self.state[gen_key] = s
            self._dirty.add(gen_key)
        elif st.status == "tentative":
            ok = all(
                label in st.tables
                and symbolic_tables_equal(st.tables[label], t)
                for label, t in gen_tables.items()
            ) and len(st.tables) == len(gen_tables)
            if not ok:
                st.status = "rejected"
                self._dirty.add(gen_key)
            elif shapes_token not in st.seen_shapes:
                # gen_sig confirmation requires a *different* shape (§VI.C)
                st.matches += 1
                st.seen_shapes.add(shapes_token)
                st.tables = gen_tables  # keep the latest generalization
                if st.matches >= self.m:
                    st.status = "confirmed"
                self._dirty.add(gen_key)

    def status(self, key: str) -> str | None:
        st = self.state.get(key)
        return st.status if st else None

    # ------------------------------------------------------------------ #
    # persistence (catalog manifest v2)
    # ------------------------------------------------------------------ #
    def state_manifest(self, save_table) -> dict:
        """JSON-safe snapshot of the prediction state.

        ``save_table(sig_key, label, table) -> str`` persists one stored
        table and returns its blob name — the predictor stays I/O-free; the
        catalog owns file layout.  Rejected signatures keep only their
        verdict (their tables can never be consulted again).

        Dirty tracking is per signature: a clean signature's previous record
        is reused verbatim (no blob rewrite); only signatures touched by
        :meth:`observe` since the last snapshot have their tables re-saved.
        """
        sigs = []
        for key, st in self.state.items():
            rec = self._persisted_recs.get(key)
            if rec is None or key in self._dirty:
                rec = {
                    "key": key,
                    "kind": st.kind,
                    "status": st.status,
                    "matches": st.matches,
                    "seen_shapes": [
                        [list(map(int, s)) for s in tok] for tok in st.seen_shapes
                    ],
                    "tables": {},
                }
                if st.status != "rejected":
                    rec["tables"] = {
                        label: save_table(key, label, tbl)
                        for label, tbl in st.tables.items()
                    }
                self._persisted_recs[key] = rec
            sigs.append(rec)
        self._dirty.clear()
        return {"m": self.m, "sigs": sigs}

    @classmethod
    def from_manifest(cls, manifest: dict, load_table) -> "ReusePredictor":
        """Rebuild a predictor from :meth:`state_manifest` output.

        ``load_table(blob_name) -> CompressedTable`` resolves the stored
        tables (catalog-owned I/O).  A reloaded predictor keeps confirmed
        mappings live, so ``register_operation`` on a reopened catalog still
        bypasses capture.
        """
        p = cls(m=int(manifest.get("m", 1)))
        for rec in manifest.get("sigs", []):
            st = _SigState(rec["kind"], rec["status"], int(rec["matches"]))
            st.seen_shapes = {
                tuple(tuple(int(x) for x in s) for s in tok)
                for tok in rec["seen_shapes"]
            }
            st.tables = {
                label: load_table(fn) for label, fn in rec["tables"].items()
            }
            p.state[rec["key"]] = st
            p._persisted_recs[rec["key"]] = rec
        return p
