"""TPC-H lineage as explicit pairs, built with numpy alone.

The tables ``customer``, ``orders``, ``lineitem`` and ``nation`` at a scale
factor, generated from a seed by dbgen's rules (TPC-H specification
§4.2.3), and the queries Q1, Q3, Q10 and Q12 as plans of relational
operators over them, as Smoke (Psallidas & Wu, PVLDB 11(6) 2018) captures
their lineage.  Every operator reads 2-D int64 tables (rows × columns) and
gives, for each input, its cell-level lineage as a :class:`~.lineage.Rel`
(``out[out_idx[i]] <- in[in_idx[i]]``), built by brute force over rows:

* a filter: ``out[i, c] <- in[sel[i], c]``;
* an inner equi-join, one relation per input:
  ``out[t, c] <- left[l(t), c]`` and ``out[t, L + c] <- right[r(t), c]``;
  the larger input is probed, in its own row order, against the other;
* a group-by, groups in the order of their first row: a key cell <- the
  key column's cells of its group's rows; an aggregate cell <- the cells of
  the columns its expression reads in its group's rows; ``COUNT(*)`` reads
  the group's key cells;
* ``ORDER BY``: a stable row permutation.

Dates are days since 1970-01-01; a string column holds its value's rank
among the spec's values where a query compares or orders it, and a code
drawn from the seed where none does.  ``LIMIT`` is left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lineage import Rel

COLUMNS = {
    "customer": ("c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
                 "c_acctbal", "c_mktsegment", "c_comment"),
    "orders": ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice", "o_orderdate",
               "o_orderpriority", "o_clerk", "o_shippriority", "o_comment"),
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                 "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment"),
    "nation": ("n_nationkey", "n_name", "n_regionkey", "n_comment"),
}
BASE_TABLES = tuple(COLUMNS)

# the spec's string domains, each in sorted order: a code is a rank
RETURNFLAGS = ("A", "N", "R")
LINESTATUS = ("F", "O")
ORDERSTATUS = ("F", "O", "P")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
SHIPINSTRUCT = ("COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
# nation n: (name, region key), spec §4.2.3
NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
           ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
           ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
           ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
           ("UNITED STATES", 1))
NATION_NAMES = tuple(sorted(n for n, _ in NATIONS))


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int((np.datetime64(iso, "D") - np.datetime64("1970-01-01", "D")).astype(np.int64))


def add_months(iso: str, months: int) -> int:
    m = np.datetime64(iso, "M") + np.timedelta64(months, "M")
    return day(str(m) + iso[7:])


STARTDATE, CURRENTDATE, ENDDATE = day("1992-01-01"), day("1995-06-17"), day("1998-12-31")


@dataclass(frozen=True)
class Table:
    name: str
    columns: tuple
    data: np.ndarray  # int64 [rows, len(columns)]

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    def col(self, name: str) -> np.ndarray:
        return self.data[:, self.columns.index(name)]


@dataclass(frozen=True)
class Operation:
    """One relational operator as logged: its name, input arrays, output
    array, one relation per input (in input order) and its arguments."""

    op: str
    inputs: tuple
    output: str
    rels: tuple
    args: dict


# --------------------------------------------------------------------------- #
# Tables (dbgen's rules, spec §4.2.3)
# --------------------------------------------------------------------------- #
def _rows(sf: float, per_sf: int) -> int:
    return max(1, int(round(per_sf * sf)))


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def generate(sf: float, seed: int) -> dict[str, Table]:
    """The four base tables at scale factor ``sf``, from ``seed``."""
    rng = np.random.default_rng([seed, 33])
    n_c, n_o = _rows(sf, 150_000), _rows(sf, 1_500_000)
    n_p, n_s = _rows(sf, 200_000), _rows(sf, 10_000)

    custkey = np.arange(1, n_c + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_c)
    customer = np.stack([
        custkey, custkey, rng.integers(0, 2**40, n_c), c_nation,
        (c_nation + 10) * 10**10 + rng.integers(10**9, 10**10, n_c),
        rng.integers(-99_999, 1_000_000, n_c), rng.integers(0, len(SEGMENTS), n_c),
        rng.integers(0, 2**40, n_c)], axis=1)

    i = np.arange(n_o, dtype=np.int64)
    orderkey = (i // 8) * 32 + i % 8 + 1  # dbgen's sparse keys
    eligible = custkey[custkey % 3 != 0]
    o_cust = eligible[rng.integers(0, eligible.size, n_o)]
    orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1, n_o)

    n_lines = rng.integers(1, 8, n_o)
    n_l = int(n_lines.sum())
    owner = np.repeat(i, n_lines)  # rows in order-key order, as dbgen writes them
    linenumber = np.arange(n_l) - np.repeat(np.cumsum(n_lines) - n_lines, n_lines) + 1
    partkey = rng.integers(1, n_p + 1, n_l)
    supp_i = rng.integers(0, 4, n_l)
    suppkey = (partkey + supp_i * (n_s // 4 + (partkey - 1) // n_s)) % n_s + 1
    quantity = rng.integers(1, 51, n_l)
    extprice = quantity * retail_price(partkey)
    discount, tax = rng.integers(0, 11, n_l), rng.integers(0, 9, n_l)
    odate = orderdate[owner]
    shipdate = odate + rng.integers(1, 122, n_l)
    commitdate = odate + rng.integers(30, 91, n_l)
    receiptdate = shipdate + rng.integers(1, 31, n_l)
    ra = np.where(rng.integers(0, 2, n_l) == 0, RETURNFLAGS.index("R"), RETURNFLAGS.index("A"))
    returnflag = np.where(receiptdate <= CURRENTDATE, ra, RETURNFLAGS.index("N"))
    linestatus = np.where(shipdate > CURRENTDATE, LINESTATUS.index("O"), LINESTATUS.index("F"))
    lineitem = np.stack([
        orderkey[owner], partkey, suppkey, linenumber, quantity, extprice, discount, tax,
        returnflag, linestatus, shipdate, commitdate, receiptdate,
        rng.integers(0, len(SHIPINSTRUCT), n_l), rng.integers(0, len(SHIPMODES), n_l),
        rng.integers(0, 2**40, n_l)], axis=1)

    n_open = np.bincount(owner, weights=linestatus, minlength=n_o).astype(np.int64)
    status = np.where(n_open == 0, ORDERSTATUS.index("F"),
                      np.where(n_open == n_lines, ORDERSTATUS.index("O"), ORDERSTATUS.index("P")))
    charge = extprice * (100 + tax) * (100 - discount)
    total = np.bincount(owner, weights=charge, minlength=n_o).astype(np.int64) // 10_000
    orders = np.stack([
        orderkey, o_cust, status, total, orderdate, rng.integers(0, len(PRIORITIES), n_o),
        rng.integers(1, _rows(sf, 1_000) + 1, n_o), np.zeros(n_o, np.int64),
        rng.integers(0, 2**40, n_o)], axis=1)

    nation = np.array([[k, NATION_NAMES.index(name), region, code]
                       for k, ((name, region), code) in
                       enumerate(zip(NATIONS, rng.integers(0, 2**40, 25)))], np.int64)
    return {name: Table(name, COLUMNS[name], data.astype(np.int64))
            for name, data in (("customer", customer), ("orders", orders),
                               ("lineitem", lineitem), ("nation", nation))}


# --------------------------------------------------------------------------- #
# Operators and their lineage
# --------------------------------------------------------------------------- #
def _rows_times_cols(rows: np.ndarray, out_rows: np.ndarray, cols: np.ndarray,
                     out_cols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pairs ``out[out_rows[t], out_cols[k]] <- in[rows[t], cols[k]]`` for
    every t and k: ``(out_idx, in_idx)``."""
    n, k = rows.size, cols.size
    out = np.stack([np.repeat(out_rows, k), np.tile(out_cols, n)], axis=1)
    inn = np.stack([np.repeat(rows, k), np.tile(cols, n)], axis=1)
    return out.astype(np.int64), inn.astype(np.int64)


def select(t: Table, mask: np.ndarray, name: str) -> tuple[Table, tuple]:
    sel = np.flatnonzero(mask)
    out = Table(name, t.columns, t.data[sel])
    c = np.arange(len(t.columns))
    o, i = _rows_times_cols(sel, np.arange(sel.size), c, c)
    return out, (Rel(out.shape, t.shape, o, i),)


def join(left: Table, right: Table, lcol: str, rcol: str, name: str) -> tuple[Table, tuple]:
    """Inner equi-join ``left.lcol = right.rcol``; the output holds left's
    columns, then right's."""
    lk, rk = left.col(lcol), right.col(rcol)
    probe_right = right.shape[0] >= left.shape[0]
    build, probe = (lk, rk) if probe_right else (rk, lk)
    order = np.argsort(build, kind="stable")
    sb = build[order]
    lo = np.searchsorted(sb, probe, side="left")
    counts = np.searchsorted(sb, probe, side="right") - lo
    probe_rows = np.repeat(np.arange(probe.size), counts)
    first = np.repeat(lo, counts)
    build_rows = order[first + np.arange(probe_rows.size)
                       - np.repeat(np.cumsum(counts) - counts, counts)]
    l_rows, r_rows = (build_rows, probe_rows) if probe_right else (probe_rows, build_rows)
    out = Table(name, left.columns + right.columns,
                np.concatenate([left.data[l_rows], right.data[r_rows]], axis=1))
    t = np.arange(l_rows.size)
    nl, nr = len(left.columns), len(right.columns)
    lo_, li_ = _rows_times_cols(l_rows, t, np.arange(nl), np.arange(nl))
    ro_, ri_ = _rows_times_cols(r_rows, t, np.arange(nr), nl + np.arange(nr))
    return out, (Rel(out.shape, left.shape, lo_, li_), Rel(out.shape, right.shape, ro_, ri_))


def group_by(t: Table, keys: tuple, select_list: tuple, name: str) -> tuple[Table, tuple]:
    """``GROUP BY keys`` with output columns ``select_list``: each a key
    column's name, or ``(name, kind, reads, expr)`` for an aggregate of
    ``kind`` ``sum``, ``avg`` or ``count`` over the per-row values
    ``expr(table)`` (``count``: ``COUNT(*)``, reading the key columns)."""
    kcols = np.stack([t.col(k) for k in keys], axis=1)
    _, first, gid = np.unique(kcols, axis=0, return_index=True, return_inverse=True)
    gid = np.asarray(gid).reshape(-1)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    gid = rank[gid]  # groups numbered in the order of their first row
    n_g = first.size
    counts = np.bincount(gid, minlength=n_g)
    rows = np.arange(t.shape[0])
    cols, names, outs, ins = [], [], [], []
    for j, item in enumerate(select_list):
        if isinstance(item, str):
            val = np.zeros(n_g, np.int64)
            val[gid] = t.col(item)
            reads, label = (item,), item
        else:
            label, kind, reads, expr = item
            if kind == "count":
                reads, val = tuple(keys), counts.astype(np.int64)
            else:
                s = np.zeros(n_g, np.int64)
                np.add.at(s, gid, expr(t))
                val = s if kind == "sum" else s * 100 // counts
        cols.append(val)
        names.append(label)
        rc = np.array([t.columns.index(r) for r in reads])
        o, i = _rows_times_cols(rows, gid, rc, np.full(rc.size, j))
        outs.append(o)
        ins.append(i)
    out = Table(name, tuple(names), np.stack(cols, axis=1))
    return out, (Rel(out.shape, t.shape, np.concatenate(outs), np.concatenate(ins)),)


def order_by(t: Table, keys: tuple, name: str) -> tuple[Table, tuple]:
    """Stable ``ORDER BY``: ``keys`` are ``(column, descending)``."""
    perm = np.lexsort([-t.col(c) if desc else t.col(c) for c, desc in reversed(keys)])
    out = Table(name, t.columns, t.data[perm])
    c = np.arange(len(t.columns))
    o, i = _rows_times_cols(perm, np.arange(perm.size), c, c)
    return out, (Rel(out.shape, t.shape, o, i),)


# --------------------------------------------------------------------------- #
# The queries
# --------------------------------------------------------------------------- #
def _disc_price(t: Table) -> np.ndarray:
    return t.col("l_extendedprice") * (100 - t.col("l_discount"))


def _q1(tb, p, log):
    li = tb["lineitem"]
    sel = log("filter", [li], select, li.col("l_shipdate") <= day("1998-12-01") - p["DELTA"],
              "q1_sel")
    ext, disc = ("l_extendedprice",), ("l_extendedprice", "l_discount")
    agg = log("group_by", [sel], group_by, ("l_returnflag", "l_linestatus"), (
        "l_returnflag", "l_linestatus",
        ("sum_qty", "sum", ("l_quantity",), lambda t: t.col("l_quantity")),
        ("sum_base_price", "sum", ext, lambda t: t.col("l_extendedprice")),
        ("sum_disc_price", "sum", disc, _disc_price),
        ("sum_charge", "sum", disc + ("l_tax",), lambda t: _disc_price(t) * (100 + t.col("l_tax"))),
        ("avg_qty", "avg", ("l_quantity",), lambda t: t.col("l_quantity")),
        ("avg_price", "avg", ext, lambda t: t.col("l_extendedprice")),
        ("avg_disc", "avg", ("l_discount",), lambda t: t.col("l_discount")),
        ("count_order", "count", (), None)), "q1_agg")
    log("order_by", [agg], order_by, (("l_returnflag", False), ("l_linestatus", False)), "q1_out")


def _q3(tb, p, log):
    d = day(p["DATE"])
    cu, od, li = tb["customer"], tb["orders"], tb["lineitem"]
    c = log("filter", [cu], select, cu.col("c_mktsegment") == SEGMENTS.index(p["SEGMENT"]),
            "q3_cust")
    o = log("filter", [od], select, od.col("o_orderdate") < d, "q3_ord")
    ln = log("filter", [li], select, li.col("l_shipdate") > d, "q3_line")
    co = log("join", [c, o], join, "c_custkey", "o_custkey", "q3_co")
    col = log("join", [co, ln], join, "o_orderkey", "l_orderkey", "q3_col")
    agg = log("group_by", [col], group_by, ("l_orderkey", "o_orderdate", "o_shippriority"), (
        "l_orderkey", ("revenue", "sum", ("l_extendedprice", "l_discount"), _disc_price),
        "o_orderdate", "o_shippriority"), "q3_agg")
    log("order_by", [agg], order_by, (("revenue", True), ("o_orderdate", False)), "q3_out")


def _q10(tb, p, log):
    d, d3 = day(p["DATE"]), add_months(p["DATE"], 3)
    cu, od, li, na = tb["customer"], tb["orders"], tb["lineitem"], tb["nation"]
    odate = od.col("o_orderdate")
    o = log("filter", [od], select, (odate >= d) & (odate < d3), "q10_ord")
    ln = log("filter", [li], select, li.col("l_returnflag") == RETURNFLAGS.index("R"), "q10_line")
    co = log("join", [cu, o], join, "c_custkey", "o_custkey", "q10_co")
    col = log("join", [co, ln], join, "o_orderkey", "l_orderkey", "q10_col")
    coln = log("join", [col, na], join, "c_nationkey", "n_nationkey", "q10_coln")
    agg = log("group_by", [coln], group_by, (
        "c_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address", "c_comment"), (
        "c_custkey", "c_name", ("revenue", "sum", ("l_extendedprice", "l_discount"), _disc_price),
        "c_acctbal", "n_name", "c_address", "c_phone", "c_comment"), "q10_agg")
    log("order_by", [agg], order_by, (("revenue", True),), "q10_out")


def _q12(tb, p, log):
    d, d12 = day(p["DATE"]), add_months(p["DATE"], 12)
    od, li = tb["orders"], tb["lineitem"]
    modes = [SHIPMODES.index(p["SHIPMODE1"]), SHIPMODES.index(p["SHIPMODE2"])]
    commit, receipt = li.col("l_commitdate"), li.col("l_receiptdate")
    mask = (np.isin(li.col("l_shipmode"), modes) & (commit < receipt)
            & (li.col("l_shipdate") < commit) & (receipt >= d) & (receipt < d12))
    ln = log("filter", [li], select, mask, "q12_line")
    ol = log("join", [od, ln], join, "o_orderkey", "l_orderkey", "q12_ol")
    high = (PRIORITIES.index("1-URGENT"), PRIORITIES.index("2-HIGH"))
    prio = ("o_orderpriority",)
    agg = log("group_by", [ol], group_by, ("l_shipmode",), (
        "l_shipmode",
        ("high_line_count", "sum", prio,
         lambda t: np.isin(t.col("o_orderpriority"), high).astype(np.int64)),
        ("low_line_count", "sum", prio,
         lambda t: (~np.isin(t.col("o_orderpriority"), high)).astype(np.int64))), "q12_agg")
    log("order_by", [agg], order_by, (("l_shipmode", False),), "q12_out")


QUERIES = {"Q1": _q1, "Q3": _q3, "Q10": _q10, "Q12": _q12}


def build(cfg: dict, seed: int) -> tuple[dict[str, Table], list[Operation]]:
    """The base tables and every operation of the configuration's queries
    (``cfg["scale_factor"]``, ``cfg["queries"]``: each query's substitution
    parameters), in the order they run."""
    tables = generate(cfg["scale_factor"], seed)
    ops: list[Operation] = []

    def log(op, inputs, fn, *args):
        out, rels = fn(*inputs, *args)
        ops.append(Operation(op, tuple(t.name for t in inputs), out.name, rels,
                             {"query": out.name.split("_")[0]}))
        return out

    for q, params in cfg["queries"].items():
        QUERIES[q](tables, params, log)
    return tables, ops


def chains(ops: list[Operation]) -> list[dict]:
    """Each path from a base table to its query's final array:
    ``{name, path, ops}`` (``ops``: each hop's operator, output and, for a
    join, the input the path enters by), in the order the queries run and
    their base tables first appear."""
    by_input: dict[str, list[Operation]] = {}
    for op in ops:
        for a in op.inputs:
            by_input.setdefault(a, []).append(op)
    out = []
    for op in ops:
        for a in op.inputs:
            if a not in BASE_TABLES:
                continue
            query = op.output.split("_")[0]
            path, hops, cur = [a], [], op
            while True:
                hop = {"out": cur.output}
                if len(cur.inputs) > 1:
                    hop["side"] = ("left", "right")[cur.inputs.index(path[-1])]
                hops.append([cur.op, hop])
                path.append(cur.output)
                nxt = by_input.get(cur.output, [])
                if not nxt:
                    break
                (cur,) = nxt
            out.append({"name": f"{query}_{a}", "path": path, "ops": hops})
    return out


def edges(ops: list[Operation]) -> list[tuple[str, str, Rel]]:
    """The lineage edges ``(input, output, relation)`` of every operation."""
    return [(a, op.output, rel) for op in ops for a, rel in zip(op.inputs, op.rels)]
