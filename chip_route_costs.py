#!/usr/bin/env python3
"""The cost constants of the batched executor's index-to-kernel rule on one GPU.

Run from the repository root on a machine with an NVIDIA card and the CUDA
toolkit::

    python3 chip_route_costs.py [--out chiprun_out/route_costs.json]
        [--cells fig89.query_wide,fig89.query_point] [--seed N] [--queries N]

``BatchedJoinExecutor`` can run an index-routed join two ways, and
``repro_torch.core.query.index_to_kernel`` picks by their costs.  This
script times both on per-cell tables (one box of interval length 1 per cell
of a square 2-D array: 100, 200 and 400 on a side, the shape of the fig 8/9
numpy pipelines' tables) against frontiers of distinct one-cell boxes and of
8 x 8 and 32 x 32 boxes:

* the host: ``IntervalIndex.candidate_pairs`` over windows probed
  beforehand (the executor probes them on both routes), fitted as
  ``a + b * candidates``;
* the card: the CUDA executor's dense route for the one join
  (``BatchedJoinExecutor._run_dense``: its checks, the table's resident
  pack, the packed ``range_join_mask`` launch and the pairs' extraction),
  fitted as ``c0 + c1 * nq + c2 * nq * nr + c3 * pairs``.

With ``--cells``, it also measures both routes where the rule meets
them: it builds each named benchmark cell's store from ``--seed`` and
warms it up as ``perfbench/run.py`` does, then

* replays ``--queries`` of the cell's requests, each twice, once with the
  rule on and once with every join kept on the planner's route (order
  alternating, the answer cache emptied before each), and reports both
  sides' latencies, split by whether the rule rerouted a join of the query
  (each query's record also holds the seconds of its rerouted joins'
  launch and the table packs it built);
* replays them once more and times both routes of each join whose
  candidates the rule prices above a third of a launch, right where the
  query asks for it, with the host's caches as the query leaves them.

What follows the pairs (``_finalize_batch``) is the same on both routes
and is left out of both timings.  Both fits minimise the relative error
(the times span four orders of magnitude) under non-negative coefficients.
Each time is the median of several calls on the host clock (a card call
ends with its pairs on the host), each call after 64 MB of host writes, as
a query's other host work leaves the caches between its joins.  It prints
every timing, both fits, the constants the rule ships with, the decision
each set takes on two example joins, and the card's name and power limit,
and writes them as one JSON object to ``--out``.  Without CUDA it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SIDES = (100, 200, 400)
# (box side k, frontier sizes)
FRONTIERS = ((1, (1, 10, 100, 1000, 3318, 10_000)), (8, (10, 100, 1000)), (32, (10, 100)))


def card_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def per_cell_table(ttable, side: int):
    """One box per cell of a ``side`` x ``side`` array, value = key."""
    cells = np.stack(np.unravel_index(np.arange(side * side), (side, side)), axis=1)
    zeros = np.zeros_like(cells)
    return ttable.CompressedTable(
        (side, side), (side, side), cells, cells.copy(), zeros, zeros.copy(),
        np.tile(np.arange(2), (cells.shape[0], 1)),
    )


def frontier(rng, side: int, k: int, nq: int) -> tuple[np.ndarray, np.ndarray]:
    """``nq`` distinct ``k`` x ``k`` boxes inside the array."""
    starts = rng.choice((side - k + 1) ** 2, nq, replace=False)
    lo = np.stack(np.unravel_index(starts, (side - k + 1,) * 2), axis=1).astype(np.int64)
    return lo, lo + (k - 1)


def median_s(fn, reps: int, scrub: np.ndarray) -> float:
    fn()  # warm: allocator, kernel library
    times = []
    for k in range(reps):
        scrub.fill(k & 0xFF)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def fit(features: np.ndarray, times: np.ndarray) -> tuple[np.ndarray, float]:
    """Non-negative coefficients minimising the relative error; returns them
    and the largest relative residual."""
    from scipy.optimize import nnls

    coef, _ = nnls(features / times[:, None], np.ones_like(times))
    rel = features @ coef / times - 1.0
    return coef, float(np.abs(rel).max())


def quartiles(xs) -> dict:
    if len(xs) < 2:
        return {"n": len(xs), "median": float(xs[0]) if xs else None}
    q = statistics.quantiles(xs, n=4)
    return {"n": len(xs), "q1": q[0], "median": q[1], "q3": q[2], "mean": statistics.fmean(xs)}


def p95(xs) -> float | None:
    return float(np.percentile(xs, 95)) if xs else None


def in_cell(name: str, seed: int, n_queries: int, shipped: dict,
            device: str = "cuda") -> dict:
    """Both routes of the rule inside benchmark cell ``name``: per-query
    latencies with the rule on and off, and per-join costs in place."""
    import tempfile
    import shutil

    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench import harness, tracing
    from repro_torch import core
    import repro_torch.core.query as tq

    cell = harness.load_cell(name)
    cfg = harness.load_config(cell["config"])
    traffic = harness._module("traffic", cell["traffic_kind"])
    params = cell["params"]
    run = harness.Run(name, seed, 0.0, False, device)
    rec = tracing.Recorder(False, torch)
    workdir = tempfile.mkdtemp(prefix="route-costs-")
    rule = tq.index_to_kernel
    mode = {"on": True, "asked": []}

    def gated(candidates, nq, nr, windows):
        go = mode["on"] and rule(candidates, nq, nr, windows)
        if go:
            mode["asked"].append((int(candidates), int(nq), int(nr)))
        return go

    try:
        t0 = time.perf_counter()
        client = harness.QueryClient(core, cfg, seed, workdir + "/store", device, rec, run)
        warm = traffic.requests(params, client.info, np.random.default_rng([seed, 1]))
        for _ in range(params.get("warmup_rounds_max", 8)):
            before = client.views_materialized()
            for _ in range(params["warmup_requests"]):
                client.do(next(warm), keep=False)
            if client.views_materialized() == before:
                break
        build_s = time.perf_counter() - t0
        gen = traffic.requests(params, client.info, np.random.default_rng([seed, 2]))
        reqs = [next(gen) for _ in range(n_queries)]
        views = client.log.views
        tq.index_to_kernel = gated

        run_dense = tq.BatchedJoinExecutor._run_dense

        def timed_dense(self, items, results, workers=None, observe=True):
            t = time.perf_counter()
            try:
                return run_dense(self, items, results, workers, observe)
            finally:
                if not observe:
                    mode["rerouted_s"] += time.perf_counter() - t

        def timed(req, on: bool) -> tuple[float, int]:
            """Seconds of one request, and the table packs it built."""
            mode["on"] = on
            with views._lock:
                views._cache.clear()
            built = int(client.log.io_stats["table_packs_built"])
            t = time.perf_counter()
            client.do(req, keep=False)
            return time.perf_counter() - t, int(client.log.io_stats["table_packs_built"]) - built

        # 1. the same requests with the rule on and off, in alternating order
        per_query = []
        tq.BatchedJoinExecutor._run_dense = timed_dense
        try:
            for k, req in enumerate(reqs):
                mode["asked"], mode["rerouted_s"] = [], 0.0
                c0 = int(client.log.io_stats["joins_index_to_kernel"])
                if k % 2:
                    off, _ = timed(req, False)
                    on, built = timed(req, True)
                else:
                    on, built = timed(req, True)
                    off, _ = timed(req, False)
                per_query.append({
                    "on_s": on, "off_s": off,
                    "rerouted": int(client.log.io_stats["joins_index_to_kernel"]) - c0,
                    "joins": mode["asked"], "rerouted_s": mode["rerouted_s"],
                    "packs_built": built})
        finally:
            tq.BatchedJoinExecutor._run_dense = run_dense
        # 2. both routes of every join the rule prices above a third of a launch
        joins = []
        index_route = tq.BatchedJoinExecutor._index_route
        finalize = tq._finalize_batch

        def probe(self, req, u_lo, u_hi, r_lo, index_get, windows):
            route, windows = index_route(self, req, u_lo, u_hi, r_lo, index_get, windows)
            if windows is None:
                return route, windows
            index = index_get()
            cand = int(index.estimate_candidates(u_lo, u_hi, windows))
            if tq.INDEX_S_PER_CANDIDATE * cand < tq.KERNEL_S_PER_LAUNCH / 3:
                return route, windows
            _, p_lo, p_hi, inv, p_rlo, p_rhi, _ = tq._prepare_batch(
                req.queries, req.table, req.inverse)
            item = (0, req, p_lo, p_hi, inv, p_rlo, p_rhi)
            got = []
            tq._finalize_batch = lambda *a: got.append(int(a[6].size))
            try:
                def host():
                    return index.candidate_pairs(u_lo, u_hi, windows)

                def card():
                    self._run_dense([item], [None], observe=False)

                order = (host, card) if len(joins) % 2 else (card, host)
                secs = {}
                for fn in order:
                    t = time.perf_counter()
                    out = fn()
                    secs[fn.__name__] = time.perf_counter() - t
                    if fn is host:
                        n_pairs = int(out[0].size)
            finally:
                tq._finalize_batch = finalize
            nq, nr = int(u_lo.shape[0]), int(r_lo.shape[0])
            pred = {"host_s": shipped["INDEX_S_PER_CANDIDATE"] * cand,
                    "card_s": shipped["KERNEL_S_PER_LAUNCH"]
                    + shipped["KERNEL_S_PER_QUERY_ROW"] * nq
                    + shipped["KERNEL_S_PER_CELL"] * nq * nr
                    + shipped["KERNEL_S_PER_PAIR"] * tq._pairs_estimate(windows, nr)}
            joins.append({"candidates": cand, "nq": nq, "nr": nr, "pairs": n_pairs,
                          "card_pairs": got[0] if got else None, "route": route,
                          "host_s": secs["host"], "card_s": secs["card"],
                          "model_host_s": pred["host_s"], "model_card_s": pred["card_s"]})
            return route, windows

        tq.BatchedJoinExecutor._index_route = probe
        mode["on"] = True
        try:
            for req in reqs:
                client.do(req, keep=False)
        finally:
            tq.BatchedJoinExecutor._index_route = index_route
        peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
        client.after_window(run)
    finally:
        tq.index_to_kernel = rule
        shutil.rmtree(workdir, ignore_errors=True)
    with_r = [q for q in per_query if q["rerouted"]]
    without = [q for q in per_query if not q["rerouted"]]
    summary = {
        "queries": len(per_query), "build_s": build_s, "peak_bytes": peak,
        "p95_on_ms": p95([q["on_s"] * 1e3 for q in per_query]),
        "p95_off_ms": p95([q["off_s"] * 1e3 for q in per_query]),
        "mean_on_ms": statistics.fmean(q["on_s"] * 1e3 for q in per_query),
        "mean_off_ms": statistics.fmean(q["off_s"] * 1e3 for q in per_query),
        "rerouted_queries": len(with_r), "rerouted_joins": sum(q["rerouted"] for q in per_query),
        "delta_ms_rerouted": quartiles([(q["on_s"] - q["off_s"]) * 1e3 for q in with_r]),
        "delta_ms_other": quartiles([(q["on_s"] - q["off_s"]) * 1e3 for q in without]),
        "off_ms_rerouted": quartiles([q["off_s"] * 1e3 for q in with_r]),
        "on_ms_rerouted": quartiles([q["on_s"] * 1e3 for q in with_r]),
        "timed_joins": len(joins),
        "kernel_joins_that_lose": sum(j["route"] == "kernel" and j["card_s"] > j["host_s"]
                                      for j in joins),
        "kernel_joins": sum(j["route"] == "kernel" for j in joins),
        "index_joins_that_would_win": sum(j["route"] == "index" and j["card_s"] < j["host_s"]
                                          for j in joins),
    }
    if any(j["card_pairs"] is not None and j["card_pairs"] != j["pairs"] for j in joins):
        raise AssertionError(f"{name}: a kernel segment's pairs differ from the index's")
    print(json.dumps({"cell": name, **summary}), flush=True)
    return {**summary, "per_query": per_query, "joins": joins}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "route_costs.json"))
    ap.add_argument("--cells", default="", help="benchmark cells to measure in, comma-separated")
    ap.add_argument("--seed", type=int, default=3_200_000_301)
    ap.add_argument("--queries", type=int, default=300)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_route_costs: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.query as tq
    import repro_torch.core.table as ttable

    dev = torch.device("cuda")
    ex = tq.BatchedJoinExecutor(device=dev)
    card = card_name()
    rng = np.random.default_rng(20240527)
    finalize = tq._finalize_batch
    scrub = np.zeros(64 << 20, np.uint8)
    rows = []
    for side in SIDES:
        table = per_cell_table(ttable, side)
        index = table.key_index()
        table.kernel_pack("key", dev)  # resident, as in a warmed store
        nr = table.n_rows
        for k, sizes in FRONTIERS:
            for nq in sizes:
                lo, hi = frontier(rng, side, k, nq)
                req = tq.JoinRequest([tq.QueryBox((side, side), lo, hi)], table, merge=False)
                _, u_lo, u_hi, inv, r_lo, r_hi, _ = tq._prepare_batch(req.queries, table, False)
                windows = index.probe_windows(u_lo, u_hi)
                cand = index.estimate_candidates(u_lo, u_hi, windows)
                want = index.candidate_pairs(u_lo, u_hi, windows)
                got = []

                def dense():
                    ex._run_dense([(0, req, u_lo, u_hi, inv, r_lo, r_hi)], [None],
                                  observe=False)

                tq._finalize_batch = lambda *a: got.append(a[6:8])  # the pairs alone
                try:
                    dense()
                    if not all(np.array_equal(g, w) for g, w in zip(got[0], want)):
                        raise AssertionError(f"pairs differ at side {side}, k {k}, nq {nq}")
                    reps = 5 if cand > 1_000_000 else 9
                    host = median_s(lambda: index.candidate_pairs(u_lo, u_hi, windows), reps,
                                    scrub)
                    dev_s = median_s(dense, reps, scrub)
                finally:
                    tq._finalize_batch = finalize
                row = {"side": side, "k": k, "nq": nq, "nr": nr, "candidates": cand,
                       "pairs": int(want[0].size),
                       "pairs_estimate": round(tq._pairs_estimate(windows, nr), 1),
                       "host_s": host, "card_s": dev_s}
                rows.append(row)
                print(json.dumps(row), flush=True)
    cand = np.array([r["candidates"] for r in rows], float)
    host_t = np.array([r["host_s"] for r in rows])
    keep = cand > 0
    host_coef, host_err = fit(np.stack([np.ones(keep.sum()), cand[keep]], 1), host_t[keep])
    feats = np.array([[1.0, r["nq"], r["nq"] * r["nr"], r["pairs"]] for r in rows])
    card_coef, card_err = fit(feats, np.array([r["card_s"] for r in rows]))
    shipped = {
        "INDEX_S_PER_CANDIDATE": tq.INDEX_S_PER_CANDIDATE,
        "KERNEL_S_PER_LAUNCH": tq.KERNEL_S_PER_LAUNCH,
        "KERNEL_S_PER_QUERY_ROW": tq.KERNEL_S_PER_QUERY_ROW,
        "KERNEL_S_PER_CELL": tq.KERNEL_S_PER_CELL,
        "KERNEL_S_PER_PAIR": tq.KERNEL_S_PER_PAIR,
    }
    fitted = {
        "INDEX_S_PER_CANDIDATE": float(host_coef[1]),
        "KERNEL_S_PER_LAUNCH": float(card_coef[0]),
        "KERNEL_S_PER_QUERY_ROW": float(card_coef[1]),
        "KERNEL_S_PER_CELL": float(card_coef[2]),
        "KERNEL_S_PER_PAIR": float(card_coef[3]),
    }
    cells = {}
    for name in filter(None, args.cells.split(",")):
        cells[name] = in_cell(name, args.seed, args.queries, shipped)
    if cells:
        inrows = [r for c in cells.values() for r in c["joins"]]
        cand_c = np.array([r["candidates"] for r in inrows], float)
        h_coef, h_err = fit(np.stack([np.ones(len(inrows)), cand_c], 1),
                            np.array([r["host_s"] for r in inrows]))
        c_coef, c_err = fit(np.array([[1.0, r["nq"], r["nq"] * r["nr"], r["pairs"]]
                                      for r in inrows]),
                            np.array([r["card_s"] for r in inrows]))
        in_cell_fit = {"host": [float(x) for x in h_coef], "host_max_rel_err": h_err,
                       "card": [float(x) for x in c_coef], "card_max_rel_err": c_err}
        print(json.dumps({"in_cell_fit": in_cell_fit}), flush=True)
    # the example joins of the rule's tests: one-cell frontiers of 3,318 and
    # 10 boxes against the 200 x 200 table
    table = per_cell_table(ttable, 200)
    index = table.key_index()
    decisions = {}
    for nq in (3318, 10):
        lo, hi = frontier(np.random.default_rng(nq), 200, 1, nq)
        w = index.probe_windows(lo, hi)
        c, p = index.estimate_candidates(lo, hi, w), tq._pairs_estimate(w, table.n_rows)
        for name, consts in (("fitted", fitted), ("shipped", shipped)):
            host = consts["INDEX_S_PER_CANDIDATE"] * c
            card_s = (consts["KERNEL_S_PER_LAUNCH"] + consts["KERNEL_S_PER_QUERY_ROW"] * nq
                      + consts["KERNEL_S_PER_CELL"] * nq * table.n_rows
                      + consts["KERNEL_S_PER_PAIR"] * p)
            decisions[f"{name}.nq{nq}"] = {"candidates": c, "host_s": host, "card_s": card_s,
                                           "kernel": bool(card_s < host)}
    out = {"card": card, "host_fit": {"a_s": float(host_coef[0]), "b_s": float(host_coef[1]),
                                      "max_rel_err": host_err},
           "card_fit": {"c0_s": float(card_coef[0]), "c1_s": float(card_coef[1]),
                        "c2_s": float(card_coef[2]), "c3_s": float(card_coef[3]),
                        "max_rel_err": card_err},
           "fitted": fitted, "shipped": shipped, "decisions": decisions, "rows": rows}
    if cells:
        out["in_cell_fit"] = in_cell_fit
        out["cells"] = cells
    print(json.dumps({k: v for k, v in out.items() if k not in ("rows", "cells")}, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
