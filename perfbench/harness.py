"""One run of one cell: build the store from the seed, warm up, measure for
``seconds``, check the answers against the plain reference, and reduce
what was recorded to the cell's metrics.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, the store kind in
``stores/<kind>.py``, the traffic kind in ``traffic/<kind>.py`` and each
metric's reader, with its own test case (``CASE``), in
``metrics/<metric>.py``; ``BENCHMARK.json`` at the checkout's root says
which metrics a cell reports.  A reader takes the :class:`Run` whole: in
the traced run that holds every program span and counter by name.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from perfbench import tracing
from perfbench.reference import oracle

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# top-level module names the process must never load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    return _json(PB / "workloads" / f"{name}.json")


def load_config(name: str) -> dict:
    return _json(PB / "configs" / f"{name}.json")


def _module(kind: str, name: str):
    path = PB / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    modname = f"perfbench.{kind}.{name.replace('.', '__')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _module("metrics", name)


def listing() -> dict:
    """The cells, configurations, traffic kinds, store kinds and metric
    readers present as files."""
    def names(kind, suffix):
        return sorted(p.name[: -len(suffix)] for p in (PB / kind).glob(f"*{suffix}")
                      if not p.name.startswith("_"))
    return {"workloads": names("workloads", ".json"), "configs": names("configs", ".json"),
            "traffic": names("traffic", ".py"), "stores": names("stores", ".py"),
            "metrics": names("metrics", ".py")}


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The entries of ``BENCHMARK.json`` this cell reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Run:
    """What one run records; the metric readers take it whole."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str):
        self.cell, self.seed, self.seconds, self.trace, self.device = (
            cell, seed, seconds, trace, device)
        self.setup_s = self.window_s = None
        self.latencies: list[float] = []  # seconds of each query the window completed
        self.queries = 0
        self.counters: dict[str, int] = {}  # program counters' moves over the window
        self.plan_self_s: list[float] = []  # per query, from prov_query(trace=True)
        self.execute_s: list[float] = []
        self.launches: list = []
        self.timeline: dict = {}
        self.bound_s: dict[str, float] = {}  # kernel -> summed least seconds
        # traced run only: every program span by name, summed over the
        # window's queries (seconds; how many opened, events included), and
        # the seconds of each stage of the store's build
        self.span_s: dict[str, float] = {}
        self.span_n: dict[str, int] = {}
        self.stages_s: dict[str, float] = {}

    def span_ms_per_query(self, name: str) -> float | None:
        """Milliseconds a query spent in the program's span ``name``, over
        the window's queries; None where no query opened it."""
        if not self.queries or not self.span_n.get(name):
            return None
        return self.span_s.get(name, 0.0) / self.queries * 1e3


def record_spans(run: Run, trace) -> None:
    """Add every span of one query's trace but its root to ``run``'s sums."""
    for sp in trace.spans():
        if sp is trace.root:
            continue
        run.span_n[sp.name] = run.span_n.get(sp.name, 0) + 1
        if sp.duration is not None:
            run.span_s[sp.name] = run.span_s.get(sp.name, 0.0) + sp.duration


def build_stages(log) -> dict[str, float]:
    """Seconds of each stage of the store's build so far, from its metrics
    registry (``ingest_seconds{stage=...}``)."""
    return {h["labels"]["stage"]: h["sum"] for h in log.metrics_snapshot()["histograms"]
            if h["name"] == "ingest_seconds" and "stage" in h["labels"]}


def counters(log, torch_kernels, ops) -> dict[str, int]:
    """Every numeric ``io_stats`` counter, the kernel wrappers' launch
    counters and the bytes ``kernels/ops.py`` handed to the device."""
    snap = {k: int(v) for k, v in dict(log.io_stats).items() if isinstance(v, (int, float))}
    for name in ("range_join_mask", "range_join_tile_masks"):
        snap[f"launches.{name}"] = int(getattr(torch_kernels, name).launches)
    snap["ops.h2d_bytes"] = int(ops.h2d_bytes)
    return snap


# --------------------------------------------------------------------------- #
# Clients: how a request reaches the program
# --------------------------------------------------------------------------- #
class QueryClient:
    """Queries against a store the configuration's kind builds in set-up."""

    def __init__(self, core, cfg, seed, root, device, rec, run):
        self.cfg, self.seed, self.rec, self.run = cfg, seed, rec, run
        self.store_kind = _module("stores", cfg["kind"])
        self.log, self.info = self.store_kind.build(core, cfg, seed, root, device)
        if rec.enabled:
            run.stages_s = build_stages(self.log)
        self.answers: list = []  # (request, answer) of the window

    def do(self, req, keep: bool) -> None:
        args = (req["path"],) if req["form"] == "path" else (req["src"], req["dst"])
        if self.rec.enabled and keep:
            res, tr = self.log.prov_query(*args, req["cells"], merge=req["merge"], trace=True)
            for sp in tr.spans("plan"):
                self.run.plan_self_s.append(
                    sp.duration - sum(c.duration or 0.0 for c in sp.children))
            self.run.execute_s += [sp.duration for sp in tr.spans("execute")]
            record_spans(self.run, tr)
        else:
            res = self.log.prov_query(*args, req["cells"], merge=req["merge"])
        if keep:
            self.answers.append((req, res))

    def views_materialized(self) -> int:
        return int(self.log.io_stats["views_materialized"])

    def after_window(self, run: Run) -> None:
        self.log.close()

    def check(self, run: Run, params: dict, control: bool) -> tuple[dict, dict]:
        """Compare a sample of the window's answers, drawn from the seed,
        with the reference's: the numbers compared and, with ``control``,
        what the control reads on the same sample."""
        return check_queries(self.store_kind, self.cfg, self.seed, self.answers,
                             params["check_queries"], control)


def sample(n_total: int, k: int, seed: int, stream: int) -> list[int]:
    """``k`` of ``n_total`` indices drawn from the seed, and the last one."""
    rng = np.random.default_rng([seed, stream])
    picks = set(rng.choice(n_total, size=min(k, n_total), replace=False).tolist())
    if n_total:
        picks.add(n_total - 1)
    return sorted(picks)


def _query_ends(req) -> tuple[str, str]:
    if req["form"] == "path":
        return req["path"][0], req["path"][-1]
    return req["src"], req["dst"]


def answer_cells(box) -> np.ndarray:
    """The program's answer as flat cells; boxes outside the array read as
    the impossible cell -1, which no reference answer holds."""
    if box.n_rows and ((box.lo < 0).any() or (box.hi >= np.array(box.shape)).any()
                       or (box.lo > box.hi).any()):
        return np.array([-1])
    return oracle.box_cells(box.shape, box.lo, box.hi)


def check_queries(store_kind, cfg, seed, answers, k, control) -> tuple[dict, dict]:
    edges, shapes = store_kind.reference_edges(cfg, seed)
    wrong = control_wrong = 0
    picks = sample(len(answers), k, seed, 3)
    for i in picks:
        req, res = answers[i]
        src, dst = _query_ends(req)
        cells = np.ravel_multi_index(req["cells"].T, shapes[src])
        want = oracle.propagate(edges, src, dst, cells, shapes)
        wrong += not np.array_equal(answer_cells(res), want)
        if control:
            control_wrong += not np.array_equal(oracle.bounding_box(shapes[dst], want), want)
    checks = {"wrong_answers": (wrong, 0), "answers_checked": (len(picks), None)}
    return checks, {"wrong_answers": control_wrong}


CLIENTS = {"query": QueryClient}


# --------------------------------------------------------------------------- #
# One run
# --------------------------------------------------------------------------- #
def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             cell: dict | None = None, cfg: dict | None = None, metrics: list | None = None,
             control: bool = False) -> dict:
    """Run cell ``name`` once; returns the result line's object.  ``cell``,
    ``cfg`` and ``metrics`` replace what the files and ``BENCHMARK.json``
    give (the tests run shrunk cells on the CPU).  With ``control`` the
    object also holds what the control reads on the same sample
    (``control.py``; the benchmark's own runs never compute it)."""
    import torch

    from repro_torch import core
    from repro_torch.kernels import _build, ops, range_join

    cell = cell if cell is not None else load_cell(name)
    cfg = cfg if cfg is not None else load_config(cell["config"])
    metrics = metrics if metrics is not None else cell_metrics(benchmark(), name, trace)
    if device == "cuda":
        _build.load()  # the kernel library: built on a checkout's first run
    traffic = _module("traffic", cell["traffic_kind"])
    params = cell["params"]
    run = Run(name, seed, seconds, trace, device)
    rec = tracing.Recorder(trace, torch)
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        client = CLIENTS[cell["request"]](core, cfg, seed, os.path.join(workdir, "store"),
                                          device, rec, run)
        # warm-up: the cell's own mix, from a stream of its own, in rounds
        # until the store admits no more views
        warm = traffic.requests(params, client.info, np.random.default_rng([seed, 1]))
        for _ in range(params.get("warmup_rounds_max", 8)):
            before = client.views_materialized()
            for _ in range(params["warmup_requests"]):
                client.do(next(warm), keep=False)
            if client.views_materialized() == before:
                break
        if device == "cuda":
            torch.cuda.synchronize()
        gen = traffic.requests(params, client.info, np.random.default_rng([seed, 2]))
        rec.install(ops, client.log.planner)
        c0 = counters(client.log, range_join, ops)
        run.setup_s = time.perf_counter() - t_start
        with rec.profile() as prof:
            with rec.span("window"):
                t0 = time.perf_counter()
                end = t0 + seconds
                now = t0
                while now < end:
                    req = next(gen)
                    t1 = time.perf_counter()
                    with rec.span("request"):
                        client.do(req, keep=True)
                    now = time.perf_counter()
                    if req["kind"] == "query":
                        run.latencies.append(now - t1)
                run.window_s = now - t0
        rec.uninstall()
        run.queries = len(run.latencies)
        c1 = counters(client.log, range_join, ops)
        run.counters = {k: c1[k] - c0.get(k, 0) for k in c1}
        peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
        run.launches = rec.launches
        if trace:
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            run.timeline = tracing.timeline(tracing.read_chrome_trace(path))
            os.remove(path)
        client.after_window(run)
        if trace:
            run.bound_s = kernel_bounds(torch, run.launches, device)
        t_check = time.perf_counter()
        checks, control_reads = client.check(run, params, control)
        check_s = time.perf_counter() - t_check
    finally:
        rec.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)
    values = {}
    for m in metrics:
        v = metric_reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(lim is None or val <= lim for val, lim in checks.values())
    result = {
        "correct": correct,
        "attempted": len(run.latencies),
        "failed": 0,
        "metrics": values,
        "device": device_info(torch, device, peak, run),
    }
    if trace and run.timeline:
        result["breakdown"] = breakdown(run.timeline)
    result["check_seconds"] = check_s
    if control:
        result["control"] = control_reads
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def kernel_bounds(torch, launches, device) -> dict[str, float]:
    """Summed least seconds of the window's launches, per kernel."""
    from perfbench.roofline import launch_bound_s

    out: dict[str, float] = {}
    for kernel, segments in launches:
        out[kernel] = out.get(kernel, 0.0) + launch_bound_s(torch, segments, device)
    return out


def device_info(torch, device, peak, run) -> dict:
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    if run.trace:
        info["busy_s"] = run.timeline.get("busy_s", 0.0)
        info["window_s"] = run.timeline.get("window_s", run.window_s)
    return info


def breakdown(tl: dict) -> dict:
    ops_ = sorted(tl["device_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tl["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops_], "idle_gaps": [[k, v] for k, v in gaps]}
