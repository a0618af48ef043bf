"""Shrunk configurations for the CPU tests: the same workflows at
sizes a test run holds (the cells' own sizes run on the card)."""

from __future__ import annotations

import copy

from perfbench import harness


def shrink(cfg: dict) -> dict:
    """A copy of ``cfg`` whose workflows, whatever store kind holds them,
    take the test sizes."""
    cfg = copy.deepcopy(cfg)
    for wf in cfg.get("workflows", ()):
        if wf["name"] == "image":
            wf["input"] = [24, 24]
            wf["ops"][0][1]["stops"] = [24, 24]
        elif wf["name"] == "relational":
            wf["input"] = [120, 3]
            wf["ops"][0][1].update(right_rows=60, key_range=60)
        elif wf["name"] == "resnet":
            wf["input"] = [12, 12]
        else:
            wf["input"] = [12, 12]
    return cfg


def tiny_config(name: str) -> dict:
    return shrink(harness.load_config(name))


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(name))
    cell["params"]["check_queries"] = 12
    if "selectivity" in cell["params"]:
        # a tiny array's 0.001 is a single cell
        cell["params"]["selectivity"] = max(cell["params"]["selectivity"], 0.05)
    return cell


def run_tiny(name: str, seed: int, trace: bool = False, seconds: float = 0.2, **kw) -> dict:
    import time

    cell = kw.pop("cell", None) or tiny_cell(name)
    cfg = kw.pop("cfg", None) or tiny_config(cell["config"])
    metrics = harness.cell_metrics(harness.benchmark(), name, trace) \
        if name in {w["name"] for w in harness.benchmark()["workloads"]} else []
    return harness.run_cell(name, seed, seconds, trace, "cpu", time.perf_counter(), cell=cell,
                            cfg=cfg, metrics=metrics, **kw)
