"""``BENCHMARK.json`` against the files it names, the harness's discovery of
cells and metrics by file, and the import guard."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def test_benchmark_json_names_existing_files():
    bench = harness.benchmark()
    listing = harness.listing()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert harness.load_config(c["name"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["name"] in listing["metrics"]
        reader = harness.metric_reader(m["name"])
        assert (reader.NAME, reader.UNIT, reader.BETTER, reader.SOURCE) == (
            m["name"], m["unit"], m["better"], m["source"])
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        e2e = harness.cell_metrics(bench, cell, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(bench, cell, True)


def test_new_cell_and_metric_are_found_as_files(tmp_path):
    """A later change adds a cell and metrics as new files; the harness
    lists them, and a reader of a span it has never named passes its own
    case, with no edit to a file that is there."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = harness.load_cell("fig89.query_wide")
    cell.update(name="fig89.query_mid", traffic="query_mid")
    cell["params"]["selectivity"] = 0.01
    (tmp_path / "perfbench/workloads/fig89.query_mid.json").write_text(json.dumps(cell))
    (tmp_path / "perfbench/metrics/query.answer_boxes.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "query.answer_boxes", "count", "lower", "program_counter"\n'
        'LAYER, MOVES = "core/query.py", "query_p95_ms"\n\n\ndef read(run):\n    return None\n')
    (tmp_path / "perfbench/metrics/shard.exchange_ms_per_query.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "shard.exchange_ms_per_query", "ms", "lower", '
        '"program_span"\n'
        'LAYER, MOVES = "core/shard.py", "query_p95_ms"\n'
        'CASE = {"sets": {"span_s": {"shard.exchange": 0.5}, "span_n": {"shard.exchange": 40}},\n'
        '        "reads": 0.5 / 20 * 1e3}\n\n\n'
        'def read(run):\n    return run.span_ms_per_query("shard.exchange")\n')
    out = subprocess.run([sys.executable, "perfbench/run.py", "--list"], cwd=tmp_path,
                         capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fig89.query_mid" in found["workloads"] and "query.answer_boxes" in found["metrics"]
    assert "shard.exchange_ms_per_query" in found["metrics"]
    assert set(harness.listing()["workloads"]) < set(found["workloads"])
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
         "perfbench/test_perfbench_metrics.py", "-k", "exchange"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for test in ("test_reader_on_a_fake_run", "test_reader_finds_nothing_in_an_empty_run"):
        assert f"{test}[shard.exchange_ms_per_query] PASSED" in out.stdout, out.stdout[-3000:]


def test_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import perfbench.run, perfbench.control\n"
            "from perfbench import harness, testing, tracing, roofline\n"
            "from repro_torch import core\n"
            "from repro_torch.kernels import _build, ops, range_join\n"
            "import torch.profiler\n"
            "for n in harness.listing()['metrics']: harness.metric_reader(n)\n"
            "for n in harness.listing()['traffic']: harness._module('traffic', n)\n"
            "for n in harness.listing()['stores']: harness._module('stores', n)\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxonomy", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fig89.query_wide",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, env=_env(), timeout=120)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr

