"""The port's static-analysis tools (``repro_torch.tools.astcache``,
``dslint`` and ``dsflow``) against the reference's, on the CPU.

* Every fixture tree of the reference's own tests (``test_tools_dslint.py``
  and ``test_tools_dsflow.py``) gives the port's tool the reference's
  findings (and, for ``dsflow``, the reference's static lock graph) under
  a ``repro/`` root and a ``repro_torch/`` root: each reference test runs
  with its fixture writer spied on, so its own assertions still hold.
* Both gates over ``src/repro_torch`` are clean, and ``dsflow``'s static
  lock graph there is the reference's over ``src/repro``: 15 edges.
* ``dsflow --check-dynamic`` accepts the edges the port's race detector
  exports over one test of ``test_torch_shard.py``.
* The tools import neither JAX nor the JAX package.
"""

import inspect
import json
import os
import subprocess
import sys

import pytest

import test_tools_dsflow as ref_dsflow_tests
import test_tools_dslint as ref_dslint_tests
from repro.tools import dsflow as j_dsflow
from repro.tools import dslint as j_dslint
from repro_torch.tools import dsflow as t_dsflow
from repro_torch.tools import dslint as t_dslint

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
SPIED = {"dslint": (ref_dslint_tests, "_lint("), "dsflow": (ref_dsflow_tests, "_analyze(")}


def _fixture_tests(tool) -> list:
    """The reference tests of ``tool`` that write their fixture trees
    through the module's writer (not those that register a rule of their
    own, which the port's rule table would not hold)."""
    mod, call = SPIED[tool]
    out = []
    for name, fn in vars(mod).items():
        if name.startswith("test_") and callable(fn):
            src = inspect.getsource(fn)
            if call in src and "register" not in src:
                out.append((tool, name))
    return out


CASES = _fixture_tests("dslint") + _fixture_tests("dsflow")


def _port_names(message: str) -> str:
    """A message with the port's module names read as the reference's (a
    finding names the lock table of its own package)."""
    return message.replace("repro_torch.", "repro.")


def _lint_key(findings) -> list:
    return [(f.line, f.rule, _port_names(f.message)) for f in findings]


def _flow_key(analysis) -> tuple:
    return ([(f.rule, os.path.basename(f.path), f.line, _port_names(f.message))
             for f in analysis.findings],
            sorted(analysis.static_edges()))


def _write(root, files: dict) -> list:
    paths = []
    for rel, src in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(src)
        paths.append(path)
    return sorted(paths)


@pytest.mark.parametrize("tool,name", CASES, ids=[f"{t}-{n}" for t, n in CASES])
def test_the_ports_tools_give_the_references_findings(tool, name, tmp_path, monkeypatch):
    """The reference test ``name`` runs as written; each fixture tree it
    writes is also written under a ``repro/`` and a ``repro_torch/`` root
    and analysed by the port's tool, whose findings must be the
    reference's on the tree as the test wrote it (a message names the
    port's lock table where the reference's names its own)."""
    mod, _ = SPIED[tool]
    seen = []
    if tool == "dslint":
        writer = mod._lint

        def spy(tmp, relpath, source):
            want = writer(tmp, relpath, source)
            rest = relpath.split("/", 1)[1] if relpath.startswith("repro/") else relpath
            for root in ("repro", "repro_torch"):
                path = tmp_path / "port" / str(len(seen)) / root / rest
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(source)
                assert _lint_key(t_dslint.lint_file(str(path))) == _lint_key(want), (root, relpath)
            seen.append(relpath)
            return want

        monkeypatch.setattr(mod, "_lint", spy)
    else:
        writer = mod._analyze

        def spy(files, lock_order=None, static_locks=None, **kw):
            want = writer(files, lock_order=lock_order, static_locks=static_locks, **kw)
            for root in ("", "repro", "repro_torch"):
                base = tmp_path / "port" / str(len(seen)) / (root or "bare")
                rooted = {os.path.join(root, rel): src for rel, src in files.items()}
                got = t_dsflow.analyze_paths(_write(str(base), rooted), lock_order=lock_order,
                                             static_locks=static_locks, **kw)
                assert _flow_key(got) == _flow_key(want), (root, sorted(files))
            seen.append(sorted(files))
            return want

        monkeypatch.setattr(mod, "_analyze", spy)
    fn = getattr(mod, name)
    fn(**({"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}))
    assert seen, f"{name} wrote no fixture"


@pytest.mark.parametrize("path,root", [
    ("/x/src/repro_torch/core/wal.py", "repro_torch/core/wal.py"),
    ("/x/src/repro/core/wal.py", "repro/core/wal.py"),
    ("/x/tools/repro_torch/kernels/ops.py", "repro_torch/kernels/ops.py"),
    ("/x/core/y.py", "/x/core/y.py")])
def test_scope_keys_start_at_either_package_root(path, root):
    """``_scope_key`` cuts a path at its last ``repro_torch`` or ``repro``
    part, as the reference's cuts at ``repro``; a path with neither stays
    as given."""
    assert t_dslint._scope_key(path) == root
    if "repro_torch" not in path:
        assert j_dslint._scope_key(path) == root


def test_dslint_gate_over_the_port_is_clean():
    """Every rule over ``src/repro_torch``: no finding, and the CLI exits 0."""
    assert t_dslint.lint_paths([os.path.join(SRC, "repro_torch")]) == []
    r = subprocess.run([sys.executable, "-m", "repro_torch.tools.dslint",
                        os.path.join(SRC, "repro_torch")], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert r.returncode == 0 and "dslint: 0 finding(s)" in r.stdout, r.stdout + r.stderr


def test_dsflow_gate_over_the_port_is_clean_with_the_references_lock_graph():
    """``dsflow`` over ``src/repro_torch``: no finding, and the static lock
    graph is the reference's over ``src/repro``, 15 edges."""
    port = t_dsflow.analyze_paths([os.path.join(SRC, "repro_torch")])
    ref = j_dsflow.analyze_paths([os.path.join(SRC, "repro")])
    assert port.findings == [] and ref.findings == []
    assert port.static_edges() == ref.static_edges()
    assert len(port.static_edges()) == 15


def test_check_dynamic_accepts_the_port_race_detectors_export(tmp_path, monkeypatch):
    """The acquisition graph the port's race detector records over
    ``test_torch_shard.py``'s cold-load test, exported by
    ``racecheck.export_edges``, is covered by ``dsflow``'s static graph of
    the port (``--check-dynamic`` exits 0), and holds the shard load latch's
    edges."""
    import test_torch_shard
    from repro_torch.tools import racecheck

    monkeypatch.setenv("DSLOG_RACE_DETECT", "1")
    racecheck.reset()
    try:
        test_torch_shard.test_port_locks_are_instrumented_under_the_detector(tmp_path)
        path = str(tmp_path / "edges.json")
        assert racecheck.export_edges(path) > 0
        assert racecheck.findings() == []
    finally:
        racecheck.reset()
    with open(path) as f:
        edges = json.load(f)["edges"]
    assert any(e["held"] == "shard._shard_load_lock" for e in edges), edges
    r = subprocess.run([sys.executable, "-m", "repro_torch.tools.dsflow",
                        os.path.join(SRC, "repro_torch"), "--check-dynamic", path],
                       capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert t_dsflow.analyze_paths([os.path.join(SRC, "repro_torch")]).check_dynamic(edges) == []


@pytest.mark.parametrize("tool,args", [("dslint", ["--list-rules"]),
                                       ("dsflow", ["--baseline", "BASELINE"])])
def test_the_clis_answer_as_the_references(tool, args):
    """``--list-rules`` names the reference's rules; ``--baseline`` with
    the port's (empty) baseline file passes the port's tree."""
    baseline = os.path.join(SRC, "repro_torch", "tools", "dsflow_baseline.json")
    args = [baseline if a == "BASELINE" else a for a in args]
    target = [] if tool == "dslint" else [os.path.join(SRC, "repro_torch")]
    outs = []
    for pkg in ("repro", "repro_torch"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.{tool}", *target, *args],
                           capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                           timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    with open(baseline) as f:
        assert json.load(f) == {"findings": []}


def test_the_tools_import_neither_jax_nor_repro():
    """Importing the port's three analysis tools loads no JAX and nothing
    of the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch.tools.astcache, repro_torch.tools.dslint, repro_torch.tools.dsflow\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
