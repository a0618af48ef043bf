"""The port's DSLog examples (``examples/quickstart_torch.py`` and
``examples/lineage_debugging_torch.py``) against the reference's, on the
CPU: each runs as a subprocess with ``--device cpu`` and prints the
reference example's answers line for line (routes, cells, ``reused=gen``,
the lease error, the sharded plan), apart from the temporary directory and
process id a lease error names.  Without ``--device`` they need CUDA and
say so, and they import neither JAX nor the JAX package.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"quickstart": ("quickstart.py", "quickstart_torch.py"),
         "lineage_debugging": ("lineage_debugging.py", "lineage_debugging_torch.py")}


def _run(name, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", name), *args],
                          capture_output=True, text=True, env=env, timeout=300)


def _answers(out: str) -> list:
    """The printed lines with a lease error's store path and process id
    made neutral (they differ between any two runs)."""
    out = re.sub(r"store '[^']*'", "store '<root>'", out)
    return re.sub(r"\(pid \d+ on [^)]*\)", "(pid <pid>)", out).splitlines()


@pytest.fixture(scope="module")
def runs():
    return {name: (_run(ref), _run(port, "--device", "cpu")) for name, (ref, port) in PAIRS.items()}


@pytest.mark.parametrize("name", list(PAIRS))
def test_the_port_prints_the_references_answers(runs, name):
    ref, port = runs[name]
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert port.returncode == 0, port.stdout + port.stderr
    assert _answers(port.stdout) == _answers(ref.stdout)


def test_quickstart_output_shape(runs):
    """The quickstart's route, reuse and lazy reload ran (as the
    reference's ``test_examples.py`` checks its own)."""
    out = runs["quickstart"][1].stdout
    assert "planner route:" in out
    assert "reused=gen" in out
    assert "table blobs" in out
    assert "S[7] depends on 64 cells of X (expected 64)" in out


def test_lineage_debugging_output_shape(runs):
    """The forensics example's answers: the lease error, the ground truth
    and the sharded store's plan."""
    out = runs["lineage_debugging"][1].stdout
    assert "second writer refused while store is open" in out
    assert "(expected [2])" in out
    assert "reopened after close: checkpointed state answers identically" in out
    assert "sharded store:" in out and "over 4 shards" in out


@pytest.mark.parametrize("name", [port for _, port in PAIRS.values()])
def test_the_default_device_needs_cuda(name):
    """Without ``--device`` the examples run on CUDA, and raise here."""
    r = _run(name)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


@pytest.mark.parametrize("name", [port for _, port in PAIRS.values()])
def test_the_examples_import_neither_jax_nor_repro(name):
    with open(os.path.join(REPO, "examples", name)) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert mods and all(m.split(".")[0] not in ("jax", "repro") for m in mods), mods
