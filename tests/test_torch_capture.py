"""The port's jacobian oracle, op registry and lineage facade vs the JAX
package's.

* ``capture_jacobian``: ``tests/test_capture.py``'s cases, each ``jnp``
  function given its torch twin, on the same inputs: the relations must be
  equal (tolerance 0: the nonzero pattern of the jacobian).  The port
  computes in float32, the precision ``jax.jacfwd`` runs the reference's
  float64 inputs in; an input whose derivative underflows in float32 but
  not in float64 pins that.
* ``oplib``: every registry op's lineage from the same seed equals the
  reference's, relation for relation.
* ``repro_torch.lineage`` exports the reference facade's names, and
  importing it leaves ``jax`` and ``repro`` out of ``sys.modules``.

The port runs with ``device="cpu"``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core.capture as jC
import repro.core.oplib as joplib
import repro.lineage as jlineage
import repro_torch.core.capture as tC
import repro_torch.core.oplib as toplib

from test_capture import CASES

ROOT = os.path.join(os.path.dirname(__file__), "..")

# torch twins of test_capture.py's jnp functions, by case name
TWINS = {
    "negative": lambda x: -x,
    "exp": torch.exp,
    "sum_ax1": lambda x: x.sum(dim=1),
    "sum_all": lambda x: x.sum().reshape(1),
    "softmax": lambda x: torch.exp(x) / torch.exp(x).sum(-1, keepdim=True),
    "transpose": lambda x: x.T,
    "reshape": lambda x: x.reshape(-1),
    "tile": lambda x: torch.tile(x, (2, 2)),
    "repeat": lambda x: torch.repeat_interleave(x, 3, dim=0),
    "roll": lambda x: torch.roll(x, 2, 0),
    "flip": lambda x: torch.flip(x, (0,)),
    "pad": lambda x: F.pad(x, (1, 1, 1, 1)),
    "slice": lambda x: x[:2, :3],
    "cumsum": lambda x: torch.cumsum(x, 0),
}


def _rand(rng, shape):
    return rng.random(shape) + 0.5


def _same_rel(got, want):
    """A port relation equals a reference one: shapes and distinct rows."""
    assert (got.out_shape, got.in_shape) == (want.out_shape, want.in_shape)
    a, b = np.unique(got.rows(), axis=0), np.unique(want.rows(), axis=0)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _both(jf, tf, *args):
    want = jC.capture_jacobian(jf, *args)
    got = tC.capture_jacobian(tf, *args, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_rel(g, w)
    return got


def test_every_case_has_a_twin():
    assert sorted(TWINS) == sorted(c[0] for c in CASES)


@pytest.mark.parametrize("name,f,shapes,symbolic", CASES, ids=[c[0] for c in CASES])
def test_jacobian_matches_reference(name, f, shapes, symbolic):
    rng = np.random.default_rng(sum(map(ord, name)))
    args = [_rand(rng, s) for s in shapes]
    got = _both(f, TWINS[name], *args)
    _same_rel(got[0], symbolic())


def test_matmul_broadcast_conv_take_and_sort_match_reference():
    rng = np.random.default_rng(1)
    A, B = _rand(rng, (3, 4)), _rand(rng, (4, 5))
    ra, rb = _both(lambda a, b: a @ b, lambda a, b: a @ b, A, B)
    assert (ra, rb) == tuple(tC.matmul_lineage(3, 4, 5))
    x, v = _rand(rng, (4, 3)), _rand(rng, (3,))
    rx, rv = _both(lambda a, b: a * b, lambda a, b: a * b, x, v)
    assert rv == tC.broadcast_lineage((3,), (4, 3))
    x, w = _rand(rng, (10,)), _rand(rng, (3,))
    rx, _ = _both(
        lambda a, b: jnp.convolve(a, b, mode="valid"),
        lambda a, b: F.conv1d(a[None, None], b.flip(0)[None, None])[0, 0],
        x, w,
    )
    assert rx == tC.conv1d_lineage(10, 3)
    idx = np.array([3, 1, 1, 0])
    x = _rand(rng, (5, 2))
    got = _both(lambda a: a[jnp.asarray(idx)], lambda a: a[torch.as_tensor(idx)], x)
    assert got[0] == tC.take_lineage((5, 2), idx, 0)
    x = rng.permutation(8).astype(float)
    pmat = np.eye(8)[np.argsort(x, kind="stable")]
    got = _both(lambda a: jnp.asarray(pmat) @ a,
                lambda a: torch.as_tensor(pmat, dtype=a.dtype) @ a, x)
    assert got[0] == tC.sort_lineage(x)


def test_jacobian_runs_in_the_references_precision():
    """exp'(-120) = 7.7e-53 underflows in float32 and not in float64: the
    reference (x64 off) drops that cell, so the port must too."""
    assert not jax.config.jax_enable_x64
    x = np.array([-120.0, 0.5, 3.0])
    got = _both(jnp.exp, torch.exp, x)[0]
    assert sorted(map(tuple, got.in_idx)) == [(1,), (2,)]
    jac64 = torch.func.jacfwd(torch.exp)(torch.as_tensor(x, dtype=torch.float64))
    assert int((jac64.abs() > 0).sum()) == 3  # float64 keeps all three
    got_eps = tC.capture_jacobian(torch.exp, x, eps=2.0, device="cpu")[0]
    _same_rel(got_eps, jC.capture_jacobian(jnp.exp, x, eps=2.0)[0])
    assert sorted(map(tuple, got_eps.in_idx)) == [(2,)]


def test_capture_jacobian_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tC.capture_jacobian(torch.exp, np.ones(3))


# --------------------------------------------------------------------------- #
# The op registry
# --------------------------------------------------------------------------- #
def test_registry_matches_reference():
    assert toplib.op_names() == joplib.op_names()
    for name in joplib.op_names():
        t, j = toplib.get_op(name), joplib.get_op(name)
        assert (t.name, t.category, t.value_dependent, t.shapes, t.shape_pattern_dependent) == (
            j.name, j.category, j.value_dependent, j.shapes, j.shape_pattern_dependent)


@pytest.mark.parametrize("name", joplib.op_names())
def test_op_lineage_matches_reference(name):
    t, j = toplib.OPS[name], joplib.OPS[name]
    for shape in j.shapes:
        got = t.lineage(shape, np.random.default_rng(0))
        want = j.lineage(shape, np.random.default_rng(0))
        assert sorted(got) == sorted(want), name
        for key, rel in want.items():
            g = got[key]
            assert (g.out_shape, g.in_shape) == (rel.out_shape, rel.in_shape), (name, key)
            assert g.out_idx.tobytes() == rel.out_idx.tobytes(), (name, key)
            assert g.in_idx.tobytes() == rel.in_idx.tobytes(), (name, key)


OPLIB_TWINS = {
    # registry op -> (torch function, its operands' shapes from the op's first shape)
    "negative": (lambda x: -x, lambda s: [s]),
    "exp": (torch.exp, lambda s: [s]),
    "add": (lambda a, b: a + b, lambda s: [s, s]),
    "mul_rowvec": (lambda a, v: a * v, lambda s: [s, (s[-1],)]),
    "sum": (lambda x: x.sum().reshape(1), lambda s: [s]),
    "sum_axis1": (lambda x: x.sum(dim=1), lambda s: [s]),
    "softmax": (lambda x: torch.softmax(x, -1), lambda s: [s]),
    "matmul": (lambda a, b: a @ b, lambda s: [s, (s[1], s[1] + 2)]),
    "transpose": (lambda x: x.T, lambda s: [s]),
    "tile": (lambda x: torch.tile(x, (2, 2)), lambda s: [s]),
    "roll": (lambda x: torch.roll(x, 2, 0), lambda s: [s]),
    "flip": (lambda x: torch.flip(x, (0,)), lambda s: [s]),
    "pad": (lambda x: F.pad(x, (1, 1, 1, 1)), lambda s: [s]),
}


@pytest.mark.parametrize("name", sorted(OPLIB_TWINS))
def test_jacobian_equals_oplib_lineage(name):
    """The oracle agrees with the registry's symbolic lineage (chip_smoke.py
    phase 9e holds the same ops on the card)."""
    f, shapes = OPLIB_TWINS[name]
    spec = toplib.OPS[name]
    shape = spec.shapes[0]
    args = [_rand(np.random.default_rng(2), s) for s in shapes(shape)]
    rels = tC.capture_jacobian(f, *args, device="cpu")
    want = spec.lineage(shape, np.random.default_rng(0))
    for (_, pos), rel in want.items():
        assert rels[pos] == rel, (name, pos)


# --------------------------------------------------------------------------- #
# The facade
# --------------------------------------------------------------------------- #
def test_lineage_facade_exports_the_reference_names():
    code = (
        "import sys\n"
        "import repro_torch.lineage as L\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(sorted(L.__all__))\n"
        "print(bad)\n"
        "missing = [n for n in L.__all__ if not hasattr(L, n)]\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[0] == str(sorted(jlineage.__all__))
    import repro_torch.lineage as L

    assert L.capture is tC and L.OPS is toplib.OPS
    assert L.ShardedDSLog.__module__ == "repro_torch.core.shard"
    assert all(getattr(L, n).__module__.startswith("repro_torch")
               for n in L.__all__ if hasattr(getattr(L, n), "__module__"))
