"""The port's optimizer, gradient compression and straggler watchdog
(``repro_torch.optim``, ``repro_torch.distributed.elastic``) vs the JAX
package's, on the CPU.

Both packages update the same numpy-seeded float32 trees.  Tolerance:
rtol = atol = 2e-4 on parameters, moments, ``grad_norm`` and ``lr``
after each step (the step-dependent scalars are float32 in both, so the
measured differences are a few ulps: at most 1.5e-8 here); ``step`` and the
int8 codes are compared exactly.  Top-k is compared on data without ties
in magnitude, because ``jax.lax.top_k`` and ``torch.topk`` may order
ties differently.  ``compressed_psum`` runs in a two-process ``gloo``
group (a ``file://`` rendezvous under the test's ``tmp_path``) and must
equal the sum of the reference's ``ef_roundtrip`` outputs on each rank's
gradients, with each rank's own residual.
"""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.elastic import StepWatchdog as JWatchdog
from repro.optim import adamw as J
from repro.optim import compress as JC
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.optim import adamw as T
from repro_torch.optim import compress as TC

SEED = 20240527
TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}


def _trees(rng, scale=1.0):
    """The same float32 leaves as a reference dict and the port's list
    (in the reference's sorted-key order)."""
    tree = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    return tree, [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_steps_equal_reference(schedule):
    """Four steps with clipping active (gradients of norm ~ 40 against
    clip_norm 1), warmup 2 of total 5 so the decay runs too."""
    cfg_kw = dict(lr=0.05, warmup_steps=2, total_steps=5, schedule=schedule)
    rng = np.random.default_rng(SEED)
    jp, tp = _trees(rng)
    params = [torch.nn.Parameter(t) for t in tp]
    jstate, tstate = J.adamw_init(jp), T.adamw_init(params)
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    assert all(m.dtype == torch.float32 for m in tstate["m"] + tstate["v"])
    for _ in range(4):
        jg, tg = _trees(rng, scale=10.0)
        jp, jstate, jm = J.adamw_update(jp, jg, jstate, J.AdamWConfig(**cfg_kw))
        _, tstate, tm = T.adamw_update(params, tg, tstate, T.AdamWConfig(**cfg_kw))
        assert float(jm["grad_norm"]) > 1.0  # clipping is active
        assert tm["lr"].dtype == torch.float32 and tm["grad_norm"].dtype == torch.float32
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        assert int(tstate["step"]) == int(jstate["step"])
        for i, k in enumerate(sorted(SHAPES)):
            _close(params[i].detach(), jp[k])
            _close(tstate["m"][i], jstate["m"][k])
            _close(tstate["v"][i], jstate["v"][k])


def test_adamw_config_equals_reference():
    assert T.AdamWConfig()._asdict() == J.AdamWConfig()._asdict()


def test_adamw_minimizes_quadratic():
    cfg = T.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, schedule="constant")
    w = torch.nn.Parameter(torch.tensor([3.0, -2.0]))
    state = T.adamw_init([w])
    for _ in range(200):
        (g,) = torch.autograd.grad(torch.sum(w**2), [w])
        _, state, _ = T.adamw_update([w], [g], state, cfg)
    assert float(torch.sum(w.detach() ** 2)) < 1e-3 and int(state["step"]) == 200


def test_adamw_rejects_mismatched_grads():
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="follow the parameters"):
        T.adamw_update([w], [], T.adamw_init([w]), T.AdamWConfig())


def test_global_norm_equals_reference():
    jt, tt = _trees(np.random.default_rng(SEED + 1))
    _close(T.global_norm(tt), J.global_norm(jt))
    assert T.global_norm([torch.ones(4, dtype=torch.bfloat16)]).dtype == torch.float32


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_equals_reference(schedule):
    """Step 0, inside warmup, at its end, during decay and after
    ``total_steps``."""
    jcfg = J.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    tcfg = T.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0.0, 3.0, 10.0, 55.0, 100.0, 250.0):
        want = J.cosine_schedule(jnp.float32(step), jcfg)
        got = T.cosine_schedule(torch.tensor(step), tcfg)
        assert got.dtype == torch.float32
        _close(got, want)
    assert float(T.cosine_schedule(0, tcfg)) == 0.0


def _ramp(n, seed):
    """Distinct magnitudes (no ties for top-k), random signs and order."""
    rng = np.random.default_rng(seed)
    mags = (np.arange(1, n + 1, dtype=np.float32) / n) * 3.0
    return (rng.permutation(mags) * rng.choice([-1.0, 1.0], n)).astype(np.float32)


def test_int8_roundtrip_equals_reference():
    x = (np.random.default_rng(SEED).standard_normal((33, 17)) * 2).astype(np.float32)
    jq, js = JC.int8_compress(jnp.asarray(x))
    tq, ts = TC.int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js)
    _close(TC.int8_decompress(tq, ts), JC.int8_decompress(jq, js))


def test_round_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    jq, _ = JC.int8_compress(jnp.asarray(x))
    tq, _ = TC.int8_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist()[:5] == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_roundtrip_equals_reference(frac):
    x = _ramp(240, SEED).reshape(12, 20)
    jk, ji, js = JC.topk_compress(jnp.asarray(x), frac)
    tk, ti, ts = TC.topk_compress(torch.from_numpy(x), frac)
    assert ts == tuple(js)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(TC.topk_decompress(tk, ti, ts).numpy(),
                                  np.asarray(JC.topk_decompress(jk, ji, js)))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_ef_roundtrip_equals_reference(scheme):
    """Five error-feedback rounds, the residual carried in each package."""
    rng = np.random.default_rng(SEED + 2)
    jerr = jnp.zeros((8, 25), jnp.float32)
    terr = TC.ef_state_init([torch.zeros(8, 25)])[0]
    for i in range(5):
        g = _ramp(200, SEED + i).reshape(8, 25) * rng.uniform(0.5, 2.0)
        ja, jerr = JC.ef_roundtrip(jnp.asarray(g), jerr, scheme, frac=0.1)
        ta, terr = TC.ef_roundtrip(torch.from_numpy(g), terr, scheme, frac=0.1)
        _close(ta, ja)
        _close(terr, jerr)
    with pytest.raises(ValueError):
        TC.ef_roundtrip(torch.zeros(3), torch.zeros(3), "fp4")


_PSUM_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.compress import compressed_psum, ef_state_init

init, rank, scheme, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
data = np.load(out.replace(f"out{rank}", "in"))
grads = [torch.from_numpy(data[f"g{rank}_{i}"]) for i in range(2)]
err = [torch.from_numpy(data[f"e{rank}_{i}"]) for i in range(2)]
summed, resid = compressed_psum(grads, err, scheme=scheme, frac=0.1)
np.savez(out, **{f"s{i}": s.numpy() for i, s in enumerate(summed)},
         **{f"r{i}": r.numpy() for i, r in enumerate(resid)})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_psum_two_ranks_equals_reference(tmp_path, scheme):
    inputs = {}
    for rank in range(2):
        for i, n in enumerate((60, 36)):
            inputs[f"g{rank}_{i}"] = _ramp(n, SEED + 10 * rank + i)
            inputs[f"e{rank}_{i}"] = (_ramp(n, SEED + 5 + rank + i) * 0.01).astype(np.float32)
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_WORKER, init, str(rank), scheme,
                               str(tmp_path / f"out{rank}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    for i in range(2):
        approx = [JC.ef_roundtrip(jnp.asarray(inputs[f"g{r}_{i}"]),
                                  jnp.asarray(inputs[f"e{r}_{i}"]), scheme, 0.1)
                  for r in range(2)]
        want = np.asarray(approx[0][0]) + np.asarray(approx[1][0])
        for rank in range(2):
            got = np.load(tmp_path / f"out{rank}.npz")
            _close(got[f"s{i}"], want)
            _close(got[f"r{i}"], approx[rank][1])


@pytest.mark.parametrize("cls", [StepWatchdog, JWatchdog], ids=["port", "reference"])
def test_watchdog_fires_on_straggler(cls):
    w = cls(factor=1.0, floor_s=0.05)
    for _ in range(5):
        w.guard(lambda: time.sleep(0.01))
    assert np.isfinite(w.deadline()) and len(w.history) == 5
    fired = []
    assert w.guard(lambda: time.sleep(0.5) or 7, on_straggler=lambda dt, dl: fired.append(dt)) == 7
    assert fired and w.fired == 1


def test_watchdog_reraises_a_failed_step():
    """The port re-raises where the reference's ``guard`` would wait for
    ever (its runner thread dies before setting ``done``)."""
    w = StepWatchdog()

    def boom():
        raise ZeroDivisionError("step failed")

    with pytest.raises(ZeroDivisionError, match="step failed"):
        w.guard(boom)
    assert w.guard(lambda x: x + 1, 1) == 2
