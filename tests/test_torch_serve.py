"""The port's serving path (``repro_torch.launch.serve``) vs the JAX
package's, on the CPU.

Both packages hold the same weights (the reference's tree, carried across
by ``convert.from_reference``) and decode the same numpy-seeded prompts.
Greedy tokens must be equal (argmax, first index on ties, as
``jnp.argmax``); sampled tokens come from different RNGs and are not
compared.  Also: the example runs as a subprocess, the new subpackages
import neither ``jax`` nor ``repro``, and every new entry point raises
on ``device="cuda"`` without CUDA.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.serve import generate as j_generate
from repro.models.model import init_model as j_init_model
import repro_torch.configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import from_reference, init_caches, init_model

SEED = 20240527
ROOT = os.path.join(os.path.dirname(__file__), "..")
# dense, sliding-window, MoE (one-hot and sorted dispatch), SSM and hybrid
GREEDY_ARCHS = ["qwen2-0.5b", "gemma3-4b", "qwen2-moe-a2.7b", "grok-1-314b",
                "mamba2-780m", "hymba-1.5b", "internvl2-2b"]


@pytest.mark.parametrize("name", GREEDY_ARCHS)
def test_greedy_generate_equals_reference(name):
    jcfg = jconfigs.get_arch(name).reduced()
    tcfg = tconfigs.get_arch(name).reduced()
    if name == "grok-1-314b":  # the sorted dispatch on the decode path
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, dispatch="sorted"))
                      for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(2), jcfg)[0])
    model = from_reference(tcfg, tree, device="cpu")
    prompts = np.random.default_rng(SEED).integers(0, jcfg.vocab, (3, 8)).astype(np.int32)
    want = np.asarray(j_generate(jcfg, tree, jnp.asarray(prompts), 10))
    got = serve.generate(tcfg, model, prompts, 10, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, :8], prompts)


def test_sampling_uses_a_seeded_generator():
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    model = init_model(cfg, 1, device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    a, b, c = (serve.generate(cfg, model, prompts, 6, greedy=False, seed=s, device="cpu")
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < cfg.vocab  # padded vocab ids are never drawn


def test_generate_reports_loop_timings():
    cfg = tconfigs.get_arch("gemma3-4b").reduced()
    model = init_model(cfg, 1, device="cpu")
    prompts = np.ones((2, 5), np.int32)
    laps = {}
    out = serve.generate(cfg, model, prompts, 3, device="cpu", timings=laps)
    assert sorted(laps) == ["decode_s", "prefill_s"] and min(laps.values()) > 0
    assert torch.equal(out, serve.generate(cfg, model, prompts, 3, device="cpu"))


def test_generate_checks_the_models_device():
    cfg = tconfigs.get_arch("mamba2-780m").reduced()
    model = init_model(cfg, 0, device="cpu").to("meta")
    with pytest.raises(ValueError, match="lies on meta"):
        serve.generate(cfg, model, np.zeros((1, 2), np.int32), 1, device="cpu")


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0), cfg)[0])
    for call in (
        lambda: init_model(cfg),
        lambda: init_caches(cfg, 1, 4),
        lambda: from_reference(cfg, tree),
        lambda: serve.generate(cfg, init_model(cfg, device="cpu"), np.zeros((1, 2), np.int32)),
        lambda: serve.main(["--arch", "qwen2-0.5b", "--smoke"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)


def test_example_runs_on_cpu():
    r = _run(["examples/serve_decode_torch.py", "--device", "cpu", "--arch", "hymba-1.5b",
              "--batch", "2", "--new-tokens", "4"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[hymba-1.5b-smoke] generated 2x4 tokens on cpu" in r.stdout


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "gemma3-4b", "--smoke", "--batch", "2", "--prompt-len", "3",
                "--new-tokens", "2", "--device", "cpu"])
    assert "generated (2, 5) on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_new_subpackages_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.launch.serve\n"
        "import repro_torch.data.pipeline, repro_torch.distributed\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
