"""The port's trainer (``repro_torch.launch.train``) vs the JAX package's
checkpoints and loss, on the CPU.

``train_loop``: a run resumed from its checkpoint gives the straight
run's losses exactly (same device, restored bits), and the checkpoint
restores in the reference's ``CheckpointManager``, whose ``lm_loss`` on the
restored parameters equals the port's resumed loss at the next step
(rtol = atol = 2e-4; measured 0 to 1e-6).  Also: lineage logging, an
encoder's frames, the device and ``model_parallel`` checks, the CLI and
``examples/train_lm_torch.py`` with ``--device cpu``, and import hygiene.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import PipelineConfig as JPipelineConfig, TokenPipeline as JPipeline
from repro.models.model import init_model as j_init_model, lm_loss as j_lm_loss
import repro_torch.configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.optim.adamw import AdamWConfig

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.join(os.path.dirname(__file__), "..")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _loop(tmp_path, name, steps, sub, **kw):
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced() if name is None else name
    return ttrain.train_loop(cfg, tconfigs.ShapeConfig("t", 16, 2, "train"), steps=steps,
                             ckpt_dir=str(tmp_path / sub), ckpt_every=3, log_every=100,
                             opt_cfg=AdamWConfig(**OPT), device="cpu", **kw)


def test_train_loop_resume_equals_straight_run(tmp_path, capsys):
    _, straight = _loop(tmp_path, None, 6, "straight")
    _, first = _loop(tmp_path, None, 3, "resumed")
    model, rest = _loop(tmp_path, None, 6, "resumed")
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(straight) == 6 and len(first) == 3 and len(rest) == 3
    assert first + rest == straight
    assert np.isfinite(straight).all()
    assert sorted(os.listdir(tmp_path / "straight")) == ["LATEST", "step_00000002",
                                                         "step_00000005"]


def test_train_loop_checkpoint_restores_in_reference(tmp_path):
    """The port's checkpoint after step 2, restored by the reference: its
    ``lm_loss`` on step 3's batch equals the port's resumed loss there."""
    _loop(tmp_path, None, 3, "ck")
    tree, extra = JManager(str(tmp_path / "ck")).restore()
    assert extra == {"step": 2, "pipeline": {"step": 3}}
    assert int(tree["opt"]["step"]) == 3
    jcfg = jconfigs.get_arch("qwen2-0.5b").reduced()
    ref_shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                              j_init_model(jax.random.PRNGKey(0), jcfg)[0])
    assert jax.tree.map(lambda x: (x.shape, str(x.dtype)), tree["params"]) == ref_shapes
    assert jax.tree.map(lambda x: (x.shape, str(x.dtype)), tree["opt"]["m"]) == ref_shapes
    pipe = JPipeline(JPipelineConfig(jcfg.vocab, 16, 2, 0))
    pipe.load_state_dict(extra["pipeline"])
    batch = {"tokens": jnp.asarray(pipe.next_batch()["tokens"])}
    want, _ = j_lm_loss(tree["params"], batch, jcfg)
    _, resumed = _loop(tmp_path, None, 4, "ck")
    np.testing.assert_allclose(resumed[0], float(want), **TOL)


def test_train_loop_logs_lineage_and_trains_an_encoder(tmp_path):
    from repro_torch.core import DSLog

    cfg = tconfigs.get_arch("hubert-xlarge").reduced()
    _, losses = _loop(tmp_path, cfg, 2, "enc", lineage_dir=str(tmp_path / "lineage"))
    assert len(losses) == 2 and np.isfinite(losses).all()
    store = DSLog.load(str(tmp_path / "lineage"), device="cpu")
    assert {"corpus", "batch_s0", "shard_s1_k0"} <= set(store.arrays)


def test_train_loop_checks_model_parallel(tmp_path):
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    shape = tconfigs.ShapeConfig("t", 16, 2, "train")
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.train_loop(cfg, shape, steps=1, model_parallel=2, device="cpu")


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train_loop(cfg, tconfigs.ShapeConfig("t", 16, 2, "train"), steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_train_cli_runs_on_cpu(capsys):
    ttrain.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "2", "--seq-len", "16",
                 "--global-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out


def test_example_runs_on_cpu(tmp_path):
    r = _run(["examples/train_lm_torch.py", "--device", "cpu", "--steps", "2", "--seq-len",
              "16", "--global-batch", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "params: 99M" in r.stdout and "step     1 loss" in r.stdout
    assert "loss: first-" in r.stdout


def test_training_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.optim, repro_torch.checkpoint, repro_torch.launch.steps\n"
        "import repro_torch.launch.train, repro_torch.distributed.elastic\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
