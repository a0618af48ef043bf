"""Data-parallel ``train_loop`` of the port on 4 and 2 ``gloo`` processes
on the CPU, against the JAX package's single-device train step on the
global batch.

The reference's microbatch split (``launch/steps.py:127-133``) and the
pipeline's shard slice (``data/pipeline.py:72-75``) both cut the global
batch into contiguous blocks, so rank k's batch is the reference's
microbatch k of ``n_micro = W``.  Dense (qwen2): the port at W ranks
equals the reference's step with ``n_micro = 1`` and with ``n_micro = W``
(rtol = atol = 2e-4; the bucketed ``all_reduce`` sums in another order:
parameters measured within 1.02e-4 of ``n_micro = 1`` and 4.8e-5 of
``n_micro = W``, the MoE's within 6.0e-5 of ``n_micro = W``).
MoE (qwen2-moe): the router's load-balance loss is not linear in the
batch, so the port equals ``n_micro = W`` and not ``n_micro = 1``; the
reported loss is the mean over the ranks of each rank's ``ce + 0.01 *
aux``.  The ranks hold ZeRO-3 blocks (``fsdp`` dimensions split over the
data ranks; ``test_torch_tp_train.py`` checks the blocks), so the
parameters compared are the gathered tree.  Also: every rank gathers the
same tree, a checkpoint written at W = 4 resumes at W = 2 and at W = 1 and
restores in the reference, rank 0's lineage equals a single-process
pipeline's, ``model_parallel = 2`` on 2 ranks, the CLI under ``torchrun``,
and the reference's ``shard_id=0`` fault at ``dp > 1`` (``ROADMAP.md`` §3
item 6), which the port does not copy.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _dist_cases as K
from _dist_port import DP_BATCH, DP_OPT, DP_SEQ, DP_STEPS, finish, start
import repro.configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import PipelineConfig as JPipelineConfig, TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models.model import lm_loss as j_lm_loss
from repro.optim.adamw import AdamWConfig as JAdamW, adamw_init as j_adamw_init
import repro_torch.configs as tconfigs
from repro_torch.core import DSLog
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import init_model, to_reference
from repro_torch.optim.adamw import AdamWConfig

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DENSE, MOE = "qwen2-0.5b", "qwen2-moe-a2.7b"


def _reference_steps(name, n_micro):
    """The reference's ``make_train_step`` on the global batches, from the
    port's initial weights (``train_loop``'s ``seed=0``): the parameters
    and metrics after each step."""
    jcfg = jconfigs.get_arch(name).reduced()
    tree = to_reference(init_model(tconfigs.get_arch(name).reduced(), 0, device="cpu"))
    shape = jconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train")
    plan = {**jsteps.attn_plan(jcfg, shape, dp_total=1), "n_micro": n_micro}
    step = jax.jit(jsteps.make_train_step(jcfg, JAdamW(**DP_OPT), plan))
    pipe = JPipeline(JPipelineConfig(jcfg.vocab, DP_SEQ, DP_BATCH, 0))
    params, opt = tree, j_adamw_init(tree)
    out = []
    for s in range(DP_STEPS):
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(pipe.global_batch_tokens(s))})
        out.append((K.flat(jax.tree.map(np.asarray, params)),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """W = 4, then W = 2 (it resumes W = 4's checkpoint) and W = 1 in this
    process; the reference's steps meanwhile."""
    io = str(tmp_path_factory.mktemp("dp"))
    started = start("dp4", 4, io)
    try:
        ref = {(name, n): _reference_steps(name, n)
               for name in (DENSE, MOE) for n in (1, 2, 4)}
    finally:
        dp4 = finish(started)
    for dst in ("ck4_to2", "ck4_to1"):
        shutil.copytree(os.path.join(io, "ck4"), os.path.join(io, dst))
    started = start("dp2", 2, io)
    try:
        _, w1 = ttrain.train_loop(
            tconfigs.get_arch(DENSE).reduced(), tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH,
                                                                     "train"),
            steps=6, ckpt_dir=os.path.join(io, "ck4_to1"), ckpt_every=3, log_every=100,
            opt_cfg=AdamWConfig(**DP_OPT), device="cpu")
    finally:
        dp2 = finish(started)
    return {"io": io, "ref": ref, 4: dp4, 2: dp2, 1: w1}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def _params(io, tag, step):
    return dict(np.load(os.path.join(io, f"{tag}.step{step}.npz")))


@pytest.mark.parametrize("world,n_micro", [(4, 1), (4, 4), (2, 1), (2, 2)])
def test_dense_data_parallel_equals_reference_single_device(runs, world, n_micro):
    """Parameters, ``grad_norm``, ``lr`` and loss after each step."""
    tag = f"dense{world}"
    got = runs[world][0]["dense"]
    for s, (params, m) in enumerate(runs["ref"][(DENSE, n_micro)]):
        mine = got["metrics"][s]
        for key in ("loss", "ce", "grad_norm", "lr"):
            _close(mine[key], m[key], f"step {s} {key}")
        assert mine["aux"] == 0.0
        port = _params(runs["io"], tag, s)
        assert set(port) == set(params)
        for path, want in params.items():
            _close(port[path], want, f"step {s} {path}")


@pytest.mark.parametrize("world", [4, 2])
def test_moe_data_parallel_equals_reference_microbatched(runs, world):
    """Equal to the reference with ``n_micro = W``; the loss reported is
    the mean over ranks of ``ce + 0.01 * aux`` (the reference's
    ``n_micro = W`` step reports the mean ``ce`` alone)."""
    got = runs[world][0]["moe"]
    for s, (params, m) in enumerate(runs["ref"][(MOE, world)]):
        mine = got["metrics"][s]
        for key in ("ce", "aux", "grad_norm", "lr"):
            _close(mine[key], m[key], f"step {s} {key}")
        assert mine["aux"] > 0.5  # so the two loss rules differ here
        np.testing.assert_allclose(mine["loss"], mine["ce"] + 0.01 * mine["aux"], rtol=1e-6)
        _close(mine["loss"], m["ce"] + 0.01 * m["aux"], f"step {s} loss")
        assert abs(m["loss"] - m["ce"]) < 1e-6
        port = _params(runs["io"], f"moe{world}", s)
        for path, want in params.items():
            _close(port[path], want, f"step {s} {path}")


@pytest.mark.parametrize("world", [4, 2])
def test_moe_data_parallel_differs_from_the_unsplit_step(runs, world):
    """The aux loss of the whole batch is not the mean of the ranks':
    against the reference's ``n_micro = 1`` step the router moves apart,
    beyond the tolerance the ``n_micro = W`` step meets."""
    params, _ = runs["ref"][(MOE, 1)][DP_STEPS - 1]
    port = _params(runs["io"], f"moe{world}", DP_STEPS - 1)
    router = "layers/moe/router/w"
    assert not np.allclose(port[router], params[router], **TOL)
    assert runs[world][0]["moe"]["metrics"][0]["aux"] != runs["ref"][(MOE, 1)][0][1]["aux"]


@pytest.mark.parametrize("world", [4, 2])
def test_replicas_stay_identical(runs, world):
    """Every rank gathers the same parameters and reports the same losses."""
    for run in ("dense", "moe"):
        ranks = [r[run] for r in runs[world]]
        assert len({r["digest"] for r in ranks}) == 1, run
        assert all(r["losses"] == ranks[0]["losses"] for r in ranks), run


def test_checkpoint_resumes_across_world_sizes(runs):
    """Written at W = 4 after step 2, resumed at W = 2 and at W = 1: the
    losses of the uninterrupted W = 4 run (float order apart)."""
    straight = runs[4][0]["dense"]["losses"]
    assert len(straight) == 6
    assert runs[4][0]["ck4"]["losses"] == straight[:3]
    for world, rest in ((2, runs[2][0]["resume"]["losses"]), (1, runs[1])):
        assert len(rest) == 3, world
        _close(rest, straight[3:], f"resumed at W = {world}")
    assert sorted(os.listdir(os.path.join(runs["io"], "ck4"))) == ["LATEST", "step_00000002"]


def test_data_parallel_checkpoint_restores_in_reference(runs):
    """The W = 4 checkpoint in the reference's manager: its ``lm_loss`` on
    step 3's global batch is the W = 4 run's loss there."""
    tree, extra = JManager(os.path.join(runs["io"], "ck4")).restore()
    assert extra == {"step": 2, "pipeline": {"step": 3}}
    jcfg = jconfigs.get_arch(DENSE).reduced()
    tokens = JPipeline(JPipelineConfig(jcfg.vocab, DP_SEQ, DP_BATCH, 0)).global_batch_tokens(3)
    want, _ = j_lm_loss(tree["params"], {"tokens": jnp.asarray(tokens)}, jcfg)
    _close(runs[4][0]["dense"]["losses"][3], float(want), "loss at step 3")


def _store_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f not in ("telemetry.json", "autotune.json"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def test_rank0_lineage_equals_a_single_process_pipeline(runs, tmp_path):
    """Only rank 0 logs, and its store is a single-process pipeline's over
    the same 4 shards, file for file: the shuffle of each global batch and
    every shard's slice."""
    cfg = tconfigs.get_arch(DENSE).reduced()
    store = DSLog(root=str(tmp_path / "single"), device="cpu")
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, DP_SEQ, DP_BATCH, 0), data_shards=4,
                         shard_id=0, dslog=store)
    for _ in range(6):
        pipe.next_batch()
    store.save()
    got = _store_files(os.path.join(runs["io"], "lineage4"))
    assert got and got == _store_files(str(tmp_path / "single"))
    logged = DSLog.load(os.path.join(runs["io"], "lineage4"), device="cpu")
    assert {f"shard_s5_k{k}" for k in range(4)} <= set(logged.arrays)


def test_the_port_trains_on_the_whole_global_batch():
    """§3 item 6.  The port's rank k takes block k, so the ranks' batches
    are the global batch, and the runs above equal the reference on one
    device.  The reference's ``train_loop`` at ``dp > 1`` builds
    ``TokenPipeline(data_shards=dp, shard_id=0)`` (``launch/train.py:63-64``)
    and passes its rows as the whole batch of the step (``:92``): it
    trains on 1/dp of each global batch, shard 0's rows only, against
    the pipeline's contract.  It is not run at ``dp > 1`` here: that
    needs the reference's sharded step on a forced device count, and
    what it trains on is decided by the two lines above."""
    cfg = tconfigs.get_arch(DENSE).reduced()
    for world in (2, 4):
        blocks = [TokenPipeline(PipelineConfig(cfg.vocab, DP_SEQ, DP_BATCH, 0), world, k)
                  .next_batch()["tokens"] for k in range(world)]
        glob = TokenPipeline(PipelineConfig(cfg.vocab, DP_SEQ, DP_BATCH, 0)).global_batch_tokens(0)
        np.testing.assert_array_equal(np.concatenate(blocks), glob)
        ref = JPipeline(JPipelineConfig(cfg.vocab, DP_SEQ, DP_BATCH, 0), data_shards=world,
                        shard_id=0).next_batch()["tokens"]
        assert ref.shape[0] == DP_BATCH // world
        np.testing.assert_array_equal(ref, glob[: DP_BATCH // world])


def test_model_parallel_still_raises_under_a_group(runs):
    """``model_parallel = 2`` under a group of 2 ranks, which raised before
    the port's tensor parallelism, now trains on a (1, 2) mesh: the
    reference's single-device step, step by step; every head splits on a
    head boundary, so no layer computes whole."""
    got = runs[2][0]["model_parallel"]
    for s, (params, m) in enumerate(runs["ref"][(DENSE, 1)]):
        for key in ("loss", "ce", "grad_norm", "lr"):
            _close(got["metrics"][s][key], m[key], f"step {s} {key}")
        port = _params(runs["io"], "mp2", s)
        assert set(port) == set(params)
        for path, want in params.items():
            _close(port[path], want, f"step {s} {path}")
    for r in runs[2]:
        assert r["model_parallel"]["digest"] == got["digest"]
        assert r["model_parallel"]["replicated"] == []


def test_train_cli_under_torchrun_on_cpu(tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train ...
    --device cpu``: main starts a ``gloo`` group from the launcher's
    environment; rank 0 prints the steps."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", "--arch", DENSE, "--smoke",
         "--device", "cpu", "--steps", "3", "--seq-len", "16", "--global-batch", "4"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("step     2 loss") == 1, r.stdout
