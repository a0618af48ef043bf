"""Tensor parallelism and ZeRO-3 beyond the (2, 2) mesh: the layers on 2
``gloo`` ranks, the (1, 4) and (4, 1) meshes, checkpoints across meshes
and the CLI under ``torchrun``, on the CPU, against the JAX package.

* Layers on a (1, 2) mesh (``tp2``): column- and row-parallel ``dense``
  with their gradients; the vocab-parallel lookup, head and cross-entropy
  of a tied and an untied model whose padded ids (vocab 250, padded to
  256) fall in model rank 1's half and whose labels fall in both, of one
  with 3 query heads, which 2 model ranks cut (its attention computes
  whole on both), and of an MoE under the gather/scatter dispatch;
  ``global_norm`` of a placed tree, equal to the reference's on the whole
  tree.
* qwen2 and qwen2-moe on a (1, 4) mesh (tensor parallelism alone: 2 KV
  heads over 4 ranks cut a head, so ``k``/``v`` compute whole and
  ``replicated_over_model`` names them) and a (4, 1) mesh (ZeRO-3 alone),
  against the reference's single-device steps (an MoE's ``n_micro = dp``),
  with the reference's blocks.
* A checkpoint written at (2, 2) resumes at (4, 1) and in one process with
  the straight run's losses and restores in the reference's manager; a
  reference checkpoint resumes at (2, 2) and continues the reference's
  steps.

rtol = atol = 2e-4 unless named.
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
from _dist_port import finish, spawn, start
from _tp_ref import (check_blocks, check_run, close, finish_reference, global_batch, is_moe,
                     reference_steps, start_reference)
import repro.configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models.layers import dense as j_dense
from repro.models.model import forward as j_forward
from repro.models.model import init_model as j_init_model
from repro.models.model import lm_loss as j_lm_loss
from repro.optim.adamw import global_norm as j_global_norm
import repro_torch.configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.optim.adamw import AdamWConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DENSE, MOE = "qwen2-0.5b", "qwen2-moe-a2.7b"
LM_VOCAB = K.TP2_VOCAB  # padded to 256: ids 250-255 lie in model rank 1's half
CUT_KV = ["layers/attn/k/b", "layers/attn/k/w", "layers/attn/v/b", "layers/attn/v/w"]


# --------------------------------------------------------------------------- #
# layers on a (1, 2) mesh
# --------------------------------------------------------------------------- #



@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    io = str(tmp_path_factory.mktemp("tp2"))
    rng = np.random.default_rng(20240527)
    inp = {"dense/w": rng.standard_normal((16, 12)).astype(np.float32),
           "dense/b": rng.standard_normal(12).astype(np.float32),
           "dense/x": rng.standard_normal((2, 3, 16)).astype(np.float32),
           "dense/r": rng.standard_normal((2, 3, 12)).astype(np.float32),
           "lm/vocab": np.asarray(LM_VOCAB)}
    tokens = rng.integers(0, LM_VOCAB, (2, 12)).astype(np.int32)
    tokens[0, :4] = [0, 127, 128, LM_VOCAB - 1]  # the edges of both halves
    inp["lm/tokens"] = tokens
    trees = {}
    for i, name in enumerate(K.TP2_LM):
        tree = jax.tree.map(np.asarray,
                            j_init_model(jax.random.PRNGKey(i), K.tp2_cfg(jconfigs, name))[0])
        trees[name] = tree
        inp.update({f"{name}/{p}": a for p, a in K.flat(tree).items()})
    norm_tree = jax.tree.map(np.asarray,
                             j_init_model(jax.random.PRNGKey(9),
                                          jconfigs.get_arch(DENSE).reduced())[0])
    inp.update({f"norm/{p}": a for p, a in K.flat(norm_tree).items()})
    np.savez(os.path.join(io, "tp2_inputs.npz"), **inp)
    ranks = spawn("tp2", 2, io)
    got = dict(np.load(os.path.join(io, "tp2.npz")))
    return {"inp": inp, "trees": trees, "norm_tree": norm_tree, "got": got, "ranks": ranks}


@pytest.mark.parametrize("kind", ["col", "row"])
def test_split_dense_and_its_gradients_equal_reference(layers, kind):
    """Column-parallel (this rank's output columns, the input entering the
    model region) and row-parallel (this rank's rows, the products summed
    over the ranks) ``dense``: the output, ``sum(y * r)`` and the
    gradients of the input, the weight and the bias."""
    inp, got = layers["inp"], layers["got"]
    p = {"w": jnp.asarray(inp["dense/w"]), "b": jnp.asarray(inp["dense/b"])}
    x, r = jnp.asarray(inp["dense/x"]), jnp.asarray(inp["dense/r"])

    def loss(p, x):
        return jnp.sum(j_dense(p, x) * r)

    want, (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1))(p, x)
    close(got[f"{kind}/y"], j_dense(p, x), "y")
    close(got[f"{kind}/loss"], want, "loss")
    close(got[f"{kind}/dx"], dx, "dx")
    close(got[f"{kind}/dw"], dp["w"], "dw")
    close(got[f"{kind}/db"], dp["b"], "db")
    # rank 0's block: the first half of the columns, or of the rows
    w = inp["dense/w"]
    want_block = w[:, :6] if kind == "col" else w[:8]
    np.testing.assert_array_equal(got[f"{kind}/w_block"], want_block)


@pytest.mark.parametrize("name", list(K.TP2_LM))
def test_vocab_parallel_lookup_head_and_cross_entropy(layers, name):
    """The vocab split over 2 model ranks (rows 0-127 and 128-255 of the
    table, or columns of the untied head): the gathered logits (padded ids
    at -1e30, masked by their global id in rank 1's half), the
    cross-entropy and every parameter's gradient equal the reference's.
    With 3 query heads the attention's weights are gathered over the model
    ranks (``replicated_over_model`` names them) and its gradients still
    land in each rank's blocks; the sorted MoE dispatch sums its experts'
    partial outputs after the scatter-add."""
    cfg = K.tp2_cfg(jconfigs, name)
    assert cfg.vocab_padded == 256
    want = sorted(f"layers/attn/{n}/{t}" for n in "qkvo" for t in "bw" if t == "w" or n != "o")
    assert list(layers["got"][f"{name}/replicated"]) == (want if name == "cut_heads" else [])
    got, tree = layers["got"], layers["trees"][name]
    batch = {"tokens": jnp.asarray(layers["inp"]["lm/tokens"])}
    logits, _ = jax.jit(lambda p: j_forward(p, batch, cfg))(tree)
    close(got[f"{name}/logits"], logits, "logits")
    assert np.all(got[f"{name}/logits"][..., LM_VOCAB:] == -1e30)
    assert [r["lo"][name] for r in layers["ranks"]] == [0, 128]
    labels = layers["inp"]["lm/tokens"][:, 1:]
    assert (labels < 128).any() and (labels >= 128).any()

    def loss(p):
        total, (ce, _) = j_lm_loss(p, batch, cfg)
        return total, ce

    (_, ce), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    close(got[f"{name}/ce"], ce, "ce")
    for path, want in K.flat(jax.tree.map(np.asarray, grads)).items():
        close(got[f"{name}/grad/{path}"], want, path)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_global_norm_of_a_placed_tree_equals_reference(layers, mesh):
    """Each entry of the whole tree counted once: the blocks' sums of
    squares added over the mesh dimensions that split each leaf only."""
    want = float(j_global_norm(layers["norm_tree"]))
    np.testing.assert_allclose(layers["got"][f"norm/{mesh}"], want, rtol=1e-6)


# --------------------------------------------------------------------------- #
# (1, 4), (4, 1) and checkpoints across meshes
# --------------------------------------------------------------------------- #
def _reference_state(name):
    """A reference checkpoint's state: the reference's own initial weights,
    moments from a seeded generator (``v`` positive) and step 2."""
    jcfg = jconfigs.get_arch(name).reduced()
    params = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(3), jcfg)[0])
    rng = np.random.default_rng(3)
    m = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32), params)
    v = jax.tree.map(lambda a: (1e-6 * rng.random(a.shape)).astype(np.float32), params)
    return params, {"m": m, "v": v, "step": np.asarray(2, np.int32)}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """``tpmesh`` on 4 ranks and the reference's blocks (a subprocess),
    while this process computes the reference's steps; then a resume of
    the (2, 2) checkpoint in this process."""
    io = str(tmp_path_factory.mktemp("tpmesh"))
    params, opt = _reference_state(DENSE)
    JManager(os.path.join(io, "refck")).save(
        2, {"params": params, "opt": opt}, extra={"step": 2, "pipeline": {"step": 3}})
    ref_proc = start_reference(io, "tp-blocks")
    try:
        started = start("tpmesh", K.WORLD, io)
        try:
            ref = {(DENSE, 1): reference_steps(DENSE, 1, steps=6),
                   (MOE, 1): reference_steps(MOE, 1), (MOE, 4): reference_steps(MOE, 4),
                   "refck": reference_steps(DENSE, 1, state=(params, opt), first=3)}
        finally:
            ranks = finish(started)
    finally:
        reference = finish_reference(ref_proc, io)
    dst = os.path.join(io, "ck22_to1")
    shutil.copytree(os.path.join(io, "ck22_to41"), dst)
    _, one = ttrain.train_loop(
        tconfigs.get_arch(DENSE).reduced(),
        tconfigs.ShapeConfig("dp", K.DP_SEQ, K.DP_BATCH, "train"), steps=6, ckpt_dir=dst,
        ckpt_every=100, log_every=100, opt_cfg=AdamWConfig(**K.DP_OPT), device="cpu")
    return {"io": io, "ref": ref, "ranks": ranks, "reference": reference, "one": one}


@pytest.mark.parametrize("mesh,name", [(m, n) for m in ("1x4", "4x1") for n in (DENSE, MOE)])
def test_pure_tensor_and_pure_zero3_meshes_equal_reference(meshes, mesh, name):
    """(1, 4): every product split over 4 model ranks; (4, 1): every
    ``fsdp`` dimension over 4 data ranks.  The reference's single-device
    steps (an MoE's with ``n_micro`` = the data ranks), and each rank's
    blocks of the parameters and moments are the reference's."""
    dp = int(mesh[0])
    ref = meshes["ref"][(name, dp if is_moe(name) else 1)][:K.DP_STEPS]
    got = meshes["ranks"][0][f"{mesh}|{name}"]
    check_run(meshes["io"], f"tp{mesh}_{name}", got, ref, is_moe(name))
    blocks = meshes["reference"]["blocks"][f"{mesh}|{name}"]
    for r in meshes["ranks"]:
        assert r[f"{mesh}|{name}"]["digest"] == got["digest"]
        check_blocks(r[f"{mesh}|{name}"], r[f"coord{mesh}"], blocks)


def test_replicated_over_model_names_the_cut_kv_heads(meshes):
    """4 model ranks cut qwen2's and qwen2-moe's 2 KV heads at
    ``reduced()`` (8 columns a rank, half a head): their ``k``/``v`` weights
    and biases compute whole on every model rank; the query heads (4 over
    4) still split.  ZeRO-3 alone gathers nothing over the model axis."""
    for r in meshes["ranks"]:
        for name in (DENSE, MOE):
            assert r[f"1x4|{name}"]["replicated"] == CUT_KV
            assert r[f"4x1|{name}"]["replicated"] == []


def test_checkpoint_from_2x2_resumes_at_4x1_and_one_process(meshes):
    """Written at (2, 2) after step 2, resumed at (4, 1) and in one process:
    the straight (2, 2) run's losses, within float order; the straight run
    is the reference's too."""
    straight = meshes["ranks"][0]["straight"]
    assert len(straight["losses"]) == 6
    check_run(meshes["io"], "straight22", straight, meshes["ref"][(DENSE, 1)][:K.DP_STEPS],
              False)
    close(straight["losses"], [m["loss"] for _, m in meshes["ref"][(DENSE, 1)]], "straight")
    for what, rest in (("(4, 1)", meshes["ranks"][0]["resume41"]["losses"]),
                       ("one process", meshes["one"])):
        assert len(rest) == 3, what
        close(rest, straight["losses"][3:], f"resumed at {what}")
    for r in meshes["ranks"]:
        assert r["resume41"]["losses"] == meshes["ranks"][0]["resume41"]["losses"]


def test_2x2_checkpoint_restores_in_reference(meshes):
    """The (2, 2) run's step-2 checkpoint in the reference's manager: its
    ``lm_loss`` on step 3's global batch is the straight run's loss there,
    and its moments are the reference's after 3 steps."""
    tree, extra = JManager(os.path.join(meshes["io"], "ck22")).restore(step=2)
    assert extra == {"step": 2, "pipeline": {"step": 3}}
    jcfg = jconfigs.get_arch(DENSE).reduced()
    batch = {k: jnp.asarray(v) for k, v in global_batch(jcfg, 3).items()}
    want, _ = j_lm_loss(tree["params"], batch, jcfg)
    close(meshes["ranks"][0]["straight"]["losses"][3], float(want), "loss at step 3")
    assert int(tree["opt"]["step"]) == 3
    params, _ = meshes["ref"][(DENSE, 1)][2]
    for path, want in params.items():
        node = tree["params"]
        for key in path.split("/"):
            node = node[key]
        close(node, want, path)


def test_reference_checkpoint_resumes_at_2x2(meshes):
    """A checkpoint the reference's manager wrote (its own weights and
    moments at step 2) resumes at (2, 2): steps 3-5 are the reference's
    single-device steps from the same state."""
    got = meshes["ranks"][0]["refresume"]
    assert len(got["losses"]) == 3
    for s, (_, m) in enumerate(meshes["ref"]["refck"]):
        for key in ("loss", "ce", "grad_norm", "lr"):
            close(got["metrics"][s][key], m[key], f"step {3 + s} {key}")


def test_train_cli_model_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 4 -m repro_torch.launch.train ...
    --model-parallel 2 --device cpu``: a (2, 2) mesh; rank 0 prints it and
    the steps."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "repro_torch.launch.train", "--arch", DENSE, "--smoke",
         "--model-parallel", "2", "--device", "cpu", "--steps", "3", "--seq-len", "16",
         "--global-batch", "4"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("step     2 loss") == 1, r.stdout
    assert "mesh (2, 2) (data, model); computed whole on every model rank: none" in r.stdout


def test_the_port_trains_a_vlm_whose_patches_the_reference_leaves_out():
    """``ROADMAP.md`` §3 item 7.  The reference's ``train_loop`` passes a
    decoder ``{"tokens": ...}`` alone (``src/repro/launch/train.py:87-96``),
    and its ``lm_loss`` on that batch raises ``KeyError('patch_embeds')``
    for a patch-frontend config (inside its watchdog, whose wait then never
    ends: item 5).  The port's passes patch embeddings from a generator
    seeded with the step, so internvl2 trains (``test_torch_tp_train.py``
    holds it to the reference's step on the same batches)."""
    jcfg = jconfigs.get_arch("internvl2-2b").reduced()
    params = j_init_model(jax.random.PRNGKey(0), jcfg)[0]
    with pytest.raises(KeyError, match="patch_embeds"):
        j_lm_loss(params, {"tokens": jnp.zeros((2, K.DP_SEQ), jnp.int32)}, jcfg)
    _, losses = ttrain.train_loop(
        tconfigs.get_arch("internvl2-2b").reduced(),
        tconfigs.ShapeConfig("vlm", K.DP_SEQ, 2, "train"), steps=1, log_every=100, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])
