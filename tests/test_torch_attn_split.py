"""Placed attention under the reference's ``attn_heads`` policies, on the
CPU, against the JAX package's one-device results.

The reference's ``hint(x, "heads")`` gives ``model`` the heads where it
divides them, else the sequence (``"auto"``); ``"seq"`` gives it the
sequence wherever that divides, ``"batch_only"`` neither, ``"tp_uneven"``
the heads in uneven blocks.  The port's placed layers carry the same
decision out (``models.attention.attention_split``).  On a (1, 2) and a
(1, 4) mesh of ``gloo`` ranks (``_dist_port.py attnsplit``), for
``reduced()`` qwen2 and for query heads the model axis cuts
(``_dist_cases.ATTN_LM``), under each policy:

* every rank takes the split the policy names, in every layer;
* ``lm_loss`` and every parameter's gradient in each attention mode
  (``dot``, a padded ``chunked`` sweep, ``causal_blocked`` with chunks
  across the ranks' rows), placed prefill's last-token logits and
  tokens, and one placed train step's parameters and metrics
  (``grad_norm`` shows a gradient summed twice at once) equal the
  reference's one-device results.

rtol = atol = 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _dist_cases as K
from _dist_port import finish, start
from _tp_ref import close
import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.model import forward as j_forward
from repro.models.model import init_model as j_init_model
from repro.models.model import lm_loss as j_lm_loss
from repro.optim.adamw import AdamWConfig as JAdamW, adamw_init as j_adamw_init

# the split each policy names, by (ranks of model, case): S = 16 divides 2 and 4
SPLITS = {
    (2, "reduced"): {"auto": "heads", "seq": "seq", "batch_only": "whole",
                     "tp_uneven": "heads"},
    (2, "cut3"): {"auto": "seq", "seq": "seq", "batch_only": "whole", "tp_uneven": "uneven"},
    (2, "gemma_cut3"): {"auto": "seq", "seq": "seq", "batch_only": "whole",
                        "tp_uneven": "uneven"},
    # 2 KV heads over 4 cut a KV head; 3 query heads are fewer than 4 blocks
    (4, "reduced"): {"auto": "q_heads", "seq": "seq", "batch_only": "whole",
                     "tp_uneven": "q_heads"},
    (4, "cut3"): {"auto": "seq", "seq": "seq", "batch_only": "whole", "tp_uneven": "seq"},
    (4, "cut6"): {"auto": "seq", "seq": "seq", "batch_only": "whole", "tp_uneven": "uneven"},
}
CASES = [(w, n, p) for w, names in K.ATTN_WORLDS.items() for n in names for p in K.POLICIES]
MODES = [m for m, _ in K.ATTN_MODES]


def _ids(case):
    w, n, p = case
    return f"1x{w}-{n}-{p}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks at once, while this process computes the
    reference's results for every case."""
    rng = np.random.default_rng(20240601)
    tokens = rng.integers(0, 256, (K.DP_BATCH, K.DP_SEQ)).astype(np.int32)
    trees = {}
    inp = {"tokens": tokens}
    for i, name in enumerate(K.ATTN_LM):
        tree = jax.tree.map(np.asarray,
                            j_init_model(jax.random.PRNGKey(i), K.attn_cfg(jconfigs, name))[0])
        trees[name] = tree
        inp.update({f"{name}/{p}": a for p, a in K.flat(tree).items()})
    started = {}
    for world in K.ATTN_WORLDS:
        io = str(tmp_path_factory.mktemp(f"attnsplit{world}"))
        np.savez(os.path.join(io, "attnsplit_inputs.npz"), **inp)
        started[world] = (io, start("attnsplit", world, io))
    try:
        ref = {name: _reference(name, trees[name], tokens) for name in K.ATTN_LM}
    finally:
        ranks = {w: finish(s) for w, (_, s) in started.items()}
    got = {w: dict(np.load(os.path.join(io, f"attnsplit{w}.npz")))
           for w, (io, _) in started.items()}
    return {"ref": ref, "got": got, "ranks": ranks}


def _reference(name, tree, tokens) -> dict:
    """The reference's loss and gradients in every mode, prefill logits and
    one train step on one device."""
    cfg = K.attn_cfg(jconfigs, name)
    batch = {"tokens": jnp.asarray(tokens)}
    out = {}
    for mode, chunk in K.ATTN_MODES:
        fn = jax.jit(jax.value_and_grad(
            lambda p, mode=mode, chunk=chunk: j_lm_loss(p, batch, cfg, mode=mode, chunk=chunk)[0]))
        loss, grads = fn(tree)
        out[mode] = (float(loss), K.flat(jax.tree.map(np.asarray, grads)))
    out["prefill"] = np.asarray(jax.jit(lambda p: j_forward(p, batch, cfg)[0])(tree))[:, -1]
    shape = jconfigs.ShapeConfig("attn", K.DP_SEQ, K.DP_BATCH, "train")
    step = jax.jit(jsteps.make_train_step(cfg, JAdamW(**K.DP_OPT),
                                          jsteps.attn_plan(cfg, shape, dp_total=1)))
    params, _, m = step(tree, j_adamw_init(tree), batch)
    out["step"] = (K.flat(jax.tree.map(np.asarray, params)), {k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_takes_the_policys_split(runs, case):
    """Every rank, in every layer, takes the split the policy names."""
    world, name, policy = case
    want = SPLITS[(world, name)][policy]
    for r in runs["ranks"][world]:
        assert r["splits"][f"{name}/{policy}"] == [want] * 2


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_gradients_equal_reference(runs, case, mode):
    """``lm_loss`` and each parameter's gradient, gathered, in ``mode``."""
    world, name, policy = case
    got = runs["got"][world]
    key = f"{name}/{policy}/{mode}"
    loss, grads = runs["ref"][name][mode]
    close(got[f"{key}/loss"], loss, f"{key} loss")
    for path, want in grads.items():
        close(got[f"{key}/grad/{path}"], want, f"{key} {path}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_placed_prefill_equals_reference(runs, case):
    """Placed prefill's last-token logits over every vocab id, and so its
    greedy tokens."""
    world, name, policy = case
    got = runs["got"][world][f"{name}/{policy}/prefill"]
    want = runs["ref"][name]["prefill"]
    close(got, want, f"{name} {policy} prefill")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_one_train_step_equals_reference(runs, case):
    """One placed step from the same weights: every parameter after it and
    the loss, ``grad_norm`` and learning rate."""
    world, name, policy = case
    got = runs["got"][world]
    key = f"{name}/{policy}/step"
    params, metrics = runs["ref"][name]["step"]
    for k in ("loss", "grad_norm", "lr"):
        close(got[f"{key}/metric/{k}"], metrics[k], f"{key} {k}")
    for path, want in params.items():
        close(got[f"{key}/param/{path}"], want, f"{key} {path}")


def test_without_an_activation_mesh_the_policy_is_auto():
    """``train_loop`` and placed serving activate no mesh: the split is
    ``"auto"``'s (heads where ``model`` divides them, else the sequence
    where it divides that, else neither: decode keeps the whole layer)."""
    from repro_torch.distributed.sharding import attention_axis

    for kind, shape in K.HINTS:
        for m in (1, 2, 3, 4):
            if kind == "heads":
                assert attention_axis(shape, m) == attention_axis(shape, m, "auto"), (shape, m)
    assert attention_axis((2, 4096, 14, 64), 4) == "seq"  # qwen2-0.5b on (1, 4)
    assert attention_axis((2, 4096, 14, 64), 2) == "heads"
    assert attention_axis((2, 1, 14, 64), 4) is None
    assert attention_axis((2, 4096, 14, 64), 4, "tp_uneven") == "heads"
    assert attention_axis((2, 4096, 16, 64), 4, "seq") == "seq"
    assert attention_axis((2, 4096, 16, 64), 4, "batch_only") is None
