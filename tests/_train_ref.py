"""Shared by ``test_torch_train.py`` and ``test_torch_steps.py``: both
packages' train steps from the same weights on the same batches, held
together step by step (rtol = atol = 2e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.model import init_model as j_init_model
from repro.optim.adamw import AdamWConfig as JAdamW, adamw_init as j_adamw_init
import repro_torch.configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import from_reference, to_reference
from repro_torch.optim.adamw import AdamWConfig, adamw_init

SEED = 20240527
TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def cfgs(name, dispatch=None):
    pair = []
    for pkg in (jconfigs, tconfigs):
        cfg = pkg.get_arch(name).reduced()
        if dispatch is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
        pair.append(cfg)
    return pair


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL, err_msg=what)


def close_trees(got, want):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        close(node, leaf, jax.tree_util.keystr(path))


def run_steps(name, dispatch, n_micro, b=2, s=16, n_steps=3):
    """``n_steps`` steps of both packages' train step, held together."""
    jcfg, tcfg = cfgs(name, dispatch)
    shape = jconfigs.ShapeConfig("t", s, b, "train")
    plan = {**jsteps.attn_plan(jcfg, shape, dp_total=1), "n_micro": n_micro}
    assert plan == {**tsteps.attn_plan(tcfg, shape, dp_total=1), "n_micro": n_micro}
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(4), jcfg)[0])
    j_step = jax.jit(jsteps.make_train_step(jcfg, JAdamW(**OPT), plan))
    t_step = tsteps.make_train_step(tcfg, AdamWConfig(**OPT), plan)
    jp, jopt = tree, j_adamw_init(tree)
    model = from_reference(tcfg, tree, device="cpu")
    topt = adamw_init(model)
    rng = np.random.default_rng(SEED)
    for _ in range(n_steps):
        tokens = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
        jp, jopt, jm = j_step(jp, jopt, {"tokens": jnp.asarray(tokens)})
        model, topt, tm = t_step(model, topt, {"tokens": torch.from_numpy(tokens)})
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            close(tm[key], jm[key], key)
        # the reported loss (launch/steps.py:123-159 of the reference): the
        # aux term is in it with one microbatch, not with several
        want = tm["ce"] + 0.01 * tm["aux"] if n_micro == 1 else tm["ce"]
        assert float(tm["loss"]) == float(want)
        if tcfg.moe is not None:
            assert float(tm["aux"]) > 0.5  # so the two rules differ here
        close_trees(to_reference(model), jp)
        assert int(topt["step"]) == int(jopt["step"])
    close_trees(to_reference(model, topt["m"]), jopt["m"])
    close_trees(to_reference(model, topt["v"]), jopt["v"])
