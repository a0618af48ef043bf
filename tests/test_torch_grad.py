"""The gradient of the port's ``lm_loss`` vs ``jax.grad`` of the JAX
package's, on the CPU.

Both packages hold the reference's weights (``models.from_reference``) and
take the same numpy-seeded batch.  The port's gradient (one tensor a
parameter, ``torch.autograd.grad``) goes back into the reference's tree
layout with ``models.to_reference`` and is held leaf by leaf against
``jax.jit(jax.grad(...))``'s: rtol = atol = 2e-4 (measured: at most
5.1e-7 in absolute value, 4.9e-6 of the largest entry of a leaf, at these
widths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.model import init_model as j_init_model, lm_loss as j_lm_loss
import repro_torch.configs as tconfigs
from repro_torch.models import from_reference, lm_loss, to_reference

SEED = 20240527
TOL = dict(rtol=2e-4, atol=2e-4)


def _batch_for(cfg, rng, b, s):
    if cfg.frontend == "frames":
        return {
            "frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        }
    if cfg.frontend == "patch":
        return {
            "tokens": rng.integers(0, cfg.vocab, (b, s - cfg.frontend_len)).astype(np.int32),
            "patch_embeds": rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
            .astype(np.float32),
        }
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _port_grads(model, batch, cfg):
    total, _ = lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    params = list(model.parameters())
    return torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_lm_loss_gradient_equals_reference(name):
    jcfg = jconfigs.get_arch(name).reduced()
    tcfg = tconfigs.get_arch(name).reduced()
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(1), jcfg)[0])
    batch = _batch_for(jcfg, np.random.default_rng(SEED), 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(jax.grad(lambda p: j_lm_loss(p, jb, jcfg)[0]))(tree)
    model = from_reference(tcfg, tree, device="cpu")
    got = to_reference(model, _port_grads(model, batch, tcfg))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat_got) == sorted(
        jax.tree_util.keystr(p) for p, _ in flat_want)
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert any(np.abs(np.asarray(leaf)).max() > 0 for _, leaf in flat_want)
