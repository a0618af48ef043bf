"""The port's remat (``cfg.remat``, applied layer by layer by
``repro_torch.models.blocks.stack_apply``), on the CPU.

The reference's ``_remat_wrap`` (``src/repro/models/blocks.py:148-156``)
wraps its layer scan in ``jax.checkpoint``; the port wraps each layer in
``torch.utils.checkpoint.checkpoint``.  Remat must not change the
gradient: ``full`` and ``dots`` are held against ``nothing`` at rtol =
atol = 1e-6 (recomputation repeats the same float32 operations; measured
0).  What each policy recomputes is read from the aten operations the
backward pass dispatches.  The port's own weights (``init_model``) serve;
the gradient itself is held against the JAX package's in
``test_torch_grad.py``.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as tconfigs
from repro_torch.models import init_model, lm_loss
import repro_torch.models.blocks as t_blocks

SEED = 20240527
# dense, sliding-window, MoE (einsum and sorted dispatch), SSM, hybrid,
# encoder and VLM
REMAT_ARCHS = ["qwen2-0.5b", "gemma3-4b", "qwen2-moe-a2.7b", "grok-1-314b", "mamba2-780m",
               "hymba-1.5b", "hubert-xlarge", "internvl2-2b"]


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


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_remat_keeps_the_gradient(name, remat):
    cfg = tconfigs.get_arch(name).reduced()
    batch = _batch_for(cfg, np.random.default_rng(SEED + 1), 2, 16)
    model = init_model(cfg, 3, device="cpu")
    want = _port_grads(model, batch, dataclasses.replace(cfg, remat="nothing"))
    got = _port_grads(model, batch, dataclasses.replace(cfg, remat=remat))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


class _CountOps(TorchDispatchMode):
    """Counts the aten operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, batch, cfg):
    """The aten operations the backward pass of ``lm_loss`` runs."""
    total, _ = lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    with _CountOps() as count:
        total.backward()
    model.zero_grad()
    return count.ops


def test_remat_recomputes_per_policy(monkeypatch):
    """In the backward pass ``nothing`` recomputes no forward operation,
    ``dots`` recomputes the layers' elementwise work (``silu``) but not
    their weight products (the same ``mm`` count as ``nothing``), and
    ``full`` recomputes both; without autograd (serving) no layer is
    checkpointed."""
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    model = init_model(cfg, 3, device="cpu")
    batch = _batch_for(cfg, np.random.default_rng(SEED), 2, 16)
    ops = {r: _backward_ops(model, batch, dataclasses.replace(cfg, remat=r))
           for r in ("nothing", "dots", "full")}
    mm, silu = torch.ops.aten.mm.default, torch.ops.aten.silu.default
    assert ops["nothing"][silu] == 0
    assert ops["dots"][silu] == ops["full"][silu] == cfg.n_layers
    assert ops["nothing"][mm] == ops["dots"][mm] < ops["full"][mm]
    calls = []
    monkeypatch.setattr(t_blocks, "checkpoint", lambda *a, **k: calls.append(1))
    with torch.no_grad():
        lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                dataclasses.replace(cfg, remat="full"))
    assert calls == []
