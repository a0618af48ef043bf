"""The port's step functions (``repro_torch.launch.steps``) and
``models.to_reference`` vs the JAX package's, on the CPU.

``make_train_step`` with two microbatches against the reference's
(``_train_ref.run_steps``, rtol = atol = 2e-4): accumulated float32
gradients divided by ``n_micro``, and the reported loss the mean ``ce``
without the aux term, as the reference reports it
(``src/repro/launch/steps.py:123-159``).  Also ``attn_plan`` and
``input_specs`` for every architecture and shape, the prefill and decode
steps, and the ``to_reference`` round trip (bit for bit).
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.model import init_model as j_init_model
import repro_torch.configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import copy_tree, init_caches, init_model, to_reference
from repro_torch.models.convert import tree_values

from _train_ref import run_steps


@pytest.mark.parametrize("name,dispatch", [("qwen2-0.5b", None), ("qwen2-moe-a2.7b", "einsum")])
def test_microbatched_steps_equal_reference(name, dispatch):
    """Two microbatches of two rows; for the MoE the reported loss leaves
    out the aux term, as the reference's does."""
    run_steps(name, dispatch, n_micro=2, b=4)


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_attn_plan_and_input_specs_equal_reference(name):
    jcfg, tcfg = jconfigs.get_arch(name), tconfigs.get_arch(name)
    for shape_name, shape in jconfigs.SHAPES.items():
        for dp in (1, 16, 512):
            assert tsteps.attn_plan(tcfg, tconfigs.SHAPES[shape_name], dp) == jsteps.attn_plan(
                jcfg, shape, dp)
        want = jsteps.input_specs(jcfg, shape)
        got = tsteps.input_specs(tcfg, tconfigs.SHAPES[shape_name])
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)


def test_prefill_and_decode_steps():
    cfg = tconfigs.get_arch("gemma3-4b").reduced()
    model = init_model(cfg, 3, device="cpu")
    shape = tconfigs.ShapeConfig("p", 12, 2, "prefill")
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(0))
    logits = tsteps.make_prefill_step(cfg, shape, tsteps.attn_plan(cfg, shape))(
        model, {"tokens": tokens})
    assert logits.shape == (2, 1, cfg.vocab_padded)
    step = tsteps.make_decode_step(cfg)
    caches = init_caches(cfg, 2, 13, device="cpu")
    for t in range(12):
        out, caches = step(model, tokens[:, t : t + 1], caches, t)
    torch.testing.assert_close(out, logits, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "grok-1-314b", "hubert-xlarge"])
def test_to_reference_round_trip(name):
    cfg = tconfigs.get_arch(name).reduced()
    a, b = init_model(cfg, 1, device="cpu"), init_model(cfg, 2, device="cpu")
    tree = to_reference(a)
    jtree = j_init_model(jax.random.PRNGKey(0), jconfigs.get_arch(name).reduced())[0]
    assert jax.tree.structure(jax.tree.map(np.asarray, jtree)) == jax.tree.structure(tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = tree
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape and node.dtype == leaf.dtype
    copy_tree(b, tree)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    moments = [torch.full_like(p, float(i)) for i, p in enumerate(a.parameters())]
    values = tree_values(a, to_reference(a, moments))
    assert len(values) == len(moments)
    for m, v in zip(moments, values):
        assert torch.equal(m, v)
    with pytest.raises(ValueError, match="values for"):
        to_reference(a, moments[:-1])
    with pytest.raises(TypeError, match="bfloat16"):
        to_reference(a.to(torch.bfloat16))
