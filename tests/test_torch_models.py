"""The port's LM stack (``repro_torch.configs``, ``.models``) vs the JAX
package's, on the CPU.

The reference initialises each model from a JAX key; its value tree
crosses to the port as numpy (``convert.from_reference``/``copy_tree``), so
both packages compute with the same float32 weights on the same
numpy-seeded inputs.  Tolerance: rtol = atol = 2e-4 on every float output
held against the reference (logits, aux, loss, caches, layer outputs);
the measured differences at these widths are about 4e-6 (float32 sums
taken in another order).  The ``-1e30`` logits of padded vocab ids, and
bf16 ``rmsnorm`` outputs, are compared exactly.  Two checks of the port
against itself keep the reference's own tolerances for them: decode
against forward and the SSD recurrence against its chunked scan at 2e-3
(``tests/test_models.py``; measured 1.9e-6 and 3.0e-7 on the CPU).

* configs: every architecture's ``ArchConfig``, ``reduced()``,
  ``vocab_padded``, ``layer_kinds()``, ``params_billions()``, ``SHAPES``
  and ``skip_reason`` equal the reference's;
* every architecture at ``reduced()``: ``forward`` logits and aux, and
  ``lm_loss``;
* ``decode_step`` logits and caches for ``test_models.py``'s five decode
  architectures, step by step;
* attention (``chunked``, ``causal_blocked`` equal to ``dot``; the
  sliding window), the SSD scan and decode, both MoE dispatches and the
  tanh-gelu MLP, each against the reference's function;
* qwen2-0.5b at its published layer geometry, cut in depth and vocab.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as jconfigs
from repro.models.attention import attention_block as j_attention, attn_init
from repro.models.blocks import init_caches as j_init_caches
from repro.models.layers import mlp as j_mlp, mlp_init, split_params
from repro.models.model import decode_step as j_decode, forward as j_forward
from repro.models.model import init_model as j_init_model, lm_loss as j_lm_loss
from repro.models.model import prefill as j_prefill
import repro.models.layers as j_layers
from repro.models.moe import moe_apply as j_moe, moe_init
from repro.models.ssm import ssm_apply as j_ssm, ssm_decode as j_ssm_decode, ssm_init
from repro.models.ssm import ssm_state_shapes
import repro_torch.configs as tconfigs
from repro_torch.models import copy_tree, decode_step, forward, from_reference, init_caches
from repro_torch.models import init_model, lm_loss, prefill
import repro_torch.models.layers as t_layers
from repro_torch.models.attention import Attention, attention_block
from repro_torch.models.layers import MLP, Init, mlp
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.ssm import SSM, ssm_apply, ssm_decode

SEED = 20240527
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_ARCHS = ["qwen2-0.5b", "gemma3-4b", "mamba2-780m", "hymba-1.5b", "qwen2-moe-a2.7b"]
CPU = Init(None, "cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _values(p):
    return _np_tree(split_params(p)[0])


def _cfgs(name, **moe):
    """The reference's and the port's reduced config of ``name`` (with
    ``moe`` fields replaced, e.g. a drop-free capacity)."""
    pair = []
    for pkg in (jconfigs, tconfigs):
        cfg = pkg.get_arch(name).reduced()
        if moe and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        pair.append(cfg)
    return pair


@functools.lru_cache(maxsize=None)
def _reference_tree(name, **moe):
    jcfg, _ = _cfgs(name, **moe)
    return _np_tree(j_init_model(jax.random.PRNGKey(1), jcfg)[0])


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


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _x(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_config_equals_reference(name):
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        assert (a.hd, a.vocab_padded, a.attention_free) == (b.hd, b.vocab_padded, b.attention_free)
        assert a.layer_kinds() == b.layer_kinds()
        assert a.params_billions() == b.params_billions()
        assert a.active_params_billions() == b.active_params_billions()
    for shape in jconfigs.SHAPES:
        assert tconfigs.skip_reason(t, shape) == jconfigs.skip_reason(j, shape)
    assert tconfigs.arch_names() == jconfigs.arch_names()


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()
    }
    assert dataclasses.asdict(tconfigs.smoke_shape("decode")) == dataclasses.asdict(
        jconfigs.smoke_shape("decode")
    )
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-5")


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_forward_and_loss_equal_reference(name):
    jcfg, tcfg = _cfgs(name)
    tree = _reference_tree(name)
    model = from_reference(tcfg, tree, device="cpu")
    batch = _batch_for(jcfg, np.random.default_rng(SEED), 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    j_logits, j_aux = j_forward(tree, jb, jcfg)
    j_total, (j_loss, _) = j_lm_loss(tree, jb, jcfg)
    with torch.no_grad():
        t_logits, t_aux = forward(model, tb, tcfg)
        t_total, (t_loss, _) = lm_loss(model, tb, tcfg)
    assert t_logits.shape == (2, 16, tcfg.vocab_padded)
    pad = np.asarray(j_logits)[..., tcfg.vocab :]
    assert (t_logits.numpy()[..., tcfg.vocab :] == pad).all()  # the -1e30 mask
    _close(t_logits[..., : tcfg.vocab], np.asarray(j_logits)[..., : tcfg.vocab])
    _close(t_aux, j_aux)
    _close(t_loss, j_loss)
    _close(t_total, j_total)


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_step_equals_reference(name):
    """Logits and every cache after each of 16 steps; the MoE at a
    drop-free capacity, as ``test_decode_matches_forward``."""
    jcfg, tcfg = _cfgs(name, capacity_factor=8.0)
    tree = _reference_tree(name, capacity_factor=8.0)
    model = from_reference(tcfg, tree, device="cpu")
    b, s = 2, 16
    tokens = np.random.default_rng(SEED).integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    j_step = jax.jit(lambda p, t, c, n: j_decode(p, t, c, n, jcfg))
    j_caches = j_init_caches(jcfg, b, s + 1, jnp.float32)
    t_caches = init_caches(tcfg, b, s + 1, device="cpu")
    assert {k: tuple(v.shape) for k, v in t_caches.items()} == {
        k: tuple(v.shape) for k, v in j_caches.items()
    }
    for t in range(s):
        j_logits, j_caches = j_step(tree, jnp.asarray(tokens[:, t : t + 1]), j_caches,
                                    jnp.int32(t))
        t_logits, t_caches = decode_step(model, torch.from_numpy(tokens[:, t : t + 1]),
                                         t_caches, t, tcfg)
        _close(t_logits[..., : tcfg.vocab], np.asarray(j_logits)[..., : tcfg.vocab])
        for k in j_caches:
            _close(t_caches[k], j_caches[k])


def test_prefill_equals_reference():
    jcfg, tcfg = _cfgs("internvl2-2b")
    tree = _reference_tree("internvl2-2b")
    model = from_reference(tcfg, tree, device="cpu")
    batch = _batch_for(jcfg, np.random.default_rng(SEED), 2, 12)
    want = j_prefill(tree, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, 16)
    got = prefill(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, 16)
    assert got.shape == (2, 1, tcfg.vocab_padded) and not got.requires_grad
    _close(got, want)


@pytest.mark.parametrize("case", ["dense_bias", "rmsnorm", "rmsnorm_bf16", "layernorm",
                                  "rope"])
def test_layers_equal_reference(case):
    """The basic layers on the same weights and inputs; ``rmsnorm`` computes
    in float32 and casts back to its input's type (bf16 here: both round
    to nearest even, so the bf16 outputs are equal)."""
    rng = np.random.default_rng(SEED)
    x, jx, tx = _x(rng, 2, 5, 3, 16)
    if case == "dense_bias":
        p = _values(j_layers.dense_init(jax.random.PRNGKey(0), 16, 24, (None, None), True))
        p["b"] = rng.standard_normal(24).astype(np.float32)
        tp = copy_tree(t_layers.Dense(CPU, 16, 24, bias=True), p)
        _close(t_layers.dense(tp, tx), j_layers.dense(p, jx))
    elif case.startswith("rmsnorm"):
        p = {"g": rng.standard_normal(16).astype(np.float32)}
        tp = copy_tree(t_layers.RMSNorm(CPU, 16), p)
        if case == "rmsnorm_bf16":
            got = t_layers.rmsnorm(tp, tx.to(torch.bfloat16), 1e-6)
            want = j_layers.rmsnorm(p, jx.astype(jnp.bfloat16), 1e-6)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.detach().float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
        else:
            _close(t_layers.rmsnorm(tp, tx, 1e-5), j_layers.rmsnorm(p, jx, 1e-5))
    elif case == "layernorm":
        p = {"g": rng.standard_normal(16).astype(np.float32),
             "b": rng.standard_normal(16).astype(np.float32)}
        tp = copy_tree(t_layers.LayerNorm(CPU, 16), p)
        _close(t_layers.layernorm(tp, tx), j_layers.layernorm(p, jx))
    else:
        pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
        _close(t_layers.rope_freqs(16, 1e6), j_layers.rope_freqs(16, 1e6))
        _close(t_layers.apply_rope(tx, torch.from_numpy(pos), 1e6),
               j_layers.apply_rope(jx, jnp.asarray(pos), 1e6))


def test_decode_matches_forward_in_the_port():
    """The port's own equivalence, as the reference's
    ``test_decode_matches_forward`` (its tolerance, 2e-3)."""
    _, tcfg = _cfgs("hymba-1.5b")
    model = init_model(tcfg, 3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    )
    with torch.no_grad():
        full, _ = forward(model, {"tokens": tokens}, tcfg, mode="dot")
    caches = init_caches(tcfg, 2, 17, device="cpu")
    steps = [decode_step(model, tokens[:, t : t + 1], caches, t, tcfg)[0][:, 0]
             for t in range(16)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_qwen2_published_geometry():
    """qwen2-0.5b at its published layer widths: d_model 896, 14 query and
    2 KV heads of 64, d_ff 4,864, QKV bias, tied embeddings, RoPE 1e6.
    Cuts: 2 layers (of 24) and a vocab of 1,000 (of 151,936), which pads
    to 1,024, so the padded-vocab mask still runs."""
    cfgs = []
    for pkg in (jconfigs, tconfigs):
        cfgs.append(dataclasses.replace(pkg.get_arch("qwen2-0.5b"), n_layers=2, vocab=1000))
    jcfg, tcfg = cfgs
    assert (tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, tcfg.d_ff) == (
        896, 14, 2, 64, 4864)
    assert tcfg.qkv_bias and tcfg.tie_embeddings and tcfg.vocab_padded == 1024
    tree = _np_tree(j_init_model(jax.random.PRNGKey(4), jcfg)[0])
    model = from_reference(tcfg, tree, device="cpu")
    tokens = np.random.default_rng(SEED).integers(0, 1000, (2, 12)).astype(np.int32)
    j_logits, _ = j_forward(tree, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.no_grad():
        t_logits, _ = forward(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert (t_logits.numpy()[..., 1000:] == -1e30).all()
    _close(t_logits[..., :1000], np.asarray(j_logits)[..., :1000])
    j_caches = j_init_caches(jcfg, 2, 4, jnp.float32)
    t_caches = init_caches(tcfg, 2, 4, device="cpu")
    for t in range(3):
        j_step, j_caches = j_decode(tree, jnp.asarray(tokens[:, t : t + 1]), j_caches,
                                    jnp.int32(t), jcfg)
        t_step, t_caches = decode_step(model, torch.from_numpy(tokens[:, t : t + 1]),
                                       t_caches, t, tcfg)
        _close(t_step[..., :1000], np.asarray(j_step)[..., :1000])


def test_from_reference_rejects_a_mismatched_tree():
    _, tcfg = _cfgs("qwen2-0.5b")
    tree = _reference_tree("qwen2-0.5b")
    with pytest.raises(KeyError, match="no port parameter"):
        from_reference(tcfg, {**tree, "extra": {"w": np.zeros(3)}}, device="cpu")
    short = {**tree, "final_norm": {"g": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="reference shape"):
        from_reference(tcfg, short, device="cpu")


# --------------------------------------------------------------------------- #
# modules, each against the reference's function
# --------------------------------------------------------------------------- #
def _attention(name="qwen2-0.5b", **replace):
    jcfg, tcfg = (dataclasses.replace(c, **replace) for c in _cfgs(name))
    p = _values(attn_init(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, p, copy_tree(Attention(CPU, tcfg), p)


@pytest.mark.parametrize("mode,s,window", [
    ("chunked", 32, None), ("chunked", 32, 8), ("causal_blocked", 32, None),
    ("causal_blocked", 32, 8), ("chunked", 12, 4),
])
def test_attention_modes_equal_dot_and_reference(mode, s, window):
    jcfg, tcfg, p, tp = _attention()
    _, jx, tx = _x(np.random.default_rng(SEED), 2, s, jcfg.d_model)
    jw = None if window is None else jnp.int32(window)
    want = j_attention(p, jx, jcfg, window=jw, mode=mode, chunk=8)
    with torch.no_grad():
        got = attention_block(tp, tx, tcfg, window=window, mode=mode, chunk=8)
        dot = attention_block(tp, tx, tcfg, window=window, mode="dot")
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), dot.numpy(), rtol=1e-4, atol=1e-5)


def test_chunked_padding_follows_the_reference():
    """A sequence that is not a multiple of ``chunk`` pads its keys at
    position -1e9; at a global window (the ``1 << 30`` sentinel) neither
    the causal nor the window mask removes them, so in the reference (and
    the port, which matches it) zero-valued pad keys take softmax weight
    and ``chunked`` differs from ``dot`` (``ROADMAP.md`` §3)."""
    jcfg, tcfg, p, tp = _attention()
    _, jx, tx = _x(np.random.default_rng(SEED), 2, 12, jcfg.d_model)
    want = j_attention(p, jx, jcfg, mode="chunked", chunk=8)
    with torch.no_grad():
        got = attention_block(tp, tx, tcfg, mode="chunked", chunk=8)
        dot = attention_block(tp, tx, tcfg, mode="dot")
    _close(got, want)
    assert np.abs(got.numpy() - dot.numpy()).max() > 0.1


def test_sliding_window_masks_past():
    jcfg, tcfg, p, tp = _attention("gemma3-4b", window=4)
    x, jx, tx = _x(np.random.default_rng(SEED), 1, 16, jcfg.d_model)
    x2 = x.copy()
    x2[:, 0] += 10.0
    with torch.no_grad():
        y = attention_block(tp, tx, tcfg, window=4, mode="dot")
        y2 = attention_block(tp, torch.from_numpy(x2), tcfg, window=4, mode="dot")
    # a token more than the window back changes nothing
    np.testing.assert_allclose(y[:, 8:].numpy(), y2[:, 8:].numpy(), rtol=1e-4, atol=1e-5)
    assert np.abs(y[:, :4].numpy() - y2[:, :4].numpy()).max() > 1e-3
    _close(y, j_attention(p, jx, jcfg, window=jnp.int32(4), mode="dot"))


def _ssm():
    jcfg, tcfg = _cfgs("mamba2-780m")
    p = _values(ssm_init(jax.random.PRNGKey(7), jcfg))
    return jcfg, tcfg, p, copy_tree(SSM(CPU, tcfg), p)


def test_ssd_scan_equals_reference_and_decode():
    jcfg, tcfg, p, tp = _ssm()
    _, jx, tx = _x(np.random.default_rng(SEED), 2, 16, jcfg.d_model, scale=0.5)
    with torch.no_grad():
        y = ssm_apply(tp, tx, tcfg)  # chunk 8: two chunks
    _close(y, j_ssm(p, jx, jcfg))
    conv_shape, ssm_shape = ssm_state_shapes(jcfg, 2)
    jconv, jstate = jnp.zeros(conv_shape), jnp.zeros(ssm_shape)
    tconv, tstate = torch.zeros(conv_shape), torch.zeros(ssm_shape)
    steps = []
    with torch.no_grad():
        for t in range(16):
            jy, jconv, jstate = j_ssm_decode(p, jx[:, t : t + 1], jcfg, jconv, jstate)
            ty, tconv, tstate = ssm_decode(tp, tx[:, t : t + 1], tcfg, tconv, tstate)
            _close(ty, jy)
            steps.append(ty[:, 0])
    _close(tconv, jconv)
    _close(tstate, jstate)
    # the recurrence equals the chunked scan (the reference's tolerance)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), y.numpy(), rtol=2e-3, atol=2e-3)


def test_ssd_scan_requires_whole_chunks():
    _, tcfg, _, tp = _ssm()
    with pytest.raises(ValueError, match="divisible by SSD chunk"):
        ssm_apply(tp, torch.zeros(1, 12, tcfg.d_model), tcfg)


@pytest.mark.parametrize("dispatch,capacity", [("einsum", 8.0), ("sorted", 8.0),
                                               ("einsum", 1.25), ("sorted", 1.25)])
def test_moe_dispatch_equals_reference(dispatch, capacity):
    """Both dispatches, drop-free (capacity 8) and at the production
    capacity factor, where tokens over capacity are dropped."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=capacity, dispatch=dispatch)
    p = _values(moe_init(jax.random.PRNGKey(0), jcfg))
    tp = copy_tree(MoE(CPU, tcfg), p)
    _, jx, tx = _x(np.random.default_rng(SEED), 2, 16, jcfg.d_model)
    jy, jaux = j_moe(p, jx, jcfg)
    with torch.no_grad():
        ty, taux = moe_apply(tp, tx, tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    assert float(taux) >= 1.0 - 1e-3


def test_gelu_is_the_tanh_approximation():
    """hubert's MLP: ``jax.nn.gelu`` defaults to the tanh approximation;
    the port must not use torch's exact gelu."""
    jcfg, tcfg = _cfgs("hubert-xlarge")
    assert tcfg.mlp_act == "gelu"
    p = _values(mlp_init(jax.random.PRNGKey(5), jcfg.d_model, jcfg.d_ff, "gelu"))
    tp = copy_tree(MLP(CPU, tcfg.d_model, tcfg.d_ff, "gelu"), p)
    _, jx, tx = _x(np.random.default_rng(SEED), 2, 8, jcfg.d_model, scale=3.0)
    with torch.no_grad():
        y = mlp(tp, tx, "gelu")
        exact = F.gelu(tx @ tp.up.w) @ tp.down.w
    _close(y, j_mlp(p, jx, "gelu"))
    assert np.abs(y.numpy() - exact.numpy()).max() > 1e-4


def test_init_model_draws_from_a_generator():
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    a, b, c = (init_model(tcfg, s, device="cpu") for s in (0, 0, 1))
    tree = _reference_tree("qwen2-moe-a2.7b")
    names = [n for n, _ in a.named_parameters()]
    assert len(names) == sum(1 for _ in jax.tree.leaves(tree)) + (tcfg.n_layers - 1) * len(
        jax.tree.leaves(tree["layers"]))
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.embed.table, c.embed.table)
    assert float(a.layers[0].norm1.g.detach().sum()) == tcfg.d_model
