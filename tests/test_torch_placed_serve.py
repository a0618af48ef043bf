"""Placed serving and the pod axis: the port's ``make_prefill_step`` and
``make_decode_step(mesh=)`` on 4 ``gloo`` processes on the CPU, and
``make_train_step`` on a ``("pod", "data", "model")`` mesh, against the
JAX package's single-device ``prefill``/``decode_step`` and jitted train
step on the same weights (``init_model(seed 0)`` carried across as the
reference's tree, ``_tp_ref.initial_tree``).

Every decoder architecture at ``reduced()`` serves 4 prompts on a (2, 2)
mesh (KV heads over the model ranks: each rank computes its heads), a
(1, 4) mesh (2 KV heads do not divide 4: the caches split the sequence
over the model ranks, and the softmax partials are merged over them) and
a (4, 1) mesh (the batch alone), and one prompt on (1, 4), where the
sequence lies over ``("data", "model")``.  SSM states are gathered over
the model ranks for a step and each rank keeps its block.  Each rank
holds the caches ``cache_sharding`` gives its mesh coordinate.  Logits
within rtol = atol = 2e-4, greedy tokens equal.

The pod axis: a (2, 1, 2) mesh trains qwen2-0.5b and qwen2-moe-a2.7b at
``reduced()`` for 3 steps, each pod a data block; the numbers are the
reference's one-device step over the global batch (an MoE's with
``n_micro = dp``, as on a ``("data", "model")`` mesh), within 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _dist_cases as K
from _dist_port import finish, start
from _tp_ref import (check_metrics, close, global_batch, initial_tree, is_moe, reference_steps,
                     saved)
import repro.configs as jconfigs
from repro.models.blocks import init_caches as j_init_caches
from repro.models.model import decode_step as j_decode, prefill as j_prefill
import repro_torch.configs as tconfigs

SEED = 20240601


def _inputs(io) -> dict:
    rng = np.random.default_rng(SEED)
    inp = {}
    for arch in K.SERVE_ARCHS:
        cfg = tconfigs.get_arch(arch).reduced()
        inp[f"{arch}/tokens"] = rng.integers(0, cfg.vocab, (4, K.SERVE_PROMPT)).astype(np.int32)
        if cfg.frontend == "patch":
            inp[f"{arch}/patches"] = rng.standard_normal(
                (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    np.savez(os.path.join(io, "serve_inputs.npz"), **inp)
    return inp


def _reference_serve(arch, inp, b) -> dict:
    """The reference on one device: prefill logits, and the decode logits
    and greedy tokens of the port's loop (the prompt token by token, then
    ``SERVE_NEW`` tokens)."""
    cfg = jconfigs.get_arch(arch).reduced()
    tree = jax.tree.map(jnp.asarray, initial_tree(arch))
    tokens = inp[f"{arch}/tokens"][:b]
    batch = {"tokens": jnp.asarray(tokens)}
    if cfg.frontend == "patch":
        batch = {"tokens": jnp.asarray(tokens[:, cfg.frontend_len:]),
                 "patch_embeds": jnp.asarray(inp[f"{arch}/patches"][:b])}
    pre = np.asarray(j_prefill(tree, batch, cfg, K.SERVE_PROMPT))[:, 0]
    step = jax.jit(lambda p, t, c, n: j_decode(p, t, c, n, cfg))
    caches = j_init_caches(cfg, b, K.SERVE_MAX_LEN, jnp.float32)
    tok, logits, new = jnp.asarray(tokens[:, :1]), [], []
    for t in range(K.SERVE_PROMPT + K.SERVE_NEW - 1):
        lg, caches = step(tree, tok, caches, jnp.int32(t))
        logits.append(np.asarray(lg)[:, 0])
        if t + 1 < K.SERVE_PROMPT:
            tok = jnp.asarray(tokens[:, t + 1:t + 2])
        else:
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
            new.append(np.asarray(tok))
    return {"prefill": pre, "logits": np.stack(logits, 1), "tokens": np.concatenate(new, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks serve (``serve``), then train on the pod mesh (``pod``),
    while this process computes the reference's answers."""
    io = str(tmp_path_factory.mktemp("placed"))
    inp = _inputs(io)
    batches = {}
    for arch in K.POD_ARCHS:
        cfg = jconfigs.get_arch(arch).reduced()
        for s in range(K.DP_STEPS):
            batches[f"{arch}/{s}"] = global_batch(cfg, s)["tokens"]
    np.savez(os.path.join(io, "pod_batches.npz"), **batches)
    started = start("serve", K.WORLD, io)
    try:
        ref = {(arch, b): _reference_serve(arch, inp, b)
               for arch in K.SERVE_ARCHS for b in sorted({b for _, b in K.SERVE_CASES})}
    finally:
        serve = finish(started)
    started = start("pod", K.WORLD, io)
    try:
        pod_ref = {arch: reference_steps(arch, 2 if is_moe(arch) else 1) for arch in K.POD_ARCHS}
    finally:
        pod = finish(started)
    return {"io": io, "ref": ref, "serve": serve, "pod": pod, "pod_ref": pod_ref}


def _gathered(io, m, b, arch) -> dict:
    """Each part's rows from every rank, put in place; every rank of a data
    block must report the same rows."""
    out = {}
    for r in range(K.WORLD):
        got = np.load(os.path.join(io, f"serve.{m}.b{b}.{arch}.rank{r}.npz"))
        lo, hi = got["rows"]
        for part in ("prefill", "logits", "tokens"):
            whole = out.setdefault(part, [None] * b)
            for i, row in zip(range(lo, hi), got[part]):
                if whole[i] is None:
                    whole[i] = row
                else:
                    np.testing.assert_array_equal(whole[i], row, err_msg=f"rank {r} {part}")
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("m,b", K.SERVE_CASES, ids=[f"{m}-b{b}" for m, b in K.SERVE_CASES])
@pytest.mark.parametrize("arch", K.SERVE_ARCHS)
def test_placed_serving_equals_reference(runs, arch, m, b):
    """Placed prefill's last logits, every decode step's logits (the first
    ``vocab`` ids) and the greedy tokens against the reference's
    single-device answers."""
    got = _gathered(runs["io"], m, b, arch)
    want = runs["ref"][(arch, b)]
    v = tconfigs.get_arch(arch).reduced().vocab
    close(got["prefill"][..., :v], want["prefill"][..., :v], f"{arch} {m} b{b} prefill")
    close(got["logits"][..., :v], want["logits"][..., :v], f"{arch} {m} b{b} decode logits")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_pod_coordinates(runs):
    """On (2, 1, 2) the data coordinate is the pod's: the two pods take the
    two blocks of the batch, the model ranks of a pod the same one."""
    for r, res in enumerate(runs["pod"]):
        pod, data, model = res["coord"]
        assert (pod, data, model) == (r // 2, 0, r % 2)
        assert (res["data"], res["dp"]) == (pod, 2)


@pytest.mark.parametrize("arch", K.POD_ARCHS)
def test_pod_mesh_train_equals_reference_single_device(runs, arch):
    """Metrics and gathered parameters after each of 3 steps; every rank
    reports the same metrics."""
    for s, (params, want) in enumerate(runs["pod_ref"][arch]):
        check_metrics(runs["pod"][0][arch][s], want, is_moe(arch), f"step {s}")
        port = saved(runs["io"], f"pod_{arch}", s)
        assert set(port) == set(params)
        for path, w in params.items():
            close(port[path], w, f"step {s} {path}")
    for res in runs["pod"]:
        assert res[arch] == runs["pod"][0][arch]
