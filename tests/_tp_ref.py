"""Shared by ``test_torch_tp_train.py`` and ``test_torch_tp_layers.py``:
the global batches ``train_loop`` makes, the reference's jitted train
step on one device over them, its subprocess on 4 forced host devices
(``_dist_ref.py``), and the comparison of a step's metrics."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _dist_cases as K
import repro.configs as jconfigs
from repro.data.pipeline import PipelineConfig as JPipelineConfig, TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.optim.adamw import AdamWConfig as JAdamW, adamw_init as j_adamw_init
import repro_torch.configs as tconfigs
from repro_torch.models import init_model, to_reference

TOL = dict(rtol=2e-4, atol=2e-4)
HERE = os.path.dirname(os.path.abspath(__file__))


def is_moe(name) -> bool:
    return tconfigs.get_arch(name).moe is not None


def global_batch(cfg, step) -> dict:
    """``train_loop``'s global batch at ``step``, as numpy: the pipeline's
    tokens, an encoder's frames and a VLM's patch embeddings from a
    ``torch.Generator`` seeded with the step."""
    tokens = JPipeline(JPipelineConfig(cfg.vocab, K.DP_SEQ, K.DP_BATCH, 0)).global_batch_tokens(
        step)
    gen = torch.Generator().manual_seed(step)
    if cfg.encoder_only:
        frames = torch.randn((K.DP_BATCH, K.DP_SEQ, cfg.frontend_dim), generator=gen)
        return {"frames": frames.numpy(), "labels": tokens % cfg.vocab}
    if cfg.frontend == "patch":
        patches = torch.randn((K.DP_BATCH, cfg.frontend_len, cfg.d_model), generator=gen)
        return {"tokens": tokens[:, :K.DP_SEQ - cfg.frontend_len], "patch_embeds": patches.numpy()}
    return {"tokens": tokens}


def initial_tree(name) -> dict:
    """``train_loop``'s initial weights (``seed=0``) as the reference's tree."""
    return to_reference(init_model(tconfigs.get_arch(name).reduced(), 0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit_step(name, n_micro):
    jcfg = jconfigs.get_arch(name).reduced()
    shape = jconfigs.ShapeConfig("dp", K.DP_SEQ, K.DP_BATCH, "train")
    plan = {**jsteps.attn_plan(jcfg, shape, dp_total=1), "n_micro": n_micro}
    return jcfg, jax.jit(jsteps.make_train_step(jcfg, JAdamW(**K.DP_OPT), plan))


def reference_steps(name, n_micro, state=None, first=0, steps=K.DP_STEPS):
    """The reference's jitted ``make_train_step`` on one device over the
    global batches of steps ``first`` … from ``train_loop``'s initial
    weights or ``state`` (``(params, opt)``): the flat parameters and the
    metrics after each step."""
    jcfg, step = _jit_step(name, n_micro)
    if state is None:
        tree = initial_tree(name)
        state = (tree, j_adamw_init(tree))
    params, opt = state
    out = []
    for s in range(first, first + steps):
        batch = {k: jnp.asarray(v) for k, v in global_batch(jcfg, s).items()}
        params, opt, m = step(params, opt, batch)
        out.append((K.flat(jax.tree.map(np.asarray, params)), {k: float(v) for k, v in m.items()}))
    return out


def start_reference(io, mode):
    """The reference's subprocess on 4 forced host devices (``_dist_ref.py
    IO_DIR mode``)."""
    env = {"PYTHONPATH": f"{os.path.join(HERE, '..', 'src')}:{HERE}", "PATH": "/usr/bin:/bin",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={K.WORLD}"}
    for var in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):  # see test_distributed.py
        if var in os.environ:
            env[var] = os.environ[var]
    return subprocess.Popen([sys.executable, os.path.join(HERE, "_dist_ref.py"), io, mode],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_reference(proc, io) -> dict:
    try:
        out = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    with open(os.path.join(io, "reference_tp.json")) as fh:
        return json.load(fh)


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def saved(io, tag, step) -> dict:
    return dict(np.load(os.path.join(io, f"{tag}.step{step}.npz")))


def check_metrics(mine, want, moe, what):
    """The port's metrics against a reference step's; an MoE's reported
    loss is the mean over the data ranks of ``ce + 0.01 * aux``, the
    reference's ``n_micro = dp`` step reports the mean ``ce``."""
    for key in ("ce", "aux", "grad_norm", "lr"):
        close(mine[key], want[key], f"{what} {key}")
    close(mine["loss"], want["ce"] + 0.01 * want["aux"] if moe else want["loss"], f"{what} loss")
    np.testing.assert_allclose(mine["loss"], mine["ce"] + 0.01 * mine["aux"], rtol=1e-6)


def check_run(io, tag, got, ref, moe):
    """A run's metrics and saved parameters against reference steps."""
    for s, (params, m) in enumerate(ref):
        check_metrics(got["metrics"][s], m, moe, f"{tag} step {s}")
        port = saved(io, tag, s)
        assert set(port) == set(params)
        for path, want in params.items():
            close(port[path], want, f"{tag} step {s} {path}")


def block_bytes(block) -> int:
    return int(np.prod([b - a for a, b in block])) * 4


def whole(by_coord) -> list:
    """A leaf's whole extent from its blocks by mesh coordinate."""
    blocks = list(by_coord.values())
    return [[min(b[d][0] for b in blocks), max(b[d][1] for b in blocks)]
            for d in range(len(blocks[0]))]


def check_blocks(run, coord, ref):
    """Each part's blocks (parameters after ``train_loop``; parameters and
    both moments after a placed step) are the reference's at ``coord``, and
    the rank holds those bytes alone."""
    for blocks, held in ((run["blocks"], run["held"]), (run["step_blocks"], run["step_held"])):
        for part, by_path in blocks.items():
            assert set(by_path) == set(ref), part
            for path, block in by_path.items():
                assert block == ref[path][coord], f"{part} {path} at {coord}"
            assert held[part] == sum(block_bytes(ref[p][coord]) for p in ref), part
    assert set(run["step_blocks"]) == {"params", "m", "v"}
