"""The reference's side of ``test_torch_distributed.py``, run in a
subprocess with 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``)::

    python tests/_dist_ref.py IO_DIR [tp | tp-blocks]

reads ``IO_DIR/inputs.npz`` (and the reference checkpoint in
``IO_DIR/ref_ckpt``) and writes ``IO_DIR/reference.json``: every spec of
``_dist_cases`` and, for each placement, the block of each device by its
mesh coordinates (``devices_indices_map``).  With ``tp`` (for
``test_torch_tp_*.py``) it writes ``IO_DIR/reference_tp.json`` instead:
the blocks of every architecture's parameters at ``reduced()`` on the
``TP_MESHES``, and the reference's own jitted train step on a (2, 2) mesh
(``TP_MESH_STEP``) from the trees in ``IO_DIR/tp_init.npz``, its
parameters after each step in ``IO_DIR/refmesh_<arch>.step<s>.npz``
(``tp-blocks``: the blocks alone)."""

import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as PS

import _dist_cases as K
import repro.configs as jconfigs
from repro.checkpoint.manager import CheckpointManager
from repro.distributed.collectives import flash_decode_combine, local_partial_attention
from repro.distributed.collectives import pipeline_stage_step
from repro.distributed.elastic import reshard_tree
from repro.distributed.sharding import (batch_sharding, cache_sharding, hint, param_sharding,
                                        set_activation_mesh)
from repro.data.pipeline import PipelineConfig, TokenPipeline
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.launch.steps import input_specs
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.models.blocks import init_caches
from repro.models.model import init_model

try:
    from jax import shard_map
except ImportError:  # older JAX
    from jax.experimental.shard_map import shard_map


def blocks_by_coord(mesh, sharding, shape) -> dict:
    """``{"i,j": [[start, stop], ...]}`` of each device's block."""
    out = {}
    for dev, idx in sharding.devices_indices_map(tuple(shape)).items():
        coord = np.argwhere(mesh.devices == dev)[0]
        out[",".join(str(int(c)) for c in coord)] = K.block(idx, shape)
    return out


def placed_blocks(mesh, tree) -> dict:
    """Blocks of each leaf of a tree of placed arrays, checked against the
    leaf's values."""
    out = {}
    for path, a in K.flat(tree).items():
        full = np.asarray(a)
        for shard in a.addressable_shards:
            assert np.array_equal(np.asarray(shard.data), full[shard.index])
        out[path] = blocks_by_coord(mesh, a.sharding, a.shape)
    return out


def arch_shapes(cfg):
    specs = {}

    def values(key):
        vals, specs["tree"] = init_model(key, cfg)
        return vals

    return jax.eval_shape(values, jax.random.PRNGKey(0)), specs["tree"]


def main(io):
    inputs = np.load(os.path.join(io, "inputs.npz"))
    meshes = {k: make_mesh(*v) for k, v in K.MESHES.items()}
    res = {"param": {}, "batch": {}, "cache": {}, "hint": {}, "place": {}}

    for name in K.ARCHS:
        for red in (True, False):
            cfg = jconfigs.get_arch(name)
            cfg = cfg.reduced() if red else cfg
            shapes, specs = arch_shapes(cfg)
            for m, mesh in meshes.items():
                sh = param_sharding(mesh, specs, shapes_tree=shapes)
                res["param"][f"{m}|{name}|{red}"] = {
                    p: K.spec_json(s.spec) for p, s in K.flat(sh).items()}

    for m, mesh in meshes.items():
        for case, arch, seq, gb, kind in K.BATCHES:
            batch = input_specs(jconfigs.get_arch(arch),
                                jconfigs.ShapeConfig(case, seq, gb, kind))
            res["batch"][f"{m}|{case}"] = {
                k: K.spec_json(s.spec) for k, s in batch_sharding(mesh, batch).items()}
        for arch, b, t, red in K.CACHES:
            cfg = jconfigs.get_arch(arch)
            cfg = cfg.reduced() if red else cfg
            caches = jax.eval_shape(lambda: init_caches(cfg, b, t, jnp.float32))
            sh = cache_sharding(mesh, caches, cfg.n_kv_heads, b)
            res["cache"][f"{m}|{arch}|{b}|{red}"] = {
                k: {"shape": list(caches[k].shape), "spec": K.spec_json(s.spec)}
                for k, s in sh.items()}

    for m in K.HINT_MESHES:
        mesh = meshes[m]
        for policy in K.POLICIES:
            set_activation_mesh(mesh, policy={"attn_heads": policy})
            for kind, shape in K.HINTS:
                x = jnp.zeros(shape, jnp.float32)
                eqn = jax.make_jaxpr(lambda v: hint(v, kind))(x).eqns[0]
                sharding = eqn.params["sharding"]
                try:  # only shapes the spec's axes divide have a block map
                    blocks = blocks_by_coord(mesh, sharding, shape)
                except ValueError:
                    blocks = None
                res["hint"][K.hint_key(m, policy, kind, shape)] = {
                    "spec": K.spec_json(sharding.spec), "blocks": blocks}
            set_activation_mesh(None)

    host = {k[len("tree/"):]: inputs[k] for k in inputs.files if k.startswith("tree/")}
    tree = K.unflat(host)
    _, specs = arch_shapes(jconfigs.get_arch("qwen2-0.5b").reduced())
    for m in K.PLACE_MESHES:
        res["place"][m] = placed_blocks(meshes[m], reshard_tree(tree, specs, meshes[m]))

    # the reference's own elastic case: written on one mesh, restored on another
    a, b = (meshes[m] for m in K.ELASTIC)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(0, reshard_tree(tree, specs, a), extra={})
        got, _ = mgr.restore(shardings=param_sharding(b, specs, shapes_tree=tree))
    res["elastic"] = placed_blocks(b, got)
    mesh = meshes[K.RESTORE_MESH]
    got, _ = CheckpointManager(os.path.join(io, "ref_ckpt")).restore(
        shardings=param_sharding(mesh, specs, shapes_tree=tree))
    res["restore"] = placed_blocks(mesh, got)

    f = K.FLASH
    sp = make_mesh((K.WORLD,), ("sp",))

    def shard_fn(q, k, v):
        t_local = k.shape[2]
        pos = jax.lax.axis_index("sp") * t_local + jnp.arange(t_local)
        valid = jnp.broadcast_to(pos <= f["cur_len"], (f["b"], t_local))
        return flash_decode_combine(*local_partial_attention(q, k, v, valid), "sp")

    kv = PS(None, None, "sp", None)
    flash = shard_map(shard_fn, mesh=sp, in_specs=(PS(), kv, kv), out_specs=PS())(
        *(jnp.asarray(inputs[k]) for k in ("q", "k", "v")))
    ring = shard_map(lambda x: pipeline_stage_step(lambda y: y * 2.0 + 1.0, x, "sp"),
                     mesh=sp, in_specs=PS("sp"), out_specs=PS("sp"))(jnp.asarray(inputs["ring"]))
    np.savez(os.path.join(io, "reference.npz"), flash=np.asarray(flash), ring=np.asarray(ring))
    with open(os.path.join(io, "reference.json"), "w") as fh:
        json.dump(res, fh)


def main_tp(io, mesh_step=True):
    meshes = {k: make_mesh(*K.MESHES[k]) for k in K.TP_MESHES}
    res = {"blocks": {}, "mesh_step": {}}
    for name in K.ARCHS:
        shapes, specs = arch_shapes(jconfigs.get_arch(name).reduced())
        flat_shapes = K.flat(shapes)
        for m, mesh in meshes.items():
            sh = param_sharding(mesh, specs, shapes_tree=shapes)
            res["blocks"][f"{m}|{name}"] = {
                p: blocks_by_coord(mesh, s, flat_shapes[p].shape) for p, s in K.flat(sh).items()}
    if mesh_step:
        res["mesh_step"] = mesh_steps(io, meshes["2x2"])
    with open(os.path.join(io, "reference_tp.json"), "w") as fh:
        json.dump(res, fh)


def mesh_steps(io, mesh) -> dict:
    """``TP_MESH_STEP``'s jitted steps on ``mesh`` (GSPMD), from the trees of
    ``IO_DIR/tp_init.npz`` placed by ``param_sharding``, on the global
    batches placed by ``batch_sharding``: each step's metrics."""
    init = np.load(os.path.join(io, "tp_init.npz"))
    shape = jconfigs.ShapeConfig("dp", K.DP_SEQ, K.DP_BATCH, "train")
    out = {}
    for name, n_micro in K.TP_MESH_STEP:
        cfg = jconfigs.get_arch(name).reduced()
        tree = K.unflat({k.split("|", 1)[1]: init[k] for k in init.files
                         if k.startswith(name + "|")})
        _, specs = arch_shapes(cfg)
        p_shard = param_sharding(mesh, specs, shapes_tree=tree)
        params = jax.tree.map(jax.device_put, tree, p_shard)
        opt = adamw_init(params)
        opt = {"m": jax.tree.map(jax.device_put, opt["m"], p_shard),
               "v": jax.tree.map(jax.device_put, opt["v"], p_shard), "step": opt["step"]}
        plan = {**jsteps.attn_plan(cfg, shape, dp_total=2), "n_micro": n_micro}
        step = jax.jit(jsteps.make_train_step(cfg, AdamWConfig(**K.DP_OPT), plan))
        pipe = TokenPipeline(PipelineConfig(cfg.vocab, K.DP_SEQ, K.DP_BATCH, 0))
        tok_sh = batch_sharding(mesh, {"tokens": np.zeros((K.DP_BATCH, K.DP_SEQ))})["tokens"]
        metrics = []
        with mesh:
            for s in range(K.DP_STEPS):
                tokens = jax.device_put(jnp.asarray(pipe.global_batch_tokens(s)), tok_sh)
                params, opt, m = step(params, opt, {"tokens": tokens})
                metrics.append({k: float(v) for k, v in m.items()})
                np.savez(os.path.join(io, f"refmesh_{name}.step{s}.npz"),
                         **{k: np.asarray(v) for k, v in K.flat(params).items()})
        out[name] = metrics
    return out


if __name__ == "__main__":
    if sys.argv[2:] in (["tp"], ["tp-blocks"]):
        main_tp(sys.argv[1], mesh_step=sys.argv[2] == "tp")
    else:
        main(sys.argv[1])
