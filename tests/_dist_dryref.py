"""The reference's side of ``test_torch_dryrun.py``'s state bytes, run in a
subprocess::

    python tests/_dist_dryref.py OUT_JSON

Imports ``repro.launch.dryrun`` first, which forces 512 host devices, and
writes ``{"<mesh_tag>|<arch>|<shape>": bytes}``: ``_sharded_bytes`` of the
trees and shardings ``lower_cell`` builds for each cell of both
production meshes (parameters and AdamW state for ``train_*``,
parameters for ``prefill_*``, parameters and caches for decode shapes),
without lowering anything; skipped cells are left out."""

import json
import sys

from repro.launch import dryrun as D  # noqa: I001  (sets XLA_FLAGS before JAX starts)

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as PS


def state_bytes(arch, shape_name, multi_pod):
    cfg = D.get_arch(arch)
    shape = D.SHAPES[shape_name]
    if D.skip_reason(cfg, shape_name):
        return None
    mesh = D.make_production_mesh(multi_pod=multi_pod)
    rules = D.default_rules(mesh)
    param_shapes, param_specs = D.abstract_model(cfg, jnp.bfloat16)
    p_shard = D.param_sharding(mesh, param_specs, rules, param_shapes)
    if shape.kind == "train":
        opt_shapes = D.abstract_opt_state(param_shapes)
        o_shard = {"m": p_shard, "v": p_shard, "step": NamedSharding(mesh, PS())}
        return D._sharded_bytes((param_shapes, opt_shapes), (p_shard, o_shard), mesh.size)
    if shape.kind == "prefill":
        return D._sharded_bytes(param_shapes, p_shard, mesh.size)
    caches = D.abstract_caches(cfg, shape.global_batch, shape.seq_len, jnp.bfloat16)
    c_shard = D.cache_sharding(mesh, caches, cfg.n_kv_heads, shape.global_batch, rules)
    return D._sharded_bytes((param_shapes, caches), (p_shard, c_shard), mesh.size)


def main():
    out = {}
    for multi_pod, tag in ((False, "pod16x16"), (True, "pod2x16x16")):
        for arch in D.ARCHS:
            for s in D.SHAPES:
                n = state_bytes(arch, s, multi_pod)
                if n is not None:
                    out[f"{tag}|{arch}|{s}"] = n
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
