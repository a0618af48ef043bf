"""A durable sharded store holding a configuration's workflows (fig 8/9).

The workflows are logged as :mod:`perfbench.stores.workflows` logs them,
into a ``ShardedDSLog`` of ``store["n_shards"]`` shards under the default
hash placement, then one ``commit()``.  Sharding changes no lineage, so
the reference's edges are the single store's.
"""

from __future__ import annotations

from perfbench.reference.workflows import build_workflow, instance_rng
from perfbench.stores import workflows

reference_edges = workflows.reference_edges


def open_store(core, cfg: dict, root: str, device: str):
    """The configuration's durable sharded store, empty."""
    st = cfg["store"]
    return core.ShardedDSLog.open(root, n_shards=st["n_shards"], durability=st["durability"],
                                  flush_interval=st["flush_interval_s"],
                                  max_batch=st["max_batch"], store_forward=st["store_forward"],
                                  device=device)


def build(core, cfg: dict, seed: int, root: str, device: str):
    """The program's store and, per workflow, its array path and shapes."""
    log = open_store(core, cfg, root, device)
    chains = []
    for pos, spec in enumerate(cfg["workflows"]):
        ops = build_workflow(spec, instance_rng(seed, pos))
        names = workflows.log_workflow(core, log, spec["name"], ops)
        chains.append({"name": spec["name"], "path": names,
                       "shapes": [ops[0][2].in_shape] + [rel.out_shape for _, _, rel in ops]})
    log.commit()
    return log, {"chains": chains}
