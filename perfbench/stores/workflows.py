"""A durable store holding a configuration's workflows (fig 8/9).

Workflow ``w`` is logged as arrays ``<w>_a0 .. <w>_aK`` and one
``register_operation`` per numpy operation, under its numpy name and
arguments, then one ``commit()``.  Its data come from
``instance_rng(seed, position)``.
"""

from __future__ import annotations

from perfbench.reference.workflows import build_workflow, instance_rng


def array_names(prefix: str, n_ops: int) -> list[str]:
    return [f"{prefix}_a{k}" for k in range(n_ops + 1)]


def log_workflow(core, log, prefix: str, ops) -> list[str]:
    """Define the workflow's arrays and register its operations in ``log``;
    returns the array path."""
    names = array_names(prefix, len(ops))
    log.define_array(names[0], ops[0][2].in_shape)
    for k, (op, args, rel) in enumerate(ops):
        log.define_array(names[k + 1], rel.out_shape)
        lr = core.LineageRelation(rel.out_shape, rel.in_shape, rel.out_idx, rel.in_idx)
        log.register_operation(op, [names[k]], [names[k + 1]],
                               capture=lambda r=lr: {(0, 0): r}, op_args=args)
    return names


def open_store(core, cfg: dict, root: str, device: str):
    """The configuration's durable store, empty."""
    st = cfg["store"]
    return core.DSLog.open(root, durability=st["durability"], flush_interval=st["flush_interval_s"],
                           max_batch=st["max_batch"], store_forward=st["store_forward"],
                           device=device)


def build(core, cfg: dict, seed: int, root: str, device: str):
    """The program's store and, per workflow, its array path and shapes."""
    log = open_store(core, cfg, root, device)
    chains = []
    for pos, spec in enumerate(cfg["workflows"]):
        ops = build_workflow(spec, instance_rng(seed, pos))
        names = log_workflow(core, log, spec["name"], ops)
        chains.append({"name": spec["name"], "path": names,
                       "shapes": [ops[0][2].in_shape] + [rel.out_shape for _, _, rel in ops]})
    log.commit()
    return log, {"chains": chains}


def reference_edges(cfg: dict, seed: int, positions=None) -> tuple[list, dict]:
    """The reference's lineage edges and array shapes, rebuilt from the seed
    (``positions``: only these workflows)."""
    edges, shapes = [], {}
    for pos, spec in enumerate(cfg["workflows"]):
        if positions is not None and pos not in positions:
            continue
        ops = build_workflow(spec, instance_rng(seed, pos))
        names = array_names(spec["name"], len(ops))
        shapes[names[0]] = ops[0][2].in_shape
        for k, (_, _, rel) in enumerate(ops):
            edges.append((names[k], names[k + 1], rel))
            shapes[names[k + 1]] = rel.out_shape
    return edges, shapes
