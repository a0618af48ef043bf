"""A durable store holding a configuration's TPC-H lineage (Smoke's Q1, Q3,
Q10 and Q12).

The base tables and every operator's output are arrays of one store (rows
× columns).  Each relational operator is one ``register_operation`` with
one lineage relation per input, so a join logs an entry for each of its
two inputs.  Every operator is value-dependent, so each is registered with
``reuse=False``: a confirmed signature of an earlier operation must not
stand in for its lineage.  Then one ``commit()``.  The tables and
relations come from :mod:`perfbench.reference.tpch`, rebuilt from the seed.
"""

from __future__ import annotations

from perfbench.reference import tpch
from perfbench.stores.workflows import open_store


def _shapes(tables: dict, ops: list) -> dict[str, tuple]:
    shapes = {name: t.shape for name, t in tables.items()}
    shapes.update({op.output: op.rels[0].out_shape for op in ops})
    return shapes


def build(core, cfg: dict, seed: int, root: str, device: str):
    """The program's store and, per chain (a base table to its query's
    final array), its array path and shapes."""
    log = open_store(core, cfg, root, device)
    tables, ops = tpch.build(cfg, seed)
    shapes = _shapes(tables, ops)
    for name in tpch.BASE_TABLES:
        log.define_array(name, shapes[name])
    for op in ops:
        log.define_array(op.output, shapes[op.output])
        rels = {(0, k): core.LineageRelation(r.out_shape, r.in_shape, r.out_idx, r.in_idx)
                for k, r in enumerate(op.rels)}
        log.register_operation(op.op, list(op.inputs), [op.output], capture=lambda r=rels: r,
                               op_args=op.args, reuse=False)
    log.commit()
    chains = [{"name": c["name"], "path": c["path"], "shapes": [shapes[a] for a in c["path"]]}
              for c in tpch.chains(ops)]
    return log, {"chains": chains}


def reference_edges(cfg: dict, seed: int) -> tuple[list, dict]:
    """The reference's lineage edges and array shapes, rebuilt from the seed."""
    tables, ops = tpch.build(cfg, seed)
    return tpch.edges(ops), _shapes(tables, ops)
