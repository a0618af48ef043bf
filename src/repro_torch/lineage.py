"""Integration facade for logging framework ops into DSLog.

The port of ``repro.lineage``, with the same names: one import gives the
catalog (:class:`DSLog`, :class:`ShardedDSLog`), the query types, the
lineage DAG and planner, the op registry with its per-op lineage adapters,
and the capture helpers — without reaching into individual
``repro_torch.core`` submodules.

    from repro_torch import lineage as L

    log = L.DSLog(root="/tmp/lineage")   # device="cuda" unless told "cpu"
    spec = L.get_op("matmul")            # adapter from the op registry
    log.register_operation(...)
    L.QueryBox, log.prov_query("loss", "corpus", cells)  # graph-form query
"""

from repro_torch.core import (  # noqa: F401
    AffinityShardPolicy,
    ArrayDef,
    CommitPipeline,
    CompressedTable,
    CycleError,
    DSLog,
    LeaseHeldError,
    ExchangeStep,
    HashShardPolicy,
    IntervalIndex,
    LineageEntry,
    LineageGraph,
    LineageRelation,
    QueryBox,
    QueryPlan,
    QueryPlanner,
    ReusePredictor,
    ShardedDSLog,
    ShardedLineageGraph,
    ShardedQueryPlan,
    ShardedQueryPlanner,
    ShardPolicy,
    compress,
    compress_both,
    merge_boxes,
    theta_join,
    theta_join_batch,
    theta_join_inverse,
    theta_join_inverse_batch,
)
from repro_torch.core import capture  # noqa: F401
from repro_torch.core.oplib import OPS, OpSpec, get_op, op_names  # noqa: F401

__all__ = [
    "AffinityShardPolicy",
    "ArrayDef",
    "CommitPipeline",
    "CompressedTable",
    "CycleError",
    "DSLog",
    "ExchangeStep",
    "LeaseHeldError",
    "HashShardPolicy",
    "IntervalIndex",
    "LineageEntry",
    "LineageGraph",
    "LineageRelation",
    "OPS",
    "OpSpec",
    "QueryBox",
    "QueryPlan",
    "QueryPlanner",
    "ReusePredictor",
    "ShardPolicy",
    "ShardedDSLog",
    "ShardedLineageGraph",
    "ShardedQueryPlan",
    "ShardedQueryPlanner",
    "capture",
    "compress",
    "compress_both",
    "get_op",
    "merge_boxes",
    "op_names",
    "theta_join",
    "theta_join_batch",
    "theta_join_inverse",
    "theta_join_inverse_batch",
]
