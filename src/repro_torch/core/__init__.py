"""DSLog core on PyTorch/CUDA: ProvRC compression and in-situ queries.

The port of ``repro.core`` (Zhao & Krishnan, "Compression and In-Situ
Query Processing for Fine-Grained Array Lineage").  Public API:

    from repro_torch.core import DSLog, QueryBox, compress, LineageRelation

``DSLog()`` runs its dense θ-joins on CUDA by default; pass
``device="cpu"`` for the plain CPU paths.
"""

from .catalog import ArrayDef, DSLog, LineageEntry  # noqa: F401
from .graph import CycleError, LineageGraph  # noqa: F401
from .index import IntervalIndex  # noqa: F401
from .planner import QueryPlan, QueryPlanner  # noqa: F401
from .provrc import compress, compress_both  # noqa: F401
from .query import (  # noqa: F401
    BatchedJoinExecutor,
    QueryBox,
    merge_boxes,
    query_path,
    theta_join,
    theta_join_batch,
    theta_join_inverse,
    theta_join_inverse_batch,
)
from .relation import LineageRelation  # noqa: F401
from .table import CompressedTable  # noqa: F401
