"""Quickstart on the PyTorch/CUDA port: DSLog lineage storage,
compression, and in-situ queries, on the GPU unless ``--device cpu``.

The port of ``examples/quickstart.py``: the same workflow and queries,
with the store's joins on ``--device``; it prints the same answers.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import DSLog
from repro_torch.core.capture import identity_lineage, matmul_lineage, reduce_lineage

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# A tiny array workflow:  X --(normalize)--> Y --(Y @ W)--> Z --(rowsum)--> S
log = DSLog(device=args.device)
log.define_array("X", (1024, 64))
log.define_array("Y", (1024, 64))
log.define_array("Z", (1024, 16))
log.define_array("S", (1024,))

log.register_operation(
    "normalize", ["X"], ["Y"], capture=lambda: {(0, 0): identity_lineage((1024, 64))}
)
rel_y, rel_w = matmul_lineage(1024, 64, 16)
log.register_operation(
    "project", ["Y"], ["Z"], capture=lambda: {(0, 0): rel_y}
)
log.register_operation(
    "rowsum", ["Z"], ["S"], capture=lambda: {(0, 0): reduce_lineage((1024, 16), 1)}
)

raw_bytes = sum(
    e.backward.decompress().nbytes_raw() for e in log.lineage.values()
)
print(f"stored lineage: {log.storage_bytes()} bytes "
      f"(raw rows would be {raw_bytes} bytes, "
      f"{raw_bytes / log.storage_bytes():.0f}x larger)")

# Backward: which input cells fed S[7]?
back = log.prov_query(["S", "Z", "Y", "X"], np.array([[7]]))
print(f"S[7] depends on {back.n_cells()} cells of X "
      f"(expected 64): boxes={back.n_rows}")

# Forward: where does X[3, 5] flow?
fwd = log.prov_query(["X", "Y", "Z", "S"], np.array([[3, 5]]))
print(f"X[3,5] influences cells of S: {sorted(fwd.cell_set())}")

# Graph form: no hand-spelled path — the planner routes over the lineage
# DAG itself, picking the cheapest stored materialization per hop.
auto = log.prov_query("X", "S", np.array([[3, 5]]))
assert auto.cell_set() == fwd.cell_set()
plan = log.planner.plan("X", ["S"])
print("planner route:\n" + plan.describe())

# Reuse: run the same normalize on new arrays of a DIFFERENT shape —
# after one confirming call, capture is bypassed via index reshaping.
for i, shape in enumerate([(512, 32), (2048, 128), (99, 7)]):
    a, b = f"A{i}", f"B{i}"
    log.define_array(a, shape)
    log.define_array(b, shape)
    rec = log.register_operation(
        "normalize", [a], [b],
        capture=(lambda s=shape: {(0, 0): identity_lineage(s)})
        if i < 2 else None,  # third call: no capture available at all
    )
    print(f"normalize on {shape}: reused={rec.reused}")

# Durable persistence: DSLog.open is the context-managed writer — ingest
# is write-ahead logged (group commit), a second concurrent open raises
# LeaseHeldError, and the with-exit checkpoints (incremental save + log
# truncation).  A reloaded catalog deserializes blobs lazily — only what a
# query touches — and, after a crash, replays the WAL tail on load.
with tempfile.TemporaryDirectory() as d:
    with DSLog.open(d, device=args.device) as disk:
        for name, shape in log.arrays.items():
            disk.define_array(name, shape.shape)
        disk.register_operation(
            "normalize", ["X"], ["Y"],
            capture=lambda: {(0, 0): identity_lineage((1024, 64))},
        )
        disk.register_operation(
            "project", ["Y"], ["Z"], capture=lambda: {(0, 0): rel_y}
        )
    reloaded = DSLog.load(d, device=args.device)
    reloaded.prov_query("Z", "Y", np.array([[7, 3]]))
    print(
        f"reloaded catalog answered a 1-hop query after deserializing "
        f"{reloaded.io_stats['tables_loaded']} of "
        f"{sum(1 + e.has_forward for e in reloaded.lineage.values())} "
        f"table blobs"
    )
