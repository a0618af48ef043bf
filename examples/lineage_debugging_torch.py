"""Training-data forensics with DSLog on the PyTorch/CUDA port: find which
corpus documents shaped a given training shard row, across the pipeline
chain, without decompression; the store's joins on the GPU unless
``--device cpu``.

The port of ``examples/lineage_debugging.py``: the same pipeline, stores
and queries, which print the same answers.  The pipeline logs per-step
lineage into DSLog; the shuffle gather is value-dependent (captured each
step) while the shard/microbatch slices hit ``dim_sig`` reuse after one
confirmation.  Stores are opened with the durable, context-managed form
(``with DSLog.open(root, device=...) as log``): the writer lease makes a
second concurrent open an error, every ingest is write-ahead logged with
group commit, and leaving the ``with`` block checkpoints and releases the
lease.

    PYTHONPATH=src python examples/lineage_debugging_torch.py
    PYTHONPATH=src python examples/lineage_debugging_torch.py --device cpu
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core.catalog import DSLog
from repro_torch.core.commit import LeaseHeldError
from repro_torch.core.shard import ShardedDSLog
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

cfg = PipelineConfig(vocab=32000, seq_len=64, global_batch=16, seed=42,
                     n_source_rows=100_000)

with tempfile.TemporaryDirectory() as root:
    with DSLog.open(root, device=args.device) as log:
        pipe = TokenPipeline(cfg, data_shards=4, shard_id=0, dslog=log)
        for _ in range(4):
            pipe.next_batch()

        n_reused = sum(1 for op in log.ops if op.reused)
        print(f"registered {len(log.ops)} pipeline ops; {n_reused} served by "
              f"reuse (capture bypassed)")
        print(f"total lineage storage: {log.storage_bytes() / 1024:.1f} KiB")

        # the lease protocol makes the old double-open bug an error: a
        # second writer on the same root is refused while this one is live
        try:
            DSLog.open(root, device=args.device)
            raise AssertionError("double-open must raise")
        except LeaseHeldError as e:
            print(f"second writer refused while store is open: {e}")

        # ---- backward query: which corpus doc produced shard row 2, token
        # 10, at step 3?  Graph form: the planner routes shard -> batch ->
        # corpus over the lineage DAG itself — no hand-spelled path. -------
        res = log.prov_query("shard_s3_k0", "corpus", np.array([[2, 10]]))
        docs = sorted({c[0] for c in res.cell_set()})
        truth = pipe.source_rows_for_step(3)[2]
        print(f"shard_s3_k0[2, 10] came from corpus doc(s) {docs} "
              f"(ground truth: {truth})")
        assert docs == [int(truth)]
        # the explicit-path form (paper §V) answers identically
        via_path = log.prov_query(
            ["shard_s3_k0", "batch_s3", "corpus"], np.array([[2, 10]])
        )
        assert via_path.cell_set() == res.cell_set()

        # ---- forward query: a suspect document — which rows of data shard
        # 0 did it touch in step 3?  (shard 0 holds global batch rows 0-3.)
        suspect = int(pipe.source_rows_for_step(3)[2])
        fwd = log.prov_query("corpus", "shard_s3_k0", np.array([[suspect, 0]]))
        rows = sorted({c[0] for c in fwd.cell_set()})
        print(f"corpus doc {suspect} touched shard-0 rows {rows} "
              f"(expected [2])")
        assert rows == [2]
        answer = res.cell_set()
    # with-exit: checkpointed + lease released — reopening now works
    with DSLog.open(root, device=args.device) as again:
        assert again.prov_query(
            "shard_s3_k0", "corpus", np.array([[2, 10]])
        ).cell_set() == answer
    print("reopened after close: checkpointed state answers identically")

# ---- the same forensics on a sharded store: DSLog's surface is unchanged,
# so the pipeline logs into a 4-shard ShardedDSLog as-is; queries whose
# route crosses shard boundaries ship merged-box frontiers between the
# per-shard sub-plans. ------------------------------------------------------
with tempfile.TemporaryDirectory() as sroot:
    with ShardedDSLog.open(sroot, 4, device=args.device) as slog:
        spipe = TokenPipeline(cfg, data_shards=4, shard_id=0, dslog=slog)
        for _ in range(4):
            spipe.next_batch()

        sres = slog.prov_query("shard_s3_k0", "corpus", np.array([[2, 10]]))
        assert sres.cell_set() == answer  # == the single-store answer
        plan = slog.planner.plan("shard_s3_k0", ["corpus"])
        print(
            f"sharded store: {len(slog.lineage)} entries over "
            f"{slog.n_shards} shards, {len(slog.sgraph.boundary)} boundary "
            f"edges; query plan touches shards {plan.shards_touched()} with "
            f"{len(plan.exchanges)} boundary exchanges "
            f"({slog.io_stats['boxes_exchanged']} boxes shipped so far)"
        )
