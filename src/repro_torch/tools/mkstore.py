"""Build a small sharded store for smoke checks (CI's fsck target).

Usage::

    python -m repro_torch.tools.mkstore ROOT [--shards 4] [--ops 12] [--seed 7] [--device cpu]

The port of ``repro.tools.mkstore``.  Opens a ``ShardedDSLog`` durably on
``--device`` (default ``cuda``, which needs CUDA; ``cpu`` runs anywhere),
ingests a random chain-plus-fan-in DAG of synthetic lineage (identity /
flip / roll / transpose over an 8×8 array), drops one entry, checkpoints,
compacts, runs a probe ``prov_query``, and closes.  The resulting directory
exercises every on-disk structure fsck verifies: root + shard manifests,
blobs and index sidecars, WALs, the boundary-edge table, and released
leases.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_store(
    root: str, n_shards: int = 4, n_ops: int = 12, seed: int = 7, device="cuda"
) -> dict:
    from repro_torch.core.capture import (
        flip_lineage,
        identity_lineage,
        roll_lineage,
        transpose_lineage,
    )
    from repro_torch.core.shard import ShardedDSLog

    shape = (8, 8)
    ops = [
        lambda rng: identity_lineage(shape),
        lambda rng: flip_lineage(shape, int(rng.integers(0, 2))),
        lambda rng: roll_lineage(shape, int(rng.integers(1, 4)), 0),
        lambda rng: transpose_lineage(shape, (1, 0)),
    ]
    rng = np.random.default_rng(seed)
    log = ShardedDSLog.open(root, n_shards=n_shards, device=device)
    try:
        names = ["a0"]
        entry_ids = []
        for k in range(n_ops):
            new = f"a{k + 1}"
            rel = ops[int(rng.integers(0, len(ops)))](rng)
            entry_ids.append(log.add_lineage(names[-1], new, rel).lineage_id)
            if k % 3 == 2 and len(names) > 2:
                other = names[int(rng.integers(0, len(names) - 1))]
                rel2 = ops[int(rng.integers(0, len(ops)))](rng)
                entry_ids.append(log.add_lineage(other, new, rel2).lineage_id)
            names.append(new)
        log.save()
        # leave GC work behind, then reclaim it: exercises the vacuum path
        log.drop_lineage(entry_ids[len(entry_ids) // 2])
        log.compact()
        probe = log.prov_query(names[0], names[-1], np.array([[1, 2], [6, 7]]))
        stats = {
            "entries": len(entry_ids) - 1,
            "arrays": len(names),
            "probe_cells": len(probe.cell_set()),
        }
    finally:
        log.close()
    return stats


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.mkstore",
        description="build a small sharded store for fsck smoke checks",
    )
    ap.add_argument("root")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--ops", type=int, default=12)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument(
        "--device", default="cuda", help="the store's device: cuda (default) or cpu"
    )
    args = ap.parse_args(argv)
    stats = build_store(args.root, args.shards, args.ops, args.seed, args.device)
    print(f"mkstore: {args.root}: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
