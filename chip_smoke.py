#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit::

    python3 chip_smoke.py
    python3 chip_smoke.py --before OLD/src/repro_torch/kernels/csrc  # also time an earlier commit's kernels

Phases:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (with ``--before``, also those of an earlier commit, symbols renamed);
2. hold each kernel against its plain PyTorch version on the card (exact
   equality; the mask kernel also over row counts and widths around its
   block tile, boxes that hold 0 and 1, and raw launches at every output
   alignment; the tile kernel over widths and block sizes, pad rows,
   repeated tiles and raw launches with guard bytes) and time, on made-up
   operands and block-diagonal schedules (one that fills the card, one of
   64 attributes), as medians of 9 runs: the kernel (``ms``: one CUDA
   event pair around K back-to-back raw launches into a preallocated
   output, divided by K, see ``KernelTimer``; ``ms_before`` the earlier
   commit's kernel, timed in turns with it), the wrapper a caller uses
   (``wrapper_ms``: one call per event pair, with output allocation,
   operand and schedule checks and the host's launch gap) and the plain
   version (``plain_ms``, one call per event pair);
3. DSLog ingest + explicit-path ``prov_query`` over the paper's fig 8/9
   workflows at their published sizes, checked against a raw-join oracle;
4. batched frontiers: the accel DAG queried with the per-hop loop and the
   batched executor, bit-identical, checked against a bijection oracle;
5. the per-hop dense route: ``theta_join(path="dense")`` on a poorly
   compressible 20,000-row table, equal to ``path="index"``;
6. phase 2's checks and timings again, on the operands phases 3-5 handed
   the kernels (recorded as they ran), and for each phase 4 frontier the
   time of the whole pair pipeline (``pipeline``) at each tile size;
7. the durable store at the same sizes: ``DSLog.open`` (WAL, group commit,
   writer lease) ingests phase 3's workflows with reuse on and answers
   phase 3's queries equal to phase 3's; a checkpointed close and a cold
   reopen; a crash (``close(checkpoint=False)``) recovered by
   ``DSLog.load``'s WAL replay; phase 4's accel DAG on a durable store,
   queried until a view is materialized and hit and an answer is served
   from the cache, equal to phase 4's store;
8. ``run_boundaries``: ``ops.run_boundaries`` on the rows ProvRC's first
   step-1 pass sorted for each phase 3 workflow's largest relation
   (recorded as phase 3 ran; on those point rows the flags equal
   ``coalesce_1d``'s run starts) and on the 4,194,304 rows of a one-to-one
   relation over a 2048 x 2048 array; then the kernel against its plain
   version on made-up tables (1 to 2^20 rows, 0 to 126 keys), edge rows
   and those operands, timed as in phase 2, and ``ops.run_boundaries`` on
   the 4,194,304 rows on the host clock;
9. the sharded store (``ShardedDSLog``, four shards on the one card):
   (a) ``ShardedDSLog.open`` with the hash policy ingests phase 3's
   workflows with reuse on and answers phase 3's queries (merged answers
   byte for byte, the others cell for cell: a frontier crossing shards
   ships merged), with boxes exchanged between shards; (b) phase 4's accel
   DAG on an affinity policy that spreads its branches over the shards,
   equal to phase 4's answer; (c) a checkpointed close, a cold
   ``ShardedDSLog.load`` whose one-shard query loads only that shard, the
   queries again, more ingest, a crash and its recovery; (d) the port's
   ``fsck`` on phase 7's stores and this one, and ``health(run_fsck=True)``;
   (e) ``capture_jacobian`` on the card against ``oplib``'s lineage;
10. the LM serving path (``repro_torch.models``, ``launch.serve``,
    ``data.pipeline``): qwen2-0.5b at its published widths (24 layers,
    d_model 896, 14/2 heads of 64, d_ff 4,864, vocab 151,936 padded to
    152,064; float32 weights from a seeded generator on the card, matmuls
    at "highest" precision) serves 3 request batches of 8 prompts of 128
    tokens from a ``TokenPipeline`` logging into a ``DSLog`` on the card,
    32 greedy tokens each (``generate``, which times its prompt and its
    decode loop);
    (b) for the first batch the stepwise decode logits equal the full
    ``forward(mode="dot")`` on the card (rtol = atol = 2e-3, the reference's
    tolerance for this) and one prompt's first step on the card equals the
    CPU's on the same weights (1e-3); every greedy token is the forward's
    argmax up to that tolerance; (c) each step's shard cells queried back
    through the batch to the corpus equal the shuffle's source rows, and
    ``shard_slice`` is reused (``dim``) from the third step; (d) every
    decoder architecture at ``reduced()`` gives the same greedy tokens on the
    card and on the CPU; (e) init s, prefill ms, decode ms a token against
    its memory bound, tokens/s, peak memory, and a profiled decode step's
    device work and idle share (``torch.profiler``) are printed.
11. the LM training path (``launch.steps``, ``launch.train``, ``optim``,
    ``checkpoint``): (a) qwen2-0.5b at its published widths and depth
    (``remat="full"``) takes 5 AdamW steps of ``make_train_step`` on
    ``train_4k``'s 4,096-token sequences at a global batch of 2 (cut from
    256: one card, float32), ``attn_plan``'s chunked attention at 512,
    on batches from a ``TokenPipeline`` logging into a ``DSLog`` on the
    card; step ms (step 1 apart), tokens/s, the step's flop bound and the
    share of it reached, peak memory, and loss, ``grad_norm`` and ``lr``
    each step (finite; ``lr`` equal to ``cosine_schedule``), then a sixth
    step under ``torch.profiler`` (device busy time, idle share, the dense
    products' share, the heaviest kernels); (b) the
    published layer widths cut to 2 layers take 2 steps on the card and the
    CPU from the same weights (loss, ``grad_norm`` and ``lr`` within rtol =
    atol = 1e-3; the parameters within 1e-4 but for a share of at most 1e-6
    of the entries, whose gradients cancel to near zero and which AdamW's
    normalisation may move by up to 2 lr a step), and the gradient under remat ``full`` and
    ``dots`` equals ``nothing``'s on the card (atol 1e-5); (c) ``train_loop``
    at ``reduced()`` with checkpoints every 3 steps: a run resumed from step
    2 gives the straight run's losses (atol 1e-6), and the last checkpoint
    restores on the CPU to the trained parameters, bit for bit (save and
    restore seconds printed); (d) three steps' shard cells queried back to
    the corpus equal the pipeline's source rows.
12. the LM stack's distributed path (``launch.mesh``, ``distributed``,
    ``launch.train`` on a mesh): (a) the script starts itself twice
    (``--mesh-rank``) as two ranks of a ``gloo`` group sharing the card
    (NCCL takes one rank a card; ``gloo`` runs its collectives on CUDA
    tensors through the host), each running ``train_loop`` on ``cuda:0``
    on a (2, 1) mesh, ZeRO-3 (each rank holds its data coordinate's block
    of every ``fsdp`` dimension), at qwen2-0.5b's published widths and 2
    of its 24 layers (the depth cut to keep the script near 300 s) for 3
    steps of phase 11's batches, one sequence a rank: loss, ``grad_norm``
    and ``lr`` within 1e-4 of those of a one-process ``train_loop`` at the
    same depth, the gathered parameters within 1e-5 of its after step 3
    (below 2 sum(lr), which any two AdamW runs of 3 steps keep; largest
    difference printed), both ranks' gathered trees equal and each rank's
    blocks their slices of it; each rank's held parameter, gradient and
    moment bytes, peak memory (beside the one-process run's), step ms, its
    collectives' bytes a step and those collectives replayed alone, after
    a checked call of each on known values; (b) a one-rank ``nccl`` group in this
    process: ``local_mesh(1)`` is a ``cuda`` mesh, ``reshard_tree`` lays
    qwen2-0.5b's tree (phase 11's weights after step 3) on it bit for bit,
    ``restore(shardings=)`` of 11c's checkpoint equals the plain restore,
    and ``flash_decode_combine`` and ``pipeline_stage_step`` equal their
    one-rank answers.
13. the mesh path (tensor parallelism and ZeRO-3): the script starts
    itself 4 times as ``gloo`` ranks sharing the card, running
    ``train_loop(model_parallel=2)`` on a (2, 2) mesh at qwen2-0.5b's
    published widths and depth (``remat="full"``), phase 11's two
    sequences, one a data coordinate, for 3 steps: loss, ``grad_norm`` and
    ``lr`` within 1e-4 of phase 11's; the gathered parameters within 1e-5
    of phase 11's for all but a 1e-6 share of the entries (phase 11b's
    rule) and all below 2 sum(lr); each rank's blocks their slices of the
    gathered tree, exactly; ``replicated_over_model`` empty; rank 0's
    lineage store (logged by its pipeline on the card) queried back to the
    corpus, which must launch ``range_join_mask``; printed as 12a.

Phases 3-5 are the port's main path, phase 7 the store's, phase 8's
``ops.run_boundaries`` calls the run-boundary kernel's and phase 9 the
sharded store's: the launch counters are zeroed before each of those and
read after it, and each path's kernels must have launched (in phase 9,
``range_join_mask`` in step a and ``range_join_tile_masks`` in step b).
Phase 10's counters are zeroed and read the same way and reported
(``launches_serve_path``); the LM stack has no kernel of its own, so none
is required to launch there.  Phase 11's are reported as
``launches_train_path``, and its lineage queries must launch
``range_join_mask``; phase 12's as ``launches_dp_path`` (the ranks of 12a
report theirs; the distributed pieces have no kernel); phase 13's ranks
count theirs from zero and report them as ``launches_tp_path``, where
``range_join_mask`` must have launched.  The JSON line reports phase 6's and phase 8's numbers
on the main paths' own operands.  Any failure raises and exits non-zero.
Without CUDA, or without the port beside this script, it exits non-zero
and prints no result.  The last three stdout lines are the card's name and
power limit, a JSON object of per-kernel numbers, and
``{"ok": true, "device": {...}}``.

The workflow constructors and the raw-join oracle are this script's own copies
of ``benchmarks/fig89_query.py``'s (lines 57-167, 247-255, 810-870), so it
needs nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor fp32 rate, taken for the int32 compares these kernels issue on
# the same CUDA cores (an optimistic rate, so the bound stays a lower bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
TIMING_REPS = 9
# a timed run of back-to-back kernel launches lasts about RUN_MS, in at most
# MAX_LAUNCHES launches
RUN_MS = 1.0
MAX_LAUNCHES = 1000
# block-diagonal tile sizes timed on the main path's first frontier: the
# port launches at DEFAULT_GEOMETRY (256x256); these are the alternatives
TILE_GEOMETRIES = ((64, 64), (64, 128), (128, 128), (128, 256), (256, 128), (256, 256))
# phase 2: the tile kernel's exactness sweep, widths around its four-attribute
# passes and block sizes that take each of its block tiles, and ragged ones
TILE_WIDTHS = (1, 2, 3, 4, 5, 8, 9, 17, 63, 64)
TILE_SIZES = ((32, 32), (64, 64), (64, 128), (64, 256), (128, 128), (256, 64), (256, 128),
              (256, 256), (96, 160))
# phase 2's timed block-diagonal schedules at 256 x 256: (segments, rows a
# side of each, attributes); the first fills the card, the second is wide
TILE_SCHEDULES = ((64, 2048, 4), (16, 1024, 64))

KERNEL_SOURCES = {
    "range_join_mask": "src/repro_torch/kernels/csrc/range_join.cu",
    "range_join_tile_masks": "src/repro_torch/kernels/csrc/range_join.cu",
    "run_boundaries_packed": "src/repro_torch/kernels/csrc/run_boundary.cu",
}
REPLACES = {
    "range_join_mask": "src/repro/kernels/range_join.py:118",
    "range_join_tile_masks": "src/repro/kernels/range_join.py:198",
    "run_boundaries_packed": "src/repro/kernels/run_boundary.py:86",
}
SELECTIVITIES = (0.001, 0.01, 0.1)
# phase 2: mask row counts around the kernel's 64 x 256 block tile and its
# 16-byte stores, and widths around its four-attribute passes
MASK_EDGES = (1, 63, 64, 65, 255, 256, 257, 1000)
MASK_WIDTHS = (1, 2, 4, 8, 9, 16, 17, 63, 64)
# phase 8: made-up tables (rows x key columns), and the 2048 x 2048 table
RB_ROWS = (1, 255, 256, 257, 1024, 1025, 1 << 20)
# key counts whose row width (n_keys + 2 lanes) is 1-3 16-byte chunks, not a
# multiple of 4 lanes, or the whole 128-lane row; timed at 2^20 rows: RB_TIMED_KEYS
RB_KEYS = (0, 1, 2, 3, 4, 6, 7, 8, 126)
RB_TIMED_KEYS = (0, 1, 4, 8, 126)
RB_SIDE = 2048
# phase 3's workflow sizes (image side, relational n, resnet side, random
# pipelines, random cells) and phase 4's accel DAG (shape, branches, hops,
# query cells)
FIG89_SIZES = (256, 20_000, 128, 6, 40_000)
ACCEL = ((32, 31), 20, 2, 330)
# phase 9: shards of the sharded store (all on the one card)
SHARDS = 4
# phase 10: the serving path at qwen2-0.5b's published widths, float32
# weights from a seeded generator on the card: SERVE_BATCHES request batches
# of SERVE_BATCH prompts of SERVE_PROMPT tokens from the token pipeline,
# each extended by SERVE_NEW greedy tokens
SERVE_ARCH = "qwen2-0.5b"
SERVE_BATCHES, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 3, 8, 128, 32
SERVE_SEED = 0
# stepwise decode against the full forward on the card: the reference's own
# tolerance for that equivalence (tests/test_models.py:96-98); the card
# against the CPU on the same weights (float32 sums in another order)
DECODE_TOL = 2e-3
CARD_CPU_TOL = 1e-3
# phase 10d: each decoder at reduced(), on the card and the CPU
SMALL_BATCH, SMALL_PROMPT, SMALL_NEW = 2, 16, 8
# phase 11: the training path at qwen2-0.5b's published widths and depth,
# train_4k's sequence with its global batch cut from 256 to TRAIN_BATCH (one
# card, float32), TRAIN_STEPS steps; lineage queried back for three steps
TRAIN_ARCH, TRAIN_SHAPE, TRAIN_BATCH, TRAIN_STEPS, TRAIN_SEED = (
    "qwen2-0.5b", "train_4k", 2, 5, 0)
TRAIN_LINEAGE_STEPS = (0, 2, 4)
# phase 11b: the published layer widths at TRAIN_CPU_LAYERS layers on the card
# and the CPU (float32 sums in another order); remat's recomputation repeats
# the same products on the card
TRAIN_CPU_LAYERS, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS = 2, 256, 2
TRAIN_CARD_CPU_TOL = 1e-3
# parameters after the steps: all but PARAM_OUT_SHARE of the entries within
# PARAM_TOL, every entry within AdamW's bound (see train_card_vs_cpu)
PARAM_TOL, PARAM_OUT_SHARE = 1e-4, 1e-6
REMAT_TOL = 1e-5
# phase 11c: train_loop at reduced() resumed from a checkpoint on the same card
RESUME_SEQ = 64
RESUME_TOL = 1e-6
# phase 12a: train_loop data-parallel over DP_RANKS processes sharing the card
# (a gloo group: NCCL takes one rank a card), DP_STEPS steps of phase 11's
# batches at DP_LAYERS of qwen2-0.5b's 24 layers (published widths; the depth
# is cut to keep the script near 300 s, and phase 13 trains all 24), held to a
# one-process train_loop at that depth
DP_RANKS, DP_LAYERS, DP_STEPS, DP_TOL, DP_TIMEOUT_S = 2, 2, 3, 1e-4, 600
# and every parameter within DP_PARAM_TOL of the reference's: below 2 sum(lr), the
# most that any two AdamW runs of DP_STEPS steps can differ by, so a wrong
# gradient average or update shows there too
DP_PARAM_TOL = 1e-5
# phase 13: train_loop on a (TP_RANKS / TP_MODEL, TP_MODEL) mesh of TP_RANKS
# processes sharing the card, DP_STEPS steps of phase 11's batches (one
# sequence a data rank) at all 24 layers, held to phase 11's steps, its
# parameters by phase 11b's rule (all but PARAM_OUT_SHARE of the entries
# within DP_PARAM_TOL)
TP_RANKS, TP_MODEL = 4, 2
# phase 12b: flash-decode partials on a one-rank NCCL group
FLASH_SHAPE, FLASH_TOL = (2, 14, 4096, 64), 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


# the C symbols of the kernel library; an earlier build is linked with each
# renamed before_<name>, so both libraries load in one process
LIB_SYMBOLS = ("rj_range_join_mask", "rj_range_join_tile_masks", "rb_run_boundaries",
               "rj_error_string")


def start_before_build(_build, src_dir: Path) -> list:
    """Start one ``nvcc`` per ``*.cu`` of ``src_dir`` (the ``csrc`` directory
    of an earlier commit), with the flags of ``_build``; returns the
    (source, object, process) triples."""
    srcs = sorted(src_dir.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"--before: no *.cu in {src_dir}")
    out = ROOT / "build" / "before"
    out.mkdir(parents=True, exist_ok=True)
    renames = [f"-D{sym}=before_{sym}" for sym in LIB_SYMBOLS]
    procs = []
    for src in srcs:
        obj = out / f"{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *renames, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    return procs


def finish_before_build(_build, procs, lib):
    """Link the earlier build and bind it like ``lib``: an object whose
    attributes carry ``lib``'s names."""
    import ctypes
    from types import SimpleNamespace

    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"--before: nvcc failed on {src}:\n{err[-4000:]}")
    so = ROOT / "build" / "before" / "libbefore.so"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", str(so),
                    *(str(obj) for _, obj, _ in procs)], check=True, capture_output=True)
    before = ctypes.CDLL(str(so))
    bound_fns = {}
    for sym in LIB_SYMBOLS:
        fn = getattr(before, f"before_{sym}")
        fn.argtypes = getattr(lib, sym).argtypes
        fn.restype = getattr(lib, sym).restype
        bound_fns[sym] = fn
    return SimpleNamespace(**bound_fns)


# --------------------------------------------------------------------------- #
# Workflows (copies of benchmarks/fig89_query.py constructors)
# --------------------------------------------------------------------------- #
def image_workflow(C, side=256):
    h = side
    rels = [
        C.slice_lineage((h, h), (0, 0), (h, h), (2, 2)),
        C.identity_lineage((h // 2, h // 2)),
        C.transpose_lineage((h // 2, h // 2), (1, 0)),
        C.flip_lineage((h // 2, h // 2), 1),
        C.reduce_lineage((h // 2, h // 2), 1),
    ]
    return "image", rels


def relational_workflow(C, n=20_000):
    rng = np.random.default_rng(3)
    lk = rng.integers(0, n // 2, n)
    rk = rng.integers(0, n // 2, n // 2)
    join_l, _ = C.inner_join_lineage(lk, rk, 3, 2)
    n_out = join_l.out_shape[0]
    rels = [
        join_l,
        C.identity_lineage(join_l.out_shape),
        C.reduce_lineage(join_l.out_shape, 1),
        C.identity_lineage((n_out,)),
        C.identity_lineage((n_out,)),
    ]
    return "relational", rels


def resnet_workflow(C, side=128):
    s = side
    rels = [
        C.conv2d_lineage(s, s, 3, 3),
        C.identity_lineage((s - 2, s - 2)),
        C.conv2d_lineage(s - 2, s - 2, 3, 3),
        C.identity_lineage((s - 4, s - 4)),
        C.conv2d_lineage(s - 4, s - 4, 3, 3),
        C.identity_lineage((s - 6, s - 6)),
        C.reduce_lineage((s - 6, s - 6), (0, 1)),
    ]
    return "resnet", rels


def random_ops(C):
    return [
        lambda shape, rng: C.identity_lineage(shape),
        lambda shape, rng: C.identity_lineage(shape),
        lambda shape, rng: C.identity_lineage(shape),
        lambda shape, rng: C.flip_lineage(shape, 0),
        lambda shape, rng: C.roll_lineage(shape, int(rng.integers(1, 5)), 0),
        lambda shape, rng: C.transpose_lineage(
            shape, tuple(reversed(range(len(shape))))
        ),
        lambda shape, rng: C.reshape_lineage(shape, (int(np.prod(shape)),)),
        lambda shape, rng: C.sort_lineage(rng.random(shape), axis=-1),
    ]


def random_workflow(C, n_ops: int, seed: int, n_cells: int = 40_000):
    ops_list = random_ops(C)
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_cells))
    shape = (side, side)
    rels = []
    for _ in range(n_ops):
        rel = ops_list[int(rng.integers(0, len(ops_list)))](shape, rng)
        rels.append(rel)
        shape = rel.out_shape
    return f"random{n_ops}_s{seed}", rels


def fig89_workflows(C, image_side, rel_n, resnet_side, n_random, random_cells):
    flows = [
        image_workflow(C, image_side),
        relational_workflow(C, rel_n),
        resnet_workflow(C, resnet_side),
    ]
    for seed in range(n_random):
        flows.append(random_workflow(C, 5, seed, random_cells))
    return flows


def forward_join_rows(rels, query_cells) -> np.ndarray:
    """Raw-join oracle: hash-join forward propagation over uncompressed rows."""
    cur = np.ravel_multi_index(query_cells.T, rels[0].in_shape)
    for rel in rels:
        in_r = np.ravel_multi_index(rel.in_idx.T, rel.in_shape)
        out_r = np.ravel_multi_index(rel.out_idx.T, rel.out_shape)
        cur = np.unique(out_r[np.isin(in_r, cur)])
    return cur


def box_flat_cells(box) -> np.ndarray:
    """Distinct flat cell ids covered by a QueryBox (vectorized expansion)."""
    n, nd = box.lo.shape
    owner = np.arange(n, dtype=np.int64)
    cols: list[np.ndarray] = []
    for d in range(nd):
        counts = box.hi[owner, d] - box.lo[owner, d] + 1
        rep = np.repeat(np.arange(owner.size), counts)
        offset = np.arange(rep.size) - np.repeat(np.cumsum(counts) - counts, counts)
        cols = [c[rep] for c in cols] + [box.lo[owner[rep], d] + offset]
        owner = owner[rep]
    if not cols:
        return np.zeros(0, np.int64)
    return np.unique(np.ravel_multi_index(np.stack(cols), box.shape))


def scatter_table(compress, LineageRelation, n_rows: int, seed: int = 0):
    """A poorly compressible (near one row per pair) table."""
    rng = np.random.default_rng(seed)
    o = np.stack([np.arange(n_rows), rng.integers(0, 64, n_rows)], axis=1)
    i = np.stack([rng.permutation(n_rows)], axis=1)
    rel = LineageRelation((n_rows, 64), (n_rows,), o, i).canonical()
    return compress(rel)


def permutation_lineage(LineageRelation, shape, rng):
    n = int(np.prod(shape))
    cells = np.stack(np.unravel_index(np.arange(n), shape), axis=1).astype(np.int64)
    perm = rng.permutation(n)
    return LineageRelation(shape, shape, cells, cells[perm]).canonical()


def build_accel_dag(log_, LineageRelation, shape, branches, hops, seed=0):
    """``src`` fans out to ``branches`` chains of ``hops`` random bijections
    that all fan back into ``out``, in the store ``log_``; returns each
    branch's relations (for the oracle)."""
    rng = np.random.default_rng(seed)
    log_.define_array("src", shape)
    log_.define_array("out", shape)
    chains = []
    for b in range(branches):
        prev, chain = "src", []
        for h in range(hops):
            name = f"b{b}h{h}"
            log_.define_array(name, shape)
            rel = permutation_lineage(LineageRelation, shape, rng)
            log_.add_lineage(prev, name, rel)
            chain.append(rel)
            prev = name
        rel = permutation_lineage(LineageRelation, shape, rng)
        log_.add_lineage(prev, "out", rel)
        chain.append(rel)
        chains.append(chain)
    return chains


def ragged_frontier(k, row_lo, row_hi, n_attrs, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(k):
        nq = int(rng.integers(row_lo, row_hi))
        nr = int(rng.integers(row_lo, row_hi))
        q_lo = rng.integers(0, 512, size=(nq, n_attrs)).astype(np.int64)
        r_lo = rng.integers(0, 512, size=(nr, n_attrs)).astype(np.int64)
        q_hi = q_lo + rng.integers(1, 48, size=(nq, n_attrs))
        r_hi = r_lo + rng.integers(1, 48, size=(nr, n_attrs))
        segs.append((q_lo, q_hi, r_lo, r_hi))
    return segs


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
def packed_boxes(torch, rng, n, n_attrs, device, seg=None, spanning=False):
    """Packed [n, 128] int32 boxes.  Up to three attributes discriminate;
    the rest always overlap, so wide masks keep real pairs and every lane
    is read.  ``seg`` puts a segment id in the last attribute (lo = hi).
    ``spanning``: half the rows hold 0 and 1 in every attribute
    (lo <= 0, hi >= 1) and the rest lie in [5, 12], so a row staged as
    zeros past the operands would overlap the first half."""
    p = np.zeros((n, 128), np.int32)
    span = rng.random(n) < 0.5
    for j in range(n_attrs):
        if seg is not None and j == n_attrs - 1:
            lo = seg
            hi = seg
        elif spanning:
            lo = np.where(span, -rng.integers(0, 4, n), 5 + rng.integers(0, 4, n))
            hi = np.where(span, 1 + rng.integers(0, 4, n), lo + rng.integers(0, 4, n))
        elif j < 3:
            lo = rng.integers(0, 60, n)
            hi = lo + rng.integers(0, 8, n)
        else:
            lo = rng.integers(0, 4, n)
            hi = lo + 8
        p[:, j] = lo
        p[:, n_attrs + j] = hi
    return torch.from_numpy(p).to(device)


def checked(err: int) -> None:
    """Raise on a nonzero error code from a raw kernel launcher."""
    if err:
        raise RuntimeError(f"CUDA launch failed with error {err}")


def cuda_samples(torch, fn) -> list:
    """Milliseconds of ``fn`` in each of TIMING_REPS runs (CUDA events),
    after one untimed warm-up.  One call per event pair: what a caller pays,
    the host's launch gap included (``wrapper_ms``, ``plain_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(torch, fn) -> float:
    """Median milliseconds of ``fn`` over TIMING_REPS runs."""
    return float(np.median(cuda_samples(torch, fn)))


class KernelTimer:
    """Kernel time as the card sees it: one CUDA event pair around K
    back-to-back raw launches into a preallocated output, divided by K.

    K is sized so a run lasts about RUN_MS (at most MAX_LAUNCHES), after a
    warm-up.  A sleep kernel queued ahead of each run keeps the card busy
    while the host enqueues the K launches, so the host's gap between two
    launches is never counted as kernel time.  The result is the median of
    TIMING_REPS runs.  With ``before`` (the library built from an earlier
    commit's sources, see ``build_before``) the same launch of the earlier
    kernel is timed in the same call, in the order before, now, now, before.
    """

    def __init__(self, torch, lib, before=None):
        self.torch, self.lib, self.before = torch, lib, before
        torch.cuda._sleep(1000)
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def _run(self, launch, k, host_ms) -> float:
        # the sleep outlasts the host's enqueueing of the k launches
        self.torch.cuda._sleep(int(self.cycles_per_ms * (2.0 * k * host_ms + 0.2)))
        start, end = self._events()
        start.record()
        for _ in range(k):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k

    def _host_ms(self, launch) -> float:
        t0 = time.perf_counter()
        for _ in range(10):
            launch()
        dt = (time.perf_counter() - t0) * 1e3 / 10
        self.torch.cuda.synchronize()
        return dt

    def ms(self, make_launch) -> tuple[float, "float | None"]:
        """Per-launch device ms of ``make_launch(lib)``, and of
        ``make_launch(before)`` where an earlier build is loaded (else
        None)."""
        now = make_launch(self.lib)
        old = make_launch(self.before) if self.before is not None else None
        host = {}
        for name, fn in (("now", now), ("old", old)):
            if fn is not None:
                fn()
                self.torch.cuda.synchronize()
                host[name] = self._host_ms(fn)
        first = self._run(now, 10, host["now"])
        k = int(min(MAX_LAUNCHES, max(1, np.ceil(RUN_MS / first))))
        if old is None:
            rounds = ((now, "now", TIMING_REPS),)
        else:
            half = TIMING_REPS // 2
            rounds = ((old, "old", TIMING_REPS - half), (now, "now", TIMING_REPS - half),
                      (now, "now", half), (old, "old", half))
        samples = {"now": [], "old": []}
        for fn, name, reps in rounds:
            samples[name] += [self._run(fn, k, host[name]) for _ in range(reps)]
        before = float(np.median(samples["old"])) if old is not None else None
        return float(np.median(samples["now"])), before


def plain_blocked(torch, plain, q, r, n_attrs, rows=2048):
    """The plain mask in row blocks, so no intermediate exceeds rows x NR."""
    out = torch.empty((q.shape[0], r.shape[0]), dtype=torch.uint8, device=q.device)
    for s in range(0, q.shape[0], rows):
        out[s : s + rows] = plain(q[s : s + rows], r, n_attrs)
    return out


def needed_compares(torch, q_blocks, r_blocks, n_attrs, rows=2048) -> int:
    """Compares this data needs: per cell, 2 per attribute until the first
    attribute that fails (an attribute is tested only where all earlier
    ones overlapped).  ``q_blocks``/``r_blocks`` are ``[..., N, 128]``."""
    total = 0
    for s in range(0, q_blocks.shape[-2], rows):
        q = q_blocks[..., s : s + rows, :]
        alive = torch.ones(
            q.shape[:-1] + (r_blocks.shape[-2],), dtype=torch.bool, device=q.device
        )
        for j in range(n_attrs):
            total += 2 * int(alive.sum())
            alive &= (q[..., :, j].unsqueeze(-1) <= r_blocks[..., :, n_attrs + j].unsqueeze(-2)) & (
                r_blocks[..., :, j].unsqueeze(-2) <= q[..., :, n_attrs + j].unsqueeze(-1)
            )
    return total


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_mask_kernel(torch, rj, ref, timer, q, r, n_attrs, label, timed=True):
    """Hold ``range_join_mask`` on ``q``/``r`` against its plain version
    (exact); with ``timed``, time the kernel (``KernelTimer``), the wrapper
    and the plain version."""
    dev = "cuda"
    nq, nr = q.shape[0], r.shape[0]
    got = rj.range_join_mask(q, r, n_attrs=n_attrs)
    want = plain_blocked(torch, ref.range_join_mask_ref, q, r, n_attrs)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"range_join_mask differs from plain at {label}")
    rec = {"shape": label, "max_abs_err": err}
    if not timed:
        return rec
    out = torch.empty((nq, nr), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms, ms_before = timer.ms(lambda L: lambda: checked(L.rj_range_join_mask(
        q.data_ptr(), r.data_ptr(), out.data_ptr(), nq, nr, n_attrs, stream
    )))
    wrapper_ms = cuda_ms(torch, lambda: rj.range_join_mask(q, r, n_attrs=n_attrs))
    plain_ms = cuda_ms(
        torch, lambda: plain_blocked(torch, ref.range_join_mask_ref, q, r, n_attrs)
    )
    ops = needed_compares(torch, q, r, n_attrs)
    bytes_moved = (nq + nr) * 2 * n_attrs * 4 + nq * nr
    b_ms, b_by = bound(bytes_moved, ops)
    log(
        f"  range_join_mask {label}: equal pairs={int(got.sum())} "
        f"kernel={ms:.4f}ms before={fmt_ms(ms_before)} wrapper={wrapper_ms:.4f}ms "
        f"plain={plain_ms:.4f}ms bound={b_ms:.4f}ms ({b_by}) bytes={bytes_moved} "
        f"compares={ops}"
    )
    rec.update({"ms": ms, "ms_before": ms_before, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    return rec


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}ms"


def check_mask_stores(torch, ref, lib, q, r, n_attrs, offset, label):
    """A raw launch into an output ``offset`` bytes past a 16-byte boundary
    (so at every store width the kernel has) writes the mask's bytes and
    not one byte around them."""
    nq, nr = q.shape[0], r.shape[0]
    buf = torch.full((nq * nr + 64,), 0xEE, dtype=torch.uint8, device="cuda")
    start = 16 + offset
    checked(lib.rj_range_join_mask(
        q.data_ptr(), r.data_ptr(), buf[start:].data_ptr(), nq, nr, n_attrs,
        torch.cuda.current_stream().cuda_stream,
    ))
    want = ref.range_join_mask_ref(q, r, n_attrs).reshape(-1)
    if not (torch.equal(buf[start : start + nq * nr], want)
            and bool((buf[:start] == 0xEE).all())
            and bool((buf[start + nq * nr :] == 0xEE).all())):
        raise AssertionError(f"range_join_mask stores at {label} offset {offset}")


def synthetic_mask(torch, rj, ref, timer, rng, nq, nr, n_attrs, seg_lane=False,
                   spanning=False, timed=True):
    seg_q = np.sort(rng.integers(0, 4, nq)) if seg_lane else None
    seg_r = np.sort(rng.integers(0, 4, nr)) if seg_lane else None
    q = packed_boxes(torch, rng, nq, n_attrs, "cuda", seg_q, spanning)
    r = packed_boxes(torch, rng, nr, n_attrs, "cuda", seg_r, spanning)
    label = (f"{nq}x{nr}x{n_attrs}" + ("+seg" if seg_lane else "")
             + ("+span" if spanning else ""))
    return check_mask_kernel(torch, rj, ref, timer, q, r, n_attrs, label, timed)


def plain_tiles(torch, ref, q, r, tq, tr, n_attrs, bq, br, tiles=512):
    """The plain tile masks in schedule blocks of ``tiles``, so no
    intermediate exceeds ``tiles`` x bq x br."""
    out = torch.empty((tq.shape[0], bq, br), dtype=torch.uint8, device=q.device)
    for s in range(0, tq.shape[0], tiles):
        out[s : s + tiles] = ref.range_join_tile_masks_ref(
            q, r, tq[s : s + tiles], tr[s : s + tiles], n_attrs, bq, br
        )
    return out


def tile_compares(torch, q, r, tq, tr, n_attrs, bq, br, tiles=512) -> int:
    """``needed_compares`` over the scheduled tiles, in blocks of ``tiles``."""
    total = 0
    for s in range(0, tq.shape[0], tiles):
        total += needed_compares(
            torch, q.reshape(-1, bq, 128)[tq[s : s + tiles].long()],
            r.reshape(-1, br, 128)[tr[s : s + tiles].long()], n_attrs,
        )
    return total


def check_tile_kernel(torch, rj, ref, timer, q, r, tq_host, tr_host, n_attrs, bq, br, label,
                      pairs=None):
    """Hold ``range_join_tile_masks`` on packed ``q``/``r`` and the host
    schedule ``tq_host``/``tr_host`` against its plain version (exact) and
    time the kernel, the wrapper and the plain version; ``pairs``, where
    given, is the whole pair pipeline of the same frontier
    (``segmented_range_join_pairs``: pack, upload, launch, extraction),
    timed too."""
    dev = "cuda"
    # the wrapper takes the schedule on the host; the raw launcher and the
    # plain version read it on the card
    tq, tr = tq_host.to(dev), tr_host.to(dev)

    def kernel():
        return rj.range_join_tile_masks(
            q, r, tq_host, tr_host, n_attrs=n_attrs, block_q=bq, block_r=br
        )

    def plain():
        return plain_tiles(torch, ref, q, r, tq, tr, n_attrs, bq, br)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"range_join_tile_masks differs from plain at {label}")
    n_pairs = int(got.sum())
    del got, want
    n_tiles = int(tq.shape[0])
    out = torch.empty((n_tiles, bq, br), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms, ms_before = timer.ms(lambda L: lambda: checked(L.rj_range_join_tile_masks(
        q.data_ptr(), r.data_ptr(), tq.data_ptr(), tr.data_ptr(), out.data_ptr(),
        n_tiles, bq, br, n_attrs, stream,
    )))
    del out
    wrapper_ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain)
    ops = tile_compares(torch, q, r, tq, tr, n_attrs, bq, br)
    rows = q.shape[0] + r.shape[0]
    bytes_moved = rows * 2 * n_attrs * 4 + n_tiles * 8 + n_tiles * bq * br
    b_ms, b_by = bound(bytes_moved, ops)
    rec = {"shape": label, "ms": ms, "ms_before": ms_before, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "cells": n_tiles * bq * br}
    pipeline = ""
    if pairs is not None:
        pair_times = cuda_samples(torch, pairs)
        rec["pipeline_ms"] = float(np.median(pair_times))
        pipeline = (f"pipeline={rec['pipeline_ms']:.4f}ms "
                    f"[{min(pair_times):.4f}-{max(pair_times):.4f}] ")
    log(
        f"  range_join_tile_masks {label}: equal pairs={n_pairs} "
        f"kernel={ms:.4f}ms before={fmt_ms(ms_before)} wrapper={wrapper_ms:.4f}ms "
        f"plain={plain_ms:.4f}ms {pipeline}"
        f"bound={b_ms:.4f}ms ({b_by}) bytes={bytes_moved} compares={ops}"
    )
    return rec


def check_frontier(torch, rj, ref, timer, ops_mod, segs, n_attrs, bq, br, name):
    """``check_tile_kernel`` on the block-diagonal schedule of the frontier
    ``segs`` at ``bq`` x ``br``, with its pair pipeline timed."""
    sched = ops_mod._blockdiag_schedule(segs, n_attrs, bq, br)
    q = torch.from_numpy(sched.q).to("cuda")
    r = torch.from_numpy(sched.r).to("cuda")
    rows = sched.q.shape[0] + sched.r.shape[0]
    label = f"{name} {len(segs)}seg/{rows}rows/{len(sched.tile_q)}tiles@{bq}x{br}"
    return check_tile_kernel(
        torch, rj, ref, timer, q, r, host_i32(torch, sched.tile_q),
        host_i32(torch, sched.tile_r), n_attrs, bq, br, label,
        pairs=lambda: ops_mod.segmented_range_join_pairs(
            segs, block_q=bq, block_r=br, device="cuda", layout="blockdiag"
        ),
    )


def diagonal_schedule(torch, n_seg, rows, bq, br):
    """The block-diagonal schedule of ``n_seg`` segments of ``rows`` q and
    ``rows`` r rows each (multiples of the block sizes), segment-major, q
    block outer and r block inner, as ``ops._blockdiag_schedule`` builds
    it: host int32 (tile_q, tile_r)."""
    nqb, nrb = rows // bq, rows // br
    seg = np.repeat(np.arange(n_seg), nqb * nrb)
    within = np.tile(np.arange(nqb * nrb), n_seg)
    tq = seg * nqb + within // nrb
    tr = seg * nrb + within % nrb
    return host_i32(torch, tq), host_i32(torch, tr)


def host_i32(torch, a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def synthetic_schedule(torch, rj, ref, timer, rng, n_seg, rows, n_attrs, bq=256, br=256):
    """``check_tile_kernel`` on ``n_seg`` made-up segments of ``rows`` x
    ``rows`` boxes (``packed_boxes``), block-diagonal at ``bq`` x ``br``."""
    q = packed_boxes(torch, rng, n_seg * rows, n_attrs, "cuda")
    r = packed_boxes(torch, rng, n_seg * rows, n_attrs, "cuda")
    tq, tr = diagonal_schedule(torch, n_seg, rows, bq, br)
    label = f"{n_seg}seg x {rows}x{rows}x{n_attrs}/{tq.shape[0]}tiles@{bq}x{br}"
    return check_tile_kernel(torch, rj, ref, timer, q, r, tq, tr, n_attrs, bq, br, label)


def tile_operands(torch, rng, n_attrs, bq, br, nqb, nrb, pads):
    """Packed q and r of ``nqb`` / ``nrb`` blocks: boxes that hold 0 and 1
    and ordinary ones, the last ``pads`` rows of each side the host's pad
    rows (lo = 1, hi = 0), which the first kind overlap."""
    out = []
    for n in (nqb * bq, nrb * br):
        p = packed_boxes(torch, rng, n, n_attrs, "cuda", spanning=True)
        p[n - pads :] = 0
        p[n - pads :, :n_attrs] = 1
        out.append(p)
    return out


def check_tile_stores(torch, ref, lib, q, r, tq, tr, n_attrs, bq, br, offset, label):
    """A raw launch of the schedule ``tq``/``tr`` (on the card) into an
    output ``offset`` bytes past a 16-byte boundary writes the tiles' bytes
    and not one byte around them."""
    n = tq.shape[0] * bq * br
    buf = torch.full((n + 64,), 0xEE, dtype=torch.uint8, device="cuda")
    start = 16 + offset
    checked(lib.rj_range_join_tile_masks(
        q.data_ptr(), r.data_ptr(), tq.data_ptr(), tr.data_ptr(), buf[start:].data_ptr(),
        tq.shape[0], bq, br, n_attrs, torch.cuda.current_stream().cuda_stream,
    ))
    want = plain_tiles(torch, ref, q, r, tq, tr, n_attrs, bq, br).reshape(-1)
    if not (torch.equal(buf[start : start + n], want)
            and bool((buf[:start] == 0xEE).all())
            and bool((buf[start + n :] == 0xEE).all())):
        raise AssertionError(f"range_join_tile_masks stores at {label} offset {offset}")


def tile_sweep(torch, rj, ref, lib, rng) -> int:
    """The tile kernel exact at every width of TILE_WIDTHS and block size of
    TILE_SIZES (boxes against pad rows, every block pair and repeats, raw
    launches at each output alignment with guard bytes), at T = 1, and at
    T past one wave; returns the count of launches checked."""
    offsets = (0, 1, 2, 4, 8)
    checks = 0
    for i, (bq, br) in enumerate(TILE_SIZES):
        for j, a in enumerate(TILE_WIDTHS):
            q, r = tile_operands(torch, rng, a, bq, br, 2, 3, pads=5)
            tq = np.concatenate([np.repeat(np.arange(2), 3), rng.integers(0, 2, 5)])
            tr = np.concatenate([np.tile(np.arange(3), 2), rng.integers(0, 3, 5)])
            tq, tr = host_i32(torch, tq), host_i32(torch, tr)
            check_tile_stores(torch, ref, lib, q, r, tq.cuda(), tr.cuda(), a, bq, br,
                              offsets[(i + j) % len(offsets)], f"{bq}x{br}x{a}")
            got = rj.range_join_tile_masks(q, r, tq, tr, n_attrs=a, block_q=bq, block_r=br)
            if not torch.equal(got, plain_tiles(torch, ref, q, r, tq.cuda(), tr.cuda(),
                                                a, bq, br)):
                raise AssertionError(f"range_join_tile_masks differs from plain at {bq}x{br}x{a}")
            checks += 2
    for n_tiles, bq, br, a in ((1, 256, 256, 2), (1, 96, 160, 5), (700, 64, 64, 2),
                               (700, 64, 64, 9), (2000, 256, 256, 4)):
        q, r = tile_operands(torch, rng, a, bq, br, 4, 5, pads=3)
        tq = host_i32(torch, rng.integers(0, 4, n_tiles)).cuda()
        tr = host_i32(torch, rng.integers(0, 5, n_tiles)).cuda()
        for offset in (0, 1):
            check_tile_stores(torch, ref, lib, q, r, tq, tr, a, bq, br, offset,
                              f"T={n_tiles} {bq}x{br}x{a}")
            checks += 1
    return checks


class MainPathRecorder:
    """Keeps the operands the main path hands the kernels, so that phase 6
    holds each kernel against its plain version on exactly those inputs.

    It wraps ``ops``' own references to the mask wrapper and to the
    block-diagonal scheduler; the wrappers still count every launch, and
    recording launches nothing.  ``phase`` tags what is recorded.  It also
    keeps, per workflow (``workflow``, set while phase 3 ingests one), the
    inputs of ProvRC's first step-1 pass on its largest relation
    (``provrc._step1_pass``, ``provrc.py:142-143``): phase 8 runs the
    run-boundary kernel on the rows that pass sorts.
    """

    def __init__(self, ops_mod, provrc_mod):
        self.ops = ops_mod
        self.provrc = provrc_mod
        self.phase = None
        self.workflow = None
        self.mask_shapes: dict = {}  # phase -> [(nq, nr, n_attrs)]
        self.mask_first: dict = {}  # phase -> (q, r, n_attrs)
        self.mask_largest: dict = {}  # phase -> (q, r, n_attrs)
        self.frontiers: list = []  # (phase, segments, n_attrs, block_q, block_r)
        self.step1: dict = {}  # workflow -> _step1_pass arguments
        self._orig = (ops_mod.range_join_mask, ops_mod._blockdiag_schedule,
                      provrc_mod._step1_pass)

    def __enter__(self):
        mask, schedule, step1 = self._orig

        def record_mask(q, r, *, n_attrs):
            ph = self.phase
            self.mask_shapes.setdefault(ph, []).append((q.shape[0], r.shape[0], n_attrs))
            self.mask_first.setdefault(ph, (q, r, n_attrs))
            big = self.mask_largest.get(ph)
            if big is None or q.shape[0] * r.shape[0] > big[0].shape[0] * big[1].shape[0]:
                self.mask_largest[ph] = (q, r, n_attrs)
            return mask(q, r, n_attrs=n_attrs)

        def record_schedule(segments, n_attrs, block_q, block_r):
            self.frontiers.append((self.phase, segments, n_attrs, block_q, block_r))
            return schedule(segments, n_attrs, block_q, block_r)

        def record_step1(key_lo, key_hi, val_lo, val_hi, val_ref, i):
            # compress() runs its passes from the last value attribute down:
            # i == m - 1 is the first, on the relation's unmerged rows
            wf = self.workflow
            if wf is not None and i == val_lo.shape[1] - 1:
                best = self.step1.get(wf)
                if best is None or val_lo.shape[0] > best[2].shape[0]:
                    self.step1[wf] = (key_lo, key_hi, val_lo, val_hi, val_ref, i)
            return step1(key_lo, key_hi, val_lo, val_hi, val_ref, i)

        self.ops.range_join_mask = record_mask
        self.ops._blockdiag_schedule = record_schedule
        self.provrc._step1_pass = record_step1
        return self

    def __exit__(self, *exc):
        (self.ops.range_join_mask, self.ops._blockdiag_schedule,
         self.provrc._step1_pass) = self._orig


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #
def phase_kernels(torch, rj, ref, timer, ops_mod) -> dict:
    rng = np.random.default_rng(0)
    records = {"range_join_mask": [], "range_join_tile_masks": []}
    masks = records["range_join_mask"]
    # exact, untimed: row counts around the mask kernel's 64 x 256 block tile
    # and its 16-byte stores (every other shape with boxes that hold 0 and
    # 1), widths around its four-attribute passes, the segment lane, and
    # raw launches at every output alignment
    for i, nq in enumerate(MASK_EDGES):
        for j, nr in enumerate(MASK_EDGES):
            masks.append(synthetic_mask(torch, rj, ref, timer, rng, nq, nr, 1,
                                        spanning=(i + j) % 2 == 1, timed=False))
    for k, a in enumerate(MASK_WIDTHS):
        masks.append(synthetic_mask(torch, rj, ref, timer, rng, 65, 1000, a,
                                    spanning=k % 2 == 1, timed=False))
    for nq, nr, a in ((65, 257, 2), (200, 513, 17), (70, 300, 64)):
        masks.append(synthetic_mask(torch, rj, ref, timer, rng, nq, nr, a,
                                    seg_lane=True, timed=False))
    for offset in (0, 1, 2, 4, 8):
        for nq, nr in ((65, 1000), (64, 257), (1, 255)):
            q = packed_boxes(torch, rng, nq, 2, "cuda", spanning=True)
            r = packed_boxes(torch, rng, nr, 2, "cuda", spanning=True)
            check_mask_stores(torch, ref, timer.lib, q, r, 2, offset, f"{nq}x{nr}x2")
    log(f"  range_join_mask: {len(masks)} shapes and 15 raw launches exact "
        f"(rows {MASK_EDGES}, widths {MASK_WIDTHS}, segment lane, spanning boxes)")
    for shape in ((1, 1, 3), (200, 20_000, 2), (3000, 20_000, 2), (20_000, 20_000, 4),
                  (2000, 3000, 64)):
        masks.append(synthetic_mask(torch, rj, ref, timer, rng, *shape))
    masks.append(synthetic_mask(torch, rj, ref, timer, rng, 2000, 3000, 64, seg_lane=True))
    # the block-diagonal layout: exact over widths, block sizes, pad rows and
    # output alignments; timed on the accel ablation's ragged frontier (24
    # segments of 96-224 rows a side, ~7,800 rows, 2 attributes) and on
    # TILE_SCHEDULES, the first beside the mask's 20,000 x 20,000 x 4 per cell
    tiles = records["range_join_tile_masks"]
    checks = tile_sweep(torch, rj, ref, timer.lib, rng)
    log(f"  range_join_tile_masks: {checks} launches exact (widths {TILE_WIDTHS}, "
        f"sizes {TILE_SIZES}, pad rows, repeated tiles, T = 1 to 2000, guard bytes)")
    segs = ragged_frontier(24, 96, 224, n_attrs=2, seed=11)
    for g in (64, 128, 256):
        tiles.append(check_frontier(torch, rj, ref, timer, ops_mod, segs, 2, g, g, "ragged"))
    for n_seg, rows, a in TILE_SCHEDULES:
        tiles.append(synthetic_schedule(torch, rj, ref, timer, rng, n_seg, rows, a))
    full = tiles[-len(TILE_SCHEDULES)]
    mask = next(m for m in masks if m["shape"] == "20000x20000x4")
    ratio = (full["ms"] / full["cells"]) / (mask["ms"] / 4e8)
    full["per_cell_vs_mask"] = ratio
    log(f"  tile kernel ms per cell at {full['shape']} / mask's at 20000x20000x4: "
        f"{ratio:.3f}" + (f" (before: {(full['ms_before'] / full['cells']) / (mask['ms_before'] / 4e8):.3f})"
                          if full["ms_before"] is not None else ""))
    return records


def phase_main_operands(torch, rj, ref, timer, ops_mod, seen) -> tuple[dict, dict]:
    """Each kernel against its plain version on the operands the main path
    gave it: phase 3's largest mask and phase 5's first, and every phase 4
    frontier at the geometry it ran, the first one also at each size of
    TILE_GEOMETRIES, twice.  Returns, per kernel, the record that stands
    for the main path (phase 5's mask, phase 4's first frontier) and all
    records."""
    records = {"range_join_mask": [], "range_join_tile_masks": []}
    main = {}
    shapes = seen.mask_shapes.get(3, [])
    if shapes:
        cells = sorted(nq * nr for nq, nr, _ in shapes)
        log(f"  phase 3 mask launches: {len(shapes)}, nq*nr median "
            f"{cells[len(cells) // 2]}, max {cells[-1]}")
        q, r, a = seen.mask_largest[3]
        records["range_join_mask"].append(check_mask_kernel(
            torch, rj, ref, timer, q, r, a, f"phase3-largest {q.shape[0]}x{r.shape[0]}x{a}"
        ))
    if 5 not in seen.mask_first:
        raise AssertionError("phase 5 launched no range_join_mask")
    q, r, a = seen.mask_first[5]
    main["range_join_mask"] = check_mask_kernel(
        torch, rj, ref, timer, q, r, a, f"phase5 {q.shape[0]}x{r.shape[0]}x{a}"
    )
    records["range_join_mask"].append(main["range_join_mask"])
    fronts = [f for f in seen.frontiers if f[0] == 4]
    if not fronts:
        raise AssertionError("phase 4 launched no block-diagonal frontier")
    for i, (_, segs, n_attrs, bq, br) in enumerate(fronts):
        rec = check_frontier(
            torch, rj, ref, timer, ops_mod, segs, n_attrs, bq, br, f"phase4-wave{i}"
        )
        records["range_join_tile_masks"].append(rec)
        main.setdefault("range_join_tile_masks", rec)
    # the sweep runs twice, the second time in reverse order, so a size's
    # place in the run cannot pass for its own cost
    _, segs, n_attrs, _, _ = fronts[0]
    for sweep, order in (("pass1", TILE_GEOMETRIES), ("pass2", TILE_GEOMETRIES[::-1])):
        for g in order:
            records["range_join_tile_masks"].append(check_frontier(
                torch, rj, ref, timer, ops_mod, segs, n_attrs, *g, f"phase4-wave0 {sweep}"
            ))
    return main, records


def register_workflow(store, wf_name, rels, reuse):
    """Define the workflow's arrays and register its operations; returns
    the array path."""
    names = [f"{wf_name}_a0"]
    store.define_array(names[0], rels[0].in_shape)
    for k, rel in enumerate(rels):
        names.append(f"{wf_name}_a{k + 1}")
        store.define_array(names[k + 1], rel.out_shape)
        store.register_operation(
            f"{wf_name}_op{k}", [names[k]], [names[k + 1]],
            capture=lambda r=rel: {(0, 0): r}, reuse=reuse,
        )
    return names


def query_cells(in_shape, sel):
    k = max(1, int(int(np.prod(in_shape)) * sel))
    return np.stack(np.unravel_index(np.arange(k), in_shape), axis=1)


def fig89_queries(store, wf_name, names, in_shape) -> tuple[dict, dict]:
    """Phase 3's six path-form queries on one workflow: the answers and the
    milliseconds of each, keyed ``(workflow, selectivity, merge)``."""
    answers, ms = {}, {}
    for sel in SELECTIVITIES:
        cells = query_cells(in_shape, sel)
        for merge in (True, False):
            t1 = time.perf_counter()
            answers[(wf_name, sel, merge)] = store.prov_query(names, cells, merge=merge)
            ms[(wf_name, sel, merge)] = (time.perf_counter() - t1) * 1e3
    return answers, ms


def same_box(got, want) -> bool:
    return (got.shape == want.shape and got.lo.tobytes() == want.lo.tobytes()
            and got.hi.tobytes() == want.hi.tobytes())


def check_answers(got: dict, want: dict, what: str) -> None:
    for key, box in got.items():
        if not same_box(box, want[key]):
            raise AssertionError(f"{what}: answer {key} differs from phase 3's")


def check_sharded_answers(got: dict, want: dict, what: str) -> None:
    """A sharded store's answers against phase 3's: the same boxes where
    merged, the same cells where not (a frontier that crosses shards ships
    merged, as the reference's ``ShardedQueryPlanner`` does)."""
    for key, box in got.items():
        merge = key[-1]
        same = (same_box(box, want[key]) if merge else
                np.array_equal(box_flat_cells(box), box_flat_cells(want[key])))
        if not same:
            raise AssertionError(f"{what}: answer {key} differs from phase 3's")


def phase_fig89(core, C, sizes, device, seen) -> tuple[dict, float]:
    """One in-memory store per workflow, answers checked against the
    raw-join oracle; returns the answers and the summed ingest seconds."""
    all_answers, ingest = {}, 0.0
    for wf_name, rels in fig89_workflows(C, *sizes):
        t0 = time.perf_counter()
        store = core.DSLog(store_forward=True, device=device)
        seen.workflow = wf_name
        names = register_workflow(store, wf_name, rels, reuse=False)
        seen.workflow = None
        t_ingest = time.perf_counter() - t0
        ingest += t_ingest
        answers, ms = fig89_queries(store, wf_name, names, rels[0].in_shape)
        for (_, sel, merge), res in answers.items():
            want = forward_join_rows(rels, query_cells(rels[0].in_shape, sel))
            got = box_flat_cells(res)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{wf_name} sel={sel} merge={merge}: {got.size} cells "
                    f"vs oracle {want.size}"
                )
        all_answers.update(answers)
        line = [f"{sel}/{'m' if merge else 'nm'}={t:.1f}ms" for (_, sel, merge), t in ms.items()]
        log(
            f"  {wf_name:14s} ingest={t_ingest:.2f}s storage={store.storage_bytes()}B "
            + " ".join(line)
        )
    return all_answers, ingest


def accel_cells(shape, n_cells):
    rng = np.random.default_rng(7)
    flat = rng.choice(int(np.prod(shape)), size=n_cells, replace=False)
    return np.stack(np.unravel_index(flat, shape), axis=1)


def phase_accel(core, shape, branches, hops, n_cells, device):
    """Returns the store and its batched answer (phase 7 compares with
    both)."""
    store = core.DSLog(store_forward=True, device=device)
    # the two engines answer the same query: keep the answer cache out of it
    store.views.enabled = False
    chains = build_accel_dag(store, core.LineageRelation, shape, branches, hops)
    n = int(np.prod(shape))
    cells = accel_cells(shape, n_cells)
    t0 = time.perf_counter()
    want = store.prov_query("src", "out", cells, batched=False)
    t_perhop = time.perf_counter() - t0
    before = dict(store.io_stats)
    t0 = time.perf_counter()
    got = store.prov_query("src", "out", cells, batched=True)
    t_batched = time.perf_counter() - t0
    after = dict(store.io_stats)
    if got.lo.tobytes() != want.lo.tobytes() or got.hi.tobytes() != want.hi.tobytes():
        raise AssertionError("accel DAG: batched and per-hop results differ")
    # oracle: each branch maps the query cells through its bijections
    expect = set()
    for chain in chains:
        cur = np.ravel_multi_index(cells.T, shape)
        for rel in chain:
            fwd = np.empty(n, np.int64)
            fwd[np.ravel_multi_index(rel.in_idx.T, shape)] = np.ravel_multi_index(
                rel.out_idx.T, shape
            )
            cur = fwd[cur]
        expect.update(cur.tolist())
    if set(box_flat_cells(got).tolist()) != expect:
        raise AssertionError("accel DAG: answer differs from the bijection oracle")
    launches = after["kernel_launches"] - before["kernel_launches"]
    tiles = after["batch_tiles_visited"] - before["batch_tiles_visited"]
    if launches <= 0 or tiles <= 0:
        raise AssertionError(f"accel DAG: kernel_launches={launches} tiles={tiles}")
    log(
        f"  accel {shape} x{branches} branches: perhop={t_perhop * 1e3:.1f}ms "
        f"batched={t_batched * 1e3:.1f}ms kernel_launches={launches} "
        f"tiles_visited={tiles} tiles_skipped="
        f"{after['batch_tiles_skipped'] - before['batch_tiles_skipped']} "
        f"answer_rows={got.n_rows}"
    )
    return store, got


def phase_perhop_dense(core, n_rows, n_queries, boxes, device) -> None:
    table = scatter_table(core.compress, core.LineageRelation, n_rows, seed=0)
    rng = np.random.default_rng(5)
    for i in range(n_queries):
        rows = rng.integers(0, n_rows - 4, boxes)
        cols = rng.integers(0, 60, boxes)
        lo = np.stack([rows, cols], axis=1)
        hi = lo + np.stack([rng.integers(0, 3, boxes), rng.integers(0, 4, boxes)], axis=1)
        q = core.QueryBox(table.key_shape, lo, hi)
        dense = core.theta_join(q, table, path="dense", device=device)
        index = core.theta_join(q, table, path="index", device=device)
        if dense.lo.tobytes() != index.lo.tobytes() or dense.hi.tobytes() != index.hi.tobytes():
            raise AssertionError(f"per-hop dense differs from index (query {i})")
    log(
        f"  scatter table {table.n_rows} rows, {n_queries} queries x {boxes} boxes: "
        "dense == index"
    )


def dir_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))


def fsync_stats(store) -> tuple[int, float]:
    """Count and p99 seconds of the store's WAL fsyncs."""
    for row in store.metrics_snapshot()["histograms"]:
        if row["name"] == "wal_fsync_seconds" and not row["labels"]:
            return row["count"], row["p99"]
    return 0, 0.0


def run_fig89_queries(store, paths) -> tuple[dict, float]:
    answers, total_ms = {}, 0.0
    for wf_name, (names, in_shape) in paths.items():
        got, ms = fig89_queries(store, wf_name, names, in_shape)
        answers.update(got)
        total_ms += sum(ms.values())
    return answers, total_ms


def phase_store(core, C, sizes, p3, accel, device, workdir) -> dict:
    """The durable store at phase 3's and phase 4's sizes (see the module
    doc, phase 7).  ``p3`` is phase 3's (answers, ingest seconds); ``accel``
    phase 4's (store, answer, shape, branches, hops, n_cells)."""
    p3_answers, p3_ingest = p3
    flows = fig89_workflows(C, *sizes)
    root = os.path.join(workdir, "fig89")
    t0 = time.perf_counter()
    store = core.DSLog.open(root, durability="group", device=device)
    paths = {
        wf: (register_workflow(store, wf, rels, reuse=None), rels[0].in_shape)
        for wf, rels in flows
    }
    store.commit()
    t_ingest = time.perf_counter() - t0
    n_fsync, fsync_p99 = fsync_stats(store)
    answers, first_ms = run_fig89_queries(store, paths)
    check_answers(answers, p3_answers, "durable store")
    t0 = time.perf_counter()
    store.close()  # checkpoint: incremental save + log truncation
    t_checkpoint = time.perf_counter() - t0
    log(f"  ingest durable={t_ingest:.2f}s in-memory={p3_ingest:.2f}s "
        f"fsyncs={n_fsync} fsync_p99={fsync_p99 * 1e3:.3f}ms "
        f"queries={first_ms:.1f}ms checkpoint={t_checkpoint:.3f}s")

    t0 = time.perf_counter()
    store = core.DSLog.open(root, durability="group", device=device)
    t_reopen = time.perf_counter() - t0
    cold, cold_ms = run_fig89_queries(store, paths)
    loaded = store.io_stats["tables_loaded"]
    warm, warm_ms = run_fig89_queries(store, paths)
    check_answers(cold, p3_answers, "reopened store (cold)")
    check_answers(warm, p3_answers, "reopened store (warm)")
    if loaded <= 0:
        raise AssertionError("the reopened store loaded no table")
    log(f"  reopen={t_reopen:.3f}s cold={cold_ms:.1f}ms warm={warm_ms:.1f}ms "
        f"tables_loaded={loaded} (54 queries each)")

    # one more workflow, then a crash: only the WAL holds it
    extra, rels = random_workflow(C, 5, len(flows), sizes[4])
    extra_path = register_workflow(store, extra, rels, reuse=None)
    store.commit()
    store.close(checkpoint=False)
    t0 = time.perf_counter()
    store = core.DSLog.load(root, device=device)
    t_recover = time.perf_counter() - t0
    replayed = dict(store.io_stats).get("wal_replayed", 0)
    if replayed <= 0:
        raise AssertionError("load() replayed no WAL record after the crash")
    again, _ = run_fig89_queries(store, paths)
    check_answers(again, p3_answers, "recovered store")
    got, _ = fig89_queries(store, extra, extra_path, rels[0].in_shape)
    for (_, sel, _), res in got.items():
        want = forward_join_rows(rels, query_cells(rels[0].in_shape, sel))
        if not np.array_equal(box_flat_cells(res), want):
            raise AssertionError(f"recovered store: {extra} sel={sel} differs from the oracle")
    disk = dir_bytes(root)
    log(f"  crash+load={t_recover:.3f}s wal_replayed={replayed} "
        f"bytes_on_disk={disk} storage_bytes={store.storage_bytes()}")

    # phase 4's accel DAG, durable: its query, then a hot two-hop route
    ref_store, ref_answer, shape, branches, hops, n_cells = accel
    aroot = os.path.join(workdir, "accel")
    astore = core.DSLog.open(aroot, durability="group", device=device)
    build_accel_dag(astore, core.LineageRelation, shape, branches, hops)
    astore.commit()
    if not same_box(astore.prov_query("src", "out", accel_cells(shape, n_cells)), ref_answer):
        raise AssertionError("durable accel DAG: answer differs from phase 4's")
    route = ("src", "b0h1")
    rng = np.random.default_rng(11)
    n = int(np.prod(shape))

    def route_query():
        cells = np.stack(np.unravel_index(rng.choice(n, 32, replace=False), shape), axis=1)
        t1 = time.perf_counter()
        res = astore.prov_query(*route, cells)
        dt = (time.perf_counter() - t1) * 1e3
        if not same_box(res, ref_store.prov_query(*route, cells)):
            raise AssertionError(f"durable accel DAG: route {route} differs from phase 4's")
        return cells, res, dt

    miss_ms = []
    for _ in range(8):
        _, _, dt = route_query()
        miss_ms.append(dt)
        if astore.io_stats["views_materialized"] >= 1 and astore.io_stats["view_hits"] >= 1:
            break
    hits = astore.io_stats["view_hits"]
    cells, res, view_ms = route_query()
    if astore.io_stats["view_hits"] <= hits:
        raise AssertionError("durable accel DAG: the view was not hit")
    t1 = time.perf_counter()
    again = astore.prov_query(*route, cells)
    cache_ms = (time.perf_counter() - t1) * 1e3
    if not same_box(again, res) or astore.io_stats["cache_hits"] < 1:
        raise AssertionError("durable accel DAG: the repeat was not served from the cache")
    views = {k: astore.io_stats[k] for k in ("views_materialized", "view_hits", "cache_hits")}
    astore.close()
    log(f"  accel durable: route {route[0]}->{route[1]} planned "
        f"{' '.join(f'{t:.1f}' for t in miss_ms)}ms, view-hit={view_ms:.2f}ms "
        f"cache-hit={cache_ms:.3f}ms {views}")
    return {
        "ingest_s": t_ingest, "ingest_in_memory_s": p3_ingest, "fsyncs": n_fsync,
        "fsync_p99_s": fsync_p99, "checkpoint_s": t_checkpoint, "reopen_s": t_reopen,
        "cold_ms": cold_ms, "warm_ms": warm_ms, "view_hit_ms": view_ms,
        "cache_hit_ms": cache_ms, "bytes_on_disk": disk, "wal_replayed": replayed,
    }


# --------------------------------------------------------------------------- #
# The sharded store (phase 9)
# --------------------------------------------------------------------------- #
def accel_pins(branches, hops, n_shards):
    """Affinity pins that spread the accel DAG's branches over the shards."""
    pins = {"src": 0, "out": 1 % n_shards}
    for b in range(branches):
        for h in range(hops):
            pins[f"b{b}h{h}"] = b % n_shards
    return pins


def first_cells(shape, n=16):
    return np.stack(np.unravel_index(np.arange(min(n, int(np.prod(shape)))), shape), axis=1)


def jacobian_twins(torch):
    """``oplib`` ops and their torch functions (with each operand's shape
    from the op's first registry shape), for phase 9e."""
    return {
        "exp": (torch.exp, lambda s: [s]),
        "add": (lambda a, b: a + b, lambda s: [s, s]),
        "mul_rowvec": (lambda a, v: a * v, lambda s: [s, (s[-1],)]),
        "sum_axis1": (lambda x: x.sum(dim=1), lambda s: [s]),
        "softmax": (lambda x: torch.softmax(x, -1), lambda s: [s]),
        "matmul": (lambda a, b: a @ b, lambda s: [s, (s[1], s[1] + 2)]),
        "transpose": (lambda x: x.T, lambda s: [s]),
        "tile": (lambda x: torch.tile(x, (2, 2)), lambda s: [s]),
        "roll": (lambda x: torch.roll(x, 2, 0), lambda s: [s]),
    }


def phase_sharded(torch, core, C, oplib, fsck, wrappers, card, sizes, p3, accel, store_roots,
                  workdir) -> dict:
    """The sharded store at phase 3's and phase 4's sizes (module doc, phase
    9).  ``p3`` is phase 3's (answers, ingest seconds), ``accel`` phase 4's
    (store, answer, shape, branches, hops, n_cells), ``store_roots`` phase
    7's store directories.  Returns each step's numbers."""
    p3_answers = p3[0]
    steps = {}

    def step(name, kernel, fn):
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        if kernel is not None and launched[kernel] <= 0:
            raise AssertionError(f"phase 9{name}: {kernel} never launched")
        nums = " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) and k.endswith("_s")
            else f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in out.items()
        )
        log(f"[phase 9{name}] wall={wall:.2f}s {nums} "
            + " ".join(f"{k}+={v}" for k, v in launched.items()) + f" | {card}")
        steps[name] = {"wall_s": wall, **out, "launches": launched}

    flows = fig89_workflows(C, *sizes)
    root = os.path.join(workdir, "sharded")
    state = {}

    def ingest_and_query():
        store = core.ShardedDSLog.open(root, n_shards=SHARDS, device="cuda")
        paths = {
            wf: (register_workflow(store, wf, rels, reuse=None), rels[0].in_shape)
            for wf, rels in flows
        }
        # an in-place update of the first workflow's output, logged as a
        # new version (DSLog.version): an array's versions share its shard,
        # so this hop's plan touches one shard (phase 9c loads only it)
        out = paths[flows[0][0]][0][-1]
        inplace = store.version(out)
        store.add_lineage(out, inplace, C.identity_lineage(store.arrays[out].shape),
                          op_name="inplace")
        store.commit()
        answers, ms = run_fig89_queries(store, paths)
        check_sharded_answers(answers, p3_answers, "sharded store")
        touched = sorted({k for names, _ in paths.values()
                          for k in store.planner.plan(names[0], [names[-1]]).shards_touched()})
        exchanged = store.io_stats["boxes_exchanged"]
        if exchanged <= 0 or len(touched) < 2:
            raise AssertionError(f"sharded store: boxes_exchanged={exchanged} "
                                 f"shards touched={touched}")
        state.update(store=store, paths=paths, route=(out, inplace))
        return {"query_ms": ms, "boxes_exchanged": exchanged, "shards_touched": len(touched),
                "shards_loaded": len(store.loaded_shards()),
                "boundary_edges": len(store.sgraph.boundary)}

    step("a sharded ingest + fig8/9 queries", "range_join_mask", ingest_and_query)

    def accel_dag():
        _, want, shape, branches, hops, n_cells = accel
        store = core.ShardedDSLog(
            n_shards=SHARDS, device="cuda",
            policy=core.AffinityShardPolicy(SHARDS, accel_pins(branches, hops, SHARDS)),
        )
        store.views.enabled = False  # the answer comes from the joins
        build_accel_dag(store, core.LineageRelation, shape, branches, hops)
        t0 = time.perf_counter()
        got = store.prov_query("src", "out", accel_cells(shape, n_cells), batched=True)
        ms = (time.perf_counter() - t0) * 1e3
        if not same_box(got, want):
            raise AssertionError("sharded accel DAG: answer differs from phase 4's")
        return {"query_ms": ms, "boxes_exchanged": store.io_stats["boxes_exchanged"],
                "tiles_visited": store.io_stats["batch_tiles_visited"],
                "shards_loaded": len(store.loaded_shards())}

    step("b sharded accel DAG", "range_join_tile_masks", accel_dag)

    def reload_and_recover():
        store, paths = state["store"], state["paths"]
        u, v = state["route"]
        if len(store.planner.plan(u, [v]).shards_touched()) != 1:
            raise AssertionError(f"{u}->{v} touches more than one shard")
        shape = store.arrays[u].shape
        cells = first_cells(shape)  # never asked before: no cached answer
        t0 = time.perf_counter()
        store.close()  # checkpoint
        checkpoint_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = core.ShardedDSLog.load(root, device="cuda")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = cold.prov_query(u, v, cells)
        one_ms = (time.perf_counter() - t0) * 1e3
        loaded = cold.io_stats["shards_loaded"]
        # the hop is an identity: the answer is the query's cells
        if not np.array_equal(box_flat_cells(got), np.ravel_multi_index(cells.T, shape)):
            raise AssertionError(f"cold load: {u}->{v} answer differs from its cells")
        if loaded != 1 or len(cold.loaded_shards()) != 1:
            raise AssertionError(f"cold load: {u}->{v} loaded {cold.loaded_shards()}")
        answers, cold_ms = run_fig89_queries(cold, paths)
        check_sharded_answers(answers, p3_answers, "sharded store (cold)")
        # more ingest, then a crash: only the WALs hold it
        store = core.ShardedDSLog.open(root, device="cuda")
        extra, rels = random_workflow(C, 5, len(flows), sizes[4])
        extra_path = register_workflow(store, extra, rels, reuse=None)
        store.commit()
        store.close(checkpoint=False)
        t0 = time.perf_counter()
        rec = core.ShardedDSLog.load(root, device="cuda")
        recover_s = time.perf_counter() - t0
        replayed = dict(rec.io_stats).get("wal_replayed", 0)
        if replayed <= 0:
            raise AssertionError("sharded load() replayed no WAL record after the crash")
        again, rec_ms = run_fig89_queries(rec, paths)
        check_sharded_answers(again, p3_answers, "recovered sharded store")
        got, _ = fig89_queries(rec, extra, extra_path, rels[0].in_shape)
        for (_, sel, _), res in got.items():
            if not np.array_equal(box_flat_cells(res),
                                  forward_join_rows(rels, query_cells(rels[0].in_shape, sel))):
                raise AssertionError(f"recovered sharded store: {extra} sel={sel} differs")
        state["recovered"] = rec
        return {"route": f"{u}->{v}", "one_shard_query_ms": one_ms,
                "shards_loaded_by_it": loaded, "checkpoint_s": checkpoint_s, "load_s": load_s,
                "query_ms_cold": cold_ms, "recover_s": recover_s, "wal_replayed": replayed,
                "query_ms_recovered": rec_ms,
                "boxes_exchanged": rec.io_stats["boxes_exchanged"],
                "shards_loaded": rec.io_stats["shards_loaded"]}

    step("c checkpoint, cold load, crash + recovery", None, reload_and_recover)

    def verify():
        out = {}
        for label, path in [*store_roots.items(), ("phase9", root)]:
            t0 = time.perf_counter()
            report = fsck.fsck_store(path)
            if not report.ok:
                raise AssertionError(f"fsck {label}: " + "; ".join(map(str, report.errors)))
            out[f"fsck_{label}_s"] = time.perf_counter() - t0
            out[f"fsck_{label}_warnings"] = len(report.warnings)
        health = state["recovered"].health(run_fsck=True)
        if health["fsck"] is None or not health["fsck"]["ok"]:
            raise AssertionError(f"health(run_fsck=True): {health['flags']}")
        out["health_fsck_findings"] = len(health["fsck"]["findings"])
        out["health_flags"] = len(health["flags"])
        return out

    step("d fsck", None, verify)

    def jacobians():
        twins = jacobian_twins(torch)
        rng = np.random.default_rng(3)
        for name, (f, shapes) in twins.items():
            spec = oplib.OPS[name]
            args = [rng.random(s) + 0.5 for s in shapes(spec.shapes[0])]
            rels = C.capture_jacobian(f, *args, device="cuda")
            for (_, pos), rel in spec.lineage(spec.shapes[0], np.random.default_rng(0)).items():
                if rels[pos] != rel:
                    raise AssertionError(f"capture_jacobian {name} operand {pos} "
                                         "differs from oplib's lineage")
        return {"ops": len(twins)}

    step("e capture_jacobian vs oplib", None, jacobians)
    return steps


# --------------------------------------------------------------------------- #
# Serving (phase 10)
# --------------------------------------------------------------------------- #
def timed_generate(torch, generate, cfg, model, prompts, new, laps):
    """``generate`` on the card; (tokens, host ms up to the last token).
    ``laps`` receives its prefill and decode loops' seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, model, prompts, new, device="cuda", timings=laps)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def allclose_excess(got, want, tol) -> float:
    """Largest ``|got - want| - (tol + tol * |want|)``: at most 0 when the
    two agree within rtol = atol = ``tol``."""
    return float(((got - want).abs() - tol - tol * want.abs()).max())


def greedy_gap(torch, forward, cfg, model, out, s0) -> float:
    """The largest gap between the top full-forward logit and the logit of
    the token greedy decoding picked there: 0 where decode and forward pick
    the same token; a near-tie within the decode/forward tolerance may
    pick either."""
    logits, _ = forward(model, {"tokens": out[:, :-1]}, cfg, mode="dot")
    logits = logits[:, s0 - 1 :]
    picked = torch.take_along_dim(logits, out[:, s0:, None].long(), dim=-1)[..., 0]
    return float((logits.amax(dim=-1) - picked).max())


def serve_bound(cfg, model, batch, s0, new) -> tuple[float, str, int]:
    """The least time of one decode step at this batch, averaged over the
    ``new`` steps: every weight read once, the valid K/V rows read once,
    the logits written once, over 3.35 TB/s; against 2 flops a weight a
    token over the fp32 rate."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    mean_len = s0 + (new + 1) / 2
    kv = 2 * cfg.n_layers * batch * mean_len * cfg.n_kv_heads * cfg.hd * 4
    logits = batch * cfg.vocab_padded * 4
    flops = 2 * sum(p.numel() for p in model.parameters()) * batch
    b_ms, b_by = bound(weights + kv + logits, flops)
    return b_ms, b_by, weights


def phase_serve(torch, core, card) -> dict:
    """The LM serving path (module doc, phase 10)."""
    import copy

    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, forward, init_caches, init_model

    precision = torch.get_float32_matmul_precision()
    log(f"  float32 matmul precision: {precision} "
        f"(tf32 matmul {torch.backends.cuda.matmul.allow_tf32})")
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 10 runs float32 matmuls at full precision")
    cfg = get_arch(SERVE_ARCH)
    b, s0, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_model(cfg, SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    b_ms, b_by, weight_bytes = serve_bound(cfg, model, b, s0, new)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
        f"-> {cfg.vocab_padded}; {n_params} float32 parameters ({weight_bytes} B) "
        f"made on the card in {init_s:.2f}s")

    store = core.DSLog(device="cuda")
    pipe = TokenPipeline(
        PipelineConfig(vocab=cfg.vocab, seq_len=s0, global_batch=b, seed=SERVE_SEED),
        dslog=store,
    )
    prefill_ms, decode_ms, total_ms, lineage_ms, checks = [], [], [], [], {}
    for t in range(SERVE_BATCHES):
        t0 = time.perf_counter()
        batch = pipe.next_batch()
        lineage_ms.append((time.perf_counter() - t0) * 1e3)
        prompts = torch.from_numpy(batch["tokens"]).to("cuda")
        if t == 0:
            checks = serve_checks(torch, decode_step, forward, init_caches, copy, cfg,
                                  model, prompts)
        laps = {}
        out, g_ms = timed_generate(torch, generate, cfg, model, prompts, new, laps)
        p_ms = laps["prefill_s"] * 1e3
        prefill_ms.append(p_ms)
        decode_ms.append(laps["decode_s"] * 1e3 / new)
        total_ms.append(g_ms)
        if out.shape != (b, s0 + new) or not torch.equal(out[:, :s0], prompts.int()):
            raise AssertionError(f"batch {t}: generate returned {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
            raise AssertionError(f"batch {t}: a generated id lies outside the vocab")
        gap = greedy_gap(torch, forward, cfg, model, out, s0)
        if gap > 2 * DECODE_TOL:
            raise AssertionError(f"batch {t}: greedy token {gap} below the forward's top logit")
        log(f"  batch {t}: lineage logged in {lineage_ms[-1]:.1f}ms, prefill {p_ms:.1f}ms, "
            f"decode {decode_ms[-1]:.3f}ms a token, request {g_ms:.1f}ms, greedy gap to "
            f"forward argmax {gap:.2e}")
    prefill = float(np.median(prefill_ms))
    decode = float(np.median(decode_ms))
    profile = serve_profile(torch, decode_step, init_caches, cfg, model, prompts, decode)
    lineage = pipeline_lineage(store, pipe, b, s0)
    reduced = serve_reduced(torch, copy, ARCHS, generate, init_model)
    res = {
        "arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
        "init_s": init_s, "batch": b, "prompt": s0, "new_tokens": new,
        "prefill_ms": prefill, "prefill_ms_per_token": prefill / s0,
        "decode_ms_per_token": decode, "decode_bound_ms": b_ms, "decode_bound_by": b_by,
        "decode_tokens_per_s": b * 1e3 / decode,
        "request_tokens_per_s": b * new * 1e3 / float(np.median(total_ms)),
        "lineage_log_ms": float(np.median(lineage_ms)),
        "peak_cuda_mem": torch.cuda.max_memory_allocated(), **checks, **profile, **lineage,
        "reduced_archs": reduced,
    }
    log(f"  {card}: prefill {prefill:.1f}ms for {b} x {s0} tokens "
        f"({prefill / s0:.3f}ms a step), decode {decode:.3f}ms a token for the batch "
        f"of {b} (bound {b_ms:.3f}ms by {b_by}), {res['decode_tokens_per_s']:.1f} decode "
        f"tokens/s, {res['request_tokens_per_s']:.1f} generated tokens/s a request, "
        f"peak {res['peak_cuda_mem']}B (medians of {SERVE_BATCHES} batches)")
    return res


def serve_profile(torch, decode_step, init_caches, cfg, model, prompts, decode_ms,
                  steps=8) -> dict:
    """``steps`` decode steps of the batch under ``torch.profiler``: the
    device work they launch (kernels and copies) and its busy time, against
    ``decode_ms``, the step's time without the profiler (which slows the
    host several times over, not the device).  Where the profiler records
    no device event, the device numbers are None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    b = prompts.shape[0]
    caches = init_caches(cfg, b, steps + 1, device="cuda")
    decode_step(model, prompts[:, :1], caches, 0, cfg)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            decode_step(model, prompts[:, t : t + 1], caches, t, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU and e.cpu_parent is None)
    res = {"profile_wall_ms_per_step": wall_ms, "profile_host_ops_per_step": ops / steps,
           "profile_device_events_per_step": None, "profile_device_busy_ms_per_step": None,
           "profile_device_idle_share": None}
    if device:
        busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
        res.update({"profile_device_events_per_step": len(device) / steps,
                    "profile_device_busy_ms_per_step": busy,
                    "profile_device_idle_share": 1 - busy / decode_ms})
        top = {}
        for e in device:
            top[e.name] = top.get(e.name, 0) + e.time_range.elapsed_us()
        heavy = sorted(top.items(), key=lambda kv: -kv[1])[:5]
        log("  profiled decode step, top device work (us a step): " + "; ".join(
            f"{n[:60]} {us / steps:.1f}" for n, us in heavy))
    log(f"  profiled decode step ({steps} steps): host {wall_ms:.3f}ms under the "
        f"profiler ({decode_ms:.3f}ms without), "
        f"{res['profile_host_ops_per_step']:.0f} top-level host ops, device events "
        f"{res['profile_device_events_per_step']}, device busy "
        f"{res['profile_device_busy_ms_per_step']}ms, idle share "
        f"{res['profile_device_idle_share']}")
    return res


def serve_checks(torch, decode_step, forward, init_caches, copy, cfg, model, prompts) -> dict:
    """Phase 10b: the stepwise decode logits against the full forward on
    the card, and one prompt's first step on the card against the CPU."""
    b, s0 = prompts.shape
    caches = init_caches(cfg, b, s0 + 1, device="cuda")
    steps = torch.stack([decode_step(model, prompts[:, t : t + 1], caches, t, cfg)[0][:, 0]
                         for t in range(s0)], dim=1)
    full, _ = forward(model, {"tokens": prompts}, cfg, mode="dot")
    excess = allclose_excess(steps, full, DECODE_TOL)
    decode_err = float((steps - full).abs().max())
    del steps, full, caches
    if excess > 0:
        raise AssertionError(f"decode differs from forward by {decode_err} "
                             f"(rtol = atol = {DECODE_TOL})")
    cpu_model = copy.deepcopy(model).to("cpu")
    tok = prompts[:1, :1]
    want, _ = decode_step(cpu_model, tok.cpu(), init_caches(cfg, 1, 2, device="cpu"), 0, cfg)
    got, _ = decode_step(model, tok, init_caches(cfg, 1, 2, device="cuda"), 0, cfg)
    del cpu_model
    cpu_err = float((got.cpu() - want).abs().max())
    if allclose_excess(got.cpu(), want, CARD_CPU_TOL) > 0:
        raise AssertionError(f"first-step logits: card vs CPU {cpu_err} "
                             f"(rtol = atol = {CARD_CPU_TOL})")
    log(f"  decode vs forward(mode='dot') on the card: max |diff| {decode_err:.3e} over "
        f"{b} x {s0} steps (rtol = atol = {DECODE_TOL}); first step card vs CPU: max "
        f"|diff| {cpu_err:.3e} (rtol = atol = {CARD_CPU_TOL})")
    return {"decode_vs_forward_max_abs": decode_err, "card_vs_cpu_max_abs": cpu_err}


def pipeline_lineage(store, pipe, b, s0, steps=None) -> dict:
    """Phases 10c and 11d: each step's (or each of ``steps``') shard cells
    back through the batch to the corpus, against the numpy oracle;
    ``shard_slice`` reuse."""
    before = dict(store.io_stats)
    cells = np.array([[r, c] for r in range(b) for c in range(s0)])
    routes = set()
    steps = range(pipe.step) if steps is None else steps
    t0 = time.perf_counter()
    for t in steps:
        path = [f"shard_s{t}_k0", f"batch_s{t}", "corpus"]
        res = store.prov_query(path, cells)
        rows = pipe.source_rows_for_step(t)
        if res.cell_set() != {(int(rows[r]), int(c)) for r, c in cells}:
            raise AssertionError(f"step {t}: lineage differs from the shuffle's source rows")
        routes.add(store.planner.plan_path(path).describe().split("\n", 1)[1])
    query_ms = (time.perf_counter() - t0) * 1e3
    reused = [op.reused for op in store.ops if op.op_name == "shard_slice"]
    if reused[2:] != ["dim"] * (len(reused) - 2):
        raise AssertionError(f"shard_slice reuse {reused}: not dim from the third step")
    launches = store.io_stats["kernel_launches"] - before["kernel_launches"]
    log(f"  lineage: {len(steps)} backward queries of {len(cells)} cells each equal the "
        f"source rows in {query_ms:.1f}ms; shard_slice reuse {reused}; io_stats "
        f"kernel_launches +{launches}; routes:")
    for route in sorted(routes):
        log("    " + route.replace("\n", "\n    "))
    return {"lineage_query_ms": query_ms, "lineage_kernel_launches": launches,
            "shard_slice_reuse": reused, "lineage_routes": sorted(routes)}


def serve_reduced(torch, copy, archs, generate, init_model) -> list:
    """Phase 10d: every decoder architecture at ``reduced()`` generates on
    the card and on the CPU from the same weights; greedy tokens equal."""
    done = []
    rng = np.random.default_rng(SERVE_SEED)
    for name, arch in archs.items():
        cfg = arch.reduced()
        if cfg.encoder_only:
            continue
        model = init_model(cfg, SERVE_SEED, device="cuda")
        cpu_model = copy.deepcopy(model).to("cpu")
        prompts = rng.integers(0, cfg.vocab, (SMALL_BATCH, SMALL_PROMPT)).astype(np.int32)
        got = generate(cfg, model, prompts, SMALL_NEW, device="cuda").cpu()
        want = generate(cfg, cpu_model, prompts, SMALL_NEW, device="cpu")
        if not torch.equal(got, want):
            raise AssertionError(f"{cfg.name}: greedy tokens on the card differ from the CPU's")
        done.append(cfg.name)
    log(f"  reduced() decoders, card == CPU greedy tokens: {', '.join(done)}")
    return done


# --------------------------------------------------------------------------- #
# The training path (phase 11)
# --------------------------------------------------------------------------- #
def train_step_flops(cfg, model, b, s, plan) -> float:
    """The train step's flops from the code's shapes: 6 a weight a token
    (forward 2, backward 4) over the layers' weight matrices and the head,
    attention's two products over every key position the path visits
    (``chunked`` pads keys to a multiple of ``chunk`` and masks, it skips
    none), 3 times (forward, backward 2x), and remat's second forward of
    each layer (``full``: its products and attention; ``dots``: attention
    only, the products are saved).  Norms, softmax and other elementwise
    work are left out, so this is a lower bound."""
    t = b * s
    n_layer = sum(p.numel() for n, p in model.named_parameters()
                  if n.startswith("layers.") and p.dim() == 2)
    n_head = cfg.vocab_padded * cfg.d_model
    s_kv = s if plan["mode"] == "dot" else -(-s // plan["chunk"]) * plan["chunk"]
    attn = 0 if cfg.attention_free else (
        2 * 2 * b * cfg.n_heads * s * s_kv * cfg.hd * cfg.n_layers)
    remat = {"nothing": 0, "dots": attn}.get(cfg.remat, 2 * n_layer * t + attn)
    return 3 * (2 * (n_layer + n_head) * t + attn) + remat


def phase_train(torch, core, card, workdir, keep) -> dict:
    """The LM training path (module doc, phase 11).  ``keep`` receives the
    parameters on the host after step DP_STEPS and the steps' metrics,
    which phase 12 holds its ranks to."""
    import copy
    import dataclasses

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, cosine_schedule

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 11 runs float32 matmuls at full precision")
    cfg = get_arch(TRAIN_ARCH)
    shape = dataclasses.replace(SHAPES[TRAIN_SHAPE], global_batch=TRAIN_BATCH)
    b, s = shape.global_batch, shape.seq_len
    plan = attn_plan(cfg, shape, dp_total=1)
    if (plan["mode"], plan["chunk"], plan["n_micro"]) != ("chunked", 512, 1) or s % 512:
        raise AssertionError(f"attn_plan for {shape}: {plan}")
    opt_cfg = AdamWConfig()
    model = init_model(cfg, TRAIN_SEED, device="cuda")
    opt = adamw_init(model)
    flops = train_step_flops(cfg, model, b, s, plan)
    b_ms, b_by = bound(0, flops)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}, remat "
        f"{cfg.remat}; {shape.name} cut to batch {b} x {s} tokens; plan {plan}; step "
        f"{flops:.4e} flops, bound {b_ms:.1f}ms ({b_by})")
    store = core.DSLog(device="cuda")
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, s, b, TRAIN_SEED), dslog=store)
    step_fn = make_train_step(cfg, opt_cfg, plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(pipe.next_batch()["tokens"]).to("cuda")
        log_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": k, "ms": ms, "lineage_log_ms": log_ms,
               **{key: float(m[key]) for key in ("loss", "ce", "aux", "grad_norm", "lr")}}
        want_lr = cosine_schedule(torch.tensor(float(k + 1), device="cuda"), opt_cfg)
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"train step {k}: loss {rec['loss']}, grad_norm "
                                 f"{rec['grad_norm']}")
        if not torch.equal(m["lr"], want_lr) or int(opt["step"]) != k + 1:
            raise AssertionError(f"train step {k}: lr {rec['lr']} != cosine_schedule "
                                 f"{float(want_lr)}, step {int(opt['step'])}")
        steps.append(rec)
        log(f"  step {k}: {ms:.1f}ms loss {rec['loss']:.6f} grad_norm {rec['grad_norm']:.6f} "
            f"lr {rec['lr']:.3e} (lineage logged in {log_ms:.1f}ms)")
        if k + 1 == DP_STEPS:
            keep["params"] = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    peak = torch.cuda.max_memory_allocated()
    keep.update(steps=steps, peak=peak, layers=cfg.n_layers)
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    res = {"arch": cfg.name, "params": sum(p.numel() for p in model.parameters()),
           "batch": b, "seq": s, "plan": plan, "remat": cfg.remat, "step_flops": flops,
           "first_step_ms": steps[0]["ms"], "step_ms": step_ms,
           "tokens_per_s": b * s * 1e3 / step_ms, "bound_ms": b_ms, "bound_by": b_by,
           "bound_share": b_ms / step_ms, "peak_cuda_mem": peak, "steps": steps}
    log(f"  {card}: train step {step_ms:.1f}ms (median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{steps[0]['ms']:.1f}ms), {res['tokens_per_s']:.1f} tokens/s, bound {b_ms:.1f}ms "
        f"({b_by}, share {res['bound_share']:.3f}), peak {peak}B")
    tokens = torch.from_numpy(pipe.global_batch_tokens(TRAIN_STEPS)).to("cuda")
    res.update(train_profile(torch, step_fn, model, opt, {"tokens": tokens}, step_ms))
    del model, opt, step_fn
    torch.cuda.empty_cache()
    res["lineage"] = pipeline_lineage(store, pipe, b, s, steps=TRAIN_LINEAGE_STEPS)
    res.update(train_card_vs_cpu(torch, copy, dataclasses, cfg))
    res.update(train_resume(torch, cfg, workdir))
    return res


def train_profile(torch, step_fn, model, opt, batch, step_ms) -> dict:
    """One more train step under ``torch.profiler``: its device work
    (kernels and copies), busy time against ``step_ms`` (the step without
    the profiler), the dense products' share (cuBLAS/CUTLASS GEMM kernels)
    and the heaviest kernels.  Where the profiler records no device event,
    the device numbers are None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(model, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {"profile_wall_ms": wall_ms, "profile_device_events": len(device),
           "profile_device_busy_ms": None, "profile_device_idle_share": None,
           "profile_gemm_ms": None}
    if device:
        by_name: dict = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        gemm = sum(ms for n, ms in by_name.items()
                   if re.search(r"gemm|xmma|cutlass", n, re.IGNORECASE))
        res.update({"profile_device_busy_ms": busy, "profile_device_idle_share": 1 - busy / step_ms,
                    "profile_gemm_ms": gemm})
        heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log("  profiled train step, top device work (ms): " + "; ".join(
            f"{n[:60]} {ms:.1f}" for n, ms in heavy))
    log(f"  profiled train step: host {wall_ms:.1f}ms under the profiler ({step_ms:.1f}ms "
        f"without), {len(device)} device events, device busy {res['profile_device_busy_ms']}ms, "
        f"dense products {res['profile_gemm_ms']}ms, idle share "
        f"{res['profile_device_idle_share']}")
    return res


def train_card_vs_cpu(torch, copy, dataclasses, cfg_full) -> dict:
    """Phase 11b: qwen2-0.5b's published layer widths cut to a few layers
    trains on the card and on the CPU from the same weights; then the
    gradient under each remat policy on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model, lm_loss
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(cfg_full, n_layers=TRAIN_CPU_LAYERS)
    shape = ShapeConfig("card_vs_cpu", TRAIN_CPU_SEQ, TRAIN_BATCH, "train")
    plan = attn_plan(cfg, shape, dp_total=1)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    model = init_model(cfg, TRAIN_SEED, device="cuda")
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(TRAIN_SEED)
    batches = [rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_CPU_SEQ)).astype(np.int32)
               for _ in range(TRAIN_CPU_STEPS)]
    metrics = {}
    for where, m in (("card", model), ("cpu", cpu_model)):
        opt, step_fn = adamw_init(m), make_train_step(cfg, opt_cfg, plan)
        metrics[where] = []
        for tokens in batches:
            batch = {"tokens": torch.from_numpy(tokens).to(next(m.parameters()).device)}
            m, opt, out = step_fn(m, opt, batch)
            metrics[where].append([float(out[k]) for k in ("loss", "grad_norm", "lr")])
    got, want = np.array(metrics["card"]), np.array(metrics["cpu"])
    metric_err = float(np.abs(got - want).max())
    if np.any(np.abs(got - want) > TRAIN_CARD_CPU_TOL * (1 + np.abs(want))):
        raise AssertionError(f"train steps card vs CPU: loss/grad_norm/lr differ by "
                             f"{metric_err} (rtol = atol = {TRAIN_CARD_CPU_TOL})")
    # AdamW moves each entry by about lr a step whatever its gradient's size:
    # where a gradient cancels to near zero, float32 rounding on either device
    # decides its sign, so a few entries may differ by up to 2 lr a step
    adamw_bound = PARAM_TOL + 2 * float(got[:, 2].sum())
    param_err, worst, n_out, n_all = 0.0, "", 0, 0
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        diff = (p.detach().cpu() - q.detach()).abs()
        n_out += int((diff > PARAM_TOL * (1 + q.detach().abs())).sum())
        n_all += diff.numel()
        if float(diff.max()) > param_err:
            param_err, worst = float(diff.max()), name
    if param_err > adamw_bound or n_out > PARAM_OUT_SHARE * n_all:
        raise AssertionError(f"train steps card vs CPU: parameters differ by {param_err} "
                             f"({worst}); {n_out} of {n_all} entries beyond rtol = atol = "
                             f"{PARAM_TOL}")
    log(f"  card vs CPU, {cfg.n_layers} layers x {TRAIN_BATCH} x {TRAIN_CPU_SEQ} tokens, "
        f"{TRAIN_CPU_STEPS} steps: loss/grad_norm/lr max |diff| {metric_err:.3e} (rtol = atol "
        f"= {TRAIN_CARD_CPU_TOL}); parameters max |diff| {param_err:.3e} in {worst} (at most "
        f"{adamw_bound:.3e}), {n_out} of {n_all} entries beyond rtol = atol = {PARAM_TOL} (at "
        f"most a share of {PARAM_OUT_SHARE}); card {metrics['card']}")
    del cpu_model

    batch = {"tokens": torch.from_numpy(batches[0]).to("cuda")}
    params = list(model.parameters())
    grads = {}
    for remat in ("nothing", "full", "dots"):
        total, _ = lm_loss(model, batch, dataclasses.replace(cfg, remat=remat),
                           mode=plan["mode"], chunk=plan["chunk"])
        grads[remat] = torch.autograd.grad(total, params)
    remat_err = {}
    for remat in ("full", "dots"):
        remat_err[remat] = max(float((g - w).abs().max())
                               for g, w in zip(grads[remat], grads["nothing"]))
        if remat_err[remat] > REMAT_TOL:
            raise AssertionError(f"remat {remat}: gradient differs by {remat_err[remat]} on "
                                 f"the card (atol {REMAT_TOL})")
    log(f"  remat on the card: gradient max |diff| against 'nothing': full "
        f"{remat_err['full']:.3e}, dots {remat_err['dots']:.3e} (atol {REMAT_TOL})")
    return {"card_vs_cpu_metrics_max_abs": metric_err, "card_vs_cpu_params_max_abs": param_err,
            "card_vs_cpu_params_beyond_tol": n_out, "remat_grad_max_abs": remat_err}


def train_resume(torch, cfg_full, workdir) -> dict:
    """Phase 11c: ``train_loop`` at ``reduced()`` with checkpoints on the
    card: a run resumed from step 2 gives the straight run's losses, and
    the last checkpoint restores on the CPU to the trained parameters."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models.convert import tree_values
    from repro_torch.optim.adamw import AdamWConfig

    cfg = cfg_full.reduced()
    shape = ShapeConfig("resume", RESUME_SEQ, TRAIN_BATCH, "train")
    kw = dict(ckpt_every=3, log_every=100, device="cuda",
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
    straight_dir, resumed_dir = os.path.join(workdir, "straight"), os.path.join(workdir, "resumed")
    model, straight = train_loop(cfg, shape, steps=6, ckpt_dir=straight_dir, **kw)
    _, first = train_loop(cfg, shape, steps=3, ckpt_dir=resumed_dir, **kw)
    _, rest = train_loop(cfg, shape, steps=6, ckpt_dir=resumed_dir, **kw)
    resume_err = float(np.abs(np.array(first + rest) - np.array(straight)).max())
    if len(rest) != 3 or resume_err > RESUME_TOL:
        raise AssertionError(f"resumed losses {first + rest} != straight {straight}")
    mgr = CheckpointManager(straight_dir)
    t0 = time.perf_counter()
    tree, extra = mgr.restore(device="cpu")
    restore_s = time.perf_counter() - t0
    for (name, p), got in zip(model.named_parameters(), tree_values(model, tree["params"])):
        if got.device.type != "cpu" or not torch.equal(got, p.detach().cpu()):
            raise AssertionError(f"checkpoint leaf of {name} differs on the CPU")
    on_card, _ = mgr.restore(device="cuda")
    if not torch.equal(on_card["opt"]["m"]["embed"]["table"].cpu(),
                       tree["opt"]["m"]["embed"]["table"]) or extra["step"] != 5:
        raise AssertionError("the checkpoint restores otherwise on the card")
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(workdir, "resave")).save(5, tree, extra=extra)
    save_s = time.perf_counter() - t0
    with open(os.path.join(straight_dir, "step_00000005", "manifest.json")) as f:
        codec = json.load(f)["codec"]
    log(f"  train_loop {cfg.name}: straight {['%.6f' % x for x in straight]}, resumed from "
        f"step 2 max |diff| {resume_err:.3e} (atol {RESUME_TOL}); checkpoint of "
        f"{sum(p.numel() for p in model.parameters())} parameters + moments: save "
        f"{save_s:.3f}s, restore {restore_s:.3f}s (codec {codec})")
    return {"resume_losses": straight, "resume_max_abs": resume_err,
            "ckpt_save_s": save_s, "ckpt_restore_s": restore_s}


# --------------------------------------------------------------------------- #
# The LM stack's distributed pieces (phase 12)
# --------------------------------------------------------------------------- #
def replay_exchange(torch, dist, coords, step_traffic) -> dict:
    """The step's collectives alone, replayed at their average size a call:
    ms of each kind (``collectives.traffic``'s), through ``gloo``.  A first
    call of each kind on known values is checked: each rank's block ``r +
    1`` gathers to the blocks in group order, a whole of block numbers
    reduce-scatters to ``size`` times this rank's, and ``r + 1`` all-reduces
    to ``size (size + 1) / 2``."""
    groups = {"zero3_gather": coords.data_group, "zero3_reduce_scatter": coords.data_group,
              "model_all_reduce": coords.model_group, "model_all_gather": coords.model_group}
    out = {}
    for kind, (n, b) in sorted(step_traffic.items()):
        group = groups[kind]
        size, r = dist.get_world_size(group), dist.get_rank(group)
        per = max(1, b // max(n, 1) // 4 // size)
        numbers = torch.arange(1, size + 1, device="cuda:0", dtype=torch.float32)
        if kind in ("zero3_gather", "model_all_gather"):
            got = torch.empty(per * size, device="cuda:0")
            dist.all_gather_into_tensor(got, torch.full((per,), r + 1.0, device="cuda:0"),
                                        group=group)
            want = numbers.repeat_interleave(per)
        elif kind == "zero3_reduce_scatter":
            got = torch.empty(per, device="cuda:0")
            dist.reduce_scatter_tensor(got, numbers.repeat_interleave(per), group=group)
            want = torch.full((per,), size * (r + 1.0), device="cuda:0")
        else:
            got = torch.full((per * size,), r + 1.0, device="cuda:0")
            dist.all_reduce(got, group=group)
            want = torch.full((per * size,), size * (size + 1) / 2, device="cuda:0")
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} over gloo on CUDA tensors gave wrong values")
        whole = torch.zeros(per * size, device="cuda:0")
        block = torch.zeros(per, device="cuda:0")
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if kind in ("zero3_gather", "model_all_gather"):
                dist.all_gather_into_tensor(whole, block, group=group)
            elif kind == "zero3_reduce_scatter":
                dist.reduce_scatter_tensor(block, whole, group=group)
            else:
                dist.all_reduce(whole, group=group)
        torch.cuda.synchronize()
        out[kind] = (time.perf_counter() - t0) * 1e3
    return out


def mesh_lineage(store, pipe, steps, dp) -> dict:
    """Phase 13: each step's data shards queried back through the batch to
    the corpus, against the shuffle's source rows."""
    per, s0 = pipe.cfg.global_batch // dp, pipe.cfg.seq_len
    cells = np.array([[r, c] for r in range(per) for c in range(s0)])
    t0 = time.perf_counter()
    for t in steps:
        rows = pipe.source_rows_for_step(t)
        for k in range(dp):
            res = store.prov_query([f"shard_s{t}_k{k}", f"batch_s{t}", "corpus"], cells)
            if res.cell_set() != {(int(rows[k * per + r]), int(c)) for r, c in cells}:
                raise AssertionError(f"step {t} shard {k}: lineage differs from the source rows")
    return {"lineage_query_ms": (time.perf_counter() - t0) * 1e3,
            "lineage_queries": len(steps) * dp}


def mesh_worker(rank: int, world: int, mp: int, layers: int, workdir: str) -> int:
    """One rank of phase 12a (``mp`` 1) or 13 (``mp`` 2), run as
    ``chip_smoke.py --mesh-rank R --mesh-world W --mesh-model M
    --mesh-layers L --mesh-dir D``: ``train_loop`` on ``cuda:0`` at L of
    qwen2-0.5b's layers on a ``(W / M, M)`` mesh of a ``gloo``
    group (file rendezvous in D); the bytes it holds and its collectives'
    bytes a step, then those collectives alone; the gathered parameters,
    against its own blocks and (rank 0) the one-process run's in
    ``D/mesh<W>x<M>_want.pt``; in phase 13 rank 0's lineage queries.  Writes
    ``D/mesh<W>x<M>.rankR.json``."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core import DSLog
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed import collectives as col
    from repro_torch.kernels import range_join as rj
    from repro_torch.kernels import run_boundary as rb
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.launch.train import train_loop
    from repro_torch.models.convert import to_reference, tree_values
    from repro_torch.models.layers import Init
    from repro_torch.models.model import LM, replicated_over_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phases 12a and 13 run float32 matmuls at full precision, as 11")
    tag = f"mesh{world}x{mp}"
    wrappers = (rj.range_join_mask, rj.range_join_tile_masks, rb.run_boundaries_packed)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{tag}.rendezvous", rank=rank,
                            world_size=world)
    try:
        cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=layers)
        shape = dataclasses.replace(SHAPES[TRAIN_SHAPE], global_batch=TRAIN_BATCH)
        lineage = os.path.join(workdir, f"{tag}_lineage") if mp > 1 else None
        marks, metrics, traffic = [], [], []

        def on_step(step, model, m):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            metrics.append(m)
            traffic.append(dict(col.traffic))

        t0 = time.perf_counter()
        torch.zeros(1, device="cuda:0")  # the process's CUDA context, timed apart
        torch.cuda.synchronize()
        ctx_ms = (time.perf_counter() - t0) * 1e3
        for w in wrappers:  # the path's launches, counted from zero
            w.launches = 0
        col.traffic.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, _ = train_loop(cfg, shape, steps=DP_STEPS, seed=TRAIN_SEED, opt_cfg=AdamWConfig(),
                              device="cuda:0", log_every=1, on_step=on_step, model_parallel=mp,
                              lineage_dir=lineage)
        peak = torch.cuda.max_memory_allocated()
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
        last, before = traffic[-1], traffic[-2]
        step_traffic = {k: (n - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
                        for k, (n, b) in last.items()}
        params = list(model.parameters())
        coords = mesh_coords(params[0].device_mesh)
        held = sum(p.to_local().numel() * p.element_size() for p in params)
        moments = adamw_init(model)  # placed as train_loop's: zeros_like each parameter
        moment_bytes = sum(t.to_local().numel() * t.element_size()
                           for t in moments["m"] + moments["v"])
        del moments
        exchange_ms = replay_exchange(torch, dist, coords, step_traffic)
        tree = to_reference(model)  # a collective: every rank gathers
        digest = hashlib.sha256()
        for v in leaf_pairs(tree, tree):
            digest.update(v[0].tobytes())
        for (name, p), v in zip(model.named_parameters(), tree_values(model, tree)):
            if not torch.equal(p.to_local().detach().cpu(), v):
                raise AssertionError(f"rank {rank}: its block of {name} is not its slice of "
                                     "the gathered tree")
        out = {"rank": rank, "coord": [coords.data, coords.model], "metrics": metrics,
               "step_ms": step_ms, "peak": peak, "ctx_ms": ctx_ms, "param_bytes": held,
               "grad_bytes": held, "moment_bytes": moment_bytes, "step_traffic": step_traffic,
               "exchange_ms": exchange_ms, "digest": digest.hexdigest(),
               "replicated_over_model": replicated_over_model(model, cfg)}
        if rank == 0:
            want = torch.load(os.path.join(workdir, f"{tag}_want.pt"), mmap=True)
            meta = LM(Init(None, "meta"), cfg)
            err, worst, n_out, n_all = 0.0, "", 0, 0
            for (name, _), got, w in zip(meta.named_parameters(), tree_values(meta, tree), want):
                diff = (got - w).abs()
                n_out += int((diff > DP_PARAM_TOL).sum())
                n_all += diff.numel()
                if float(diff.max()) > err:
                    err, worst = float(diff.max()), name
            out.update(param_max_abs=err, param_worst=worst, param_beyond=n_out, param_all=n_all)
            if lineage is not None:
                pipe = TokenPipeline(PipelineConfig(cfg.vocab, shape.seq_len, shape.global_batch,
                                                    TRAIN_SEED))
                out.update(mesh_lineage(DSLog.load(lineage, device="cuda:0"), pipe,
                                        range(DP_STEPS), coords.dp))
        out["launches"] = {w.__name__: w.launches for w in wrappers}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"{tag}.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def mesh_reference(torch, layers) -> dict:
    """Phase 12a's reference: ``train_loop`` in this process, on the card, at
    ``layers`` of qwen2-0.5b's layers for DP_STEPS steps of phase 11's
    batches: the steps' metrics, the parameters after them on the host and
    the peak memory, as phase 11 keeps them."""
    import contextlib
    import dataclasses

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=layers)
    shape = dataclasses.replace(SHAPES[TRAIN_SHAPE], global_batch=TRAIN_BATCH)
    steps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        model, _ = train_loop(cfg, shape, steps=DP_STEPS, seed=TRAIN_SEED, opt_cfg=AdamWConfig(),
                              device="cuda:0", on_step=lambda step, model, m: steps.append(m))
    want = {"steps": steps, "peak": torch.cuda.max_memory_allocated(), "layers": layers,
            "params": [p.detach().to("cpu", copy=True) for p in model.parameters()]}
    del model
    torch.cuda.empty_cache()
    return want


def phase_mesh(torch, card, workdir, want, world, mp, name) -> dict:
    """Phase 12a (``mp`` 1: ZeRO-3 over 2 data ranks) or 13 (``mp`` 2: a
    (2, 2) mesh): ``train_loop`` on ``world`` processes sharing the card
    (module doc) at the depth of ``want``, a one-process run
    (``mesh_reference``'s, or phase 11's ``keep``), held to its first
    DP_STEPS steps."""
    layers = want["layers"]
    torch.save(want["params"], os.path.join(workdir, f"mesh{world}x{mp}_want.pt"))
    torch.cuda.empty_cache()
    parent_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
                               "--mesh-world", str(world), "--mesh-model", str(mp),
                               "--mesh-layers", str(layers), "--mesh-dir", workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phase {name} rank {r} exited {p.returncode}:\n{out[-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"mesh{world}x{mp}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    for line in outs[0].splitlines():
        if line.startswith(("step ", "mesh ")):
            log(f"  rank 0: {line}")
    ref_peak, want = want["peak"], want["steps"][:DP_STEPS]
    err = 0.0
    for rk in ranks:
        if len(rk["metrics"]) != DP_STEPS or rk["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"phase {name}: rank {rk['rank']} ran {len(rk['metrics'])} steps "
                                 "or its gathered parameters differ from rank 0's")
        for got, w in zip(rk["metrics"], want):
            for key in ("loss", "grad_norm", "lr"):
                err = max(err, abs(got[key] - w[key]))
    if err > DP_TOL:
        raise AssertionError(f"phase {name}: loss/grad_norm/lr differ from the one-process "
                             f"run's by {err} (atol {DP_TOL})")
    # AdamW moves each entry by about lr a step whatever its gradient: a limit
    # at or above adamw_bound could not fail
    adamw_bound = 2 * sum(w["lr"] for w in want)
    if DP_PARAM_TOL >= adamw_bound:
        raise AssertionError(f"phase {name}: DP_PARAM_TOL {DP_PARAM_TOL} is not below 2 sum(lr) "
                             f"= {adamw_bound}")
    r0 = ranks[0]
    # 12a: every entry within DP_PARAM_TOL; 13 (phase 11b's rule): all but a
    # PARAM_OUT_SHARE of them, whose gradients cancel, every one below 2 sum(lr)
    share = PARAM_OUT_SHARE if mp > 1 else 0.0
    if r0["param_beyond"] > share * r0["param_all"] or r0["param_max_abs"] >= adamw_bound:
        raise AssertionError(f"phase {name}: parameters differ from the one-process run's by "
                             f"{r0['param_max_abs']} ({r0['param_worst']}); "
                             f"{r0['param_beyond']} of {r0['param_all']} entries beyond "
                             f"{DP_PARAM_TOL}")
    if mp > 1:
        if any(rk["replicated_over_model"] for rk in ranks):
            raise AssertionError(f"phase {name}: layers computed whole on every model rank: "
                                 f"{ranks[0]['replicated_over_model']}")
        if r0["launches"]["range_join_mask"] <= 0:
            raise AssertionError(f"phase {name}: rank 0's lineage queries launched no mask")
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in r0["launches"]}
    res = {"ranks": world, "model_parallel": mp, "layers": layers, "steps": DP_STEPS,
           "wall_s": wall, "parent_cuda_mem": parent_mem, "one_process_peak": ref_peak,
           "metrics_max_abs": err,
           "param_max_abs": r0["param_max_abs"], "param_worst": r0["param_worst"],
           "param_beyond_tol": r0["param_beyond"], "adamw_bound": adamw_bound,
           "launches": launches, "replicated_over_model": r0["replicated_over_model"],
           **{k: r0[k] for k in ("lineage_query_ms", "lineage_queries") if k in r0},
           "per_rank": [{k: rk[k] for k in ("coord", "step_ms", "peak", "ctx_ms", "param_bytes",
                                            "grad_bytes", "moment_bytes", "step_traffic",
                                            "exchange_ms")} for rk in ranks]}
    for rk in ranks:
        ms = rk["step_ms"]
        moved = ", ".join(f"{k} {n} calls {b}B" for k, (n, b) in sorted(rk["step_traffic"].items()))
        alone = ", ".join(f"{k} {v:.1f}ms" for k, v in sorted(rk["exchange_ms"].items()))
        log(f"  rank {rk['rank']} at (data, model) {tuple(rk['coord'])}: holds parameters "
            f"{rk['param_bytes']}B, gradients {rk['grad_bytes']}B, moments {rk['moment_bytes']}B; "
            f"peak {rk['peak']}B (one process at this depth: {ref_peak}B; PR 18's replicated "
            f"data-parallel rank at 24 layers: 13,868,465,152B); CUDA "
            f"context {rk['ctx_ms']:.1f}ms; step 1 (with init_model and placement) {ms[0]:.1f}ms, "
            f"steps 2-{DP_STEPS} {', '.join(f'{x:.1f}' for x in ms[1:])}ms; a step's exchange "
            f"{moved}; alone, staged through the host by gloo: {alone}")
    log(f"  {card}: {world} ranks on a ({world // mp}, {mp}) mesh, {layers} layers, 1 "
        f"sequence of {TRAIN_SHAPE} a data rank, {DP_STEPS} steps in {wall:.2f}s (processes "
        f"included); loss/grad_norm/lr max |diff| against one process at this depth {err:.3e} "
        f"(atol {DP_TOL}); gathered parameters max |diff| "
        f"{res['param_max_abs']:.3e} in {res['param_worst']}, {res['param_beyond_tol']} of "
        f"{r0['param_all']} entries beyond {DP_PARAM_TOL} (at most a share of {share}; below 2 "
        f"sum(lr) = {adamw_bound:.3e}); computed whole on every model rank: "
        f"{res['replicated_over_model'] or 'none'}; launches {launches}"
        + (f"; rank 0's {res['lineage_queries']} lineage queries {res['lineage_query_ms']:.1f}ms"
           if "lineage_queries" in res else "") + f"; parent holds {parent_mem}B")
    return res


def leaf_pairs(got: dict, want: dict):
    """(got leaf, want leaf) of two nested dicts with the same keys."""
    for k, w in want.items():
        if isinstance(w, dict):
            yield from leaf_pairs(got[k], w)
        else:
            yield got[k], w


def phase_nccl(torch, card, workdir, keep) -> dict:
    """Phase 12b: a one-rank NCCL group on the card: ``local_mesh``,
    ``reshard_tree`` of qwen2-0.5b's tree, ``restore(shardings=)`` of
    phase 11c's checkpoint and the collectives (module doc)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import (flash_decode_combine,
                                                     local_partial_attention,
                                                     pipeline_stage_step)
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models.convert import shape_tree, spec_tree, to_reference
    from repro_torch.models.layers import Init
    from repro_torch.models.model import LM

    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl.rendezvous", rank=0,
                            world_size=1)
    res = {}
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"phase 12b: backend {dist.get_backend()}")
        mesh = local_mesh(1, device="cuda:0")
        if mesh.device_type != "cuda" or tuple(mesh.mesh_dim_names) != ("data", "model"):
            raise AssertionError(f"phase 12b: local_mesh(1) is {mesh}")
        cfg = get_arch(TRAIN_ARCH)
        meta = LM(Init(None, "meta"), cfg)
        tree = to_reference(meta, keep["params"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = reshard_tree(tree, spec_tree(meta), mesh)
        torch.cuda.synchronize()
        res["reshard_s"] = time.perf_counter() - t0
        n_leaves = 0
        for dt, host in leaf_pairs(placed, tree):
            full = dt.full_tensor()
            if full.device.type != "cuda" or not torch.equal(full.cpu(), torch.from_numpy(host)):
                raise AssertionError("phase 12b: a leaf differs after reshard_tree")
            n_leaves += 1
        res["reshard_leaves"] = n_leaves
        del placed, tree

        red = LM(Init(None, "meta"), cfg.reduced())
        sh = param_sharding(mesh, spec_tree(red), shapes_tree=shape_tree(red))
        mgr = CheckpointManager(os.path.join(workdir, "straight"))
        t0 = time.perf_counter()
        got, extra = mgr.restore(device="cuda:0", shardings={"params": sh, "opt": {"m": sh, "v": sh}})
        res["restore_sharded_s"] = time.perf_counter() - t0
        plain, _ = mgr.restore(device="cpu")
        for part in (("params",), ("opt", "m"), ("opt", "v")):
            g, w = got, plain
            for key in part:
                g, w = g[key], w[key]
            for a, b in leaf_pairs(g, w):
                if not torch.equal(a.full_tensor().cpu(), b):
                    raise AssertionError("phase 12b: a sharded restore differs")
        if hasattr(got["opt"]["step"], "full_tensor") or extra["step"] != 5:
            raise AssertionError("phase 12b: the unsharded leaves are not plain tensors")

        gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
        b, h, t, d = FLASH_SHAPE
        q, k, v = (torch.randn(s, generator=gen, device="cuda")
                   for s in ((b, h, 1, d), (b, h, t, d), (b, h, t, d)))
        valid = (torch.arange(t, device="cuda") < t - 7).expand(b, t)
        m, l, o = local_partial_attention(q, k, v, valid)
        torch.cuda.synchronize()
        laps = []
        for _ in range(4):  # the first call also sets up NCCL's communicator
            t0 = time.perf_counter()
            out = flash_decode_combine(m, l, o)
            torch.cuda.synchronize()
            laps.append((time.perf_counter() - t0) * 1e3)
        res["first_collective_ms"], res["flash_combine_ms"] = laps[0], float(np.median(laps[1:]))
        if not torch.equal(out, o / torch.clamp(l, min=1e-30)[..., None]):
            raise AssertionError("phase 12b: flash_decode_combine on one rank changed the answer")
        s_ = (q @ k.transpose(-1, -2)) * d**-0.5
        want = torch.softmax(s_.masked_fill(~valid[:, None, None, :], float("-inf")), -1) @ v
        res["flash_max_abs"] = float((out - want).abs().max())
        if res["flash_max_abs"] > FLASH_TOL:
            raise AssertionError(f"phase 12b: flash-decode differs from softmax attention by "
                                 f"{res['flash_max_abs']} (atol {FLASH_TOL})")
        x = torch.randn((4, 896), generator=gen, device="cuda")
        ring = pipeline_stage_step(lambda y: y * 2.0 + 1.0, x)
        if not torch.equal(ring, x * 2.0 + 1.0):
            raise AssertionError("phase 12b: pipeline_stage_step on one rank changed the answer")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log(f"  {card}: nccl, local_mesh(1) on cuda; reshard_tree of {res['reshard_leaves']} leaves "
        f"in {res['reshard_s']:.3f}s, bit-exact; sharded restore of phase 11c's checkpoint "
        f"{res['restore_sharded_s']:.3f}s, equal; flash_decode_combine {FLASH_SHAPE} "
        f"{res['flash_combine_ms']:.3f}ms (median of 3; the first, with NCCL's set-up, "
        f"{res['first_collective_ms']:.1f}ms), max |diff| against softmax attention "
        f"{res['flash_max_abs']:.3e} (atol {FLASH_TOL}); pipeline_stage_step equal")
    return res


# --------------------------------------------------------------------------- #
# Run boundaries (phase 8)
# --------------------------------------------------------------------------- #
def step1_operands(intervals, provrc, args):
    """The rows ProvRC's step-1 pass sorts from its recorded inputs: the
    group columns and the merged column's lo/hi in sorted order, and
    ``coalesce_1d``'s run starts."""
    key_lo, _, val_lo, val_hi, _, i = args
    _, cols, lo, hi = provrc._step1_rows(key_lo, val_lo, val_hi, i)
    group = provrc._group_ids(cols, lo.shape[0])
    starts, _, _ = intervals.coalesce_1d(group, lo, hi)
    return cols, lo, hi, starts


def identity_step1(side):
    """Step 1's first sorted rows for the backward table of a one-to-one
    (identity) relation over a side x side array: group columns (out row,
    out col, in row lo, in row hi), merged column in col, already in order."""
    r = np.arange(side * side, dtype=np.int64)
    row, col = r // side, r % side
    return [row, col, row, row], col, col


def check_run_flags(flags, cols, lo, hi, starts, what) -> None:
    if not np.array_equal(lo, hi):
        raise AssertionError(f"{what}: step 1's first pass sorts point rows")
    if not np.array_equal(np.flatnonzero(flags), starts):
        raise AssertionError(f"{what}: run_boundaries differs from coalesce_1d")


def phase_rb_main(ops_mod, intervals, provrc, seen) -> tuple[list, tuple]:
    """The run-boundary path: ``ops.run_boundaries`` on each phase 3
    workflow's recorded step-1 rows and on the 2048 x 2048 identity's."""
    tables = []
    for wf, args in seen.step1.items():
        cols, lo, hi, starts = step1_operands(intervals, provrc, args)
        flags = ops_mod.run_boundaries(cols, lo, hi, device="cuda")
        check_run_flags(flags, cols, lo, hi, starts, wf)
        tables.append((wf, cols, lo, hi))
        log(f"  {wf:14s} rows={lo.shape[0]} n_keys={len(cols)} runs={int(flags.sum())}")
    cols, lo, hi = identity_step1(RB_SIDE)
    flags = ops_mod.run_boundaries(cols, lo, hi, device="cuda")
    group = provrc._group_ids(cols, lo.shape[0])
    check_run_flags(flags, cols, lo, hi, intervals.coalesce_1d(group, lo, hi)[0], "identity")
    log(f"  identity {RB_SIDE}x{RB_SIDE} rows={lo.shape[0]} n_keys={len(cols)} "
        f"runs={int(flags.sum())}")
    if len(tables) != 9:
        raise AssertionError(f"recorded step-1 rows of {len(tables)} workflows, not 9")
    return tables, (cols, lo, hi)


def rb_needed_ops(torch, packed, n_keys) -> int:
    """Operations this table needs: for each row after the first, the key
    compares up to the first changed key; where none changed, all of them,
    the add of hi + 1 and the lo compare."""
    total, n, chunk = 0, packed.shape[0], 1 << 20
    for s in range(1, n, chunk):
        e = min(n, s + chunk)
        if n_keys:
            diff = packed[s:e, :n_keys] != packed[s - 1 : e - 1, :n_keys]
            first = diff.int().argmax(dim=1)
            total += int(torch.where(diff.any(dim=1), first + 1,
                                     torch.full_like(first, n_keys + 2)).sum())
        else:
            total += 2 * (e - s)
    return total


def rb_bytes(n, n_keys) -> int:
    """Bytes the flags must move: each row's active lanes ([0, n_keys + 2))
    read once, in the 32-byte sectors memory moves them in, and one flag
    byte written."""
    return n * 32 * -(-(n_keys + 2) * 4 // 32) + n


def rb_table(torch, n, n_keys, seed):
    """A made-up sorted table on the card: each key column sorted over 3
    values (long runs), lo sorted, hi = lo + 0..2."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def ints(hi_val):
        return torch.randint(0, hi_val, (n,), generator=g, device="cuda", dtype=torch.int32)

    p = torch.zeros((n, 128), dtype=torch.int32, device="cuda")
    for c in range(n_keys):
        p[:, c] = torch.sort(ints(3)).values
    lo = torch.sort(ints(max(n // 2, 2))).values
    p[:, n_keys] = lo
    p[:, n_keys + 1] = lo + ints(3)
    return p


def check_rb_kernel(torch, rb, ref, timer, packed, n_keys, label, timed, expect=None):
    """Hold ``run_boundaries_packed`` at block_rows 256 and 1024 against its
    plain version (exact); with ``timed``, time the kernel (``KernelTimer``),
    the wrapper and the plain version."""
    n = packed.shape[0]
    want = ref.run_boundaries_ref(packed, n_keys)
    err = 0
    for block_rows in (256, 1024):
        got = rb.run_boundaries_packed(packed, n_keys=n_keys, block_rows=block_rows)
        torch.cuda.synchronize()
        if n:
            err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"run_boundaries_packed differs from plain at {label} block_rows={block_rows}"
            )
    if expect is not None and want.cpu().tolist() != expect:
        raise AssertionError(f"run_boundaries at {label}: {want.cpu().tolist()} != {expect}")
    rec = {"shape": label, "max_abs_err": err}
    if not timed:
        return rec
    out = torch.empty(n, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms, ms_before = timer.ms(lambda L: lambda: checked(L.rb_run_boundaries(
        packed.data_ptr(), out.data_ptr(), n, n_keys, 1024, stream
    )))
    wrapper_ms = cuda_ms(torch, lambda: rb.run_boundaries_packed(packed, n_keys=n_keys))
    plain_ms = cuda_ms(torch, lambda: ref.run_boundaries_ref(packed, n_keys))
    bytes_moved = rb_bytes(n, n_keys)
    ops = rb_needed_ops(torch, packed, n_keys)
    b_ms, b_by = bound(bytes_moved, ops)
    log(
        f"  run_boundaries_packed {label}: equal runs={int(want.sum())} "
        f"kernel={ms:.4f}ms before={fmt_ms(ms_before)} wrapper={wrapper_ms:.4f}ms "
        f"plain={plain_ms:.4f}ms bound={b_ms:.4f}ms ({b_by}) bytes={bytes_moved} ops={ops}"
    )
    rec.update({"ms": ms, "ms_before": ms_before, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    return rec


def host_ms(torch, fn, reps=3) -> float:
    """Median host milliseconds of ``fn`` (synchronized) over ``reps`` runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_rb_checks(torch, rb, ref, timer, ops_mod, tables, big) -> tuple[dict, list]:
    """The kernel against its plain version: made-up tables, edge rows, the
    main path's tables; the 2048 x 2048 table also through the whole
    ``ops.run_boundaries`` wrapper (host clock).  Returns the record that
    stands for the main path and all records."""
    records = []
    dev = torch.device("cuda")
    for n in RB_ROWS:
        for n_keys in RB_KEYS:
            p = rb_table(torch, n, n_keys, seed=n * 131 + n_keys)
            records.append(check_rb_kernel(
                torch, rb, ref, timer, p, n_keys, f"made-up {n}x{n_keys}",
                timed=n == RB_ROWS[-1] and n_keys in RB_TIMED_KEYS,
            ))
    log(f"  run_boundaries_packed: {len(records)} made-up tables exact "
        f"(rows {RB_ROWS}, keys {RB_KEYS}, block_rows 256 and 1024)")
    i32 = np.iinfo(np.int32)
    edge = torch.full((3, 128), i32.min, dtype=torch.int32, device="cuda")
    wrap = torch.zeros((4, 128), dtype=torch.int32, device="cuda")
    wrap[:, 1] = torch.tensor([0, 5, i32.min, i32.min + 1], dtype=torch.int32)
    wrap[:, 2] = i32.max
    # at 3 keys lo and hi lie in two 16-byte chunks
    wrap3 = torch.zeros((4, 128), dtype=torch.int32, device="cuda")
    wrap3[:, 3] = wrap[:, 1]
    wrap3[:, 4] = i32.max
    for p, n_keys, expect, label in ((edge, 0, [1, 0, 0], "INT32_MIN row 0, n_keys=0"),
                                     (edge, 1, [1, 0, 0], "INT32_MIN row 0, n_keys=1"),
                                     (edge, 7, [1, 0, 0], "INT32_MIN row 0, n_keys=7"),
                                     (edge, 126, [1, 0, 0], "INT32_MIN row 0, n_keys=126"),
                                     (wrap, 1, [1, 1, 0, 1], "hi=INT32_MAX wrap"),
                                     (wrap3, 3, [1, 1, 0, 1], "hi=INT32_MAX wrap, n_keys=3")):
        records.append(check_rb_kernel(torch, rb, ref, timer, p, n_keys, label, False, expect))
    for wf, cols, lo, hi in tables:
        p = ops_mod._pack_run_columns(cols, lo, hi, dev)
        records.append(check_rb_kernel(
            torch, rb, ref, timer, p, len(cols), f"phase3 {wf} {lo.shape[0]}x{len(cols)}", True
        ))
    cols, lo, hi = big
    p = ops_mod._pack_run_columns(cols, lo, hi, dev)
    main = check_rb_kernel(
        torch, rb, ref, timer, p, len(cols),
        f"identity {RB_SIDE}x{RB_SIDE} {lo.shape[0]}x{len(cols)}", True,
    )
    records.append(main)
    del p
    ops_ms = host_ms(torch, lambda: ops_mod.run_boundaries(cols, lo, hi, device="cuda"))
    main["ops_ms"] = ops_ms
    log(f"  ops.run_boundaries {main['shape']}: total={ops_ms:.1f}ms "
        "(host clock, median of 3; columns uploaded and packed on the card)")
    return main, records


def run_phase(torch, wrappers, name, fn):
    """Run one phase; log its wall time, each kernel's launches during it
    and the peak CUDA memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = " ".join(f"{k}+={w.launches - before[k]}" for k, w in wrappers.items())
    log(f"[phase {name}] wall={dt:.2f}s {launched} "
        f"peak_cuda_mem={torch.cuda.max_memory_allocated()}B")
    return out


def ptxas_summary(text: str) -> list:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its name
    with its template arguments (a tile kernel's Geometry: r rows, threads,
    attributes a pass), registers and spill bytes."""
    lines, name = [], None
    for line in text.splitlines():
        entry = re.search(r"entry function '[^']*?([a-z][a-z_]*_kernel)(\w*?)E[vP]", line)
        if entry:
            args = re.findall(r"Li(\d+)E", entry.group(2))
            name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        elif name and "spill" in line:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            name += f" spill {spill.group(1)}/{spill.group(2)} B"
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name} {regs.group(1)} registers")
            name = None
    return lines


def main_path(wrappers, names, phase):
    """Zero the counters of ``names``, run ``phase`` (a callable), read
    them; each kernel must have launched."""
    for k in names:
        wrappers[k].launches = 0
    out = phase()
    launches = {k: wrappers[k].launches for k in names}
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} never launched on its path")
    return out, launches


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--before", type=Path, default=None,
        help="csrc directory of an earlier commit: its kernels are built too and "
             "timed beside these in the same call (ms_before)",
    )
    parser.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-world", type=int, default=DP_RANKS, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-model", type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-layers", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.mesh_rank is not None:  # one rank of phase 12a or 13
        return mesh_worker(args.mesh_rank, args.mesh_world, args.mesh_model, args.mesh_layers,
                           args.mesh_dir)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core as core
        from repro_torch.core import capture as C
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels import ops as ops_mod
        from repro_torch.kernels import range_join as rj
        from repro_torch.kernels import run_boundary as rb
        from repro_torch.core import intervals, oplib, provrc
        from repro_torch.tools import fsck
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2

    card = gpu_name_and_power()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    before_procs = start_before_build(_build, args.before) if args.before else None
    lib = _build.load()
    before = finish_before_build(_build, before_procs, lib) if before_procs else None
    log(f"[phase 1 build] {time.perf_counter() - t0:.2f}s -> {_build.build().name}"
        + (f" (and {args.before}, for ms_before)" if before else ""))
    for line in ptxas_summary(_build.build().with_suffix(".log").read_text()):
        log(f"  ptxas: {line}")
    timer = KernelTimer(torch, lib, before)

    wrappers = {
        "range_join_mask": rj.range_join_mask,
        "range_join_tile_masks": rj.range_join_tile_masks,
        "run_boundaries_packed": rb.run_boundaries_packed,
    }
    joins = ("range_join_mask", "range_join_tile_masks")
    records = run_phase(
        torch, wrappers, "2 kernels vs plain",
        lambda: phase_kernels(torch, rj, ref, timer, ops_mod),
    )

    # the main path, phases 3-5: the counters count only their launches
    def query_path():
        seen.phase = 3
        p3 = run_phase(
            torch, wrappers, "3 fig8/9 ingest+query",
            lambda: phase_fig89(core, C, FIG89_SIZES, "cuda", seen),
        )
        seen.phase = 4
        accel = run_phase(
            torch, wrappers, "4 accel DAG frontiers",
            lambda: phase_accel(core, *ACCEL, "cuda"),
        )
        seen.phase = 5
        run_phase(
            torch, wrappers, "5 per-hop dense route",
            lambda: phase_perhop_dense(core, 20_000, 16, 200, "cuda"),
        )
        return p3, accel

    with MainPathRecorder(ops_mod, provrc) as seen:
        (p3, accel), launches = main_path(wrappers, joins, query_path)
    log(f"main-path launches: {launches}")

    main_recs, main_records = run_phase(
        torch, wrappers, "6 kernels vs plain on the main path's operands",
        lambda: phase_main_operands(torch, rj, ref, timer, ops_mod, seen),
    )

    # the store's path, phase 7
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    # phases 7-9 keep their stores in one directory (phase 9 checks phase 7's)
    with tempfile.TemporaryDirectory(prefix="smoke_store_", dir=build_dir) as workdir:
        store, store_launches = main_path(wrappers, joins, lambda: run_phase(
            torch, wrappers, "7 durable store",
            lambda: phase_store(core, C, FIG89_SIZES, p3, (*accel, *ACCEL), "cuda", workdir),
        ))
        log(f"store-path launches: {store_launches}")

        # the run-boundary path, phase 8
        (tables, big), rb_launches = main_path(
            wrappers, ("run_boundaries_packed",),
            lambda: run_phase(
                torch, wrappers, "8a ops.run_boundaries on the main path's tables",
                lambda: phase_rb_main(ops_mod, intervals, provrc, seen),
            ),
        )
        launches.update(rb_launches)
        log(f"run-boundary path launches: {rb_launches}")
        rb_main, rb_records = run_phase(
            torch, wrappers, "8b run_boundaries_packed vs plain",
            lambda: phase_rb_checks(torch, rb, ref, timer, ops_mod, tables, big),
        )
        main_recs["run_boundaries_packed"] = rb_main
        main_records["run_boundaries_packed"] = rb_records

        # the sharded store's path, phase 9 (it also checks phase 7's stores)
        store_roots = {"phase7_fig89": os.path.join(workdir, "fig89"),
                       "phase7_accel": os.path.join(workdir, "accel")}
        sharded, shard_launches = main_path(wrappers, joins, lambda: run_phase(
            torch, wrappers, "9 sharded store",
            lambda: phase_sharded(torch, core, C, oplib, fsck, wrappers, card, FIG89_SIZES, p3,
                                  (*accel, *ACCEL), store_roots, workdir),
        ))
    log(f"shard-path launches: {shard_launches}")

    # the serving path, phase 10: the LM stack has no kernel of its own; its
    # pipeline's lineage queries may launch the joins, counted from zero here
    for w in wrappers.values():
        w.launches = 0

    def serve():
        with torch.no_grad():
            return phase_serve(torch, core, card)

    serving = run_phase(torch, wrappers, "10 serving", serve)
    serve_launches = {k: w.launches for k, w in wrappers.items()}
    log(f"serve-path launches: {serve_launches}")

    # the training path, phase 11: the LM stack has no kernel of its own;
    # the pipeline's lineage queries (11d) must launch range_join_mask
    for w in wrappers.values():
        w.launches = 0
    keep: dict = {}
    with tempfile.TemporaryDirectory(prefix="smoke_train_", dir=build_dir) as workdir:
        training, _ = main_path(wrappers, ("range_join_mask",), lambda: run_phase(
            torch, wrappers, "11 training", lambda: phase_train(torch, core, card, workdir,
                                                                keep)))
        train_launches = {k: w.launches for k, w in wrappers.items()}
        log(f"train-path launches: {train_launches}")

        # the distributed path, phase 12: no kernel of its own; the ranks of
        # 12a report theirs, 12b runs here, counted from zero
        for w in wrappers.values():
            w.launches = 0
        dp = run_phase(torch, wrappers, "12a data-parallel training under ZeRO-3",
                       lambda: phase_mesh(torch, card, workdir, mesh_reference(torch, DP_LAYERS),
                                          DP_RANKS, 1, "12a"))
        dp["nccl"] = run_phase(torch, wrappers, "12b one-rank nccl group",
                               lambda: phase_nccl(torch, card, workdir, keep))
        dp_launches = {k: w.launches for k, w in wrappers.items()}
        log(f"distributed-path launches: {dp_launches} (ranks of 12a: {dp['launches']})")

        # the mesh path, phase 13: its ranks count their launches from zero;
        # rank 0's lineage queries must launch range_join_mask
        for w in wrappers.values():
            w.launches = 0
        tp = run_phase(torch, wrappers, "13 tensor-parallel and ZeRO-3 training on a (2, 2) mesh",
                       lambda: phase_mesh(torch, card, workdir, keep, TP_RANKS, TP_MODEL, "13"))
        tp_launches = tp["launches"]
        log(f"mesh-path launches (its ranks): {tp_launches}")
    keep.clear()

    kernels = []
    for name, rec in main_recs.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(
                r["max_abs_err"] for r in records.get(name, []) + main_records[name]
            ),
            "ms": rec["ms"],
            "ms_before": rec["ms_before"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
            "wrapper_ms": rec["wrapper_ms"],
            "shape": rec["shape"],
            **({"launches_store_path": store_launches[name],
                "launches_shard_path": shard_launches[name]} if name in joins else {}),
            "launches_serve_path": serve_launches[name],
            "launches_train_path": train_launches[name],
            "launches_dp_path": dp_launches[name],
            "launches_tp_path": tp_launches[name],
            **({"ops_ms": rec["ops_ms"]} if "ops_ms" in rec else {}),
        })
    log(f"store: {json.dumps(store)}")
    log(f"sharded: {json.dumps(sharded)}")
    log(f"serving: {json.dumps(serving)}")
    log(f"training: {json.dumps(training)}")
    log(f"distributed: {json.dumps(dp)}")
    log(f"mesh: {json.dumps(tp)}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
