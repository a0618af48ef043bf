#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card (exact
   equality) and time, as medians over CUDA events: the kernel's own
   launch into a preallocated output (``ms``), the wrapper a caller uses
   (``wrapper_ms``: output allocation, operand and schedule checks, launch)
   and the plain version (``plain_ms``), on made-up operands;
3. DSLog ingest + explicit-path ``prov_query`` over the paper's fig 8/9
   workflows at their published sizes, checked against a raw-join oracle;
4. batched frontiers: the accel DAG queried with the per-hop loop and the
   batched executor, bit-identical, checked against a bijection oracle;
5. the per-hop dense route: ``theta_join(path="dense")`` on a poorly
   compressible 20,000-row table, equal to ``path="index"``;
6. phase 2's checks and timings again, on the operands phases 3-5 handed
   the kernels (recorded as they ran), and for each phase 4 frontier the
   time of the whole pair pipeline (``pipeline``) at each tile size.

Phases 3-5 are the port's main path: both kernels' launch counters are
zeroed before phase 3 and must have risen after phase 5; the JSON line
reports phase 6's numbers for the main path's own operands.  Any failure
raises and exits non-zero.  Without CUDA, or without the port beside this
script, it exits non-zero and prints no result.  The last three stdout
lines are the card's name and power limit, a JSON object of per-kernel
numbers, and ``{"ok": true, "device": {...}}``.

The workflow constructors and the raw-join oracle are this script's own copies
of ``benchmarks/fig89_query.py``'s (lines 57-167, 247-255, 810-870), so it
needs nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
# block-diagonal tile sizes timed on the main path's first frontier: the
# port launches at DEFAULT_GEOMETRY (256x256); these are the alternatives
TILE_GEOMETRIES = ((64, 64), (64, 128), (128, 128), (128, 256), (256, 128), (256, 256))

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/range_join.cu"
REPLACES = {
    "range_join_mask": "src/repro/kernels/range_join.py:118",
    "range_join_tile_masks": "src/repro/kernels/range_join.py:198",
}


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


def build_accel_dag(DSLog, LineageRelation, shape, branches, hops, device, seed=0):
    """``src`` fans out to ``branches`` chains of ``hops`` random bijections
    that all fan back into ``out``; returns the store and each branch's
    relations (for the oracle)."""
    rng = np.random.default_rng(seed)
    log_ = DSLog(store_forward=True, device=device)
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
    return log_, chains


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
def packed_boxes(torch, rng, n, n_attrs, device, seg=None):
    """Packed [n, 128] int32 boxes.  Up to three attributes discriminate;
    the rest always overlap, so wide masks keep real pairs and every lane
    is read.  ``seg`` puts a segment id in the last attribute (lo = hi)."""
    p = np.zeros((n, 128), np.int32)
    for j in range(n_attrs):
        if seg is not None and j == n_attrs - 1:
            lo = seg
            hi = seg
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
    after one untimed warm-up."""
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


def check_mask_kernel(torch, rj, ref, lib, q, r, n_attrs, label):
    """Hold ``range_join_mask`` on ``q``/``r`` against its plain version
    (exact) and time the kernel, the wrapper and the plain version."""
    dev = "cuda"
    nq, nr = q.shape[0], r.shape[0]
    got = rj.range_join_mask(q, r, n_attrs=n_attrs)
    want = plain_blocked(torch, ref.range_join_mask_ref, q, r, n_attrs)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"range_join_mask differs from plain at {label}")
    out = torch.empty((nq, nr), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(torch, lambda: checked(lib.rj_range_join_mask(
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
        f"kernel={ms:.4f}ms wrapper={wrapper_ms:.4f}ms plain={plain_ms:.4f}ms "
        f"bound={b_ms:.4f}ms ({b_by}) bytes={bytes_moved} compares={ops}"
    )
    return {"shape": label, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def synthetic_mask(torch, rj, ref, lib, rng, nq, nr, n_attrs, seg_lane=False):
    seg_q = np.sort(rng.integers(0, 4, nq)) if seg_lane else None
    seg_r = np.sort(rng.integers(0, 4, nr)) if seg_lane else None
    q = packed_boxes(torch, rng, nq, n_attrs, "cuda", seg_q)
    r = packed_boxes(torch, rng, nr, n_attrs, "cuda", seg_r)
    label = f"{nq}x{nr}x{n_attrs}" + ("+seg" if seg_lane else "")
    return check_mask_kernel(torch, rj, ref, lib, q, r, n_attrs, label)


def check_tile_kernel(torch, rj, ref, lib, ops_mod, segs, n_attrs, bq, br, name):
    """Hold ``range_join_tile_masks`` on the block-diagonal schedule of
    ``segs`` at ``bq`` x ``br`` against its plain version (exact) and time
    the kernel, the wrapper, the plain version and the whole pair pipeline
    (``segmented_range_join_pairs``: pack, upload, launch, extraction)."""
    dev = "cuda"
    sched = ops_mod._blockdiag_schedule(segs, n_attrs, bq, br)
    q = torch.from_numpy(sched.q).to(dev)
    r = torch.from_numpy(sched.r).to(dev)
    # the wrapper takes the schedule on the host; the raw launcher and the
    # plain version read it on the card
    tq_host = torch.from_numpy(sched.tile_q.astype(np.int32))
    tr_host = torch.from_numpy(sched.tile_r.astype(np.int32))
    tq, tr = tq_host.to(dev), tr_host.to(dev)

    def kernel():
        return rj.range_join_tile_masks(
            q, r, tq_host, tr_host, n_attrs=n_attrs, block_q=bq, block_r=br
        )

    def plain():
        return ref.range_join_tile_masks_ref(q, r, tq, tr, n_attrs, bq, br)

    def pairs():
        return ops_mod.segmented_range_join_pairs(
            segs, block_q=bq, block_r=br, device=dev, layout="blockdiag"
        )

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"range_join_tile_masks differs from plain at {name} {bq}x{br}")
    n_tiles = int(tq.shape[0])
    out = torch.empty((n_tiles, bq, br), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(torch, lambda: checked(lib.rj_range_join_tile_masks(
        q.data_ptr(), r.data_ptr(), tq.data_ptr(), tr.data_ptr(), out.data_ptr(),
        n_tiles, bq, br, n_attrs, stream,
    )))
    wrapper_ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain)
    pair_times = cuda_samples(torch, pairs)
    q_blocks = q.reshape(-1, bq, 128)[tq.long()]
    r_blocks = r.reshape(-1, br, 128)[tr.long()]
    ops = needed_compares(torch, q_blocks, r_blocks, n_attrs)
    rows = sched.q.shape[0] + sched.r.shape[0]
    bytes_moved = rows * 2 * n_attrs * 4 + n_tiles * 8 + n_tiles * bq * br
    b_ms, b_by = bound(bytes_moved, ops)
    label = f"{name} {len(segs)}seg/{rows}rows/{n_tiles}tiles@{bq}x{br}"
    pairs_ms = float(np.median(pair_times))
    log(
        f"  range_join_tile_masks {label}: equal pairs={int(got.sum())} "
        f"kernel={ms:.4f}ms wrapper={wrapper_ms:.4f}ms plain={plain_ms:.4f}ms "
        f"pipeline={pairs_ms:.4f}ms [{min(pair_times):.4f}-{max(pair_times):.4f}] "
        f"bound={b_ms:.4f}ms ({b_by}) bytes={bytes_moved} compares={ops}"
    )
    return {"shape": label, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "pipeline_ms": pairs_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err}


class MainPathRecorder:
    """Keeps the operands the main path hands the kernels, so that phase 6
    holds each kernel against its plain version on exactly those inputs.

    It wraps ``ops``' own references to the mask wrapper and to the
    block-diagonal scheduler; the wrappers still count every launch, and
    recording launches nothing.  ``phase`` tags what is recorded.
    """

    def __init__(self, ops_mod):
        self.ops = ops_mod
        self.phase = None
        self.mask_shapes: dict = {}  # phase -> [(nq, nr, n_attrs)]
        self.mask_first: dict = {}  # phase -> (q, r, n_attrs)
        self.mask_largest: dict = {}  # phase -> (q, r, n_attrs)
        self.frontiers: list = []  # (phase, segments, n_attrs, block_q, block_r)
        self._orig = (ops_mod.range_join_mask, ops_mod._blockdiag_schedule)

    def __enter__(self):
        mask, schedule = self._orig

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

        self.ops.range_join_mask = record_mask
        self.ops._blockdiag_schedule = record_schedule
        return self

    def __exit__(self, *exc):
        self.ops.range_join_mask, self.ops._blockdiag_schedule = self._orig


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #
def phase_kernels(torch, rj, ref, lib, ops_mod) -> dict:
    rng = np.random.default_rng(0)
    records = {"range_join_mask": [], "range_join_tile_masks": []}
    for nq in (255, 256, 257):
        for nr in (255, 256, 257):
            records["range_join_mask"].append(
                synthetic_mask(torch, rj, ref, lib, rng, nq, nr, 1)
            )
    for shape in ((1, 1, 3), (200, 20_000, 2), (3000, 20_000, 2), (20_000, 20_000, 4),
                  (2000, 3000, 64)):
        records["range_join_mask"].append(
            synthetic_mask(torch, rj, ref, lib, rng, *shape)
        )
    records["range_join_mask"].append(
        synthetic_mask(torch, rj, ref, lib, rng, 2000, 3000, 64, seg_lane=True)
    )
    # the block-diagonal layout on the accel ablation's ragged frontier:
    # 24 segments of 96-224 rows a side (~7,800 rows), 2 attributes
    segs = ragged_frontier(24, 96, 224, n_attrs=2, seed=11)
    for g in (64, 128, 256):
        records["range_join_tile_masks"].append(
            check_tile_kernel(torch, rj, ref, lib, ops_mod, segs, 2, g, g, "ragged")
        )
    return records


def phase_main_operands(torch, rj, ref, lib, ops_mod, seen) -> tuple[dict, dict]:
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
            torch, rj, ref, lib, q, r, a, f"phase3-largest {q.shape[0]}x{r.shape[0]}x{a}"
        ))
    if 5 not in seen.mask_first:
        raise AssertionError("phase 5 launched no range_join_mask")
    q, r, a = seen.mask_first[5]
    main["range_join_mask"] = check_mask_kernel(
        torch, rj, ref, lib, q, r, a, f"phase5 {q.shape[0]}x{r.shape[0]}x{a}"
    )
    records["range_join_mask"].append(main["range_join_mask"])
    fronts = [f for f in seen.frontiers if f[0] == 4]
    if not fronts:
        raise AssertionError("phase 4 launched no block-diagonal frontier")
    for i, (_, segs, n_attrs, bq, br) in enumerate(fronts):
        rec = check_tile_kernel(
            torch, rj, ref, lib, ops_mod, segs, n_attrs, bq, br, f"phase4-wave{i}"
        )
        records["range_join_tile_masks"].append(rec)
        main.setdefault("range_join_tile_masks", rec)
    # the sweep runs twice, the second time in reverse order, so a size's
    # place in the run cannot pass for its own cost
    _, segs, n_attrs, _, _ = fronts[0]
    for sweep, order in (("pass1", TILE_GEOMETRIES), ("pass2", TILE_GEOMETRIES[::-1])):
        for g in order:
            records["range_join_tile_masks"].append(check_tile_kernel(
                torch, rj, ref, lib, ops_mod, segs, n_attrs, *g, f"phase4-wave0 {sweep}"
            ))
    return main, records


def phase_fig89(core, C, sizes, device) -> None:
    for wf_name, rels in fig89_workflows(C, *sizes):
        t0 = time.perf_counter()
        store = core.DSLog(store_forward=True, device=device)
        names = [f"{wf_name}_a0"]
        store.define_array(names[0], rels[0].in_shape)
        for k, rel in enumerate(rels):
            names.append(f"{wf_name}_a{k + 1}")
            store.define_array(names[k + 1], rel.out_shape)
            store.register_operation(
                f"{wf_name}_op{k}", [names[k]], [names[k + 1]],
                capture=lambda r=rel: {(0, 0): r}, reuse=False,
            )
        t_ingest = time.perf_counter() - t0
        in_shape = rels[0].in_shape
        n_cells = int(np.prod(in_shape))
        line = []
        for sel in (0.001, 0.01, 0.1):
            k = max(1, int(n_cells * sel))
            cells = np.stack(np.unravel_index(np.arange(k), in_shape), axis=1)
            want = forward_join_rows(rels, cells)
            for merge in (True, False):
                t1 = time.perf_counter()
                res = store.prov_query(names, cells, merge=merge)
                dt = time.perf_counter() - t1
                got = box_flat_cells(res)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"{wf_name} sel={sel} merge={merge}: {got.size} cells "
                        f"vs oracle {want.size}"
                    )
                line.append(f"{sel}/{'m' if merge else 'nm'}={dt * 1e3:.1f}ms")
        log(
            f"  {wf_name:14s} ingest={t_ingest:.2f}s storage={store.storage_bytes()}B "
            + " ".join(line)
        )


def phase_accel(core, shape, branches, hops, n_cells, device) -> None:
    store, chains = build_accel_dag(
        core.DSLog, core.LineageRelation, shape, branches, hops, device
    )
    rng = np.random.default_rng(7)
    n = int(np.prod(shape))
    flat = rng.choice(n, size=n_cells, replace=False)
    cells = np.stack(np.unravel_index(flat, shape), axis=1)
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


def run_phase(torch, rj, name, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (rj.range_join_mask.launches, rj.range_join_tile_masks.launches)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(
        f"[phase {name}] wall={dt:.2f}s "
        f"range_join_mask+={rj.range_join_mask.launches - before[0]} "
        f"range_join_tile_masks+={rj.range_join_tile_masks.launches - before[1]} "
        f"peak_cuda_mem={torch.cuda.max_memory_allocated()}B"
    )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core as core
        from repro_torch.core import capture as C
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels import ops as ops_mod
        from repro_torch.kernels import range_join as rj
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2

    card = gpu_name_and_power()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[phase 1 build] {time.perf_counter() - t0:.2f}s -> {_build.build().name}")
    for line in _build.build().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    records = run_phase(
        torch, rj, "2 kernels vs plain",
        lambda: phase_kernels(torch, rj, ref, lib, ops_mod),
    )

    # the main path: counters count only the launches of phases 3-5
    rj.range_join_mask.launches = 0
    rj.range_join_tile_masks.launches = 0
    with MainPathRecorder(ops_mod) as seen:
        seen.phase = 3
        run_phase(
            torch, rj, "3 fig8/9 ingest+query",
            lambda: phase_fig89(core, C, (256, 20_000, 128, 6, 40_000), "cuda"),
        )
        seen.phase = 4
        run_phase(
            torch, rj, "4 accel DAG frontiers",
            lambda: phase_accel(core, (32, 31), 20, 2, 330, "cuda"),
        )
        seen.phase = 5
        run_phase(
            torch, rj, "5 per-hop dense route",
            lambda: phase_perhop_dense(core, 20_000, 16, 200, "cuda"),
        )
    launches = {
        "range_join_mask": rj.range_join_mask.launches,
        "range_join_tile_masks": rj.range_join_tile_masks.launches,
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    log(f"main-path launches: {launches}")

    main_recs, main_records = run_phase(
        torch, rj, "6 kernels vs plain on the main path's operands",
        lambda: phase_main_operands(torch, rj, ref, lib, ops_mod, seen),
    )
    kernels = []
    for name, rec in main_recs.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(
                r["max_abs_err"] for r in records[name] + main_records[name]
            ),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
            "wrapper_ms": rec["wrapper_ms"],
            "shape": rec["shape"],
        })
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
