"""Public wrappers around the CUDA kernels (range joins, run boundaries).

The port of ``repro.kernels.ops``.  These handle packing/padding from the
natural numpy layouts used by ``repro_torch.core`` into the 128-lane int32
tiles the kernels expect, move the packs to the device the caller names,
and bring pair lists back as numpy.  ``device="cuda"`` (the default)
launches the hand-written kernels and raises when CUDA is not available;
``device="cpu"`` runs their plain PyTorch versions.  Where the reference
read a global ``default_interpret()``, every function here takes the device
explicitly.

The packers are int32: coordinates outside the int32 range cannot ride the
kernel path (they would silently wrap).  ``fits_int32`` is the gate callers
use to route oversized joins to the numpy dense path; handing out-of-range
values to a packer raises.

Both dense entry points run one pipeline: the query side checked
against int32, packed on the host and uploaded; the table side always a
device operand, one :func:`pack_table_side` pack per segment (a table's
resident pack, ``r_packs``, which ``CompressedTable.kernel_pack`` keeps;
else packed by the entry point); one launch of ``range_join_mask`` (the
masked dense layout) or ``range_join_tile_masks`` (the block-diagonal
one); and the layout's extractor.  :func:`range_join_pairs` is its
one-segment dense call.  The pipeline counts the bytes of every pack it
hands to the device in the module-level ``h2d_bytes`` (beside the kernel
wrappers' ``launches`` counters), and opens the spans ``ops.pack``,
``ops.upload``, ``ops.launch`` and ``ops.extract`` of the active query
trace (:mod:`repro_torch.obs.trace`).
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

from .range_join import (
    LANES,
    check_lane_capacity,
    range_join_mask,
    range_join_tile_masks,
)
from .run_boundary import run_boundaries_packed

__all__ = [
    "run_boundaries",
    "range_join_pairs",
    "segmented_range_join_pairs",
    "pack_table_side",
    "resolve_device",
    "fits_int32",
]

_I32 = np.iinfo(np.int32)
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)

# one join of a dense entry point: (q_lo, q_hi, r_lo, r_hi), [N, l] each
_Segment = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

# bytes of the packs the dense entry points handed to the device
h2d_bytes = 0
_h2d_lock = threading.Lock()


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` (raises without CUDA) or ``cpu``.

    There is no fallback: a caller that names CUDA on a machine without it
    gets an error, never the plain CPU path in its place.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU "
                "(the kernels' plain PyTorch versions)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def fits_int32(*arrays: np.ndarray) -> bool:
    """Whether every value survives an int32 pack without wrapping."""
    for a in arrays:
        if a.size and (a.min() < _I32.min or a.max() > _I32.max):
            return False
    return True


_INT32_ERROR = (
    "coordinates outside the int32 range cannot be packed for the kernel "
    "path (they would wrap); route this join to the numpy dense path "
    "(fits_int32 gates this)"
)


def _require_int32(*arrays: np.ndarray) -> None:
    if not fits_int32(*arrays):
        raise ValueError(_INT32_ERROR)


def run_boundaries(
    group_cols: list[np.ndarray],
    lo: np.ndarray,
    hi: np.ndarray,
    block_rows: int = 1024,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Boundary flags for sorted rows; drop-in for the numpy hot pass.

    ``group_cols`` are the equality columns, ``lo``/``hi`` the merge-column
    interval.  Values must fit int32 (array indices always do).  The live
    columns are uploaded to ``device``, packed there and flagged by the
    ``run_boundaries_packed`` kernel (its plain version on ``"cpu"``); the
    flags come back as a numpy bool array.
    """
    dev = resolve_device(device)
    flags = run_boundaries_packed(
        _pack_run_columns(group_cols, lo, hi, dev),
        n_keys=len(group_cols),
        block_rows=block_rows,
    )
    return flags.cpu().numpy().astype(bool)


def _pack_run_columns(
    group_cols: list[np.ndarray], lo: np.ndarray, hi: np.ndarray, device: torch.device
) -> torch.Tensor:
    """Pack sorted rows into the run-boundary kernel's ``[N, 128]`` int32
    layout on ``device``: key lanes ``[0, n_keys)``, then ``lo``, then
    ``hi``, the other lanes 0.  Only the ``n_keys + 2`` live columns cross
    to the device, as they are (48 bytes a row at 4 int64 keys, not 512);
    the int32 table is made there, and the int32 range is checked there
    too, so the host makes no pass over the rows."""
    n = lo.shape[0]
    n_keys = len(group_cols)
    if n_keys + 2 > LANES:
        raise ValueError(f"{n_keys} group columns do not fit one {LANES}-lane tile")
    packed = torch.zeros((n, LANES), dtype=torch.int32, device=device)
    extremes = []
    for c, col in enumerate((*group_cols, lo, hi)):
        t = torch.from_numpy(np.ascontiguousarray(col)).to(device)
        if t.dtype in _WIDE_UNSIGNED:
            # min/max are not defined on these types: widen to int64, where
            # a uint64 of 2**63 or more reads negative (out of range too)
            t = t.view(torch.int64) if t.dtype == torch.uint64 else t.to(torch.int64)
            if n:
                top = torch.where(t.min() < 0, math.inf, t.max().double())
                extremes += [torch.zeros_like(top), top]
        elif n:
            extremes += [t.min().double(), t.max().double()]
        packed[:, c] = t
    if extremes:
        lims = torch.stack(extremes).cpu()
        if lims.min() < _I32.min or lims.max() > _I32.max:
            raise ValueError(_INT32_ERROR)
    return packed


def _pack_run_table(
    group_cols: list[np.ndarray], lo: np.ndarray, hi: np.ndarray
) -> np.ndarray:
    """The packed ``[N, 128]`` int32 table of :func:`_pack_run_columns`, on
    the host."""
    return _pack_run_columns(group_cols, lo, hi, torch.device("cpu")).numpy()


def _to_device(device: torch.device, pack: np.ndarray) -> torch.Tensor:
    """The pack on ``device``, counted in ``h2d_bytes``."""
    global h2d_bytes
    out = torch.from_numpy(pack).to(device)
    with _h2d_lock:
        h2d_bytes += pack.nbytes
    return out


def _nonzero_rows(mask: torch.Tensor) -> np.ndarray:
    """Row-major coordinates of a mask's nonzeros, on the host (``[P, d]``
    int64, the order of ``np.nonzero`` / ``np.flatnonzero``).  Extraction
    runs where the mask lies, so only the pairs cross to the host."""
    return torch.nonzero(mask).cpu().numpy()


def _pack_boxes(lo: np.ndarray, hi: np.ndarray, n_attrs: int) -> np.ndarray:
    """Pack ``[N, l]`` lo/hi into the kernel's ``[N, 128]`` int32 layout.

    Lanes ``[0, n_attrs)`` hold lo columns, ``[n_attrs, 2*n_attrs)`` hi
    columns; attributes beyond ``lo.shape[1]`` (width padding in segmented
    packs) are left ``lo = hi = 0`` on *both* operands, which always
    overlaps and so never filters a pair.
    """
    n, l = lo.shape
    _require_int32(lo, hi)  # last line of defense at the cast site
    p = np.zeros((n, LANES), np.int32)
    p[:, :l] = lo.astype(np.int32)
    p[:, n_attrs : n_attrs + l] = hi.astype(np.int32)
    return p


def _pad_packed_rows(p: np.ndarray, mult: int, n_attrs: int) -> np.ndarray:
    """Pad packed rows to a multiple of ``mult`` with empty boxes.

    The host counterpart of the reference's ``range_join._pad_empty``
    (the CUDA mask kernel bounds-checks instead): padded rows carry
    ``lo = 1, hi = 0`` on every attribute lane, so they never overlap a
    padded row; real rows with coordinates spanning ``[≤0, ≥1]`` *can* still
    graze one, which is why tile extraction bounds-checks pairs against the
    segment's real row counts.
    """
    n = p.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return p
    row = np.zeros(LANES, np.int32)
    row[:n_attrs] = 1
    return np.concatenate([p, np.tile(row, (pad, 1))], axis=0)


def _pack_queries(
    segments: list[_Segment],
    n_attrs: int,
    seg_lane: "int | None" = None,
    block: "int | None" = None,
) -> np.ndarray:
    """The query side of every segment packed at ``n_attrs`` and
    concatenated: with ``seg_lane``, the segment id in lanes ``seg_lane``
    and ``n_attrs + seg_lane`` (``lo = hi = segment``, so rows only match
    within their own join); with ``block``, each segment padded to a
    multiple of ``block`` rows by :func:`_pad_packed_rows`."""
    parts = []
    for seg, (lo, hi, _, _) in enumerate(segments):
        p = _pack_boxes(lo, hi, n_attrs)
        if seg_lane is not None:
            p[:, seg_lane] = p[:, n_attrs + seg_lane] = seg
        if block is not None:
            p = _pad_packed_rows(p, block, n_attrs)
        parts.append(p)
    return np.concatenate(parts, axis=0)


def pack_table_side(
    lo: np.ndarray, hi: np.ndarray, device: "str | torch.device"
) -> torch.Tensor:
    """One table join side's kernel operand on ``device``: ``[N, 128]``
    int32 at the side's own width ``l`` (lo lanes ``[0, l)``, hi lanes
    ``[l, 2l)``).  Its bytes count in ``h2d_bytes``; it opens no span, so
    a fill made inside an entry point is charged to that entry point's
    ``ops.pack``.  A single-segment dense launch takes the pack as it is;
    any other re-lays it on the device (:func:`_assemble_r`)."""
    return _to_device(resolve_device(device), _pack_boxes(lo, hi, lo.shape[1]))


def _assemble_r(
    packs: "list[torch.Tensor]",
    segments: list[_Segment],
    n_attrs: int,
    seg_rows: "list[int]",
    seg_lane: "int | None" = None,
) -> torch.Tensor:
    """The ``r`` operand of a launch of several dense segments or of any
    block-diagonal one, made on the device from each segment's
    :func:`pack_table_side` pack: hi lanes moved from ``l`` to
    ``n_attrs``; ``seg_rows[s]`` rows for segment ``s``, those past its
    own rows (block padding) empty boxes ``lo = 1, hi = 0`` on lanes
    ``[0, n_attrs)``, as :func:`_pad_packed_rows` makes them; with
    ``seg_lane``, the segment id in lanes ``seg_lane`` and ``n_attrs +
    seg_lane``, as :func:`_pack_queries` sets it on the query side."""
    out = torch.zeros((sum(seg_rows), LANES), dtype=torch.int32, device=packs[0].device)
    off = 0
    for seg, (p, s, rows) in enumerate(zip(packs, segments, seg_rows)):
        n, l = s[2].shape
        out[off : off + n, :l] = p[:, :l]
        out[off : off + n, n_attrs : n_attrs + l] = p[:, l : 2 * l]
        if rows > n:
            out[off + n : off + rows, :n_attrs] = 1
        if seg_lane is not None:
            out[off : off + n, seg_lane] = seg
            out[off : off + n, n_attrs + seg_lane] = seg
        off += rows
    return out


def _resident_packs(r_packs: list, segments: list[_Segment]) -> "list[torch.Tensor]":
    """Each segment's resident ``r`` pack, from its getter, checked to
    cover the segment's table rows."""
    packs = [get() for get in r_packs]
    for p, s in zip(packs, segments):
        if p.shape != (s[2].shape[0], LANES):
            raise ValueError(
                f"a resident pack of shape {tuple(p.shape)} cannot serve a "
                f"table side of {s[2].shape[0]} rows"
            )
    return packs


class _TileSchedule(NamedTuple):
    """Block-diagonal launch operands: per-segment packs padded to block
    multiples, concatenated, and the diagonal tile schedule over them."""

    q: np.ndarray  # [sum padded q rows, LANES] int32, on the host
    r: torch.Tensor  # [sum padded r rows, LANES] int32, on the packs' device
    tile_q: np.ndarray  # [T] int64 q-block index per tile
    tile_r: np.ndarray  # [T] int64 r-block index per tile
    nrb: np.ndarray  # r blocks per segment
    q_blk_off: np.ndarray  # first q block of each segment (+ total)
    r_blk_off: np.ndarray  # first r block of each segment (+ total)
    tile_start: np.ndarray  # first tile of each segment (+ total)


def _blockdiag_schedule(
    segments: list[_Segment],
    n_attrs: int,
    block_q: int,
    block_r: int,
    packs: "list[torch.Tensor]",
) -> _TileSchedule:
    """Pack each segment's query side on its own (tiles never straddle
    segments, so no segment-id lane is spent), assemble the ``r`` operand
    from the segments' table packs on their device, and enumerate the
    diagonal tile schedule: segment-major, q-block outer / r-block inner."""
    nqb = np.array([-(-s[0].shape[0] // block_q) for s in segments], np.int64)
    nrb = np.array([-(-s[2].shape[0] // block_r) for s in segments], np.int64)
    q_blk_off = np.concatenate([[0], np.cumsum(nqb)])
    r_blk_off = np.concatenate([[0], np.cumsum(nrb)])
    tile_start = np.concatenate([[0], np.cumsum(nqb * nrb)])
    tile_q = np.concatenate(
        [q_blk_off[s] + np.repeat(np.arange(nqb[s]), nrb[s]) for s in range(len(segments))]
    ).astype(np.int64)
    tile_r = np.concatenate(
        [r_blk_off[s] + np.tile(np.arange(nrb[s]), int(nqb[s])) for s in range(len(segments))]
    ).astype(np.int64)
    q = _pack_queries(segments, n_attrs, block=block_q)
    r = _assemble_r(packs, segments, n_attrs, (nrb * block_r).tolist())
    return _TileSchedule(q, r, tile_q, tile_r, nrb, q_blk_off, r_blk_off, tile_start)


def _dense_extract(
    mask: torch.Tensor, segments: list[_Segment]
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-segment pairs of a masked dense launch's ``[NQ, NR]`` mask."""
    idx = _nonzero_rows(mask)
    qi, ri = idx[:, 0], idx[:, 1]
    q_off = np.cumsum([0] + [s[0].shape[0] for s in segments])
    r_off = np.cumsum([0] + [s[2].shape[0] for s in segments])
    # pairs are qi-major and the segment lane confines ri to the segment's
    # own column range, so one cut per segment recovers the per-join lists
    cuts = np.searchsorted(qi, q_off[1:-1])
    return [
        ((qs - q_off[seg]).astype(np.int64), (rs - r_off[seg]).astype(np.int64))
        for seg, (qs, rs) in enumerate(zip(np.split(qi, cuts), np.split(ri, cuts)))
    ]


def _tile_extract(
    masks: torch.Tensor,
    segments: list[_Segment],
    sched: _TileSchedule,
    block_q: int,
    block_r: int,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-segment pairs of a block-diagonal launch's ``[T, block_q,
    block_r]`` tile stack, bounds-checked against each segment's real rows
    and in row-major order."""
    flat = _nonzero_rows(masks.reshape(-1))[:, 0]
    t, rem = np.divmod(flat, block_q * block_r)
    lq, lr = np.divmod(rem, block_r)
    qi_pad = sched.tile_q[t] * block_q + lq  # global padded-row coordinates
    ri_pad = sched.tile_r[t] * block_r + lr
    # tiles are segment-grouped and flatnonzero is tile-major, so one cut
    # per segment recovers the per-join slices
    cuts = np.searchsorted(t, sched.tile_start[1:-1])
    out = []
    for s, (qs, rs) in enumerate(zip(np.split(qi_pad, cuts), np.split(ri_pad, cuts))):
        qi = qs - sched.q_blk_off[s] * block_q
        ri = rs - sched.r_blk_off[s] * block_r
        keep = (qi < segments[s][0].shape[0]) & (ri < segments[s][2].shape[0])
        if not keep.all():
            qi, ri = qi[keep], ri[keep]
        if sched.nrb[s] > 1:
            # tiles run r-block inner, so segments spanning several r blocks
            # need a row-major resort to match the dense oracle's pair order
            order = np.lexsort((ri, qi))
            qi, ri = qi[order], ri[order]
        out.append((qi.astype(np.int64, copy=False), ri.astype(np.int64, copy=False)))
    return out


def _join(
    segments: list[_Segment],
    r_packs: "list | None",
    layout: str,
    block_q: int,
    block_r: int,
    device: torch.device,
) -> tuple[list[tuple[np.ndarray, np.ndarray]], dict]:
    """The dense pipeline behind both entry points.

    ``ops.pack``: the query side's int32 check, the tile bills (and the
    choice of ``layout="auto"``), the lane check (a dense launch of
    several segments spends one more attribute on the segment id), each
    segment's table side — from its getter in ``r_packs``, or packed here
    by :func:`pack_table_side` where the caller keeps none resident — the
    query side packed on the host, and the table operand on the device: a
    single dense segment's pack as it is, otherwise made by
    :func:`_assemble_r`.  Then the query side's upload (``ops.upload``),
    the layout's kernel (``ops.launch``) and its extractor
    (``ops.extract``).  Returns the per-segment pair lists and the info of
    :func:`segmented_range_join_pairs`.
    """
    with obs_trace.span("ops.pack", "ops"):
        for s in segments:
            _require_int32(s[0], s[1])
        nq = sum(s[0].shape[0] for s in segments)
        nr = sum(s[2].shape[0] for s in segments)
        # tile bills for both schedules over the same segments: the masked
        # cross product pays the full grid, the diagonal pays per-segment
        # ceil-padded blocks — auto takes the cheaper, and the difference is
        # what io_stats reports as skipped
        cross_tiles = -(-nq // block_q) * -(-nr // block_r)
        if layout == "auto":
            diag_tiles = sum(
                -(-s[0].shape[0] // block_q) * -(-s[2].shape[0] // block_r)
                for s in segments
            )
            diag = len(segments) > 1 and diag_tiles < cross_tiles
            layout = "blockdiag" if diag else "dense"
        dense = layout == "dense"
        l_max = max(s[0].shape[1] for s in segments)
        segmented = dense and len(segments) > 1
        check_lane_capacity(l_max, segmented=segmented)
        if r_packs is None:
            packs = [pack_table_side(s[2], s[3], device) for s in segments]
        else:
            packs = _resident_packs(r_packs, segments)
        if dense:
            n_attrs = l_max + int(segmented)  # + segment-id lane pair
            seg_lane = l_max if segmented else None
            q = _pack_queries(segments, n_attrs, seg_lane)
            # one segment: n_attrs is the table's own width, so its pack is
            # the operand as it is
            r_t = _assemble_r(
                packs, segments, n_attrs, [s[2].shape[0] for s in segments], seg_lane
            ) if segmented else packs[0]
            visited = cross_tiles
            rows_padded = -(-nq // block_q) * block_q + -(-nr // block_r) * block_r
        else:
            n_attrs = l_max
            sched = _blockdiag_schedule(segments, n_attrs, block_q, block_r, packs)
            q, r_t = sched.q, sched.r
            visited = int(sched.tile_start[-1])
            rows_padded = q.shape[0] + r_t.shape[0] if visited else 0
    info = {
        "rows": int(nq + nr),
        "rows_padded": int(rows_padded),
        "launches": 1,
        "layout": layout,
        "geometry": (block_q, block_r),
        "tiles_visited": int(visited),
        "tiles_skipped": max(0, int(cross_tiles - visited)),
    }
    if not dense and visited == 0:  # every segment has an empty side
        return [(np.zeros(0, np.int64), np.zeros(0, np.int64)) for _ in segments], info
    with obs_trace.span("ops.upload", "ops"):
        q_t = _to_device(device, q)
    with obs_trace.span("ops.launch", "ops"):
        if dense:
            mask = range_join_mask(q_t, r_t, n_attrs=n_attrs)
        else:
            mask = range_join_tile_masks(
                q_t,
                r_t,
                # the schedule stays on the host: the wrapper checks and uploads it
                # dslint: ignore[int32-cast] block indices, bounded by row count/block
                torch.from_numpy(sched.tile_q.astype(np.int32)),
                # dslint: ignore[int32-cast] block indices, bounded by row count/block
                torch.from_numpy(sched.tile_r.astype(np.int32)),
                n_attrs=n_attrs,
                block_q=block_q,
                block_r=block_r,
            )
    with obs_trace.span("ops.extract", "ops"):
        if dense:
            return _dense_extract(mask, segments), info
        return _tile_extract(mask, segments, sched, block_q, block_r), info


def range_join_pairs(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    r_lo: np.ndarray,
    r_hi: np.ndarray,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """All (query row, table row) index pairs whose boxes overlap.

    Kernel-accelerated replacement for the broadcasting pass inside
    ``repro_torch.core.query.theta_join``: one dense segment of the
    pipeline behind :func:`segmented_range_join_pairs`.  Raises for joins
    the kernel cannot express faithfully (lane capacity, then int32
    overflow) — the caller's routing
    (``repro_torch.core.query._kernel_pairs``) checks the same gates and
    takes the numpy path before ever reaching this point.  The mask kernel
    tiles internally, so unlike the reference this takes no launch
    geometry.
    """
    dev = resolve_device(device)
    nq, l = q_lo.shape
    nr = r_lo.shape[0]
    if nq == 0 or nr == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    check_lane_capacity(l)
    # the block sizes only bill tiles, which this entry point does not report
    (pairs,), _ = _join([(q_lo, q_hi, r_lo, r_hi)], None, "dense", 256, 256, dev)
    return pairs


def segmented_range_join_pairs(
    segments: list[_Segment],
    block_q: int = 256,
    block_r: int = 256,
    device: "str | torch.device" = "cuda",
    layout: str = "auto",
    r_packs: "list | None" = None,
) -> tuple[list[tuple[np.ndarray, np.ndarray]], dict]:
    """Many independent range joins in **one** kernel launch.

    ``segments`` is a list of ``(q_lo, q_hi, r_lo, r_hi)`` joins; attribute
    widths are padded to the widest segment (spare attributes carry
    ``lo = hi = 0`` on both sides, never filtering).  Two launch layouts:

    * ``"dense"`` — one masked ``[NQ, 128] × [NR, 128]`` cross-product
      launch; with more than one segment, a spare-lane attribute holds the
      *segment id* with ``lo = hi = segment`` so rows only match within
      their own join (a single segment skips the lane).  The correctness
      oracle, and the cheaper plan for single-segment or tiny frontiers
      where per-segment padding would cost more than the cross product.
    * ``"blockdiag"`` — the tile-scheduled kernel
      (:func:`repro_torch.kernels.range_join.range_join_tile_masks`): only the
      ~K diagonal tiles of a K-segment frontier are visited, and the host
      reads back the tile stack instead of the full cross-product mask.

    ``layout="auto"`` charges both schedules in tiles and picks the
    cheaper.  Returns the per-segment ``(qi, ri)`` pair lists (row-major
    order, bit-identical between layouts and to a per-segment dense
    evaluation) plus occupancy info for ``io_stats``: ``tiles_visited`` is
    the executed schedule, ``tiles_skipped`` the cross-product tiles the
    block-diagonal schedule avoided.  ``device`` is as for
    :func:`range_join_pairs`.  Raises for joins the kernel cannot express
    faithfully (int32 overflow of the query side, then lane capacity).

    ``r_packs``, one zero-argument getter per segment, hands over each
    segment's table side already on ``device`` (:func:`pack_table_side`'s
    ``[N, 128]`` pack of ``r_lo``/``r_hi``, whose int32 range its owner
    checked).  The getters are called inside the ``ops.pack`` span; only
    the query side is then checked, packed and uploaded.  Without
    ``r_packs`` each table side is packed there by :func:`pack_table_side`
    and uploaded as it is.  The pair lists are the same either way.
    """
    dev = resolve_device(device)
    if not segments:
        return [], {
            "rows": 0, "rows_padded": 0, "launches": 0, "layout": "dense",
            "geometry": (block_q, block_r), "tiles_visited": 0, "tiles_skipped": 0,
        }
    if layout not in ("auto", "dense", "blockdiag"):
        raise ValueError(f"unknown launch layout {layout!r}")
    if r_packs is not None and len(r_packs) != len(segments):
        raise ValueError(f"{len(r_packs)} resident packs for {len(segments)} segments")
    return _join(segments, r_packs, layout, block_q, block_r, dev)
