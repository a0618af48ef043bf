"""Public wrappers around the CUDA range-join kernels.

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

``run_boundaries`` (the ``run_boundaries_packed`` kernel) is still to be
ported: ProvRC's encoder does not call it (ROADMAP §2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .range_join import (
    LANES,
    check_lane_capacity,
    range_join_mask,
    range_join_tile_masks,
)

__all__ = [
    "range_join_pairs",
    "segmented_range_join_pairs",
    "resolve_device",
    "fits_int32",
]

_I32 = np.iinfo(np.int32)


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device a join runs on: ``cuda`` (raises without CUDA) or ``cpu``.

    There is no fallback: a caller that names CUDA on a machine without it
    gets an error, never the plain CPU path in its place.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
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


def _require_int32(*arrays: np.ndarray) -> None:
    if not fits_int32(*arrays):
        raise ValueError(
            "coordinates outside the int32 range cannot be packed for the "
            "kernel path (they would wrap); route this join to the numpy "
            "dense path (fits_int32 gates this)"
        )


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


def range_join_pairs(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    r_lo: np.ndarray,
    r_hi: np.ndarray,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """All (query row, table row) index pairs whose boxes overlap.

    Kernel-accelerated replacement for the broadcasting pass inside
    ``repro_torch.core.query.theta_join``.  Raises for joins the kernel
    cannot express faithfully (lane capacity, int32 overflow) — the
    caller's routing (``repro_torch.core.query._kernel_pairs``) checks the
    same gates and takes the numpy path before ever reaching this point.
    The mask kernel tiles internally, so unlike the reference this takes no
    launch geometry.
    """
    dev = resolve_device(device)
    nq, l = q_lo.shape
    nr = r_lo.shape[0]
    if nq == 0 or nr == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    check_lane_capacity(l)
    _require_int32(q_lo, q_hi, r_lo, r_hi)
    mask = range_join_mask(
        torch.from_numpy(_pack_boxes(q_lo, q_hi, l)).to(dev),
        torch.from_numpy(_pack_boxes(r_lo, r_hi, l)).to(dev),
        n_attrs=l,
    )
    idx = _nonzero_rows(mask)
    return idx[:, 0].astype(np.int64), idx[:, 1].astype(np.int64)


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


class _TileSchedule(NamedTuple):
    """Block-diagonal launch operands: per-segment packs padded to block
    multiples, concatenated, and the diagonal tile schedule over them."""

    q: np.ndarray  # [sum padded q rows, LANES] int32
    r: np.ndarray  # [sum padded r rows, LANES] int32
    tile_q: np.ndarray  # [T] int64 q-block index per tile
    tile_r: np.ndarray  # [T] int64 r-block index per tile
    nrb: np.ndarray  # r blocks per segment
    q_blk_off: np.ndarray  # first q block of each segment (+ total)
    r_blk_off: np.ndarray  # first r block of each segment (+ total)
    tile_start: np.ndarray  # first tile of each segment (+ total)


def _blockdiag_schedule(
    segments: "list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]",
    n_attrs: int,
    block_q: int,
    block_r: int,
) -> _TileSchedule:
    """Pack each segment on its own (tiles never straddle segments, so no
    segment-id lane is spent) and enumerate the diagonal tile schedule:
    segment-major, q-block outer / r-block inner."""
    q_parts = [
        _pad_packed_rows(_pack_boxes(s[0], s[1], n_attrs), block_q, n_attrs)
        for s in segments
    ]
    r_parts = [
        _pad_packed_rows(_pack_boxes(s[2], s[3], n_attrs), block_r, n_attrs)
        for s in segments
    ]
    nqb = np.array([p.shape[0] // block_q for p in q_parts], np.int64)
    nrb = np.array([p.shape[0] // block_r for p in r_parts], np.int64)
    q_blk_off = np.concatenate([[0], np.cumsum(nqb)])
    r_blk_off = np.concatenate([[0], np.cumsum(nrb)])
    tile_start = np.concatenate([[0], np.cumsum(nqb * nrb)])
    tile_q = np.concatenate(
        [q_blk_off[s] + np.repeat(np.arange(nqb[s]), nrb[s]) for s in range(len(segments))]
    ).astype(np.int64)
    tile_r = np.concatenate(
        [r_blk_off[s] + np.tile(np.arange(nrb[s]), int(nqb[s])) for s in range(len(segments))]
    ).astype(np.int64)
    return _TileSchedule(
        np.concatenate(q_parts, axis=0),
        np.concatenate(r_parts, axis=0),
        tile_q,
        tile_r,
        nrb,
        q_blk_off,
        r_blk_off,
        tile_start,
    )


def _blockdiag_pairs(
    segments: "list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]",
    n_attrs: int,
    block_q: int,
    block_r: int,
    device: torch.device,
) -> tuple[list[tuple[np.ndarray, np.ndarray]], int, int]:
    """Per-segment pairs via the tile-scheduled (block-diagonal) kernel.

    The schedule comes from :func:`_blockdiag_schedule`, and pair
    extraction runs on the device over the ``[T, block_q, block_r]`` tile
    stack — only the pairs come back to the host.  Returns the per-segment
    pair lists plus (padded rows, tiles visited).
    """
    sched = _blockdiag_schedule(segments, n_attrs, block_q, block_r)
    tile_q, tile_r = sched.tile_q, sched.tile_r
    nrb, q_blk_off, r_blk_off = sched.nrb, sched.q_blk_off, sched.r_blk_off
    tile_start = sched.tile_start
    n_tiles = int(tile_start[-1])
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if n_tiles == 0:
        return [empty for _ in segments], 0, 0
    masks = range_join_tile_masks(
        torch.from_numpy(sched.q).to(device),
        torch.from_numpy(sched.r).to(device),
        # the schedule stays on the host: the wrapper checks and uploads it
        # dslint: ignore[int32-cast] block indices, bounded by row count/block
        torch.from_numpy(tile_q.astype(np.int32)),
        # dslint: ignore[int32-cast] block indices, bounded by row count/block
        torch.from_numpy(tile_r.astype(np.int32)),
        n_attrs=n_attrs,
        block_q=block_q,
        block_r=block_r,
    )
    flat = _nonzero_rows(masks.reshape(-1))[:, 0]
    t, rem = np.divmod(flat, block_q * block_r)
    lq, lr = np.divmod(rem, block_r)
    qi_pad = tile_q[t] * block_q + lq  # global padded-row coordinates
    ri_pad = tile_r[t] * block_r + lr
    # tiles are segment-grouped and flatnonzero is tile-major, so one cut
    # per segment recovers the per-join slices
    cuts = np.searchsorted(t, tile_start[1:-1])
    out = []
    for s, (qs, rs) in enumerate(
        zip(np.split(qi_pad, cuts), np.split(ri_pad, cuts))
    ):
        qi = qs - q_blk_off[s] * block_q
        ri = rs - r_blk_off[s] * block_r
        keep = (qi < segments[s][0].shape[0]) & (ri < segments[s][2].shape[0])
        if not keep.all():
            qi, ri = qi[keep], ri[keep]
        if nrb[s] > 1:
            # tiles run r-block inner, so segments spanning several r blocks
            # need a row-major resort to match the dense oracle's pair order
            order = np.lexsort((ri, qi))
            qi, ri = qi[order], ri[order]
        out.append(
            (qi.astype(np.int64, copy=False), ri.astype(np.int64, copy=False))
        )
    rows_padded = int(sched.q.shape[0] + sched.r.shape[0])
    return out, rows_padded, n_tiles


def segmented_range_join_pairs(
    segments: "list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]",
    block_q: int = 256,
    block_r: int = 256,
    device: "str | torch.device" = "cuda",
    layout: str = "auto",
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
    :func:`range_join_pairs`.
    """
    dev = resolve_device(device)
    geometry = (block_q, block_r)
    if not segments:
        return [], {
            "rows": 0, "rows_padded": 0, "launches": 0, "layout": "dense",
            "geometry": geometry, "tiles_visited": 0, "tiles_skipped": 0,
        }
    if layout not in ("auto", "dense", "blockdiag"):
        raise ValueError(f"unknown launch layout {layout!r}")
    l_max = max(s[0].shape[1] for s in segments)
    for q_lo, q_hi, r_lo, r_hi in segments:
        _require_int32(q_lo, q_hi, r_lo, r_hi)
    nq_tot = sum(s[0].shape[0] for s in segments)
    nr_tot = sum(s[2].shape[0] for s in segments)
    rows = int(nq_tot + nr_tot)
    # tile bills for both schedules over the same segments: the masked
    # cross product pays the full grid, the diagonal pays per-segment
    # ceil-padded blocks — auto takes the cheaper, and the difference is
    # what io_stats reports as skipped
    cross_tiles = -(-nq_tot // block_q) * -(-nr_tot // block_r)
    diag_tiles = sum(
        -(-s[0].shape[0] // block_q) * -(-s[2].shape[0] // block_r)
        for s in segments
    )
    if layout == "auto":
        layout = (
            "blockdiag"
            if len(segments) > 1 and diag_tiles < cross_tiles
            else "dense"
        )
    if layout == "blockdiag":
        check_lane_capacity(l_max)  # no segment lane: tiles never cross segments
        out, rows_padded, visited = _blockdiag_pairs(
            segments, l_max, block_q, block_r, dev
        )
        return out, {
            "rows": rows,
            "rows_padded": rows_padded,
            "launches": 1,
            "layout": "blockdiag",
            "geometry": geometry,
            "tiles_visited": visited,
            "tiles_skipped": max(0, int(cross_tiles - visited)),
        }

    # masked dense cross-product launch
    segmented = len(segments) > 1
    n_attrs = l_max + (1 if segmented else 0)  # + segment-id lane pair
    check_lane_capacity(l_max, segmented=segmented)

    def pack_side(arrs: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
        parts = []
        for seg, (lo, hi) in enumerate(arrs):
            p = _pack_boxes(lo, hi, n_attrs)
            if segmented:
                p[:, l_max] = seg  # segment id: lo = hi = seg
                p[:, n_attrs + l_max] = seg
            parts.append(p)
        return np.concatenate(parts, axis=0)

    qp = pack_side([(s[0], s[1]) for s in segments])
    rp = pack_side([(s[2], s[3]) for s in segments])
    q_off = np.cumsum([0] + [s[0].shape[0] for s in segments])
    r_off = np.cumsum([0] + [s[2].shape[0] for s in segments])
    mask = range_join_mask(
        torch.from_numpy(qp).to(dev), torch.from_numpy(rp).to(dev), n_attrs=n_attrs
    )
    idx = _nonzero_rows(mask)
    qi, ri = idx[:, 0], idx[:, 1]
    # pairs are qi-major and the segment lane confines ri to the segment's
    # own column range, so one cut per segment recovers the per-join lists
    cuts = np.searchsorted(qi, q_off[1:-1])
    out = []
    for seg, (qs, rs) in enumerate(
        zip(np.split(qi, cuts), np.split(ri, cuts))
    ):
        out.append(
            (
                (qs - q_off[seg]).astype(np.int64),
                (rs - r_off[seg]).astype(np.int64),
            )
        )
    rows_padded = int(
        -(-qp.shape[0] // block_q) * block_q + -(-rp.shape[0] // block_r) * block_r
    )
    return out, {
        "rows": rows,
        "rows_padded": rows_padded,
        "launches": 1,
        "layout": "dense",
        "geometry": geometry,
        "tiles_visited": int(cross_tiles),
        "tiles_skipped": 0,
    }
