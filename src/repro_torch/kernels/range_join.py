"""Blocked multi-attribute interval-overlap join: CUDA kernels for Hopper.

The range join of the paper's θ-join (§V.B.1): for query boxes ``Q`` and
compressed-table key boxes ``R``,
``mask[q, r] = ∧_j  [q.lo_j, q.hi_j] ∩ [r.lo_j, r.hi_j] ≠ ∅``.

This is the port of ``repro.kernels.range_join``.  Its two Pallas TPU
kernels become the two hand-written CUDA kernels of
``csrc/range_join.cu`` (built by :mod:`._build`):

* :func:`range_join_mask` — the dense ``[NQ, NR]`` mask (the masked-dense
  batched layout and the per-hop dense fallback);
* :func:`range_join_tile_masks` — the block-diagonal layout: masks of an
  explicit ``(tile_q, tile_r)`` schedule, ``[T, block_q, block_r]``.

Operands keep the reference contract: packed ``[N, 128]`` int32, lo lanes
``[0, n_attrs)`` then hi lanes ``[n_attrs, 2*n_attrs)``.  The masks are
``uint8`` 0/1 (the reference returns int32; the nonzero positions are the
same).  A CUDA tensor goes to the kernel and a CPU tensor to the plain
version in :mod:`.ref`; there is no fallback from one to the other.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .ref import LANES, range_join_mask_ref, range_join_tile_masks_ref

__all__ = [
    "LANES",
    "check_lane_capacity",
    "range_join_mask",
    "range_join_tile_masks",
]


def fits_lanes(n_attrs: int, segmented: bool = False) -> bool:
    """Whether ``n_attrs`` interval attributes fit one 128-lane tile.

    Each attribute needs a lo and a hi lane; a segmented (batched) launch
    additionally spends one attribute on the segment id.  The one lane
    rule: the kernel wrappers, the planner's ``np:wide`` notes, the per-hop
    route and the executor all ask it.
    """
    return 2 * (n_attrs + int(segmented)) <= LANES


def check_lane_capacity(n_attrs: int, segmented: bool = False) -> None:
    """Raise when ``n_attrs`` interval attributes cannot fit one tile
    (:func:`fits_lanes`).

    Beyond this the dense route must run on the numpy path — callers that
    want the silent fallback check before packing, so reaching the kernel
    over-capacity is a hard error, not a degradation.
    """
    if not fits_lanes(n_attrs, segmented):
        total = n_attrs + (1 if segmented else 0)
        raise ValueError(
            f"range_join_mask lane capacity exceeded: {n_attrs} attributes"
            f"{' + 1 segment lane' if segmented else ''} need {2 * total} "
            f"lanes but one tile has {LANES}; route this join to the numpy "
            f"dense path instead"
        )


def _check_packed(*packed: torch.Tensor) -> torch.device:
    device = packed[0].device
    for p in packed:
        if p.dim() != 2 or p.shape[1] != LANES:
            raise ValueError(f"operands must be packed to {LANES} lanes")
        if p.dtype != torch.int32:
            raise ValueError(f"packed operands must be int32, got {p.dtype}")
        if p.device != device:
            raise ValueError("operands lie on different devices")
        if not p.is_contiguous():
            raise ValueError("packed operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# parallel plan execution can launch from several threads; the counters'
# read-modify-write must not lose a launch
_count_lock = threading.Lock()


def range_join_mask(
    q_packed: torch.Tensor, r_packed: torch.Tensor, *, n_attrs: int
) -> torch.Tensor:
    """Overlap mask of ``[NQ, 128]`` × ``[NR, 128]`` int32 boxes: ``[NQ, NR]``
    uint8.  Any row counts: the kernel bounds-checks the ragged edge."""
    check_lane_capacity(n_attrs)
    device = _check_packed(q_packed, r_packed)
    if device.type == "cpu":
        return range_join_mask_ref(q_packed, r_packed, n_attrs)
    nq, nr = q_packed.shape[0], r_packed.shape[0]
    out = torch.empty((nq, nr), dtype=torch.uint8, device=device)
    if nq and nr:
        lib = _build.load()
        with torch.cuda.device(device):
            err = lib.rj_range_join_mask(
                q_packed.data_ptr(), r_packed.data_ptr(), out.data_ptr(),
                nq, nr, n_attrs, _stream(device),
            )
        _build.check_launch(err, "range_join_mask")
        with _count_lock:
            range_join_mask.launches += 1
    return out


range_join_mask.launches = 0


def range_join_tile_masks(
    q_packed: torch.Tensor,
    r_packed: torch.Tensor,
    tile_q: torch.Tensor,
    tile_r: torch.Tensor,
    *,
    n_attrs: int,
    block_q: int = 256,
    block_r: int = 256,
) -> torch.Tensor:
    """Overlap masks for an explicit tile schedule (block-diagonal launch).

    ``tile_q``/``tile_r`` are int32 ``[T]`` *block indices* into the packed
    operands, whose rows must already be multiples of the block sizes (the
    segmented packer pads each segment on its own, which keeps a tile from
    straddling two segments).  Tile ``t`` evaluates q rows
    ``[tile_q[t]*block_q, ...)`` against r rows ``[tile_r[t]*block_r, ...)``
    and lands in ``out[t]``: ``[T, block_q, block_r]`` uint8.  Tiles not in
    the schedule are never computed.

    The schedule lies on the host, where it was built: its bounds are
    checked there, and a CUDA launch uploads it with the operands' stream,
    so the check never waits on the device.
    """
    check_lane_capacity(n_attrs)
    device = _check_packed(q_packed, r_packed)
    nq, nr = q_packed.shape[0], r_packed.shape[0]
    if block_q <= 0 or block_r <= 0 or nq % block_q or nr % block_r:
        raise ValueError(
            "tile-scheduled operands must be pre-padded to block multiples "
            f"(got {nq} q rows / {nr} r rows for {block_q}x{block_r} tiles)"
        )
    for t in (tile_q, tile_r):
        if t.dim() != 1 or t.dtype != torch.int32 or t.device.type != "cpu":
            raise ValueError("tile schedules must be 1-D int32 host tensors")
    if tile_q.shape != tile_r.shape:
        raise ValueError("tile_q and tile_r differ in length")
    n_tiles = tile_q.shape[0]
    if n_tiles and (
        int(tile_q.min()) < 0
        or int(tile_r.min()) < 0
        or int(tile_q.max()) >= nq // block_q
        or int(tile_r.max()) >= nr // block_r
    ):
        raise ValueError("tile schedule indexes blocks outside the operands")
    if device.type == "cpu":
        return range_join_tile_masks_ref(
            q_packed, r_packed, tile_q, tile_r, n_attrs, block_q, block_r
        )
    out = torch.empty((n_tiles, block_q, block_r), dtype=torch.uint8, device=device)
    if n_tiles:
        # one upload for both halves of the schedule
        sched = torch.stack([tile_q, tile_r]).to(device)
        lib = _build.load()
        with torch.cuda.device(device):
            err = lib.rj_range_join_tile_masks(
                q_packed.data_ptr(), r_packed.data_ptr(),
                sched[0].data_ptr(), sched[1].data_ptr(), out.data_ptr(),
                n_tiles, block_q, block_r, n_attrs, _stream(device),
            )
        _build.check_launch(err, "range_join_tile_masks")
        with _count_lock:
            range_join_tile_masks.launches += 1
    return out


range_join_tile_masks.launches = 0
