"""Plain PyTorch versions of the range-join kernels (the ``ref.py`` contract).

The port's counterpart of ``repro.kernels.ref``.  Each hand-written CUDA
kernel in :mod:`repro_torch.kernels.range_join` must match these exactly
(integer outputs, zero tolerance); they are also what a CPU tensor runs.
Both return ``uint8`` 0/1 masks, the CUDA kernels' output type.

The attribute loop evaluates one ``[NQ, NR]`` comparison at a time instead
of broadcasting an ``[NQ, NR, n_attrs]`` cube, so the intermediate is the
size of the mask, whatever the width.
"""

from __future__ import annotations

import torch

LANES = 128


def _overlap(q: torch.Tensor, r: torch.Tensor, n_attrs: int) -> torch.Tensor:
    """``∧_j (q.lo_j ≤ r.hi_j ∧ r.lo_j ≤ q.hi_j)`` over the last two dims:
    ``q`` is ``[..., NQ, LANES]``, ``r`` is ``[..., NR, LANES]``."""
    ok = torch.ones(
        q.shape[:-1] + (r.shape[-2],), dtype=torch.bool, device=q.device
    )
    for j in range(n_attrs):
        q_lo = q[..., :, j].unsqueeze(-1)
        q_hi = q[..., :, n_attrs + j].unsqueeze(-1)
        r_lo = r[..., :, j].unsqueeze(-2)
        r_hi = r[..., :, n_attrs + j].unsqueeze(-2)
        ok &= (q_lo <= r_hi) & (r_lo <= q_hi)
    return ok


def range_join_mask_ref(
    q_packed: torch.Tensor, r_packed: torch.Tensor, n_attrs: int
) -> torch.Tensor:
    """Plain version of ``range_join.range_join_mask``: ``[NQ, NR]`` uint8."""
    return _overlap(q_packed, r_packed, n_attrs).to(torch.uint8)


def range_join_tile_masks_ref(
    q_packed: torch.Tensor,
    r_packed: torch.Tensor,
    tile_q: torch.Tensor,
    tile_r: torch.Tensor,
    n_attrs: int,
    block_q: int,
    block_r: int,
) -> torch.Tensor:
    """Plain version of ``range_join.range_join_tile_masks``.

    Tile ``t`` is the mask of q rows ``[tile_q[t]*block_q, +block_q)``
    against r rows ``[tile_r[t]*block_r, +block_r)``: ``[T, block_q,
    block_r]`` uint8.
    """
    q_blocks = q_packed.reshape(-1, block_q, LANES)[tile_q.long()]
    r_blocks = r_packed.reshape(-1, block_r, LANES)[tile_r.long()]
    return _overlap(q_blocks, r_blocks, n_attrs).to(torch.uint8)
