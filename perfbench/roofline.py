"""The least time a range join's logical work needs on the card.

A copy of ``chip_smoke.py``'s ``needed_compares``/``bound`` arithmetic,
counted over the logical join, whatever implements it (not the launch's
padding, tiles or segment lanes): for a join of ``nq`` query boxes and
``nr`` table boxes over ``n_attrs`` attributes, each input box is read once
(``(nq + nr) * 2 * n_attrs * 4`` bytes of int32 bounds) and each mask cell
written once (``nq * nr`` bytes); a cell needs 2 compares per attribute up
to the first attribute that fails.
"""

from __future__ import annotations

import numpy as np

from perfbench.hw import COMPARES_PER_S, HBM_BYTES_PER_S


def join_bytes(nq: int, nr: int, n_attrs: int) -> int:
    return (nq + nr) * 2 * n_attrs * 4 + nq * nr


def needed_compares(torch, q_lo, q_hi, r_lo, r_hi, device="cpu", rows=2048) -> int:
    """Compares the boxes need: per (query, table) cell, 2 per attribute
    until the first attribute that fails."""
    if q_lo.shape[0] == 0 or r_lo.shape[0] == 0:
        return 0
    rl, rh = (torch.as_tensor(np.ascontiguousarray(a), device=device) for a in (r_lo, r_hi))
    total = 0
    for s in range(0, q_lo.shape[0], rows):
        ql = torch.as_tensor(np.ascontiguousarray(q_lo[s : s + rows]), device=device)
        qh = torch.as_tensor(np.ascontiguousarray(q_hi[s : s + rows]), device=device)
        alive = torch.ones((ql.shape[0], rl.shape[0]), dtype=torch.bool, device=device)
        for j in range(q_lo.shape[1]):
            total += 2 * int(alive.sum())
            alive &= (ql[:, j, None] <= rh[None, :, j]) & (rl[None, :, j] <= qh[:, j, None])
    return total


def bound_s(n_bytes: float, compares: float) -> tuple[float, str]:
    """The larger of the two times, and which one bounds the join."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, compares / COMPARES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "compares")


def launch_bound_s(torch, segments, device="cpu") -> float:
    """Least seconds of one launch that evaluates ``segments``, each
    ``(q_lo, q_hi, r_lo, r_hi)``."""
    n_bytes = compares = 0
    for q_lo, q_hi, r_lo, r_hi in segments:
        n_bytes += join_bytes(q_lo.shape[0], r_lo.shape[0], q_lo.shape[1])
        compares += needed_compares(torch, q_lo, q_hi, r_lo, r_hi, device)
    return bound_s(n_bytes, compares)[0]
