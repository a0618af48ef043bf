"""GQA attention: naive-dot and chunked online-softmax, sliding-window
masking, KV-cache decode, optional QKV bias.

The port of ``repro.models.attention``.  Heads stay flat ([B, S, H, hd];
KV repeated to H for GQA) in the full-sequence paths, as in the reference.
The chunked path runs the FlashAttention recurrence over KV chunks in a
Python loop (the reference's ``lax.scan``), carrying the running (max,
sum, acc) triple, so peak score memory is ``[B, H, S_q, chunk]``.

Decode writes the new token's K/V into the preallocated cache in place
(the reference's ``dynamic_update_slice`` returns a new cache) and attends
against the *unrepeated* cache with a grouped einsum.

On a mesh whose model axis (``m`` ranks) splits the projections, the
reference's ``hint(x, "heads")`` decides the split under the
``attn_heads`` policy (``distributed.sharding.attention_axis``: the policy
``set_activation_mesh`` stored, ``"auto"`` without one), and
``attention_split`` maps it onto the weights' placement:

* ``"heads"`` — heads on ``model``, ``m`` dividing the query and KV
  heads: each rank its own heads, ``q``/``k``/``v`` column-parallel and
  ``o`` row-parallel;
* ``"q_heads"`` — the same where the split cuts a KV head (the reduced
  configs' 2 KV heads over 4): ``k``/``v`` whole on every model rank, each
  rank takes the KV heads of its query heads;
* ``"uneven"`` — heads on ``model`` under ``"tp_uneven"`` where ``m``
  does not divide them: each rank its ``torch.chunk`` block of the heads
  (JAX's padded blocks: 4, 4, 4, 2 for 14 over 4) from the weights
  gathered over ``model``, the partial outputs summed over ``model``;
* ``"seq"`` — the sequence on ``model`` (``"auto"`` where the heads do
  not divide and the sequence does, ``"seq"`` wherever it does): each
  rank projects ``q`` for its block of rows, attends them against the
  whole K/V and projects them by ``o``; the output rows are gathered over
  ``model``, and the scores peak at ``[B, H, S/m, chunk]`` a rank;
* ``"whole"`` — neither (``"batch_only"``, a sequence ``m`` does not
  divide): every head of every row on every model rank.

In ``"uneven"`` and ``"seq"`` each rank uses the gathered weights on its
own heads or rows, so their gradients are summed over the model ranks
(``layers.weight(..., partial=True)``); in ``"whole"`` every rank computes
the same whole gradient and keeps its block.  ``gathered_over_model``
names the weights a mode gathers.  Decode (``S = 1``) has no sequence to
split and the reference's decode no head hint: its split follows the
placement alone (``"heads"``/``"q_heads"`` where ``m`` divides the query
heads, else ``"whole"``).

Decode on a mesh takes the caches placed by ``cache_sharding``.  Where
they hold this rank's KV heads (KV heads over ``model``), it computes its
own query and KV heads as training does.  Where they hold a block of the
sequence (over ``model``, or at batch 1 over the data axes and ``model``
together: ``SeqBlock``), every rank computes every head of the new token
(its column blocks gathered over the model ranks), the rank whose block
holds position ``cur_len`` writes the new K/V, each attends its block
(``collectives.local_partial_attention``) and the softmax partials are
merged over the ranks that split the sequence
(``collectives.flash_decode_combine``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.collectives import (copy_to_model, flash_decode_combine, gather_from_model,
                                       local_partial_attention, reduce_from_model)
from ..distributed.sharding import attention_axis, hint
from .layers import (Dense, Init, apply_rope, dense, enter_model, model_group, model_rank,
                     model_size, model_split, weight)

__all__ = ["Attention", "attention_block", "decode_attention_block", "attention_split",
           "gathered_over_model", "SeqBlock", "NEG_INF", "GLOBAL_WINDOW"]

NEG_INF = -1e30
GLOBAL_WINDOW = 1 << 30  # "no window" sentinel: one code path for local/global


class Attention(nn.Module):
    def __init__(self, init: Init, cfg):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.q = Dense(init, d, cfg.n_heads * hd, ("fsdp", "tp"), cfg.qkv_bias)
        self.k = Dense(init, d, cfg.n_kv_heads * hd, ("fsdp", "tp"), cfg.qkv_bias)
        self.v = Dense(init, d, cfg.n_kv_heads * hd, ("fsdp", "tp"), cfg.qkv_bias)
        self.o = Dense(init, cfg.n_heads * hd, d, ("tp", "fsdp"))


def _uneven_heads(n_heads: int, m: int, r: int) -> tuple[int, int]:
    """``(first head, heads)`` of rank ``r``'s ``torch.chunk`` block of
    ``n_heads`` over ``m`` (none past the last block)."""
    k = -(-n_heads // m)
    lo = min(r * k, n_heads)
    return lo, min(k, n_heads - lo)


def attention_split(p: Attention, cfg, seq_len: int | None = None) -> tuple[str, int, int]:
    """``(mode, query heads, KV heads)`` this rank computes for a sequence
    of ``seq_len`` (``None``: decode), from the ``attn_heads`` policy, the
    placement of ``p``'s weights and the head counts (module doc):
    ``"heads"``, ``"q_heads"``, ``"uneven"``, ``"seq"`` or ``"whole"``."""
    m = model_size(p.q.w)
    if m == 1:
        return "whole", cfg.n_heads, cfg.n_kv_heads
    shape = (1, 1 if seq_len is None else seq_len, cfg.n_heads)
    axis = attention_axis(shape, m, "auto" if seq_len is None else None)
    if axis == "seq":
        return "seq", cfg.n_heads, cfg.n_kv_heads
    if axis == "heads" and cfg.n_heads % m:
        return "uneven", _uneven_heads(cfg.n_heads, m, model_rank(p.q.w))[1], cfg.n_kv_heads
    if axis != "heads" or model_split(p.q.w) != 1 or model_split(p.o.w) != 0:
        return "whole", cfg.n_heads, cfg.n_kv_heads
    hq = cfg.n_heads // m
    if model_split(p.k.w) == 1 and cfg.n_kv_heads % m == 0:
        return "heads", hq, cfg.n_kv_heads // m
    return "q_heads", hq, cfg.n_kv_heads


def gathered_over_model(p: Attention, cfg, seq_len: int | None = None) -> list:
    """The names (``k.w``, …) of ``p``'s parameters split over the model
    ranks that ``attention_split``'s mode for ``seq_len`` gathers there."""
    mode, _, _ = attention_split(p, cfg, seq_len)
    names = ("k", "v") if mode == "q_heads" else () if mode == "heads" else ("q", "k", "v", "o")
    return [f"{n}.{t}" for n in names for t in ("w", "b")
            if getattr(getattr(p, n), t) is not None
            and model_split(getattr(getattr(p, n), t)) is not None]


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd)


def _repeat_kv(x, n_heads):
    g = n_heads // x.shape[2]
    return x.repeat_interleave(g, dim=2) if g > 1 else x


def _mask_bias(q_pos, k_pos, causal, window):
    """[S_q, S_kv] additive bias; ``window`` is an int (``GLOBAL_WINDOW``
    for global attention)."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = m.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    return m.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF)


def _dot_attention(q, k, v, bias):
    """q:[B,Sq,H,hd] k/v:[B,Skv,H,hd] bias:[Sq,Skv] → [B,Sq,H,hd]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bthd->bhqt", q, k) * scale
    scores = hint(scores.float() + bias[None, None], "bhst")
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", w, v)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, window, chunk):
    """Online softmax over KV chunks (the flash recurrence)."""
    b, sq, h, hd = q.shape
    scale = hd**-0.5
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = hint(torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device), "heads")
    for lo in range(0, k.shape[1], chunk):
        kc, vc, kpc = k[:, lo : lo + chunk], v[:, lo : lo + chunk], k_pos[lo : lo + chunk]
        s = torch.einsum("bqhd,bthd->bhqt", q, kc) * scale
        s = hint(s.float() + _mask_bias(q_pos, kpc, causal, window)[None, None], "bhst")
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqt,bthd->bqhd", p.to(q.dtype), vc
        ).float()
        acc = hint(acc, "heads")
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _causal_blocked_attention(q, k, v, q_pos, k_pos, causal, window, chunk, q0=0):
    """Triangular q-block schedule: the query rows ``[lo, hi)`` of a chunk
    attend only the keys before ``hi``, halving causal-attention FLOPs
    against masking a full S x S sweep.  ``q`` holds the rows from ``q0``
    (a block of the sequence, split over the model ranks)."""
    sq = q.shape[1]
    outs = []
    for lo in range(0, sq, chunk):
        hi = min(lo + chunk, sq)
        outs.append(
            _chunked_attention(
                q[:, lo:hi], k[:, :q0 + hi], v[:, :q0 + hi], q_pos[lo:hi], k_pos[:q0 + hi],
                causal, window, chunk,
            )
        )
    return torch.cat(outs, dim=1)


def _head_cols(p: Dense, x, lo: int, n: int, hd: int):
    """``x`` by the columns of heads ``[lo, lo + n)`` of ``p``'s weights
    gathered over the model ranks (their gradients summed there)."""
    cols = slice(lo * hd, (lo + n) * hd)
    y = x @ weight(p.w, True, True)[:, cols]
    return y if p.b is None else y + weight(p.b, True, True)[cols]


def attention_block(
    p: Attention,
    x,
    cfg,
    *,
    window=None,
    positions=None,
    mode: str = "auto",
    chunk: int = 512,
    return_kv: bool = False,
):
    """Full-sequence attention (training / prefill).

    x: [B, S, D].  ``window``: sliding-window size (``None``: global).
    Returns [B, S, D] (and pre-repeat K/V when ``return_kv``: this rank's
    KV heads under ``"heads"``, every KV head otherwise).  ``mode`` is
    ``dot``, ``chunked``, ``causal_blocked`` or ``auto`` (dot up to 2,048
    tokens), as in the reference.
    """
    b, s, d = x.shape
    hd = cfg.hd
    if window is None:
        window = GLOBAL_WINDOW
    dev = x.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    pos1 = torch.arange(s, dtype=torch.int32, device=dev)
    split, n_q, n_kv = attention_split(p, cfg, s)
    whole = split == "whole"
    rows = slice(0, s)
    if split in ("seq", "uneven"):  # whole weights, on this rank's rows or heads
        group = model_group(p.q.w)
        xm = copy_to_model(x, group)
        if split == "seq":
            n = s // model_size(p.q.w)
            rows = slice(model_rank(p.q.w) * n, (model_rank(p.q.w) + 1) * n)
            q = dense(p.q, xm[:, rows], True, True)
        else:
            lo, _ = _uneven_heads(cfg.n_heads, model_size(p.q.w), model_rank(p.q.w))
            q = _head_cols(p.q, xm, lo, n_q, hd)
        k, v = dense(p.k, xm, True, True), dense(p.v, xm, True, True)
    else:
        xq = x if whole else enter_model(x, p.q.w)
        q = dense(p.q, xq, whole)
        # k/v whole from the replicated x, then into the model region where each
        # rank takes the KV heads of its own query heads
        k = dense(p.k, xq if split == "heads" else x, split != "heads")
        v = dense(p.v, xq if split == "heads" else x, split != "heads")
        if split == "q_heads":
            k, v = copy_to_model(k, model_group(p.q.w)), copy_to_model(v, model_group(p.q.w))
            lo = model_rank(p.q.w) * n_q
    q = _split_heads(q, n_q, hd)
    k, v = _split_heads(k, n_kv, hd), _split_heads(v, n_kv, hd)
    q = hint(apply_rope(q, positions[:, rows], cfg.rope_theta), "heads")
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_keep = (k, v)
    if split in ("q_heads", "uneven"):  # the KV heads of this rank's query heads
        k = _repeat_kv(k, cfg.n_heads)[:, :, lo:lo + n_q]
        v = _repeat_kv(v, cfg.n_heads)[:, :, lo:lo + n_q]
    else:
        k, v = _repeat_kv(k, n_q), _repeat_kv(v, n_q)
    k, v = hint(k, "heads"), hint(v, "heads")

    causal = not cfg.encoder_only
    q_pos = pos1[rows]
    if mode == "auto":
        mode = "dot" if s <= 2048 else "chunked"
    if mode == "dot":
        out = _dot_attention(q, k, v, _mask_bias(q_pos, pos1, causal, window))
    elif mode == "causal_blocked" and causal and s % chunk == 0:
        out = _causal_blocked_attention(q, k, v, q_pos, pos1, causal, window, chunk, rows.start)
    else:
        pad = (-s) % chunk
        kp = pos1
        if pad:
            # padded keys sit at position -1e9, as in the reference
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            kp = torch.cat([pos1, torch.full((pad,), -(10**9), dtype=torch.int32, device=dev)])
        out = _chunked_attention(q, k, v, q_pos, kp, causal, window, chunk)
    out = hint(out.reshape(b, out.shape[1], n_q * hd), "ffn")
    if split == "seq":  # this rank's rows, then every rank's
        y = gather_from_model(dense(p.o, out, True, True), 1, group)
    elif split == "uneven":  # this rank's heads' rows of o, summed over the ranks
        o_rows = weight(p.o.w, True, True)[lo * hd:(lo + n_q) * hd]
        y = reduce_from_model(out @ o_rows, group)
    else:
        y = dense(p.o, out, whole)
    y = hint(y, "hidden")
    if return_kv:
        return y, kv_keep
    return y


class SeqBlock(NamedTuple):
    """The block of a sequence-split decode cache this rank holds."""

    start: int  # the global position of its first row
    group: object  # the ranks that split the sequence


def _decode_qkv(p: Attention, x, cfg, local_heads: bool):
    """The new token's q, k, v: this rank's heads when ``local_heads``,
    else every head on every model rank."""
    split, n_q, n_kv = attention_split(p, cfg)
    hd = cfg.hd
    if local_heads:
        if split != "heads":
            raise ValueError(f"the cache holds this rank's KV heads, the weights split as {split}")
        xq = enter_model(x, p.q.w)
        return (_split_heads(dense(p.q, xq), n_q, hd), _split_heads(dense(p.k, xq), n_kv, hd),
                _split_heads(dense(p.v, xq), n_kv, hd))
    if split == "whole":
        q = dense(p.q, x, True)
    else:  # this rank's query heads, then every rank's
        q = gather_from_model(dense(p.q, enter_model(x, p.q.w)), 2, model_group(p.q.w))
    if split == "heads":
        xk = enter_model(x, p.k.w)
        k = gather_from_model(dense(p.k, xk), 2, model_group(p.k.w))
        v = gather_from_model(dense(p.v, xk), 2, model_group(p.k.w))
    else:
        k, v = dense(p.k, x, True), dense(p.v, x, True)
    return (_split_heads(q, cfg.n_heads, hd), _split_heads(k, cfg.n_kv_heads, hd),
            _split_heads(v, cfg.n_kv_heads, hd))


def decode_attention_block(p: Attention, x, cfg, cache_k, cache_v, cur_len: int, *,
                           window=None, seq: SeqBlock | None = None):
    """Single-token decode against a fixed-size KV cache.

    x: [B, 1, D]; cache_k/v: [B, T, Kv, hd] (on a mesh this rank's block:
    its KV heads, or with ``seq`` its rows of the sequence from
    ``seq.start``); ``cur_len``: tokens [0, cur_len) are valid, the new
    token is written at ``cur_len``, in place.  Returns (y [B,1,D],
    cache_k, cache_v).
    """
    b = x.shape[0]
    hd = cfg.hd
    t = cache_k.shape[1]
    if window is None:
        window = GLOBAL_WINDOW
    dev = x.device
    local_heads = cache_k.shape[2] != cfg.n_kv_heads
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=dev)
    q, k, v = _decode_qkv(p, x, cfg, local_heads)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    t0 = 0 if seq is None else seq.start
    if t0 <= cur_len < t0 + t:  # this block holds the new token's row
        cache_k[:, cur_len - t0] = k[:, 0].to(cache_k.dtype)
        cache_v[:, cur_len - t0] = v[:, 0].to(cache_v.dtype)
    n_q, n_kv = q.shape[2], k.shape[2]
    g = n_q // n_kv
    kpos = torch.arange(t0, t0 + t, dtype=torch.int32, device=dev)
    valid = (kpos <= cur_len) & (kpos > cur_len - window)
    scale = hd**-0.5
    # grouped einsum against the *unrepeated* cache (decode is memory-bound:
    # never materialize a repeated cache)
    if seq is None:
        qg = q.reshape(b, 1, n_kv, g, hd)
        scores = torch.einsum("bqkgd,btkd->bkgqt", qg, cache_k.to(qg.dtype)) * scale
        bias = torch.zeros(t, dtype=torch.float32, device=dev).masked_fill(~valid, NEG_INF)
        scores = scores.float() + bias
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgqt,btkd->bqkgd", w, cache_v.to(x.dtype)).reshape(b, 1, n_q * hd)
    else:  # a query head group's g heads take the partials' query axis
        qg = q.reshape(b, n_kv, g, hd)
        m, l, o = local_partial_attention(qg, cache_k.to(qg.dtype).transpose(1, 2),
                                          cache_v.to(qg.dtype).transpose(1, 2),
                                          valid.expand(b, t))
        out = flash_decode_combine(m, l, o, seq.group).to(x.dtype).reshape(b, 1, n_q * hd)
    split, n_own, _ = attention_split(p, cfg)
    if local_heads or split == "whole":
        y = dense(p.o, out, split == "whole")
    else:  # every head here: the rows of o this rank holds take its heads
        lo = model_rank(p.o.w) * n_own * hd
        y = dense(p.o, out[..., lo:lo + n_own * hd])
    return hint(y, "hidden"), cache_k, cache_v
