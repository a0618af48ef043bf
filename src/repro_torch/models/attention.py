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

On a mesh whose model axis splits the projections (``attention_split``),
each rank computes its own heads: ``q``/``k``/``v`` column-parallel and
``o`` row-parallel when the split falls on head boundaries for both the
query and the KV heads.  Where it cuts a KV head (the reduced configs'
2 KV heads over 4 model ranks), ``k``/``v`` are computed whole on every
model rank and each rank takes the KV heads of its query heads; where it
cuts a query head (qwen2-0.5b's 14 heads over 4), the whole layer is
computed on every model rank.  Those weights are gathered over the model
ranks, and ``gathered_over_model`` names them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.collectives import copy_to_model
from ..distributed.sharding import hint
from .layers import (Dense, Init, apply_rope, dense, enter_model, model_group, model_rank,
                     model_size, model_split)

__all__ = ["Attention", "attention_block", "decode_attention_block", "attention_split",
           "gathered_over_model", "NEG_INF", "GLOBAL_WINDOW"]

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


def attention_split(p: Attention, cfg) -> tuple[str, int, int]:
    """``(mode, query heads, KV heads)`` this rank computes, from the
    placement of ``p``'s weights and the head counts:

    * ``"heads"`` — the model axis splits ``q`` and ``k`` on head
      boundaries: this rank's heads, ``o`` row-parallel;
    * ``"q_heads"`` — it splits ``q`` on head boundaries but cuts a KV
      head: ``k``/``v`` whole on every model rank, this rank's query heads;
    * ``"whole"`` — otherwise (plain weights, a model axis of one, or a cut
      query head): every head on every model rank."""
    m = model_size(p.q.w)
    if model_split(p.q.w) != 1 or model_split(p.o.w) != 0 or cfg.n_heads % m:
        return "whole", cfg.n_heads, cfg.n_kv_heads
    hq = cfg.n_heads // m
    if model_split(p.k.w) == 1 and cfg.n_kv_heads % m == 0:
        return "heads", hq, cfg.n_kv_heads // m
    return "q_heads", hq, cfg.n_kv_heads


def gathered_over_model(p: Attention, cfg) -> list:
    """The names (``k.w``, …) of ``p``'s parameters split over the model
    ranks that ``attention_split`` computes whole, so gathers."""
    mode, _, _ = attention_split(p, cfg)
    names = {"whole": ("q", "k", "v", "o"), "q_heads": ("k", "v")}.get(mode, ())
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


def _causal_blocked_attention(q, k, v, q_pos, k_pos, causal, window, chunk):
    """Triangular q-block schedule: query chunk ``qi`` attends only KV
    chunks ``<= qi``, halving causal-attention FLOPs against masking a full
    S x S sweep."""
    s = q.shape[1]
    if s % chunk:
        raise ValueError("causal_blocked needs seq divisible by chunk")
    outs = []
    for lo in range(0, s, chunk):
        hi = lo + chunk
        outs.append(
            _chunked_attention(
                q[:, lo:hi], k[:, :hi], v[:, :hi], q_pos[lo:hi], k_pos[:hi],
                causal, window, chunk,
            )
        )
    return torch.cat(outs, dim=1)


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
    Returns [B, S, D] (and pre-repeat K/V when ``return_kv``).  ``mode`` is
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
    split, n_q, n_kv = attention_split(p, cfg)
    whole = split == "whole"
    xq = x if whole else enter_model(x, p.q.w)
    # k/v whole from the replicated x, then into the model region where each
    # rank takes the KV heads of its own query heads
    q = _split_heads(dense(p.q, xq, whole), n_q, hd)
    k = dense(p.k, xq if split == "heads" else x, split != "heads")
    v = dense(p.v, xq if split == "heads" else x, split != "heads")
    if split == "q_heads":
        k, v = copy_to_model(k, model_group(p.q.w)), copy_to_model(v, model_group(p.q.w))
    k, v = _split_heads(k, n_kv, hd), _split_heads(v, n_kv, hd)
    q = hint(apply_rope(q, positions, cfg.rope_theta), "heads")
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_keep = (k, v)
    if split == "q_heads":
        lo = model_rank(p.q.w) * n_q
        k = _repeat_kv(k, cfg.n_heads)[:, :, lo:lo + n_q]
        v = _repeat_kv(v, cfg.n_heads)[:, :, lo:lo + n_q]
    k = hint(_repeat_kv(k, n_q), "heads")
    v = hint(_repeat_kv(v, n_q), "heads")

    causal = not cfg.encoder_only
    pos1 = torch.arange(s, dtype=torch.int32, device=dev)
    if mode == "auto":
        mode = "dot" if s <= 2048 else "chunked"
    if mode == "dot":
        out = _dot_attention(q, k, v, _mask_bias(pos1, pos1, causal, window))
    elif mode == "causal_blocked" and causal and s % chunk == 0:
        out = _causal_blocked_attention(q, k, v, pos1, pos1, causal, window, chunk)
    else:
        pad = (-s) % chunk
        kp = pos1
        if pad:
            # padded keys sit at position -1e9, as in the reference
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            kp = torch.cat([pos1, torch.full((pad,), -(10**9), dtype=torch.int32, device=dev)])
        out = _chunked_attention(q, k, v, pos1, kp, causal, window, chunk)
    out = hint(out.reshape(b, s, n_q * hd), "ffn")
    y = hint(dense(p.o, out, whole), "hidden")
    if return_kv:
        return y, kv_keep
    return y


def decode_attention_block(p: Attention, x, cfg, cache_k, cache_v, cur_len: int, *,
                           window=None):
    """Single-token decode against a fixed-size KV cache.

    x: [B, 1, D]; cache_k/v: [B, T, Kv, hd]; ``cur_len``: tokens
    [0, cur_len) are valid, the new token is written at ``cur_len``, in
    place.  Returns (y [B,1,D], cache_k, cache_v).
    """
    b = x.shape[0]
    hd = cfg.hd
    t = cache_k.shape[1]
    if window is None:
        window = GLOBAL_WINDOW
    dev = x.device
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=dev)
    q = _split_heads(dense(p.q, x), cfg.n_heads, hd)
    k = _split_heads(dense(p.k, x), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p.v, x), cfg.n_kv_heads, hd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
    g = cfg.n_heads // cfg.n_kv_heads
    kpos = torch.arange(t, dtype=torch.int32, device=dev)
    valid = (kpos <= cur_len) & (kpos > cur_len - window)
    scale = hd**-0.5
    # grouped einsum against the *unrepeated* cache (decode is memory-bound:
    # never materialize a repeated cache)
    qg = q.reshape(b, 1, cfg.n_kv_heads, g, hd)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, cache_k.to(qg.dtype)) * scale
    bias = torch.zeros(t, dtype=torch.float32, device=dev).masked_fill(~valid, NEG_INF)
    scores = scores.float() + bias
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", w, cache_v.to(x.dtype))
    y = dense(p.o, out.reshape(b, 1, cfg.n_heads * hd))
    return hint(y, "hidden"), cache_k, cache_v
