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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import hint
from .layers import Dense, Init, apply_rope, dense

__all__ = ["Attention", "attention_block", "decode_attention_block", "NEG_INF",
           "GLOBAL_WINDOW"]

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
    q = _split_heads(dense(p.q, x), cfg.n_heads, hd)
    k = _split_heads(dense(p.k, x), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p.v, x), cfg.n_kv_heads, hd)
    q = hint(apply_rope(q, positions, cfg.rope_theta), "heads")
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_keep = (k, v)
    k = hint(_repeat_kv(k, cfg.n_heads), "heads")
    v = hint(_repeat_kv(v, cfg.n_heads), "heads")

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
    out = hint(out.reshape(b, s, cfg.n_heads * hd), "ffn")
    y = hint(dense(p.o, out), "hidden")
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
