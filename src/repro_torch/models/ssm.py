"""Mamba-2 (SSD — state-space duality) block, chunked-scan form and
O(1)-state decode form  [arXiv:2405.21060].

The port of ``repro.models.ssm``.  The chunked SSD algorithm splits the
sequence into chunks of length Q: the intra-chunk term is a small
attention-like contraction, and chunk-to-chunk information flows through
an ``[H, N, P]`` state carried by a Python loop over the chunks (the
reference's ``lax.scan``).  Decode keeps ``(conv_state [B, d_conv-1, CH],
ssm_state [B, H, N, P])`` per layer and costs O(1) a token.

On a mesh the block is computed whole on every model rank: the fused
``in_proj``'s contiguous column blocks (and ``conv_w``/``conv_b``'s
channel blocks) cut across its z/x/B/C/dt segments, so its weights split
over the model ranks are gathered there (``gathered_over_model``), as
GSPMD reshards them for the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import hint
from .layers import Dense, Init, RMSNorm, dense, model_split, rmsnorm, weight

__all__ = ["SSM", "ssm_apply", "ssm_decode", "ssm_state_shapes", "gathered_over_model"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    n_groups = 1
    conv_ch = d_inner + 2 * n_groups * s.d_state
    return d_inner, n_heads, n_groups, conv_ch


class SSM(nn.Module):
    specs = {"conv_w": (None, "tp"), "conv_b": ("tp",), "A_log": (None,), "D": (None,),
             "dt_bias": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, n_heads, n_groups, conv_ch = _dims(cfg)
        d_in_proj = 2 * d_inner + 2 * n_groups * s.d_state + n_heads
        self.in_proj = Dense(init, d, d_in_proj, ("fsdp", "tp"))
        self.conv_w = init.normal((s.d_conv, conv_ch), 0.2)
        self.conv_b = init.full((conv_ch,), 0.0)
        self.A_log = init.tensor(torch.log(torch.linspace(1.0, 16.0, n_heads)))
        self.D = init.full((n_heads,), 1.0, torch.float32)
        self.dt_bias = init.full((n_heads,), 0.0, torch.float32)
        self.norm = RMSNorm(init, d_inner)
        self.out_proj = Dense(init, d_inner, d, ("tp", "fsdp"), scale=d_inner**-0.5)


def gathered_over_model(p: SSM) -> list:
    """The names of ``p``'s parameters split over the model ranks, which
    ``ssm_apply`` gathers to compute the block whole."""
    named = {"in_proj.w": p.in_proj.w, "conv_w": p.conv_w, "conv_b": p.conv_b,
             "out_proj.w": p.out_proj.w}
    return [n for n, t in named.items() if model_split(t) is not None]


def _split_proj(cfg, zxbcdt):
    d_inner, _, _, conv_ch = _dims(cfg)
    z, xBC, dt = torch.tensor_split(zxbcdt, [d_inner, d_inner + conv_ch], dim=-1)
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal 1-D conv: xBC [B,S,CH], w [K,CH]."""
    k = w.shape[0]
    x_pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(k):  # K is 4: a static unroll, as the reference
        out = out + x_pad[:, i : i + xBC.shape[1], :] * w[i]
    return F.silu(out + b)


def ssm_apply(p: SSM, x, cfg):
    """x: [B, S, D] → [B, S, D] (training / prefill)."""
    s_cfg = cfg.ssm
    b, seq, d = x.shape
    d_inner, n_heads, n_groups, conv_ch = _dims(cfg)
    hd, n = s_cfg.head_dim, s_cfg.d_state
    q = min(s_cfg.chunk, seq)
    if seq % q:
        raise ValueError("sequence must be divisible by SSD chunk")

    z, xBC, dt = _split_proj(cfg, dense(p.in_proj, x, whole=True))
    xBC = _causal_conv(xBC, weight(p.conv_w, whole=True), weight(p.conv_b, whole=True))
    xh, B_ssm, C_ssm = torch.tensor_split(xBC, [d_inner, d_inner + n_groups * n], dim=-1)
    xh = xh.reshape(b, seq, n_heads, hd)

    dt = F.softplus(dt.float() + weight(p.dt_bias))  # [B,S,H]
    a = -torch.exp(weight(p.A_log))  # [H] negative
    da = dt * a  # [B,S,H] log-decay per step
    xdt = xh.float() * dt[..., None]  # [B,S,H,P]
    b_all = B_ssm.float()  # [B,S,N] (one group)
    c_all = C_ssm.float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    state = torch.zeros((b, n_heads, n, hd), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, seq, q):
        da_k, xdt_k = da[:, lo : lo + q], xdt[:, lo : lo + q]
        b_k, c_k = b_all[:, lo : lo + q], c_all[:, lo : lo + q]
        csum = torch.cumsum(da_k, dim=1)  # [B,q,H]
        li = csum[:, :, None, :] - csum[:, None, :, :]  # [B,q,q,H]
        # mask BEFORE exp: li > 0 for the (masked) j > i entries can overflow
        li = li.masked_fill(~mask[None, :, :, None], -math.inf)
        L = torch.exp(li)
        scores = torch.einsum("bin,bjn->bij", c_k, b_k)  # [B,q,q]
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", scores, L, xdt_k)
        in_decay = torch.exp(csum)  # decay from chunk start to step i
        y_inter = torch.einsum("bin,bih,bhnp->bihp", c_k, in_decay, state)
        decay_to_end = torch.exp(csum[:, -1:, :] - csum)  # [B,q,H]
        s_chunk = torch.einsum("bjn,bjh,bjhp->bhnp", b_k, decay_to_end, xdt_k)
        state = state * torch.exp(csum[:, -1, :])[:, :, None, None] + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + weight(p.D)[None, None, :, None] * xh.float()
    y = y.reshape(b, seq, d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return hint(dense(p.out_proj, y, whole=True), "hidden")


def ssm_state_shapes(cfg, batch):
    s = cfg.ssm
    _, n_heads, _, conv_ch = _dims(cfg)
    return (
        (batch, s.d_conv - 1, conv_ch),  # conv state
        (batch, n_heads, s.d_state, s.head_dim),  # ssm state
    )


def ssm_decode(p: SSM, x, cfg, conv_state, ssm_state):
    """One-token decode.  x: [B, 1, D] → (y, conv_state, ssm_state), the
    states new tensors."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    d_inner, n_heads, n_groups, conv_ch = _dims(cfg)
    hd, n = s_cfg.head_dim, s_cfg.d_state

    z, xBC, dt = _split_proj(cfg, dense(p.in_proj, x))
    xBC = xBC[:, 0]  # [B,CH]
    window = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # [B,K,CH]
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float())
    xBC = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
    new_conv_state = window[:, 1:]

    xh, B_ssm, C_ssm = torch.tensor_split(xBC, [d_inner, d_inner + n_groups * n], dim=-1)
    xh = xh.reshape(b, n_heads, hd).float()
    B_ssm = B_ssm.reshape(b, n)[:, None, :].float()  # G=1 → [B,1,N]
    C_ssm = C_ssm.reshape(b, n)[:, None, :].float()

    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)  # [B,H]
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt1 * a)  # [B,H]
    xdt = xh * dt1[..., None]  # [B,H,P]
    new_state = ssm_state * decay[:, :, None, None] + torch.einsum(
        "bgn,bhp->bhnp", B_ssm, xdt
    )
    y = torch.einsum("bgn,bhnp->bhp", C_ssm, new_state)  # [B,H,P]
    y = y + p.D[None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return hint(dense(p.out_proj, y), "hidden"), new_conv_state, new_state
