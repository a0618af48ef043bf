"""Mixture-of-Experts layer: GShard-style capacity dispatch, top-k routing,
shared experts (Qwen-MoE), load-balance aux loss.

The port of ``repro.models.moe``.  Expert weights are ``[E, D, F]`` with
``D → fsdp`` and ``F → tp``; the dispatch one-hot keeps tokens grouped by
their batch row.  The ``sorted`` dispatch's scatter-add is
``index_put_(accumulate=True)``, which on CUDA adds with float atomics in
no fixed order: its results match the reference within a tolerance, not
bit for bit.

On a mesh whose model axis splits the experts' ``F`` (``specs``), gate and
up are column-parallel and down row-parallel per expert: the dispatched
tokens enter the model region once, and the combined partial outputs are
summed over the model ranks once, after the combine.  The combine weights
multiply partial sums, so they enter the model region too: their gradient,
which reaches the replicated router, is summed over the model ranks.  The
router and the shared gate stay replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.collectives import reduce_from_model
from ..distributed.sharding import hint
from .layers import MLP, Dense, Init, dense, enter_model, mlp, model_group, model_split, weight

__all__ = ["MoE", "moe_apply"]


class MoE(nn.Module):
    specs = {"gate_w": (None, "fsdp", "tp"), "up_w": (None, "fsdp", "tp"),
             "down_w": (None, "tp", "fsdp")}

    def __init__(self, init: Init, cfg):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        f = m.d_ff_expert or cfg.d_ff
        self.router = Dense(init, d, m.n_experts, (None, None))
        self.gate_w = init.normal((m.n_experts, d, f), d**-0.5)
        self.up_w = init.normal((m.n_experts, d, f), d**-0.5)
        self.down_w = init.normal((m.n_experts, f, d), f**-0.5)
        if m.n_shared:
            # shared experts are dense MLPs applied to every token, fused
            # into one wide MLP (mathematically identical, one less einsum)
            self.shared = MLP(init, d, m.n_shared * f, "swiglu")
            self.shared_gate = Dense(init, d, 1, (None, None))


def moe_apply(p: MoE, x, cfg):
    """x: [B, S, D] → (y, aux_loss).  Dispatch per ``cfg.moe.dispatch``:

    * ``einsum`` — GShard one-hot dispatch/combine einsums;
    * ``sorted`` — sort token-choices by expert, gather the first ``cap``
      per expert, scatter-add weighted outputs back.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = max(1, int(s * k / e * m.capacity_factor))

    logits = dense(p.router, x).float()  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [B,S,k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch/GShard form)
    me = probs.mean(dim=(0, 1))  # [E]
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    if getattr(m, "dispatch", "einsum") == "sorted":
        y = _leave_experts(p, _sorted_dispatch(p, x, cfg, gate_vals, gate_idx, cap))
        if m.n_shared:
            y = y + mlp(p.shared, x, "swiglu")
        return y, aux

    # position of each (token, choice) within its expert's capacity buffer
    dispatch = torch.zeros((b, s, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32, device=x.device)
    for choice in range(k):
        oh = F.one_hot(gate_idx[..., choice], e).float()  # [B,S,E]
        pos = (torch.cumsum(oh, dim=1) - oh) + combine_positions_base(combine)
        keep = (pos < cap) & (oh > 0)
        pos_c = torch.clamp(pos, 0, cap - 1).long()
        sel = F.one_hot(pos_c, cap).float() * keep[..., None]
        contrib = oh[..., None] * sel  # [B,S,E,cap]
        dispatch = dispatch + contrib.to(x.dtype)
        combine = combine + contrib * gate_vals[..., choice, None, None]

    xe = hint(torch.einsum("bsec,bsd->ebcd", dispatch, x), "experts")  # [E,B,cap,D]
    ye = _expert_ffn(p, xe)
    # the combine weights meet partial sums: their gradient is summed over
    # the model ranks (enter_model), as the expert outputs are
    combine = enter_model(combine.to(x.dtype), p.gate_w)
    y = _leave_experts(p, torch.einsum("bsec,ebcd->bsd", combine, ye))
    y = hint(y, "hidden")

    if m.n_shared:
        y = y + mlp(p.shared, x, "swiglu")
    return y, aux


def combine_positions_base(combine):
    """Occupied slots per expert so far across earlier top-k choices."""
    taken = (combine > 0).float().sum(dim=(1, 3))  # [B, E]
    return taken[:, None, :]


def _leave_experts(p: MoE, y):
    """The experts' combined output: summed over the model ranks when they
    split the experts' ``F`` (each holds a partial sum)."""
    return y if model_split(p.gate_w) is None else reduce_from_model(y, model_group(p.gate_w))


def _expert_ffn(p: MoE, xe):
    """xe: [E, B, cap, D] → [E, B, cap, D] (SwiGLU expert MLPs); a partial
    sum over this rank's block of ``F`` on a mesh that splits it."""
    xe = enter_model(xe, p.gate_w)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, weight(p.gate_w))) * torch.einsum(
        "ebcd,edf->ebcf", xe, weight(p.up_w)
    )
    return torch.einsum("ebcf,efd->ebcd", h, weight(p.down_w))


def _sorted_dispatch(p: MoE, x, cfg, gate_vals, gate_idx, cap):
    """Gather/scatter MoE dispatch (sort tokens by expert, no one-hots)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    sk = s * k
    dev = x.device
    eid = gate_idx.reshape(b, sk)  # expert of each (token, choice)
    tok = torch.arange(s, device=dev).repeat_interleave(k)[None, :].expand(b, sk)
    gate = gate_vals.reshape(b, sk)
    order = torch.argsort(eid, dim=1, stable=True)
    eid_s = torch.take_along_dim(eid, order, dim=1)
    tok_s = torch.take_along_dim(tok, order, dim=1)
    gate_s = torch.take_along_dim(gate, order, dim=1)
    # rank within expert = position - first position of that expert
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(eid_s.contiguous(), experts)  # [B, E]
    first = torch.take_along_dim(starts, eid_s, dim=1)  # [B, sk]
    rank = torch.arange(sk, device=dev)[None, :] - first
    keep = rank < cap
    slot = torch.where(keep, eid_s * cap + rank, e * cap)  # overflow -> spill row

    bidx = torch.arange(b, device=dev)[:, None].expand(b, sk)
    gathered = torch.take_along_dim(x, tok_s[..., None], dim=1)  # [B, sk, D]
    xe = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=dev)
    xe.index_put_((bidx, slot), gathered)
    xe = xe[:, : e * cap].reshape(b, e, cap, d).permute(1, 0, 2, 3)
    ye = _expert_ffn(p, xe)  # [E, B, cap, D]
    ye_flat = ye.permute(1, 0, 2, 3).reshape(b, e * cap, d)
    ye_flat = torch.cat([ye_flat, torch.zeros((b, 1, d), dtype=ye_flat.dtype, device=dev)],
                        dim=1)
    contrib = torch.take_along_dim(ye_flat, slot[..., None], dim=1)
    w = enter_model(torch.where(keep, gate_s, 0.0).to(x.dtype)[..., None], p.gate_w)
    y = torch.zeros_like(x)
    y.index_put_((bidx, tok_s), contrib * w, accumulate=True)
    return y
