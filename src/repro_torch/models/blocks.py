"""Per-layer blocks (dense / MoE / SSM / hybrid) and the layer stack.

The port of ``repro.models.blocks``.  The reference stacks every layer's
weights on a leading axis and runs one ``lax.scan``; here the stack is an
``nn.ModuleList`` run by a Python loop, and each layer's attention window
is a Python int (``layer_windows``).  The decode caches keep the
reference's layout, one tensor per kind with a leading layer axis, and are
updated in place.

Remat: ``cfg.remat`` in {nothing, dots, full} wraps each layer's
``layer_apply`` in ``torch.utils.checkpoint.checkpoint`` (non-reentrant),
the reference's ``_remat_wrap`` of its scan body: ``full`` saves only the
layer's input and recomputes the layer in the backward pass; ``dots``
also saves the outputs of the weight products (``aten.mm``/``addmm``, to
which ``x @ w`` flattens) and recomputes the rest, the torch form of JAX's
``checkpoint_dots_with_no_batch_dims`` (attention's batched products are
``bmm`` and are recomputed).  Remat applies only while autograd records,
so serving runs the layers as they are.

On a mesh a layer's ZeRO-3 gathers and model-axis collectives
(``models.layers``) run inside its checkpointed region, so the recompute
gathers the weights again instead of keeping them: every rank runs the
same layers in the same order, forward and recompute alike, so each
issues its collectives in the same order as its group's other ranks.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from ..distributed.sharding import hint
from ..kernels.ops import resolve_device
from .attention import GLOBAL_WINDOW, Attention, attention_block, decode_attention_block
from .layers import MLP, Init, RMSNorm, mlp, rmsnorm
from .moe import MoE, moe_apply
from .ssm import SSM, ssm_apply, ssm_decode, ssm_state_shapes

__all__ = [
    "Layer",
    "layer_apply",
    "layer_decode",
    "stack_apply",
    "stack_decode",
    "layer_windows",
    "init_caches",
]


class Layer(nn.Module):
    """One block's weights, named as the reference's ``layer_init`` tree."""

    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.norm1 = RMSNorm(init, cfg.d_model)
        if cfg.family == "ssm":
            self.ssm = SSM(init, cfg)
            if cfg.d_ff:
                self.norm2 = RMSNorm(init, cfg.d_model)
                self.mlp = MLP(init, cfg.d_model, cfg.d_ff, cfg.mlp_act)
            return
        self.attn = Attention(init, cfg)
        if cfg.family == "hybrid":
            self.ssm = SSM(init, cfg)
            self.branch_norm_attn = RMSNorm(init, cfg.d_model)
            self.branch_norm_ssm = RMSNorm(init, cfg.d_model)
        self.norm2 = RMSNorm(init, cfg.d_model)
        if cfg.moe is not None:
            self.moe = MoE(init, cfg)
        else:
            self.mlp = MLP(init, cfg.d_model, cfg.d_ff, cfg.mlp_act)


def layer_apply(p: Layer, x, cfg: ArchConfig, window: int, *, mode="auto", chunk=512):
    """One block, full sequence.  Returns (y, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = x + ssm_apply(p.ssm, rmsnorm(p.norm1, x, cfg.norm_eps), cfg)
        if cfg.d_ff:
            x = x + mlp(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps), cfg.mlp_act)
        return x, aux
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    a = attention_block(p.attn, h, cfg, window=window, mode=mode, chunk=chunk)
    if cfg.family == "hybrid":
        s = ssm_apply(p.ssm, h, cfg)
        a = 0.5 * (
            rmsnorm(p.branch_norm_attn, a, cfg.norm_eps)
            + rmsnorm(p.branch_norm_ssm, s, cfg.norm_eps)
        )
    x = x + a
    h2 = rmsnorm(p.norm2, x, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_apply(p.moe, h2, cfg)
    else:
        y = mlp(p.mlp, h2, cfg.mlp_act)
    return x + y, aux


def layer_decode(p: Layer, x, cfg: ArchConfig, window: int, cache: dict, cur_len: int):
    """One block, one token.  ``cache`` holds this layer's slices of the
    stacked caches (views), written in place."""
    if cfg.family == "ssm":
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        y, conv_s, ssm_s = ssm_decode(p.ssm, h, cfg, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        x = x + y
        if cfg.d_ff:
            x = x + mlp(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps), cfg.mlp_act)
        return x
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    a, _, _ = decode_attention_block(
        p.attn, h, cfg, cache["k"], cache["v"], cur_len, window=window
    )
    if cfg.family == "hybrid":
        y, conv_s, ssm_s = ssm_decode(p.ssm, h, cfg, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        a = 0.5 * (
            rmsnorm(p.branch_norm_attn, a, cfg.norm_eps)
            + rmsnorm(p.branch_norm_ssm, y, cfg.norm_eps)
        )
    x = x + a
    h2 = rmsnorm(p.norm2, x, cfg.norm_eps)
    if cfg.moe is not None:
        y2, _ = moe_apply(p.moe, h2, cfg)
    else:
        y2 = mlp(p.mlp, h2, cfg.mlp_act)
    return x + y2


# --------------------------------------------------------------------------- #
# Stack
# --------------------------------------------------------------------------- #
def layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer attention window (``GLOBAL_WINDOW`` = global)."""
    return [cfg.window if kind == "local" else GLOBAL_WINDOW for kind in cfg.layer_kinds()]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat_wrap(fn, remat: str):
    if remat == "nothing" or not torch.is_grad_enabled():
        return fn
    if remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_contexts)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def stack_apply(layers: nn.ModuleList, x, cfg: ArchConfig, *, mode="auto", chunk=512):
    """Run all layers (each under ``cfg.remat``); returns (hidden,
    total_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat_wrap(layer_apply, cfg.remat)
    for lp, win in zip(layers, layer_windows(cfg)):
        x, a = body(lp, x, cfg, win, mode=mode, chunk=chunk)
        x = hint(x, "hidden")
        aux = aux + a
    return x, aux


def stack_decode(layers: nn.ModuleList, x, cfg: ArchConfig, caches: dict, cur_len: int):
    """One-token decode through all layers; ``caches`` (leading L axis) are
    written in place, and ``caches["len"]`` becomes ``cur_len + 1``."""
    kinds = [k for k in ("k", "v", "conv", "ssm") if k in caches]
    for i, (lp, win) in enumerate(zip(layers, layer_windows(cfg))):
        x = layer_decode(lp, x, cfg, win, {k: caches[k][i] for k in kinds}, cur_len)
    if "len" in caches:
        caches["len"].fill_(cur_len + 1)
    return x, caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
                device="cuda") -> dict:
    """Decode caches with leading layer axis (the reference's layout):
    ``k``/``v`` [L, B, T, Kv, hd], ``len`` [L] int32, ``conv``
    [L, B, d_conv-1, CH] and ``ssm`` [L, B, H, N, P] float32."""
    dev = resolve_device(device)
    L = cfg.n_layers
    cache = {}
    if cfg.family != "ssm":
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["len"] = torch.zeros((L,), dtype=torch.int32, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        conv_shape, ssm_shape = ssm_state_shapes(cfg, batch)
        cache["conv"] = torch.zeros((L,) + conv_shape, dtype=dtype, device=dev)
        cache["ssm"] = torch.zeros((L,) + ssm_shape, dtype=torch.float32, device=dev)
    return cache
