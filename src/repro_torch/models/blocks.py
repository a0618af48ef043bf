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
from ..distributed.collectives import mesh_group
from ..distributed.sharding import block_of, hint, is_placed, local_tensor, placed_zeros
from ..kernels.ops import resolve_device
from .attention import (GLOBAL_WINDOW, Attention, SeqBlock, attention_block,
                        decode_attention_block)
from .layers import MLP, Init, RMSNorm, mlp, rmsnorm
from .moe import MoE, moe_apply
from .ssm import SSM, ssm_apply, ssm_decode, ssm_state_shapes

__all__ = [
    "Layer",
    "layer_apply",
    "layer_decode",
    "stack_apply",
    "stack_decode",
    "seq_block",
    "layer_windows",
    "cache_shapes",
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


def layer_decode(p: Layer, x, cfg: ArchConfig, window: int, cache: dict, cur_len: int,
                 seq: SeqBlock | None = None):
    """One block, one token.  ``cache`` holds this layer's slices of the
    stacked caches (views; on a mesh, of this rank's blocks), written in
    place; ``seq`` the sequence block of a sequence-split KV cache."""
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
        p.attn, h, cfg, cache["k"], cache["v"], cur_len, window=window, seq=seq
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


def seq_block(cache) -> SeqBlock | None:
    """The sequence block of a KV cache [L, B, T, Kv, hd] placed with its
    ``T`` split (``cache_sharding``'s sequence-parallel cache), or None."""
    if not is_placed(cache):
        return None
    mesh = cache.device_mesh
    axes = [mesh.mesh_dim_names[i] for i, pl in enumerate(cache.placements)
            if pl.is_shard(2) and mesh.size(i) > 1]
    if not axes:
        return None
    _, offset = block_of(cache.shape, mesh, cache.placements)
    return SeqBlock(int(offset[2]), mesh_group(mesh, axes))


def stack_decode(layers: nn.ModuleList, x, cfg: ArchConfig, caches: dict, cur_len: int):
    """One-token decode through all layers; ``caches`` (leading L axis) are
    written in place, and ``caches["len"]`` becomes ``cur_len + 1``.  On a
    mesh, placed caches (``init_caches(..., sharding=)``): each rank
    reads and writes its blocks."""
    kinds = [k for k in ("k", "v", "conv", "ssm") if k in caches]
    local = {k: local_tensor(caches[k]) for k in kinds}
    seq = seq_block(caches["k"]) if "k" in caches else None
    for i, (lp, win) in enumerate(zip(layers, layer_windows(cfg))):
        x = layer_decode(lp, x, cfg, win, {k: local[k][i] for k in kinds}, cur_len, seq)
    if "len" in caches:
        local_tensor(caches["len"]).fill_(cur_len + 1)
    return x, caches


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32) -> dict:
    """``{kind: (shape, dtype)}`` of ``init_caches``' tensors."""
    L = cfg.n_layers
    out = {}
    if cfg.family != "ssm":
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
        out["k"] = (shape, dtype)
        out["v"] = (shape, dtype)
        out["len"] = ((L,), torch.int32)
    if cfg.family in ("ssm", "hybrid"):
        conv_shape, ssm_shape = ssm_state_shapes(cfg, batch)
        out["conv"] = ((L,) + conv_shape, dtype)
        out["ssm"] = ((L,) + ssm_shape, torch.float32)
    return out


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
                device="cuda", sharding=None) -> dict:
    """Decode caches with leading layer axis (the reference's layout):
    ``k``/``v`` [L, B, T, Kv, hd], ``len`` [L] int32, ``conv``
    [L, B, d_conv-1, CH] and ``ssm`` [L, B, H, N, P] float32, zeros.  With
    ``sharding`` (``distributed.sharding.cache_sharding``'s tree), each is a
    ``DTensor`` of which this rank holds only its block."""
    dev = resolve_device(device)
    specs = cache_shapes(cfg, batch, max_len, dtype)
    if sharding is None:
        return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in specs.items()}
    return {k: placed_zeros(shape, sharding[k], dt, dev) for k, (shape, dt) in specs.items()}
