"""Full model assembly: embeddings / modality frontends, layer stack, head,
loss, and the prefill / decode step functions.

The port of ``repro.models.model``.  Batch conventions are the
reference's:

* decoder LMs:   ``{"tokens": [B, S] int}``; labels are tokens shifted.
* VLM:           ``+ {"patch_embeds": [B, Np, D]}`` (frontend stub) —
                 patches are prepended to the text embeddings.
* audio encoder: ``{"frames": [B, T, F], "labels": [B, T] int}``
                 (conv feature-extractor stub; encoder-only, CE per frame).

``forward`` and ``lm_loss`` are differentiable (``launch.steps``'s train
step takes their gradient, with ``cfg.remat`` applied layer by layer);
``prefill`` and ``decode_step`` run without autograd.

On a mesh (``convert.place_model``) the embedding table is
``("tp", "fsdp")``: vocab rows over the model ranks.  Each rank looks up
the tokens of its rows (the others give zeros) and the lookups are summed
over the model ranks; the head gives this rank's block of the vocab
(``forward``'s logits), padded ids masked by their global id; and
``lm_loss``'s cross-entropy reduces the maximum, the sum of exponentials
and the label's logit over the model ranks.  The tied table takes both
gradients in one block.  ``replicated_over_model`` names the weights
split over the model ranks that a layer computes whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.collectives import gather_from_model, max_over, reduce_from_model
from ..distributed.sharding import hint
from ..kernels.ops import resolve_device
from . import attention as attn_mod
from . import ssm as ssm_mod
from .blocks import Layer, init_caches, stack_apply, stack_decode
from .layers import (Dense, Embed, Init, RMSNorm, dense, enter_model, model_group, model_rank,
                     model_size, model_split, rmsnorm, weight)

__all__ = [
    "LM",
    "init_model",
    "forward",
    "lm_loss",
    "prefill",
    "decode_step",
    "init_caches",
    "replicated_over_model",
]


class LM(nn.Module):
    """The whole model's weights, named as the reference's ``init_model``
    tree (``frontend_proj``, ``embed``, ``layers``, ``final_norm``,
    ``head``)."""

    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        if cfg.frontend == "frames":
            self.frontend_proj = Dense(init, cfg.frontend_dim, cfg.d_model, ("fsdp", "tp"),
                                       bias=True)
        self.embed = Embed(init, cfg.vocab_padded, cfg.d_model)
        self.layers = nn.ModuleList(Layer(init, cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(init, cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = Dense(init, cfg.d_model, cfg.vocab_padded, ("fsdp", "tp"),
                              scale=cfg.d_model**-0.5)


def init_model(cfg: ArchConfig, seed: int = 0, *, device="cuda", dtype=torch.float32) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's initial distributions (its numbers
    come from JAX's RNG and differ; ``convert.from_reference`` carries a
    reference tree across)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(Init(gen, dev, dtype), cfg)


def _vocab_weight(model: LM, cfg):
    """The parameter that holds the head's vocab: the table when tied."""
    return model.embed.table if cfg.tie_embeddings else model.head.w


def vocab_block(model: LM, cfg) -> tuple:
    """``(first vocab id, model group)`` of this rank's block of the
    logits, ``(0, None)`` when the model ranks do not split the vocab."""
    w = _vocab_weight(model, cfg)
    split = model_split(w)
    if split is None:
        return 0, None
    return model_rank(w) * (w.shape[split] // model_size(w)), model_group(w)


def _embed_tokens(model: LM, tokens, cfg, table=None):
    t = model.embed.table
    table = weight(t) if table is None else table
    if model_split(t) == 0:  # this rank's rows; the others' tokens look up zeros
        n = table.shape[0]
        ids = tokens.long() - model_rank(t) * n
        inside = (ids >= 0) & (ids < n)
        x = F.embedding(torch.where(inside, ids, 0), table) * inside[..., None].to(table.dtype)
        x = reduce_from_model(x, model_group(t))
    else:
        x = F.embedding(tokens, table)
    if cfg.tie_embeddings:
        x = x * cfg.d_model**0.5
    return x


def _head(model: LM, h, cfg, table=None):
    w = _vocab_weight(model, cfg)
    h = enter_model(h, w)
    if cfg.tie_embeddings:
        logits = h @ (weight(w) if table is None else table).T
    else:
        logits = dense(model.head, h)
    lo, _ = vocab_block(model, cfg)
    n = logits.shape[-1]
    if lo + n > cfg.vocab:  # mask padding ids, by their global id
        pad = torch.arange(lo, lo + n, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(model: LM, batch: dict, cfg: ArchConfig, *, mode="auto", chunk=512):
    """Full-sequence forward.  Returns (logits [B, S, V], aux_loss); on a
    mesh whose model ranks split the vocab, this rank's block of ``V``
    (``vocab_block``)."""
    # the tied table is gathered over the data ranks once, for both its uses
    table = weight(model.embed.table) if cfg.tie_embeddings else None
    if cfg.frontend == "frames":
        w = model.frontend_proj.w
        x = dense(model.frontend_proj, batch["frames"])
        if model_split(w) == 1:  # column-parallel: this rank's features
            x = gather_from_model(x, x.dim() - 1, model_group(w))
    else:
        x = _embed_tokens(model, batch["tokens"], cfg, table)
        if cfg.frontend == "patch":
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = hint(x, "hidden")
    h, aux = stack_apply(model.layers, x, cfg, mode=mode, chunk=chunk)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = hint(_head(model, h, cfg, table), "logits")
    return logits, aux


def _nll(logits, labels, lo=0, group=None):
    """Per-position cross-entropy.  With a model ``group``, ``logits`` is
    this rank's block of the vocab from id ``lo``: the maximum, the sum of
    exponentials and the label's logit are reduced over the group."""
    if group is None:
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(lp, labels[..., None].long(), dim=-1)[..., 0]
    z = logits - max_over(logits.amax(dim=-1), group)[..., None]
    sumexp = reduce_from_model(torch.exp(z).sum(dim=-1), group)
    n = logits.shape[-1]
    ids = labels.long() - lo
    inside = (ids >= 0) & (ids < n)
    picked = torch.take_along_dim(z, ids.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
    picked = reduce_from_model(torch.where(inside, picked, 0.0), group)
    return torch.log(sumexp) - picked


def lm_loss(model: LM, batch: dict, cfg: ArchConfig, *, mode="auto", chunk=512,
            aux_weight=0.01):
    """Cross-entropy loss (next-token for decoders, per-frame for encoders).
    Returns ``(loss + aux_weight * aux, (loss, aux))``."""
    logits, aux = forward(model, batch, cfg, mode=mode, chunk=chunk)
    logits = logits.float()
    lo, group = vocab_block(model, cfg)
    if cfg.encoder_only:
        loss = _nll(logits, batch["labels"], lo, group).mean()
    else:
        if cfg.frontend == "patch":
            # logits for text positions start after the patch prefix
            logits = logits[:, batch["patch_embeds"].shape[1] :, :]
        loss = _nll(logits[:, :-1], batch["tokens"][:, 1:], lo, group).mean()
    return loss + aux_weight * aux, (loss, aux)


def replicated_over_model(model: LM, cfg: ArchConfig) -> list:
    """The reference tree paths (``layers/attn/k/w``, …) of the weights
    split over the model ranks that a layer computes whole on every model
    rank, gathering them there: KV projections that cut a KV head, every
    projection of an attention that cuts a query head
    (``attention.attention_split``), and the SSM block's
    (``ssm.gathered_over_model``).  Empty without a mesh, and for
    qwen2-0.5b on a ``(2, 2)`` mesh."""
    names = set()
    for layer in model.layers:
        if hasattr(layer, "attn"):
            names.update(f"layers/attn/{n.replace('.', '/')}"
                         for n in attn_mod.gathered_over_model(layer.attn, cfg))
        if hasattr(layer, "ssm"):
            names.update(f"layers/ssm/{n.replace('.', '/')}"
                         for n in ssm_mod.gathered_over_model(layer.ssm))
    return sorted(names)


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
@torch.no_grad()
def prefill(model: LM, batch: dict, cfg: ArchConfig, max_len: int, *, mode="auto",
            chunk=512):
    """Run the prompt through the stack; returns the last-token logits.
    As in the reference, a pure forward: the caches are written by
    ``decode_step``, which owns their layout (a fused prefill is perf work
    for later)."""
    logits, _ = forward(model, batch, cfg, mode=mode, chunk=chunk)
    return logits[:, -1:, :]


@torch.no_grad()
def decode_step(model: LM, token, caches: dict, cur_len: int, cfg: ArchConfig):
    """One decode step.

    token: [B, 1] int; caches: stacked per-layer dict (``init_caches``),
    written in place; cur_len: the position of ``token`` (same for all
    layers).  Returns (logits [B, 1, V], caches).
    """
    x = _embed_tokens(model, token, cfg)
    h, caches = stack_decode(model.layers, x, cfg, caches, cur_len)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    return _head(model, h, cfg), caches
