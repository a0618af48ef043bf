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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.sharding import hint
from ..kernels.ops import resolve_device
from .blocks import Layer, init_caches, stack_apply, stack_decode
from .layers import Dense, Embed, Init, RMSNorm, dense, rmsnorm

__all__ = [
    "LM",
    "init_model",
    "forward",
    "lm_loss",
    "prefill",
    "decode_step",
    "init_caches",
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


def _embed_tokens(model: LM, tokens, cfg):
    x = F.embedding(tokens, model.embed.table)
    if cfg.tie_embeddings:
        x = x * cfg.d_model**0.5
    return x


def _head(model: LM, h, cfg):
    logits = h @ model.embed.table.T if cfg.tie_embeddings else dense(model.head, h)
    if cfg.vocab_padded != cfg.vocab:  # mask padding ids
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(model: LM, batch: dict, cfg: ArchConfig, *, mode="auto", chunk=512):
    """Full-sequence forward.  Returns (logits [B, S, V], aux_loss)."""
    if cfg.frontend == "frames":
        x = dense(model.frontend_proj, batch["frames"])
    else:
        x = _embed_tokens(model, batch["tokens"], cfg)
        if cfg.frontend == "patch":
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = hint(x, "hidden")
    h, aux = stack_apply(model.layers, x, cfg, mode=mode, chunk=chunk)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = hint(_head(model, h, cfg), "logits")
    return logits, aux


def _nll(logits, labels):
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(lp, labels[..., None].long(), dim=-1)[..., 0]


def lm_loss(model: LM, batch: dict, cfg: ArchConfig, *, mode="auto", chunk=512,
            aux_weight=0.01):
    """Cross-entropy loss (next-token for decoders, per-frame for encoders).
    Returns ``(loss + aux_weight * aux, (loss, aux))``."""
    logits, aux = forward(model, batch, cfg, mode=mode, chunk=chunk)
    logits = logits.float()
    if cfg.encoder_only:
        loss = _nll(logits, batch["labels"]).mean()
    else:
        if cfg.frontend == "patch":
            # logits for text positions start after the patch prefix
            logits = logits[:, batch["patch_embeds"].shape[1] :, :]
        loss = _nll(logits[:, :-1], batch["tokens"][:, 1:]).mean()
    return loss + aux_weight * aux, (loss, aux)


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
