"""Step functions and input specs shared by the trainer and the server.

The port of ``repro.launch.steps``.  ``input_specs`` gives ``meta``-device
tensors with the shapes and dtypes of one step's batch (no memory is
allocated).  ``make_train_step`` returns a function that takes
``lm_loss``'s gradient and applies AdamW to the model's parameters in
place.  The abstract model, cache and optimizer states of the reference
serve its dry run, and come with the port's.

``make_train_step(..., mesh=)`` is the step on a ``("data", "model")``
mesh, the reference's jitted step under GSPMD: the model's parameters are
placed on it (``models.convert.place_model``) and each rank passes
its data coordinate's block of the global batch.  The layers compute on
the blocks with explicit collectives (``models.layers``): a ZeRO-3
gather's backward hands each parameter split over the data ranks its
gradient reduce-scattered and averaged over them; the gradients of the
parameters the data ranks replicate are averaged over the data group
after the backward (not over the world: the model ranks already agree);
nothing is reduced twice.  AdamW runs on the blocks, its clip on the
global norm.  Where the model axis cuts a head or the SSM's fused
segments, a layer gathers its weights over the model ranks and computes
whole there (``models.model.replicated_over_model`` names them).  The
numbers are the one-device step's on the global batch up to float order;
for an MoE, its ``n_micro = dp`` step (each data rank's router sees its
own block).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed.collectives import all_reduce_mean
from ..distributed.sharding import local_tensor
from ..models.model import decode_step, lm_loss, prefill
from ..optim.adamw import AdamWConfig, adamw_update

__all__ = [
    "input_specs",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "attn_plan",
]


def attn_plan(cfg: ArchConfig, shape: ShapeConfig, dp_total: int = 16) -> dict:
    """Static attention/memory plan per (arch, shape).

    ``n_micro`` (gradient-accumulation microbatches) is sized so the
    per-device checkpointed layer inputs stay ~<= 3 GB:
        act_bytes = B_local * S * D * 2 * L / n_micro.
    """
    plan = {
        "mode": "dot" if shape.seq_len <= 2048 else "chunked",
        "chunk": 1024 if shape.seq_len >= 32768 else 512,
        "unroll": 1,
        "layer_unroll": 1,
        "n_micro": 1,
    }
    if shape.kind == "train":
        b_local = max(1, shape.global_batch // dp_total)
        act_gb = (
            b_local * shape.seq_len * cfg.d_model * 2 * cfg.n_layers / 1e9
        )
        n = 1
        while act_gb / n > 3.0 and n < b_local:
            n *= 2
        plan["n_micro"] = n
    return plan


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors for the data batch of one step (the reference's
    ``ShapeDtypeStruct``s)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": spec((b, 1))}
    if cfg.frontend == "frames":
        return {"frames": spec((b, s, cfg.frontend_dim), torch.bfloat16),
                "labels": spec((b, s))}
    if cfg.frontend == "patch":
        return {"tokens": spec((b, s - cfg.frontend_len)),
                "patch_embeds": spec((b, cfg.frontend_len, cfg.d_model), torch.bfloat16)}
    return {"tokens": spec((b, s))}


def _data_split(p) -> bool:
    """Whether a placed parameter is split over the ``data`` mesh axis."""
    mesh = p.device_mesh
    i = mesh.mesh_dim_names.index("data")
    return p.placements[i].is_shard() and mesh.size(i) > 1


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, plan: dict, mesh=None):
    """The full update step ``train_step(model, opt_state, batch)`` →
    ``(model, opt_state, metrics)``, the parameters updated in place.

    ``plan["n_micro"] > 1`` accumulates float32 gradients over that many
    microbatches (each batch tensor split on its leading axis) and divides
    by ``n_micro``, so live activations are one microbatch's.  As in the
    reference, the reported ``loss`` is ``ce + aux_weight * aux`` with one
    microbatch and the mean ``ce`` with several (the two differ for MoE).

    With a ``mesh`` (module doc) the model is placed on it and ``batch`` is
    this rank's data block; the gradients of the parameters replicated
    over the data ranks are averaged over the data group (in flat float32
    buckets, ``collectives.all_reduce_mean``), and the reported ``loss``,
    ``ce`` and ``aux`` are the means over the data ranks of each rank's.
    """
    n_micro = int(plan.get("n_micro", 1))
    data_group = None
    if mesh is not None and mesh.size(mesh.mesh_dim_names.index("data")) > 1:
        data_group = mesh.get_group("data")

    def grads_of(model, params, batch):
        total, (ce, aux) = lm_loss(model, batch, cfg, mode=plan["mode"], chunk=plan["chunk"])
        grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
        return total.detach(), ce.detach(), aux.detach(), grads

    def train_step(model, opt_state, batch):
        params = list(model.parameters())
        if n_micro == 1:
            loss, ce, aux, grads = grads_of(model, params, batch)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            dev = local_tensor(params[0]).device
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                _, ce_i, aux_i, g = grads_of(model, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(grads, g):
                    local_tensor(acc).add_(local_tensor(gi).float())
                ce, aux = ce + ce_i, aux + aux_i
                del g
            grads = [g / n_micro for g in grads]
            ce, aux = ce / n_micro, aux / n_micro
            loss = ce
        if data_group is not None:
            with torch.no_grad():
                blocks = [local_tensor(g) for p, g in zip(params, grads) if not _data_split(p)]
                for g, mean in zip(blocks, all_reduce_mean(blocks, data_group)):
                    if mean is not g:
                        g.copy_(mean)
            loss, ce, aux = all_reduce_mean([torch.stack([loss, ce, aux]).float()],
                                            data_group)[0]
        model, opt_state, metrics = adamw_update(model, grads, opt_state, opt_cfg)
        return model, opt_state, {**metrics, "loss": loss, "ce": ce, "aux": aux}

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, plan: dict):
    def prefill_step(model, batch):
        return prefill(model, batch, cfg, shape.seq_len, mode=plan["mode"],
                       chunk=plan["chunk"])

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(model, token, caches, cur_len):
        return decode_step(model, token, caches, cur_len, cfg)

    return serve_step
