"""Step functions and abstract input and state specs shared by the dry
run, the trainer and the server.

The port of ``repro.launch.steps``.  ``input_specs`` gives ``meta``-device
tensors with the shapes and dtypes of one step's batch, and
``abstract_model``, ``abstract_caches`` and ``abstract_opt_state`` the
model, its decode caches and its AdamW state on the ``meta`` device (the
reference's ``jax.eval_shape`` trees: no memory is allocated, so a
published configuration of 314 B parameters costs nothing).
``make_train_step`` returns a function that takes ``lm_loss``'s gradient
and applies AdamW to the model's parameters in place.

``make_train_step(..., mesh=)`` is the step on a ``("data", "model")``
or ``("pod", "data", "model")`` mesh, the reference's jitted step under
GSPMD: the model's parameters are placed on it
(``models.convert.place_model``) and each rank passes the block of the
global batch at its flat coordinate over ``("pod", "data")``
(``default_rules``' ``dp``; ``launch.mesh.mesh_coords``).  The layers
compute on the blocks with explicit collectives (``models.layers``): a
ZeRO-3 gather's backward hands each parameter split over the data ranks
(``fsdp`` is ``data`` alone, so the pods replicate it) its gradient
reduce-scattered and averaged over them, and that block is then averaged
over the pod group; the gradients of the parameters the data ranks
replicate are averaged over ``("pod", "data")`` after the backward (not
over the world: the model ranks already agree); nothing is reduced twice.  AdamW runs on the blocks, its clip on the
global norm.  Where the model axis cuts a query head, attention runs on
its weights gathered over the model ranks, split by sequence (or by
uneven blocks of heads, under ``attn_heads="tp_uneven"``), and sums their
gradients there; where it cuts a KV head or the SSM's fused segments, a
layer gathers those weights and computes whole there
(``models.model.replicated_over_model`` names every gathered weight,
``attention_splits`` each layer's split: ``models.attention``).  The
numbers are the one-device step's on the global batch up to float order;
for an MoE, its ``n_micro = dp`` step (each data rank's router sees its
own block).

``make_prefill_step(..., mesh=)`` and ``make_decode_step(mesh=)`` serve a
placed model: the batch block of this rank's data coordinate, the decode
caches placed by ``cache_sharding`` (``models.blocks.init_caches(...,
sharding=)``), and the last token's logits gathered whole over the model
ranks, for ``argmax``.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed.collectives import all_reduce_mean, mesh_group
from ..distributed.sharding import local_tensor
from ..models.blocks import cache_shapes
from ..models.convert import spec_tree
from ..models.layers import Init
from ..models.model import LM, decode_step, lm_loss, prefill
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = [
    "input_specs",
    "abstract_model",
    "abstract_caches",
    "abstract_opt_state",
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


def abstract_model(cfg: ArchConfig, dtype=torch.bfloat16):
    """``(model, logical spec tree)``: ``cfg``'s model with its parameters
    on the ``meta`` device in ``dtype`` (the SSM's ``A_log``, ``D`` and
    ``dt_bias`` stay float32, as the reference's), and the reference's
    spec tree (``convert.spec_tree``)."""
    model = LM(Init(None, "meta", dtype), cfg)
    return model, spec_tree(model)


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """``init_caches``' tree on the ``meta`` device."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in cache_shapes(cfg, batch, max_len, dtype).items()}


def abstract_opt_state(model) -> dict:
    """``adamw_init``'s state for ``model``, placed and on the device as
    its parameters (the ``meta`` device for ``abstract_model``'s)."""
    return adamw_init(model)


def _data_split(p) -> bool:
    """Whether a placed parameter is split over the ``data`` mesh axis."""
    mesh = p.device_mesh
    i = mesh.mesh_dim_names.index("data")
    return p.placements[i].is_shard() and mesh.size(i) > 1


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, plan: dict, mesh=None,
                    on_micro=None):
    """The full update step ``train_step(model, opt_state, batch)`` →
    ``(model, opt_state, metrics)``, the parameters updated in place.

    ``plan["n_micro"] > 1`` accumulates float32 gradients over that many
    microbatches (each batch tensor split on its leading axis) and divides
    by ``n_micro``, so live activations are one microbatch's.  As in the
    reference, the reported ``loss`` is ``ce + aux_weight * aux`` with one
    microbatch and the mean ``ce`` with several (the two differ for MoE).

    With a ``mesh`` (module doc) the model is placed on it and ``batch`` is
    this rank's data block; the gradients of the parameters replicated
    over the data ranks are averaged over ``("pod", "data")`` (in flat
    float32 buckets, ``collectives.all_reduce_mean``), those split over
    the data ranks over the pods, and the reported ``loss``, ``ce`` and
    ``aux`` are the means over ``("pod", "data")`` of each rank's.
    """
    n_micro = int(plan.get("n_micro", 1))
    dp_group = pod_group = None
    if mesh is not None:
        names = mesh.mesh_dim_names
        dp_axes = tuple(a for a in ("pod", "data") if a in names)
        if any(mesh.size(names.index(a)) > 1 for a in dp_axes):
            dp_group = mesh_group(mesh, dp_axes)
        if "pod" in names and mesh.size(names.index("pod")) > 1:
            pod_group = mesh.get_group("pod")

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
                if on_micro is not None:
                    on_micro(i)
            grads = [g / n_micro for g in grads]
            ce, aux = ce / n_micro, aux / n_micro
            loss = ce
        if dp_group is not None:
            with torch.no_grad():
                for split, group in ((False, dp_group), (True, pod_group)):
                    blocks = [local_tensor(g) for p, g in zip(params, grads)
                              if _data_split(p) == split]
                    if group is None or not blocks:
                        continue
                    for g, mean in zip(blocks, all_reduce_mean(blocks, group)):
                        if mean is not g:
                            g.copy_(mean)
            loss, ce, aux = all_reduce_mean([torch.stack([loss, ce, aux]).float()],
                                            dp_group)[0]
        model, opt_state, metrics = adamw_update(model, grads, opt_state, opt_cfg)
        return model, opt_state, {**metrics, "loss": loss, "ce": ce, "aux": aux}

    return train_step


def _on_mesh(model, mesh) -> None:
    p = next(model.parameters())
    if mesh is not None and getattr(p, "device_mesh", None) != mesh:
        raise ValueError("the model is not placed on this mesh (models.convert.place_model)")


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, plan: dict, mesh=None):
    """``prefill_step(model, batch)`` → the last token's logits [B, 1, V];
    with a ``mesh``, of this rank's batch block, gathered over the model
    ranks (module doc)."""
    def prefill_step(model, batch):
        _on_mesh(model, mesh)
        return prefill(model, batch, cfg, shape.seq_len, mode=plan["mode"],
                       chunk=plan["chunk"])

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``serve_step(model, token, caches, cur_len)`` → ``(logits, caches)``;
    with a ``mesh``, on this rank's batch block and cache blocks, the
    logits gathered over the model ranks (module doc)."""
    def serve_step(model, token, caches, cur_len):
        _on_mesh(model, mesh)
        return decode_step(model, token, caches, cur_len, cfg)

    return serve_step
