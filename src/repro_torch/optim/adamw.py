"""AdamW with global-norm clipping and schedules, as plain functions on
tensors.

The port of ``repro.optim.adamw``.  The reference maps a parameter tree;
here the state mirrors ``model.parameters()`` in order: ``m`` and ``v``
are lists of float32 tensors, one a parameter, and ``step`` a 0-d int32
tensor on the parameters' device.  Every step-dependent scalar (the bias
corrections ``b1 ** step``, the warmup ratio, the cosine) is a float32
tensor, as the reference computes it, so no Python double enters the
update and nothing leaves the device.

On a mesh the parameters, their gradients and both moments are
``DTensor``s placed alike: the update runs on each rank's blocks, and
``global_norm`` counts each entry of the global gradient once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from ..distributed.collectives import count
from ..distributed.sharding import is_placed, local_tensor

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "cosine_schedule"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant


def _params(model) -> list:
    return list(model.parameters()) if isinstance(model, nn.Module) else list(model)


def adamw_init(model) -> dict:
    """Zero moments for ``model``'s parameters (or a sequence of tensors)."""
    params = _params(model)
    device = params[0].device if params else torch.device("cpu")
    return {
        "m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a 0-d tensor).
    A ``DTensor`` counts each entry of its global value once: the sums of
    squares of the blocks are added over the mesh dimensions that split
    it (one ``all_reduce`` a set of such dimensions, over each of their
    groups, counted in ``collectives.traffic``), and not over those that
    replicate it."""
    plain, split = [], {}
    for x in tensors:
        sq = torch.sum(torch.square(local_tensor(x).float()))
        if not is_placed(x):
            plain.append(sq)
            continue
        mesh = x.device_mesh
        dims = tuple(i for i, p in enumerate(x.placements) if p.is_shard() and mesh.size(i) > 1)
        key = (mesh, dims)
        split[key] = split[key] + sq if key in split else sq
    total = sum(plain)
    for (mesh, dims), sq in split.items():
        for i in dims:
            count("norm_all_reduce", sq)
            dist.all_reduce(sq, group=mesh.get_group(i))
        total = total + sq
    return torch.sqrt(total)


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a float32 tensor, or a number taken as
    one): linear warmup, then cosine, linear or constant decay."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm * 1.0
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    if cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


@torch.no_grad()
def adamw_update(model, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step.  ``grads`` follows ``model.parameters()``.  The
    parameters and the moments ``m``/``v`` are updated in place; returns
    ``(model, state, metrics)`` with a new ``state["step"]`` and
    ``metrics = {"grad_norm", "lr"}`` (the norm before clipping)."""
    params = _params(model)
    if not (len(params) == len(grads) == len(state["m"]) == len(state["v"])):
        raise ValueError("grads and the optimizer state must follow the parameters")
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step_f = step.float()
    lr = cosine_schedule(step_f, cfg)
    corr1 = 1 - torch.pow(cfg.b1, step_f)
    corr2 = 1 - torch.pow(cfg.b2, step_f)
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        # a placed parameter's block, its gradient's and its moments'
        p, g, m, v = (local_tensor(t) for t in (p, g, m, v))
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / corr1) / (torch.sqrt(v / corr2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return model, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gn, "lr": lr}
