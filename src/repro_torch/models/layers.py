"""Parameter plumbing + basic layers (norms, MLP, RoPE, embeddings).

The port of ``repro.models.layers``.  Parameters live in ``nn.Module``s
whose attribute names are the reference's tree keys (``w``/``b`` of a
dense layer, ``g`` of a norm, ``table`` of an embedding), so a module path
such as ``layers.3.attn.q.w`` names the reference leaf
``tree["layers"]["attn"]["q"]["w"][3]`` (``convert.from_reference``).
Weights keep the reference's ``[d_in, d_out]`` layout: ``dense`` is
``x @ w``, and carrying weights across is a copy, not a transpose.  The
layer functions take the module as the reference's take its dict.

Each module holds the logical partition specs of its own parameters, the
reference's ``P`` leaves, in ``specs`` (parameter name → a tuple with one
entry a dimension): ``"fsdp"`` (ZeRO-3 over the data axis), ``"tp"``
(tensor parallel over the model axis) or ``None`` (replicated).
``convert.spec_tree`` gathers them into the reference's spec tree, and
``repro_torch.distributed.sharding`` resolves them against a mesh.

On a mesh (``convert.place_model``) the parameters are ``DTensor``s and
each rank computes on its blocks; the weight's placement decides the
computation, as GSPMD's does for the reference (not the logical spec: a
mesh axis that does not divide a dimension is demoted to replication).
``weight`` gives the tensor a layer computes with: the local block with
its ``fsdp`` dimension gathered over the data ranks (ZeRO-3,
``collectives.zero3_gather``).  A ``dense`` weight split over the model
ranks on its output dimension is column-parallel (this rank's columns; the
caller puts its input into the model region once, ``enter_model``), on
its input dimension row-parallel (this rank's rows, then the sum over the
model ranks), and a weight replicated there is plain.  A layer that
computes whole on every model rank (``whole=True``) gathers its weights
over the model ranks too; one that takes the whole weights to its own
rows or heads (``partial=True`` as well) sums their gradients over the
model ranks.  Plain tensors take the plain path unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.collectives import (copy_to_model, gather_from_model, reduce_from_model,
                                       zero3_gather)
from ..distributed.sharding import is_placed

__all__ = [
    "weight",
    "model_split",
    "model_size",
    "model_group",
    "model_rank",
    "enter_model",
    "Init",
    "Dense",
    "dense",
    "RMSNorm",
    "rmsnorm",
    "LayerNorm",
    "layernorm",
    "MLP",
    "mlp",
    "Embed",
    "rope_freqs",
    "apply_rope",
]


def _model_dim(w):
    names = w.device_mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


def model_size(w) -> int:
    """The size of ``w``'s ``model`` mesh axis (1 for a plain tensor)."""
    i = _model_dim(w) if is_placed(w) else None
    return 1 if i is None else w.device_mesh.size(i)


def model_split(w):
    """The dimension of ``w`` split over the ``model`` mesh axis, or None
    (a plain tensor, or one the model ranks replicate)."""
    if model_size(w) == 1:
        return None
    p = w.placements[_model_dim(w)]
    return p.dim if p.is_shard() else None


def model_group(w):
    """The process group of ``w``'s ``model`` mesh axis."""
    return w.device_mesh.get_group(_model_dim(w))


def model_rank(w) -> int:
    """This rank's coordinate on ``w``'s ``model`` mesh axis."""
    return w.device_mesh.get_local_rank(_model_dim(w))


def enter_model(x, w):
    """``x`` entering products whose weight ``w`` is split over the model
    ranks (``collectives.copy_to_model``); ``x`` itself otherwise."""
    return x if model_split(w) is None else copy_to_model(x, model_group(w))


def weight(w, whole: bool = False, partial: bool = False):
    """The tensor a layer computes with: ``w`` itself when plain; for a
    ``DTensor``, this rank's block with each dimension split over the data
    ranks gathered (``zero3_gather``: its gradient comes back
    reduce-scattered) and, with ``whole``, the dimension split over the
    model ranks gathered too (``gather_from_model``).  With ``partial``
    (and ``whole``) each model rank uses the weight on its own rows or
    heads, so its gradient is summed over the model ranks: reduce-scattered
    where they split it, all-reduced where they replicate it.
    Differentiable."""
    if not is_placed(w):
        return w
    x, mesh = w.to_local(), w.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = w.placements[i]
        if mesh.size(i) == 1:
            continue
        if mesh.mesh_dim_names[i] != "model":
            if p.is_shard():
                x = zero3_gather(x, p.dim, mesh.get_group(i))
        elif p.is_shard() and whole:
            x = gather_from_model(x, p.dim, mesh.get_group(i), partial)
        elif not p.is_shard() and partial:
            x = copy_to_model(x, mesh.get_group(i))
    return x


class Init:
    """Where new weights are made and how: on ``device`` in ``dtype``,
    drawn from ``generator`` (a ``torch.Generator`` on that device).  With
    ``generator=None`` random weights are left uninitialised, for weights
    that are copied in next (``convert.from_reference``)."""

    def __init__(self, generator, device, dtype=torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def normal(self, shape, scale, dtype=None) -> nn.Parameter:
        """N(0, 1) * scale, drawn in float32 and cast to ``dtype``, as the
        reference's ``_init_matrix``."""
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.generator is not None:
            t.normal_(generator=self.generator).mul_(scale)
        return nn.Parameter(t.to(dtype or self.dtype))

    def full(self, shape, value, dtype=None) -> nn.Parameter:
        return nn.Parameter(
            torch.full(shape, value, dtype=dtype or self.dtype, device=self.device)
        )

    def tensor(self, values, dtype=torch.float32) -> nn.Parameter:
        return nn.Parameter(values.to(device=self.device, dtype=dtype))


class Dense(nn.Module):
    """``{"w": [d_in, d_out], "b": [d_out]}`` (``b`` only with ``bias``);
    ``w`` takes ``spec`` (the reference's ``dense_init`` argument; most of
    its layers pass ``("fsdp", "tp")``), ``b`` its last entry."""

    def __init__(self, init: Init, d_in, d_out, spec=("fsdp", "tp"), bias=False, scale=None):
        super().__init__()
        self.w = init.normal((d_in, d_out), d_in**-0.5 if scale is None else scale)
        self.b = init.full((d_out,), 0.0) if bias else None
        self.specs = {"w": tuple(spec), "b": (spec[-1],)}


def dense(p: Dense, x, whole: bool = False, partial: bool = False):
    """``x @ w + b``.  On a placed weight (module doc): this rank's columns
    when ``w`` is split over the model ranks on its output dimension (``x``
    entered the model region), the sum over the model ranks when on its
    input dimension (``x`` holds this rank's block of features), and the
    whole product with ``whole`` (``partial``: on this rank's rows, the
    gradients summed over the model ranks, ``weight``).  A bias takes its
    weight's output placement, and is added after the sum."""
    y = x @ weight(p.w, whole, partial)
    if not whole and model_split(p.w) == 0:
        y = reduce_from_model(y, model_group(p.w))
    if p.b is not None:
        y = y + weight(p.b, whole, partial)
    return y


class RMSNorm(nn.Module):
    specs = {"g": (None,)}

    def __init__(self, init: Init, d):
        super().__init__()
        self.g = init.full((d,), 1.0)


def rmsnorm(p: RMSNorm, x, eps=1e-6):
    """Computed in float32 and cast back to ``x``'s type."""
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * weight(p.g).float()).to(x.dtype)


class LayerNorm(nn.Module):
    specs = {"g": (None,), "b": (None,)}

    def __init__(self, init: Init, d):
        super().__init__()
        self.g = init.full((d,), 1.0)
        self.b = init.full((d,), 0.0)


def layernorm(p: LayerNorm, x, eps=1e-6):
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * weight(p.g).float() + weight(p.b).float()).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, init: Init, d_model, d_ff, act="swiglu"):
        super().__init__()
        self.up = Dense(init, d_model, d_ff, ("fsdp", "tp"))
        self.down = Dense(init, d_ff, d_model, ("tp", "fsdp"), scale=d_ff**-0.5)
        self.gate = Dense(init, d_model, d_ff, ("fsdp", "tp")) if act == "swiglu" else None


def mlp(p: MLP, x, act="swiglu"):
    """Column-parallel ``up``/``gate`` and row-parallel ``down`` on a
    mesh that splits ``d_ff`` (they share its demotion)."""
    x = enter_model(x, p.up.w)
    up = dense(p.up, x)
    if act == "swiglu":
        h = F.silu(dense(p.gate, x)) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to the exact
        h = F.gelu(up, approximate="tanh")
    return dense(p.down, h)


class Embed(nn.Module):
    specs = {"table": ("tp", "fsdp")}

    def __init__(self, init: Init, vocab, d):
        super().__init__()
        # N(0, 1/sqrt(d)) keeps tied-head logits O(1) at init
        self.table = init.normal((vocab, d), d**-0.5)


# ----------------------------- RoPE ---------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    ang = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
