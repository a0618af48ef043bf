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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
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


def dense(p: Dense, x):
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
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
    return (h * p.g.float()).to(x.dtype)


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
    return (h * p.g.float() + p.b.float()).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, init: Init, d_model, d_ff, act="swiglu"):
        super().__init__()
        self.up = Dense(init, d_model, d_ff, ("fsdp", "tp"))
        self.down = Dense(init, d_ff, d_model, ("tp", "fsdp"), scale=d_ff**-0.5)
        self.gate = Dense(init, d_model, d_ff, ("fsdp", "tp")) if act == "swiglu" else None


def mlp(p: MLP, x, act="swiglu"):
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
