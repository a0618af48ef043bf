"""Gradient compression with error feedback (beyond-paper).

The port of ``repro.optim.compress``.  Two schemes, each with an error
residual added back into the next step:

* int8 quantization with a per-tensor scale (about 4x under float32);
* magnitude top-k sparsification (``frac`` of the entries kept).

``compressed_psum`` is the reference's ``shard_map`` pattern as a
``torch.distributed.all_reduce`` over a process group: each rank
compresses (grad + residual), the dequantized values are summed across
ranks, and the residual stays local.  Gradients are sequences of tensors
(the parameters' order), where the reference maps a tree.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "ef_state_init",
    "int8_compress",
    "int8_decompress",
    "topk_compress",
    "topk_decompress",
    "ef_roundtrip",
    "compressed_psum",
]


def ef_state_init(grads) -> list:
    return [torch.zeros_like(g, dtype=torch.float32) for g in grads]


def int8_compress(x):
    """(q int8, scale float32); ``round`` is half to even, as ``jnp.round``."""
    x = x.float()
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.float() * scale


def topk_compress(x, frac: float):
    """The ``k = max(1, int(size * frac))`` entries largest in magnitude:
    (values, flat indices, shape).  Ties may be ordered otherwise than by
    ``jax.lax.top_k``."""
    x = x.float()
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx, tuple(x.shape)


def topk_decompress(kept, idx, shape):
    flat = torch.zeros(math.prod(shape), dtype=torch.float32, device=kept.device)
    flat[idx] = kept
    return flat.reshape(shape)


def ef_roundtrip(g, err, scheme: str = "int8", frac: float = 0.01):
    """One error-feedback round trip for a single tensor: (decompressed
    value for the optimizer or the all-reduce, new error residual)."""
    corrected = g.float() + err
    if scheme == "int8":
        approx = int8_decompress(*int8_compress(corrected))
    elif scheme == "topk":
        approx = topk_decompress(*topk_compress(corrected, frac))
    else:
        raise ValueError(scheme)
    return approx, corrected - approx


def compressed_psum(grads, err_state, group=None, scheme: str = "int8", frac: float = 0.01):
    """Error-feedback compressed all-reduce over ``group`` (default: the
    world group of an initialised ``torch.distributed``).  Returns (summed
    approximations, new residuals), each a list following ``grads``."""
    import torch.distributed as dist

    summed, residuals = [], []
    for g, e in zip(grads, err_state):
        approx, new_e = ef_roundtrip(g, e, scheme, frac)
        dist.all_reduce(approx, op=dist.ReduceOp.SUM, group=group)
        summed.append(approx)
        residuals.append(new_e)
    return summed, residuals
