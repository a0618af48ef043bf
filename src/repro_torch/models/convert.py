"""Carry the reference's weights across: a ``repro.models`` value tree, as
numpy arrays, into the port's modules.

Each parameter of the port's module tree is named by the reference's
tree path, with the layer index where the reference stacks layers on a
leading ``L`` axis: ``layers.3.attn.q.w`` is
``tree["layers"]["attn"]["q"]["w"][3]``.  Both keep ``[d_in, d_out]``
weights, so every leaf is a copy.  The tests use this so that both
packages compute with the same weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.ops import resolve_device
from .layers import Init
from .model import LM

__all__ = ["copy_tree", "from_reference"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def copy_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy ``tree``'s leaves into ``module``'s parameters and return it.
    A numeric part of a parameter's name indexes the leading axis of the
    leaf named by the other parts.  Every leaf must find its parameter and
    shape, and every parameter its leaf."""
    leaves = dict(_leaves(tree))
    used = set()
    with torch.no_grad():
        for name, param in module.named_parameters():
            parts = name.split(".")
            path = tuple(p for p in parts if not p.isdigit())
            if path not in leaves:
                raise KeyError(f"the reference tree has no leaf {'/'.join(path)}")
            value = np.asarray(leaves[path])
            for index in (int(p) for p in parts if p.isdigit()):
                value = value[index]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: reference shape {value.shape}, port shape {tuple(param.shape)}"
                )
            param.copy_(torch.from_numpy(np.array(value)))
            used.add(path)
    missing = set(leaves) - used
    if missing:
        raise KeyError(f"reference leaves with no port parameter: {sorted(missing)}")
    return module


def from_reference(cfg: ArchConfig, tree: dict, *, device="cuda", dtype=torch.float32) -> LM:
    """The port's model on ``device`` holding the weights of ``tree`` (the
    reference's ``init_model`` values, layer leaves stacked on ``L``)."""
    dev = resolve_device(device)
    return copy_tree(LM(Init(None, dev, dtype), cfg), tree)
