"""Carry weights between the packages: a ``repro.models`` value tree, as
numpy arrays, into the port's modules (``copy_tree``/``from_reference``),
and the port's parameters back into that tree (``to_reference``); and
the reference's logical spec tree and parameter shapes of a model
(``spec_tree``, ``shape_tree``), for ``distributed.sharding``; and
``place_model``, which lays a model's parameters on a mesh as that
module's ``param_sharding`` tree places them.

On a placed model (``DTensor`` parameters, ``place_model``)
``to_reference`` gathers each parameter's blocks (a collective every rank
calls) into the reference's stacked tree, and ``tree_values``/
``copy_tree`` take each rank's block: the leaf's own block where the
leaf is a ``DTensor`` placed alike (``CheckpointManager.restore(
shardings=...)``), else the slice of the whole value at the rank's mesh
coordinate.

Each parameter of the port's module tree is named by the reference's
tree path, with the layer index where the reference stacks layers on a
leading ``L`` axis: ``layers.3.attn.q.w`` is
``tree["layers"]["attn"]["q"]["w"][3]``.  Both keep ``[d_in, d_out]``
weights, so every leaf is a copy.  The tests use this so that both
packages compute with the same weights; the trainer's checkpoints use
``to_reference``'s layout, so either package restores the other's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.collectives import gather_full
from ..distributed.sharding import NamedSharding, is_placed, local_block, local_tensor
from ..kernels.ops import resolve_device
from .layers import Init
from .model import LM

__all__ = ["copy_tree", "from_reference", "to_reference", "tree_values", "spec_tree",
           "shape_tree", "place_model"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def split_name(name: str):
    """(tree path, layer indices) of a parameter name."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def tree_values(module: nn.Module, tree: dict) -> list:
    """The value in ``tree`` (numpy arrays, tensors or ``DTensor``s) of
    each of ``module``'s parameters, as tensors in ``module.parameters()``
    order: for a placed parameter, this rank's block (module doc).  A
    numeric part of a parameter's name indexes the leading axis of the
    leaf named by the other parts.  Every leaf must find its parameter and
    shape, and every parameter its leaf."""
    leaves = dict(_leaves(tree))
    used = set()
    values = []
    for name, param in module.named_parameters():
        path, indices = split_name(name)
        if path not in leaves:
            raise KeyError(f"the reference tree has no leaf {'/'.join(path)}")
        value = leaves[path]
        block = is_placed(value)
        if block:  # placed alike: the stacked leaf's block, its layer axis whole
            want = tuple(local_tensor(param).shape)
            value = value.to_local()
        else:
            want = tuple(param.shape)
            if not isinstance(value, torch.Tensor):
                value = np.asarray(value)
        for index in indices:
            value = value[index]
        if tuple(value.shape) != want:
            raise ValueError(f"{name}: reference shape {value.shape}, port shape {want}")
        if not block and is_placed(param):
            value = local_block(param, value)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        values.append(value)
        used.add(path)
    missing = set(leaves) - used
    if missing:
        raise KeyError(f"reference leaves with no port parameter: {sorted(missing)}")
    return values


def copy_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy ``tree``'s leaves into ``module``'s parameters (matched as
    ``tree_values`` matches them; a placed parameter takes its block) and
    return it."""
    with torch.no_grad():
        for param, value in zip(module.parameters(), tree_values(module, tree)):
            local_tensor(param).copy_(value)
    return module


def to_reference(module: nn.Module, values=None) -> dict:
    """The reference's nested numpy tree of ``module``'s parameters, or of
    ``values`` (one tensor a parameter, in ``module.parameters()`` order,
    such as AdamW's ``m``): layer leaves stacked on a leading ``L`` axis.
    ``copy_tree(module, to_reference(module))`` gives back the same bits.
    A ``DTensor`` is gathered whole (``collectives.gather_full``), so on a
    placed model every rank of its mesh calls this.  Numpy has no
    bfloat16, so a bfloat16 tensor raises ``TypeError``."""
    named = list(module.named_parameters())
    if values is None:
        values = [p for _, p in named]
    if len(values) != len(named):
        raise ValueError(f"{len(values)} values for {len(named)} parameters")
    stacks: dict = {}
    for (name, _), value in zip(named, values):
        path, indices = split_name(name)
        if value.dtype == torch.bfloat16:
            raise TypeError(f"{name}: numpy has no bfloat16")
        # a copy: the tree must not change when the parameters are next updated
        value = gather_full(value.detach())
        stacks.setdefault(path, []).append((indices, value.to("cpu", copy=True).numpy()))
    tree: dict = {}
    for path, items in stacks.items():
        if items[0][0]:
            leaf = np.stack([a for _, a in sorted(items, key=lambda it: it[0])])
        else:
            leaf = items[0][1]
        _set_leaf(tree, path, leaf)
    return tree


def _set_leaf(tree: dict, path, leaf) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def spec_tree(module: nn.Module) -> dict:
    """The reference's logical spec tree of ``module``'s parameters (the
    second value of ``repro.models.model.init_model``): each leaf is the
    ``specs`` entry of the module that owns the parameter, and a layer's
    leaf gets the leading ``None`` of the stacked layer axis."""
    tree: dict = {}
    seen: dict = {}
    for mod_name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            path, indices = split_name(f"{mod_name}.{pname}" if mod_name else pname)
            try:
                spec = (None,) * len(indices) + tuple(mod.specs[pname])
            except (AttributeError, KeyError):
                raise KeyError(f"{type(mod).__name__} declares no spec for {pname}") from None
            if seen.setdefault(path, spec) != spec:
                raise ValueError(f"layers disagree on the spec of {'/'.join(path)}")
            _set_leaf(tree, path, spec)
    return tree


def shape_tree(module: nn.Module) -> dict:
    """The shape (``torch.Size``) of each leaf of ``to_reference(module)``,
    without copying: layer leaves stacked on a leading ``L`` axis.  On a
    ``meta``-device model it costs no memory (``LM(Init(None, "meta"),
    cfg)``), so it gives a published configuration's shapes."""
    stacks: dict = {}
    for name, param in module.named_parameters():
        path, indices = split_name(name)
        stacks.setdefault(path, []).append((indices, tuple(param.shape)))
    tree: dict = {}
    for path, items in stacks.items():
        shape = items[0][1]
        _set_leaf(tree, path, torch.Size((len(items),) + shape if items[0][0] else shape))
    return tree


def place_model(model: nn.Module, sharding: dict) -> nn.Module:
    """Replace each of ``model``'s parameters by a ``DTensor`` and return
    the model.  ``sharding`` is ``param_sharding(mesh, spec_tree(model),
    shapes_tree=shape_tree(model))``, the reference's ``jax.device_put``
    tree; a parameter takes its leaf's placements without the leading
    layer axis of a stacked leaf (which no rule splits).  Every rank holds
    the whole value (the same seeded ``init_model``), so each keeps the
    block of its mesh coordinate and nothing is sent
    (``src_data_rank=None``); the whole tensors are freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            path, indices = split_name(f"{mod_name}.{pname}" if mod_name else pname)
            node = sharding
            for key in path:
                node = node[key]
            if any(e is not None for e in node.spec[:len(indices)]):
                raise ValueError(f"{'/'.join(path)}: a rule splits the stacked layer axis")
            mesh = node.mesh
            placements = NamedSharding(mesh, node.spec[len(indices):]).placements
            dt = distribute_tensor(p.detach(), mesh, placements, src_data_rank=None)
            # a block split on its leading dimension is a view of the whole
            # tensor: a copy of its own lets the whole one go
            dt = DTensor.from_local(dt.to_local().clone(), mesh, dt.placements, run_check=False,
                                    shape=dt.shape, stride=dt.stride())
            setattr(mod, pname, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def from_reference(cfg: ArchConfig, tree: dict, *, device="cuda", dtype=torch.float32) -> LM:
    """The port's model on ``device`` holding the weights of ``tree`` (the
    reference's ``init_model`` values, layer leaves stacked on ``L``)."""
    dev = resolve_device(device)
    return copy_tree(LM(Init(None, dev, dtype), cfg), tree)
