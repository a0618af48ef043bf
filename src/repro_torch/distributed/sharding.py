"""Logical-axis → mesh-axis sharding rules (DP/FSDP/TP/EP/SP).

The port of ``repro.distributed.sharding``.  Parameters carry logical
specs like ``("fsdp", "tp")`` (each module's ``specs``;
``models.convert.spec_tree`` gathers the reference's tree); this module
resolves them against a mesh (``launch.mesh``, a ``DeviceMesh``):

* ``fsdp`` → the ``data`` axis (ZeRO-3 parameter sharding within a pod)
* ``tp``   → the ``model`` axis (tensor parallelism)
* batch    → ``("pod", "data")`` when the mesh has a pod axis (pure DP
  across pods — the slow inter-pod links carry only gradient reductions)

Rules are data, not code, so they can be swapped per architecture.

The port has no ``PartitionSpec``: a :class:`NamedSharding`'s ``spec`` is
the tuple of mesh axes of each tensor dimension (``None``, an axis name,
or a tuple of names), entry for entry the reference's ``PartitionSpec``
(which keeps a one-axis tuple as the name), and its ``placements`` are
the ``DTensor`` placements, one a mesh dimension.  A dimension split over
several mesh axes becomes one ``Shard(d)`` on each, which ``DTensor``
applies in mesh order, so the axes of such an entry must be in mesh order
(JAX's blocks for the same mesh coordinates; every spec the rules here
make is).

``hint(x, kind)`` is the identity without an activated mesh, and for a
plain tensor under one.  A ``DTensor`` under an activated mesh is
redistributed to the placements of the reference's spec for that kind
and shape (``hint_spec``).  ``DTensor`` splits a dimension that its axes
do not divide as ``torch.chunk`` does, into the blocks JAX pads to
(``attn_heads="tp_uneven"``).

``local_tensor`` and ``local_block`` read a ``DTensor``'s block on this
rank (``models.convert.place_model`` lays a model's parameters on a mesh
with ``param_sharding``'s placements).
"""

from __future__ import annotations

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "NamedSharding",
    "default_rules",
    "param_sharding",
    "batch_sharding",
    "cache_sharding",
    "logical_to_spec",
    "set_activation_mesh",
    "hint",
    "hint_spec",
    "is_placed",
    "local_tensor",
    "local_block",
]


class AxisRules(dict):
    """logical axis name -> mesh axis (str | tuple | None)."""


def _mesh_shape(mesh) -> dict:
    """Axis name → size of a ``DeviceMesh`` (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is
    the axis name, an empty one ``None``."""
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


class NamedSharding:
    """How a tensor lies on ``mesh``: ``spec`` gives each dimension's mesh
    axes, as the reference's ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(_entry(e) for e in spec)

    @property
    def placements(self) -> tuple:
        """One ``Shard(d)`` or ``Replicate()`` a mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise NotImplementedError(
                    f"dimension {d} is split over {axes}, not in the mesh's order {names}"
                )
            for i in pos:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]} splits two dimensions of {self.spec}")
                out[i] = Shard(d)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec}, mesh={tuple(self.mesh.mesh_dim_names)})"


def default_rules(mesh) -> AxisRules:
    has_pod = "pod" in mesh.mesh_dim_names
    return AxisRules(
        fsdp="data",
        tp="model",
        dp=("pod", "data") if has_pod else ("data",),
        sp="data",  # sequence sharding for long-context caches
    )


DEFAULT_RULES = default_rules


def logical_to_spec(logical: tuple, rules: AxisRules) -> tuple:
    return tuple(rules.get(ax) if ax is not None else None for ax in logical)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else len(x.shape)


def _map(fn, tree, *rest, is_leaf=lambda x: False, path=()):
    """``fn(path, leaf, *parallel leaves)`` over the dicts and lists of
    ``tree``; ``rest`` are trees with the same keys."""
    if not is_leaf(tree) and isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf, path=path + (k,))
                for k, v in tree.items()}
    if not is_leaf(tree) and isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf, path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


# --------------------------------------------------------------------------- #
# Activation sharding hints
# --------------------------------------------------------------------------- #
# The model code calls ``hint(x, kind)`` at the layout decision points of the
# reference; a launcher activates a mesh here.  Outside an activated mesh the
# hints are no-ops, so unit tests and the single-process trainer run unchanged.

_ACT: dict | None = None


def set_activation_mesh(mesh, rules: AxisRules | None = None, policy: dict | None = None):
    """Enable (or with ``None`` disable) activation sharding hints.

    ``policy`` tunes the strategy per tensor kind:
      attn_heads: "auto" (TP when divisible, else sequence-parallel) |
                  "tp_uneven" (TP with uneven blocks for 14/25/40-head
                  configs) | "seq" | "batch_only"
    """
    global _ACT
    if mesh is None:
        _ACT = None
        return
    rules = rules or default_rules(mesh)
    _ACT = {
        "mesh": mesh,
        "dp": rules["dp"],
        "model_size": _mesh_shape(mesh)["model"],
        "policy": dict(policy or {}),
    }


def hint_spec(shape, kind: str) -> tuple:
    """The reference's spec for a ``kind`` tensor of ``shape`` under the
    activated mesh (``hint``'s layout), entries as ``PartitionSpec`` keeps
    them.

    kinds:
      hidden   [B, S, D]        -> (dp, None, None)
      heads    [B, S, H, hd]    -> heads on model when divisible, else
                                   sequence-parallel (dp, model, None, None)
      ffn      [B, S, F]        -> (dp, None, model)
      logits   [B, S, V]        -> (dp, None, model)
      experts  [E, B, C, D]     -> (None, dp, None, None)
      bhst     [B, H, S, T]     -> scores: H on model when divisible
    """
    if _ACT is None:
        raise RuntimeError("no activation mesh: call set_activation_mesh first")
    shape = tuple(shape)
    dp, ms = _ACT["dp"], _ACT["model_size"]
    heads_mode = _ACT["policy"].get("attn_heads", "auto")
    b_ok = shape[0] > 1
    dpx = dp if b_ok else None
    if kind == "hidden":
        spec = (dpx, *([None] * (len(shape) - 1)))
    elif kind == "heads":
        tp_ok = shape[2] % ms == 0 or (heads_mode == "tp_uneven" and shape[2] >= ms)
        seq_ok = shape[1] % ms == 0 and shape[1] > 1
        if heads_mode == "batch_only":
            spec = (dpx, None, None, None)
        elif heads_mode == "seq" and seq_ok:
            spec = (dpx, "model", None, None)
        elif tp_ok:
            spec = (dpx, None, "model", None)
        elif seq_ok:
            spec = (dpx, "model", None, None)
        else:
            spec = (dpx, None, None, None)
    elif kind == "bhst":
        tp_ok = shape[1] % ms == 0 or (heads_mode == "tp_uneven" and shape[1] >= ms)
        seq_ok = shape[2] % ms == 0 and shape[2] > 1
        if heads_mode == "batch_only":
            spec = (dpx, None, None, None)
        elif heads_mode == "seq" and seq_ok:
            spec = (dpx, None, "model", None)
        elif tp_ok:
            spec = (dpx, "model", None, None)
        elif seq_ok:
            spec = (dpx, None, "model", None)
        else:
            spec = (dpx, None, None, None)
    elif kind in ("ffn", "logits"):
        spec = (dpx, None, "model" if shape[-1] % ms == 0 else None)
    elif kind == "experts":
        spec = (None, dp if shape[1] > 1 else None, None, None)
    else:
        raise ValueError(kind)
    return tuple(_entry(e) for e in spec)


def hint(x, kind: str):
    """Apply an activation sharding constraint (see the module doc)."""
    if _ACT is None:
        return x
    spec = hint_spec(x.shape, kind)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = _ACT["mesh"]
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


# --------------------------------------------------------------------------- #
# Parameter, batch and cache shardings
# --------------------------------------------------------------------------- #
def param_sharding(mesh, spec_tree, rules: AxisRules | None = None, shapes_tree=None):
    """Tree of :class:`NamedSharding` from a tree of logical spec tuples.

    With ``shapes_tree`` (a parallel tree of tensors, arrays or shapes),
    mesh axes are dropped from dimensions they do not divide — e.g. a
    50280-row vocab table cannot split 16 ways, so its ``tp`` axis is
    demoted to replication (exact configs keep their odd vocab sizes).
    """
    rules = rules or default_rules(mesh)
    sizes = _mesh_shape(mesh)

    def axes_size(ax) -> int:
        if ax is None:
            return 1
        n = 1
        for a in ax if isinstance(ax, tuple) else (ax,):
            n *= sizes[a]
        return n

    def resolve(_, t, shape=None):
        spec = list(logical_to_spec(t, rules))
        if shape is not None:
            dims = shape.shape if hasattr(shape, "shape") else shape
            for i, ax in enumerate(spec):
                if ax is not None and dims[i] % axes_size(ax) != 0:
                    spec[i] = None
        return NamedSharding(mesh, spec)

    if shapes_tree is None:
        return _map(resolve, spec_tree, is_leaf=_is_spec)
    return _map(resolve, spec_tree, shapes_tree, is_leaf=_is_spec)


def batch_sharding(mesh, batch_like, rules: AxisRules | None = None):
    """Shard every batch leaf on its leading (batch) dim over the DP axes."""
    dp = (rules or default_rules(mesh))["dp"]
    return _map(lambda _, x: NamedSharding(mesh, (dp, *([None] * (_ndim(x) - 1)))),
                batch_like)


def cache_sharding(mesh, cache_like, n_kv_heads: int, batch: int,
                   rules: AxisRules | None = None):
    """Decode-cache shardings.

    KV tensors are [L, B, T, Kv, hd]:
      * B over DP axes when it divides;
      * Kv over ``model`` when it divides, else T over ``model``
        (sequence-parallel cache — the long_500k path);
      * when B == 1 (long-context), T additionally over the DP axes.
    SSM states are [L, B, H, N, P]: B over DP, H over model when divisible.
    """
    rules = rules or default_rules(mesh)
    sizes = _mesh_shape(mesh)
    model_size = sizes["model"]
    dp_axes = rules["dp"]
    dp_size = 1
    for a in dp_axes:
        dp_size *= sizes[a]

    def spec_for_path(path, x):
        name = str(path[-1])
        nd = _ndim(x)
        b_ax = dp_axes if batch % dp_size == 0 and batch > 1 else None
        if name in ("k", "v"):
            if n_kv_heads % model_size == 0:
                spec = (None, b_ax, None, "model", None)
            elif batch == 1:
                spec = (None, None, (*dp_axes, "model"), None, None)
            else:
                spec = (None, b_ax, "model", None, None)
            return NamedSharding(mesh, spec)
        if name == "ssm" and nd == 5:
            h_ax = "model" if x.shape[2] % model_size == 0 else None
            return NamedSharding(mesh, (None, b_ax, h_ax, None, None))
        if name == "conv" and nd == 4:
            c_ax = "model" if x.shape[3] % model_size == 0 else None
            return NamedSharding(mesh, (None, b_ax, None, c_ax))
        return NamedSharding(mesh, (None,) * nd)

    return _map(spec_for_path, cache_like)


def is_placed(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (laid on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t):
    """This rank's block of a ``DTensor`` (outside autograd, its own
    storage: writing it writes the ``DTensor``); a plain tensor itself."""
    return t.to_local() if is_placed(t) else t


def local_block(dt, full):
    """The slice of ``full`` (the whole value, a tensor or array) that
    ``dt``'s placements give this rank's mesh coordinate."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if tuple(full.shape) != tuple(dt.shape):
        raise ValueError(f"whole value {tuple(full.shape)} for a DTensor of {tuple(dt.shape)}")
    shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                          dt.placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
