"""The workflows a configuration names, as explicit lineage pairs.

A workflow is a chain of numpy operations given by name and arguments in
the configuration's file; its data (the values ``sort`` orders, the keys a
``merge`` joins on) come from the generator passed in, so one seed gives
one set of relations.  The shapes never depend on the seed, except the row
count of a join's output, which follows its keys.
"""

from __future__ import annotations

import numpy as np

from . import lineage as L

# element-wise numpy operations: each output cell depends on its own input cell
IDENTITY_OPS = frozenset({"negative", "exp", "clip", "dropna", "add", "maximum"})


def _op(name: str, args: dict, shape: tuple, rng: np.random.Generator) -> L.Rel:
    if name in IDENTITY_OPS:
        return L.identity(shape)
    if name == "getitem":
        return L.strided_slice(shape, args["starts"], args["stops"], args["steps"])
    if name == "transpose":
        return L.transpose(shape, args.get("axes") or tuple(reversed(range(len(shape)))))
    if name == "flip":
        return L.flip(shape, args["axis"])
    if name == "roll":
        return L.roll(shape, args["shift"], args["axis"])
    if name == "reshape":
        return L.reshape(shape, (int(np.prod(shape)),))
    if name == "sort":
        return L.sort(rng.random(shape), axis=args["axis"])
    if name == "sum":
        return L.reduce(shape, args["axis"])
    if name == "correlate2d":
        return L.conv2d(shape[0], shape[1], *args["kernel"])
    if name == "merge":
        n = shape[0]
        left = rng.integers(0, args["key_range"], n)
        right = rng.integers(0, args["key_range"], args["right_rows"])
        return L.inner_join(left, right, shape[1], args["right_cols"])
    raise ValueError(f"unknown operation {name!r}")


def build_workflow(spec: dict, rng: np.random.Generator) -> list[tuple[str, dict, L.Rel]]:
    """``[(op name, op arguments, relation)]`` of one workflow instance."""
    shape = tuple(spec["input"])
    ops = []
    for name, args in spec["ops"]:
        rel = _op(name, args, shape, rng)
        ops.append((name, args, rel))
        shape = rel.out_shape
    return ops


def instance_rng(seed: int, instance: int) -> np.random.Generator:
    """The generator of one workflow instance: its data depend on the run's
    seed and the instance's number alone, so the reference rebuilds any
    instance without replaying the others."""
    return np.random.default_rng([seed, instance])

