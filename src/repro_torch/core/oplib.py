"""Registry of numpy array operations with lineage adapters.

The port of ``repro.core.oplib``: the same ops, categories and lineage (the
adapters run on the port's :mod:`~repro_torch.core.capture`).  The paper's Table IX evaluates ProvRC compression + automatic reuse over 136
numpy API operations (element-wise vs "complex").  This registry is the
offline analog: every entry knows how to produce its fine-grained lineage
for a given input shape, whether that lineage is value-dependent, and which
family it belongs to.  The integration facade ``repro_torch.lineage``
re-exports these adapters (alongside DSLog, the lineage graph, and the
planner) as the single import surface for logging pipeline/model ops into
DSLog.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import capture as C
from .relation import LineageRelation

__all__ = ["OpSpec", "OPS", "get_op", "op_names"]


@dataclass(frozen=True)
class OpSpec:
    name: str
    category: str  # "element" | "complex"
    value_dependent: bool
    # lineage(shape, rng) -> {(out_pos, in_pos): LineageRelation}
    lineage: Callable[[tuple[int, ...], np.random.Generator], dict]
    # two+ distinct input shapes for reuse confirmation sweeps
    shapes: tuple[tuple[int, ...], ...] = ((8, 6), (5, 9))
    # True when the lineage pattern itself changes with shape — the paper's
    # `cross` case, which gen_sig reuse must NOT cover (misprediction risk).
    shape_pattern_dependent: bool = False


def _unary(shape, rng):
    return {(0, 0): C.identity_lineage(shape)}


def _binary_same(shape, rng):
    return {(0, 0): C.identity_lineage(shape), (0, 1): C.identity_lineage(shape)}


def _binary_broadcast(shape, rng):
    # second operand is a broadcast row vector
    vec = (shape[-1],)
    return {
        (0, 0): C.identity_lineage(shape),
        (0, 1): C.broadcast_lineage(vec, shape),
    }


def _reduce_all(shape, rng):
    return {(0, 0): C.reduce_lineage(shape, tuple(range(len(shape))))}


def _reduce_ax(ax):
    def f(shape, rng):
        return {(0, 0): C.reduce_lineage(shape, ax % len(shape))}

    return f


def _softmax(shape, rng):
    return {(0, 0): C.softmax_lineage(shape, -1)}


def _cumulative(shape, rng):
    n = int(np.prod(shape))
    return {(0, 0): _lift_flat(C.cumulative_lineage(n), shape)}


def _lift_flat(rel_flat: LineageRelation, shape) -> LineageRelation:
    """cumsum over the flattened array (numpy default axis=None view)."""
    n = int(np.prod(shape))
    return LineageRelation((n,), (n,), rel_flat.out_idx, rel_flat.in_idx)


def _matmul(shape, rng):
    m, k = shape
    n = k + 2
    ra, rb = C.matmul_lineage(m, k, n)
    return {(0, 0): ra, (0, 1): rb}


def _outer(shape, rng):
    m = shape[0]
    n = shape[-1] + 1
    ra, rb = C.outer_lineage(m, n)
    return {(0, 0): ra, (0, 1): rb}


def _transpose(shape, rng):
    perm = tuple(reversed(range(len(shape))))
    return {(0, 0): C.transpose_lineage(shape, perm)}


def _reshape(shape, rng):
    n = int(np.prod(shape))
    return {(0, 0): C.reshape_lineage(shape, (n,))}


def _expand(shape, rng):
    return {(0, 0): C.reshape_lineage(shape, (1,) + tuple(shape))}


def _slice_half(shape, rng):
    stops = tuple(max(1, d // 2) for d in shape)
    return {(0, 0): C.slice_lineage(shape, (0,) * len(shape), stops)}


def _strided(shape, rng):
    return {
        (0, 0): C.slice_lineage(
            shape, (0,) * len(shape), shape, (2,) + (1,) * (len(shape) - 1)
        )
    }


def _concat(shape, rng):
    rels = C.concat_lineage([shape, shape], 0)
    return {(0, 0): rels[0], (0, 1): rels[1]}


def _stack(shape, rng):
    # stack = new leading axis; operand s lands in slot s of axis 0
    out_shape = (2,) + tuple(shape)
    idx = C.all_indices(shape)
    rels = {}
    for s in range(2):
        out = np.concatenate([np.full((idx.shape[0], 1), s, np.int64), idx], axis=1)
        rels[(0, s)] = LineageRelation(out_shape, shape, out, idx)
    return rels


def _tile(shape, rng):
    return {(0, 0): C.tile_lineage(shape, (2,) * len(shape))}


def _repeat(shape, rng):
    return {(0, 0): C.repeat_lineage(shape, 3, 0)}


def _roll(shape, rng):
    return {(0, 0): C.roll_lineage(shape, 2, 0)}


def _flip(shape, rng):
    return {(0, 0): C.flip_lineage(shape, 0)}


def _pad(shape, rng):
    return {(0, 0): C.pad_lineage(shape, [(1, 1)] * len(shape))}


def _diag(shape, rng):
    n = min(shape)
    out = np.arange(n, dtype=np.int64)[:, None]
    inn = np.stack([np.arange(n), np.arange(n)], axis=1).astype(np.int64)
    return {(0, 0): LineageRelation((n,), (shape[0], shape[1]), out, inn)}


def _triu(shape, rng):
    h, w = shape
    i, j = np.triu_indices(h, m=w)
    idx = np.stack([i, j], axis=1).astype(np.int64)
    return {(0, 0): LineageRelation(shape, shape, idx, idx)}


def _tril(shape, rng):
    h, w = shape
    i, j = np.tril_indices(h, m=w)
    idx = np.stack([i, j], axis=1).astype(np.int64)
    return {(0, 0): LineageRelation(shape, shape, idx, idx)}


def _trace(shape, rng):
    n = min(shape)
    inn = np.stack([np.arange(n), np.arange(n)], axis=1).astype(np.int64)
    out = np.zeros((n, 1), np.int64)
    return {(0, 0): LineageRelation((1,), shape, out, inn)}


def _convolve(shape, rng):
    n = int(np.prod(shape))
    k = 3
    rel = C.conv1d_lineage(n, k)
    # kernel operand lineage: out[i] <- w[d] for all d
    grid = C.all_indices((n - k + 1, k))
    rel_w = LineageRelation((n - k + 1,), (k,), grid[:, :1], grid[:, 1:])
    return {(0, 0): rel, (0, 1): rel_w}


def _sort(shape, rng):
    vals = rng.random(shape)
    return {(0, 0): C.sort_lineage(vals, axis=-1)}


def _take(shape, rng):
    idx = rng.integers(0, shape[0], size=shape[0] // 2 + 1)
    return {(0, 0): C.take_lineage(shape, idx, 0)}


def _where(shape, rng):
    # out = where(cond, x, y): elementwise from both branches
    return {(0, 0): C.identity_lineage(shape), (0, 1): C.identity_lineage(shape)}


def _kron(shape, rng):
    h, w = shape
    # kron with a 2x2 block: out[(i,p),(j,q)] <- a[i,j] (and b[p,q])
    out_shape = (2 * h, 2 * w)
    oidx = C.all_indices(out_shape)
    a_idx = np.stack([oidx[:, 0] // 2, oidx[:, 1] // 2], axis=1)
    b_idx = np.stack([oidx[:, 0] % 2, oidx[:, 1] % 2], axis=1)
    return {
        (0, 0): LineageRelation(out_shape, shape, oidx, a_idx),
        (0, 1): LineageRelation(out_shape, (2, 2), oidx, b_idx),
    }


def _cross(shape, rng):
    """np.cross over arrays of vectors — the paper's misprediction case.

    For 3-vectors each output component reads the two *other* components of
    both operands; for 2-vectors the output is a scalar reading both
    components.  The lineage pattern changes with the trailing dim, so a
    gen_sig generalized over one trailing size extrapolates wrongly.
    """
    n, d = shape
    rows_o, rows_a = [], []
    if d == 3:
        for c in range(3):
            for oth in [(c + 1) % 3, (c + 2) % 3]:
                rows_o.append((c, oth))
        out_shape = (n, 3)
    else:  # d == 2 -> scalar per vector pair
        rows_o = [(0, 0), (0, 1)]
        out_shape = (n, 1)
    o_list, a_list = [], []
    for r in range(n):
        for oc, ac in rows_o:
            o_list.append((r, oc))
            a_list.append((r, ac))
    o = np.array(o_list, np.int64)
    a = np.array(a_list, np.int64)
    rel = LineageRelation(out_shape, shape, o, a)
    return {(0, 0): rel, (0, 1): rel}


_E = "element"
_X = "complex"

_ELEMENTWISE_UNARY = [
    "negative", "abs", "exp", "log", "log1p", "expm1", "sqrt", "square",
    "reciprocal", "sign", "floor", "ceil", "round", "rint", "trunc",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "exp2", "log2", "log10",
    "cbrt", "fabs", "positive", "rad2deg", "deg2rad", "sigmoid", "relu",
    "gelu", "silu", "softplus", "erf", "rsqrt", "logit", "clip",
    "nan_to_num", "isfinite_mask", "dropout_mask_apply", "scale", "shift",
    "normalize_affine",
]

_ELEMENTWISE_BINARY = [
    "add", "subtract", "multiply", "true_divide", "power", "maximum",
    "minimum", "fmod", "arctan2", "hypot", "logaddexp", "copysign",
    "heaviside", "nextafter", "remainder",
]

_BROADCAST_BINARY = [
    "add_rowvec", "mul_rowvec", "sub_rowvec", "div_rowvec",
    "bias_add", "scale_cols",
]


def _mk_ops() -> dict[str, OpSpec]:
    ops: dict[str, OpSpec] = {}
    for nm in _ELEMENTWISE_UNARY:
        ops[nm] = OpSpec(nm, _E, False, _unary)
    for nm in _ELEMENTWISE_BINARY:
        ops[nm] = OpSpec(nm, _E, False, _binary_same)
    for nm in _BROADCAST_BINARY:
        ops[nm] = OpSpec(nm, _E, False, _binary_broadcast)
    complex_ops = {
        "sum": OpSpec("sum", _X, False, _reduce_all),
        "mean": OpSpec("mean", _X, False, _reduce_all),
        "prod": OpSpec("prod", _X, False, _reduce_all),
        "max": OpSpec("max", _X, False, _reduce_all),
        "min": OpSpec("min", _X, False, _reduce_all),
        "std": OpSpec("std", _X, False, _reduce_all),
        "var": OpSpec("var", _X, False, _reduce_all),
        "sum_axis0": OpSpec("sum_axis0", _X, False, _reduce_ax(0)),
        "sum_axis1": OpSpec("sum_axis1", _X, False, _reduce_ax(1)),
        "mean_axis0": OpSpec("mean_axis0", _X, False, _reduce_ax(0)),
        "max_axis1": OpSpec("max_axis1", _X, False, _reduce_ax(1)),
        "softmax": OpSpec("softmax", _X, False, _softmax),
        "log_softmax": OpSpec("log_softmax", _X, False, _softmax),
        "cumsum": OpSpec("cumsum", _X, False, _cumulative),
        "cumprod": OpSpec("cumprod", _X, False, _cumulative),
        "matmul": OpSpec("matmul", _X, False, _matmul),
        "dot": OpSpec("dot", _X, False, _matmul),
        "outer": OpSpec("outer", _X, False, _outer),
        "transpose": OpSpec("transpose", _X, False, _transpose),
        "swapaxes": OpSpec("swapaxes", _X, False, _transpose),
        "reshape": OpSpec("reshape", _X, False, _reshape),
        "ravel": OpSpec("ravel", _X, False, _reshape),
        "flatten": OpSpec("flatten", _X, False, _reshape),
        "expand_dims": OpSpec("expand_dims", _X, False, _expand),
        "atleast_3d": OpSpec("atleast_3d", _X, False, _expand),
        "slice_half": OpSpec("slice_half", _X, False, _slice_half),
        "strided_slice": OpSpec("strided_slice", _X, False, _strided),
        "concatenate": OpSpec("concatenate", _X, False, _concat),
        "vstack": OpSpec("vstack", _X, False, _concat),
        "hstack": OpSpec(
            "hstack", _X, False,
            lambda shape, rng: {
                (0, i): r for i, r in enumerate(C.concat_lineage([shape, shape], -1))
            },
        ),
        "stack": OpSpec("stack", _X, False, _stack),
        "tile": OpSpec("tile", _X, False, _tile),
        "repeat": OpSpec("repeat", _X, False, _repeat),
        "roll": OpSpec("roll", _X, False, _roll),
        "flip": OpSpec("flip", _X, False, _flip),
        "flipud": OpSpec("flipud", _X, False, _flip),
        "fliplr": OpSpec(
            "fliplr", _X, False, lambda shape, rng: {(0, 0): C.flip_lineage(shape, 1)}
        ),
        "rot90": OpSpec(
            "rot90", _X, False,
            lambda shape, rng: {
                (0, 0): C.transpose_lineage(shape, (1, 0))
            },
        ),
        "pad": OpSpec("pad", _X, False, _pad),
        "broadcast_to": OpSpec(
            "broadcast_to", _X, False,
            lambda shape, rng: {(0, 0): C.broadcast_lineage(shape, (3,) + tuple(shape))},
        ),
        "diag": OpSpec("diag", _X, False, _diag),
        "triu": OpSpec("triu", _X, False, _triu),
        "tril": OpSpec("tril", _X, False, _tril),
        "trace": OpSpec("trace", _X, False, _trace),
        "convolve": OpSpec("convolve", _X, False, _convolve),
        "correlate": OpSpec("correlate", _X, False, _convolve),
        "kron": OpSpec("kron", _X, False, _kron),
        "sort": OpSpec("sort", _X, True, _sort),
        "argsort_gather": OpSpec("argsort_gather", _X, True, _sort),
        "take": OpSpec("take", _X, True, _take),
        "where": OpSpec("where", _E, False, _where),
        "cross": OpSpec(
            "cross", _X, False, _cross,
            shapes=((6, 3), (9, 3), (7, 2)),
            shape_pattern_dependent=True,
        ),
    }
    ops.update(complex_ops)
    return ops


OPS: dict[str, OpSpec] = _mk_ops()


def get_op(name: str) -> OpSpec:
    return OPS[name]


def op_names() -> list[str]:
    return sorted(OPS)
