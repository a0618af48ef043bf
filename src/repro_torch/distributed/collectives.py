"""Explicit collective patterns over a process group.

The port of ``repro.distributed.collectives``.  The reference's
``axis_name`` (a mesh axis inside ``shard_map``) becomes a process group
(``group=None``: the world group of the initialised ``torch.distributed``;
a ``DeviceMesh`` axis's is ``mesh.get_group("data")``), as
``optim.compress.compressed_psum`` takes it.

* :func:`flash_decode_combine` — distributed partial-softmax combine: each
  rank attends over its slice of a sequence-sharded KV cache and the
  (m, l, o) triples are merged with max/sum reductions — flash-decoding
  mapped onto collectives.
* :func:`pipeline_stage_step` — GPipe-style microbatch rotation around the
  group's ranks (rank i sends to i + 1 mod n).
* :func:`all_reduce_mean` — the data-parallel gradient average of the
  parameters a mesh replicates over its data axis, in a few large flat
  float32 buckets (one ``all_reduce`` a bucket, not one a tensor).

The training step on a ``("data", "model")`` mesh computes on each rank's
blocks of the parameters (``DTensor``s placed by
``models.convert.place_model``) with these differentiable collectives, the
ones GSPMD inserts for the reference:

* :func:`zero3_gather` — ZeRO-3: the forward all-gathers a weight's
  ``fsdp`` dimension over the data group, the backward reduce-scatters its
  gradient, averaged over the data ranks (each took its own block of the
  batch);
* :func:`copy_to_model` and :func:`reduce_from_model` — Megatron's pair
  over the model group: identity forward and ``all_reduce`` backward where
  a replicated activation enters split products, ``all_reduce`` forward
  and identity backward where their partial sums leave;
* :func:`gather_from_model` — all-gather over the model group, identity
  on each rank's slice backward: a weight a layer computes whole on every
  model rank, and an activation split on its features;
* :func:`gather_full` — a ``DTensor``'s whole value on every rank, for
  checkpoints and the reference's tree.

They call ``torch.distributed``'s own collectives, which ``gloo`` runs on
CUDA tensors as well (ranks sharing one card), and never ``DTensor``'s,
whose functional collectives a ``gloo`` group does not run on CUDA
tensors.  Each adds the bytes it moves to :data:`traffic`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import is_placed

__all__ = [
    "local_partial_attention",
    "flash_decode_combine",
    "pipeline_stage_step",
    "all_reduce_mean",
    "zero3_gather",
    "copy_to_model",
    "reduce_from_model",
    "gather_from_model",
    "gather_full",
    "max_over",
    "traffic",
]

# float32 elements a bucket (256 MiB): qwen2-0.5b's 290 parameter tensors take 7
BUCKET_NUMEL = 1 << 26


def local_partial_attention(q, k_shard, v_shard, valid):
    """Per-shard partial attention.

    q: [B, H, 1, hd]; k_shard/v_shard: [B, H, T_local, hd];
    valid: [B, T_local] bool.  Returns (m, l, o) partials; scores in
    float32, invalid keys at -1e30, as the reference.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhtd->bhqt", q, k_shard).float() * scale
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    m = s.amax(dim=-1)  # [B,H,1]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqt,bhtd->bhqd", p.to(q.dtype), v_shard)
    return m, l, o


def flash_decode_combine(m, l, o, group=None):
    """Merge per-rank (m, l, o) softmax partials over ``group``."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    l_g = l * corr
    dist.all_reduce(l_g, op=dist.ReduceOp.SUM, group=group)
    o_g = o * corr[..., None].to(o.dtype)
    dist.all_reduce(o_g, op=dist.ReduceOp.SUM, group=group)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None].to(o_g.dtype)


def pipeline_stage_step(fn, x, group=None):
    """One GPipe rotation: apply this stage's ``fn``, then shift the
    result to the next rank of ``group`` (ring: i sends to i + 1 mod n,
    by ``batch_isend_irecv``); returns what the previous rank sent."""
    y = fn(x).contiguous()
    n = dist.get_world_size(group)
    r = dist.get_rank(group)

    def peer(i):
        return i if group is None else dist.get_global_rank(group, i)

    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, peer((r + 1) % n), group),
           dist.P2POp(dist.irecv, out, peer((r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _buckets(tensors):
    """Runs of consecutive tensors of at most ``BUCKET_NUMEL`` elements in
    all (a larger tensor is a bucket of its own)."""
    start, n = 0, 0
    for i, t in enumerate(tensors):
        if i > start and n + t.numel() > BUCKET_NUMEL:
            yield tensors[start:i]
            start, n = i, 0
        n += t.numel()
    if start < len(tensors):
        yield tensors[start:]


def all_reduce_mean(tensors, group=None) -> list:
    """The mean over ``group``'s ranks of each tensor, summed in float32
    flat buckets and divided by the world size.  Float32 tensors are
    overwritten with their mean and returned; others come back as new
    float32 tensors.  Live memory above the inputs is one bucket."""
    world = dist.get_world_size(group)
    out = []
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= world
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            if t.dtype == torch.float32:
                out.append(t.copy_(v.view_as(t)))
            else:
                out.append(v.view_as(t).clone())
        del flat
    return out


# bytes each kind of collective moved (the whole tensor a rank ends with),
# and its calls; the step's exchange is read from here (zeroed by the caller)
traffic: dict = {}


def _count(kind: str, t: torch.Tensor) -> None:
    n, b = traffic.get(kind, (0, 0))
    traffic[kind] = (n + 1, b + t.numel() * t.element_size())


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_gather(x, dim: int, group):
    """Blocks of ``x`` from every rank of ``group``, concatenated on ``dim``
    in the group's rank order."""
    n = _size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(
        tuple(x.shape[:dim]) + (n * x.shape[dim],) + tuple(x.shape[dim + 1:]))


def _my_slice(x, dim: int, group):
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class _Zero3Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        out = _all_gather(x, dim, group)
        _count("zero3_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        n, dim = _size(ctx.group), ctx.dim
        blocks = torch.cat(g.float().chunk(n, dim=dim), dim=0).contiguous()
        _count("zero3_reduce_scatter", blocks)
        out = torch.empty((blocks.shape[0] // n,) + tuple(blocks.shape[1:]), dtype=blocks.dtype,
                          device=blocks.device)
        dist.reduce_scatter_tensor(out, blocks, group=ctx.group)
        return (out / n).to(g.dtype), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count("model_all_reduce", g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        _count("model_all_reduce", x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        out = _all_gather(x, dim, group)
        _count("model_all_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.dim, ctx.group), None, None


def zero3_gather(x, dim: int, group):
    """``x``'s blocks over ``group`` (the data group), concatenated on
    ``dim``; the backward reduce-scatters the gradient on ``dim`` and
    divides by the group's size (the mean over the data ranks).  The
    identity on a group of one."""
    return x if _size(group) == 1 else _Zero3Gather.apply(x, dim, group)


def copy_to_model(x, group):
    """Identity; the backward sums the gradient over ``group`` (the model
    group): where a replicated activation enters products split over it."""
    return x if _size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The sum of ``x`` over ``group`` (the model group); the backward
    passes the gradient on: the partial sums of products split over it."""
    return x if _size(group) == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim: int, group):
    """``x``'s blocks over ``group`` concatenated on ``dim``; the backward
    takes this rank's slice of the gradient, which every rank of the group
    holds whole (the gathered value is used alike on each)."""
    return x if _size(group) == 1 else _GatherFromModel.apply(x, dim, group)


@torch.no_grad()
def max_over(x, group):
    """The elementwise maximum of ``x`` over ``group`` (not differentiated)."""
    x = x.detach().contiguous().clone()
    if _size(group) > 1:
        _count("model_all_reduce", x)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


@torch.no_grad()
def gather_full(dt) -> torch.Tensor:
    """The whole value of a ``DTensor`` (evenly split, as ``param_sharding``
    places), gathered with ``torch.distributed``'s collectives over each
    mesh dimension that splits it, innermost first; a collective on every
    rank of its mesh.  A plain tensor is returned as it is."""
    if not is_placed(dt):
        return dt
    x, mesh = dt.to_local(), dt.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = dt.placements[i]
        if p.is_shard():
            x = _all_gather(x, p.dim, mesh.get_group(i))
    if tuple(x.shape) != tuple(dt.shape):
        raise ValueError(f"unevenly split DTensor: gathered {tuple(x.shape)}, "
                         f"global {tuple(dt.shape)}")
    return x
