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
* :func:`all_reduce_mean` — the port's data-parallel gradient average, in
  a few large flat float32 buckets (one ``all_reduce`` a bucket, not one a
  parameter tensor), and :func:`broadcast_tensors`, which starts every
  rank from rank 0's weights the same way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "local_partial_attention",
    "flash_decode_combine",
    "pipeline_stage_step",
    "all_reduce_mean",
    "broadcast_tensors",
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


@torch.no_grad()
def broadcast_tensors(tensors, src: int = 0, group=None) -> None:
    """Overwrite each tensor with global rank ``src``'s, in flat buckets
    of one dtype (a bucket keeps the tensors' bits)."""
    tensors = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        for bucket in _buckets(same):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src=src, group=group)
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view_as(t))
