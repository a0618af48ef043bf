"""Multi-pod dry run: the port of ``repro.launch.dryrun``.

For every (architecture × input shape) cell this runs the port's own step
— ``make_train_step`` (forward, backward and the AdamW update) for
``train_*`` shapes, ``make_prefill_step``/``make_decode_step`` for the
others — once, in eager mode, as rank 0 of the production mesh: 16x16 (256
ranks) or 2x16x16 (512 ranks), or a mesh named with ``--mesh``.  No card
and no memory is needed for that: the process group is a **fake** one
(``torch.distributed``'s ``fake`` backend on a ``FakeStore``, rank 0 of
``world`` ranks: its collectives return at once and move nothing) and
every tensor is a fake tensor (``FakeTensorMode`` on ``--device``'s type:
shapes, dtypes and devices, no storage).  The dry run never starts inside
a process that already has a group (``fake_group`` raises): run it as its
own process::

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes --device cuda
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --device cpu

Rank 0 holds the blocks of the parameters, AdamW moments and caches that
``param_sharding``/``cache_sharding`` give its mesh coordinate, and its
data coordinate's block of the batch; the step computes on them with the
collectives a real rank issues.  The record of a cell
(``experiments/dryrun_torch/<mesh_tag>/<arch>__<shape>.json``) has the
reference's keys; those that mean something else than XLA's:

* ``state_bytes_per_device`` — rank 0's held bytes of parameters plus
  AdamW state (train) or plus caches (decode): the reference's
  ``_sharded_bytes`` of the same trees and shardings;
  ``state_parts_bytes`` splits it (and gives a train step's gradient
  blocks, placed as their parameters).
* ``cost_analysis`` — ``flops``: ``torch.utils.flop_counter``'s count of
  the step's products (every layer: eager mode runs them all, where XLA
  counts a ``scan`` body once); ``bytes accessed``: the sum over the
  step's aten ops (views and those that touch no element excepted) of
  their input and output bytes,
  unfused, so an upper bound on what a fused program reads and writes;
  ``transcendentals``: the output elements of the ops that evaluate exp,
  log, tanh, sigmoid, sqrt/rsqrt, sin/cos or erf.
* ``cost_accounted``/``collectives`` — ``account_cell``'s extrapolation
  ``c1 + (L - 1)(c2 - c1)`` from 1- and 2-layer runs, kept from the
  reference; eager mode counts every layer, so it equals
  ``cost_analysis``/``collectives_scan_program`` (the tests hold it so).
* ``collectives_scan_program`` — rank 0's collectives a step
  (``collectives.traffic``, which counts each call and the bytes of the
  tensor a rank ends with) under the HLO kinds ``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``; ``traffic`` keeps the port's own kinds.  There
  is no HLO, so ``parse_collectives`` is not ported and ``hlo_bytes`` is
  null.
* ``memory_analysis`` — ``argument_size_in_bytes``: rank 0's parameters,
  moments, caches and batch block; ``output_size_in_bytes``: the tensors
  the step returns, each storage once (a train step returns the
  parameters and moments it updated in place, as the reference's donated
  outputs); ``temp_size_in_bytes``: the peak of live bytes during the
  step less the arguments; ``peak_bytes``: that peak.  Live bytes are
  those of every storage an op makes during the step, from its creation
  to its release, each rounded up to the CUDA caching allocator's 512
  bytes (``LiveBytes``); there is no ``generated_code_size_in_bytes``.
* ``lower_s`` — the seconds to build rank 0's placed state; ``compile_s``
  — the seconds of the fake step.
* ``fits`` — ``peak_bytes`` within the card's memory
  (``torch.cuda.get_device_properties``), null on ``--device cpu``;
  ``card`` the card's name and power limit (``nvidia-smi``).

``cur_len`` of a decode step is ``seq_len - 1`` (a full cache).  The
``--attn-heads`` policy (``auto``, the default, ``seq``, ``batch_only`` or
``tp_uneven``) changes the program as in the reference: the run activates
it with the mesh (``set_activation_mesh``), and each placed attention
layer of a train or prefill step splits by heads, by sequence or not at
all as the reference's ``hint(x, "heads")`` decides under it
(``models.attention.attention_split``; a decode step's split follows the
placement alone, as the reference's decode has no head hint).  The record
keeps the policy in ``overrides`` and each layer's split in
``attn_split``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, SHAPES, get_arch, skip_reason
from ..configs.base import ShapeConfig, smoke_shape
from ..distributed import collectives as col
from ..distributed.sharding import (batch_sharding, block_of, cache_sharding, default_rules,
                                    is_placed, param_sharding, placed_zeros,
                                    set_activation_mesh)
from ..models.blocks import cache_shapes
from ..models.convert import place_model, shape_tree
from ..models.model import attention_splits
from ..optim.adamw import AdamWConfig
from .mesh import make_mesh, make_production_mesh
from .steps import (abstract_caches, abstract_model, abstract_opt_state, attn_plan, input_specs,
                    make_decode_step, make_prefill_step, make_train_step)

__all__ = ["fake_group", "LiveBytes", "account_cell", "lower_cell", "run", "main"]

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# collectives.traffic's kinds under the HLO kind of the collective each is
_HLO_KIND = {
    "zero3_gather": "all-gather",
    "model_all_gather": "all-gather",
    "zero3_reduce_scatter": "reduce-scatter",
    "model_reduce_scatter": "reduce-scatter",
    "model_all_reduce": "all-reduce",
    "dp_mean_all_reduce": "all-reduce",
    "norm_all_reduce": "all-reduce",
    "seq_all_reduce": "all-reduce",
}
# aten ops whose output elements each take a transcendental evaluation
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "rsqrt",
    "sqrt", "sin", "cos", "erf", "erfc", "silu", "gelu", "softplus", "_softmax",
    "_log_softmax", "silu_backward", "gelu_backward", "softplus_backward", "tanh_backward",
    "sigmoid_backward", "_log_softmax_backward_data",
}
# aten ops that read and write no element
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}
# the CUDA caching allocator rounds every block up to this many bytes
_BLOCK = 512
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks with this process as rank 0
    (module doc); raises in a process that already has a group."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: run it in a "
                           "process that has none")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t):
    """A ``DTensor``'s block (its ``_local_tensor``: ``to_local`` would be an
    autograd op on every count), a plain tensor itself."""
    return t._local_tensor if is_placed(t) else t


def _storage_bytes(tensors) -> int:
    """The bytes of the storages of ``tensors`` (a ``DTensor``'s block),
    each storage once."""
    seen, total = set(), 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class LiveBytes(TorchDispatchMode):
    """Counts what a step's aten ops make and touch: the live bytes of the
    storages they make (each rounded up to ``_BLOCK``, from its creation
    to its release) and their peak, the bytes each op reads and writes
    (views excepted), and the transcendental output elements.  The
    storages of ``held`` (the step's arguments, counted apart) are never
    counted, also when an op returns a view of one or writes one in
    place."""

    def __init__(self, held=()):
        super().__init__()
        self.live = self.peak = self.accessed = self.transcendentals = 0
        self._keys = {_local(t).untyped_storage()._cdata for t in held}

    def _free(self, key, n) -> None:
        self._keys.discard(key)
        self.live -= n

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [_local(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.namespace != "prim" and not func.is_view and \
                func.overloadpacket.__name__ not in _NO_DATA:
            ins = [_local(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        if func.overloadpacket.__name__ in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def _hlo_collectives(traffic: dict) -> dict:
    """``collectives.traffic`` under the HLO kinds, with ``total_bytes``."""
    out = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, (n, b) in traffic.items():
        out[_HLO_KIND[kind]]["count"] += n
        out[_HLO_KIND[kind]]["bytes"] += b
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _block(x, sharding, device):
    """Zeros of rank 0's block of the batch tensor ``x`` (a meta tensor)."""
    shape, _ = block_of(x.shape, sharding.mesh, sharding.placements)
    return torch.zeros(shape, dtype=x.dtype, device=device)


def _abstract(cfg, mesh, rules, dtype):
    """``cfg``'s model on the ``meta`` device and its parameters' shardings
    (made outside the fake mode: ``meta`` ops are cheap)."""
    model, specs = abstract_model(cfg, dtype)
    return model, param_sharding(mesh, specs, rules, shape_tree(model))


def _build(model, sharding, cfg, shape, mesh, rules, plan, device, cache_dtype, on_micro=None):
    """Rank 0's placed state for ``cfg`` on ``mesh`` (under the caller's
    ``FakeTensorMode``): ``({part: state tensors}, batch block, step call,
    params)``, the parts ``params``, ``moments`` and ``opt_step`` (train) or
    ``caches`` (decode)."""
    from ..distributed.sharding import NamedSharding

    place_model(model, sharding, device)
    params = list(model.parameters())
    batch = input_specs(cfg, shape)
    b_shard = batch_sharding(mesh, batch, rules)
    if shape.kind == "decode" and shape.global_batch == 1:  # the reference's token
        b_shard = {"token": NamedSharding(mesh, (None, None))}
    batch = {k: _block(v, b_shard[k], device) for k, v in batch.items()}
    state = {"params": params}
    if shape.kind == "train":
        opt = abstract_opt_state(model)
        state.update(moments=opt["m"] + opt["v"], opt_step=[opt["step"]])
        step = make_train_step(cfg, AdamWConfig(), plan, mesh=mesh, on_micro=on_micro)
        return state, batch, lambda: step(model, opt, batch), params
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, shape, plan, mesh=mesh)
        return state, batch, lambda: step(model, batch), params
    c_shapes = abstract_caches(cfg, shape.global_batch, shape.seq_len, cache_dtype)
    c_shard = cache_sharding(mesh, c_shapes, cfg.n_kv_heads, shape.global_batch, rules)
    # init_caches(..., sharding=c_shard)'s blocks, also on the meta device
    caches = {k: placed_zeros(s, c_shard[k], dt, device) for k, (s, dt) in
              cache_shapes(cfg, shape.global_batch, shape.seq_len, cache_dtype).items()}
    state["caches"] = list(caches.values())
    step = make_decode_step(cfg, mesh=mesh)
    return state, batch, lambda: step(model, batch["token"], caches, shape.seq_len - 1), params


def _state_bytes(cfg, shape, mesh, rules, plan, dtype, cache_dtype) -> int:
    """``state_bytes_per_device`` alone: rank 0's placed state with its
    blocks on the ``meta`` device (the same blocks, cheaper), no step."""
    model, sharding = _abstract(cfg, mesh, rules, dtype)
    state, _, _, _ = _build(model, sharding, cfg, shape, mesh, rules, plan, "meta", cache_dtype)
    return sum(_storage_bytes(v) for v in state.values())


def _run_step(cfg, shape, mesh, rules, plan, device, dtype, cache_dtype,
              all_micro=False) -> dict:
    """Rank 0's placed state and one run of the step on it, counted
    (module doc); under a ``FakeTensorMode``.  A train step of ``n > 2``
    microbatches runs 2 (unless ``all_micro``): every microbatch after the
    first repeats the same ops on the same shapes, so the counts are the
    2-microbatch run's plus ``n - 2`` times its second microbatch's, and
    its peak is the 2-microbatch run's (with the whole batch block)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    n_micro = int(plan.get("n_micro", 1))
    n_run = n_micro if shape.kind != "train" or n_micro <= 2 or all_micro else 2
    if n_run != n_micro:
        shape = dataclasses.replace(shape, global_batch=shape.global_batch * n_run // n_micro)
        plan = {**plan, "n_micro": n_run}
    flops, marks = FlopCounterMode(display=False), []

    def counts():
        return {"flops": float(flops.get_total_flops()), "bytes accessed": float(counter.accessed),
                "transcendentals": float(counter.transcendentals),
                **{k: tuple(v) for k, v in col.traffic.items()}}

    t0 = time.perf_counter()
    model, sharding = _abstract(cfg, mesh, rules, dtype)
    with FakeTensorMode():
        state, batch, call, params = _build(model, sharding, cfg, shape, mesh, rules, plan,
                                            device, cache_dtype,
                                            on_micro=lambda i: marks.append(counts()))
        parts = {k: _storage_bytes(v) for k, v in state.items()}
        splits = attention_splits(model, cfg, None if shape.kind == "decode" else shape.seq_len)
        if shape.kind == "train":  # each gradient is a block placed as its parameter
            parts["grads"] = sum(_local(p).numel() * p.element_size() for p in params)
        state_bytes = sum(v for k, v in parts.items() if k != "grads")
        batch_bytes = _storage_bytes(batch.values())
        counter = LiveBytes([t for v in state.values() for t in v] + list(batch.values()))
        build_s = time.perf_counter() - t0
        col.traffic.clear()
        t0 = time.perf_counter()
        with flops, counter:
            out = call()
        run_s = time.perf_counter() - t0
        out_bytes = _storage_bytes([t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                                   + (params if shape.kind == "train" else []))
        total = counts()
        peak = state_bytes + batch_bytes + counter.peak
    if n_run != n_micro:  # the counts of n_micro - 2 more microbatches like the second
        extra = n_micro - n_run
        for k, v in total.items():
            if isinstance(v, tuple):
                second, first = marks[1].get(k, (0, 0)), marks[0].get(k, (0, 0))
                total[k] = tuple(a + extra * (b - c) for a, b, c in zip(v, second, first))
            else:
                total[k] = v + extra * (marks[1][k] - marks[0][k])
        peak += batch_bytes * extra // n_run
        batch_bytes = batch_bytes * n_micro // n_run
    arg_bytes = state_bytes + batch_bytes
    traffic = {k: list(v) for k, v in sorted(total.items()) if isinstance(v, tuple)}
    return {
        "state_bytes": state_bytes,
        "state_parts": parts,
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": peak - arg_bytes, "peak_bytes": peak},
        "cost": {k: total[k] for k in ("flops", "bytes accessed", "transcendentals")},
        "traffic": traffic,
        "collectives": _hlo_collectives(traffic),
        "n_micro_run": n_run,
        "attn_split": splits,
        "build_s": build_s,
        "run_s": run_s,
    }


def account_cell(cfg, shape, mesh, rules, plan, *, device="cuda", dtype=torch.bfloat16,
                 cache_dtype=torch.bfloat16, all_micro=False):
    """The reference's loop accounting: the step of 1- and 2-layer variants,
    extrapolated as ``c1 + (L - 1) * (c2 - c1)`` (the difference isolates
    one layer; the embedding, head and optimizer cancel).  Eager mode
    counts every layer, so this equals the full count (module doc)."""
    runs = [_run_step(dataclasses.replace(cfg, n_layers=n), shape, mesh, rules, plan, device,
                      dtype, cache_dtype, all_micro) for n in (1, 2)]
    L = cfg.n_layers
    cost1, cost2 = runs[0]["cost"], runs[1]["cost"]
    out_cost = {k: cost1[k] + (L - 1) * max(0.0, cost2[k] - cost1[k]) for k in cost1}
    out_coll = {}
    for kind in _COLLECTIVES:
        c1, c2 = runs[0]["collectives"][kind], runs[1]["collectives"][kind]
        out_coll[kind] = {k: int(c1[k] + (L - 1) * max(0, c2[k] - c1[k]))
                          for k in ("bytes", "count")}
    out_coll["total_bytes"] = sum(v["bytes"] for v in out_coll.values())
    return out_cost, out_coll


def _card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _shape(name: str, overrides: dict) -> ShapeConfig:
    if name.startswith("smoke_"):
        shape = smoke_shape(name[len("smoke_"):])
    else:
        shape = SHAPES[name]
    if overrides.get("global_batch"):
        shape = dataclasses.replace(shape, global_batch=int(overrides["global_batch"]))
    return shape


def _skip(cfg, shape_name: str):
    if shape_name in SHAPES:
        return skip_reason(cfg, shape_name)
    if cfg.encoder_only and shape_name == "smoke_decode":
        return "encoder-only arch has no autoregressive decode"
    return None


def _mesh(multi_pod: bool, mesh_shape, device):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device=device)
    axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    return make_mesh(tuple(mesh_shape), axes, device)


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool, overrides: dict | None = None,
               *, device="cuda", mesh_shape=None):
    """Build rank 0's placed state for one cell and run its step once
    under the fake group already started (``fake_group``); returns the
    result record (module doc).

    ``overrides`` are the reference's knobs ``remat``, ``attn_heads``,
    ``attn_impl``, ``moe_dispatch``, ``chunk``, ``n_micro``,
    ``cache_dtype`` (``fp8``: ``torch.float8_e4m3fn``) and
    ``skip_account``, and the port's ``reduced`` (the architecture's
    ``reduced()``), ``layers`` (its depth), ``global_batch`` and
    ``param_dtype`` (``bfloat16``, the reference's, or ``float32``),
    ``all_micro`` (run every microbatch of a train step: ``_run_step``) and
    ``state_only`` (build the state and record its bytes; run no step).
    ``mesh_shape`` replaces the production mesh by ``(data, model)`` or
    ``(pod, data, model)``.
    """
    overrides = overrides or {}
    cfg = get_arch(arch_name)
    if overrides.get("reduced"):
        cfg = cfg.reduced()
    if overrides.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=int(overrides["layers"]))
    if overrides.get("remat"):
        cfg = dataclasses.replace(cfg, remat=overrides["remat"])
    if overrides.get("moe_dispatch") and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=overrides["moe_dispatch"])
        )
    shape = _shape(shape_name, overrides)
    reason = _skip(cfg, shape_name)
    if reason:
        return {"arch": arch_name, "shape": shape_name, "status": "skip", "reason": reason}

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)  # rank 0's card: the fake ranks need none
    mesh = _mesh(multi_pod, mesh_shape, dev)
    rules = default_rules(mesh)
    policy = {k: overrides[k] for k in ("attn_heads",) if overrides.get(k)}
    sizes = {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    dp_total = sizes["data"] * sizes.get("pod", 1)
    plan = attn_plan(cfg, shape, dp_total)
    if overrides.get("n_micro"):
        plan = {**plan, "n_micro": int(overrides["n_micro"])}
    if overrides.get("chunk"):
        plan = {**plan, "chunk": int(overrides["chunk"])}
    if overrides.get("attn_impl"):
        plan = {**plan, "mode": overrides["attn_impl"]}
    dtype = _DTYPES[overrides.get("param_dtype") or "bfloat16"]
    cache_dtype = torch.float8_e4m3fn if overrides.get("cache_dtype") == "fp8" else torch.bfloat16
    record = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "x".join(str(mesh.size(i)) for i in range(mesh.ndim)),
        "kind": shape.kind,
        "plan": plan,
        "overrides": overrides,
        "world": dist.get_world_size(),
        "device": dev.type,
        "card": _card(dev),
        "torch": torch.__version__,
        "param_dtype": str(dtype).replace("torch.", ""),
        "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers,
    }
    if overrides.get("state_only"):
        record["state_bytes_per_device"] = _state_bytes(cfg, shape, mesh, rules, plan, dtype,
                                                        cache_dtype)
        record["status"] = "ok"
        return record
    set_activation_mesh(mesh, rules, policy)
    try:
        all_micro = bool(overrides.get("all_micro"))
        res = _run_step(cfg, shape, mesh, rules, plan, dev, dtype, cache_dtype, all_micro)
        record["n_micro_run"] = res["n_micro_run"]
        record["attn_split"] = res["attn_split"]
        record["lower_s"] = round(res["build_s"], 2)
        record["compile_s"] = round(res["run_s"], 2)
        record["memory_analysis"] = res["memory"]
        record["cost_analysis"] = res["cost"]
        record["collectives_scan_program"] = res["collectives"]
        record["traffic"] = res["traffic"]
        record["hlo_bytes"] = None
        record["state_bytes_per_device"] = res["state_bytes"]
        record["state_parts_bytes"] = res["state_parts"]
        total = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None
        record["device_memory_bytes"] = total
        record["fits"] = None if total is None else res["memory"]["peak_bytes"] <= total
        if overrides.get("skip_account"):
            record["collectives"] = record["collectives_scan_program"]
        else:
            acc_cost, acc_coll = account_cell(cfg, shape, mesh, rules, plan, device=dev,
                                              dtype=dtype, cache_dtype=cache_dtype,
                                              all_micro=all_micro)
            record["cost_accounted"] = acc_cost
            record["collectives"] = acc_coll
    finally:
        set_activation_mesh(None)
    record["status"] = "ok"
    return record


def mesh_tag(multi_pod: bool, mesh_shape=None, tag: str = "") -> str:
    base = ("pod2x16x16" if multi_pod else "pod16x16") if mesh_shape is None else \
        "mesh" + "x".join(str(int(n)) for n in mesh_shape)
    return base + (f"_{tag}" if tag else "")


def run(arch_names, shape_names, multi_pod: bool, out_dir: str, overrides: dict | None = None,
        tag: str = "", *, device="cuda", mesh_shape=None) -> list[dict]:
    """Every cell of ``arch_names`` × ``shape_names`` on one mesh, in a fake
    group of its size started here; writes each record and returns them."""
    world = 512 if multi_pod else 256
    if mesh_shape is not None:
        world = 1
        for n in mesh_shape:
            world *= int(n)
    mtag = mesh_tag(multi_pod, mesh_shape, tag)
    os.makedirs(os.path.join(out_dir, mtag), exist_ok=True)
    records = []
    with fake_group(world):
        for a in arch_names:
            for s in shape_names:
                path = os.path.join(out_dir, mtag, f"{a}__{s}.json")
                t0 = time.perf_counter()
                try:
                    rec = lower_cell(a, s, multi_pod, overrides, device=device,
                                     mesh_shape=mesh_shape)
                except Exception as e:
                    rec = {
                        "arch": a,
                        "shape": s,
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                rec["wall_s"] = round(time.perf_counter() - t0, 2)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(_line(mtag, rec), flush=True)
                records.append(rec)
    return records


def _line(mtag: str, rec: dict) -> str:
    a, s, status = rec["arch"], rec["shape"], rec["status"]
    line = f"[{mtag}] {a:18s} {s:13s} -> {status:5s}"
    if status == "ok" and "memory_analysis" not in rec:
        line += f" state={rec['state_bytes_per_device']}B"
    elif status == "ok":
        mem = rec["memory_analysis"]
        line += (f" flops={rec['cost_analysis']['flops']:.3e} "
                 f"state={rec['state_bytes_per_device']}B peak={mem['peak_bytes']}B "
                 f"fits={rec['fits']} ({rec['wall_s']}s)")
    elif status == "skip":
        line += f" ({rec.get('reason', '')[:60]})"
    else:
        line += f" ERR {rec.get('error', '')[:160]}"
    return line


def _run_jobs(argv, archs, shapes, meshes, args, jobs: int) -> list[dict]:
    """Each cell in a process of its own (its own fake group), ``jobs`` at a
    time; the records they write, printed as each ends."""
    from concurrent.futures import ThreadPoolExecutor

    drop = {"--arch", "--shape", "--jobs"}
    base, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in drop:
            skip = True
        elif a.split("=")[0] not in drop and a not in ("--multi-pod", "--both-meshes"):
            base.append(a)
    cells = [(mp, a, s) for mp in meshes for a in archs for s in shapes]

    def one(cell):
        mp, a, s = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *base, "--arch", a,
               "--shape", s, *(["--multi-pod"] if mp else [])]
        done = subprocess.run(cmd, capture_output=True, text=True)
        path = os.path.join(args.out, mesh_tag(mp, args.mesh, args.tag), f"{a}__{s}.json")
        if not os.path.exists(path):
            raise RuntimeError(f"{a} {s}: no record (exit {done.returncode}):\n"
                               f"{done.stdout[-2000:]}{done.stderr[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
        print(_line(mesh_tag(mp, args.mesh, args.tag), rec), flush=True)
        return rec

    with ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(one, cells))


def _mesh_arg(text: str):
    shape = tuple(int(n) for n in text.lower().split("x"))
    if len(shape) not in (2, 3):
        raise argparse.ArgumentTypeError(f"--mesh {text}: give DxM or PxDxM")
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run of the port's steps")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="names of SHAPES, or smoke_train/smoke_prefill/smoke_decode")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="DxM or PxDxM instead of the production mesh")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--remat", default="")
    ap.add_argument("--attn-heads", default="")
    ap.add_argument("--attn-impl", default="")
    ap.add_argument("--moe-dispatch", default="")
    ap.add_argument("--chunk", default="")
    ap.add_argument("--n-micro", default="")
    ap.add_argument("--cache-dtype", default="")
    ap.add_argument("--skip-account", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for the output subdir")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the fake tensors'")
    ap.add_argument("--reduced", action="store_true", help="each architecture's reduced()")
    ap.add_argument("--layers", default="", help="the depth, instead of the architecture's")
    ap.add_argument("--global-batch", default="", help="instead of the shape's")
    ap.add_argument("--param-dtype", default="", choices=["", *_DTYPES])
    ap.add_argument("--all-micro", action="store_true",
                    help="run every microbatch of a train step, not 2 and the rest counted")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process (and fake group) of its own")
    ap.add_argument("--state-only", action="store_true",
                    help="record state_bytes_per_device alone: run no step")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass --device cpu)")
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.mesh is not None:
        meshes = [False]
    overrides = {
        k: v
        for k, v in (
            ("remat", args.remat),
            ("attn_heads", args.attn_heads),
            ("attn_impl", args.attn_impl),
            ("moe_dispatch", args.moe_dispatch),
            ("chunk", args.chunk),
            ("n_micro", args.n_micro),
            ("cache_dtype", args.cache_dtype),
            ("skip_account", args.skip_account),
            ("reduced", args.reduced),
            ("layers", args.layers),
            ("global_batch", args.global_batch),
            ("param_dtype", args.param_dtype),
            ("all_micro", args.all_micro),
            ("state_only", args.state_only),
        )
        if v
    }
    t0 = time.perf_counter()
    records = []
    if args.jobs > 1:
        records = _run_jobs(sys.argv[1:] if argv is None else list(argv), archs, shapes, meshes,
                            args, args.jobs)
    for mp in meshes if args.jobs <= 1 else ():
        records += run(archs, shapes, mp, args.out, overrides, args.tag, device=args.device,
                       mesh_shape=args.mesh)
    errors = [r for r in records if r["status"] == "error"]
    print(f"dry run: {len(records)} cells, "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skip' for r in records)} skip, {len(errors)} error, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
