"""The port's side of the process-group tests: ``spawn`` starts W ``gloo``
processes on the CPU, each running this file::

    python tests/_dist_port.py TASK INIT_METHOD RANK WORLD IO_DIR

which joins the group, runs ``TASKS[TASK]`` and writes what it returns to
``IO_DIR/TASK.rankN.json``.  It imports torch and the port, never JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from _dist_cases import DP_BATCH, DP_OPT, DP_SEQ, DP_STEPS

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def spawn(task: str, world: int, io: str, timeout: int = 300) -> list:
    """Run ``task`` on ``world`` ranks; returns each rank's JSON result."""
    return finish(start(task, world, io), timeout)


def start(task: str, world: int, io: str) -> tuple:
    """Start ``task`` on ``world`` ranks (``finish`` waits for them)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OMP_NUM_THREADS="1")
    init = f"file://{os.path.join(io, f'{task}.rendezvous')}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), task, init, str(r),
                               str(world), io], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return task, world, io, procs


def finish(started: tuple, timeout: int = 300) -> list:
    task, world, io, procs = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{task} rank {r}:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(io, f"{task}.rank{r}.json")) as f:
            results.append(json.load(f))
    return results


# --------------------------------------------------------------------------- #
# sharding: specs, placements and collectives (test_torch_distributed.py)
# --------------------------------------------------------------------------- #
def _blocks(dt) -> list:
    """``[[start, stop], ...]`` of this rank's block of a ``DTensor``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                          dt.placements)
    return [[o, o + n] for o, n in zip(offset, shape)]


def _place(model, mesh):
    """``model`` with its parameters placed on ``mesh`` as ``param_sharding``
    places the reference's tree."""
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models.convert import place_model, shape_tree, spec_tree

    return place_model(model, param_sharding(mesh, spec_tree(model), shapes_tree=shape_tree(model)))


def _placed(tree, host) -> dict:
    """This rank's block of each leaf, after checking its values against
    the host array's and the gathered tensor against the host array."""
    import _dist_cases as K

    out = {}
    for path, dt in K.flat(tree).items():
        full = torch.from_numpy(np.asarray(host[path]))
        b = _blocks(dt)
        local = dt.to_local()
        assert torch.equal(local, full[tuple(slice(s, e) for s, e in b)]), path
        assert torch.equal(dt.full_tensor(), full), path
        out[path] = b
    return out


def task_sharding(rank, world, io):
    import _dist_cases as K
    import repro_torch.configs as tconfigs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import input_specs
    from repro_torch.models.blocks import init_caches
    from repro_torch.models.convert import shape_tree, spec_tree
    from repro_torch.models.layers import Init
    from repro_torch.models.model import LM

    inputs = np.load(os.path.join(io, "inputs.npz"))
    with open(os.path.join(io, "cache_shapes.json")) as f:
        cache_shapes = json.load(f)
    meshes = {k: make_mesh(*v, device="cpu") for k, v in K.MESHES.items()}
    res = {"coord": {m: ",".join(map(str, mesh.get_coordinate())) for m, mesh in meshes.items()},
           "param": {}, "batch": {}, "cache": {}, "hint": {}, "place": {}}

    for name in K.ARCHS:
        for red in (True, False):
            cfg = tconfigs.get_arch(name)
            model = LM(Init(None, "meta"), cfg.reduced() if red else cfg)
            specs, shapes = spec_tree(model), shape_tree(model)
            for m, mesh in meshes.items():
                sh = S.param_sharding(mesh, specs, shapes_tree=shapes)
                res["param"][f"{m}|{name}|{red}"] = {
                    p: K.spec_json(s.spec) for p, s in K.flat(sh).items()}

    for m, mesh in meshes.items():
        for case, arch, seq, gb, kind in K.BATCHES:
            batch = input_specs(tconfigs.get_arch(arch), tconfigs.ShapeConfig(case, seq, gb, kind))
            res["batch"][f"{m}|{case}"] = {
                k: K.spec_json(s.spec) for k, s in S.batch_sharding(mesh, batch).items()}
        for arch, b, t, red in K.CACHES:
            cfg = tconfigs.get_arch(arch)
            cfg = cfg.reduced() if red else cfg
            if red:  # the port's own caches
                caches = init_caches(cfg, b, t, device="cpu")
            else:  # the reference's shapes at published widths, on the meta device
                caches = {k: torch.empty(v, device="meta")
                          for k, v in cache_shapes[f"{arch}|{b}"].items()}
            sh = S.cache_sharding(mesh, caches, cfg.n_kv_heads, b)
            res["cache"][f"{m}|{arch}|{b}|{red}"] = {
                k: {"shape": list(caches[k].shape), "spec": K.spec_json(s.spec)}
                for k, s in sh.items()}

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    for m in K.HINT_MESHES:
        mesh = meshes[m]
        for policy in K.POLICIES:
            S.set_activation_mesh(mesh, policy={"attn_heads": policy})
            for kind, shape in K.HINTS:
                host = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
                assert S.hint(host, kind) is host  # a plain tensor passes unchanged
                # start from a sharded layout, so the redistribute moves data
                start = [Shard(len(shape) - 1) if i == 0 and shape[-1] % mesh.size(0) == 0
                         else Replicate() for i in range(mesh.ndim)]
                dt = S.hint(distribute_tensor(host, mesh, start, src_data_rank=None), kind)
                spec = S.hint_spec(shape, kind)
                assert tuple(dt.placements) == S.NamedSharding(mesh, spec).placements
                b = _blocks(dt)
                assert torch.equal(dt.to_local(), host[tuple(slice(s, e) for s, e in b)])
                res["hint"][K.hint_key(m, policy, kind, shape)] = {
                    "spec": K.spec_json(spec), "block": b}
            S.set_activation_mesh(None)

    host = {k[len("tree/"):]: inputs[k] for k in inputs.files if k.startswith("tree/")}
    tree = K.unflat(host)
    specs = spec_tree(LM(Init(None, "meta"), tconfigs.get_arch("qwen2-0.5b").reduced()))
    for m in K.PLACE_MESHES:
        res["place"][m] = _placed(reshard_tree(tree, specs, meshes[m]), host)

    a, b = (meshes[m] for m in K.ELASTIC)
    mgr = CheckpointManager(os.path.join(io, "port_elastic"))
    mgr.save(0, reshard_tree(tree, specs, a), extra={})  # gathers; rank 0 writes
    dist.barrier()
    got, _ = mgr.restore(device="cpu", shardings=S.param_sharding(b, specs, shapes_tree=tree))
    res["elastic"] = _placed(got, host)
    mesh = meshes[K.RESTORE_MESH]
    got, extra = CheckpointManager(os.path.join(io, "ref_ckpt")).restore(
        device="cpu", shardings=S.param_sharding(mesh, specs, shapes_tree=tree))
    res["restore"] = _placed(got, host)
    res["restore_extra"] = extra

    f = K.FLASH
    t_local = f["t"] // world
    lo = rank * t_local
    q = torch.from_numpy(inputs["q"])
    k = torch.from_numpy(inputs["k"][:, :, lo:lo + t_local])
    v = torch.from_numpy(inputs["v"][:, :, lo:lo + t_local])
    valid = (torch.arange(lo, lo + t_local) <= f["cur_len"]).expand(f["b"], t_local)
    flash = col.flash_decode_combine(*col.local_partial_attention(q, k, v, valid))
    ring = col.pipeline_stage_step(lambda y: y * 2.0 + 1.0,
                                   torch.from_numpy(inputs["ring"][rank:rank + 1]))
    res["flash"] = flash.flatten().tolist()
    res["ring"] = ring.flatten().tolist()
    return res


# --------------------------------------------------------------------------- #
# data-parallel training (test_torch_dp_train.py)
# --------------------------------------------------------------------------- #


def dp_train(io, tag, arch, steps, **kw):
    """``train_loop`` on this rank: its per-step metrics and losses, and a
    digest of its final parameters gathered (the reference's tree, on every
    rank); rank 0 also saves that tree after each of the first
    ``DP_STEPS`` steps.  On a mesh, also each parameter's block on this
    rank (checked against the gathered tree), the bytes it holds and
    ``replicated_over_model``."""
    import hashlib

    import repro_torch.configs as tconfigs
    from repro_torch.launch.train import train_loop
    from repro_torch.models.convert import to_reference
    from repro_torch.models.model import replicated_over_model
    from repro_torch.optim.adamw import AdamWConfig

    import _dist_cases as K

    metrics = []

    def on_step(step, model, m):
        metrics.append(m)
        if step < DP_STEPS:
            tree = K.flat(to_reference(model))  # a collective: every rank gathers
            if dist.get_rank() == 0:
                np.savez(os.path.join(io, f"{tag}.step{step}.npz"), **tree)

    cfg = tconfigs.get_arch(arch).reduced()
    model, losses = train_loop(
        cfg, tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train"),
        steps=steps, log_every=100, opt_cfg=AdamWConfig(**DP_OPT), device="cpu",
        on_step=on_step, **kw)
    tree = K.flat(to_reference(model))
    digest = hashlib.sha256()
    for path in sorted(tree):
        digest.update(tree[path].tobytes())
    out = {"metrics": metrics, "losses": losses, "digest": digest.hexdigest()}
    if any(hasattr(p, "device_mesh") for p in model.parameters()):
        out["blocks"], out["held"] = param_blocks(model, [("params", model.parameters(), tree)])
        out["replicated"] = replicated_over_model(model, cfg)
    return out


def param_blocks(model, parts) -> tuple:
    """``({part: {reference path: block}}, {part: bytes held})`` of placed
    tensors following ``model.parameters()``; each ``part`` is ``(name,
    tensors, gathered flat tree)``.  A block is ``[[start, stop], ...]``
    with the stacked leaf's layer axis (the same for every layer: checked);
    each rank's tensor must equal the gathered tree's slice there, bit for
    bit, and hold only those bytes."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.models.convert import split_name

    names = [n for n, _ in model.named_parameters()]
    blocks, held = {}, {}
    for part, tensors, tree in parts:
        blocks[part], held[part] = {}, 0
        for name, t in zip(names, tensors):
            path, indices = split_name(name)
            key = "/".join(path)
            shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                                  t.placements)
            block = [[o, o + n] for o, n in zip(offset, shape)]
            local = t.to_local()
            assert tuple(local.shape) == tuple(shape), name
            whole = tree[key][indices] if indices else tree[key]
            want = whole[tuple(slice(a, b) for a, b in block)]
            assert np.array_equal(local.detach().numpy(), want), f"{part} {name}"
            held[part] += local.numel() * local.element_size()
            if indices:
                block = [[0, tree[key].shape[0]]] + block
            assert blocks[part].setdefault(key, block) == block, f"{part} {name}"
    return blocks, held


def placed_step(mesh, arch):
    """One ``make_train_step(mesh=)`` step of ``arch`` at ``reduced()`` on
    this rank's data block of a made-up batch: the blocks of the
    parameters and both moments (``param_blocks``)."""
    import repro_torch.configs as tconfigs
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model, to_reference
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    import _dist_cases as K

    cfg = tconfigs.get_arch(arch).reduced()
    shape = tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train")
    c = mesh_coords(mesh)
    model = _place(init_model(cfg, 0, device="cpu"), mesh)
    opt = adamw_init(model)
    step = make_train_step(cfg, AdamWConfig(**DP_OPT), attn_plan(cfg, shape, c.dp), mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (DP_BATCH, DP_SEQ), generator=gen, dtype=torch.int32)
    per = DP_BATCH // c.dp
    mine = slice(c.data * per, (c.data + 1) * per)
    if cfg.frontend == "frames":
        frames = torch.randn((DP_BATCH, DP_SEQ, cfg.frontend_dim), generator=gen)
        batch = {"frames": frames[mine], "labels": tokens[mine] % cfg.vocab}
    elif cfg.frontend == "patch":
        patches = torch.randn((DP_BATCH, cfg.frontend_len, cfg.d_model), generator=gen)
        batch = {"tokens": tokens[mine, :DP_SEQ - cfg.frontend_len], "patch_embeds": patches[mine]}
    else:
        batch = {"tokens": tokens[mine]}
    model, opt, _ = step(model, opt, batch)
    parts = [("params", list(model.parameters()), K.flat(to_reference(model)))]
    for k in ("m", "v"):
        parts.append((k, opt[k], K.flat(to_reference(model, opt[k]))))
    return param_blocks(model, parts)


def task_dp4(rank, world, io):
    return {
        "dense": dp_train(io, "dense4", "qwen2-0.5b", 6, ckpt_dir=os.path.join(io, "straight4"),
                          ckpt_every=3, lineage_dir=os.path.join(io, "lineage4")),
        "ck4": dp_train(io, "ck4", "qwen2-0.5b", 3, ckpt_dir=os.path.join(io, "ck4"),
                        ckpt_every=3),
        "moe": dp_train(io, "moe4", "qwen2-moe-a2.7b", DP_STEPS),
    }


def task_dp2(rank, world, io):
    return {
        "dense": dp_train(io, "dense2", "qwen2-0.5b", DP_STEPS),
        "moe": dp_train(io, "moe2", "qwen2-moe-a2.7b", DP_STEPS),
        "resume": dp_train(io, "resume2", "qwen2-0.5b", 6, ckpt_dir=os.path.join(io, "ck4_to2"),
                           ckpt_every=3),
        "model_parallel": dp_train(io, "mp2", "qwen2-0.5b", DP_STEPS, model_parallel=2),
    }


# --------------------------------------------------------------------------- #
# tensor parallelism and ZeRO-3 (test_torch_tp_train.py, test_torch_tp_layers.py)
# --------------------------------------------------------------------------- #
def remat_grads(mesh, arch) -> dict:
    """The largest difference of each placed gradient (gathered) under
    remat ``full`` and ``dots`` from ``nothing``'s, for ``arch`` at
    ``reduced()`` on this rank's data block: the recompute repeats a
    layer's ZeRO-3 gathers and model-axis collectives."""
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.models import init_model, lm_loss

    cfg = tconfigs.get_arch(arch).reduced()
    c = mesh_coords(mesh)
    model = _place(init_model(cfg, 0, device="cpu"), mesh)
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (DP_BATCH, DP_SEQ), generator=gen, dtype=torch.int32)
    per = DP_BATCH // c.dp
    batch = {"tokens": tokens[c.data * per:(c.data + 1) * per]}
    grads = {}
    for remat in ("nothing", "full", "dots"):
        total, _ = lm_loss(model, batch, dataclasses.replace(cfg, remat=remat))
        grads[remat] = [gather_full(g) for g in torch.autograd.grad(
            total, list(model.parameters()), allow_unused=True, materialize_grads=True)]
    return {remat: max(float((g - w).abs().max()) for g, w in zip(grads[remat], grads["nothing"]))
            for remat in ("full", "dots")}


def micro_step(mesh, arch) -> dict:
    """One placed step of ``arch`` at ``reduced()`` with ``n_micro`` 1 and 2
    on this rank's data block, from the same weights: the largest
    differences of the gathered parameters and of ``grad_norm``."""
    import repro_torch.configs as tconfigs
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.launch.steps import attn_plan, make_train_step
    from repro_torch.models import init_model, to_reference
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    import _dist_cases as K

    cfg = tconfigs.get_arch(arch).reduced()
    c = mesh_coords(mesh)
    plan = attn_plan(cfg, tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train"), c.dp)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (DP_BATCH, DP_SEQ), generator=gen, dtype=torch.int32)
    per = DP_BATCH // c.dp
    batch = {"tokens": tokens[c.data * per:(c.data + 1) * per]}
    out = {}
    for n_micro in (1, 2):
        model = _place(init_model(cfg, 0, device="cpu"), mesh)
        step = make_train_step(cfg, AdamWConfig(**DP_OPT), {**plan, "n_micro": n_micro},
                               mesh=mesh)
        model, _, m = step(model, adamw_init(model), batch)
        out[n_micro] = (K.flat(to_reference(model)), float(m["grad_norm"]))
    return {"params": max(float(np.abs(a - out[2][0][k]).max()) for k, a in out[1][0].items()),
            "grad_norm": abs(out[1][1] - out[2][1])}


def task_tp4(rank, world, io):
    """Every architecture at ``reduced()`` on a (2, 2) mesh: ``train_loop``
    for ``DP_STEPS`` steps, and one placed step's parameter and moment
    blocks; the remat policies' gradients and ``n_micro = 2`` on that
    mesh."""
    import _dist_cases as K
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*K.MESHES["2x2"], device="cpu")
    out = {"coord": ",".join(map(str, mesh.get_coordinate()))}
    for arch in K.ARCHS:
        out[arch] = dp_train(io, f"tp22_{arch}", arch, DP_STEPS, model_parallel=2)
        out[arch]["step_blocks"], out[arch]["step_held"] = placed_step(mesh, arch)
    out["remat"] = {arch: remat_grads(mesh, arch) for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b",
                                                              "hymba-1.5b")}
    out["micro"] = micro_step(mesh, "qwen2-0.5b")
    return out


def task_tpmesh(rank, world, io):
    """qwen2 and qwen2-moe at ``reduced()`` on a (1, 4) mesh (tensor
    parallelism alone) and a (4, 1) mesh (ZeRO-3 alone); a (2, 2) run of 6
    steps whose step-2 checkpoint resumes at (4, 1); a reference
    checkpoint (``IO/refck``) resumed at (2, 2)."""
    import shutil

    import _dist_cases as K
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for m, mp in (("1x4", 4), ("4x1", 1)):
        mesh = make_mesh(*K.MESHES[m], device="cpu")
        out[f"coord{m}"] = ",".join(map(str, mesh.get_coordinate()))
        for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b"):
            run = dp_train(io, f"tp{m}_{arch}", arch, DP_STEPS, model_parallel=mp)
            run["step_blocks"], run["step_held"] = placed_step(mesh, arch)
            out[f"{m}|{arch}"] = run
    out["straight"] = dp_train(io, "straight22", "qwen2-0.5b", 6, model_parallel=2,
                               ckpt_dir=os.path.join(io, "ck22"), ckpt_every=3)
    if rank == 0:  # the step-2 checkpoint alone, as the latest of a new root
        dst = os.path.join(io, "ck22_to41")
        shutil.copytree(os.path.join(io, "ck22", "step_00000002"),
                        os.path.join(dst, "step_00000002"))
        with open(os.path.join(dst, "LATEST"), "w") as f:
            f.write("step_00000002")
    dist.barrier()
    out["resume41"] = dp_train(io, "resume41", "qwen2-0.5b", 6, model_parallel=1,
                               ckpt_dir=os.path.join(io, "ck22_to41"), ckpt_every=100)
    out["refresume"] = dp_train(io, "refresume", "qwen2-0.5b", 6, model_parallel=2,
                                ckpt_dir=os.path.join(io, "refck"), ckpt_every=100)
    return out


def task_tp2(rank, world, io):
    """Layers on a (1, 2) mesh, their results gathered (``IO/tp2.npz``
    from rank 0): column- and row-parallel ``dense`` with gradients; the
    vocab-parallel lookup, head and cross-entropy of a tied and an untied
    model with padded ids (``forward``'s logits, ``lm_loss`` and its
    gradient); ``global_norm`` of trees placed on (1, 2) and (2, 1)."""
    import _dist_cases as K
    import repro_torch.configs as tconfigs
    from repro_torch.distributed.collectives import gather_full, reduce_from_model
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import from_reference, spec_tree, to_reference
    from repro_torch.models.layers import Dense, Init, dense, enter_model, model_group
    from repro_torch.models.model import forward, lm_loss, replicated_over_model, vocab_block
    from repro_torch.optim.adamw import global_norm

    inp = dict(np.load(os.path.join(io, "tp2_inputs.npz")))
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    m = mesh.get_local_rank("model")
    res = {}
    for kind, spec in (("col", ("fsdp", "tp")), ("row", ("tp", "fsdp"))):
        w, b = torch.from_numpy(inp["dense/w"]), torch.from_numpy(inp["dense/b"])
        layer = Dense(Init(None, "cpu"), w.shape[0], w.shape[1], spec, bias=True)
        with torch.no_grad():
            layer.w.copy_(w)
            layer.b.copy_(b)
        _place(layer, mesh)
        x = torch.from_numpy(inp["dense/x"]).requires_grad_(True)
        r = torch.from_numpy(inp["dense/r"])
        group = model_group(layer.w)
        if kind == "col":  # this rank's output columns: the loss's terms summed over both
            y = dense(layer, enter_model(x, layer.w))
            n = y.shape[-1]
            total = reduce_from_model((y * r[..., m * n:(m + 1) * n]).sum(), group)
        else:  # this rank's block of the input features; y whole on both
            n = x.shape[-1] // 2
            y = dense(layer, x[..., m * n:(m + 1) * n])
            total = (y * r).sum()
        total.backward()
        if kind == "col":
            full = [torch.empty_like(y) for _ in range(2)]
            dist.all_gather(full, y.detach().contiguous(), group=group)
            y = torch.cat(full, dim=-1)
        res[f"{kind}/y"] = y.detach().numpy()
        res[f"{kind}/loss"] = total.detach().numpy()
        dx = x.grad
        if kind == "row":  # each rank's gradient covers its block of the features
            dist.all_reduce(dx, group=group)
        res[f"{kind}/dx"] = dx.numpy()
        res[f"{kind}/dw"] = gather_full(layer.w.grad).numpy()
        res[f"{kind}/db"] = gather_full(layer.b.grad).numpy()
        res[f"{kind}/w_block"] = layer.w.to_local().detach().numpy()

    tokens = torch.from_numpy(inp["lm/tokens"])
    for name in K.TP2_LM:
        cfg = K.tp2_cfg(tconfigs, name)
        tree = K.unflat({k[len(name) + 1:]: v for k, v in inp.items() if k.startswith(name + "/")})
        model = _place(from_reference(cfg, tree, device="cpu"), mesh)
        res[f"{name}/replicated"] = np.asarray(replicated_over_model(model, cfg))
        lo, _ = vocab_block(model, cfg)
        logits, _ = forward(model, {"tokens": tokens}, cfg)
        full = [torch.empty_like(logits) for _ in range(2)]
        dist.all_gather(full, logits.detach().contiguous(), group=mesh.get_group("model"))
        total, (ce, _) = lm_loss(model, {"tokens": tokens}, cfg)
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
        res[f"{name}/lo"] = np.asarray(lo)
        res[f"{name}/logits"] = torch.cat(full, dim=-1).numpy()
        res[f"{name}/ce"] = ce.detach().numpy()
        for path, g in K.flat(to_reference(model, grads)).items():
            res[f"{name}/grad/{path}"] = g

    tree = K.unflat({k[len("norm/"):]: v for k, v in inp.items() if k.startswith("norm/")})
    cfg = tconfigs.get_arch("qwen2-0.5b").reduced()
    specs = spec_tree(from_reference(cfg, tree, device="cpu"))
    for shape in ((1, 2), (2, 1)):
        placed = reshard_tree(tree, specs, make_mesh(shape, ("data", "model"), device="cpu"))
        res[f"norm/{shape[0]}x{shape[1]}"] = global_norm(list(K.flat(placed).values())).numpy()
    if rank == 0:
        np.savez(os.path.join(io, "tp2.npz"), **res)
    return {"lo": {k: int(res[f"{k}/lo"]) for k in K.TP2_LM}}


TASKS = {"sharding": task_sharding, "dp4": task_dp4, "dp2": task_dp2, "tp4": task_tp4,
         "tpmesh": task_tpmesh, "tp2": task_tp2}


def main():
    task, init, rank, world, io = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), \
        sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = TASKS[task](rank, world, io)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(io, f"{task}.rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
