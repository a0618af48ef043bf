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
DP_SEQ, DP_BATCH, DP_STEPS = 16, 4, 3
DP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def dp_train(io, tag, arch, steps, **kw):
    """``train_loop`` on this rank: its per-step metrics and losses, and a
    digest of its final parameters; rank 0 also saves the parameters (the
    reference's tree) after each of the first ``DP_STEPS`` steps."""
    import hashlib

    import repro_torch.configs as tconfigs
    from repro_torch.launch.train import train_loop
    from repro_torch.models.convert import to_reference
    from repro_torch.optim.adamw import AdamWConfig

    import _dist_cases as K

    metrics = []

    def on_step(step, model, m):
        metrics.append(m)
        if dist.get_rank() == 0 and step < DP_STEPS:
            np.savez(os.path.join(io, f"{tag}.step{step}.npz"), **K.flat(to_reference(model)))

    model, losses = train_loop(
        tconfigs.get_arch(arch).reduced(), tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train"),
        steps=steps, log_every=100, opt_cfg=AdamWConfig(**DP_OPT), device="cpu",
        on_step=on_step, **kw)
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().numpy().tobytes())
    return {"metrics": metrics, "losses": losses, "digest": digest.hexdigest()}


def task_dp4(rank, world, io):
    return {
        "dense": dp_train(io, "dense4", "qwen2-0.5b", 6, ckpt_dir=os.path.join(io, "straight4"),
                          ckpt_every=3, lineage_dir=os.path.join(io, "lineage4")),
        "ck4": dp_train(io, "ck4", "qwen2-0.5b", 3, ckpt_dir=os.path.join(io, "ck4"),
                        ckpt_every=3),
        "moe": dp_train(io, "moe4", "qwen2-moe-a2.7b", DP_STEPS),
    }


def task_dp2(rank, world, io):
    import repro_torch.configs as tconfigs
    from repro_torch.launch.train import train_loop

    try:
        train_loop(tconfigs.get_arch("qwen2-0.5b").reduced(),
                   tconfigs.ShapeConfig("dp", DP_SEQ, DP_BATCH, "train"), steps=1,
                   model_parallel=2, device="cpu")
        raised = None
    except NotImplementedError as exc:
        raised = str(exc)
    return {
        "dense": dp_train(io, "dense2", "qwen2-0.5b", DP_STEPS),
        "moe": dp_train(io, "moe2", "qwen2-moe-a2.7b", DP_STEPS),
        "resume": dp_train(io, "resume2", "qwen2-0.5b", 6, ckpt_dir=os.path.join(io, "ck4_to2"),
                           ckpt_every=3),
        "model_parallel": raised,
    }


TASKS = {"sharding": task_sharding, "dp4": task_dp4, "dp2": task_dp2}


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
