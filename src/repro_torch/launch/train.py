"""End-to-end trainer.

The port of ``repro.launch.train``: the config registry, the synthetic
token pipeline with optional DSLog lineage logging, AdamW,
checkpoint/restart and the straggler watchdog, on one device (``cuda``
unless the caller passes ``device="cpu"``).  Checkpoints keep the
reference's tree, ``{"params": ..., "opt": {"m", "v", "step"}}``, in the
reference's layout (``models.to_reference``), so either package resumes
from the other's.  ``examples/train_lm_torch.py`` drives it, and so does
``python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device cpu``.

Without an initialised ``torch.distributed`` group it trains on one
device, with no mesh.  In a group of W ranks (``torchrun``; ``main``
starts the group from its environment) it trains on the reference's
``local_mesh(model_parallel)``, a ``("data", "model")`` mesh of
``W / model_parallel`` by ``model_parallel`` ranks, one process a rank
(``launch.mesh.mesh_coords``).  Every rank makes the same seeded
``init_model`` and keeps the block of each parameter that
``param_sharding`` gives its mesh coordinate (``models.convert.place_model``;
the same tree restores a checkpoint): ``fsdp`` dimensions split over the
data ranks (ZeRO-3, at every ``dp > 1``), ``tp`` dimensions over the
model ranks, an axis that does not divide a dimension demoted to
replication; both AdamW moments follow.  The step
(``steps.make_train_step(mesh=...)``) computes tensor-parallel over the
model ranks and averages the gradients over the data ranks; where the
model axis cuts a head or the SSM's fused segments, a layer computes whole
on every model rank, and ``models.replicated_over_model`` names its
weights (rank 0 prints them; none for qwen2-0.5b at ``(2, 2)``).  The
ranks of one data coordinate take the same block of each global batch
(``TokenPipeline(data_shards=dp, shard_id=data coordinate)``), so the data
blocks together are the global batch and the numbers are the one-device
step's (an MoE's with ``n_micro = dp``).  Only global rank 0 logs lineage
(its pipeline logs every shard's slice).  Checkpoints are gathered to the
reference's tree, which rank 0 writes; a resume restores each rank's
blocks (``restore(shardings=...)``), at any mesh: the pipeline's state is
its step.  The reference at ``dp > 1`` trains on shard 0's block alone
(``ROADMAP.md`` §3, item 6); the port does not copy that.

An encoder's random ``frames``, and a VLM's random ``patch_embeds``, come
from a ``torch.Generator`` seeded with the step, so they differ from the
reference's JAX RNG; the reference's ``train_loop`` passes a VLM no patch
embeddings at all (``ROADMAP.md`` §3, item 7).
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..core.catalog import DSLog
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed.elastic import StepWatchdog
from ..distributed.sharding import local_tensor, param_sharding
from ..models.convert import (copy_tree, place_model, shape_tree, spec_tree, to_reference,
                              tree_values)
from ..models.model import init_model, replicated_over_model
from ..optim.adamw import AdamWConfig, adamw_init
from .mesh import local_mesh, mesh_coords, rank_device
from .steps import attn_plan, make_train_step

__all__ = ["train_loop", "main"]


def _moments(model, tree) -> list:
    """Float32 tensors placed like ``model``'s parameters, holding
    ``tree``'s values (each rank its blocks)."""
    out = []
    with torch.no_grad():
        for p, value in zip(model.parameters(), tree_values(model, tree)):
            t = torch.zeros_like(p, dtype=torch.float32)
            local_tensor(t).copy_(value)
            out.append(t)
    return out


def _checkpoint_tree(model, opt_state) -> dict:
    """The reference's checkpoint tree; on a mesh every rank gathers it."""
    return {
        "params": to_reference(model),
        "opt": {"m": to_reference(model, opt_state["m"]),
                "v": to_reference(model, opt_state["v"]),
                "step": opt_state["step"]},
    }


def train_loop(
    cfg,
    shape: ShapeConfig,
    steps: int = 100,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    lineage_dir: str | None = None,
    model_parallel: int = 1,
    log_every: int = 10,
    seed: int = 0,
    opt_cfg: AdamWConfig | None = None,
    device="cuda",
    on_step=None,
):
    """Train ``cfg`` on ``shape``'s batches for ``steps`` steps; returns
    ``(model, losses)`` with one loss a step run (fewer after a resume).
    In a process group every rank calls it (see the module doc); ``device``
    is this rank's (``launch.mesh.rank_device``).  ``on_step(step, model,
    metrics)``, when given, is called after each step with the step's
    metrics as floats."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {world} rank(s)")
    dev = rank_device(device)
    if group is not None and dev.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("an nccl group reduces CUDA tensors: pass this rank's cuda device")
    mesh = local_mesh(model_parallel, device=dev) if world > 1 else None
    coords = mesh_coords(mesh) if mesh is not None else None
    data, dp = (coords.data, coords.dp) if coords is not None else (0, 1)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    plan = attn_plan(cfg, shape, dp_total=dp)

    model = init_model(cfg, seed, device=dev)
    sh = None
    if mesh is not None:  # every rank made the same weights; each keeps its blocks
        sh = param_sharding(mesh, spec_tree(model), shapes_tree=shape_tree(model))
        place_model(model, sh)
        replicated = replicated_over_model(model, cfg)
        if rank == 0:
            print(f"mesh {tuple(mesh.mesh.shape)} (data, model); computed whole on every model "
                  f"rank: {replicated or 'none'}", flush=True)
    opt_state = adamw_init(model)

    dslog = DSLog(root=lineage_dir, device=dev) if lineage_dir and rank == 0 else None
    pipe = TokenPipeline(
        PipelineConfig(cfg.vocab, shape.seq_len, shape.global_batch, seed),
        data_shards=dp,
        shard_id=data,
        dslog=dslog,
    )
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        # on a mesh each rank keeps its blocks of the gathered tree
        shardings = {"params": sh, "opt": {"m": sh, "v": sh}} if sh is not None else None
        restored, extra = mgr.restore(device=dev, shardings=shardings)
        if restored is not None:
            copy_tree(model, restored["params"])
            opt = restored["opt"]
            opt_state = {
                "m": _moments(model, opt["m"]),
                "v": _moments(model, opt["v"]),
                "step": torch.as_tensor(opt.get("step", extra["step"]), dtype=torch.int32,
                                        device=dev),
            }
            pipe.load_state_dict(extra["pipeline"])
            start_step = int(extra["step"]) + 1
            if rank == 0:
                print(f"resumed from step {start_step - 1}")

    step_fn = make_train_step(cfg, opt_cfg, plan, mesh=mesh)
    # the watchdog runs each step, and so the step's collectives, on its own
    # thread: one step at a time, so every rank issues them in the same order
    watchdog = StepWatchdog()
    history = []
    per = shape.global_batch // dp
    for step in range(start_step, steps):
        batch_np = pipe.next_batch()
        tokens = torch.from_numpy(batch_np["tokens"]).to(dev)
        batch = {"tokens": tokens}
        mine = slice(data * per, (data + 1) * per)  # this data coordinate's block
        if cfg.encoder_only:
            gen = torch.Generator(device=dev)
            gen.manual_seed(step)
            frames = torch.randn((shape.global_batch, shape.seq_len, cfg.frontend_dim),
                                 generator=gen, device=dev)
            batch = {"frames": frames[mine], "labels": tokens % cfg.vocab}
        elif cfg.frontend == "patch":  # input_specs' layout: patches, then the text
            gen = torch.Generator(device=dev)
            gen.manual_seed(step)
            patches = torch.randn((shape.global_batch, cfg.frontend_len, cfg.d_model),
                                  generator=gen, device=dev)
            batch = {"tokens": tokens[:, :shape.seq_len - cfg.frontend_len],
                     "patch_embeds": patches[mine]}
        t0 = time.time()
        model, opt_state, metrics = watchdog.guard(step_fn, model, opt_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if on_step is not None:
            on_step(step, model, {k: float(v) for k, v in metrics.items()})
        if rank == 0 and (step % log_every == 0 or step == steps - 1):
            dt = time.time() - t0
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"grad_norm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)",
                flush=True,
            )
        if mgr is not None and (step + 1) % ckpt_every == 0:
            # every rank gathers the tree and calls save; rank 0 alone writes
            mgr.save(
                step,
                _checkpoint_tree(model, opt_state),
                extra={"step": step, "pipeline": pipe.state_dict()},
            )
            if mesh is not None:
                dist.barrier()
    if mgr is not None:
        mgr.wait()
    if dslog is not None:
        dslog.save()
    if mesh is not None:
        dist.barrier()
    return model, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lineage-dir", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:  # under torchrun: one process a rank, its card from train_loop's rank_device
        if args.device not in ("cuda", "cpu"):
            raise ValueError(f"--device {args.device}: under torchrun each rank takes cuda or cpu")
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        train_loop(
            cfg,
            shape,
            steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            lineage_dir=args.lineage_dir,
            model_parallel=args.model_parallel,
            device=args.device,
        )
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
