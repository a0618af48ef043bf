"""End-to-end trainer.

The port of ``repro.launch.train``: the config registry, the synthetic
token pipeline with optional DSLog lineage logging, AdamW,
checkpoint/restart and the straggler watchdog, on one device (``cuda``
unless the caller passes ``device="cpu"``).  Checkpoints keep the
reference's tree, ``{"params": ..., "opt": {"m", "v", "step"}}``, in the
reference's layout (``models.to_reference``), so either package resumes
from the other's.  ``examples/train_lm_torch.py`` drives it, and so does
``python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device cpu``.

One device, no mesh: ``model_parallel`` must divide the device count and,
until the port's distributed slice, be 1; the data-parallel width is 1.
An encoder's random ``frames`` come from a ``torch.Generator`` seeded with
the step, so they differ from the reference's JAX RNG.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..core.catalog import DSLog
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed.elastic import StepWatchdog
from ..kernels.ops import resolve_device
from ..models.convert import copy_tree, to_reference, tree_values
from ..models.model import init_model
from ..optim.adamw import AdamWConfig, adamw_init
from .steps import attn_plan, make_train_step

__all__ = ["train_loop", "main"]


def _checkpoint_tree(model, opt_state) -> dict:
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
):
    """Train ``cfg`` on ``shape``'s batches for ``steps`` steps; returns
    ``(model, losses)`` with one loss a step run (fewer after a resume)."""
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if model_parallel < 1 or n_dev % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n_dev} device(s)")
    if model_parallel != 1:
        raise NotImplementedError("model parallelism comes with the port's distributed slice")
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    plan = attn_plan(cfg, shape, dp_total=1)

    model = init_model(cfg, seed, device=dev)
    opt_state = adamw_init(model)

    dslog = DSLog(root=lineage_dir, device=dev) if lineage_dir else None
    pipe = TokenPipeline(
        PipelineConfig(cfg.vocab, shape.seq_len, shape.global_batch, seed),
        data_shards=1,
        shard_id=0,
        dslog=dslog,
    )
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, extra = mgr.restore(device=dev)
        if restored is not None:
            copy_tree(model, restored["params"])
            opt = restored["opt"]
            opt_state = {
                "m": [t.float().clone() for t in tree_values(model, opt["m"])],
                "v": [t.float().clone() for t in tree_values(model, opt["v"])],
                "step": torch.as_tensor(opt.get("step", extra["step"]), dtype=torch.int32,
                                        device=dev),
            }
            pipe.load_state_dict(extra["pipeline"])
            start_step = int(extra["step"]) + 1
            print(f"resumed from step {start_step - 1}")

    step_fn = make_train_step(cfg, opt_cfg, plan)
    watchdog = StepWatchdog()
    history = []
    for step in range(start_step, steps):
        batch_np = pipe.next_batch()
        tokens = torch.from_numpy(batch_np["tokens"]).to(dev)
        batch = {"tokens": tokens}
        if cfg.encoder_only:
            gen = torch.Generator(device=dev)
            gen.manual_seed(step)
            batch = {
                "frames": torch.randn((shape.global_batch, shape.seq_len, cfg.frontend_dim),
                                      generator=gen, device=dev),
                "labels": tokens % cfg.vocab,
            }
        t0 = time.time()
        model, opt_state, metrics = watchdog.guard(step_fn, model, opt_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"grad_norm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)",
                flush=True,
            )
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(
                step,
                _checkpoint_tree(model, opt_state),
                extra={"step": step, "pipeline": pipe.state_dict()},
            )
    if mgr is not None:
        mgr.wait()
    if dslog is not None:
        dslog.save()
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
    train_loop(
        cfg,
        shape,
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        lineage_dir=args.lineage_dir,
        model_parallel=args.model_parallel,
        device=args.device,
    )


if __name__ == "__main__":
    main()
