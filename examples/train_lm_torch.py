"""Train a ~100M-param decoder LM with the port (``repro_torch``): the
trainer with checkpointing, the straggler watchdog and a loss-curve
report, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""

import argparse

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.train import train_loop
from repro_torch.optim.adamw import AdamWConfig

LM100M = ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    remat="nothing",
    source="example trainer",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint every 100 steps here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    print(f"params: {LM100M.params_billions() * 1000:.0f}M")
    shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")
    _, history = train_loop(
        LM100M,
        shape,
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        log_every=max(1, args.steps // 10),
        opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        device=args.device,
    )
    k = max(1, min(5, len(history) // 2), len(history) // 10)
    print(
        f"loss: first-{k}-avg {sum(history[:k]) / k:.3f} -> "
        f"last-{k}-avg {sum(history[-k:]) / k:.3f} "
        f"({'DECREASED' if history and sum(history[-k:]) < sum(history[:k]) else 'FLAT'})"
    )


if __name__ == "__main__":
    main()
