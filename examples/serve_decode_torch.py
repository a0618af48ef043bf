"""Batched serving demo on the PyTorch/CUDA port: prefill a prompt batch,
greedy-decode new tokens through the KV/SSM caches (dense, SWA, MoE,
hybrid, SSM architectures), on the GPU unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch mamba2-780m
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.launch.serve import generate
from repro_torch.models import init_model


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = get_arch(args.arch).reduced()
    if cfg.encoder_only:
        raise SystemExit("encoder-only arch has no decode path")
    model = init_model(cfg, 0, device=args.device)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=args.device, dtype=torch.int32)
    t0 = time.time()
    out = generate(cfg, model, prompts, args.new_tokens, device=args.device)
    new = out[:, args.prompt_len :].cpu()
    dt = time.time() - t0
    print(f"[{cfg.name}] generated {out.shape[0]}x{args.new_tokens} tokens on "
          f"{args.device} in {dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print(new)


if __name__ == "__main__":
    main()
