"""Batched serving loop: prefill a batch of prompts, then decode.

The port of ``repro.launch.serve``; ``examples/serve_decode_torch.py``
drives it, and so does ``python -m repro_torch.launch.serve --arch
qwen2-0.5b --device cuda``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..kernels.ops import resolve_device
from ..models.blocks import init_caches
from ..models.model import decode_step, init_model

__all__ = ["generate", "main"]


@torch.no_grad()
def generate(
    cfg,
    model,
    prompts,
    max_new_tokens: int = 16,
    greedy: bool = True,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> torch.Tensor:
    """prompts: [B, S0] int → [B, S0 + max_new_tokens] int32 on ``device``,
    where ``model`` must lie.

    Greedy decoding takes the first index of the largest logit, as
    ``jnp.argmax``; sampling draws from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (its tokens differ from the reference's JAX RNG).
    A ``timings`` dict receives ``prefill_s`` and ``decode_s``, the host
    seconds of the prompt loop and of the decode loop, each ended by a
    device synchronisation (made only when ``timings`` is given).
    """
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type or dev.index not in (None, where.index):
        raise ValueError(f"the model lies on {where}, not on {dev}")
    tokens = torch.as_tensor(prompts, device=dev).to(torch.int32)
    b, s0 = tokens.shape
    max_len = s0 + max_new_tokens + 1
    caches = init_caches(cfg, b, max_len, torch.float32, device=dev)

    def lap(name: str, t0: float) -> float:
        if timings is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if name:
            timings[name] = now - t0
        return now

    t0 = lap("", 0.0)
    # prompt ingestion via the decode path (token-by-token prefill keeps the
    # cache layout identical; a fused prefill is perf work for later)
    logits = None
    for pos in range(s0):
        logits, caches = decode_step(model, tokens[:, pos : pos + 1], caches, pos, cfg)
    t0 = lap("prefill_s", t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = [tokens]
    for i in range(max_new_tokens):
        if greedy:
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        else:
            probs = torch.softmax(logits[:, -1].float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        nxt = nxt.to(torch.int32)
        out.append(nxt)
        logits, caches = decode_step(model, nxt, caches, s0 + i, cfg)
    lap("decode_s", t0)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit("encoder-only architectures have no decode path")
    dev = resolve_device(args.device)
    model = init_model(cfg, 0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    t0 = time.time()
    out = generate(cfg, model, prompts, args.new_tokens, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n_new = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} on {dev} in {dt:.2f}s ({n_new / dt:.1f} tok/s)")
    print(out[:, args.prompt_len :].cpu())


if __name__ == "__main__":
    main()
