"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card: the kernels
are loaded from the checkout's ``build/repro_torch/`` (built there on the
first run), the cell's store is built from the seed under ``TMPDIR``,
warmed up, measured for ``--seconds``, and its answers are checked against
the plain reference.  The last line of standard output is the result's
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.  ``--list`` prints the cells and metrics present
as files.  Without a card, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import harness, hw  # noqa: E402


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    stray = harness.forbidden_modules()
    if stray:
        fail(f"forbidden modules loaded at start-up: {stray}")
    if args.list:
        print(json.dumps(harness.listing()))
        return
    if not args.workload:
        fail("--workload is required")
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} cards, {torch.cuda.device_count()} present")
    card = hw.card_state()
    print(f"perfbench: card {card}", file=sys.stderr, flush=True)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START)
    stray = harness.forbidden_modules()
    if stray:
        fail(f"forbidden modules loaded after the window: {stray}")
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
