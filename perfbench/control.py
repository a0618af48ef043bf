"""Readings that set a cell's limits: the program's numbers compared, and the
control's, on many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--out F]

The control is the plain reference in the program's place with the
configuration's guarantee broken: each answer widened to its bounding box,
the coarse lineage a block- or array-level system returns in place of the
exact cell set.  For each seed the cell runs once at its own size and load
(a short window); the numbers the run compares are read for the program's
answers and for the control's on the same sample.  The benchmark's own runs
never compute the control.  Needs a CUDA card.
"""

import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import harness, hw  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("control.py: no CUDA device")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                             time.perf_counter(), metrics=[], control=True)
        row = {"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()},
               "control": r["control"], "correct": r["correct"],
               "check_seconds": r["check_seconds"], "attempted": r["attempted"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "card": hw.card_state(), "runs": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]},
                      "control_min": {k: min(r["control"][k] for r in rows) for k in rows[0]["control"]}}))


if __name__ == "__main__":
    main()
