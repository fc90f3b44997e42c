"""The readings that `correct`'s limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--out control.jsonl]

For each seed, one run of the cell at its own size and load (a short
window, `--seconds`), then the kept chunks judged twice: the program's
output against the float64 reference (the lower readings), and the
control, the reference computed in float32 with every stage's result
rounded to bfloat16, put in the program's place (the upper readings).
One JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.cell import run_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res, lines = run_cell(args.workload, seed, args.seconds, False,
                                  lambda: time.perf_counter() - t0,
                                  control=torch.bfloat16)
            row = {"workload": args.workload, "seed": seed,
                   "correct": res["correct"], **res["control"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
