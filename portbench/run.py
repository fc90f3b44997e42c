"""Run one cell of the benchmark of `pbmm_tpu_torch` on an NVIDIA card.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the repository's root.  Set-up makes the cell's frames on the card
from the seed and warms the program's shapes; the window then measures
for `--seconds` seconds; the chunks kept from it are checked against the
float64 reference.  The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and `checks`, each compared number beside its limit); the
last lines of standard error repeat the compared numbers.  With
`--trace 0` the metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics.

Exits 2 without printing a result when no CUDA card (or fewer than the
cell asks for) is present, and 3 when a module of JAX or of the JAX
package is loaded once the window has closed.  The program builds its
kernel library into `build/pbmm_tpu_torch/` inside the checkout at the
first run; the caches of PyTorch's extensions and of Triton are fixed to
`build/portbench/` there too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pbmm_tpu")


def _process_start_offset() -> float:
    """Seconds from this process's start to this module's import, from
    /proc (the start in clock ticks after boot), else 0."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        now = time.clock_gettime(time.CLOCK_BOOTTIME)
        offset = now - started - (time.perf_counter() - _T_IMPORT)
    except (OSError, ValueError, IndexError):
        return 0.0
    return offset if 0.0 <= offset < 60.0 else 0.0


_OFFSET = _process_start_offset()


def since_start() -> float:
    """Seconds since the process started."""
    return _OFFSET + time.perf_counter() - _T_IMPORT


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import spec
    from portbench.harness.cell import run_cell

    wl = spec.workload(spec.benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), since_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
