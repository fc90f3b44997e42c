"""The one sweep of a "cameras" cell: the latency and backlog at several
camera counts, to find the highest count the card sustains.

    python3 portbench/sweep.py --workload ref1080.u8_cams8 \\
        --cameras 100,200,300 [--seconds 6] [--seed 7]

For each count: the cell's traffic with that many cameras (set-up
bootstraps each camera's state), one window, and a line with the
latency's median and 95th percentile, the chunks that missed the next
due time, how late the dispatcher ran, and the backlog's trend: the
median latency of the window's last quarter minus its first quarter (a
backlog that grows through the window shows as a large positive
trend).  First, the device milliseconds of one camera chunk alone
(CUDA events behind a spin, `harness/marks.py::device_ms`) and the count
at which the card alone would be saturated.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--cameras", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from pbmm_tpu_torch import magnify_video
    from portbench.harness import spec
    from portbench.harness.cell import Ctx, program_config
    from portbench.harness.inputs import make_ring
    from portbench.harness.marks import Marks, device_ms

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    wl = spec.workload(spec.benchmark(ROOT), args.workload)
    cfg_file = spec.config(wl["config"])
    base = spec.traffic(wl["traffic"])
    kind = spec.kind(base["kind"])
    ring = make_ring(args.seed, base["ring_frames"], cfg_file["height"],
                     cfg_file["width"], base["format"], base["content"], dev)
    marks = Marks(dev)
    cfg = program_config(cfg_file, base)
    t = base["chunk_frames"]
    _, state = magnify_video(ring[:t], cfg)
    one = device_ms(lambda: magnify_video(ring[t:2 * t], cfg, state), 20)
    period_ms = 1e3 * t / base["fps"]
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "chunk_device_ms": one,
                      "card_bound_cameras": period_ms / one}), flush=True)
    for n in (int(x) for x in args.cameras.split(",")):
        traffic = dict(base, cameras=n)
        ctx = Ctx(magnify_video, cfg, ring, traffic, marks, args.seed, True)
        st = kind.setup(ctx)
        win = kind.window(st, ctx, args.seconds, keep=False)
        e2e = kind.end_to_end(win, ctx)
        lat = np.array([marks.ms(win.origin, c.end) - c.due * 1e3
                        for c in win.chunks])
        q = max(1, len(lat) // 4)
        busy = sum(marks.ms(c.start, c.end) for c in win.chunks) / 1e3
        print(json.dumps({
            "cameras": n, **e2e["metrics"], "failed": e2e["failed"],
            "attempted": e2e["attempted"],
            "trend_ms": float(np.median(lat[-q:]) - np.median(lat[:q])),
            "host_ms_median": float(np.median([c.host_s * 1e3
                                               for c in win.chunks])),
            "device_busy_share": busy / args.seconds,
            **e2e["notes"]}), flush=True)
        kind.release(st)
        del st, win
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
