"""Tiny versions of the benchmark's cells for the CPU tests: the cell's
own configuration, mix and limits at 72x120 frames, a ring of 24 frames
and chunks of at most 4."""

from __future__ import annotations

import time

from portbench.harness import spec
from portbench.harness.cell import run_cell


# The cameras cell is kept out of BENCHMARK.json (PERF.md section 7), and
# its kind and mix stay tested here.
CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + [
    "ref1080.u8_cams8"]


def tiny(cell: str):
    """(bench, config, traffic) of the cell named <config>.<traffic>, with
    the cell in `bench`'s workloads."""
    bench = spec.benchmark()
    name, mix = cell.split(".")
    if cell not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": mix, "chips": 1, "why": ""})
    cfg = spec.config(name)
    cfg["height"], cfg["width"] = 72, 120
    tr = spec.traffic(mix)
    tr["ring_frames"] = 24
    tr["chunk_frames"] = min(tr["chunk_frames"], 4)
    tr["content"] = dict(tr["content"], bar_width=2.0, blob_sigma=6.0)
    if tr["kind"] == "cameras":
        tr["cameras"] = 4
    return bench, cfg, tr


def run_tiny(cell: str, seed: int = 5, seconds: float = 0.4, **kw):
    bench, cfg, tr = tiny(cell)
    t0 = time.perf_counter()
    return run_cell(cell, seed, seconds, False,
                    lambda: time.perf_counter() - t0, device="cpu",
                    bench=bench, cfg_file=cfg, traffic=tr, **kw)
