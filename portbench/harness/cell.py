"""One run of one cell: set-up, the measured window, the traced readings,
and the check of `correct`.

`run_cell` returns the result object that `run.py` prints, plus the
lines for standard error.  It takes the program's entry as an argument
(`magnify`, by default `pbmm_tpu_torch.magnify_video`) and a device, so
that the CPU tests drive a whole run at a tiny size, or with the program
broken underneath, without a card.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, List, Optional

import torch

from . import check, spec
from .inputs import make_ring
from .marks import Marks
from .roofline import ChunkWork, bound_ms
from .tracing import StageTimer, profile_window

PROFILE_SECONDS = 2.0  # the traced run's profiled window, after the window


@dataclasses.dataclass
class Ctx:
    magnify: Callable
    cfg: Any  # the program's MagnifyConfig
    ring: torch.Tensor
    traffic: dict
    marks: Marks
    seed: int
    trace: bool


class LayerRun:
    """What a per-layer metric's reader reads: the window's chunks (host
    seconds of each call, markers before and after it), the timed
    entries' device milliseconds, and the cell's least work."""

    def __init__(self, win, marks, stages: Optional[StageTimer],
                 work: ChunkWork):
        self.win = win
        self.marks = marks
        self.stages = stages
        self.work = work

    def host_ms(self) -> List[float]:
        return [c.host_s * 1e3 for c in self.win.chunks]

    def entry_device_ms(self, entry: str) -> List[float]:
        return self.stages.device_ms(entry) if self.stages else []

    def chunk_device_ms(self) -> List[float]:
        return [self.marks.ms(c.start, c.end) for c in self.win.chunks
                if c.start is not None]

    def chunk_intervals(self) -> List[tuple]:
        """(start, end) seconds of each chunk on the card, from the
        window's start."""
        o, ms = self.win.origin, self.marks.ms
        return [(ms(o, c.start) / 1e3, ms(o, c.end) / 1e3)
                for c in self.win.chunks if c.start is not None]

    def covered_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi) that some chunk's interval on the card
        covers (chunks on one stream run one after another)."""
        total, end = 0.0, lo
        for a, b in sorted(self.chunk_intervals()):
            a, b = max(a, end), min(b, hi)
            if b > a:
                total += b - a
                end = b
        return total

    def stage_bound_ms(self, stage: str) -> float:
        return bound_ms(*self.work.stage(stage))

    def chunk_bound_ms(self) -> float:
        return bound_ms(*self.work.chunk())


class GcPauses:
    """The garbage collector's pauses while the block runs."""

    def __init__(self):
        self.pauses = []
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def notes(self) -> dict:
        full = [p for g, p in self.pauses if g == 2]
        return {"gc_collections": len(self.pauses),
                "gc_full": len(full),
                "gc_pause_max_ms": 1e3 * max((p for _, p in self.pauses),
                                             default=0.0)}


def program_config(cfg_file: dict, traffic: dict):
    from pbmm_tpu_torch import MagnifyConfig
    from pbmm_tpu_torch.config import TemporalConfig

    fields = dict(cfg_file["magnify"])
    fields["temporal"] = TemporalConfig(**fields["temporal"])
    return MagnifyConfig(**fields).replace(
        output_layout=traffic["output_layout"])


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             since_start: Callable[[], float], device="cuda",
             bench: Optional[dict] = None, cfg_file: Optional[dict] = None,
             traffic: Optional[dict] = None, limits: Optional[dict] = None,
             magnify: Optional[Callable] = None,
             control: Optional[torch.dtype] = None):
    """-> (result dict, stderr lines).  `bench`, `cfg_file`, `traffic`
    and `limits` default to the files the cell's name finds.  With
    `control` (a dtype) the reference in that precision is also put in
    the program's place on the same kept chunks, and its numbers judged
    under the key "control" (`control.py`; the benchmark's own runs do
    not run it)."""
    bench = bench if bench is not None else spec.benchmark()
    wl = spec.workload(bench, cell)
    cfg_file = cfg_file or spec.config(wl["config"])
    traffic = traffic or spec.traffic(wl["traffic"])
    limits = limits or spec.limits(cell)
    if magnify is None:
        from pbmm_tpu_torch import magnify_video as magnify
    dev = torch.device(device)
    h, w = cfg_file["height"], cfg_file["width"]
    kind = spec.kind(traffic["kind"])
    readers = {}
    if trace:
        readers = {m["name"]: spec.metric_reader(m["name"])
                   for m in spec.cell_metrics(bench, cell, True)}
    marks = Marks(dev)
    stages = None
    if trace:
        stages = StageTimer(marks, [r.ENTRY for r in readers.values()
                                    if getattr(r, "ENTRY", None)])
        stages.install()
    try:
        marks.sync()
        t_entry = since_start()
        ring = make_ring(seed, traffic["ring_frames"], h, w,
                         traffic["format"], traffic["content"], dev)
        marks.sync()
        t_ring = since_start()
        ctx = Ctx(magnify, program_config(cfg_file, traffic), ring, traffic,
                  marks, seed, trace)
        st = kind.setup(ctx)
        # What set-up left on the heap (the interpreter's, torch's and the
        # program's modules) goes to the permanent generation, so that a
        # full collection in the window scans only what the window makes.
        gc.collect()
        gc.freeze()
        setup_s = since_start()
        if stages:
            stages.active = True
        with GcPauses() as pauses:
            win = kind.window(st, ctx, seconds, keep=True)
        if stages:
            stages.active = False
        e2e = kind.end_to_end(win, ctx)
        e2e["notes"].update(pauses.notes(), host_call_max_ms=max(
            c.host_s for c in win.chunks) * 1e3)
        prof = None
        if trace:
            layer = LayerRun(win, marks, stages, ChunkWork(
                cfg_file["magnify"], h, w, traffic["chunk_frames"],
                traffic["format"], traffic["output_layout"]))
            values = {name: r.read(layer) for name, r in readers.items()}
            stages.active = True  # names the host's ranges in the trace
            traced = []
            prof = profile_window(lambda: traced.append(
                kind.window(st, ctx, PROFILE_SECONDS, keep=False)))
            stages.active = False
            if prof["device_events"] == 0:
                # The profiler recorded no device event: the chunks'
                # event intervals give the busy time instead.
                tl = LayerRun(traced[0], marks, None, layer.work)
                prof["busy_s"] = tl.covered_s(0.0, float("inf"))
                prof["busy_source"] = "chunk events"
    finally:
        if stages:
            stages.uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = kind.kept(st)
    kind.release(st)
    del st, win
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    measured = check.measure(kept, ring, cfg_file["magnify"], traffic, h, w,
                             dev)
    correct, rows = check.judge(measured, limits)
    check_s = time.perf_counter() - t_check
    if control is not None:
        low = check.measure(kept, ring, cfg_file["magnify"], traffic, h, w,
                            dev, store=control)

    lines = [f"cell {cell} seed {seed} seconds {seconds} trace {int(trace)}",
             f"device {_device_name(dev)}",
             f"setup_s {setup_s!r} (to the harness {t_entry!r}, frames "
             f"{t_ring - t_entry!r}, warm-up {setup_s - t_ring!r}) "
             f"check_s {check_s!r} kept "
             f"{[(k.stream, k.pos) for k in kept]}",
             "window " + " ".join(f"{k} {v!r}"
                                  for k, v in e2e["notes"].items()),
             "measured " + " ".join(f"{k} {v!r}" for k, v in measured.items())]
    if trace:
        metrics = {}
        for m in spec.cell_metrics(bench, cell, True):
            v = values[m["name"]]
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lines.append("per-layer " + " ".join(f"{k} {v!r}"
                                             for k, v in values.items()))
        lines.append(f"profiler device_events {prof['device_events']} "
                     f"busy_s {prof['busy_s']!r} window_s {prof['window_s']!r}"
                     f" busy from {prof.get('busy_source', 'the trace')}")
    else:
        produced = dict(e2e["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": produced[m["name"]], "unit": m["unit"]}
                   for m in spec.cell_metrics(bench, cell, False)}
    device_obj = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": _device_name(dev),
                  "count": wl["chips"] if dev.type == "cuda" else 0,
                  "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": e2e["attempted"],
              "failed": e2e["failed"], "metrics": metrics,
              "device": device_obj}
    if trace:
        device_obj["busy_s"] = prof["busy_s"]
        device_obj["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    if control is not None:
        result["control"] = {"correct": check.judge(low, limits)[0],
                             "measured": low, "program": measured}
    result["checks"] = {name: {"value": check.finite(v), "limit": lim}
                        for name, v, _, lim, _ in rows}
    lines += [f"check {name} {v!r} {rule} {lim!r} {'ok' if ok else 'FAIL'}"
              for name, v, rule, lim, ok in rows]
    return result, lines


def _device_name(dev) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type

