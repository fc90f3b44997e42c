"""The traced run's instruments: CUDA-event pairs around the program's
layer entries, and the profiler over a short window of its own.

`StageTimer` wraps each entry that a per-layer metric's reader names
(`module:attribute`, looked up in the module's globals at call time,
as `engine/video.py::_chunk_colspec` looks up `preprocess_cl`,
`colspec_chunk` and `_tail_block`): a marker before and after each call
and the host's seconds inside it.  No synchronize happens inside the
window; the pairs are read once it has closed.

`profile_window` runs the profiler (CPU and CUDA activity) around a
callable and reads its Chrome trace: the device's busy seconds (the
union of its kernels, copies and sets), the kernels that took most time,
and the longest idle gaps, each named by the harness range the host was
in when it launched the operation that ended the gap.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def host_range(name: str):
    """A profiler range named `name` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class StageTimer:
    def __init__(self, marks, entries):
        self.marks = marks
        self.entries = sorted(set(entries))
        self.calls: Dict[str, List[tuple]] = {e: [] for e in self.entries}
        self.active = False
        self._saved = []

    def install(self) -> None:
        for entry in self.entries:
            mod_name, attr = entry.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(entry, orig))

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, entry, orig):
        label = "portbench." + entry.split(":")[1]

        def timed(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            with host_range(label):
                before = self.marks.mark()
                h0 = time.perf_counter()
                out = orig(*args, **kwargs)
                h1 = time.perf_counter()
                after = self.marks.mark()
            self.calls[entry].append((before, after, h1 - h0))
            return out

        return timed

    def device_ms(self, entry: str) -> List[float]:
        return [self.marks.ms(a, b) for a, b, _ in self.calls.get(entry, [])]


def profile_window(run, top: int = 10) -> dict:
    """Profile run() (which ends with the device idle) and read the
    trace.  Returns busy_s, window_s, device_ops, idle_gaps and the
    number of device operations seen."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run()
        window_s = time.perf_counter() - w0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
    finally:
        os.remove(path)
    return {**read_trace(events, top), "window_s": window_s}


def read_trace(events: list, top: int = 10) -> dict:
    """busy_s, device_ops and idle_gaps from a Chrome trace's events."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in _DEVICE_CATS),
                 key=lambda e: e["ts"])
    launches = {}
    ranges = []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            launches[corr] = e["ts"]
        elif (e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("portbench.")):
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    busy_us = 0.0
    end = None
    gaps = []
    by_name = defaultdict(float)
    for e in dev:
        s, d = e["ts"], e["dur"]
        by_name[str(e["name"])[:120]] += d / 1e6
        if end is not None and s > end:
            gaps.append(((s - end) / 1e6,
                         (e.get("args") or {}).get("correlation")))
        if end is None or s >= end:
            busy_us += d
            end = s + d
        elif s + d > end:
            busy_us += s + d - end
            end = s + d
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_at(launches.get(corr), ranges), s]
                          for s, corr in gaps[:top]],
            "device_events": len(dev)}


def _host_at(ts, ranges) -> str:
    """The innermost harness range holding host time `ts`."""
    if ts is None:
        return "host: launch not in trace"
    best = None
    for a, b, name in ranges:
        if a <= ts <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return "host: " + (best[2] if best else "outside the harness's ranges")
