"""The program's own spans and launch counters, read for the per-layer
metrics of a traced run.

`pbmm_tpu_torch.utils.profiling` records spans (`record`, `drain`) and
keeps the kernel wrappers' `.launches` counters (`launch_counts`).  A
metric's reader that reads them calls `arm()` when it is loaded: the
harness loads a traced run's readers before its set-up, so recording
runs through set-up and the window, and arming again starts afresh.
The program records one chunk in 16 (its spans host- and device-timed)
and nothing on the others, so the harness's own readings of the window
stay as they were.  The first `of(run)` (a `LayerRun`) stops recording,
drains the ring and keeps the window's recorded chunks: each
`pbmm.chunk` span that opened after the window's start, with the spans
that share its chunk id.  It also writes the spans'
summary to standard error once.  A program without the recorder (an
older commit) gives no spans, and every metric that reads them None.

Device milliseconds of a span are its CUDA-event pair's (`Marks.ms`);
on the CPU a span gives its host milliseconds, as `Marks` gives the host
clock there.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

STAGES = ("pbmm.frontend", "pbmm.colspec", "pbmm.tail")
LAUNCH = "pbmm.launch."
TABLE = "pbmm.table"

_armed: Optional[dict] = None  # the launch counters at arming


def _recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from pbmm_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("record", "drain")):
        return None
    return profiling


def _counts(rec) -> Optional[dict]:
    fn = getattr(rec, "launch_counts", None)
    return dict(fn()) if fn is not None else None


def arm() -> None:
    """Empty the program's buffer, turn recording on and note the launch
    counters."""
    global _armed
    rec = _recorder()
    if rec is None:
        return
    rec.record(True)
    _armed = {"counts": _counts(rec)}


class Chunk:
    """One call of the program in the window: its root span and the
    spans inside it, in the order they opened."""

    def __init__(self, root, spans):
        self.root = root
        self.spans = spans

    def host_ms(self) -> float:
        return self.root.host_ms()

    def launch_ms(self) -> float:
        return sum((s.host_ms() for s in self.spans
                    if s.name.startswith(LAUNCH)), 0.0)

    def table_ms(self) -> float:
        return sum((s.host_ms() for s in self.spans if s.name == TABLE),
                   0.0)

    def overhead_ms(self) -> float:
        """The recorder's own host time inside the chunk."""
        return (self.root.overhead_ns or 0) / 1e6

    def glue_ms(self) -> float:
        return self.host_ms() - self.launch_ms() - self.overhead_ms()

    def calls(self) -> Optional[int]:
        """The wrappers' launch calls inside the chunk (the change of the
        `.launches` counters' sum over its root span)."""
        return self.root.calls


class ProgramSpans:
    def __init__(self, chunks: List[Chunk], marks, recorded: int,
                 dropped: int, tables: int, since_arm: Optional[dict]):
        self.chunks = chunks
        self.marks = marks
        self.recorded = recorded
        self.dropped = dropped
        self.tables = tables  # `pbmm.table` spans in the window
        self.since_arm = since_arm  # counter changes since arming, by wrapper

    def timed(self, span) -> bool:
        """Whether the span has a device time: its CUDA-event pair on the
        card, its host time on the CPU."""
        if getattr(self.marks, "cuda", False):
            return span.start is not None and span.end is not None
        return True

    def device_ms(self, span) -> float:
        if span.start is not None and span.end is not None:
            return self.marks.ms(span.start, span.end)
        return span.host_ms()

    def stage_device_ms(self, name: str) -> List[float]:
        """Device ms of every timed span `name` in the window's chunks."""
        return [self.device_ms(s) for c in self.chunks for s in c.spans
                if s.name == name and self.timed(s)]

    def calls_per_chunk(self) -> Optional[float]:
        """The wrappers' launch calls over the window's chunks, per
        chunk (each chunk's own change of the counters)."""
        calls = [c.calls() for c in self.chunks]
        if not calls or None in calls:
            return None
        return sum(calls) / len(calls)

    def lines(self, window_t0: float, harness_calls: int) -> List[str]:
        timed = [c for c in self.chunks if self.timed(c.root)]
        out = [f"spans window_chunks {len(self.chunks)} device_timed "
               f"{len(timed)} harness_calls {harness_calls} recorded "
               f"{self.recorded} dropped {self.dropped} "
               f"table_spans_in_window {self.tables}",
               f"spans calls_per_chunk {self.calls_per_chunk()!r} in the "
               f"window; since arming, by wrapper {self.since_arm!r}"]
        between = [self.device_ms(c.root) - sum(
            self.device_ms(s) for s in c.spans if s.name in STAGES)
            for c in timed]
        if between:
            out.append(f"spans device_ms_between_stages total "
                       f"{sum(between)!r} max {max(between)!r}")
        slow = sorted(self.chunks, key=lambda c: -c.host_ms())[:5]
        for i, c in enumerate(slow):
            parts = " ".join(f"{s.name} {s.host_ms():.3f}"
                             for s in c.spans if s is not c.root)
            out.append(
                f"spans slowest {i + 1}: {c.host_ms():.3f} ms at "
                f"{c.root.t0 / 1e9 - window_t0:.3f} s: {parts}; launches "
                f"{c.launch_ms():.3f} tables {c.table_ms():.3f} glue "
                f"{c.glue_ms() - c.table_ms():.3f} recorder "
                f"{c.overhead_ms():.3f}")
        return out


def _read(run) -> Optional[ProgramSpans]:
    global _armed
    rec = _recorder()
    if rec is None or _armed is None:
        return None
    rec.record(False)
    spans, dropped = rec.drain()
    counts = _counts(rec)
    before, _armed = _armed["counts"], None
    since_arm = None
    if counts is not None and before is not None:
        since_arm = {k: v - before.get(k, 0) for k, v in counts.items()
                     if v != before.get(k, 0)}
    by_chunk: Dict[int, list] = {}
    for s in spans:
        if s.chunk is not None:
            by_chunk.setdefault(s.chunk, []).append(s)
    t0_ns = run.win.t0 * 1e9
    chunks = []
    for group in by_chunk.values():
        root = next((s for s in group if s.name == "pbmm.chunk"), None)
        if root is not None and root.t0 >= t0_ns and root.t1 is not None:
            chunks.append(Chunk(root, group))
    tables = sum(1 for s in spans if s.name == TABLE and s.t0 >= t0_ns)
    got = ProgramSpans(chunks, run.marks, len(spans), dropped, tables,
                       since_arm)
    for line in got.lines(run.win.t0, len(run.win.chunks)):
        print(line, file=sys.stderr)
    return got


def of(run) -> Optional[ProgramSpans]:
    """The program's spans of the run's window (read once, then kept on
    the run), or None where the program records none."""
    if "program_spans" not in run.__dict__:
        run.program_spans = _read(run)
    return run.program_spans


def median_per_chunk(run, what: str) -> Optional[float]:
    """Median over the window's chunks of `Chunk.<what>()`."""
    got = of(run)
    if got is None or not got.chunks:
        return None
    return statistics.median(getattr(c, what)() for c in got.chunks)


def stage_roofline_pct(run, span: str, stage: str) -> Optional[float]:
    """A stage's share of its roofline from its span's device time,
    summed over the window's calls, as the stage rooflines compute it
    from the harness's event pairs."""
    got = of(run)
    ms = got.stage_device_ms(span) if got is not None else []
    if not ms:
        return None
    return 100.0 * run.stage_bound_ms(stage) * len(ms) / sum(ms)
