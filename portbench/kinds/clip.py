"""Traffic kind "clip": one stream magnified chunk after chunk, as fast as
the card completes them, with the state threaded through the window.

The client sends the ring's frames in order, wrapping at its end, in
chunks of `chunk_frames`, and keeps at most `max_in_flight` chunks queued
on the card (it waits on the oldest chunk's event before it sends
another).  Set-up sends the bootstrap chunk (state None: frame 0 passes
through) and `warm_chunks` steady ones, the cell's only shapes; the
window continues the same stream.

End-to-end: `frames_per_s`, the frames of the chunks whose completion
event lies inside the window, over the window's length.  `attempted`
counts the chunks sent in the window; none fails unless the call raises.
The chunks kept for the check are a reservoir sample, drawn from the
seed, of all chunks sent in the window.
"""

from __future__ import annotations

import random
import time
from collections import deque

from portbench.harness.stream import Kept, Stream, Window, call
from portbench.harness.tracing import host_range


def setup(ctx):
    t = ctx.traffic["chunk_frames"]
    if ctx.ring.shape[0] % t:
        raise ValueError("the ring's length must be a multiple of the "
                         "chunk's")
    s = Stream(offset=0)
    for _ in range(1 + ctx.traffic["warm_chunks"]):
        call(ctx, s, 0, False)
    ctx.marks.sync()
    return {"stream": s, "kept": []}


def window(st, ctx, seconds: float, keep: bool) -> Window:
    marks = ctx.marks
    s = st["stream"]
    rng = random.Random(ctx.seed)
    k = ctx.traffic["check_chunks"]
    chunks = []
    queued = deque()
    t0 = marks.start()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        if len(queued) >= ctx.traffic["max_in_flight"]:
            with host_range("portbench.wait"):
                marks.wait(queued.popleft())
        pos = s.pos
        out, rec = call(ctx, s, 0, ctx.trace)
        queued.append(rec.end)
        chunks.append(rec)
        if keep:
            _reservoir(st["kept"], Kept(0, s.offset, pos, out), len(chunks),
                       k, rng)
    marks.sync()
    return Window(t0, marks.origin, seconds, chunks)


def _reservoir(kept, item, n, k, rng) -> None:
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(n)
        if j < k:
            kept[j] = item


def end_to_end(win: Window, ctx) -> dict:
    t = ctx.traffic["chunk_frames"]
    ms = ctx.marks.ms
    done = sum(1 for c in win.chunks
               if ms(win.origin, c.end) <= win.seconds * 1e3)
    return {"metrics": {"frames_per_s": done * t / win.seconds},
            "attempted": len(win.chunks), "failed": 0,
            "notes": {"chunks_completed_in_window": done,
                      "chunks_sent": len(win.chunks)}}


def kept(st):
    return st["kept"]


def release(st) -> None:
    st["stream"].state = None
