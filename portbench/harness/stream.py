"""What the traffic kinds share: one stream of chunks through the
program's entry, the record of each call, and the chunks kept for the
check of `correct`."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

from .tracing import host_range


@dataclasses.dataclass
class Stream:
    """One client's stream: its ring offset, the stream position of the
    next frame it sends, and the program's state it threads."""

    offset: int
    pos: int = 0
    state: Any = None


@dataclasses.dataclass
class Chunk:
    """One call of the program's entry in a window."""

    stream: int  # index of the stream (a camera; 0 for a clip)
    pos: int  # stream position of its first frame
    host_in: float  # host clock at the call
    host_s: float  # host seconds in the call
    end: Any  # marker recorded after the call
    start: Any = None  # marker recorded before it (traced runs)
    due: Optional[float] = None  # seconds after the window's start


@dataclasses.dataclass
class Kept:
    """A chunk's output kept for the check, with where its frames came
    from."""

    stream: int
    offset: int
    pos: int
    output: Any


@dataclasses.dataclass
class Window:
    t0: float  # host clock at the window's start
    origin: Any  # marker recorded just after the opening synchronize
    seconds: float
    chunks: List[Chunk]


def call(ctx, s: Stream, idx: int, start_mark: bool):
    """Send the stream's next chunk through the program; returns (the
    output, the call's record).  The chunk is a view of the ring: the
    ring's length is a multiple of the chunk's, so a chunk never wraps."""
    t = ctx.traffic["chunk_frames"]
    r = ctx.ring.shape[0]
    first = (s.offset + s.pos) % r
    frames = ctx.ring[first:first + t]
    start = ctx.marks.mark() if start_mark else None
    with host_range("portbench.call"):
        h0 = time.perf_counter()
        out, s.state = ctx.magnify(frames, ctx.cfg, s.state)
        h = time.perf_counter() - h0
    rec = Chunk(idx, s.pos, h0, h, ctx.marks.mark(), start)
    s.pos += t
    return out, rec
