"""Traffic kind "cameras": `cameras` live streams, each sending a chunk of
`chunk_frames` frames every chunk_frames / fps seconds, in an open loop.

Each camera has its own state, bootstrapped in set-up (its first chunk,
frame 0 passing through), and reads the shared ring from an offset of
its own (the ring's chunk slots visited in a stride coprime to their
count).  Camera c's chunk j is due at jitter + period (c / N + j) + u,
u in [-jitter, jitter]: phases evenly staggered.  The jitters are one
fixed set of values, evenly spread over [-jitter, jitter], that the seed
deals out to the chunks in its own order: every seed brings the same
arrivals, differently assigned.  One dispatcher sends each chunk when it
is due (later, when it runs behind) and records an event after the
call.  The cell is out of BENCHMARK.json: its tail follows the host's
stalls, run to run, by more than a bound may hold (PERF.md section 7).

End-to-end, over every chunk due in the window: the completion on the
card minus the time the chunk was due, the completion read from its
event against the event recorded just after the window's opening
synchronize (so neither a waiting thread's wake-up nor the host's clock
enters it, and a dispatcher running late counts against the chunk):
`chunk_p50_ms` and `chunk_p95_ms`.  `attempted` counts the chunks due in
the window; `failed` those not complete by the camera's next due time.
The chunks kept for the check are drawn from the seed before the
window: `check_chunks` chunks over `check_cameras` cameras that read
different ring offsets.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.harness.stream import Kept, Stream, Window, call


def _period(traffic) -> float:
    return traffic["chunk_frames"] / traffic["fps"]


def offsets(traffic, ring_frames: int):
    t = traffic["chunk_frames"]
    slots = ring_frames // t
    stride = next(k for k in range(7, slots + 7) if math.gcd(k, slots) == 1)
    return [((c * stride) % slots) * t for c in range(traffic["cameras"])]


def schedule(traffic, seed: int, seconds: float):
    """(due seconds, camera, chunk ordinal) of every chunk due in
    [0, seconds), sorted by due time: the same for the same seed."""
    n = traffic["cameras"]
    p = _period(traffic)
    jit = traffic["jitter_ms"] / 1e3
    per_cam = int(math.ceil(seconds / p)) + 1
    rng = np.random.default_rng(seed)
    u = rng.permutation(np.linspace(-jit, jit, n * per_cam))
    cam = np.repeat(np.arange(n), per_cam)
    j = np.tile(np.arange(per_cam), n)
    due = jit + p * (cam / n + j) + u
    sel = due < seconds
    order = np.argsort(due[sel], kind="stable")
    return due[sel][order], cam[sel][order], j[sel][order]


def setup(ctx):
    t = ctx.traffic["chunk_frames"]
    r = ctx.ring.shape[0]
    if r % t:
        raise ValueError("the ring's length must be a multiple of the "
                         "chunk's")
    streams = [Stream(offset=o) for o in offsets(ctx.traffic, r)]
    for c, s in enumerate(streams):
        call(ctx, s, c, False)
    for _ in range(ctx.traffic["warm_chunks"]):
        call(ctx, streams[0], 0, False)
    ctx.marks.sync()
    return {"streams": streams, "kept": []}


def _to_keep(ctx, streams, cams, js, seed):
    """{(camera, ordinal)} drawn from the seed: `check_cameras` cameras
    with different ring offsets, the chunks spread evenly over them."""
    rng = np.random.default_rng(seed + 1)
    want = ctx.traffic["check_cameras"]
    chosen, seen = [], set()
    for c in rng.permutation(len(streams)):
        if streams[c].offset not in seen and np.any(cams == c):
            chosen.append(int(c))
            seen.add(streams[c].offset)
        if len(chosen) == want:
            break
    out = set()
    per = -(-ctx.traffic["check_chunks"] // len(chosen))
    for c in chosen:
        ords = js[cams == c]
        for j in rng.choice(ords, size=min(per, len(ords)), replace=False):
            out.add((c, int(j)))
    return out


def window(st, ctx, seconds: float, keep: bool) -> Window:
    marks = ctx.marks
    streams = st["streams"]
    due, cams, js = schedule(ctx.traffic, ctx.seed, seconds)
    wanted = _to_keep(ctx, streams, cams, js, ctx.seed) if keep else set()
    chunks = []
    t0 = marks.start()
    for d, c, j in zip(due.tolist(), cams.tolist(), js.tolist()):
        at = t0 + d
        now = time.perf_counter()
        if at - now > 1e-3:
            time.sleep(at - now - 5e-4)
        while time.perf_counter() < at:
            pass
        s = streams[c]
        pos = s.pos
        out, rec = call(ctx, s, c, ctx.trace)
        rec.due = d
        chunks.append(rec)
        if (c, j) in wanted:
            st["kept"].append(Kept(c, s.offset, pos, out))
    marks.sync()
    return Window(t0, marks.origin, seconds, chunks)


def end_to_end(win: Window, ctx) -> dict:
    p = _period(ctx.traffic)
    ms = ctx.marks.ms
    lat, late, failed = [], [], 0
    next_due = {}
    for c in reversed(win.chunks):
        done_s = ms(win.origin, c.end) / 1e3
        lat.append((done_s - c.due) * 1e3)
        late.append((c.host_in - win.t0 - c.due) * 1e3)
        if done_s > next_due.get(c.stream, c.due + p):
            failed += 1
        next_due[c.stream] = c.due
    lat = np.asarray(lat)
    late = np.asarray(late)
    return {"metrics": {"chunk_p95_ms": float(np.percentile(lat, 95)),
                        "chunk_p50_ms": float(np.percentile(lat, 50))},
            "attempted": len(win.chunks), "failed": failed,
            "notes": {"chunks_due": len(win.chunks),
                      "latency_max_ms": float(lat.max()),
                      "dispatch_late_p50_ms": float(np.percentile(late, 50)),
                      "dispatch_late_p95_ms": float(np.percentile(late, 95)),
                      "dispatch_late_max_ms": float(late.max())}}


def kept(st):
    return st["kept"]


def release(st) -> None:
    for s in st["streams"]:
        s.state = None
