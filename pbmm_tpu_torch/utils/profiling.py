"""Tracing and timing helpers (counterpart of `pbmm_tpu/utils/profiling.py`).

- `scope(name)`: the program's span at a layer boundary.  Off (the
  default) it checks the recording flags and whether a profiler runs,
  and returns one shared no-op context: no event, no range, nothing
  allocated.  While `torch.profiler` runs it opens the
  `torch.profiler.record_function` range `name`, on the profiler's own
  timeline.  While recording is on (`record(True)`), one chunk in
  `EVERY` (the first after `record(True)`, then every `EVERY`-th) is
  recorded: its root and every span inside it go into a ring of
  `CAPACITY` slots (the oldest overwritten and counted as dropped), read
  by `drain()` as `Span`s: the name, the span's id and its parent's (a
  per-thread stack), the chunk's id (its root's), host start and end
  (`time.perf_counter_ns`), and, for a span given `timed=` a CUDA
  tensor, a pair of timing events on that device's current stream.  A
  root also notes the `.launches` counters' sum at its start and end
  (`Span.calls`) and the recorder's own host time inside it
  (`Span.overhead_ns`: its spans' bookkeeping and events).  The other
  chunks, and spans outside any chunk, record nothing, so the calls that
  are not sampled cost what they cost with recording off (one thread
  records at a time: a recorded chunk records every thread's spans); the
  ring is flat integer arrays, so a recorded span leaves no object for
  the garbage collector to scan.
  The spans: `pbmm.chunk` (`engine/video.py::magnify_video`, the root of
  each call), `pbmm.frontend`, `pbmm.colspec`, `pbmm.tail`
  (`_chunk_colspec`, around its three stages), all four device-timed;
  host-only `pbmm.launch.<entry>` around every call into the kernel
  library (`kernels/build.py::library`) and `pbmm.table` around a device
  table's build (`kernels.device_arrays`, `device_ints`: a cache miss).
  The scan engine's stages keep the JAX package's `jax.named_scope` names
  (`pbmm.preprocess`, `pbmm.fft`, `pbmm.phase_amplify`, `pbmm.ifft`,
  `pbmm.phase_ifft_fused`, `pbmm.blur`).
- `counted(wrapper)`: a kernel wrapper's `.launches` counter, set to 0
  and registered once at import; `launch_counts()`: every registered
  counter as {wrapper name: launches} (the three probes of `tools/`
  appear once imported).
- `trace(logdir)`: `torch.profiler` around the block (CUDA activity on a
  card), a Chrome trace written into `logdir`.
- `device_ms`: median device time of a launch by CUDA events, with a
  spin of the card queued ahead of each event pair so the host's enqueue
  falls outside it; `timeit`: median seconds of a call, by `device_ms`
  on a card.
- `stage_times`: median seconds of the per-frame stages (pre + FFT, the
  band/phase pass, the inverse + post) over a frame batch.
"""

from __future__ import annotations

import array
import contextlib
import itertools
import operator
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CAPACITY = 1 << 17  # spans the ring holds before it overwrites the oldest
EVERY = 16  # one chunk in this many is recorded

# The ring: one array a field, slot = id % CAPACITY.  `_IDS[slot]` is the
# id of the span written there (0: empty), `_NAME[slot]` twice its name's
# index, plus 1 for a chunk's root, `_PARENT[slot]` its parent's id (-1:
# none), `_C0`, `_C1`, `_OV` a root's launch sums and overhead; a `_T1`
# below the slot's `_T0` (a former span's) marks a span still open.  Ids
# since the ring was last emptied are those above `_base`.
_recording = False  # record(True) was called
_active = False  # a recorded chunk is open
_ids = itertools.count(1)
_chunks = itertools.count()
_events: Dict[int, list] = {}  # id -> [start, end] of device-timed spans
_name_ids: Dict[str, int] = {}
_names: List[str] = []
_intern_lock = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()
_COUNTED: Dict[str, Callable] = {}
_LAUNCHES = operator.attrgetter("launches")
_profiler_enabled = torch.autograd._profiler_enabled
_now = time.perf_counter_ns


def _empty_ring() -> None:
    global _IDS, _NAME, _PARENT, _T0, _T1, _C0, _C1, _OV, _base
    (_IDS, _NAME, _PARENT, _T0, _T1, _C0, _C1, _OV) = (
        array.array("q", bytes(8 * CAPACITY)) for _ in range(8))
    _base = next(_ids)
    _events.clear()


_empty_ring()


class Span:
    """One span as `drain()` returns it.  `t0`, `t1`:
    `time.perf_counter_ns()` at its start and end (`t1` None while it is
    open); `start`, `end`: its CUDA events (None for a span not
    device-timed); for a chunk's root, `calls`: the `.launches` counters'
    sum's change over it, and `overhead_ns`: the recorder's host time
    inside it (None on other spans)."""

    __slots__ = ("name", "id", "parent", "chunk", "t0", "t1", "start",
                 "end", "calls", "overhead_ns")

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class _Open:
    """A span being recorded: the context `scope` returns inside a
    recorded chunk.  `_over` gathers the recorder's host time inside the
    span (its descendants' bookkeeping), which each span hands to its
    parent with its own, from `scope`'s call to its start and from its
    end to its close, when it closes."""

    __slots__ = ("_name", "_timed", "_root", "id", "slot", "stream",
                 "_ev", "_range", "_stack", "_over", "_in", "_was")

    def __init__(self, name: str, timed, root: bool, made: int):
        self._name = name
        self._timed = timed
        self._root = root
        self._in = made

    def __enter__(self):
        global _active
        try:
            stack = self._stack = _local.stack
        except AttributeError:
            stack = self._stack = _local.stack = []
        n = self.id = next(_ids)
        i = self.slot = n % CAPACITY
        if n - _base > CAPACITY:
            _events.pop(n - CAPACITY, None)
        self.stream = self._ev = self._range = None
        self._over = 0
        timed = self._timed
        if self._root:
            self._was, _active = _active, True
            _C0[i] = _launch_sum()
            if timed is not None and timed.is_cuda:
                self.stream = torch.cuda.current_stream(timed.device)
        elif stack and timed is not None:
            self.stream = stack[-1].stream
        _IDS[i] = n
        k = _name_ids.get(self._name)
        _NAME[i] = (k if k is not None else _intern(self._name)) + self._root
        _PARENT[i] = stack[-1].id if stack else -1
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        stack.append(self)
        if self.stream is not None:
            self._ev = _events[n] = [_event(self.stream), None]
        t0 = _T0[i] = _now()
        self._in = t0 - self._in
        return self

    def __exit__(self, *exc):
        global _active
        t1 = _now()
        if self._ev is not None:
            self._ev[1] = _event(self.stream)
        i = self.slot
        mine = _IDS[i] == self.id
        if mine:
            _T1[i] = t1
        stack = self._stack
        stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._root:
            _active = self._was
            if mine:
                _C1[i] = _launch_sum()
                _OV[i] = self._over
        elif stack:
            stack[-1]._over += self._over + self._in + _now() - t1
        return False


def _intern(name: str) -> int:
    with _intern_lock:
        if name not in _name_ids:
            _name_ids[name] = 2 * len(_names)
            _names.append(name)
        return _name_ids[name]


def _event(stream) -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def _launch_sum() -> int:
    return sum(map(_LAUNCHES, _COUNTED.values()))


def scope(name: str, timed: Optional[torch.Tensor] = None,
          chunk: bool = False):
    """The span `name` (see the module's docstring).  `timed`: a tensor
    on the device whose current stream the span's events time (CUDA
    tensors only; a CPU tensor or None gives a host-only span); `chunk`:
    the span is a chunk's root, which the spans inside it share."""
    if _active:
        return _Open(name, timed, chunk, _now())
    if chunk and _recording and next(_chunks) % EVERY == 0:
        return _Open(name, timed, True, _now())
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def record(on: bool) -> None:
    """Turn the recording of spans on (with an empty ring, the next chunk
    recorded) or off (the ring kept for `drain()`)."""
    global _recording, _chunks
    if on:
        _empty_ring()
        _chunks = itertools.count()
    _recording = bool(on)


def drain() -> Tuple[List[Span], int]:
    """The ring's spans in the order they opened, and how many it
    dropped since it was last emptied; empties it.  A span's chunk is
    its root's id (None where the ring dropped the root)."""
    ids, events = _IDS, dict(_events)
    last = max(ids)
    dropped = max(0, last - _base - CAPACITY)
    spans, by_id = [], {}
    for i in sorted((i for i, n in enumerate(ids) if n),
                    key=ids.__getitem__):
        s = Span()
        s.id = ids[i]
        root = _NAME[i] & 1
        s.name = _names[_NAME[i] >> 1]
        s.parent = _PARENT[i] if _PARENT[i] >= 0 else None
        s.t0 = _T0[i]
        s.t1 = _T1[i] if _T1[i] >= _T0[i] else None
        s.start, s.end = events.get(s.id, (None, None))
        done = root and s.t1 is not None
        s.calls = _C1[i] - _C0[i] if done else None
        s.overhead_ns = _OV[i] if done else None
        up = by_id.get(s.parent)
        s.chunk = s.id if root else up.chunk if up else None
        by_id[s.id] = s
        spans.append(s)
    _empty_ring()
    return spans, dropped


def counted(wrapper: Callable) -> Callable:
    """Register a kernel wrapper's launch counter: `wrapper.launches`,
    which the wrapper adds 1 to at each launch, starts at 0."""
    wrapper.launches = 0
    _COUNTED[wrapper.__name__] = wrapper
    return wrapper


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches} of every registered counter."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU, and CUDA when a card is present)
    and write a Chrome trace, `pbmm_trace_<pid>.json`, into `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"pbmm_trace_{os.getpid()}.json"))


# A spin of the card ahead of each timed launch (~1 ms at the H100's
# clocks) covers the host's enqueue of the launch: a wrapper that packs
# its arguments on the host (kernel 6's) takes 0.1-0.3 ms.
_SPIN_CYCLES = 2_000_000


def device_ms(run, reps: int, before=None) -> float:
    """Median of `reps` CUDA-event timings of run() on the current card;
    `before()` runs ahead of each timed launch, outside its event pair,
    then a spin of the card that lasts longer than the host takes to
    enqueue run(), so the device does not wait on the host inside the
    pair (an event pair around one launch on an idle card times the
    enqueue too).  All pairs are queued before one synchronisation."""
    pairs = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def timeit(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median seconds of fn(*args): the device's time (`device_ms`) when
    an argument lies on a card, else the host clock (CPU tensors or
    none)."""
    dev = next((t.device for t in _tensors(args) if t.is_cuda), None)
    for _ in range(warmup):
        fn(*args)
    times = []
    if dev is None:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        return device_ms(lambda: fn(*args), reps) / 1e3


def stage_times(frames, cfg, device=None, reps: int = 3) -> Dict[str, float]:
    """Per-stage median seconds for one (T, H, W, 3) frame batch on
    `device` (default: the first CUDA card), each frame against its
    predecessor (frame 0 against itself): the JAX function's keys."""
    from pbmm_tpu_torch.engine.pipeline import (
        amplify_spectrum,
        on_device,
        postprocess,
        preprocess,
    )

    frames = on_device(frames, device)
    specs, yiq = preprocess(frames, cfg)
    prev = torch.cat([specs[:1], specs[:-1]], dim=0)
    mod = amplify_spectrum(specs, prev, cfg)[0]
    return {
        "preprocess_fft": timeit(lambda f: preprocess(f, cfg), frames,
                                 reps=reps),
        "phase_amplify": timeit(
            lambda c, p: amplify_spectrum(c, p, cfg)[0], specs, prev,
            reps=reps),
        "ifft_postprocess": timeit(lambda m, y: postprocess(m, y, cfg),
                                   mod, yiq, reps=reps),
    }
