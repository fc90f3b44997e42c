"""Device timestamps without a synchronize inside the window.

`Marks.mark()` records a CUDA event on the current stream (on the CPU,
where every operation has finished when the call returns, the host
clock).  A window starts with `start()`: a synchronize, the host clock,
and one event just after it, so that any later event maps to the host
clock as `t0 + elapsed(origin, event)`.

`device_ms` is a frozen copy of `pbmm_tpu_torch/utils/profiling.py::
device_ms` at commit 46ab5a86602a (the method of `tools/kexp.py::timed`):
CUDA-event pairs, each behind a spin of the card long enough to cover
the host's enqueue, all queued before one synchronize.
"""

from __future__ import annotations

import statistics
import time

import torch

# A spin of the card ahead of each timed launch (~1 ms at the H100's
# clocks) covers the host's enqueue of the launch.
_SPIN_CYCLES = 2_000_000


class Marks:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.t0 = 0.0
        self.origin = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def start(self) -> float:
        """Open a window: returns its host start time."""
        self.sync()
        self.t0 = time.perf_counter()
        self.origin = self.mark()
        return self.t0

    def ms(self, a, b) -> float:
        """Milliseconds from marker a to marker b (both complete)."""
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3


def device_ms(run, reps: int, before=None) -> float:
    """Median of `reps` CUDA-event timings of run() on the current card;
    `before()` runs ahead of each timed launch, outside its event pair,
    then a spin of the card that lasts longer than the host takes to
    enqueue run(), so the device does not wait on the host inside the
    pair.  All pairs are queued before one synchronisation."""
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
