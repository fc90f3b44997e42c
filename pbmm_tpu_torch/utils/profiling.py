"""Tracing and timing helpers (counterpart of `pbmm_tpu/utils/profiling.py`).

- `trace(logdir)`: `torch.profiler` around the block (CUDA activity on a
  card), a Chrome trace written into `logdir`.
- `scope(name)`: a `torch.profiler.record_function` range.  The pipeline
  opens one per stage under the JAX package's `jax.named_scope` names
  (`pbmm.preprocess`, `pbmm.fft`, `pbmm.phase_amplify`, `pbmm.ifft`,
  `pbmm.phase_ifft_fused`, `pbmm.blur`, `pbmm.colspec_chunk`), so a trace
  groups device time by stage; never one per kernel launch.
- `device_ms`: median device time of a launch by CUDA events, with a
  spin of the card queued ahead of each event pair so the host's enqueue
  falls outside it; `timeit`: median seconds of a call, by `device_ms`
  on a card.
- `stage_times`: median seconds of the per-frame stages (pre + FFT, the
  band/phase pass, the inverse + post) over a frame batch.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict

import numpy as np
import torch


def scope(name: str):
    """A profiler range named `name` while a profiler runs, else a no-op
    context (no range is built on the hot path)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


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


# A spin of the card ahead of each timed launch (~0.1 ms at the H100's
# clocks) covers the host's enqueue of the launch.
_SPIN_CYCLES = 200_000


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
