"""The port's span recorder and launch counters
(`pbmm_tpu_torch/utils/profiling.py`), on the CPU:

- recording off records nothing, and `magnify_video`'s outputs and state
  are the same bits with it on and off (a 72x120 uint8 clip, y_only, and
  an rgb + IIR clip, both through the batched chunk engine);
- recording on gives each recorded call one `pbmm.chunk` root with
  `pbmm.frontend`, `pbmm.colspec` and `pbmm.tail` in that order, inside
  its host interval and sharing its chunk id, a new id a call; one
  chunk in `profiling.EVERY` is recorded (every chunk in the other
  tests), nothing outside a recorded chunk;
- a root notes the recorder's own host time inside it;
- the ring's bound drops the oldest span and counts the drop, and the
  ring holds no object for the garbage collector;
- a chunk's root counts the wrappers' launch calls inside it;
- a library entry (`kernels/build.py::Library`, here on a stub) gets a
  `pbmm.launch.<entry>` span and returns its value unchanged;
- `pbmm.table` spans a device table's build, once a cache miss;
- `launch_counts` lists every `.launches` counter that is imported;
- the benchmark's reader `colspec_copied_pct.clip` gives the share of
  kernel 2's calls that `colspec_chunk.copied` counted since it loaded
  (moved by hand here, where kernel 2 makes no call), and None without
  a call or without the counter.

CUDA events (the device-timed spans) exist only on a card:
`tests/test_torch_cuda.py` checks them there."""

import gc
import itertools
import sys
import types

import numpy as np
import pytest
import torch

from pbmm_tpu_torch.config import MagnifyConfig, TemporalConfig
from pbmm_tpu_torch.engine.video import magnify_video
from pbmm_tpu_torch.kernels import build, device_arrays, device_ints
from pbmm_tpu_torch.utils import profiling

STAGES = ["pbmm.frontend", "pbmm.colspec", "pbmm.tail"]


@pytest.fixture(autouse=True)
def _recording_off(monkeypatch):
    """One intra-op thread (the suite runs in parallel workers), every
    chunk recorded, and the recorder off with an empty ring around each
    test."""
    monkeypatch.setattr(profiling, "EVERY", 1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.record(False)
    profiling.drain()
    yield
    profiling.record(False)
    profiling.drain()
    torch.set_num_threads(n)


def _case(name):
    """(config, frames) of a clip of 5 frames through the batched engine."""
    cfg = MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight")
    rng = np.random.default_rng(19)
    if name == "u8":
        frames = rng.integers(0, 256, (5, 3, 72, 120), dtype=np.uint8)
        cfg = cfg.replace(output_layout="planar_u8")
    else:
        frames = rng.random((5, 72, 120, 3), dtype=np.float32)
        cfg = cfg.replace(chroma="rgb", temporal=TemporalConfig(
            mode="iir_bandpass", low_hz=0.4, high_hz=3.0, fps=30.0))
    return cfg, torch.from_numpy(frames)


def _stream(cfg, frames):
    """The clip in three calls (frame 0, then two chunks of two), the
    state threaded: the outputs and the last state."""
    outs, state = [], None
    for a, b in ((0, 1), (1, 3), (3, 5)):
        out, state = magnify_video(frames[a:b], cfg, state)
        outs.append(out)
    return outs, state


def _leaves(state):
    return [state.prev_spec_re, state.prev_spec_im, state.prev_frame,
            *state.temporal]


@pytest.mark.parametrize("case", ["u8", "rgb_iir"])
def test_recording_changes_no_bit(case):
    cfg, frames = _case(case)
    off_outs, off_state = _stream(cfg, frames)
    assert profiling.drain() == ([], 0)
    profiling.record(True)
    on_outs, on_state = _stream(cfg, frames)
    profiling.record(False)
    spans, dropped = profiling.drain()
    assert spans and dropped == 0
    for a, b in zip(off_outs + _leaves(off_state),
                    on_outs + _leaves(on_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert off_state.frame_idx == on_state.frame_idx == 5


@pytest.mark.parametrize("case", ["u8", "rgb_iir"])
def test_each_call_is_one_chunk_of_three_stages(case):
    cfg, frames = _case(case)
    profiling.record(True)
    _stream(cfg, frames)
    profiling.record(False)
    spans, _ = profiling.drain()
    roots = [s for s in spans if s.name == "pbmm.chunk"]
    assert len(roots) == 3
    assert all(r.parent is None for r in roots)
    assert len({r.chunk for r in roots}) == 3
    for root in roots:
        mine = [s for s in spans if s.chunk == root.chunk]
        assert mine[0] is root
        stages = [s for s in mine if s.parent == root.id]
        assert [s.name for s in stages] == STAGES
        for s in mine:
            assert root.t0 <= s.t0 <= s.t1 <= root.t1
            assert s.start is None and s.end is None  # CPU: host-only
        for a, b in zip(stages, stages[1:]):
            assert a.t1 <= b.t0


def test_buffer_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.record(True)
    with profiling.scope("pbmm.test0", chunk=True):
        for i in range(1, 5):
            with profiling.scope(f"pbmm.test{i}"):
                pass
    spans, dropped = profiling.drain()
    # The root's slot went to a newer span: its end is not written there.
    assert [s.name for s in spans] == ["pbmm.test2", "pbmm.test3",
                                       "pbmm.test4"]
    assert all(s.t1 is not None and s.calls is None for s in spans)
    assert dropped == 2
    assert profiling.drain() == ([], 0)


def test_ring_holds_nothing_for_the_collector():
    timed = torch.zeros(1)
    profiling.record(True)
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(1000):
        with profiling.scope("pbmm.chunk", timed=timed, chunk=True):
            with profiling.scope("pbmm.launch.x"):
                pass
    profiling.record(False)
    gc.collect()
    assert len(gc.get_objects()) - before < 50
    for a in (profiling._IDS, profiling._T0, profiling._T1):
        assert all(isinstance(r, type) for r in gc.get_referents(a))
    assert not profiling._events  # the CPU: no device-timed span
    assert len(profiling.drain()[0]) == 2000


def test_root_counts_the_launch_calls_inside_it():
    @profiling.counted
    def _stub_wrapper():
        _stub_wrapper.launches += 1

    try:
        profiling.record(True)
        _stub_wrapper()  # outside any chunk
        with profiling.scope("pbmm.chunk", chunk=True) as root:
            _stub_wrapper()
            _stub_wrapper()
        with profiling.scope("pbmm.chunk", chunk=True):
            pass
        with profiling.scope("pbmm.chunk", chunk=True):
            with profiling.scope("pbmm.tail"):
                _stub_wrapper()
        profiling.record(False)
        spans, _ = profiling.drain()
        assert spans[0].id == root.id
        assert [s.calls for s in spans] == [2, 0, 1, None]
    finally:
        del profiling._COUNTED["_stub_wrapper"]


def test_spans_nest_by_thread_stack():
    profiling.record(True)
    with profiling.scope("pbmm.outer", chunk=True) as outer:
        with profiling.scope("pbmm.inner") as inner:
            with profiling.scope("pbmm.leaf") as leaf:
                pass
    with profiling.scope("pbmm.alone"):  # outside a chunk: not recorded
        pass
    spans = profiling.drain()[0]
    assert [s.name for s in spans] == ["pbmm.outer", "pbmm.inner",
                                       "pbmm.leaf"]
    assert [s.id for s in spans] == [outer.id, inner.id, leaf.id]
    assert [s.parent for s in spans] == [None, outer.id, inner.id]
    assert [s.chunk for s in spans] == [outer.id] * 3


def test_one_chunk_in_every_is_recorded(monkeypatch):
    monkeypatch.setattr(profiling, "EVERY", 3)
    profiling.record(True)
    roots = []
    for _ in range(7):
        with profiling.scope("pbmm.chunk", chunk=True) as root:
            with profiling.scope("pbmm.tail"):
                pass
        roots.append(root)
    profiling.record(False)
    spans = profiling.drain()[0]
    assert [s.name for s in spans] == ["pbmm.chunk", "pbmm.tail"] * 3
    assert [s.id for s in spans[::2]] == [roots[k].id for k in (0, 3, 6)]
    assert profiling.scope("pbmm.tail") is profiling._OFF


def test_root_notes_the_recorder_overhead():
    profiling.record(True)
    with profiling.scope("pbmm.chunk", chunk=True):
        for _ in range(20):
            with profiling.scope("pbmm.frontend"):
                with profiling.scope("pbmm.launch.x"):
                    pass
    with profiling.scope("pbmm.chunk", chunk=True):
        pass
    profiling.record(False)
    spans = profiling.drain()[0]
    busy, idle = spans[0], spans[-1]
    assert 0 < busy.overhead_ns < busy.t1 - busy.t0
    assert idle.overhead_ns == 0
    assert all(s.overhead_ns is None for s in spans[1:-1])


def test_off_scope_is_one_shared_noop():
    assert profiling.scope("pbmm.a") is profiling.scope("pbmm.b")
    with profiling.scope("pbmm.a", timed=torch.zeros(1), chunk=True):
        pass
    assert profiling.drain() == ([], 0)


def test_profiler_range_with_and_without_recording(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.scope("pbmm.test_off"):
            pass
        profiling.record(True)
        with profiling.scope("pbmm.test_chunk", chunk=True):
            with profiling.scope("pbmm.test_on"):
                pass
        profiling.record(False)
    files = list((tmp_path / "tr").iterdir())
    text = files[0].read_text()
    assert all(k in text for k in ("pbmm.test_off", "pbmm.test_chunk",
                                   "pbmm.test_on"))
    assert [s.name for s in profiling.drain()[0]] == ["pbmm.test_chunk",
                                                     "pbmm.test_on"]


def test_library_entry_gets_a_launch_span():
    calls = []

    def entry(*args):
        calls.append(args)
        return 77

    lib = build.Library(types.SimpleNamespace(pbmm_stub=entry),
                        ["pbmm_stub"])
    assert lib.pbmm_stub(1, 2) == 77
    assert profiling.drain() == ([], 0)
    profiling.record(True)
    with profiling.scope("pbmm.chunk", chunk=True) as root:
        assert lib.pbmm_stub(3) == 77
    profiling.record(False)
    spans, _ = profiling.drain()
    assert calls == [(1, 2), (3,)]
    assert [s.name for s in spans] == ["pbmm.chunk", "pbmm.launch.pbmm_stub"]
    assert spans[1].parent == spans[1].chunk == root.id
    assert spans[1].start is None


_table_args = itertools.count()


def _table(n):
    return (np.arange(n, dtype=np.float64), np.ones(3))


@pytest.mark.parametrize("make", [device_arrays, device_ints],
                         ids=lambda f: f.__name__)
def test_table_span_once_per_cache_miss(make):
    n = 1000 + next(_table_args)
    profiling.record(True)
    with profiling.scope("pbmm.chunk", chunk=True):
        first = make(_table, (n,), torch.device("cpu"))
        again = make(_table, (n,), torch.device("cpu"))
    profiling.record(False)
    assert first is again
    assert [s.name for s in profiling.drain()[0]] == ["pbmm.chunk",
                                                     "pbmm.table"]


def test_launch_counts_lists_every_counter():
    import pbmm_tpu_torch.tools.kdecomp  # noqa: F401  (the three probes)
    import pbmm_tpu_torch.tools.kexp  # noqa: F401
    import pbmm_tpu_torch.tools.trig_probe  # noqa: F401

    found = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("pbmm_tpu_torch") or mod is None:
            continue
        for attr, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches") and \
                    obj.__module__ == name:
                found[attr] = obj
    counts = profiling.launch_counts()
    assert set(counts) == set(found) and len(counts) >= 15
    fn = found["colspec_chunk"]
    n = fn.launches
    fn.launches += 2
    try:
        assert profiling.launch_counts()["colspec_chunk"] == n + 2
    finally:
        fn.launches = n


@pytest.mark.parametrize("calls,copied,want", [
    (0, 0, None), (4, 4, 100.0), (3, 0, 0.0)])
def test_copied_reader_counts_from_loading(calls, copied, want):
    from pbmm_tpu_torch.spectral import fused
    from portbench.harness import spec

    fn = fused.colspec_chunk
    before = fn.launches, fn.copied
    reader = spec.metric_reader("colspec_copied_pct.clip")
    try:
        fn.launches += calls
        fn.copied += copied
        assert reader.read(None) == want
    finally:
        fn.launches, fn.copied = before


def test_copied_reader_without_the_counter(monkeypatch):
    """A program whose kernel 2 counts no copies: the reader gives None,
    which leaves the metric out of the line."""
    from pbmm_tpu_torch.spectral import fused
    from portbench.harness import spec

    fn = fused.colspec_chunk
    monkeypatch.delattr(fn, "copied")
    reader = spec.metric_reader("colspec_copied_pct.clip")
    fn.launches += 2
    try:
        assert reader.read(None) is None
    finally:
        fn.launches -= 2
