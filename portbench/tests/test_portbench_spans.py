"""The readers of the program's spans and launch counters
(`harness/program_spans.py` and the six metrics that read it): on whole
tiny traced runs on the CPU, on hand-made spans, beside the harness's
own event pairs, and against a program that records no spans."""

import time
import types

import pytest

from portbench.harness import program_spans, spec
from portbench.harness.cell import run_cell
from portbench.harness.marks import Marks
from tiny import CELLS, tiny

NEW = ["frontend_roofline_pct.span", "colspec_roofline_pct.span",
       "tail_roofline_pct.span", "host_launch_ms_per_chunk.clip",
       "host_glue_ms_per_chunk.clip", "kernel_calls_per_chunk.clip"]
TWINS = {"frontend_roofline_pct.span": "frontend_roofline_pct",
         "colspec_roofline_pct.span": "colspec_roofline_pct",
         "tail_roofline_pct.span": "tail_roofline_pct"}
BENCH_CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _recorder_off():
    """Loading a reader arms the program's recorder: leave it off."""
    yield
    rec = program_spans._recorder()
    rec.record(False)
    rec.drain()
    program_spans._armed = None


def _traced(cell, seconds=0.4):
    bench, cfg, tr = tiny(cell)
    t0 = time.perf_counter()
    res, lines = run_cell(cell, 7, seconds, True,
                          lambda: time.perf_counter() - t0, device="cpu",
                          bench=bench, cfg_file=cfg, traffic=tr)
    return {k: v["value"] for k, v in res["metrics"].items()}, res, lines


@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_new_metrics_on_a_whole_tiny_run(cell, capsys, monkeypatch):
    # Every chunk recorded, so that the spans' readings and the harness's
    # cover the same calls.
    monkeypatch.setattr(program_spans._recorder(), "EVERY", 1)
    got, res, lines = _traced(cell)
    assert res["correct"], lines
    assert all(got.get(m) is not None for m in NEW), got
    # The CPU takes the plain versions: no library call, no counter moves.
    assert got["host_launch_ms_per_chunk.clip"] == 0.0
    assert got["kernel_calls_per_chunk.clip"] == 0.0
    host = got["host_ms_per_chunk.clip"]
    assert 0.9 * host <= got["host_glue_ms_per_chunk.clip"] <= host
    for new, twin in TWINS.items():
        # Each span's interval holds the harness's pair of the same call.
        assert 0 < got[new] <= got[twin] * (1 + 1e-9)
    err = capsys.readouterr().err
    assert "spans window_chunks" in err and "spans slowest 1:" in err
    assert "dropped 0" in err


def test_a_tiny_run_records_one_chunk_in_sixteen(capsys):
    rec = program_spans._recorder()
    assert rec.EVERY == 16
    got, res, lines = _traced(BENCH_CELLS[0], seconds=0.6)
    assert res["correct"], lines
    err = capsys.readouterr().err
    line = next(x for x in err.splitlines()
                if x.startswith("spans window_chunks"))
    words = line.split()
    recorded = int(words[words.index("window_chunks") + 1])
    calls = int(words[words.index("harness_calls") + 1])
    assert calls >= 16 and abs(recorded - calls / 16) <= 1, line
    assert got["kernel_calls_per_chunk.clip"] == 0.0


class _Span:
    def __init__(self, name, chunk, t0, t1, start=None, end=None, sid=0,
                 parent=None, calls=None, overhead_ns=None):
        self.name, self.chunk, self.t0, self.t1 = name, chunk, t0, t1
        self.start, self.end, self.id, self.parent = start, end, sid, parent
        self.calls, self.overhead_ns = calls, overhead_ns

    def host_ms(self):
        return (self.t1 - self.t0) / 1e6


def _chunk(k, t0_ns, stages_ms, launches_ms, calls=3):
    """A chunk opening at t0_ns: its root (`calls` wrapper calls inside
    it), three stages of the given host ms one after another, each
    holding a launch of the given ms."""
    spans, t = [], t0_ns
    for name, ms, lm in zip(program_spans.STAGES, stages_ms, launches_ms):
        end = t + int(ms * 1e6)
        spans.append(_Span(name, k, t, end))
        spans.append(_Span("pbmm.launch.pbmm_x", k, t, t + int(lm * 1e6)))
        t = end
    root = _Span("pbmm.chunk", k, t0_ns, t + int(0.1e6), calls=calls,
                 overhead_ns=0)
    return program_spans.Chunk(root, [root] + spans)


def _run(chunks, since_arm=None, stages=None, marks=None):
    got = program_spans.ProgramSpans(chunks, marks or Marks("cpu"), 0, 0, 0,
                                     since_arm)
    run = types.SimpleNamespace(program_spans=got, stages=stages)
    run.stage_bound_ms = lambda stage: {"frontend": 0.5, "colspec": 0.25,
                                        "tail": 1.0}[stage]
    run.entry_device_ms = lambda entry: stages[entry] if stages else []
    return run


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_readers_on_hand_made_spans():
    chunks = [_chunk(1, 0, (1.0, 2.0, 4.0), (0.25, 0.5, 0.25)),
              _chunk(2, 10**7, (1.0, 1.0, 1.0), (0.5, 0.5, 0.5), calls=4),
              _chunk(3, 2 * 10**7, (3.0, 2.0, 1.0), (0.25, 0.25, 0.5),
                     calls=2)]
    run = _run(chunks, since_arm={"a": 12, "b": 6})
    assert _read("host_launch_ms_per_chunk.clip", run) == 1.0
    # host: 7.1, 3.1, 6.1 less launches 1.0, 1.5, 1.0
    assert _read("host_glue_ms_per_chunk.clip", run) == pytest.approx(5.1)
    chunks[1].root.overhead_ns = 500_000  # the recorder's own 0.5 ms
    assert chunks[1].glue_ms() == pytest.approx(1.1)
    assert _read("kernel_calls_per_chunk.clip", run) == 3.0
    chunks[1].root.calls = None  # a recorder that notes no calls
    assert _read("kernel_calls_per_chunk.clip", run) is None
    # front end: 0.5 ms bound x 3 calls over 5 ms
    assert _read("frontend_roofline_pct.span", run) == pytest.approx(30.0)
    assert _read("colspec_roofline_pct.span", run) == pytest.approx(15.0)
    assert _read("tail_roofline_pct.span", run) == pytest.approx(50.0)
    lines = run.program_spans.lines(0.0, 3)
    assert lines[0].startswith("spans window_chunks 3 device_timed 3 "
                               "harness_calls 3")
    assert "by wrapper {'a': 12, 'b': 6}" in lines[1]
    assert "spans slowest 1: 7.100 ms at 0.000 s" in lines[3]
    assert "glue 6.100" in lines[3]


def test_device_events_take_precedence_over_the_host():
    chunk = _chunk(1, 0, (1.0, 1.0, 1.0), (0.1, 0.1, 0.1))
    chunk.spans[1].start, chunk.spans[1].end = 0.0, 0.004  # Marks: seconds
    run = _run([chunk])
    assert run.program_spans.stage_device_ms("pbmm.frontend") == [
        pytest.approx(4.0)]


class _CardMarks:
    """Marks as on a card: events are numbers of ms here."""
    cuda = True

    @staticmethod
    def ms(a, b):
        return b - a


def test_on_the_card_only_device_timed_spans_count():
    chunks = [_chunk(k, k * 10**8, (1.0, 1.0, 1.0), (0.1, 0.1, 0.1))
              for k in range(4)]
    for c, ms in ((chunks[0], 2.0), (chunks[2], 3.0)):
        for s in c.spans:
            s.start, s.end = 0.0, ms
    run = _run(chunks, marks=_CardMarks())
    got = run.program_spans
    assert got.stage_device_ms("pbmm.tail") == [2.0, 3.0]
    # tail bound 1.0 ms x 2 timed calls over 5 ms
    assert _read("tail_roofline_pct.span", run) == pytest.approx(40.0)
    # host readings take every chunk
    assert _read("host_launch_ms_per_chunk.clip", run) == pytest.approx(0.3)
    assert "device_timed 2" in got.lines(0.0, 4)[0]


def test_span_rooflines_equal_their_twins_on_the_same_intervals():
    intervals = {"frontend": [1.0, 1.5, 2.0], "colspec": [2.0, 2.0, 3.0],
                 "tail": [0.5, 4.0, 1.0]}
    chunks = [_chunk(k, k * 10**8, [intervals[s][k] for s in
                                    ("frontend", "colspec", "tail")],
                     (0.1, 0.1, 0.1)) for k in range(3)]
    entries = {spec.metric_reader(t).ENTRY: intervals[spec.metric_reader(
        t).STAGE] for t in TWINS.values()}
    run = _run(chunks, stages=entries)
    for new, twin in TWINS.items():
        assert _read(new, run) == pytest.approx(_read(twin, run), rel=1e-6)


def test_no_recorder_gives_no_metric(monkeypatch):
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    program_spans.arm()
    run = types.SimpleNamespace(win=None, marks=None)
    assert program_spans.of(run) is None
    run.stage_bound_ms = lambda stage: 1.0
    for name in NEW:
        assert _read(name, run) is None


def test_window_keeps_only_chunks_after_its_start(monkeypatch):
    rec = program_spans._recorder()
    monkeypatch.setattr(rec, "EVERY", 1)
    program_spans.arm()
    for _ in range(2):
        with rec.scope("pbmm.chunk", chunk=True):
            pass
    t0 = time.perf_counter()
    for _ in range(3):
        with rec.scope("pbmm.chunk", chunk=True):
            with rec.scope("pbmm.table"):
                pass
    win = types.SimpleNamespace(t0=t0, chunks=[None] * 3)
    got = program_spans.of(types.SimpleNamespace(win=win, marks=Marks("cpu")))
    assert len(got.chunks) == 3
    assert got.tables == 3 and got.calls_per_chunk() == 0.0
    assert not rec._recording


@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_the_cells_name_has_a_reader(cell):
    bench, _, _ = tiny(cell)
    for m in spec.cell_metrics(bench, cell, True):
        assert callable(spec.metric_reader(m["name"]).read)
