"""The UHD cell `ref2160.u8_clip8`: its least work at 2160p's shapes, and
the reader of `colspec_staged_pct.clip` on the CPU (where kernel 2 makes
no call) and on counters moved by hand."""

import time

import pytest

from portbench.harness import program_spans, spec
from portbench.harness.cell import run_cell
from portbench.harness.roofline import ChunkWork
from tiny import tiny

CELL = "ref2160.u8_clip8"
METRIC = "colspec_staged_pct.clip"


def _work():
    cfg = spec.config("ref2160")
    tr = spec.traffic("u8_clip8")
    return ChunkWork(cfg["magnify"], cfg["height"], cfg["width"],
                     tr["chunk_frames"], tr["format"], tr["output_layout"])


def test_uhd_geometry():
    g = _work().g
    assert (g["hp"], g["wp"], g["wk"], g["hc"], g["hr"], g["taps"]) == (
        2176, 4096, 2176, 2176, 2176, 5)


def test_uhd_bytes_count_each_operand_once():
    """8 frames of 3840x2160 uint8 planar in and out; the row spectra of
    kernel 2's input and output, 2176 rows of 2176 kept lanes, re and im
    f32 a frame; the carried spectrum, one plane re and im."""
    w = _work()
    t, h, wd, hp, wk = 8, 2160, 3840, 2176, 2176
    frames = t * h * wd * 3 * 1
    rows = 2 * t * hp * wk * 4
    state = 2 * hp * wk * 4
    assert w.stage("frontend")[0] == frames + rows
    assert w.stage("colspec")[0] == 2 * rows + 2 * state
    assert w.stage("tail")[0] == rows + frames + frames
    assert w.chunk()[0] == 2 * frames + 2 * state


def test_staged_metric_lists_the_two_frame_cells():
    bench = spec.benchmark()
    m = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert m["workloads"] == ["ref1080.u8_clip16", "ref1080.f32_clip16",
                              CELL]
    for other in bench["end_to_end"][:1] + bench["per_layer"][:-1]:
        assert other["workloads"][-1] == CELL


@pytest.fixture
def recorder_off():
    """A traced run's readers arm the program's recorder: leave it off."""
    yield
    rec = program_spans._recorder()
    rec.record(False)
    rec.drain()
    program_spans._armed = None


def test_staged_reader_on_a_tiny_cpu_run(recorder_off):
    """On the CPU the wrappers take the plain versions: kernel 2 makes no
    call, and the reader gives None, which leaves the metric out."""
    bench, cfg, tr = tiny(CELL)
    t0 = time.perf_counter()
    res, lines = run_cell(CELL, 2 ** 31 + 7, 0.4, True,
                          lambda: time.perf_counter() - t0, device="cpu",
                          bench=bench, cfg_file=cfg, traffic=tr)
    assert res["correct"], lines
    assert METRIC not in res["metrics"]
    assert "kernel_calls_per_chunk.clip" in res["metrics"]
    line = next(x for x in lines if x.startswith("per-layer "))
    assert f"{METRIC} None" in line


@pytest.mark.parametrize("calls,staged,want", [
    (0, 0, None), (4, 4, 100.0), (4, 1, 25.0), (3, 0, 0.0)])
def test_staged_reader_counts_from_arming(calls, staged, want):
    from pbmm_tpu_torch.spectral import fused

    fn = fused.colspec_chunk
    before = fn.launches, fn.staged
    reader = spec.metric_reader(METRIC)
    try:
        fn.launches += calls
        fn.staged += staged
        assert reader.read(None) == want
    finally:
        fn.launches, fn.staged = before
