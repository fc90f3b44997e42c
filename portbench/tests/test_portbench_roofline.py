"""The benchmark's frozen roofline arithmetic gives the kernel table's
1080p bounds (PERF.md, the "bound ms" column: 16-frame chunks)."""

import pytest

from portbench.harness.roofline import ChunkWork, bound_ms

REF = {"pad_mode": "tight", "blur_size": 0.5, "chroma": "y_only",
       "temporal": {"mode": "two_frame"}}
EVM = dict(REF, chroma="rgb", temporal={"mode": "iir_bandpass"})


@pytest.mark.parametrize("cfg, fmt, out, stage, table_ms", [
    (REF, "f32_interleaved", "interleaved", "frontend", 0.1696),
    (REF, "u8_planar", "planar_u8", "frontend", 0.080),
    (EVM, "f32_interleaved", "interleaved", "frontend", 0.2710),
    (REF, "u8_planar", "planar_u8", "colspec", 0.108),
    (EVM, "u8_planar", "planar_u8", "colspec", 0.342),
    (REF, "u8_planar", "planar_u8", "tail", 0.110),
    (REF, "f32_interleaved", "interleaved", "tail", 0.288),
])
def test_stage_bounds_match_the_kernel_table(cfg, fmt, out, stage, table_ms):
    work = ChunkWork(cfg, 1080, 1920, 16, fmt, out)
    assert bound_ms(*work.stage(stage)) == pytest.approx(table_ms, abs=6e-4)


def test_tight_1080p_geometry():
    g = ChunkWork(REF, 1080, 1920, 16, "u8_planar", "planar_u8").g
    assert (g["hp"], g["wp"], g["wk"], g["hc"], g["hr"], g["taps"]) == (
        1152, 2048, 1152, 1152, 1152, 5)


def test_chunk_bound_counts_each_byte_once():
    w = ChunkWork(REF, 1080, 1920, 16, "u8_planar", "planar_u8")
    nbytes, ops = w.chunk()
    frames = 16 * 1080 * 1920 * 3
    state = 2 * 2 * 1152 * 1152 * 4
    assert nbytes == 2 * frames + state
    assert bound_ms(nbytes, ops) == pytest.approx(ops / 67e12 * 1e3)
