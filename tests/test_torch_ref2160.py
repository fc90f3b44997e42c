"""UHD's shapes on the CPU: the port's `magnify_video` (CPU tensors, so
every kernel wrapper takes its plain PyTorch version) against the
benchmark's float64 reference (`portbench/reference/torch_ref.py`, plain
PyTorch that imports neither JAX nor the port), in the `ref2160`
configuration: 5 bands 0.05-0.45, scale 10, two-frame, y_only, tight
pad, the fused path, uint8 planar frames in and planar uint8 out.

Two strips of a 3840x2160 frame keep one UHD axis each at its full
length, so that the port walks UHD's paths at a size the CPU can run:

- 2160 x 384: the column height of 2160p tight, H = 2176 = 17 x 128
  (kernel 2's four-step at m = 17), on 512 lanes; `post_pallas_ok` holds,
  so the tail takes kernel 3's plain version, not the torch posttail;
- 96 x 3840: the row length of 2160p, 4096 lanes with 17 of 32 lane
  tiles kept (2176 lanes), on the tail route `kernel3_serves(2, 4096,
  3840)` picks on the card.

Each case magnifies 16 seeded frames in two chunks of 8, the state of
the first threaded into the second (frame 0 passes through), and holds
frames 1-15 to the reference worked out from the source frames alone.
Tolerances, on round(255 x) of the reference, as the benchmark's
`correct` compares the uint8 layouts:

- `max_level_gap` <= 1: the port computes in float32, whose error (about
  1e-6 of full scale) can carry a value across a rounding boundary of the
  8-bit output, by one level, and no further;
- `mismatch_pct` <= 0.5: such values are rare, a share of the values
  near a boundary; half the cell's limit of 1.0 %
  (`portbench/limits/ref2160.u8_clip8.json`).

The control, the reference computed in float32 with every stage's result
rounded to bfloat16 (the precision below the configuration's float32),
fails both."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pbmm_tpu_torch import magnify_video  # noqa: E402
from pbmm_tpu_torch.core.window import geometry_for  # noqa: E402
from pbmm_tpu_torch.engine import post_fused  # noqa: E402
from pbmm_tpu_torch.engine.pipeline import blur_row_window  # noqa: E402
from pbmm_tpu_torch.spectral.hermitian import (  # noqa: E402
    hermitian_kept_width)
from portbench.harness import spec  # noqa: E402
from portbench.harness.cell import program_config  # noqa: E402
from portbench.harness.inputs import make_ring  # noqa: E402
from portbench.reference.torch_ref import Reference  # noqa: E402

FRAMES, CHUNK = 16, 8
MAX_LEVEL_GAP = 1.0
MAX_MISMATCH_PCT = 0.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _content():
    """u8_clip16's content (its sizes in pixels), with the bar and the
    blob on one period over the 16 frames: on the cell's 240-frame ring
    their periods are 30 and 12 frames, and 8 cycles over 16 frames would
    hold the bar still at every frame."""
    return dict(spec.traffic("u8_clip16")["content"], bar_cycles=1,
                blob_cycles=1)


def _numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Planar uint8 frames (T, 3, H, W) against the reference's (T, H, W,
    3) in [0, 1], as the benchmark's check compares them."""
    want = torch.round(ref * 255.0).permute(0, 3, 1, 2)
    d = (got.to(torch.float64) - want).abs()
    return {"mismatch_pct": 100.0 * float((d > 0).sum()) / d.numel(),
            "max_level_gap": float(d.max())}


def _ok(n: dict) -> bool:
    return (n["max_level_gap"] <= MAX_LEVEL_GAP
            and n["mismatch_pct"] <= MAX_MISMATCH_PCT)


@pytest.mark.parametrize("h,w", [(2160, 384), (96, 3840)],
                         ids=["2160x384", "96x3840"])
def test_uhd_shapes_against_the_float64_reference(h, w):
    cfg_file = spec.config("ref2160")
    traffic = spec.traffic("u8_clip8")
    cfg = program_config(cfg_file, traffic)
    geom = geometry_for(h, w, cfg.pad_mode)
    if h == 2160:
        assert (geom.pad_h, geom.pad_w) == (2176, 512)
        rows = blur_row_window(geom, cfg)
        assert post_fused.post_pallas_ok(geom, cfg, rows[0],
                                         rows[1] - rows[0])
    else:
        assert (geom.pad_h, geom.pad_w) == (128, 4096)
        assert hermitian_kept_width(4096) == 17 * 128
        assert post_fused.kernel3_serves(post_fused._radius(cfg), 4096, w)

    frames = make_ring(2160 + w, FRAMES, h, w, traffic["format"],
                       _content(), "cpu")
    first, state = magnify_video(frames[:CHUNK], cfg)
    second, state = magnify_video(frames[CHUNK:], cfg, state)
    assert first.dtype == second.dtype == torch.uint8
    assert first.shape == (CHUNK, 3, h, w)
    # Frame 0 starts the stream and passes through unmodified.
    assert torch.equal(first[0], frames[0])
    got = torch.cat([first[1:], second])

    mag = cfg_file["magnify"]
    with torch.no_grad():
        ref = Reference(mag, h, w, "cpu").two_frame(frames[0], frames[1:])
        low = Reference(mag, h, w, "cpu", store=torch.bfloat16).two_frame(
            frames[0], frames[1:])
    program = _numbers(got, ref)
    control = _numbers(
        torch.round(low.permute(0, 3, 1, 2) * 255.0).to(torch.uint8), ref)
    assert _ok(program), program
    assert not _ok(control), control
