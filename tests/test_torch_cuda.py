"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes and branches `chip_smoke.py` does not reach.  Covered here:
- the 320x384 clip geometry (four-step m = 3, 3 of 4 lane tiles kept);
- 720p's column height (m = 6);
- the full-width lane layout (keep_half=False, no Hermitian rebuild);
- a content slab offset inside the padded column;
- kernel 4 (u8 row FFT) at offset content rows, against its plain
  version and bit for bit against the pre stage + kernel 1;
- kernel 3 in all six chroma x layout variants;
- kernel 7 (row IFFT + |z|) at W = 512 to 4096;
- the row engine of kernels 4 and 7 (`csrc/row_pass.cuh`): kernel 7 bit
  for bit kernel 8's row pass + torch's |z| (or Re z) at W = 512 to
  8192, kept and full lanes; kernel 4 bit for bit the pre stage + kernel
  1 at 3840x2160 (W = 4096) and at an odd width, kept and full lanes;
- the whole main path on the card against the CPU path, interleaved f32
  and planar uint8 in, on both tails;
- the span recorder's recorded chunk (`utils/profiling.py`): its
  stages' events in order inside the root's pair, the next chunk
  unrecorded;
- kernel 2's branches, kernels 5 and 11, the quirk switches of kernels 3
  and 7 and the config matrix's paths;
- kernel 6 in every branch at three heights and 1, 3 and 16 frames a
  launch; with `fx_values` (the spatial engine's shard columns, W / p =
  1024, 512, 256 at H = 2048) in every branch against its plain version
  and bit for bit against one full-width call, and its launch refusing
  standard mode without a plane or the weight's terms; and bit for bit
  against kernel 2's rows (with kernel 12 = 6)
  at H = 64, 512, 2048 and 4096, 1, 3 and 16 frames a launch, in every
  frame-parallel branch; kernel 8 on both axes from 8 to 8192 points,
  kernel 9 in
  both layouts, kernel 10 in every layout, the scan engine's paths on the
  card against the CPU (numpy input landing on the card), and
  `load_state` defaulting to the card;
- kernel 12 (kdecomp) in every piece set and phase branch at H = 256
  to 8192 (strips of 16 to 2), bit for bit its plain version without
  the phase piece, its full variant bit for bit against kernel 6;
  kernel 13 (the copy probe) in every pattern, strips of 1 to 32, a
  width and planes off the 16-byte grid, bit for bit; kernel 14 (the trig probe) in every op
  code; `debug_mode` catching a planted NaN; `stage_times` and `timeit`
  on the card;
- 2160p's heights: kernels 2, 5 and 6 at H = 4096 (with and without the
  IIR taps; 6 = 2's rows and 12 = 6 bit for bit), kernel 2 at tight
  H = 2176 (m = 17);
- 4320p's heights: kernel 2 in every branch, the IIR taps included, at
  H = 8192 and at tight m = 34, 48 and 63 (m = 64 is H = 8192, a power
  of two: the radix-2 layout), against its plain version; kernels 5, 6
  and 12 at H = 8192 (5 = 2's forward half, 6 = 2's rows, 12 = 6 bit for
  bit, kernel 6 also with the IIR taps); two chunks equal to one at
  m = 34 and 8192, with and without the IIR taps;
- kernel 2's IIR branch on its three launches (forward, tap scan,
  inverse): the zero-prev bootstrap keeps the taps exactly zero at
  H = 384, 512, 4352 and 8192;
- kernel 8's row pass on the row engine at every length 128 to 8192,
  forward real, forward complex and inverse with a scale, on a row count
  that leaves the last block part-filled;
- the column engine of kernels 5 and 8 (`csrc/col_pass.cuh`): kernel 8
  in every kind at lengths 2 to 8192 on ragged widths, kernel 5 bit for
  bit against kernel 2's forward half at H = 512 to 4096 and against
  its plain version at 8192;
- blur radii 3, 5, 13 and 15: kernels 3, 10 (f32 and uint8 chroma) and
  11, kernel 3's route through kernels 7 + 10 (radii 13, 15), kernel 3 bit
  for bit against kernel 7 + kernel 10 at radii 0-14 at 1080p and 0-6 at
  2160p (4096 lanes) in both chroma sources, the three layouts and the
  quirks; kernels 10 and 11's tile (csrc/post_rgb.cu) at radii 0, 1, 2,
  5, 13, 15, 31 and 96, crop widths 128, 1152 and 1920, 1 and 16
  frames; `magnify_video` at 1080p in
  y_only, uint8 -> planar_u8 and rgb against the CPU, and the CLI's
  `--fast --blur-size 1.5` at 1080p;
- kernel 1 on the row engine at 128 to 8192 lanes, kept and full, on a
  part-filled last block: against its plain version and bit for bit
  against kernel 8's row pass on the same windowed rows;
- the sizes above 8192 (fault F4, fixed by the bracket passes): kernels
  2, 5, 6 and 12 at H = 16384 and 32768, kernel 2 in every branch at
  16384 and at tight m = 65 and 68 (the combine pass), kernels 1, 4, 7
  and 8 (both axes) at 16384 and 32768, against their plain versions;
  the identities at 16384 (5 = 2's forward half, 6 = 2's rows, 12 = 6,
  4 = the pre stage + 1, 1 = 8's row pass, 7 = 8's row pass + |z|), two
  chunks equal to one, and kernel 8's column pass on a plane of more
  than 2^31 elements;
- kernel 9 (redesigned) in its four branches and both layouts on a width
  that is not a multiple of 4;
- kernel 2's launch 2 on the phase strip's asynchronous copies at each
  strip class (pow-2 H = 1024, 2048 and 4096, tight m = 9 and 14) and on
  the element loads (H = 8192) against its plain version; two chunks
  equal to one through the ring; `colspec_chunk.staged`, as the C entry
  reports it, rising by one a call where launch 2 runs the asynchronous
  strip (m = 9, 14 and 17, H = 2048 and 4096, a steady 1080p chunk
  included) and staying put elsewhere (strips of 2, the IIR taps,
  standard mode), equal to the host's mirror `fused.colspec_staged`, and
  the C rule's shared memory equal to the host's mirror;
- kernel 2's launch 3 (the IIR branch's inverse) on asynchronous copies
  of its rotated strip at every strip width (tight m = 9 and 17, pow-2
  H = 2048 and 4096; strips of 2 at H = 8192 and m = 34), the 128-point
  chunks above m = 64 and the bracket at 16384, one plane and three,
  against its plain version, two chunks equal to one at each;
  `colspec_chunk.copied` rising by one a call with the IIR taps and by
  none on the main, standard and steerable branches;
- kernel 2's frame-parallel schedule on every non-IIR branch at H = 512,
  1152, 2048, 2176 and 4096 (strips of 16, 8 and 4 columns), one plane
  and three, T = 1, 3 and 16, on row spectra that turn smoothly from
  frame to frame (clear of atan2's branch cut); kernel 5 = its forward
  half, kernel 6 = its rows and kernel 12 = kernel 6 at H = 512 to 4096;
  two chunks equal to one at tight and pow-2 heights;
- the mxu backend (`spectral/mxu_fft.py`): its refusal with TF32 or bf16
  allowed, its transforms at (1, 2048, 2048) and (3, 1024, 2048) against
  torch.fft, `magnify_video` on the card against the CPU; and a .npy
  streamed through the native loader equal to the memmap route and to
  `magnify_video` on the whole clip, uint8 and f32.

Marked `cuda`; every test skips without a CUDA card.  This file imports
neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: spectra to max error / max magnitude < 1e-4, images to max
abs < 1e-4 (the bars of chip_smoke.py and tests/test_tight.py)."""

import numpy as np
import pytest
import torch

from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.core.color import RGB_TO_YIQ
from pbmm_tpu_torch.engine.pipeline import blur_row_window, chroma_planes
from pbmm_tpu_torch.spectral import fused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def _cfg():
    return MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight")


def _rand(rng, shape, dev, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _rel(got, want):
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return num / max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize("hc,pad_h,row0,w,keep", [
    (384, 384, 0, 512, True),
    (384, 384, 0, 512, False),
    (256, 384, 64, 256, False),
    (64, 1152, 1024, 2048, True),
])
def test_row_fft_kernel(dev, hc, pad_h, row0, w, keep):
    y = torch.rand((3, hc, w), generator=torch.Generator().manual_seed(0))
    y = y.to(dev)
    got = fused.windowed_row_fft(y, pad_h, row0, keep)
    want = fused.windowed_row_fft_ref(y, pad_h, row0, keep)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("pad_h,w,hc,row0,rows", [
    (384, 512, 384, 0, (0, 384)),
    (384, 512, 256, 64, (64, 320)),
    (768, 2048, 768, 0, (0, 768)),
    (384, 256, 384, 0, (128, 256)),
    # the phase strip's asynchronous copies at each strip class: pow-2 on
    # 16, 8 and 4 columns (a ring of 3 slots of prev and the host planes),
    # tight m = 9 (1080p, 2 slots) and m = 14 (cur alone); H = 8192 keeps
    # the element loads
    (1024, 2048, 600, 200, (100, 900)),
    (2048, 2048, 1080, 484, (400, 1600)),
    (4096, 2048, 2160, 968, (900, 3200)),
    (1152, 2048, 1080, 36, (36, 1116)),
    (1792, 2048, 1720, 36, (36, 1756)),
    (8192, 2048, 4320, 1936, (1900, 6300)),
])
def test_colspec_kernel(dev, pad_h, w, hc, row0, rows):
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(3)
    args = [_rand(rng, (4, hc, wk), dev), _rand(rng, (4, hc, wk), dev),
            _rand(rng, (1, pad_h, wk), dev), _rand(rng, (1, pad_h, wk), dev)]
    kw = dict(out_rows=rows, full_w=w)
    got = fused.colspec_chunk(*args, _cfg(), pad_h, row0, **kw)
    want = fused.colspec_chunk_ref(*args, _cfg(), pad_h, row0, **kw)
    assert _rel(got[:2], want[:2]) < 1e-4
    assert _rel(got[2:], want[2:]) < 1e-4


@pytest.mark.parametrize("in_h,in_w,keep", [
    (320, 384, True), (320, 384, False), (1080, 1920, True)])
def test_post_kernel(dev, in_h, in_w, keep):
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _cfg())
    wk = hermitian_kept_width(g.pad_w) if keep else g.pad_w
    rng = np.random.default_rng(5)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    hr = rows[1] - rows[0]
    args = (_rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            hann2d_region(g, device=dev), _cfg(), rows[0], in_h, in_w,
            "tight")
    got = post_fused.rowifft_post_fused(*args, full_w=g.pad_w)
    want = post_fused.rowifft_post_fused_ref(*args, full_w=g.pad_w)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-4


def test_main_path_on_card_matches_cpu(dev):
    rng = np.random.default_rng(9)
    base = rng.random((320, 384, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) * (0.95 + 0.01 * i)
                     for i in range(5)]).astype(np.float32)
    counts = {f: f.launches for f in (fused.windowed_row_fft_frames,
                                      fused.colspec_chunk,
                                      post_fused.rowifft_post_fused)}
    out_d, st_d = magnify_video(torch.from_numpy(clip).to(dev), _cfg())
    assert all(f.launches > n for f, n in counts.items())
    out_c, st_c = magnify_video(torch.from_numpy(clip), _cfg())
    mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
    assert mse == 0 or 10 * np.log10(1 / mse) > 100
    assert _rel([st_d.prev_spec_re.cpu()], [st_c.prev_spec_re]) < 1e-4
    o1, s1 = magnify_video(torch.from_numpy(clip[:2]).to(dev), _cfg())
    o2, _ = magnify_video(torch.from_numpy(clip[2:]).to(dev), _cfg(), s1)
    assert torch.equal(torch.cat([o1, o2]), out_d)


def test_device_timed_chunk_spans_on_card(dev):
    """The first chunk after `record(True)` is recorded: its root's and
    each stage's events exist, in order, inside the root's pair; the
    launch spans are host-only; the next chunk records nothing; the root
    counts the wrappers' calls inside it."""
    from pbmm_tpu_torch.utils import profiling

    rng = np.random.default_rng(19)
    clip = torch.from_numpy(
        rng.random((5, 320, 384, 3), dtype=np.float32)).to(dev)
    _, st = magnify_video(clip[:1], _cfg())
    before = sum(profiling.launch_counts().values())
    profiling.record(True)
    try:
        _, st = magnify_video(clip[1:3], _cfg(), st)
        mid = sum(profiling.launch_counts().values())
        _, st = magnify_video(clip[3:], _cfg(), st)
    finally:
        profiling.record(False)
    torch.cuda.synchronize()
    spans, dropped = profiling.drain()
    root = spans[0]
    assert dropped == 0 and root.name == "pbmm.chunk"
    assert all(s.chunk == root.id for s in spans)
    stages = [s for s in spans if s.parent == root.id
              and s.name in ("pbmm.frontend", "pbmm.colspec", "pbmm.tail")]
    assert [s.name for s in stages] == ["pbmm.frontend", "pbmm.colspec",
                                        "pbmm.tail"]
    events = [root.start] + [e for s in stages
                             for e in (s.start, s.end)] + [root.end]
    assert all(e is not None for e in events)
    steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    assert all(ms >= 0 for ms in steps), steps
    assert all(ms > 0 for ms in steps[1::2]), steps  # each stage's work
    assert all(s.start is None for s in spans
               if s.name.startswith("pbmm.launch."))
    assert root.calls == mid - before >= 3
    assert 0 < root.overhead_ns < root.t1 - root.t0


@pytest.mark.parametrize("in_h,in_w", [(300, 384), (320, 384), (540, 960),
                                       (1080, 1920)])
def test_u8_row_fft_kernel(dev, in_h, in_w):
    g = geometry_for(in_h, in_w, "tight")
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + in_h, g.pad_h)
    rng = np.random.default_rng(in_h)
    frames = torch.from_numpy(
        rng.integers(0, 256, (2, 3, in_h, in_w), dtype=np.uint8)).to(dev)
    luma = tuple(float(c) for c in RGB_TO_YIQ[0])
    n = fused.windowed_row_fft_u8planar.launches
    args = (frames, luma, g.pad_h, g.pad_w, g.y0, g.x0, r0, True)
    got = fused.windowed_row_fft_u8planar(*args)
    assert fused.windowed_row_fft_u8planar.launches == n + 1
    want = fused.windowed_row_fft_u8planar_ref(*args)
    assert _rel(got, want) < 1e-4
    # The torch pre stage + kernel 1 on the same frames, bit for bit.
    hc, off = fused._u8_args(frames, g.pad_h, g.pad_w, g.y0, g.x0, r0)
    re, im = fused.windowed_row_fft(
        fused.frames_slab(frames, (luma,), g.pad_w, g.x0, off, hc), g.pad_h,
        r0, True)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "full"])
@pytest.mark.parametrize("in_h,in_w", [(2160, 3840), (270, 481)])
def test_u8_row_fft_kernel_wide_and_ragged(dev, in_h, in_w, keep):
    # Kernel 4 on the row engine at 3840x2160 (W = 4096, four passes) and
    # at an odd width (481: scalar byte loads at every alignment), bit
    # for bit the torch pre stage + kernel 1 on the same frames.
    g = geometry_for(in_h, in_w, "tight")
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + in_h, g.pad_h)
    rng = np.random.default_rng(in_w)
    frames = torch.from_numpy(
        rng.integers(0, 256, (2, 3, in_h, in_w), dtype=np.uint8)).to(dev)
    luma = tuple(float(c) for c in RGB_TO_YIQ[0])
    args = (frames, luma, g.pad_h, g.pad_w, g.y0, g.x0, r0, keep)
    got = fused.windowed_row_fft_u8planar(*args)
    hc, off = fused._u8_args(frames, g.pad_h, g.pad_w, g.y0, g.x0, r0)
    f = fused.unit_float(frames)
    slab = fused.channel_mix(f[:, 0], f[:, 1], f[:, 2], luma)
    slab = torch.nn.functional.pad(
        slab, (g.x0, g.pad_w - in_w - g.x0, off, hc - off - in_h))
    want = fused.windowed_row_fft(slab.contiguous(), g.pad_h, r0, keep)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _rel(got, fused.windowed_row_fft_u8planar_ref(*args)) < 1e-4


def _row_pass_then_abs(re, im, w, scale, magnitude):
    """Kernel 7's function from kernel 8's row pass: the plan's rebuild
    gathered with torch, `_fft_axis` along the rows (inverse, unscaled),
    then torch's sqrt(re re + im im) * scale (or re * scale)."""
    from pbmm_tpu_torch.spectral import radix2

    zr, zi = radix2._fft_axis(*fused.rebuild_lanes(re, im, w), 2, True, 1.0)
    return (torch.sqrt(zr * zr + zi * zi) if magnitude else zr) * scale


@pytest.mark.parametrize("magnitude", [True, False], ids=["abs", "re"])
@pytest.mark.parametrize("keep", [True, False], ids=["kept", "full"])
@pytest.mark.parametrize("w", [512, 1024, 2048, 4096, 8192])
def test_row_ifft_kernel_equals_row_pass_and_torch_abs(dev, w, keep,
                                                       magnitude):
    # Kernel 7 on the row engine runs kernel 8's butterflies in kernel 8's
    # order with the same twiddle words, and rounds |z| as torch does.
    hb = max(8, 16384 // w)
    wk = hermitian_kept_width(w) if keep else w
    rng = np.random.default_rng(w + keep)
    scale = 0.3 * hb * np.sqrt(w)
    re, im = (_rand(rng, (3, hb, wk), dev, scale) for _ in range(2))
    got = fused.row_ifft_magnitude(re, im, magnitude, pad_h=hb, full_w=w)
    want = _row_pass_then_abs(re, im, w, 1.0 / (hb * w), magnitude)
    assert got.shape == want.shape == (3, hb, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("src", ["f32", "u8"])
@pytest.mark.parametrize("layout", ["tuple3", "planar", "planar_u8"])
def test_post_kernel_variants(dev, src, layout):
    in_h, in_w = 320, 384
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _cfg())
    wk, hr = hermitian_kept_width(g.pad_w), rows[1] - rows[0]
    rng = np.random.default_rng(6)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    rre, rim = (_rand(rng, (2, hr, wk), dev, scale) for _ in range(2))
    if src == "f32":
        chroma = (_rand(rng, (2, in_h, in_w), dev, 0.3),
                  _rand(rng, (2, in_h, in_w), dev, 0.3), None)
    else:
        chroma = (None, None, torch.from_numpy(rng.integers(
            0, 256, (2, 3, in_h, in_w), dtype=np.uint8)).to(dev))
    args = (rre, rim, chroma[0], chroma[1], hann2d_region(g, device=dev),
            _cfg(), rows[0], in_h, in_w, "tight")
    kw = dict(full_w=g.pad_w, src=chroma[2])
    got = post_fused.rowifft_post_fused(*args, out_layout=layout, **kw)
    want = post_fused.rowifft_post_fused_ref(*args, out_layout=layout, **kw)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-4
    elif layout == "planar":
        assert got.shape == (2, 3, in_h, in_w)
        assert float((got - want).abs().max()) < 1e-4
    else:
        assert got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
        planar = post_fused.rowifft_post_fused(*args, out_layout="planar",
                                               **kw)
        assert torch.equal(got, torch.round(planar * 255.0).to(torch.uint8))


@pytest.mark.parametrize("hb,w,keep", [(384, 512, True), (384, 512, False),
                                       (640, 1024, True), (64, 2048, True),
                                       (32, 4096, True)])
def test_row_ifft_kernel(dev, hb, w, keep):
    wk = hermitian_kept_width(w) if keep else w
    rng = np.random.default_rng(8)
    scale = 0.3 * hb * np.sqrt(w)
    re, im = (_rand(rng, (3, hb, wk), dev, scale) for _ in range(2))
    n = fused.row_ifft_magnitude.launches
    got = fused.row_ifft_magnitude(re, im, pad_h=hb, full_w=w)
    assert fused.row_ifft_magnitude.launches == n + 1
    want = fused.row_ifft_magnitude_ref(re, im, pad_h=hb, full_w=w)
    assert got.shape == (3, hb, w)
    assert _rel([got], [want]) < 1e-4


@pytest.mark.parametrize("in_h,layout", [(320, "planar_u8"), (320, "planar"),
                                         (300, "planar_u8"),
                                         (300, "interleaved")])
def test_u8_path_on_card_matches_cpu(dev, in_h, layout):
    rng = np.random.default_rng(10)
    base = rng.integers(0, 256, (3, in_h, 384), dtype=np.uint8)
    clip = np.stack([np.roll(base, i, axis=-1) for i in range(5)])
    cfg = _cfg().replace(output_layout=layout)
    kernels = ((fused.windowed_row_fft_u8planar, post_fused.rowifft_post_fused)
               if in_h == 320 else
               (fused.windowed_row_fft_u8planar, fused.row_ifft_magnitude))
    counts = {f: f.launches for f in kernels}
    out_d, _ = magnify_video(torch.from_numpy(clip).to(dev), cfg)
    assert all(f.launches > n for f, n in counts.items())
    out_c, _ = magnify_video(torch.from_numpy(clip), cfg)
    if layout == "planar_u8":
        assert int((out_d.cpu().int() - out_c.int()).abs().max()) <= 1
    else:
        mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
        assert mse == 0 or 10 * np.log10(1 / mse) > 100
    o1, s1 = magnify_video(torch.from_numpy(clip[:2]).to(dev), cfg)
    o2, _ = magnify_video(torch.from_numpy(clip[2:]).to(dev), cfg, s1)
    assert torch.equal(torch.cat([o1, o2]), out_d)


# -- the config matrix: kernel 2's branches, kernels 5 and 11, the quirk
#    switches of kernels 3 and 7 ---------------------------------------------

from pbmm_tpu_torch import TemporalConfig  # noqa: E402

_BRANCHES = {
    "pow2": dict(),
    "pow2_rgb": dict(chroma="rgb"),
    "iir": dict(temporal=TemporalConfig(mode="iir_bandpass")),
    "standard": dict(mode="standard"),
    "standard_iir": dict(mode="standard",
                         temporal=TemporalConfig(mode="iir_bandpass")),
    "steerable": dict(orientations=4),
    "overlapping": dict(pyramid_levels=6, orientations=3),
    "non_integer": dict(phase_scale=2.5),
}


def _spectra(rng, shape, dev, zeros=False):
    """Normal spectra; with `zeros`, a band of exact and signed zeros."""
    a = rng.standard_normal(shape).astype(np.float32)
    if zeros:
        a[..., :16, :] = 0.0
        a[..., 16:32, :] = -0.0
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("name", sorted(_BRANCHES))
@pytest.mark.parametrize("pad_h", [512, 384])
def test_colspec_kernel_branches(dev, name, pad_h):
    """Every branch of kernel 2 against its plain version, at a pow-2 and
    a four-step height, with signed zeros in cur and prev."""
    cfg = _cfg().replace(**_BRANCHES[name])
    planes = 3 if cfg.chroma == "rgb" else 1
    w, hc, row0, rows = 512, 256, 64, (64, 320)
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(11)
    rows_in = [_spectra(rng, (3 * planes, hc, wk), dev, True)
               for _ in range(2)]
    state = [_spectra(rng, (planes, pad_h, wk), dev, True) for _ in range(2)]
    if cfg.temporal.mode == "iir_bandpass":
        state += [0.1 * _spectra(rng, (planes, pad_h, wk), dev)
                  for _ in range(2)]
    n = fused.colspec_chunk.launches
    args = (*rows_in, *state[:2], cfg, pad_h, row0, *state[2:])
    kw = dict(out_rows=rows, full_w=w, planes=planes)
    got = fused.colspec_chunk(*args, **kw)
    assert fused.colspec_chunk.launches == n + 1
    want = fused.colspec_chunk_ref(*[x.cpu() for x in args[:4]], cfg, pad_h,
                                   row0, *[x.cpu() for x in state[2:]], **kw)
    assert len(got) == len(want) == 4 + len(state[2:])
    for k in range(0, len(got), 2):
        assert _rel([g.cpu() for g in got[k:k + 2]], want[k:k + 2]) < 1e-4


@pytest.mark.parametrize("pad_h", [512, 384, 8192, 4352])
def test_iir_zero_prev_taps_stay_zero(dev, pad_h):
    """The bootstrap: a zero previous spectrum with signed zeros and zero
    taps.  atan2 of (+-0, +-0) must be 0, so the taps stay exactly zero
    (IEEE atan2 would give +-pi at bins with cur in the left half).  On
    the IIR branch's three launches: the tap scan runs each bin's phase
    pass, the inverse the rotated spectra."""
    cfg = _cfg().replace(temporal=TemporalConfig(mode="iir_bandpass"))
    wk = hermitian_kept_width(512)
    rng = np.random.default_rng(12)
    rows_in = [_spectra(rng, (1, pad_h, wk), dev) for _ in range(2)]
    prev = torch.zeros((2, 1, pad_h, wk), device=dev)
    prev[1, :, ::2] = -0.0
    taps = torch.zeros((2, 1, pad_h, wk), device=dev)
    got = fused.colspec_chunk(*rows_in, prev[0], prev[1], cfg, pad_h, 0,
                              taps[0], taps[1], full_w=512)
    assert torch.equal(got[4], taps[0]) and torch.equal(got[5], taps[1])
    assert not torch.signbit(got[4]).any()
    # Frame 0 passes unmodified: its spectrum is the state it leaves.
    pow2 = pad_h & (pad_h - 1) == 0
    spec = fused.col_fft_zero_padded(*rows_in, pad_h) if pow2 else None
    if spec is not None:
        assert torch.equal(got[2], spec[0]) and torch.equal(got[3], spec[1])


def test_col_fft_kernel_matches_colspec_bootstrap(dev):
    """Kernel 5 against its plain version, and bit for bit against the
    spectrum kernel 2 carries out of a zero-prev bootstrap."""
    rng = np.random.default_rng(13)
    wk = hermitian_kept_width(1024)
    re, im = (_spectra(rng, (3, 192, wk), dev) for _ in range(2))
    n = fused.col_fft_zero_padded.launches
    got = fused.col_fft_zero_padded(re, im, 1024, row0=320)
    assert fused.col_fft_zero_padded.launches == n + 1
    want = fused.col_fft_zero_padded_ref(re.cpu(), im.cpu(), 1024, row0=320)
    assert _rel([g.cpu() for g in got], want) < 1e-4
    z = torch.zeros((1, 1024, wk), device=dev)
    for b in range(3):
        res = fused.colspec_chunk(re[b:b + 1], im[b:b + 1], z, z, _cfg(),
                                  1024, 320, full_w=1024)
        assert torch.equal(res[2][0], got[0][b])
        assert torch.equal(res[3][0], got[1][b])


def _tall_cfg(pad_mode, iir):
    change = dict(temporal=TemporalConfig(mode="iir_bandpass")) if iir else {}
    return _cfg().replace(pad_mode=pad_mode, **change)


@pytest.mark.parametrize("iir", [False, True], ids=["two_frame", "iir"])
def test_square_pow2_4k_kernels(dev, iir):
    """2160p at square_pow2 pads to H = 4096: kernels 2 and 6 on strips of
    2 columns and kernel 5's two passes, each against its plain version;
    kernel 6's rows equal kernel 2's and kernel 12's full variant equals
    kernel 6, bit for bit."""
    cfg = _tall_cfg("square_pow2", iir)
    h, fw, hc, row0, rows = 4096, 512, 2160, 968, (964, 3132)
    w = hermitian_kept_width(fw)
    rng = np.random.default_rng(30)
    rows_in = [_spectra(rng, (3, hc, w), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, w), dev) for _ in range(2)]
    taps = ([0.1 * _spectra(rng, (1, h, w), dev) for _ in range(2)]
            if iir else [])
    kw = dict(out_rows=rows, full_w=fw)
    n = fused.colspec_chunk.launches
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, *taps, **kw)
    assert fused.colspec_chunk.launches == n + 1
    want = fused.colspec_chunk_ref(*[x.cpu() for x in rows_in + prev], cfg,
                                   h, row0, *[x.cpu() for x in taps], **kw)
    for k in range(0, len(k2), 2):
        assert _rel([g.cpu() for g in k2[k:k + 2]], want[k:k + 2]) < 1e-4
    k5 = fused.col_fft_zero_padded(*rows_in, h, row0)
    want5 = fused.col_fft_zero_padded_ref(*[x.cpu() for x in rows_in], h,
                                          row0)
    assert _rel([g.cpu() for g in k5], want5) < 1e-4
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, k5)]
    tap6 = ([0.1 * _spectra(rng, (3, h, w), dev) for _ in range(2)]
            if iir else [])
    k6 = fused.phase_col_ifft(*k5, *prv, cfg, **kw,
                              **dict(zip(("lp_fast", "lp_slow"), tap6)))
    want6 = fused.phase_col_ifft_ref(
        *[x.cpu() for x in (*k5, *prv)], cfg, **kw,
        **dict(zip(("lp_fast", "lp_slow"), [x.cpu() for x in tap6])))
    assert _rel([g.cpu() for g in k6[:2]], want6[:2]) < 1e-4
    if iir:
        return
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])
    k12 = kdecomp.kdecomp_variant(*k5, *prv, cfg, kdecomp.VARIANTS[-1][1],
                                  rows, full_w=fw)
    assert all(torch.equal(a, b) for a, b in zip(k12, k6))


@pytest.mark.parametrize("iir", [False, True], ids=["two_frame", "iir"])
def test_tight_2160p_colspec_kernel(dev, iir):
    """2160p at tight pads to H = 2176 = 17 x 128: kernel 2's four-step
    instantiation for m up to 32 (kernel 6 takes pow-2 heights only, as
    the JAX phase_col_ifft)."""
    cfg = _tall_cfg("tight", iir)
    h, fw, hc, row0 = 2176, 512, 2176, 0
    w = hermitian_kept_width(fw)
    rng = np.random.default_rng(31)
    rows_in = [_spectra(rng, (3, hc, w), dev, True) for _ in range(2)]
    state = [_spectra(rng, (1, h, w), dev, True) for _ in range(2)]
    if iir:
        state += [0.1 * _spectra(rng, (1, h, w), dev) for _ in range(2)]
    kw = dict(out_rows=(8, 2168), full_w=fw)
    got = fused.colspec_chunk(*rows_in, *state[:2], cfg, h, row0,
                              *state[2:], **kw)
    want = fused.colspec_chunk_ref(*[x.cpu() for x in rows_in + state[:2]],
                                   cfg, h, row0,
                                   *[x.cpu() for x in state[2:]], **kw)
    assert len(got) == len(want) == 4 + len(state[2:])
    for k in range(0, len(got), 2):
        assert _rel([g.cpu() for g in got[k:k + 2]], want[k:k + 2]) < 1e-4


@pytest.mark.parametrize("h", [16384, 32768])
def test_column_kernels_past_8192_match_their_plain_versions(dev, h):
    """The column kernels past 8192 rows (fault F4, fixed: the bracket
    passes around the 8192-row blocks) against their plain versions on
    narrow planes: kernels 2 (two frames), 5, 6 and 12."""
    cfg = _cfg().replace(pad_mode="square_pow2")
    fw, hc = 256, h - 200
    w = hermitian_kept_width(fw)
    row0, rows = 100, (64, h - 64)
    rng = np.random.default_rng(h)
    rr, ri = _smooth_rows(rng, 3, hc, w, dev)
    order = torch.as_tensor(fused._col_order(h), device=dev)
    prev = fused._col_fft_ref(rr[0], ri[0], h, row0, order)
    args = (rr[1:].contiguous(), ri[1:].contiguous(),
            prev.real[None].contiguous(), prev.imag[None].contiguous(), cfg,
            h, row0)
    kw = dict(out_rows=rows, full_w=fw)
    got = fused.colspec_chunk(*args, **kw)
    want = fused.colspec_chunk_ref(*args, **kw)
    for k in range(0, 4, 2):
        assert _rel(got[k:k + 2], want[k:k + 2]) < 1e-4, k
    k5 = fused.col_fft_zero_padded(rr, ri, h, row0)
    assert _rel(k5, fused.col_fft_zero_padded_ref(rr, ri, h, row0)) < 1e-4
    cur = [x[1:].contiguous() for x in k5]
    prv = [x[:-1].contiguous() for x in k5]
    k6 = fused.phase_col_ifft(*cur, *prv, cfg, **kw)
    assert _rel(k6, fused.phase_col_ifft_ref(*cur, *prv, cfg, **kw)) < 1e-4
    k12 = kdecomp.kdecomp_variant(*cur, *prv, cfg, kdecomp.VARIANTS[-1][1],
                                  rows, full_w=fw)
    assert _rel(k12, kdecomp.kdecomp_variant_ref(
        *cur, *prv, cfg, kdecomp.VARIANTS[-1][1], rows, full_w=fw)) < 1e-4


@pytest.mark.parametrize("h", [512, 1024, 2048, 4096])
@pytest.mark.parametrize("where", ["row0_zero", "off_centre"])
def test_col_fft_kernel_equals_colspec_forward(dev, h, where):
    """Kernel 5 (the column engine's passes) equals kernel 2's forward
    half (the strip in shared memory) bit for bit: the spectrum kernel 2
    carries out of a zero-prev start of each frame."""
    hc = h // 2 + 40
    row0 = 0 if where == "row0_zero" else (h - hc) // 2 + 5
    w = hermitian_kept_width(512)
    rng = np.random.default_rng(h)
    re, im = (_spectra(rng, (2, hc, w), dev) for _ in range(2))
    got = fused.col_fft_zero_padded(re, im, h, row0)
    z = torch.zeros((1, h, w), device=dev)
    for b in range(2):
        res = fused.colspec_chunk(re[b:b + 1], im[b:b + 1], z, z,
                                  _cfg().replace(pad_mode="square_pow2"), h,
                                  row0, full_w=512)
        assert torch.equal(res[2][0], got[0][b])
        assert torch.equal(res[3][0], got[1][b])


def test_col_fft_kernel_8192(dev):
    rng = np.random.default_rng(32)
    re, im = (_spectra(rng, (1, 4320, 128), dev) for _ in range(2))
    n = fused.col_fft_zero_padded.launches
    got = fused.col_fft_zero_padded(re, im, 8192, 1936)
    assert fused.col_fft_zero_padded.launches == n + 1
    want = fused.col_fft_zero_padded_ref(re.cpu(), im.cpu(), 8192, 1936)
    assert _rel([g.cpu() for g in got], want) < 1e-4


_QUIRKS = {
    "real": dict(reconstruct="real"),
    "compensate": dict(compensate_window=True),
    "gains": dict(apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8)),
    "all": dict(reconstruct="real", compensate_window=True,
                apply_yiq_gains=True, yiq_gains=(0.9, 1.3, 0.7)),
}


@pytest.mark.parametrize("quirk", sorted(_QUIRKS))
@pytest.mark.parametrize("layout", ["tuple3", "planar_u8"])
def test_post_kernel_quirks(dev, quirk, layout):
    in_h, in_w = 320, 384
    cfg = _cfg().replace(**_QUIRKS[quirk])
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    wk, hr = hermitian_kept_width(g.pad_w), rows[1] - rows[0]
    rng = np.random.default_rng(14)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    args = (_rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            hann2d_region(g, device=dev), cfg, rows[0], in_h, in_w, "tight")
    kw = dict(full_w=g.pad_w, out_layout=layout)
    got = post_fused.rowifft_post_fused(*args, **kw)
    want = post_fused.rowifft_post_fused_ref(*args, **kw)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-4
    else:
        assert int((got.int() - want.int()).abs().max()) <= 1


@pytest.mark.parametrize("quirk", ["none"] + sorted(_QUIRKS))
@pytest.mark.parametrize("layout", ["tuple3", "planar", "planar_u8"])
def test_post_rgb_kernel(dev, quirk, layout):
    in_h, in_w = 320, 384
    cfg = _cfg().replace(chroma="rgb", **_QUIRKS.get(quirk, {}))
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(15)
    chans3 = torch.from_numpy(rng.uniform(
        -0.2, 0.9, (6, hr, g.pad_w)).astype(np.float32)).to(dev)
    args = (chans3, hann2d_region(g, device=dev), cfg, rows[0], in_h, in_w,
            "tight")
    n = post_fused.post_fused_rgb.launches
    got = post_fused.post_fused_rgb(*args, out_layout=layout)
    assert post_fused.post_fused_rgb.launches == n + 1
    want = post_fused.post_fused_rgb_ref(*[a.cpu() if torch.is_tensor(a)
                                           else a for a in args],
                                         out_layout=layout)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) < 1e-5
    elif layout == "planar":
        assert float((got.cpu() - want).abs().max()) < 1e-5
    else:
        assert int((got.cpu().int() - want.int()).abs().max()) <= 1
        planar = post_fused.post_fused_rgb(*args, out_layout="planar")
        assert torch.equal(got, torch.round(planar * 255.0).to(torch.uint8))


@pytest.mark.parametrize("hb,w", [(384, 512), (64, 2048)])
def test_row_ifft_kernel_real(dev, hb, w):
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(16)
    scale = 0.3 * hb * np.sqrt(w)
    re, im = (_rand(rng, (3, hb, wk), dev, scale) for _ in range(2))
    got = fused.row_ifft_magnitude(re, im, magnitude=False, pad_h=hb,
                                   full_w=w)
    want = fused.row_ifft_magnitude_ref(re.cpu(), im.cpu(), magnitude=False,
                                        pad_h=hb, full_w=w)
    assert _rel([got.cpu()], [want]) < 1e-4


_PATHS = {
    "square_pow2": dict(pad_mode="square_pow2"),
    "rgb_iir": dict(chroma="rgb", temporal=TemporalConfig(mode="iir_bandpass")),
    "standard_rect": dict(pad_mode="rect_pow2", mode="standard",
                          phase_scale=2.5),
    "steer_real_comp": dict(orientations=4, pyramid_levels=6,
                            reconstruct="real", compensate_window=True,
                            apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8)),
    "bypass_pow2": dict(pad_mode="square_pow2",
                        apply_motion_magnification=False),
}


@pytest.mark.parametrize("name", sorted(_PATHS))
def test_config_matrix_on_card_matches_cpu(dev, name):
    rng = np.random.default_rng(17)
    base = rng.random((320, 384, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) * (0.95 + 0.01 * i)
                     for i in range(5)]).astype(np.float32)
    cfg = _cfg().replace(**_PATHS[name])
    out_d, st_d = magnify_video(torch.from_numpy(clip).to(dev), cfg)
    out_c, st_c = magnify_video(torch.from_numpy(clip), cfg)
    mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
    assert mse == 0 or 10 * np.log10(1 / mse) > 100
    assert _rel([st_d.prev_spec_re.cpu(), st_d.prev_spec_im.cpu()],
                [st_c.prev_spec_re, st_c.prev_spec_im]) < 1e-4
    o1, s1 = magnify_video(torch.from_numpy(clip[:2]).to(dev), cfg)
    o2, s2 = magnify_video(torch.from_numpy(clip[2:]).to(dev), cfg, s1)
    assert torch.equal(torch.cat([o1, o2]), out_d)
    assert torch.equal(s2.prev_spec_re, st_d.prev_spec_re)


# -- the scan engine and the unfused backends: kernels 6, 8, 9, 10, the
#    default device ------------------------------------------------------------

from pbmm_tpu_torch.engine.pipeline import magnify_frame_pair  # noqa: E402
from pbmm_tpu_torch.phase import fused_kernels  # noqa: E402
from pbmm_tpu_torch.pyramid.filters import freq_axes  # noqa: E402
from pbmm_tpu_torch.spectral import radix2  # noqa: E402

_K6 = {
    "main": dict(),
    "iir": dict(temporal=TemporalConfig(mode="iir_bandpass")),
    "standard": dict(mode="standard"),
    "steerable_overlapping": dict(orientations=4, pyramid_levels=6),
    "non_integer": dict(phase_scale=2.5),
}


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("name", sorted(_K6))
@pytest.mark.parametrize("h,fw,kept", [(256, 512, True), (1024, 2048, False),
                                       (2048, 256, True)])
def test_phase_col_ifft_kernel(dev, name, h, fw, kept, b):
    """Kernel 6 against its plain version in every branch, at three
    heights and B = 1, 3 and 16 frames a launch (a grid of strips x
    frames), with signed zeros in the spectra; with the IIR taps, each
    frame's taps written back."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K6[name])
    w = hermitian_kept_width(fw) if kept else fw
    rng = np.random.default_rng(18)
    spec = [_spectra(rng, (b, h, w), dev, True) for _ in range(4)]
    taps = ([0.1 * _spectra(rng, (b, h, w), dev) for _ in range(2)]
            if cfg.temporal.mode == "iir_bandpass" else [])
    kw = dict(out_rows=(h // 4, 3 * h // 4), full_w=fw,
              **dict(zip(("lp_fast", "lp_slow"), taps)))
    n = fused.phase_col_ifft.launches
    got = fused.phase_col_ifft(*spec, cfg, **kw)
    assert fused.phase_col_ifft.launches == n + 1
    want = fused.phase_col_ifft_ref(
        *[x.cpu() for x in spec], cfg,
        **{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()})
    assert len(got) == len(want) == 2 + len(taps)
    assert _rel([g.cpu() for g in got[:2]], want[:2]) < 1e-4
    if taps:  # the taps, weighted by the magnitude of the bin each rotates
        mag = torch.complex(*[x.cpu() for x in spec[:2]]).abs()
        for g, w_ in zip(got[2:], want[2:]):
            assert float(((g.cpu() - w_).abs() * mag).max()) < 1e-4 * float(
                (w_.abs() * mag).max())


@pytest.mark.parametrize("name", sorted(_K6))
@pytest.mark.parametrize("p", [2, 4, 8])
def test_phase_col_ifft_fx_values(dev, name, p):
    """Kernel 6 with `fx_values` (the spatial engine's shards: a (B, 2048,
    2048 / p) column slice and its slice of the bit-reversed lane table, no
    host plane) against its plain version in every branch; the columns
    equal, bit for bit, the same columns of one full-width call with the
    whole table; standard mode rotates (its output differs from the
    inverse of the unmodified spectrum)."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K6[name])
    h, fw = 2048, 2048
    w, idx = fw // p, p - 1
    table = torch.from_numpy(radix2.bitrev_freq_axis(fw)).to(dev)
    fx = table[idx * w:(idx + 1) * w].contiguous()
    rng = np.random.default_rng(19)
    full = [_spectra(rng, (3, h, fw), dev, True) for _ in range(4)]
    taps_full = ([0.1 * _spectra(rng, (3, h, fw), dev) for _ in range(2)]
                 if cfg.temporal.mode == "iir_bandpass" else [])

    def cols(x):
        return x[..., idx * w:(idx + 1) * w].contiguous()

    spec, taps = [cols(x) for x in full], [cols(x) for x in taps_full]
    kw = dict(zip(("lp_fast", "lp_slow"), taps))
    got = fused.phase_col_ifft(*spec, cfg, fx_values=fx, **kw)
    want = fused.phase_col_ifft_ref(
        *[x.cpu() for x in spec], cfg, fx_values=fx.cpu(),
        **{k: v.cpu() for k, v in kw.items()})
    assert _rel([g.cpu() for g in got[:2]], want[:2]) < 1e-4
    if taps:
        mag = torch.complex(*[x.cpu() for x in spec[:2]]).abs()
        for g, w_ in zip(got[2:], want[2:]):
            assert float(((g.cpu() - w_).abs() * mag).max()) < 1e-4 * float(
                (w_.abs() * mag).max())
    whole = fused.phase_col_ifft(*full, cfg, fx_values=table,
                                 **dict(zip(("lp_fast", "lp_slow"),
                                            taps_full)))
    assert all(torch.equal(g, cols(x)) for g, x in zip(got, whole))
    if name == "standard":
        plain = radix2._fft_axis(spec[0], spec[1], 1, True)
        assert _rel([got[0] - plain[0]], [plain[0]]) > 1e-3


def test_phase_col_ifft_standard_needs_weight(dev):
    """The launch refuses standard mode with neither its host plane nor
    the weight's terms (it would rotate by nothing), and takes the same
    call with the terms."""
    from pbmm_tpu_torch.kernels import c_floats, c_ints, stream_handle
    from pbmm_tpu_torch.kernels.build import library

    cfg = _cfg().replace(pad_mode="square_pow2", mode="standard")
    h, w = 256, 128
    rng = np.random.default_rng(20)
    spec = [_spectra(rng, (1, h, w), dev) for _ in range(4)]
    fy = torch.from_numpy(fused.col_freq_axis(h)).to(dev)
    fx = torch.from_numpy(radix2.bitrev_freq_axis(w)).to(dev)
    tw = [torch.from_numpy(t).to(dev) for t in
          radix2.compact_twiddles(h, True)]
    outs = [torch.empty((1, h, w), device=dev) for _ in range(2)]
    ints, floats = fused._phase_args(fused._phase_plan(cfg), False)
    std_weight = 6 + 2 * fused._MAX_LEVELS  # PhaseArgs::std_weight
    assert ints[std_weight] == 1

    def launch(ints_):
        return library().pbmm_phase_col_ifft(
            *fused._ptrs(*spec, None, None, None, None, fy, fx, *tw, *outs,
                         None, None, None, None),
            c_ints(ints_), c_floats(floats), 1, h, w, 0, h,
            fused.phase_col_strip(h, w), stream_handle(dev))

    assert launch(ints[:std_weight] + [0] + ints[std_weight + 1:]) != 0
    assert launch(ints) == 0
    torch.cuda.synchronize()
    want = fused.phase_col_ifft_ref(*[x.cpu() for x in spec], cfg,
                                    fx_values=fx.cpu())
    assert _rel([o.cpu() for o in outs], want) < 1e-4


_K6_EQ = {"main": dict(), "standard": dict(mode="standard"),
          "steerable_overlapping": dict(orientations=4, pyramid_levels=6),
          "non_integer": dict(phase_scale=2.5)}


@pytest.mark.parametrize("name", sorted(_K6_EQ))
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("h", [64, 512, 2048, 4096])
def test_phase_col_ifft_kernel_equals_colspec(dev, h, b, name):
    """On the spectra kernel 5 gives, kernel 6's rows equal kernel 2's bit
    for bit over 16 frames (the shared phase pass and inverse of
    csrc/phase_inv.cuh), launched b frames at a time (a grid of strips x
    b frames), in every branch kernel 2 runs frame-parallel, at the
    1080p kept width; and kernel 12's full variant equals kernel 6.  At
    H = 64 a block's 256 strip words leave half its threads without one
    (the ragged last round of the asynchronous copies)."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K6_EQ[name])
    fw, t = 2048, 16
    wk = hermitian_kept_width(fw)
    hc, row0 = (h // 2 + 40, h // 4 - 8) if h >= 512 else (h // 2, h // 8)
    rows = (h // 8, h - h // 8)
    rng = np.random.default_rng(19 + h)
    rows_in = [_spectra(rng, (t, hc, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, wk), dev) for _ in range(2)]
    kw = dict(out_rows=rows, full_w=fw)
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, **kw)
    cur = fused.col_fft_zero_padded(*rows_in, h, row0)
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, cur)]
    n = fused.phase_col_ifft.launches
    for f0 in range(0, t, b):
        part = [x[f0:f0 + b] for x in (*cur, *prv)]
        k6 = fused.phase_col_ifft(*part, cfg, **kw)
        assert torch.equal(k6[0], k2[0][f0:f0 + b])
        assert torch.equal(k6[1], k2[1][f0:f0 + b])
        k12 = kdecomp.kdecomp_variant(*part, cfg, kdecomp.VARIANTS[-1][1],
                                      rows, full_w=fw)
        assert all(torch.equal(a, c) for a, c in zip(k12, k6))
    assert fused.phase_col_ifft.launches == n + -(-t // b)


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("axis,shape", [(1, (2, 8, 40)), (2, (3, 5, 8)),
                                        (1, (1, 4096, 24)),
                                        (2, (1, 16, 8192)),
                                        (1, (2, 512, 512))])
def test_fft_axis_kernel(dev, axis, shape, kind):
    rng = np.random.default_rng(20)
    re, im = (_rand(rng, shape, dev) for _ in range(2))
    im = None if kind == "forward_real" else im
    inverse = kind == "inverse_scaled"
    scale = 1.0 / (shape[1] * shape[2]) if inverse else 1.0
    n = radix2._fft_axis.launches
    got = radix2._fft_axis(re, im, axis, inverse, scale)
    assert radix2._fft_axis.launches == n + 1
    want = radix2._fft_axis_ref(re.cpu(), None if im is None else im.cpu(),
                                axis, inverse, scale)
    assert _rel([g.cpu() for g in got], want) < 1e-4


@pytest.mark.parametrize("layout", ["centered", "bitrev2d"])
@pytest.mark.parametrize("change", [dict(), dict(phase_scale=2.5),
                                    dict(orientations=4),
                                    dict(pyramid_levels=7, phase_scale=0.0)],
                         ids=["integer", "scale_2_5", "steerable",
                              "levels7_zero"])
def test_amplify_procedural_kernel(dev, layout, change):
    cfg = MagnifyConfig(**change)
    h, w = 256, 512
    rng = np.random.default_rng(21)
    spec = [_spectra(rng, (2, h, w), dev, True) for _ in range(4)]
    fy, fx = freq_axes(h, w, layout, dev)
    args = (*spec, fy[:, 0].contiguous(), fx[0].contiguous(),
            cfg.pyramid_levels, cfg.min_frequency, cfg.max_frequency,
            cfg.phase_scale, cfg.magnitude_threshold, cfg.orientations)
    n = fused_kernels.amplify_procedural.launches
    got = fused_kernels.amplify_procedural(*args)
    assert fused_kernels.amplify_procedural.launches == n + 1
    want = fused_kernels.amplify_procedural_ref(*args)
    assert _rel([g.cpu() for g in got], [x.cpu() for x in want]) < 1e-4


@pytest.mark.parametrize("layout", ["tuple3", "planar", "planar_u8"])
@pytest.mark.parametrize("quirk", ["none", "all"])
def test_post_fused_kernel(dev, layout, quirk):
    in_h, in_w = 320, 384
    cfg = _cfg().replace(**_QUIRKS.get(quirk, {}))
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(22)
    rec = torch.from_numpy(rng.uniform(0, 0.9, (2, hr, g.pad_w)).astype(
        np.float32)).to(dev)
    args = (rec, _rand(rng, (2, in_h, in_w), dev, 0.3),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            hann2d_region(g, device=dev), cfg, rows[0], in_h, in_w, "tight")
    n = post_fused.post_fused.launches
    got = post_fused.post_fused(*args, out_layout=layout)
    assert post_fused.post_fused.launches == n + 1
    want = post_fused.post_fused_ref(*[a.cpu() if torch.is_tensor(a) else a
                                       for a in args], out_layout=layout)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) < 1e-5
    elif layout == "planar":
        assert float((got.cpu() - want).abs().max()) < 1e-5
    else:
        assert int((got.cpu().int() - want.int()).abs().max()) <= 1


_SCAN = {
    "default": MagnifyConfig(),
    "tuned_scan": _cfg().replace(pad_mode="square_pow2", engine="scan"),
    "tuned_no_cache_iir": _cfg().replace(
        pad_mode="rect_pow2", cache_prev_spectrum=False,
        temporal=TemporalConfig(mode="iir_bandpass")),
    "pallas_unfused_k9": MagnifyConfig(fft_backend="pallas", use_rfft=False,
                                       use_pallas=True),
    "xla_k9": MagnifyConfig(use_rfft=False, use_pallas=True),
}


@pytest.mark.parametrize("name", sorted(_SCAN))
def test_scan_paths_on_card_match_cpu(dev, name):
    rng = np.random.default_rng(23)
    base = rng.random((320, 384, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) * (0.95 + 0.01 * i)
                     for i in range(4)]).astype(np.float32)
    cfg = _SCAN[name]
    out_d, _ = magnify_video(clip, cfg)  # numpy lands on the card
    assert out_d.device.type == "cuda"
    out_c, _ = magnify_video(clip, cfg, device="cpu")
    mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
    assert mse == 0 or 10 * np.log10(1 / mse) > 100
    o1, s1 = magnify_video(clip[:2], cfg)
    o2, _ = magnify_video(clip[2:], cfg, s1)
    assert torch.equal(torch.cat([o1, o2]), out_d)
    if cfg.temporal.mode != "two_frame":
        return  # the pair is two-frame by definition
    pair = magnify_frame_pair(clip[1], clip[2], cfg)
    assert pair.device.type == "cuda"
    pair_c = magnify_frame_pair(clip[1], clip[2], cfg, device="cpu")
    assert float((pair.cpu() - pair_c).abs().max()) < 1e-3


def test_load_state_defaults_to_the_card(dev, tmp_path):
    from pbmm_tpu_torch.engine.state import load_state, save_state

    clip = np.random.default_rng(24).random((2, 64, 128, 3)).astype(
        np.float32)
    _, st = magnify_video(clip, MagnifyConfig(), device="cpu")
    ck = str(tmp_path / "ck.npz")
    save_state(st, ck)
    back = load_state(ck)
    assert back.prev_spec_re.device.type == "cuda"
    assert torch.equal(back.prev_spec_re.cpu(), st.prev_spec_re)
    assert load_state(ck, device="cpu").prev_spec_re.device.type == "cpu"


# -- the diagnostics' kernels: 12 (kdecomp), 13 (copy probe), 14 (trig
#    probe), and debug_mode on the card ----------------------------------------

from pbmm_tpu_torch.tools import kdecomp, kexp, trig_probe  # noqa: E402
from pbmm_tpu_torch.utils.checks import debug_mode  # noqa: E402

_K12 = {"main": dict(), "standard": dict(mode="standard"),
        "steerable_overlapping": dict(orientations=4, pyramid_levels=6),
        "non_integer": dict(phase_scale=2.5)}


@pytest.mark.parametrize("h", [256, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("cfg_name", sorted(_K12))
@pytest.mark.parametrize("name,pieces", kdecomp.VARIANTS,
                         ids=[n for n, _ in kdecomp.VARIANTS])
def test_kdecomp_kernel(dev, cfg_name, name, pieces, h):
    """Kernel 12 against its plain version in every piece set and phase
    branch (the main branch and the general pass), at 1080p's kept lanes
    (H = 256) and at a narrow width on the heights whose strips kernel 6
    takes 16, 8, 4 and 2 columns (`phase_col_strip`).  Without the phase
    piece it is bit for bit its plain version (the plain version's whole
    inverse is `torch.fft`'s, so the whole inverse is held bit for bit
    against `_inverse_stages_ref` over every stage instead, and to 1e-4
    against the plain version); with it, to 1e-4; its full variant is
    kernel 6 bit for bit."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K12[cfg_name])
    w, fw = (hermitian_kept_width(2048), 2048) if h == 256 else (64, None)
    rng = np.random.default_rng(25)
    spec = [_spectra(rng, (2, h, w), dev, True) for _ in range(4)]
    rows = (h // 8, h - h // 8)
    n = kdecomp.kdecomp_variant.launches
    got = kdecomp.kdecomp_variant(*spec, cfg, pieces, rows, full_w=fw)
    assert kdecomp.kdecomp_variant.launches == n + 1
    cpu = [x.cpu() for x in spec]
    want = kdecomp.kdecomp_variant_ref(*cpu, cfg, pieces, rows, full_w=fw)
    got = [g.cpu() for g in got]
    if "phase" in pieces or {"gm", "rolls"} <= set(pieces):
        assert _rel(got, want) < 1e-4
    else:
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    if set(pieces) == {"gm", "rolls"}:
        whole = kdecomp._inverse_stages_ref(cpu[0] + cpu[2], cpu[1] + cpu[3],
                                            range(h.bit_length() - 1))
        assert all(torch.equal(g, w_[:, rows[0]:rows[1]])
                   for g, w_ in zip(got, whole))
    if len(pieces) == 3:
        k6 = fused.phase_col_ifft(*spec, cfg, out_rows=rows, full_w=fw)
        assert all(torch.equal(g, k.cpu()) for g, k in zip(got, k6))


@pytest.mark.parametrize("pattern,block,shape", [
    *((p, b, sh) for sh in ((1, 1152, 2048), (3, 37, 256))
      for p, b in (("rows", 1), ("rows", 64), ("lanes", 1), ("lanes", 2),
                   ("lanes", 4), ("lanes", 8), ("lanes", 16),
                   ("lanes", 32))),
    # A width whose rows are not 16-byte aligned: scalar heads and tails,
    # and strips of 8-byte and 4-byte copies.
    *((p, b, (2, 37, 2050)) for p, b in (("rows", 1), ("rows", 64),
                                         ("lanes", 1), ("lanes", 2)))])
def test_copy_probe_kernel(dev, pattern, block, shape):
    rng = np.random.default_rng(26)
    a, b = (_rand(rng, shape, dev) for _ in range(2))
    n = kexp.copy_probe.launches
    oa, ob = kexp.copy_probe(a, b, pattern, block)
    assert kexp.copy_probe.launches == n + 1
    assert torch.equal(oa, a) and torch.equal(ob, b)


def test_copy_probe_kernel_on_offset_planes(dev):
    """Planes that start 4 and 8 bytes past a 16-byte boundary: the rows'
    scalar heads, the strips' narrower copies."""
    rng = np.random.default_rng(27)
    base = _rand(rng, (2 * 37 * 256 + 3,), dev)
    a = base[1:1 + 37 * 256].view(1, 37, 256)
    b = base[2 + 37 * 256:2 + 2 * 37 * 256].view(1, 37, 256)
    for pattern, block in (("rows", 1), ("rows", 5), ("lanes", 4),
                           ("lanes", 8)):
        oa, ob = kexp.copy_probe(a, b, pattern, block)
        assert torch.equal(oa, a) and torch.equal(ob, b)


def test_copy_probe_kernel_refuses_a_strip_that_does_not_divide(dev):
    a = torch.zeros((1, 64, 100), device=dev)
    with pytest.raises(ValueError):
        kexp.copy_probe(a, a, "lanes", 8)


@pytest.mark.parametrize("shape", [(3, 40), (17, 128)])
@pytest.mark.parametrize("op", sorted(trig_probe.OPS))
def test_trig_probe_kernel(dev, op, shape):
    """Every op code against its plain version at random shapes, exact
    zeros in the first row."""
    rng = np.random.default_rng(27)
    _, n_in, n_out = trig_probe.OPS[op]
    ins = [_rand(rng, shape, dev, 3.0) for _ in range(n_in)]
    for x in ins:
        x[0] = 0.0
    kw = {"mask": dict(arg=3, consts=(0.05, 0.45)), "pow_int": dict(arg=5),
          "unit_pow": dict(arg=10)}.get(op, {})
    if op == "mask":
        ins = [x.abs() / 6 for x in ins]
    if op == "phase_std":
        ins[4] = ins[4].abs()
        kw = dict(cfg=MagnifyConfig(mode="standard"),
                  fy=_rand(rng, (shape[0],), dev, 0.3),
                  fx=_rand(rng, (shape[1],), dev, 0.3))
    got = trig_probe.trig_probe(op, *ins, **kw)
    want = trig_probe.trig_probe_ref(op, *ins, **kw)
    assert len(got) == len(want) == n_out
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w_).abs().max()) <= 1e-5 * max(
            1.0, float(w_.abs().max()))


def test_trig_probe_kernel_every_case(dev):
    rows = trig_probe.run_probe(dev)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]


def test_debug_mode_catches_a_planted_nan_on_the_card(dev):
    a = torch.zeros((1, 64, 128), device=dev)
    a[0, 3, 5] = float("nan")
    kexp.copy_probe(a, a, "rows", 1)
    with debug_mode():
        with pytest.raises(FloatingPointError, match="copy_probe"):
            kexp.copy_probe(a, a, "rows", 1)
        kexp.copy_probe(torch.zeros_like(a), a.nan_to_num(), "lanes", 4)


def test_stage_times_and_timeit_on_the_card(dev):
    from pbmm_tpu_torch.oracle.synthetic import oscillating_bar
    from pbmm_tpu_torch.utils.profiling import stage_times, timeit

    got = stage_times(oscillating_bar(size=64, frames=3), MagnifyConfig(),
                      device=dev, reps=2)
    assert list(got) == ["preprocess_fft", "phase_amplify",
                         "ifft_postprocess"]
    assert all(0 < v < 1 for v in got.values())
    x = torch.ones((1 << 20,), device=dev)
    assert 0 < timeit(lambda a: a * 2, x, reps=3) < 1


# -- the column engine of kernels 5 and 8 at every length, blur radii above
#    4 (kernels 3, 10, 11 and the kernel 7 + 10 route), 1080p end to end --------


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("n", [2, 8, 128, 2048, 8192])
@pytest.mark.parametrize("w", [24, 40, 1000])
def test_fft_axis_column_kernel(dev, n, w, kind):
    """Kernel 8's column pass (col_pass.cuh: one to three passes, ragged
    last tile of 32 columns) against its plain version."""
    rng = np.random.default_rng(n + w)
    shape = (2 if n <= 2048 else 1, n, w)
    re, im = (_rand(rng, shape, dev) for _ in range(2))
    im = None if kind == "forward_real" else im
    inverse = kind == "inverse_scaled"
    scale = 1.0 / (n * w) if inverse else 1.0
    got = radix2._fft_axis(re, im, 1, inverse, scale)
    want = radix2._fft_axis_ref(re.cpu(), None if im is None else im.cpu(),
                                1, inverse, scale)
    assert _rel([g.cpu() for g in got], want) < 1e-4


def _blur_cfg(blur_size, **change):
    return _cfg().replace(blur_size=blur_size, **change)


@pytest.mark.parametrize("blur_size", [0.75, 1.5, 4.0, 4.5])
@pytest.mark.parametrize("src,layout", [("f32", "tuple3"),
                                        ("u8", "planar_u8"),
                                        ("u8", "planar"),
                                        ("f32", "planar_u8")])
def test_post_kernel_blur_radius(dev, blur_size, src, layout):
    """Kernel 3 at blur radii 3 and 5 and, at 13 and 15, the kernel 7 +
    kernel 10 route that replaces it from radius 6 at 1080p (at 15 no kernel-3
    block fits a padded width of 2048 and 1920 columns), each against
    kernel 3's plain version at 1080p tight."""
    cfg = _blur_cfg(blur_size)
    in_h, in_w = 1080, 1920
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    wk, hr = hermitian_kept_width(g.pad_w), rows[1] - rows[0]
    r = post_fused._radius(cfg)
    rng = np.random.default_rng(33)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    rre, rim = (_rand(rng, (2, hr, wk), dev, scale) for _ in range(2))
    if src == "f32":
        chroma = (_rand(rng, (2, in_h, in_w), dev, 0.3),
                  _rand(rng, (2, in_h, in_w), dev, 0.3), None)
    else:
        chroma = (None, None, torch.from_numpy(rng.integers(
            0, 256, (2, 3, in_h, in_w), dtype=np.uint8)).to(dev))
    args = (rre, rim, chroma[0], chroma[1], hann2d_region(g, device=dev),
            cfg, rows[0], in_h, in_w, "tight")
    kw = dict(full_w=g.pad_w, src=chroma[2], out_layout=layout)
    counts = {f: f.launches for f in (post_fused.rowifft_post_fused,
                                      fused.row_ifft_magnitude,
                                      post_fused.post_fused)}
    got = post_fused.rowifft_post_fused(*args, **kw)
    routed = not post_fused.kernel3_serves(r, g.pad_w, in_w)
    assert routed == (r >= 13)
    moved = {f: f.launches - n for f, n in counts.items()}
    assert moved == {post_fused.rowifft_post_fused: int(not routed),
                     fused.row_ifft_magnitude: int(routed),
                     post_fused.post_fused: int(routed)}
    want = post_fused.rowifft_post_fused_ref(*args, **kw)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-4
    elif layout == "planar":
        assert float((got - want).abs().max()) < 1e-4
    else:
        assert got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1


@pytest.mark.parametrize("blur_size", [0.75, 1.5, 4.0])
@pytest.mark.parametrize("layout", ["tuple3", "planar_u8"])
def test_post_rgb_and_yonly_kernels_blur_radius(dev, blur_size, layout):
    """Kernels 11 and 10 (f32 and uint8 chroma) at blur radii 3, 5, 13,
    against their plain versions at 1080p tight."""
    in_h, in_w = 1080, 1920
    g = geometry_for(in_h, in_w, "tight")
    cfg = _blur_cfg(blur_size)
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(34)
    win = hann2d_region(g, device=dev)
    rec3 = torch.from_numpy(rng.uniform(
        -0.2, 0.9, (6, hr, g.pad_w)).astype(np.float32)).to(dev)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 3, in_h, in_w),
                                       dtype=np.uint8)).to(dev)
    iq = [_rand(rng, (2, in_h, in_w), dev, 0.3) for _ in range(2)]
    common = (win, cfg, rows[0], in_h, in_w, "tight")
    calls = {
        "k11": (post_fused.post_fused_rgb, post_fused.post_fused_rgb_ref,
                (rec3, *common), dict(out_layout=layout)),
        "k10_f32": (post_fused.post_fused, post_fused.post_fused_ref,
                    (rec3[0::3].contiguous(), *iq, *common),
                    dict(out_layout=layout)),
        "k10_u8": (post_fused.post_fused, post_fused.post_fused_ref,
                   (rec3[0::3].contiguous(), None, None, *common),
                   dict(out_layout=layout, src=u8)),
    }
    for name, (kern, ref, args, kw) in calls.items():
        n = kern.launches
        got = kern(*args, **kw)
        assert kern.launches == n + 1, name
        want = ref(*args, **kw)
        if layout == "tuple3":
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) < 1e-4, name
        else:
            assert int((got.int() - want.int()).abs().max()) <= 1, name


# Kernels 10 and 11's tile (csrc/post_rgb.cu): geometries whose halo admits
# the radius; "r96" is one `post_pallas_ok` admits at radius 96 (output
# blocks of 192 rows, the region from the blur's first row).
_TILE_GEOMS = {"1080p": (1080, 1920, "tight"),
               "w128": (136, 128, "square_pow2"),
               "r96": (576, 1152, "square_pow2")}
_QUIRK_ALL = dict(compensate_window=True, apply_yiq_gains=True,
                  yiq_gains=(1.0, 1.2, 0.8))


def _tile_case(dev, geom_name, radius, t, monkeypatch, seed):
    if radius == 0:
        monkeypatch.setattr(post_fused, "blur_taps", lambda b: (0.75,))
    in_h, in_w, pad_mode = _TILE_GEOMS[geom_name]
    cfg = _cfg().replace(pad_mode=pad_mode,
                         blur_size=max(radius - 0.5, 0.5) / 3.2307692308)
    assert post_fused._radius(cfg) == radius
    g = geometry_for(in_h, in_w, pad_mode)
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(seed)
    rec3 = torch.from_numpy(rng.uniform(
        -0.2, 0.9, (3 * t, hr, g.pad_w)).astype(np.float32)).to(dev)
    u8 = torch.from_numpy(rng.integers(0, 256, (t, 3, in_h, in_w),
                                       dtype=np.uint8)).to(dev)
    iq = [_rand(rng, (t, in_h, in_w), dev, 0.3) for _ in range(2)]
    common = (hann2d_region(g, device=dev), rows[0], in_h, in_w, pad_mode)
    return cfg, g, rows, rec3, u8, iq, common


def _check_tile_kernels(cfg, rec3, u8, iq, common):
    """Kernels 11, 10 (f32 I/Q) and 10 (uint8 frames), in tuple3 and,
    with compensation and gains, planar and planar_u8, against their
    plain versions: f32 max abs < 1e-5, uint8 1 code, planar_u8 =
    rint(255 planar) bit for bit."""
    win, rows0, in_h, in_w, pad_mode = common
    y_rows = rec3[0::3].contiguous()
    calls = {
        "k11": (post_fused.post_fused_rgb, post_fused.post_fused_rgb_ref,
                lambda c: (rec3, win, c.replace(chroma="rgb"), rows0, in_h,
                           in_w, pad_mode), {}),
        "k10_f32": (post_fused.post_fused, post_fused.post_fused_ref,
                    lambda c: (y_rows, *iq, win, c, rows0, in_h, in_w,
                               pad_mode), {}),
        "k10_u8": (post_fused.post_fused, post_fused.post_fused_ref,
                   lambda c: (y_rows, None, None, win, c, rows0, in_h, in_w,
                              pad_mode), dict(src=u8)),
    }
    for name, (kern, ref, args, kw) in calls.items():
        for layout, c in (("tuple3", cfg), ("planar", cfg.replace(
                **_QUIRK_ALL)), ("planar_u8", cfg.replace(**_QUIRK_ALL))):
            n = kern.launches
            got = kern(*args(c), out_layout=layout, **kw)
            assert kern.launches == n + 1, name
            want = ref(*args(c), out_layout=layout, **kw)
            if layout == "tuple3":
                for a, b in zip(got, want):
                    assert float((a - b).abs().max()) < 1e-5, name
            elif layout == "planar":
                assert float((got - want).abs().max()) < 1e-5, name
                planar = got
            else:
                assert got.dtype == torch.uint8
                assert int((got.int() - want.int()).abs().max()) <= 1, name
                assert torch.equal(got, torch.round(planar * 255.0).to(
                    torch.uint8)), name


@pytest.mark.parametrize("radius", [0, 1, 2, 5, 13, 15, 31])
@pytest.mark.parametrize("geom_name,t", [("1080p", 1), ("1080p", 16),
                                         ("w128", 1), ("w128", 16)])
def test_post_tile_kernels(dev, geom_name, t, radius, monkeypatch):
    """Kernels 10 and 11 (`post_fused.post_tile`'s strips, rows a group
    and runs) at radii 0-31, crop widths 1920 (strips of 256, the last of
    128) and 128, one frame and 16, every chroma source and layout and
    the quirks, against their plain versions."""
    cfg, g, rows, rec3, u8, iq, common = _tile_case(
        dev, geom_name, radius, t, monkeypatch, 50 + radius)
    _check_tile_kernels(cfg, rec3, u8, iq, common)


@pytest.mark.parametrize("t", [1, 16])
def test_post_tile_kernels_radius_96(dev, t):
    """Radius 96, the largest `post_pallas_ok` admits (576 x 1152 at
    square_pow2, output blocks of 192 rows): kernel 11 on strips of 64
    columns (a 147 KB ring), kernel 10 on strips of 256."""
    cfg, g, rows, rec3, u8, iq, common = _tile_case(
        dev, "r96", 96, t, None, 96)
    assert post_fused.post_pallas_ok(g, cfg, rows[0], rows[1] - rows[0])
    regs = post_fused._tile_regs(post_fused._CH_RGB, 0, dev)
    assert post_fused.post_tile(96, g.in_w, g.in_h, t, 3, regs)[0] == 64
    _check_tile_kernels(cfg, rec3, u8, iq, common)


def test_post_tile_regs_and_smem_contract(dev, monkeypatch):
    """Kernels 10 and 11's launch contract: each of the nine
    instantiations reports its registers a thread (1-255) for the tile
    planner, and a launch given any shared-memory size but that of the
    kernel's carve-up (`post_tile_smem`) is refused with
    cudaErrorInvalidValue (1) and counts no launch."""
    for chroma in (post_fused._CH_IQ, post_fused._CH_U8, post_fused._CH_RGB):
        for layout in range(3):
            assert 1 <= post_fused._tile_regs(chroma, layout, dev) <= 255
    cfg, g, rows, rec3, u8, iq, common = _tile_case(
        dev, "w128", 2, 1, monkeypatch, 7)
    smem = post_fused.post_tile_smem
    for extra in (16, -16):
        monkeypatch.setattr(post_fused, "post_tile_smem",
                            lambda *a, extra=extra: smem(*a) + extra)
        for kern, args in (
                (post_fused.post_fused_rgb,
                 (rec3, common[0], cfg.replace(chroma="rgb"), *common[1:])),
                (post_fused.post_fused,
                 (rec3[0::3].contiguous(), *iq, *common[:1], cfg,
                  *common[1:]))):
            n = kern.launches
            with pytest.raises(RuntimeError, match="cudaError 1$"):
                kern(*args)
            assert kern.launches == n


@pytest.mark.parametrize("blur_size", [0.75, 1.5, 4.0])
@pytest.mark.parametrize("mode", ["y_only", "planar_u8", "rgb"])
def test_1080p_blur_radius_on_card_matches_cpu(dev, blur_size, mode):
    """`magnify_video` at 1080p, `tuned_for_tpu()`, at blur radii 3, 5 and
    13 in y_only f32, uint8 -> planar_u8 and rgb: it runs on the card
    (kernel 3, kernels 7 + 10 at 13; kernel 11 for rgb) and matches the
    CPU path."""
    change = dict(chroma="rgb") if mode == "rgb" else (
        dict(output_layout="planar_u8") if mode == "planar_u8" else {})
    cfg = MagnifyConfig().tuned_for_tpu().replace(blur_size=blur_size,
                                                  **change)
    rng = np.random.default_rng(35)
    base = rng.random((1080, 1920, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) for i in range(3)])
    if mode == "planar_u8":
        clip = np.ascontiguousarray(np.moveaxis(
            np.round(clip * 255.0).astype(np.uint8), -1, 1))
    out_d, _ = magnify_video(clip, cfg)
    assert out_d.device.type == "cuda"
    out_c, _ = magnify_video(clip, cfg, device="cpu")
    if mode == "planar_u8":
        assert int((out_d.cpu().int() - out_c.int()).abs().max()) <= 1
    else:
        mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
        assert mse == 0 or 10 * np.log10(1 / mse) > 100


def test_cli_fast_blur_size_1_5_at_1080p(dev, tmp_path):
    from pbmm_tpu_torch import cli

    rng = np.random.default_rng(36)
    base = rng.random((1080, 1920, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) for i in range(3)])
    src, out = str(tmp_path / "clip.npy"), str(tmp_path / "out.npy")
    np.save(src, clip)
    assert cli.main(["--input", src, "--output", out, "--fast",
                     "--blur-size", "1.5"]) == 0
    got = np.load(out)
    assert got.shape == clip.shape and np.isfinite(got).all()


# -- kernel 1 on the row engine; kernel 2's frame-parallel schedule ----------


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "full"])
@pytest.mark.parametrize("w", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_row_fft_kernel_on_the_row_engine(dev, w, keep):
    """Kernel 1 (csrc/row_pass.cuh) at every row length, on a row count
    that leaves the last block part-filled (37 x 3 rows; blocks of 16 rows
    at 128 lanes): against its plain version, and bit for bit against the
    DIF of kernel 8's row pass on a zero imaginary plane of the same
    windowed rows (pbmm_radix2's butterflies), kept tiles."""
    from pbmm_tpu_torch.spectral import radix2
    from pbmm_tpu_torch.spectral.hermitian import kept_tiles

    hc, pad_h, row0 = 37 if w <= 2048 else 5, 160, 64
    y = torch.rand((3, hc, w), generator=torch.Generator().manual_seed(w))
    y = y.to(dev)
    n = fused.windowed_row_fft.launches
    got = fused.windowed_row_fft(y, pad_h, row0, keep)
    assert fused.windowed_row_fft.launches == n + 1
    assert _rel(got, fused.windowed_row_fft_ref(y, pad_h, row0, keep)) < 1e-4
    wy, wx = (torch.from_numpy(a).to(dev)
              for a in fused._hann_pair(pad_h, w))
    yw = (y * wy[row0:row0 + hc, None]) * wx
    zr, zi = radix2._fft_axis(yw, torch.zeros_like(yw), 2, False)
    tiles = kept_tiles(w) if keep else range(w // 128)
    lanes = torch.as_tensor(np.concatenate(
        [np.arange(t * 128, (t + 1) * 128) for t in tiles]), device=dev)
    assert torch.equal(got[0], zr[..., lanes])
    assert torch.equal(got[1], zi[..., lanes])


def _smooth_rows(rng, n, hc, wk, dev, step=0.05):
    """Row spectra of n rows turning by e^{i step} a row (a random base):
    prev * conj(cur) stays near one angle, far from atan2's branch cut, so
    the atan2 branches compare on any height and frame count."""
    base = (rng.standard_normal((hc, wk))
            + 1j * rng.standard_normal((hc, wk)))
    z = np.stack([base * np.exp(1j * step * f) for f in range(n)])
    z = z.astype(np.complex64)
    return (torch.from_numpy(np.ascontiguousarray(z.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(z.imag)).to(dev))


_K2 = {"main": dict(), "standard": dict(mode="standard"),
       "steerable": dict(orientations=4),
       "overlapping": dict(pyramid_levels=6, orientations=3),
       "non_integer": dict(phase_scale=2.5)}


@pytest.mark.parametrize("h", [512, 1152, 2048, 2176, 4096])
@pytest.mark.parametrize("name", sorted(_K2))
def test_colspec_frame_parallel_branches(dev, name, h):
    """Kernel 2's frame-parallel schedule on every non-IIR branch at pow-2
    and four-step heights (strips of 8 to 2048 rows, 4 above), one plane
    and three, T = 1, 3 and 16, against its plain version; the state it
    carries out is the last frame's spectrum."""
    cfg = _cfg().replace(pad_mode="square_pow2" if h in (512, 2048, 4096)
                         else "tight", **_K2[name])
    fw = 512
    wk = hermitian_kept_width(fw)
    pow2 = h & (h - 1) == 0
    hc, row0 = (h // 2 + 40, h // 4) if pow2 else (h - 64, 32)
    rows = (h // 8, h - h // 8)
    rng = np.random.default_rng(h)
    order = torch.as_tensor(fused._col_order(h), device=dev)
    for planes, t in ((1, 1), (1, 16), (3, 3)):
        rr, ri = _smooth_rows(rng, (t + 1) * planes, hc, wk, dev)
        # Frame -1 of each plane gives the carried state (torch.fft).
        prev = [fused._col_fft_ref(rr[c], ri[c], h, row0, order)
                for c in range(planes)]
        args = (rr[planes:].contiguous(), ri[planes:].contiguous(),
                torch.stack([p.real for p in prev]).contiguous(),
                torch.stack([p.imag for p in prev]).contiguous(), cfg, h,
                row0)
        kw = dict(out_rows=rows, full_w=fw, planes=planes)
        n = fused.colspec_chunk.launches
        got = fused.colspec_chunk(*args, **kw)
        assert fused.colspec_chunk.launches == n + 1
        want = fused.colspec_chunk_ref(*args, **kw)
        assert got[0].shape == (t * planes, rows[1] - rows[0], wk)
        for k in range(0, 4, 2):
            assert _rel(got[k:k + 2], want[k:k + 2]) < 1e-4, (planes, t, k)
        if pow2:  # the state is kernel 5's spectrum of the last frame
            k5 = fused.col_fft_zero_padded(args[0][-planes:],
                                           args[1][-planes:], h, row0)
            assert torch.equal(got[2], k5[0]) and torch.equal(got[3], k5[1])


@pytest.mark.parametrize("h", [512, 1024, 2048, 4096])
def test_colspec_pow2_identities(dev, h):
    """At pow-2 heights: kernel 5 = kernel 2's forward half (the state
    after each frame), kernel 6 on kernel 5's spectra = kernel 2's rows,
    kernel 12's full variant = kernel 6, bit for bit, over 3 frames."""
    cfg = _cfg().replace(pad_mode="square_pow2")
    fw, t = 512, 3
    wk = hermitian_kept_width(fw)
    hc, row0, rows = h // 2 + 40, h // 4 - 8, (h // 8, h - h // 8)
    rng = np.random.default_rng(h + 1)
    rows_in = [_spectra(rng, (t, hc, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, wk), dev) for _ in range(2)]
    kw = dict(out_rows=rows, full_w=fw)
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, **kw)
    k5 = fused.col_fft_zero_padded(*rows_in, h, row0)
    assert torch.equal(k2[2][0], k5[0][-1]) and torch.equal(k2[3][0],
                                                            k5[1][-1])
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, k5)]
    k6 = fused.phase_col_ifft(*k5, *prv, cfg, **kw)
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])
    k12 = kdecomp.kdecomp_variant(*k5, *prv, cfg, kdecomp.VARIANTS[-1][1],
                                  rows, full_w=fw)
    assert all(torch.equal(a, b) for a, b in zip(k12, k6))


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("h", [1024, 1152, 1792, 2048, 2176, 4096, 4352,
                               8192])
def test_colspec_two_chunks_equal_one(dev, h, planes):
    """Two chunks of 8 frames, the state threaded, equal one chunk of 16
    bit for bit (rows and state), at tight and pow-2 heights: the phase
    strip's asynchronous copies with a ring of prev words (1024, 1152,
    2048, 2176 ragged, 4096), with cur alone (1792: m = 14), and the
    element loads (4352, 8192)."""
    tight = h & (h - 1) != 0
    cfg = _cfg().replace(pad_mode="tight" if tight else "square_pow2")
    fw = 256
    wk = hermitian_kept_width(fw)
    hc, row0 = (h - 64, 32) if tight else (h // 2, h // 4)
    rng = np.random.default_rng(h + planes)
    rows_in = [_spectra(rng, (16 * planes, hc, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (planes, h, wk), dev) for _ in range(2)]
    kw = dict(out_rows=(16, h - 16), full_w=fw, planes=planes)
    one = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, **kw)
    half = 8 * planes
    a = fused.colspec_chunk(*(r[:half] for r in rows_in), *prev, cfg, h,
                            row0, **kw)
    b = fused.colspec_chunk(*(r[half:].contiguous() for r in rows_in),
                            *a[2:], cfg, h, row0, **kw)
    assert all(torch.equal(torch.cat([x, y]), z)
               for x, y, z in zip(a[:2], b[:2], one[:2]))
    assert all(torch.equal(x, z) for x, z in zip(b[2:], one[2:]))


_STAGED = [(1152, "main"), (1792, "main"), (2048, "main"), (2176, "main"),
           (4096, "main"), (4352, "main"), (8192, "main"), (1152, "iir"),
           (2176, "iir"), (1152, "standard"), (2176, "standard")]


@pytest.mark.parametrize("h,branch", _STAGED,
                         ids=[f"h{h}_{b}" for h, b in _STAGED])
def test_colspec_staged_counts_the_asynchronous_strip(dev, h, branch):
    """`colspec_chunk.staged` rises by what the C entry reports: one a call
    whose launch 2 runs the asynchronous phase strip (the main branch on
    strips of 4 and more: 1080p's m = 9, 2160p's m = 17 and H = 4096,
    m = 14 with cur alone), none elsewhere (strips of 2, the general
    pass: the IIR taps, standard mode), equal to the host's mirror
    `fused.colspec_staged` in every case, beside the one launch counted;
    the C rule's shared memory is the host's mirror at the heights, strips
    and ring words the launches take."""
    from pbmm_tpu_torch.kernels.build import library

    tight = h & (h - 1) != 0
    cfg = _cfg().replace(pad_mode="tight" if tight else "square_pow2")
    taps = ()
    if branch == "iir":
        cfg = cfg.replace(temporal=TemporalConfig(mode="iir_bandpass"))
    elif branch == "standard":
        cfg = cfg.replace(mode="standard")
    wk = hermitian_kept_width(256)
    rng = np.random.default_rng(h)
    rows_in = [_spectra(rng, (4, h - 64, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, wk), dev) for _ in range(2)]
    if branch == "iir":
        taps = tuple(torch.zeros((1, h, wk), device=dev) for _ in range(2))
    n, staged = fused.colspec_chunk.launches, fused.colspec_chunk.staged
    fused.colspec_chunk(*rows_in, *prev, cfg, h, 32, *taps, full_w=256)
    assert fused.colspec_chunk.launches == n + 1
    want = h in (1152, 1792, 2048, 2176, 4096) and branch == "main"
    assert fused.colspec_staged(h, branch != "main") == want
    assert fused.colspec_chunk.staged == staged + want
    for height in (64, 512, 1024, 1152, 1792, 2048, 2176, 4096, 8192):
        for s in (2, 4, 8, 16):
            for words in (0, 2, 4):
                assert library().pbmm_phase_strip_smem(
                    height, s, 512, words) == fused.phase_strip_smem(
                        height, s, words=words), (height, s, words)


_COPIED = [(1152, "iir"), (2176, "iir"), (4096, "iir"), (8192, "iir"),
           (68 * 128, "iir"), (16384, "iir"), (1152, "main"),
           (8192, "main"), (1152, "standard"), (1152, "steerable")]


@pytest.mark.parametrize("h,branch", _COPIED,
                         ids=[f"h{h}_{b}" for h, b in _COPIED])
def test_colspec_copied_counts_the_iir_strip(dev, h, branch):
    """`colspec_chunk.copied` rises by one a call with the IIR taps, whose
    launch 3 brings the rotated spectra in by asynchronous copies (every
    strip width, the 128-point chunks above m = 64, the bracket's
    8192-row blocks), and by none on the main, standard and steerable
    branches; one launch counted either way."""
    tight = h & (h - 1) != 0
    cfg = _cfg().replace(pad_mode="tight" if tight else "square_pow2")
    taps = ()
    if branch == "iir":
        cfg = cfg.replace(temporal=TemporalConfig(mode="iir_bandpass"))
    else:
        cfg = cfg.replace(**_K2[branch])
    wk = hermitian_kept_width(256)
    rng = np.random.default_rng(h + len(branch))
    rows_in = [_spectra(rng, (2, h - 64, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, wk), dev) for _ in range(2)]
    if branch == "iir":
        taps = tuple(torch.zeros((1, h, wk), device=dev) for _ in range(2))
    n, copied = fused.colspec_chunk.launches, fused.colspec_chunk.copied
    fused.colspec_chunk(*rows_in, *prev, cfg, h, 32, *taps, full_w=256)
    assert fused.colspec_chunk.launches == n + 1
    assert fused.colspec_chunk.copied == copied + (branch == "iir")


def test_colspec_staged_on_steady_1080p_chunks(dev):
    """Every steady 1080p tight chunk of the chunk engine (uint8 frames,
    chunks of 16) adds one to `colspec_chunk.staged`, as to `.launches`."""
    cfg = _cfg()
    frames = _source_frames(34, 1080, 1920, "u8", "interleaved", dev)
    _, state = magnify_video(frames[:2], cfg)
    n, staged = fused.colspec_chunk.launches, fused.colspec_chunk.staged
    for f0 in (2, 18):
        _, state = magnify_video(frames[f0:f0 + 16], cfg, state)
    assert fused.colspec_chunk.launches - n == 2
    assert fused.colspec_chunk.staged - staged == 2


def test_colspec_refuses_a_width_off_its_strip(dev):
    z = torch.zeros((1, 64, 100), device=dev)
    zp = torch.zeros((1, 512, 100), device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        fused.colspec_chunk(z, z, zp, zp, _cfg(), 512, 0)


_K3_GEOMS = {"1080p": (1080, 1920, tuple(range(15))),
             "2160p": (2160, 3840, (0, 2, 5, 6))}


@pytest.mark.parametrize("layout", ["tuple3", "planar", "planar_u8"])
@pytest.mark.parametrize("src", ["f32", "u8"])
@pytest.mark.parametrize("geom_name,ri", [
    (g, i) for g in sorted(_K3_GEOMS) for i in range(len(_K3_GEOMS[g][2]))])
def test_post_kernel_equals_row_ifft_and_post_fused(dev, geom_name, ri, src,
                                                    layout, monkeypatch):
    """Kernel 3 = kernel 7 + kernel 10 bit for bit: on the same region
    rows, kernel 3's output equals `post_fused(row_ifft_magnitude(...))`
    (the same |z| rows of the row engine, the blur and epilogue of
    csrc/post_tail.cuh), at every radius a kernel-3 block fits at 1080p
    tight (0-14, 2048 lanes; kernel 3 launched with route=False, as the
    route takes it only to 5 there) and 0, 2, 5 and 6 at 2160p (4096
    lanes), both chroma
    sources and the three layouts; radius 0 from a one-tap blur no config
    gives."""
    in_h, in_w, radii = _K3_GEOMS[geom_name]
    radius = radii[ri]
    if radius == 0:
        monkeypatch.setattr(post_fused, "blur_taps", lambda b: (0.75,))
    cfg = _cfg().replace(blur_size=max(radius - 0.5, 0.5) / 3.2307692308)
    assert post_fused._radius(cfg) == radius
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    wk, hr = hermitian_kept_width(g.pad_w), rows[1] - rows[0]
    assert post_fused.kernel3_rows(radius, g.pad_w, in_w) > 0
    rng = np.random.default_rng(40 + radius)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    rre, rim = (_rand(rng, (2, hr, wk), dev, scale) for _ in range(2))
    if src == "f32":
        chroma = (_rand(rng, (2, in_h, in_w), dev, 0.3),
                  _rand(rng, (2, in_h, in_w), dev, 0.3), None)
    else:
        chroma = (None, None, torch.from_numpy(rng.integers(
            0, 256, (2, 3, in_h, in_w), dtype=np.uint8)).to(dev))
    win = hann2d_region(g, device=dev)
    n3, n7 = (post_fused.rowifft_post_fused.launches,
              fused.row_ifft_magnitude.launches)
    got = post_fused.rowifft_post_fused(
        rre, rim, chroma[0], chroma[1], win, cfg, rows[0], in_h, in_w,
        "tight", full_w=g.pad_w, src=chroma[2], out_layout=layout,
        route=False)
    assert post_fused.rowifft_post_fused.launches == n3 + 1
    assert fused.row_ifft_magnitude.launches == n7
    rec = fused.row_ifft_magnitude(rre, rim, pad_h=g.pad_h, full_w=g.pad_w)
    want = post_fused.post_fused(rec, chroma[0], chroma[1], win, cfg,
                                 rows[0], in_h, in_w, "tight", layout,
                                 src=chroma[2])
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", ["tuple3", "planar_u8"])
def test_post_kernel_quirks_equal_row_ifft_and_post_fused(dev, layout):
    """The identity with Re z, the window compensation and the YIQ gains,
    at radius 5 on 1080p's rows."""
    cfg = _cfg().replace(blur_size=1.5, reconstruct="real",
                         compensate_window=True, apply_yiq_gains=True,
                         yiq_gains=(1.0, 1.2, 0.8))
    g = geometry_for(1080, 1920, "tight")
    rows = blur_row_window(g, cfg)
    wk, hr = hermitian_kept_width(g.pad_w), rows[1] - rows[0]
    rng = np.random.default_rng(47)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    rre, rim = (_rand(rng, (2, hr, wk), dev, scale) for _ in range(2))
    iq = [_rand(rng, (2, 1080, 1920), dev, 0.3) for _ in range(2)]
    win = hann2d_region(g, device=dev)
    got = post_fused.rowifft_post_fused(
        rre, rim, *iq, win, cfg, rows[0], 1080, 1920, "tight",
        full_w=g.pad_w, out_layout=layout)
    rec = fused.row_ifft_magnitude(rre, rim, magnitude=False, pad_h=g.pad_h,
                                   full_w=g.pad_w)
    want = post_fused.post_fused(rec, *iq, win, cfg, rows[0], 1080, 1920,
                                 "tight", layout)
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- 4320p: padded heights above 4096 (F3), kernel 2's IIR schedule, kernel
# 8's row pass on the row engine ---------------------------------------------

_TALL_BRANCHES = {
    **_K2, "iir": dict(temporal=TemporalConfig(mode="iir_bandpass")),
    "standard_iir": dict(mode="standard",
                         temporal=TemporalConfig(mode="iir_bandpass"))}


def _taps_rel(got, want, mag):
    """An IIR tap's error weighted by the magnitude of the bin it rotates
    (chip_smoke.py's measure: at bins at the FFTs' rounding floor the
    phase delta is noise in both versions, and there the taps rotate
    nothing)."""
    return (float(((got - want).abs() * mag).max())
            / float((want.abs() * mag).max()))


# 4320p's heights on every branch; the IIR branch also on every strip
# width below them (launch 3's asynchronous copies of 16 bytes at 1152 on
# strips of 16, 2048 and 2176 on 8, 4096 on 4).
_TALL = ([(name, h) for h in (4352, 6144, 8064, 8192)
          for name in sorted(_TALL_BRANCHES)]
         + [("iir", h) for h in (1152, 2048, 2176, 4096)])


@pytest.mark.parametrize("name,h", _TALL, ids=[f"{n}-{h}" for n, h in _TALL])
def test_colspec_tall_heights(dev, name, h):
    """Kernel 2 at 4320p's heights, every branch, against its plain
    version: H = 8192 (radix-2, strips of 2), tight m = 34, 48 and 63
    (four-step, the combine matrix in device memory, strips of 2,
    256-thread blocks), one plane and three, on rows that turn smoothly
    from frame to frame (clear of atan2's branch cut); with the IIR taps
    on its three launches, the taps weighted by magnitude, also at tight
    1152 and 2176 and pow-2 2048 and 4096 (launch 3's strips of 16, 8 and
    4; 8-byte copies on the strips of 2 above)."""
    pow2 = h & (h - 1) == 0
    cfg = _cfg().replace(pad_mode="square_pow2" if pow2 else "tight",
                         **_TALL_BRANCHES[name])
    iir = cfg.temporal.mode == "iir_bandpass"
    fw = 512
    wk = hermitian_kept_width(fw)
    hc, row0 = ((4320, 1936) if h == 8192 else (h // 2 + 40, h // 4)
                if pow2 else (h - 32, 16))
    rows = (h // 8, h - h // 8)
    rng = np.random.default_rng(h + len(name))
    order = torch.as_tensor(fused._col_order(h), device=dev)
    for planes, t in ((1, 3), (3, 2)):
        rr, ri = _smooth_rows(rng, (t + 1) * planes, hc, wk, dev)
        prev = [fused._col_fft_ref(rr[c], ri[c], h, row0, order)
                for c in range(planes)]
        taps = ([0.1 * _spectra(rng, (planes, h, wk), dev) for _ in range(2)]
                if iir else [])
        args = (rr[planes:].contiguous(), ri[planes:].contiguous(),
                torch.stack([p.real for p in prev]).contiguous(),
                torch.stack([p.imag for p in prev]).contiguous(), cfg, h,
                row0, *taps)
        kw = dict(out_rows=rows, full_w=fw, planes=planes)
        n = fused.colspec_chunk.launches
        got = fused.colspec_chunk(*args, **kw)
        assert fused.colspec_chunk.launches == n + 1
        want = fused.colspec_chunk_ref(*args, **kw)
        assert len(got) == len(want) == 4 + len(taps)
        for k in range(0, 4, 2):
            assert _rel(got[k:k + 2], want[k:k + 2]) < 1e-4, (planes, t, k)
        mag = torch.complex(want[2], want[3]).abs()
        for g, w in zip(got[4:], want[4:]):
            assert _taps_rel(g, w, mag) < 1e-4


@pytest.mark.parametrize("iir", [False, True], ids=["two_frame", "iir"])
def test_square_pow2_8k_identities(dev, iir):
    """4320p at square_pow2 pads to H = 8192: kernel 5 (three passes) =
    kernel 2's forward half, kernel 6 on kernel 5's spectra = kernel 2's
    rows (two-frame), kernel 12's full variant = kernel 6, bit for bit;
    kernel 6 with the IIR taps against its plain version."""
    cfg = _tall_cfg("square_pow2", iir)
    h, fw, hc, row0, rows = 8192, 512, 4320, 1936, (1932, 6260)
    w = hermitian_kept_width(fw)
    rng = np.random.default_rng(80)
    rows_in = [_spectra(rng, (2, hc, w), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, w), dev) for _ in range(2)]
    kw = dict(out_rows=rows, full_w=fw)
    k5 = fused.col_fft_zero_padded(*rows_in, h, row0)
    want5 = fused.col_fft_zero_padded_ref(*[x.cpu() for x in rows_in], h,
                                          row0)
    assert _rel([g.cpu() for g in k5], want5) < 1e-4
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, k5)]
    tap6 = ([0.1 * _spectra(rng, (2, h, w), dev) for _ in range(2)]
            if iir else [])
    k6 = fused.phase_col_ifft(*k5, *prv, cfg, **kw,
                              **dict(zip(("lp_fast", "lp_slow"), tap6)))
    want6 = fused.phase_col_ifft_ref(
        *[x.cpu() for x in (*k5, *prv)], cfg, **kw,
        **dict(zip(("lp_fast", "lp_slow"), [x.cpu() for x in tap6])))
    assert _rel([g.cpu() for g in k6[:2]], want6[:2]) < 1e-4
    if iir:
        return
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, **kw)
    assert torch.equal(k2[2][0], k5[0][-1]) and torch.equal(k2[3][0],
                                                            k5[1][-1])
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])
    k12 = kdecomp.kdecomp_variant(*k5, *prv, cfg, kdecomp.VARIANTS[-1][1],
                                  rows, full_w=fw)
    assert all(torch.equal(a, b) for a, b in zip(k12, k6))


@pytest.mark.parametrize("h", [1152, 2048, 2176, 4096, 4352, 8192,
                               68 * 128, 16384])
def test_colspec_iir_two_chunks_equal_one(dev, h):
    """The IIR branch's three launches: two chunks of 4 frames, the state
    and taps threaded, equal one chunk of 8 bit for bit (rows, state,
    taps): the tap scan walks a chunk's frames in the order the state
    threads them.  Launch 3 on every strip width and route: 16, 8 and 4
    columns, 2 (8-byte copies), the 128-point chunks above m = 64 and the
    8192-row blocks of the bracket (16384)."""
    tight = h & (h - 1) != 0
    cfg = _cfg().replace(pad_mode="tight" if tight else "square_pow2",
                         temporal=TemporalConfig(mode="iir_bandpass"))
    fw, planes = 256, 3
    wk = hermitian_kept_width(fw)
    hc, row0 = (h - 64, 32) if tight else (h // 2, h // 4)
    rng = np.random.default_rng(h + 7)
    rows_in = [_spectra(rng, (8 * planes, hc, wk), dev) for _ in range(2)]
    state = [_spectra(rng, (planes, h, wk), dev) for _ in range(2)]
    state += [0.1 * _spectra(rng, (planes, h, wk), dev) for _ in range(2)]
    kw = dict(out_rows=(16, h - 16), full_w=fw, planes=planes)
    one = fused.colspec_chunk(*rows_in, *state[:2], cfg, h, row0, *state[2:],
                              **kw)
    half = 4 * planes
    a = fused.colspec_chunk(*(r[:half] for r in rows_in), *state[:2], cfg, h,
                            row0, *state[2:], **kw)
    b = fused.colspec_chunk(*(r[half:].contiguous() for r in rows_in),
                            *a[2:4], cfg, h, row0, *a[4:], **kw)
    assert all(torch.equal(torch.cat([x, y]), z)
               for x, y, z in zip(a[:2], b[:2], one[:2]))
    assert all(torch.equal(x, z) for x, z in zip(b[2:], one[2:]))


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_fft_axis_row_engine(dev, n, kind):
    """Kernel 8's row pass on the row engine (row_pass.cuh) at every
    length it takes, against its plain version, on 7 x 5 rows: rows under
    2048 points pack several to a block, and 35 leaves the last block
    part-filled."""
    from pbmm_tpu_torch.spectral import radix2

    rng = np.random.default_rng(n + len(kind))
    re, im = (_rand(rng, (7, 5, n), dev) for _ in range(2))
    real, inverse = kind == "forward_real", kind == "inverse_scaled"
    scale = 1.0 / (5 * n) if inverse else 1.0
    args = (re, None if real else im, 2, inverse, scale)
    count = radix2._fft_axis.launches
    got = radix2._fft_axis(*args)
    assert radix2._fft_axis.launches == count + 1
    want = radix2._fft_axis_ref(*[x.cpu() if torch.is_tensor(x) else x
                                  for x in args])
    assert _rel([g.cpu() for g in got], want) < 1e-4


# -- padded sizes above 8192 (fault F4, fixed: csrc/col_pass.cuh) ------------


@pytest.mark.parametrize("name", sorted(_TALL_BRANCHES))
@pytest.mark.parametrize("h", [16384, 65 * 128, 68 * 128])
def test_colspec_above_8192(dev, name, h):
    """Kernel 2 past the in-block heights, every branch: pow-2 16384 (the
    bracket around its two launches on the 8192-row blocks) and tight m =
    65 and 68 (the combine pass, the 128-point factor on chunks), one plane
    and three, against its plain version; the IIR taps weighted by
    magnitude."""
    cfg = _cfg().replace(pad_mode="square_pow2" if h == 16384 else "tight",
                         **_TALL_BRANCHES[name])
    iir = cfg.temporal.mode == "iir_bandpass"
    fw = 256
    wk = hermitian_kept_width(fw)
    hc, row0 = (h - 256, 128) if h == 16384 else (h - 32, 16)
    rows = (h // 8, h - h // 8)
    rng = np.random.default_rng(h + len(name))
    order = torch.as_tensor(fused._col_order(h), device=dev)
    for planes, t in ((1, 2), (3, 1)):
        rr, ri = _smooth_rows(rng, (t + 1) * planes, hc, wk, dev)
        prev = [fused._col_fft_ref(rr[c], ri[c], h, row0, order)
                for c in range(planes)]
        taps = ([0.1 * _spectra(rng, (planes, h, wk), dev) for _ in range(2)]
                if iir else [])
        args = (rr[planes:].contiguous(), ri[planes:].contiguous(),
                torch.stack([p.real for p in prev]).contiguous(),
                torch.stack([p.imag for p in prev]).contiguous(), cfg, h,
                row0, *taps)
        kw = dict(out_rows=rows, full_w=fw, planes=planes)
        n = fused.colspec_chunk.launches
        got = fused.colspec_chunk(*args, **kw)
        assert fused.colspec_chunk.launches == n + 1
        want = fused.colspec_chunk_ref(*args, **kw)
        for k in range(0, 4, 2):
            assert _rel(got[k:k + 2], want[k:k + 2]) < 1e-4, (planes, t, k)
        mag = torch.complex(want[2], want[3]).abs()
        for g, w in zip(got[4:], want[4:]):
            assert _taps_rel(g, w, mag) < 1e-4


@pytest.mark.parametrize("h", [16384, 68 * 128])
def test_colspec_above_8192_two_chunks_equal_one(dev, h):
    """Two chunks of 1, the state threaded, equal one chunk of 2 bit for
    bit, rows and state, past the in-block heights."""
    cfg = _cfg().replace(pad_mode="square_pow2" if h == 16384 else "tight")
    fw = 256
    wk = hermitian_kept_width(fw)
    hc, row0 = (h - 256, 128) if h == 16384 else (h - 32, 16)
    rng = np.random.default_rng(h)
    rr, ri = _smooth_rows(rng, 2, hc, wk, dev)
    prev = [_spectra(rng, (1, h, wk), dev) for _ in range(2)]
    kw = dict(out_rows=(0, h), full_w=fw)
    one = fused.colspec_chunk(rr, ri, *prev, cfg, h, row0, **kw)
    a = fused.colspec_chunk(rr[:1], ri[:1], *prev, cfg, h, row0, **kw)
    b = fused.colspec_chunk(rr[1:], ri[1:], *a[2:4], cfg, h, row0, **kw)
    for k in range(2):
        assert torch.equal(one[k], torch.cat([a[k], b[k]]))
        assert torch.equal(one[2 + k], b[2 + k])


@pytest.mark.parametrize("iir", [False, True], ids=["two_frame", "iir"])
def test_square_pow2_16k_identities(dev, iir):
    """16K at square_pow2 pads to H = 16384: kernel 5 (three passes of the
    column engine) = kernel 2's forward half (the bracket, then its launch
    1 on the blocks), kernel 6 on kernel 5's spectra = kernel 2's rows,
    kernel 12's full variant = kernel 6, bit for bit; kernel 6 with the
    IIR taps against its plain version."""
    cfg = _tall_cfg("square_pow2", iir)
    h, fw, hc, row0, rows = 16384, 256, 8640, 3872, (3868, 12516)
    w = hermitian_kept_width(fw)
    rng = np.random.default_rng(160)
    rows_in = [_spectra(rng, (2, hc, w), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, h, w), dev) for _ in range(2)]
    kw = dict(out_rows=rows, full_w=fw)
    k5 = fused.col_fft_zero_padded(*rows_in, h, row0)
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, k5)]
    tap6 = ([0.1 * _spectra(rng, (2, h, w), dev) for _ in range(2)]
            if iir else [])
    k6 = fused.phase_col_ifft(*k5, *prv, cfg, **kw,
                              **dict(zip(("lp_fast", "lp_slow"), tap6)))
    if iir:
        want6 = fused.phase_col_ifft_ref(
            *k5, *prv, cfg, **kw, **dict(zip(("lp_fast", "lp_slow"), tap6)))
        mag = torch.complex(*k5).abs()
        assert _rel(k6[:2], want6[:2]) < 1e-4
        for g, w_ in zip(k6[2:], want6[2:]):
            assert _taps_rel(g, w_, mag) < 1e-4
        return
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, h, row0, **kw)
    assert torch.equal(k2[2][0], k5[0][-1]) and torch.equal(k2[3][0],
                                                            k5[1][-1])
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])
    k12 = kdecomp.kdecomp_variant(*k5, *prv, cfg, kdecomp.VARIANTS[-1][1],
                                  rows, full_w=fw)
    assert all(torch.equal(a, b) for a, b in zip(k12, k6))


@pytest.mark.parametrize("w", [16384, 32768])
@pytest.mark.parametrize("keep", [True, False], ids=["kept", "full"])
def test_row_kernels_above_8192(dev, w, keep):
    """Kernels 1 and 7 on rows of 16384 and 32768 lanes (the bracket
    around the row engine on 8192-lane blocks): against their plain
    versions, kernel 1 bit for bit kernel 8's row pass on the same
    windowed rows, kernel 7 bit for bit kernel 8's row pass on the rebuilt
    rows + torch's |z| (and Re z)."""
    hc, pad_h, row0 = 6, 64, 20
    rng = np.random.default_rng(w + keep)
    y = torch.from_numpy(rng.random((2, hc, w), np.float32)).to(dev)
    n = fused.windowed_row_fft.launches
    got = fused.windowed_row_fft(y, pad_h, row0, keep)
    assert fused.windowed_row_fft.launches == n + 1
    assert _rel(got, fused.windowed_row_fft_ref(y, pad_h, row0, keep)) < 1e-4
    wy, wx = fused._hann_pair(pad_h, w)
    yw = (y * torch.from_numpy(wy[row0:row0 + hc, None]).to(dev)
          * torch.from_numpy(wx[None, :]).to(dev)).contiguous()
    zr, zi = radix2._fft_axis(yw, torch.zeros_like(yw), 2, False)
    if keep:
        lanes = torch.as_tensor(fused.kept_lane_indices(w), device=dev)
        zr, zi = zr[..., lanes], zi[..., lanes]
    assert torch.equal(got[0], zr) and torch.equal(got[1], zi)
    wk = hermitian_kept_width(w) if keep else w
    scale = 0.3 * hc * np.sqrt(w)
    re, im = (_rand(rng, (2, hc, wk), dev, scale) for _ in range(2))
    for magnitude in (True, False):
        k7 = fused.row_ifft_magnitude(re, im, magnitude, pad_h=hc, full_w=w)
        want = fused.row_ifft_magnitude_ref(re, im, magnitude, pad_h=hc,
                                            full_w=w)
        assert _rel([k7], [want]) < 1e-4
        assert torch.equal(k7, _row_pass_then_abs(re, im, w, 1.0 / (hc * w),
                                                  magnitude))


@pytest.mark.parametrize("in_w", [9000, 15360, 20000])
def test_u8_row_fft_kernel_above_8192(dev, in_w):
    """Kernel 4 on frames wider than 8192 pixels (16384 and 32768 padded
    lanes, the bracket's byte-loading front end): bit for bit the pre
    stage + kernel 1, and against its plain version."""
    in_h = 40
    g = geometry_for(in_h, in_w, "tight")
    assert g.pad_w == (16384 if in_w <= 16384 else 32768)
    rng = np.random.default_rng(in_w)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 3, in_h, in_w),
                                       dtype=np.uint8)).to(dev)
    luma = tuple(float(c) for c in RGB_TO_YIQ[0])
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + in_h, g.pad_h)
    args = (u8, luma, g.pad_h, g.pad_w, g.y0, g.x0, r0, True)
    got = fused.windowed_row_fft_u8planar(*args)
    assert _rel(got, fused.windowed_row_fft_u8planar_ref(*args)) < 1e-4
    hc, off = fused._u8_args(u8, g.pad_h, g.pad_w, g.y0, g.x0, r0)
    from pbmm_tpu_torch.core.color import channel_mix, unit_float
    f = unit_float(u8)
    slab = torch.nn.functional.pad(
        channel_mix(f[:, 0], f[:, 1], f[:, 2], luma),
        (g.x0, g.pad_w - in_w - g.x0, off, hc - off - in_h))
    want = fused.windowed_row_fft(slab.contiguous(), g.pad_h, r0, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("n", [16384, 32768])
def test_fft_axis_above_8192(dev, n, axis, kind):
    """Kernel 8 at 16384 and 32768 points on both axes (rows: the bracket
    around the row engine; columns: the column engine's passes), against
    its plain version on narrow planes."""
    rng = np.random.default_rng(n + axis + len(kind))
    shape = (2, n, 40) if axis == 1 else (2, 3, n)
    re, im = (_rand(rng, shape, dev) for _ in range(2))
    real, inverse = kind == "forward_real", kind == "inverse_scaled"
    scale = 1.0 / (3 * n) if inverse else 1.0
    args = (re, None if real else im, axis, inverse, scale)
    got = radix2._fft_axis(*args)
    want = radix2._fft_axis_ref(*args)
    assert _rel(got, want) < 1e-4


def test_fft_axis_column_pass_past_2_31_elements(dev):
    """Kernel 8's column pass on (9, 16384, 16384): the planes pass 2^31
    elements (~9.7 GB each), so the last frame's offsets need 64 bits; it
    equals the same frame transformed alone, bit for bit."""
    shape = (9, 16384, 16384)
    g = torch.Generator(device=dev).manual_seed(3)
    re = torch.randn(shape, device=dev, generator=g)
    im = torch.randn(shape, device=dev, generator=g)
    assert re.numel() > 2 ** 31
    got = radix2._fft_axis(re, im, 1, True, 0.5)
    last = radix2._fft_axis(re[-1:].contiguous(), im[-1:].contiguous(), 1,
                            True, 0.5)
    assert torch.equal(got[0][-1:], last[0])
    assert torch.equal(got[1][-1:], last[1])
    del re, im, got, last
    torch.cuda.empty_cache()


@pytest.mark.parametrize("layout", ["centered", "bitrev2d"])
@pytest.mark.parametrize("change", [dict(), dict(phase_scale=2.5),
                                    dict(orientations=4),
                                    dict(orientations=4, phase_scale=2.5)],
                         ids=["integer", "atan2", "steerable",
                              "steerable_atan2"])
@pytest.mark.parametrize("w", [512, 387])
def test_amplify_procedural_branches(dev, layout, change, w):
    """Kernel 9's four branches (integer power or atan2; steerable or
    not) in both layouts against its plain version, on a width that is a
    multiple of 4 (16-byte loads) and one that is not (scalar loads)."""
    cfg = MagnifyConfig(**change)
    h = 128
    rng = np.random.default_rng(w + len(change))
    spec = [_spectra(rng, (2, h, w), dev) for _ in range(4)]
    fy, fx = freq_axes(h, 512, layout, dev)
    args = (*spec, fy[:, 0].contiguous(), fx[0, :w].contiguous(),
            cfg.pyramid_levels, cfg.min_frequency, cfg.max_frequency,
            cfg.phase_scale, cfg.magnitude_threshold, cfg.orientations)
    got = fused_kernels.amplify_procedural(*args)
    want = fused_kernels.amplify_procedural_ref(*args)
    assert _rel(got, want) < 1e-4


def test_amplify_procedural_16k_random_spectra(dev, monkeypatch):
    """Kernel 9 at path (m) (g)'s call, (1, 16384, 16384), on random
    spectra against its plain version: among 268 M bins many magnitude
    gates g m >= tau sit within an ulp of tau, so both must round every
    step alike.  The plain version divides by the ramp's width in one
    rounding (`fused_kernels._div_rn`, as the kernel's __fdiv_rn); torch's
    division of a CUDA tensor by a Python float, a * (1 / b), moves t by
    an ulp at some bins and flips their gates.  Prints both readings."""
    cfg = MagnifyConfig(fft_backend="pallas", use_rfft=False,
                        use_pallas=True)
    n = 16384
    g = torch.Generator(device=dev).manual_seed(16)
    spec = [torch.randn((1, n, n), device=dev, generator=g)
            for _ in range(4)]
    fy, fx = freq_axes(n, n, "bitrev2d", dev)
    args = (*spec, fy[:, 0].contiguous(), fx[0].contiguous(),
            cfg.pyramid_levels, cfg.min_frequency, cfg.max_frequency,
            cfg.phase_scale, cfg.magnitude_threshold, cfg.orientations)
    got = fused_kernels.amplify_procedural(*args)
    want = fused_kernels.amplify_procedural_ref(*args)
    err = _rel(got, want)
    peak = max(float(w.abs().max()) for w in want)
    same = int(((got[0] == want[0]) & (got[1] == want[1])).sum())
    monkeypatch.setattr(fused_kernels, "_div_rn", lambda a, b: a / b)
    recip = fused_kernels.amplify_procedural_ref(*args)
    far = int(torch.maximum((got[0] - recip[0]).abs(),
                            (got[1] - recip[1]).abs()).gt(1e-4 * peak).sum())
    print(f"kernel 9, 16K random spectra: max err / max {err:.3e}, "
          f"{same} of {n * n} bins equal bit for bit; against torch's "
          f"a * (1 / b): max err / max {_rel(got, recip):.3e}, {far} bins "
          f"over 1e-4 of the max")
    assert err < 1e-4
    del spec, got, want, recip
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rgb", [False, True], ids=["kernel10", "kernel11"])
def test_post_tile_kernels_16k_crop(dev, rgb):
    """Kernels 10 and 11 (tiles of at most 256 columns) on a 16K frame's
    15360-column crop of 16384 padded lanes, as the y_only tail (kernels
    7 + 10) and chroma="rgb" take it at 16K, against their plain
    versions."""
    in_h, in_w = 8640, 15360
    g = geometry_for(in_h, in_w, "square_pow2")
    cfg = _cfg().replace(pad_mode="square_pow2")
    if rgb:
        cfg = cfg.replace(chroma="rgb", output_layout="planar_u8")
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(16)
    win = hann2d_region(g, device=dev)
    if rgb:
        rec = torch.from_numpy(rng.uniform(-0.2, 0.9, (3, hr, g.pad_w))
                               .astype(np.float32)).to(dev)
        args = (rec, win, cfg, rows[0], in_h, in_w, "square_pow2")
        got = post_fused.post_fused_rgb(*args, out_layout="planar_u8")
        want = post_fused.post_fused_rgb_ref(*args, out_layout="planar_u8")
        assert got.shape == (1, 3, in_h, in_w)
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        rec = torch.from_numpy(rng.uniform(0, 0.9, (1, hr, g.pad_w))
                               .astype(np.float32)).to(dev)
        iq = [_rand(rng, (1, in_h, in_w), dev, 0.3) for _ in range(2)]
        args = (rec, *iq, win, cfg, rows[0], in_h, in_w, "square_pow2")
        got = post_fused.post_fused(*args)
        want = post_fused.post_fused_ref(*args)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-5


@pytest.mark.parametrize("setting", ["allow_tf32", "high", "medium"])
def test_mxu_refuses_tf32(dev, setting):
    """With TF32 (or bf16) allowed for float32 products, the mxu
    transforms refuse a CUDA tensor and leave the setting as it was."""
    from pbmm_tpu_torch.spectral import mxu_fft

    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32)
    y = torch.ones((1, 64, 64), device=dev)
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(setting)
        now = (torch.get_float32_matmul_precision(),
               torch.backends.cuda.matmul.allow_tf32)
        for call in (lambda: mxu_fft.rfft2_mxu(y),
                     lambda: mxu_fft.fft2_mxu(y),
                     lambda: mxu_fft.irfft2_mxu(torch.fft.rfft2(y), 64)):
            with pytest.raises(ValueError, match="IEEE float32"):
                call()
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32) == now
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]


@pytest.mark.parametrize("kind", ["rfft2", "irfft2", "fft2"])
@pytest.mark.parametrize("shape", [(1, 2048, 2048), (3, 1024, 2048)])
def test_mxu_transforms_match_torch_fft(dev, kind, shape):
    """The four-step transforms in IEEE f32 on the card against torch.fft
    on the same tensors: max error / max magnitude < 2e-5 (the JAX
    tests' bar)."""
    from pbmm_tpu_torch.spectral import mxu_fft

    y = _rand(np.random.default_rng(21), shape, dev)
    if kind == "rfft2":
        got, want = mxu_fft.rfft2_mxu(y), torch.fft.rfft2(y)
    elif kind == "fft2":
        got, want = mxu_fft.fft2_mxu(y), torch.fft.fft2(y)
    else:
        spec = torch.fft.rfft2(y)
        got = mxu_fft.irfft2_mxu(spec, shape[-1])
        want = torch.fft.irfft2(spec, s=shape[-2:])
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 2e-5


def test_mxu_magnify_video_against_cpu(dev):
    """`fft_backend="mxu"` on the card (the scan engine, no kernel of the
    port's) against the same clip on the CPU, two chunks threaded:
    > 100 dB."""
    from pbmm_tpu_torch.oracle.synthetic import oscillating_bar
    from pbmm_tpu_torch.utils.metrics import psnr

    clip = oscillating_bar(size=256, frames=6, bar_width=2)[:, :192]
    cfg = MagnifyConfig(fft_backend="mxu")
    outs = {}
    for d in (dev, torch.device("cpu")):
        o1, s1 = magnify_video(torch.from_numpy(clip[:3]).to(d), cfg)
        o2, _ = magnify_video(torch.from_numpy(clip[3:]).to(d), cfg, s1)
        outs[d.type] = torch.cat([o1, o2]).cpu().numpy()
    assert psnr(outs["cuda"], outs["cpu"]) > 100


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_native_stream_equals_memmap(dev, tmp_path, dtype):
    """A .npy streamed on the card through the native loader (built with
    g++ on this machine; raw mode, pinned host buffer) equals the memmap
    route (`frame_chunks`, uint8 scaled on the card) and `magnify_video`
    on the whole clip, bit for bit, on the batched engine's kernels."""
    from pbmm_tpu_torch.io import stream
    from pbmm_tpu_torch.native import NativeFrameLoader, native_available

    assert native_available()
    base = np.random.default_rng(8).integers(0, 256, (270, 480, 3),
                                             np.uint8)
    u8 = np.stack([np.roll(base, i, axis=1) for i in range(12)])
    p = str(tmp_path / "clip.npy")
    np.save(p, u8 if dtype == "u8" else u8 * np.float32(1.0 / 255.0))
    cfg = MagnifyConfig().tuned_for_tpu()
    NativeFrameLoader.served = 0
    got = np.concatenate(list(stream.stream_magnify(p, cfg, chunk_frames=5,
                                                    device=dev)))
    assert NativeFrameLoader.served == 3
    want, st = [], None
    for c in stream.frame_chunks(p, 5, device=dev):
        o, st = magnify_video(c, cfg, st)
        want.append(o.cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(want))
    whole, _ = magnify_video(torch.from_numpy(np.load(p)).to(dev), cfg)
    np.testing.assert_array_equal(got, whole.cpu().numpy())


# -- the pre stage and the output stack folded into the kernels: the front
#    end (kernel 4's kernel on every input form), the source chroma of
#    kernels 3 and 10 and the interleaved layout of kernels 3, 10, 11 --------

_FRONT_SIZES = {  # (H, W, pad_mode): 1080p's two paddings, a row of 16384
    # lanes in one block, a bracketed row (32768 lanes), an odd width
    # (element loads at every alignment)
    "1080p tight": (1080, 1920, "tight"),
    "1080p square_pow2": (1080, 1920, "square_pow2"),
    "16384 lanes": (64, 15360, "tight"),
    "32768 lanes": (8, 17000, "tight"),
    "481 wide": (270, 481, "tight"),
}


def _source_frames(t, h, w, dtype, layout, dev, seed=21):
    """Seeded source frames in one of the four input forms."""
    u8 = np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), np.uint8)
    a = u8 if dtype == "u8" else (u8 * np.float32(1.0 / 255.0))
    if layout == "planar":
        a = np.moveaxis(a, -1, 1)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("planes", ["y_only", "rgb"])
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("size", list(_FRONT_SIZES))
def test_front_end_equals_pre_stage_and_kernel1(dev, size, dtype, layout,
                                                planes):
    """The front end, bit for bit the torch pre stage (`frames_slab`:
    unit_float, the colour rows, the centre pad) + kernel 1 on the same
    frames, in every input form, one plane and three."""
    h, w, mode = _FRONT_SIZES[size]
    g = geometry_for(h, w, mode)
    frames = _source_frames(2, h, w, dtype, layout, dev)
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + h, g.pad_h)
    rows = tuple(tuple(float(c) for c in r) for r in (
        RGB_TO_YIQ[:1] if planes == "y_only" else RGB_TO_YIQ))
    n = fused.windowed_row_fft_frames.launches
    got = fused.windowed_row_fft_frames(frames, rows, g.pad_h, g.pad_w,
                                        g.y0, g.x0, r0, True)
    assert fused.windowed_row_fft_frames.launches == n + 1
    _, hc, off = fused._frames_args(frames, g.pad_h, g.pad_w, g.y0, g.x0, r0)
    want = fused.windowed_row_fft(
        fused.frames_slab(frames, rows, g.pad_w, g.x0, off, hc), g.pad_h, r0,
        True)
    assert got[0].shape == (2 * len(rows), hc, hermitian_kept_width(g.pad_w))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _post_inputs(dev, t=4, in_h=1080, in_w=1920, seed=22):
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _cfg().replace(blur_size=4.0))
    hr, wk = rows[1] - rows[0], hermitian_kept_width(g.pad_w)
    rng = np.random.default_rng(seed)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    return dict(g=g, t=t, rows=rows, win=hann2d_region(g, device=dev),
                rre=_rand(rng, (t, hr, wk), dev, scale),
                rim=_rand(rng, (t, hr, wk), dev, scale),
                rec=_rand(rng, (t, hr, g.pad_w), dev).abs(),
                rec3=_rand(rng, (3 * t, hr, g.pad_w), dev, 0.3))


def _quirk_cfg(blur, quirks):
    cfg = _cfg().replace(blur_size=blur)
    if quirks:
        cfg = cfg.replace(compensate_window=True, apply_yiq_gains=True,
                          yiq_gains=(1.0, 1.2, 0.8))
    return cfg


def _post_call(kernel, p, cfg, chroma, layout, src=None):
    g, r0 = p["g"], p["rows"][0]
    if kernel == 3:
        return post_fused.rowifft_post_fused(
            p["rre"], p["rim"], *chroma, p["win"], cfg, r0, g.in_h, g.in_w,
            "tight", full_w=g.pad_w, src=src, out_layout=layout)
    if kernel == 10:
        return post_fused.post_fused(p["rec"], *chroma, p["win"], cfg, r0,
                                     g.in_h, g.in_w, "tight", layout, src=src)
    return post_fused.post_fused_rgb(p["rec3"], p["win"],
                                     cfg.replace(chroma="rgb"), r0, g.in_h,
                                     g.in_w, "tight", out_layout=layout)


@pytest.mark.parametrize("quirks", [False, True], ids=["plain", "quirks"])
@pytest.mark.parametrize("blur", [1.0, 4.0], ids=["r2", "r13"])
@pytest.mark.parametrize("kernel", [3, 10, 11])
def test_post_interleaved_equals_stack(dev, kernel, blur, quirks):
    """The interleaved layout of kernels 3, 10 and 11 (kernel 3 at radius
    13 through kernels 7 + 10) = torch.stack of "tuple3", bit for bit."""
    p = _post_inputs(dev)
    cfg = _quirk_cfg(blur, quirks)
    chroma = chroma_planes(_source_frames(p["t"], 1080, 1920, "f32",
                                          "interleaved", dev))
    tup = _post_call(kernel, p, cfg, chroma, "tuple3")
    got = _post_call(kernel, p, cfg, chroma, "interleaved")
    assert got.shape == (p["t"], 1080, 1920, 3) and got.is_contiguous()
    assert torch.equal(got, torch.stack(tup, dim=-1))


@pytest.mark.parametrize("quirks", [False, True], ids=["plain", "quirks"])
@pytest.mark.parametrize("blur", [1.0, 4.0], ids=["r2", "r13"])
@pytest.mark.parametrize("form", ["f32 interleaved", "f32 planar",
                                  "u8 interleaved"])
@pytest.mark.parametrize("kernel", [3, 10])
def test_post_source_chroma_equals_iq_planes(dev, kernel, form, blur,
                                             quirks):
    """Kernels 3 and 10 taking the chroma from f32 or interleaved source
    frames = the same kernel on the I/Q planes the torch pre stage forms
    from them (`chroma_planes`), bit for bit, in the four layouts; at
    radius 13 kernel 3's route takes kernels 7 + 10."""
    p = _post_inputs(dev)
    cfg = _quirk_cfg(blur, quirks)
    frames = _source_frames(p["t"], 1080, 1920, *form.split(), dev)
    iq = chroma_planes(frames)
    for layout in post_fused._LAYOUTS:
        want = _post_call(kernel, p, cfg, iq, layout)
        got = _post_call(kernel, p, cfg, (None, None), layout, src=frames)
        want = want if layout != "tuple3" else torch.stack(want)
        got = got if layout != "tuple3" else torch.stack(got)
        assert torch.equal(got, want), layout


_GLUE_FORMS = ["f32 interleaved", "f32 planar", "u8 interleaved",
               "u8 planar"]


@pytest.mark.parametrize("out_layout", ["interleaved", "planar",
                                        "planar_u8"])
@pytest.mark.parametrize("form", _GLUE_FORMS)
def test_chunk_launches_only_the_kernels(dev, form, out_layout):
    """A steady-state 1080p tight chunk in every input form launches the
    front end (kernel 4 from planar uint8), kernel 2 and kernel 3 once
    each and no torch kernel (no YIQ plane, padded slab or output stack:
    the profiler's device kernels hold nothing of at::native), and gives
    the CPU path's frames."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg().replace(output_layout=out_layout)
    frames = _source_frames(6, 1080, 1920, *form.split(), dev)
    _, state = magnify_video(frames[:2], cfg)
    wrappers = (fused.windowed_row_fft_frames, fused.windowed_row_fft_u8planar,
                fused.windowed_row_fft, fused.colspec_chunk,
                post_fused.rowifft_post_fused, fused.row_ifft_magnitude,
                post_fused.post_fused, post_fused.post_fused_rgb)
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        for f in wrappers:
            f.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, _ = magnify_video(frames[2:], cfg, state)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("pbmm.")]
        if names:
            break
    front = (fused.windowed_row_fft_u8planar if form == "u8 planar"
             else fused.windowed_row_fft_frames)
    got = {f.__name__: f.launches for f in wrappers}
    assert got == {f.__name__: int(f in (front, fused.colspec_chunk,
                                         post_fused.rowifft_post_fused))
                   for f in wrappers}
    assert names and not [n for n in names if "at::native" in n], names
    cpu_frames = frames.cpu()
    _, st = magnify_video(cpu_frames[:2], cfg)
    want, _ = magnify_video(cpu_frames[2:], cfg, st)
    if out_layout == "planar_u8":
        assert int((out.cpu().int() - want.int()).abs().max()) <= 1
    else:
        assert float((out.cpu() - want).abs().max()) < 1e-4
