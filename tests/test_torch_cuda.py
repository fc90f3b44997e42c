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
- the whole main path on the card against the CPU path, interleaved f32
  and planar uint8 in, on both tails;
- kernel 2's branches, kernels 5 and 11, the quirk switches of kernels 3
  and 7 and the config matrix's paths;
- kernel 6 in every branch at three heights (and bit for bit against
  kernel 2), kernel 8 on both axes from 8 to 8192 points, kernel 9 in
  both layouts, kernel 10 in every layout, the scan engine's paths on the
  card against the CPU (numpy input landing on the card), and
  `load_state` defaulting to the card;
- kernel 12 (kdecomp) in every piece set and phase branch, its full
  variant bit for bit against kernel 6; kernel 13 (the copy probe) in
  every pattern, bit for bit; kernel 14 (the trig probe) in every op
  code; `debug_mode` catching a planted NaN; `stage_times` and `timeit`
  on the card.

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
from pbmm_tpu_torch.engine.pipeline import blur_row_window, preprocess_cl
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
    counts = {f: f.launches for f in (fused.windowed_row_fft,
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
    re, im, _, _ = preprocess_cl(frames, _cfg(), want_iq=True)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


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
    kw = dict(full_w=g.pad_w, rgb_u8=chroma[2])
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
               (fused.windowed_row_fft, fused.row_ifft_magnitude))
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


@pytest.mark.parametrize("pad_h", [512, 384])
def test_iir_zero_prev_taps_stay_zero(dev, pad_h):
    """The bootstrap: a zero previous spectrum with signed zeros and zero
    taps.  atan2 of (+-0, +-0) must be 0, so the taps stay exactly zero
    (IEEE atan2 would give +-pi at bins with cur in the left half)."""
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
    spec = fused.col_fft_zero_padded(*rows_in, pad_h) if pad_h == 512 else None
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


def test_square_pow2_4k_refused_by_name(dev):
    z = torch.zeros((1, 64, 128), device=dev)
    zp = torch.zeros((1, 4096, 128), device=dev)
    with pytest.raises(ValueError, match="2048"):
        fused.colspec_chunk(z, z, zp, zp, _cfg(), 4096, 0)
    with pytest.raises(ValueError, match="2048"):
        fused.col_fft_zero_padded(z, z, 4096)


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


@pytest.mark.parametrize("name", sorted(_K6))
@pytest.mark.parametrize("h,fw,kept", [(256, 512, True), (1024, 2048, False),
                                       (2048, 256, True)])
def test_phase_col_ifft_kernel(dev, name, h, fw, kept):
    """Kernel 6 against its plain version in every branch and at three
    heights, with signed zeros in the spectra."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K6[name])
    w = hermitian_kept_width(fw) if kept else fw
    rng = np.random.default_rng(18)
    spec = [_spectra(rng, (2, h, w), dev, True) for _ in range(4)]
    taps = ([0.1 * _spectra(rng, (2, h, w), dev) for _ in range(2)]
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


def test_phase_col_ifft_kernel_equals_colspec(dev):
    """On the spectra kernel 5 gives, kernel 6's rows equal kernel 2's bit
    for bit (the shared phase pass and inverse)."""
    cfg = _cfg().replace(pad_mode="square_pow2")
    wk = hermitian_kept_width(512)
    rng = np.random.default_rng(19)
    rows_in = [_spectra(rng, (4, 192, wk), dev) for _ in range(2)]
    prev = [_spectra(rng, (1, 512, wk), dev) for _ in range(2)]
    k2 = fused.colspec_chunk(*rows_in, *prev, cfg, 512, 64,
                             out_rows=(64, 448), full_w=512)
    cur = fused.col_fft_zero_padded(*rows_in, 512, 64)
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, cur)]
    k6 = fused.phase_col_ifft(*cur, *prv, cfg, out_rows=(64, 448),
                              full_w=512)
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])


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


@pytest.mark.parametrize("cfg_name", sorted(_K12))
@pytest.mark.parametrize("name,pieces", kdecomp.VARIANTS,
                         ids=[n for n, _ in kdecomp.VARIANTS])
def test_kdecomp_kernel(dev, cfg_name, name, pieces):
    """Kernel 12 against its plain version in every piece set and phase
    branch (the main branch and the general pass), and its full variant
    bit for bit against kernel 6."""
    cfg = _cfg().replace(pad_mode="square_pow2", **_K12[cfg_name])
    h, fw = 256, 2048
    w = hermitian_kept_width(fw)
    rng = np.random.default_rng(25)
    spec = [_spectra(rng, (2, h, w), dev, True) for _ in range(4)]
    rows = (32, 224)
    n = kdecomp.kdecomp_variant.launches
    got = kdecomp.kdecomp_variant(*spec, cfg, pieces, rows, full_w=fw)
    assert kdecomp.kdecomp_variant.launches == n + 1
    want = kdecomp.kdecomp_variant_ref(*[x.cpu() for x in spec], cfg, pieces,
                                       rows, full_w=fw)
    if not pieces:
        assert all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want))
    else:
        assert _rel([g.cpu() for g in got], want) < 1e-4
    if len(pieces) == 3:
        k6 = fused.phase_col_ifft(*spec, cfg, out_rows=rows, full_w=fw)
        assert all(torch.equal(g, k) for g, k in zip(got, k6))


@pytest.mark.parametrize("pattern,block", [("rows", 1), ("rows", 64),
                                           ("lanes", 4), ("lanes", 8),
                                           ("lanes", 32)])
@pytest.mark.parametrize("shape", [(1, 1152, 2048), (3, 37, 256)])
def test_copy_probe_kernel(dev, pattern, block, shape):
    rng = np.random.default_rng(26)
    a, b = (_rand(rng, shape, dev) for _ in range(2))
    n = kexp.copy_probe.launches
    oa, ob = kexp.copy_probe(a, b, pattern, block)
    assert kexp.copy_probe.launches == n + 1
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
