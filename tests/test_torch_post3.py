"""Kernel 3's block schedule and the launch geometry of kernels 3 and 6,
checked on the CPU.

- A float32 numpy model of kernel 3's schedule (`pbmm_tpu_torch/csrc/
  rowifft_post.cu`): a block owns a run of output rows of one frame and
  streams the run's region rows, a few at a time, through |z| (the rows of
  `rebuilt_row_ifft`, which kernel 7's engine computes bit for bit), the
  horizontal blur of each row once at the crop's columns, a ring of the
  2 r previous blurred rows, the vertical taps of the output row a new row
  completes, and the epilogue (windowed chroma, compensation, gains, YIQ
  -> RGB, clip, layout), each product and sum rounded on its own.  For
  blur radii 0-12, runs whose last block is part-filled and rows in
  flight that do not divide a run, it equals `rowifft_post_fused_ref` bit
  for bit, in both chroma sources, the three layouts and the quirks.
- The shared memory of a kernel-3 block (`post_fused.kernel3_smem`, the
  launch's formula) within 227 KB for every (radius, pad_w) that
  `kernel3_serves` admits, at every crop width.
- Kernel 6's strip (`fused.phase_col_strip`): kernel 2's, or the widest
  half of it that divides the width, down to `col_strip(h)`."""

import numpy as np
import pytest
import torch

from pbmm_tpu_torch import MagnifyConfig
from pbmm_tpu_torch.core.color import YIQ_TO_RGB
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.spectral import fused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

IN_H, IN_W = 96, 384  # tight: 128 x 512, y0 = 16, x0 = 64
T = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blur_size(radius: int) -> float:
    """A blur_size whose taps have this radius (1 and up)."""
    return (radius - 0.5) / 3.2307692308


def _inputs(seed: int):
    geom = geometry_for(IN_H, IN_W, "tight")
    wk = hermitian_kept_width(geom.pad_w)
    rng = np.random.default_rng(seed)
    s = 0.3 * geom.pad_h * geom.pad_w / np.sqrt(geom.pad_w)
    rre, rim = (torch.from_numpy((s * rng.standard_normal(
        (T, geom.pad_h, wk))).astype(np.float32)) for _ in range(2))
    i_pl = torch.from_numpy(rng.uniform(-0.6, 0.6, (T, IN_H, IN_W))
                            .astype(np.float32))
    q_pl = torch.from_numpy(rng.uniform(-0.5, 0.5, (T, IN_H, IN_W))
                            .astype(np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, (T, 3, IN_H, IN_W),
                                       dtype=np.uint8))
    return geom, rre, rim, i_pl, q_pl, u8, hann2d_region(geom)


def _model_blur(z, taps, geom, rows0, run, rows):
    """Kernel 3's schedule on (T, Hr, W) |z| rows: per frame and run of
    `run` output rows, the run's region rows `rows` at a time; each row's
    horizontal blur hb once at the crop's columns, the vertical taps of
    the output row it completes from the ring of the 2 r previous hb rows
    (row yy in slot yy mod 2 r), then hb into the ring."""
    t = z.shape[0]
    tp = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2
    r2 = 2 * r
    yrow0, x0 = geom.y0 - rows0, geom.x0
    cols = x0 + np.arange(geom.in_w)
    vb_out = np.full((t, geom.in_h, geom.in_w), np.nan, np.float32)
    for f in range(t):
        for j0 in range(0, geom.in_h, run):
            nreg = min(run, geom.in_h - j0) + r2
            ring = np.full((max(r2, 1), geom.in_w), np.nan, np.float32)
            for y0 in range(0, nreg, rows):
                flight = [z[f, yrow0 + j0 - r + y]
                          for y in range(y0, min(y0 + rows, nreg))]
                for i, zr in enumerate(flight):
                    yy = y0 + i
                    hb = zr[cols] * tp[r]
                    for k in range(1, r + 1):
                        hb = hb + (zr[cols - k] * tp[r - k]
                                   + zr[cols + k] * tp[r + k])
                    if yy >= r2:
                        vb = None
                        for ky in range(r2):
                            tv = ring[(yy + ky) % r2] * tp[ky]
                            vb = tv if ky == 0 else vb + tv
                        tv = hb * tp[r2]
                        vb = tv if vb is None else vb + tv
                        vb_out[f, j0 + yy - r2] = vb
                    if r2:
                        ring[yy % r2] = hb
    return vb_out


def _model_epilogue(vb, i_pl, q_pl, u8, win, cfg, layout):
    """The epilogue of each pixel in kernel 3's order, numpy float32."""
    w = win.numpy()
    f32 = np.float32
    if u8 is None:
        iw, qw = i_pl.numpy() * w, q_pl.numpy() * w
    else:
        c = [f32(v) for v in post_fused._u8_chroma_coeffs()]
        rgb = [u8[:, k].numpy().astype(np.float32) for k in range(3)]
        iw = (rgb[0] * c[0] + rgb[1] * c[1] + rgb[2] * c[2]) * w
        qw = (rgb[0] * c[3] + rgb[1] * c[4] + rgb[2] * c[5]) * w
    if cfg.compensate_window:
        inv = f32(1.0) / np.maximum(w, f32(1e-3))
        vb, iw, qw = vb * inv, iw * inv, qw * inv
    if cfg.apply_yiq_gains:
        g = [f32(v) for v in cfg.yiq_gains]
        vb, iw, qw = vb * g[0], iw * g[1], qw * g[2]
    m = [[f32(float(v)) for v in row] for row in YIQ_TO_RGB]
    chans = [np.clip(vb * m[d][0] + iw * m[d][1] + qw * m[d][2], f32(0),
                     f32(1)) for d in range(3)]
    if layout == "tuple3":
        return tuple(chans)
    planar = np.stack(chans, axis=1)
    if layout == "planar":
        return planar
    return np.rint(planar * f32(255.0)).astype(np.uint8)


def _model(rre, rim, i_pl, q_pl, u8, win, cfg, geom, layout, run, rows):
    z = fused.rebuilt_row_ifft(rre, rim, geom.pad_w,
                               1.0 / (geom.pad_h * geom.pad_w),
                               cfg.reconstruct == "magnitude").numpy()
    vb = _model_blur(z, post_fused.blur_taps(cfg.blur_size), geom, 0, run,
                     rows)
    assert not np.isnan(vb).any()  # every output row written
    return _model_epilogue(vb, i_pl, q_pl, u8, win, cfg, layout)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype
        assert np.array_equal(g, w.numpy())


def _ref(rre, rim, i_pl, q_pl, u8, win, cfg, layout):
    chroma = (None, None) if u8 is not None else (i_pl, q_pl)
    return post_fused.rowifft_post_fused_ref(
        rre, rim, *chroma, win, cfg, 0, IN_H, IN_W, "tight", full_w=512,
        src=u8, out_layout=layout)


@pytest.mark.parametrize("radius", range(0, 13))
def test_kernel3_schedule_model_every_radius(radius, monkeypatch):
    """Runs of 40 output rows (the last of 96 part-filled: 16), 3 region
    rows in flight: bit for bit the plain version, f32 I/Q, tuple3.
    Radius 0 comes from a one-tap blur no config gives."""
    if radius == 0:
        monkeypatch.setattr(post_fused, "blur_taps", lambda b: (0.75,))
    cfg = MagnifyConfig().replace(pad_mode="tight",
                                  blur_size=_blur_size(max(radius, 1)))
    assert post_fused._radius(cfg) == radius
    geom, rre, rim, i_pl, q_pl, _, win = _inputs(radius)
    got = _model(rre, rim, i_pl, q_pl, None, win, cfg, geom, "tuple3", 40,
                 3)
    _same(got, _ref(rre, rim, i_pl, q_pl, None, win, cfg, "tuple3"))


@pytest.mark.parametrize("radius,chroma,layout,quirks,run,rows", [
    (2, "u8", "planar_u8", False, 40, 3),
    (2, "f32", "planar", False, 96, 1),
    (5, "u8", "tuple3", True, 7, 2),
    (5, "f32", "planar_u8", True, 33, 4),
    (12, "u8", "planar", False, 50, 2),
    (12, "f32", "tuple3", True, 95, 16),
])
def test_kernel3_schedule_model_variants(radius, chroma, layout, quirks, run,
                                         rows):
    """Both chroma sources, the three layouts, Re z with compensation and
    gains, and other runs and rows in flight: bit for bit the plain
    version; planar_u8 is rint(255 planar)."""
    cfg = MagnifyConfig().replace(pad_mode="tight",
                                  blur_size=_blur_size(radius))
    if quirks:
        cfg = cfg.replace(reconstruct="real", compensate_window=True,
                          apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8))
    geom, rre, rim, i_pl, q_pl, u8, win = _inputs(100 + radius)
    u8 = u8 if chroma == "u8" else None
    got = _model(rre, rim, i_pl, q_pl, u8, win, cfg, geom, layout, run,
                 rows)
    _same(got, _ref(rre, rim, i_pl, q_pl, u8, win, cfg, layout))
    if layout == "planar_u8":
        planar = _model(rre, rim, i_pl, q_pl, u8, win, cfg, geom, "planar",
                        run, rows)
        assert np.array_equal(got, np.rint(planar * np.float32(255.0))
                              .astype(np.uint8))


def test_kernel3_smem_within_the_block_limit():
    """The launch's shared memory (rows in flight x the row engine's two
    padded planes + 2 r ring rows of the crop) fits 227 KB wherever
    `kernel3_rows` gives a (radius, pad_w, crop width) a block, with at
    most 512 threads and a whole number of rows a block; `kernel3_serves`
    takes those whose blocks keep 512 threads on an SM (2048 threads and
    233,472 bytes of shared memory an SM, 1 KB of it a block)."""
    for pad_w in (128, 256, 512, 1024, 2048, 4096, 8192):
        nt = pad_w // 16  # threads a row
        row_floats = 2 * (pad_w + pad_w // 16)  # pbmm_rp_row_floats
        for radius in range(0, 97):
            for in_w in range(128, pad_w - 2 * radius + 1, 128):
                rows = post_fused.kernel3_rows(radius, pad_w, in_w)
                if not rows:
                    assert not post_fused.kernel3_serves(radius, pad_w, in_w)
                    assert 4 * (row_floats + 2 * radius * in_w) > 232448
                    continue
                smem = 4 * (rows * row_floats + 2 * radius * in_w)
                assert smem == post_fused.kernel3_smem(rows, radius, pad_w,
                                                       in_w) <= 232448
                held = min(2048 // (rows * nt),
                           233472 // (smem + 1024)) * rows * nt
                assert post_fused.kernel3_serves(radius, pad_w, in_w) is (
                    held >= 512)
                assert rows * nt <= 512 and rows * nt >= nt


@pytest.mark.parametrize("h,w,strip", [
    (2, 1152, 16), (512, 384, 16), (1024, 640, 16), (1024, 1160, 8),
    (1024, 12, 4), (2048, 1152, 8), (2048, 1156, 4), (4096, 2176, 4),
    (4096, 2050, 2), (8192, 4224, 2), (8192, 4225, 1),
])
def test_phase_col_strip_is_kernel_2s(h, w, strip):
    """Kernel 6 launches as kernel 2's second launch does (512 threads,
    one block an SM): kernel 2's strip where it divides the width, else
    the widest half of it that does, down to `col_strip(h)`, so every
    width the wrapper takes (multiples of `col_strip(h)`) has a strip.
    The narrower strips that would fill the SMs in one wave at one frame
    (4 columns at H = 2048: 288 blocks) measured no faster."""
    got = fused.phase_col_strip(h, w)
    assert got == strip and w % got == 0
    assert got <= fused.colspec_strip(h) and got >= fused.col_strip(h)
    assert got == fused.colspec_strip(h) or w % (2 * got)
    for w_ in range(fused.col_strip(h), 4097, fused.col_strip(h)):
        assert w_ % fused.phase_col_strip(h, w_) == 0
