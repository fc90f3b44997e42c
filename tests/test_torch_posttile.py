"""Kernels 10 and 11's tile (`pbmm_tpu_torch/csrc/post_rgb.cu`), checked on
the CPU.

- The tile planner (`post_fused.post_tile`): for every blur radius 0-96,
  padded width 256-8192, crop width `post_pallas_ok` admits (a multiple
  of 128 with the radius free on each side), one plane and three, a
  strip of at most 256 columns whose ring and two staged groups fit
  232,448 bytes (`post_tile_smem`), at least one block a frame, runs no
  shorter than 8 r rows where the height allows.
- Every thread's division-free index steps (the staging copies, kernel
  11's epilogue) on the planner's tiles: each item once, inside its
  buffer, the padded row and the frame.
- A float32 numpy model of the kernel's schedule: a block owns one frame,
  one strip of output columns (the last one ragged) and a run of output
  rows (the last one short), stages the run's region rows a group at a
  time as 16-byte-aligned segments [x0 + xs - r4, x0 + xs + sw + r4),
  sums each row's horizontal taps once from 16-byte chunks that slide
  through registers (post_tail.cuh's `pbmm_tail_hsum4`), keeps the 2 r
  previous sums in a ring and reads the vertical taps from it, then runs
  the epilogue.  It never reads outside the staged segment or an empty
  ring slot, and equals `post_fused_ref` / `post_fused_rgb_ref` bit for
  bit at radii 0-16, both chroma sources, the three layouts and the
  quirks.
- `post_fused` / `post_fused_rgb` on CPU tensors against the JAX
  package's `post_fused` / `post_fused_rgb` (interpret mode) at radii 0,
  2 and 5: max abs < 1e-6, the bar of tests/test_torch_blur.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.core.window import hann2d_region as jhann
from pbmm_tpu.engine import post_pallas as jpp
from pbmm_tpu_torch import MagnifyConfig
from pbmm_tpu_torch.core.color import YIQ_TO_RGB
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused

IN_H, IN_W = 96, 384  # tight: 128 x 512, y0 = 16, x0 = 64
T = 2
SMEM = 232448
# Registers a thread the planner is given here; on the card the wrappers
# pass the kernel's own count (`post_fused._tile_regs`).
REGS = 64


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


def _cfg(radius: int, monkeypatch, **change):
    """A tight config at this blur radius; radius 0 from a one-tap blur
    no config gives."""
    if radius == 0:
        monkeypatch.setattr(post_fused, "blur_taps", lambda b: (0.75,))
    cfg = MagnifyConfig().replace(pad_mode="tight",
                                  blur_size=_blur_size(max(radius, 1)),
                                  **change)
    assert post_fused._radius(cfg) == radius
    return cfg


# -- the planner -------------------------------------------------------------


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("pad_w", [256, 512, 1024, 2048, 4096, 8192])
def test_post_tile_fits_every_admitted_geometry(pad_w, planes):
    for radius in range(0, 97):
        for in_w in range(128, pad_w - 2 * radius + 1, 128):
            for in_h, t in ((96, 1), (1080, 16), (2160, 1)):
                sw, rows, run = post_fused.post_tile(radius, in_w, in_h, t,
                                                     planes, REGS)
                smem = post_fused.post_tile_smem(sw, rows, radius, planes)
                assert smem <= SMEM, (radius, in_w, planes)
                assert sw % 4 == 0 and 1 <= planes * sw // 4 <= 192
                assert sw <= max(in_w, 32) and rows >= 1
                assert 1 <= run <= in_h
                runs = -(-in_h // run)
                assert -(-in_w // sw) * runs >= 1
                assert runs == 1 or run >= min(8 * max(radius, 1), in_h)


def test_post_tile_shapes():
    """At 1080p, 16 frames, the grid fills the 132 SMs at every radius to
    15 in both kernels; radius 96 with three planes takes strips of 64
    columns (a ring of 2 x 96 x 64 x 3 f32, 147 KB)."""
    for planes in (1, 3):
        for radius in range(0, 16):
            sw, rows, run = post_fused.post_tile(radius, 1920, 1080, 16,
                                                 planes, REGS)
            assert -(-1920 // sw) * -(-1080 // run) * 16 >= 132
    sw, rows, run = post_fused.post_tile(96, 1920, 1152, 1, 3, REGS)
    assert sw == 64
    assert post_fused.post_tile_smem(sw, rows, 96, 3) >= 2 * 96 * 64 * 3 * 4
    assert post_fused.post_tile(2, 1920, 1080, 16, 3, REGS)[:2] == (256, 3)
    assert post_fused.post_tile(2, 1920, 1080, 16, 1, REGS)[:2] == (256, 4)


@pytest.mark.parametrize("regs", [40, 64, 100])
@pytest.mark.parametrize("planes", [1, 3])
def test_post_tile_holds_the_most_threads(planes, regs):
    """Of the strips that fit, the planner takes one whose blocks give an
    SM the most threads (`_tile_blocks_per_sm`: shared memory, warps,
    registers allocated 8 a thread at a time, 32 blocks), the widest of
    those, for the registers the card reports."""
    assert (post_fused._tile_blocks_per_sm(0, 64, 57)
            == post_fused._tile_blocks_per_sm(0, 64, 64) == 16)
    for radius in (0, 2, 5, 13, 15, 31, 96):
        sw, rows, _ = post_fused.post_tile(radius, 1920, 1152, 16, planes,
                                           regs)
        held = post_fused._tile_blocks_per_sm(
            post_fused.post_tile_smem(sw, rows, radius, planes),
            planes * sw // 4, regs) * planes * sw // 4
        for other in (256, 128, 64, 32):
            smem = next((b for b in (post_fused.post_tile_smem(
                other, n, radius, planes)
                for n in post_fused._TILE_ROWS[planes]) if b <= SMEM), None)
            if smem is None:
                continue
            threads = planes * other // 4
            alt = post_fused._tile_blocks_per_sm(smem, threads,
                                                 regs) * threads
            assert alt < held or (alt == held and other <= sw), (
                radius, sw, other)


# -- the threads' index steps -----------------------------------------------


def _stage_steps(nthreads, nch, g_rows, planes, nreg, g):
    """post_tile_kernel's stage_rows(g): the (row-plane, 16-byte chunk)
    items each thread copies, stepped as the kernel steps them (no
    division in the loop)."""
    dc, drp = nthreads % nch, nthreads // nch
    items = []
    for tid in range(nthreads):
        c, rp = tid % nch, tid // nch
        while rp < g_rows * planes:
            if g * g_rows + rp // planes < nreg:
                items.append((rp, c))
            c += dc
            rp += drp
            if c >= nch:
                c -= nch
                rp += 1
    return items


def _epilogue_steps(nthreads, nqa, g_rows, r2, nreg, g):
    """Kernel 11's epilogue of group g: the (group row, column quad)
    items each thread finishes, stepped as the kernel steps them."""
    deq, dei = nthreads % nqa, nthreads // nqa
    items = []
    for tid in range(nthreads):
        q, i = tid % nqa, tid // nqa
        while i < g_rows:
            item, yy = (i, q), g * g_rows + i
            q += deq
            i += dei
            if q >= nqa:
                q -= nqa
                i += 1
            if r2 <= yy < nreg:
                items.append(item)
    return items


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("radius,in_h,in_w,pad_w,t", [
    (0, 96, 384, 512, 2), (2, 320, 384, 512, 2), (2, 1080, 1920, 2048, 16),
    (2, 1080, 1920, 2048, 1), (5, 1080, 1920, 2048, 16),
    (13, 1080, 1920, 2048, 16), (15, 1080, 128, 2048, 1),
    (31, 1152, 1920, 2048, 16), (96, 1152, 1024, 2048, 1),
])
def test_tile_thread_steps_stay_in_bounds(radius, in_h, in_w, pad_w, t,
                                          planes):
    """Every thread's division-free index steps in `post_tile_kernel`, on
    the planner's tile, every strip (the last one ragged) and run (the
    last one short), first and last group: the copies cover each 16-byte
    chunk of each needed row segment once, inside the staged buffer and
    inside the padded row (x0 = 64 as at 1080p tight, 128 at radius 96);
    kernel 11's
    epilogue finishes each row and quad of a group once, inside the sums
    buffer and the frame."""
    sw, g_rows, run = post_fused.post_tile(radius, in_w, in_h, t, planes,
                                           REGS)
    nthreads, r2, r4 = planes * sw // 4, 2 * radius, -(-radius // 4) * 4
    x0 = max(64, -(-r4 // 64) * 64)
    assert x0 >= r4 and x0 + in_w + r4 <= pad_w
    seg = sw + 2 * r4
    for xs in range(0, in_w, sw):
        sws = min(sw, in_w - xs)
        nch = (sws + 2 * r4) // 4
        for j0 in sorted({0, (in_h - 1) // run * run}):
            nreg = min(run, in_h - j0) + r2
            ngroups = -(-nreg // g_rows)
            for g in sorted({0, ngroups - 1}):
                got = _stage_steps(nthreads, nch, g_rows, planes, nreg, g)
                want = [(rp, c) for rp in range(g_rows * planes)
                        for c in range(nch)
                        if g * g_rows + rp // planes < nreg]
                assert sorted(got) == want, (xs, j0, g)
                for rp, c in got:
                    assert rp * seg + 4 * c + 4 <= g_rows * planes * seg
                    assert x0 + xs - r4 + 4 * c + 4 <= pad_w
                if planes == 1:
                    continue
                got = _epilogue_steps(nthreads, sws // 4, g_rows, r2, nreg,
                                      g)
                want = [(i, q) for i in range(g_rows)
                        for q in range(sws // 4)
                        if r2 <= g * g_rows + i < nreg]
                assert sorted(got) == want, (xs, j0, g)
                for i, q in got:
                    assert ((i * planes + 2) * sw + 4 * q + 4
                            <= g_rows * planes * sw)
                    assert j0 + g * g_rows + i - r2 < in_h
                    assert xs + 4 * q + 4 <= in_w


# -- the schedule model ------------------------------------------------------


def _hsum4(z, base, r, tp):
    """post_tail.cuh's pbmm_tail_hsum4 for every quad at once: base (nq,)
    quad starts in the staged segment z."""
    def chunk(pos):
        assert pos.min() >= 0 and pos.max() + 3 < z.shape[0]
        v = z[pos[:, None] + np.arange(4)]
        assert not np.isnan(v).any()
        return v

    nq = base.shape[0]
    lo = np.empty((nq, 8), np.float32)
    hi = np.empty((nq, 8), np.float32)
    c = chunk(base)
    lo[:, 4:] = c
    hi[:, :4] = c
    hb = lo[:, 4:] * tp[r]
    m = 0
    while 4 * m < r:
        lo[:, :4] = chunk(base - 4 * m - 4)
        hi[:, 4:] = chunk(base + 4 * m + 4)
        for s in range(1, 5):
            k = 4 * m + s
            if k > r:
                break
            hb = hb + (lo[:, 4 - s:8 - s] * tp[r - k]
                       + hi[:, s:s + 4] * tp[r + k])
        lo[:, 4:] = lo[:, :4]
        hi[:, :4] = hi[:, 4:]
        m += 1
    return hb


def _model_blur(chans, planes, taps, geom, rows0, sw, g_rows, run):
    """The blocks of post_tile_kernel on (T planes, Hr, W) rows: the
    blurred, cropped planes (planes, T, H, W)."""
    tp = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2
    r2, r4 = 2 * r, -(-r // 4) * 4
    yrow0, x0 = geom.y0 - rows0, geom.x0
    t = chans.shape[0] // planes
    seg = sw + 2 * r4
    out = np.full((planes, t, geom.in_h, geom.in_w), np.nan, np.float32)
    for f in range(t):
        for xs in range(0, geom.in_w, sw):
            sws = min(sw, geom.in_w - xs)
            base = r4 + np.arange(0, sws, 4)
            for j0 in range(0, geom.in_h, run):
                nreg = min(run, geom.in_h - j0) + r2
                ring = np.full((max(r2, 1), planes, sw), np.nan, np.float32)
                for g in range(-(-nreg // g_rows)):
                    staged = np.full((g_rows, planes, seg), np.nan,
                                     np.float32)
                    for i in range(g_rows):
                        y = g * g_rows + i
                        if y >= nreg:
                            continue
                        row = yrow0 + j0 - r + y
                        c0 = x0 + xs - r4
                        for p in range(planes):
                            staged[i, p, :sws + 2 * r4] = chans[
                                f * planes + p, row, c0:c0 + sws + 2 * r4]
                    # The group's blurred rows (kernel 11's sums buffer).
                    sums = np.full((g_rows, planes, sw), np.nan, np.float32)
                    for i in range(g_rows):
                        yy = g * g_rows + i
                        if yy >= nreg:
                            break
                        for p in range(planes):
                            hb = _hsum4(staged[i, p], base, r, tp)
                            if yy >= r2:
                                slot = yy % max(r2, 1)
                                vb = None
                                for ky in range(r2):
                                    v = ring[slot, p, :sws].reshape(-1, 4)
                                    assert not np.isnan(v).any()
                                    tv = v * tp[ky]
                                    vb = tv if ky == 0 else vb + tv
                                    slot = 0 if slot + 1 == r2 else slot + 1
                                tv = hb * tp[r2]
                                vb = tv if vb is None else vb + tv
                                sums[i, p, :sws] = vb.reshape(-1)
                            if r2:
                                ring[yy % r2, p, :sws] = hb.reshape(-1)
                    for i in range(g_rows):
                        yy = g * g_rows + i
                        if r2 <= yy < nreg:
                            assert not np.isnan(sums[i, :, :sws]).any()
                            out[:, f, j0 + yy - r2, xs:xs + sws] = (
                                sums[i, :, :sws])
    assert not np.isnan(out).any()  # every output pixel written
    return out


def _model_epilogue(v, i_pl, q_pl, u8, win, cfg, layout):
    """post_tail.cuh's epilogue, numpy float32: v (3 or 1, T, H, W)."""
    f32 = np.float32
    w = win.numpy()
    y = v[0]
    if v.shape[0] == 3:
        iw, qw = v[1], v[2]
    elif u8 is None:
        iw, qw = i_pl.numpy() * w, q_pl.numpy() * w
    else:
        c = [f32(x) for x in post_fused._u8_chroma_coeffs()]
        rgb = [u8[:, k].numpy().astype(np.float32) for k in range(3)]
        iw = (rgb[0] * c[0] + rgb[1] * c[1] + rgb[2] * c[2]) * w
        qw = (rgb[0] * c[3] + rgb[1] * c[4] + rgb[2] * c[5]) * w
    if cfg.compensate_window:
        inv = f32(1.0) / np.maximum(w, f32(1e-3))
        y, iw, qw = y * inv, iw * inv, qw * inv
    if cfg.apply_yiq_gains:
        g = [f32(x) for x in cfg.yiq_gains]
        y, iw, qw = y * g[0], iw * g[1], qw * g[2]
    m = [[f32(float(x)) for x in row] for row in YIQ_TO_RGB]
    chans = [np.clip(y * m[d][0] + iw * m[d][1] + qw * m[d][2], f32(0),
                     f32(1)) for d in range(3)]
    if layout == "tuple3":
        return tuple(chans)
    planar = np.stack(chans, axis=1)
    if layout == "planar":
        return planar
    return np.rint(planar * f32(255.0)).astype(np.uint8)


def _inputs(seed: int, planes: int):
    geom = geometry_for(IN_H, IN_W, "tight")
    rng = np.random.default_rng(seed)
    chans = torch.from_numpy(rng.uniform(
        -0.2, 0.9, (T * planes, geom.pad_h, geom.pad_w)).astype(np.float32))
    i_pl, q_pl = (torch.from_numpy(rng.uniform(-0.6, 0.6, (T, IN_H, IN_W))
                                   .astype(np.float32)) for _ in range(2))
    u8 = torch.from_numpy(rng.integers(0, 256, (T, 3, IN_H, IN_W),
                                       dtype=np.uint8))
    return geom, chans, i_pl, q_pl, u8, hann2d_region(geom)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype
        assert np.array_equal(g, w.numpy())


def _check_model(kernel, cfg, layout, chroma, tile, seed):
    planes = 3 if kernel == 11 else 1
    geom, chans, i_pl, q_pl, u8, win = _inputs(seed, planes)
    v = _model_blur(chans.numpy(), planes,
                    post_fused.blur_taps(cfg.blur_size), geom, 0, *tile)
    u8 = u8 if chroma == "u8" else None
    got = _model_epilogue(v, i_pl, q_pl, u8, win, cfg, layout)
    if kernel == 11:
        want = post_fused.post_fused_rgb_ref(chans, win, cfg, 0, IN_H, IN_W,
                                             "tight", layout)
    else:
        iq = (None, None) if u8 is not None else (i_pl, q_pl)
        want = post_fused.post_fused_ref(chans, *iq, win, cfg, 0, IN_H,
                                         IN_W, "tight", layout, src=u8)
    _same(got, want)
    if layout == "planar_u8":
        planar = _model_epilogue(v, i_pl, q_pl, u8, win, cfg, "planar")
        assert np.array_equal(got, np.rint(planar * np.float32(255.0))
                              .astype(np.uint8))


@pytest.mark.parametrize("radius", range(0, 17))
def test_tile_schedule_model_every_radius(radius, monkeypatch):
    """Kernel 11's schedule at radii 0-16: strips of 128 columns, runs of
    40 rows (the last of 96: 16), groups of 3 rows; bit for bit the plain
    version, tuple3."""
    cfg = _cfg(radius, monkeypatch, chroma="rgb")
    _check_model(11, cfg, "tuple3", "rgb", (128, 3, 40), radius)


@pytest.mark.parametrize("kernel,radius,chroma,layout,quirks,tile", [
    (11, 2, "rgb", "planar_u8", False, (256, 4, 96)),
    (11, 5, "rgb", "planar", True, (64, 1, 7)),
    (11, 13, "rgb", "planar_u8", True, (32, 2, 33)),
    (10, 2, "iq", "tuple3", False, (256, 4, 17)),
    (10, 2, "u8", "planar_u8", True, (128, 2, 96)),
    (10, 5, "u8", "planar", False, (256, 1, 50)),
    (10, 13, "iq", "planar_u8", True, (64, 4, 95)),
    (10, 15, "u8", "tuple3", False, (128, 3, 104)),
])
def test_tile_schedule_model_variants(kernel, radius, chroma, layout, quirks,
                                      tile):
    """Both kernels, the three chroma sources and layouts, Re z-style
    negative rows, compensation and gains, strips of 32-256 columns (256
    leaves a ragged strip of 128), 1-4 rows a group and runs that do not
    divide the height: bit for bit the plain version; planar_u8 is
    rint(255 planar)."""
    change = dict(chroma="rgb") if kernel == 11 else {}
    if quirks:
        change.update(compensate_window=True, apply_yiq_gains=True,
                      yiq_gains=(1.0, 1.2, 0.8))
    cfg = MagnifyConfig().replace(pad_mode="tight",
                                  blur_size=_blur_size(radius), **change)
    _check_model(kernel, cfg, layout, chroma, tile, 200 + radius)


# -- the CPU wrappers against the JAX kernels --------------------------------


def _jax_cfgs(radius, monkeypatch, **change):
    """(JAX config, port config) at this radius: at 0 both packages'
    blur_taps give one tap, under a blur_size no other test uses (the JAX
    kernels are jitted with the config static)."""
    if radius == 0:
        monkeypatch.setattr(jpp, "blur_taps", lambda b: (0.75,))
        monkeypatch.setattr(post_fused, "blur_taps", lambda b: (0.75,))
        blur = 0.0123
    else:
        blur = _blur_size(radius)
    j = JCfg().tuned_for_tpu().replace(pad_mode="tight", blur_size=blur,
                                       **change)
    t = MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight",
                                                blur_size=blur, **change)
    assert post_fused._radius(t) == jpp._radius(j) == radius
    return j, t


@pytest.mark.parametrize("radius", [0, 2, 5])
def test_post_fused_vs_jax(radius, monkeypatch):
    jc, tc = _jax_cfgs(radius, monkeypatch)
    geom, chans, i_pl, q_pl, _, win = _inputs(300 + radius, 1)
    want = jpp.post_fused(jnp.asarray(chans.numpy()),
                          jnp.asarray(i_pl.numpy()),
                          jnp.asarray(q_pl.numpy()),
                          jhann(jgeom(IN_H, IN_W, "tight")), jc, 0, IN_H,
                          IN_W, "tight", interpret=True)
    got = post_fused.post_fused(chans, i_pl, q_pl, win, tc, 0, IN_H, IN_W,
                                "tight")
    for a, b in zip(got, want):
        assert a.shape == (T, IN_H, IN_W)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < 1e-6


@pytest.mark.parametrize("radius", [0, 2, 5])
def test_post_fused_rgb_vs_jax(radius, monkeypatch):
    jc, tc = _jax_cfgs(radius, monkeypatch, chroma="rgb")
    geom, chans, *_, win = _inputs(400 + radius, 3)
    want = jpp.post_fused_rgb(jnp.asarray(chans.numpy()),
                              jhann(jgeom(IN_H, IN_W, "tight")), jc, 0,
                              IN_H, IN_W, "tight", interpret=True)
    got = post_fused.post_fused_rgb(chans, win, tc, 0, IN_H, IN_W, "tight")
    for a, b in zip(got, want):
        assert a.shape == (T, IN_H, IN_W)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < 1e-6
    u8 = post_fused.post_fused_rgb(chans, win, tc, 0, IN_H, IN_W, "tight",
                                   "planar_u8")
    want_u8 = np.round(np.stack([np.asarray(b) for b in want], 1)
                       * 255.0).astype(np.uint8)
    assert int(np.abs(u8.numpy().astype(int) - want_u8).max()) <= 1
