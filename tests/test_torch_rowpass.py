"""The row engine of kernels 1, 4, 7 and 8's row pass
(`pbmm_tpu_torch/csrc/row_pass.cuh`),
checked on the CPU: its twiddle words against the JAX package, and a
numpy-f32 model of its register-pass schedule against the stage-by-stage
radix-2 that kernels 1, 3 and 8 run (`common.cuh::pbmm_radix2`).

The model copies the engine's pass split (`pbmm_row_plan`), its groups
(g = t + j nt, base = (g / st) st 2^K + g mod st), its compact twiddle
index (d - 1 + lo + (q mod dl) st) and its butterflies, each product and
sum rounded on its own in f32 (numpy contracts nothing into an FMA).  It
must give the stage-by-stage result bit for bit, forward and inverse, at
every row length the kernels take, and the forward model that skips the
last 7 stages of the tiles a kernel does not store must give the same
kept lanes.  The shared-memory layout (`pbmm_rp_pad`) is checked to give
every pass addresses a thread reaches by constant offsets from one base
a group, and to put a warp's 32 accesses on at most two words a bank.
Last, the model with kernel 7's rebuild and |z| and with kernel 4's pre
stage is held against the JAX kernels in interpret mode, and the model of
kernel 8's row pass (forward real, with the real input's first stage;
forward complex; inverse with its scale) bit for bit against the
stage-by-stage kernel it replaces and against the JAX `_fft_axis` in
interpret mode at gm_precision "highest" (whose traces the module drops
when it ends)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral import pallas_fft as jfft
from pbmm_tpu_torch.core.color import RGB_TO_YIQ
from pbmm_tpu_torch.core.window import geometry_for
from pbmm_tpu_torch.spectral import fused, radix2
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width, kept_tiles

@pytest.fixture(scope="module", autouse=True)
def _drop_highest_traces():
    """Drop the JAX traces made at gm_precision "highest" when the module
    ends, so later tests of the process trace the default anew."""
    yield
    jfft.set_gm_precision("")
    jax.clear_caches()


KMAX = 4  # PBMM_RP_KMAX
P = 1 << KMAX  # PBMM_RP_P: points a thread holds
MAXPASS = 4  # PBMM_RP_MAXPASS
LANE = 128
_ALL_N = [1 << s for s in range(1, 14)]  # 2 .. 8192
_ROW_N = [1 << s for s in range(7, 14)]  # 128 .. 8192, the kernels' range


def _split(stages):
    np_ = -(-stages // KMAX)
    return [stages // np_ + (1 if p < stages % np_ else 0)
            for p in range(np_)]


def row_plan(n, inverse):
    """[(k, lst)] of each pass: `pbmm_row_plan` of row_pass.cuh."""
    stages = n.bit_length() - 1
    if inverse:
        ks = _split(stages)
    else:
        ks = (_split(stages - 7) if stages > 7 else []) + _split(7)
    out, s0 = [], 0
    for k in ks:
        out.append((k, s0 if inverse else stages - s0 - k))
        s0 += k
    return out


def groups(n, k, lst, adj=False):
    """(base, lo) of every group, shape (nt, J): thread t's groups
    g = t + j nt, or g = t J + j with `adj` (`PbmmRpGroups`)."""
    nt, st, nj = n // P, 1 << lst, P >> k
    t, j = np.arange(nt)[:, None], np.arange(nj)[None, :]
    g = t * nj + j if adj else t + j * nt
    lo = g & (st - 1)
    return ((g >> lst) << (lst + k)) | lo, lo


def pad(p):
    """`pbmm_rp_pad`: element p's word in a shared-memory plane."""
    return p + (p >> 4)


def _butterfly(xr, xi, ur, ui, tr, ti, inverse):
    if not inverse:
        br, bi = xr - ur, xi - ui
        return (xr + ur, xi + ui, br * tr - bi * ti, br * ti + bi * tr)
    zr, zi = ur * tr - ui * ti, ur * ti + ui * tr
    return xr + zr, xi + zi, xr - zr, xi - zi


def _real_butterfly(xr, ur, tr, ti):
    """The real input's first stage (`fft_axis.cu::fa_real_first_stage`):
    no imaginary part read, 0 above, br tw below."""
    br = xr - ur
    return xr + ur, np.zeros_like(xr), br * tr, br * ti


def stage_by_stage(re, im, inverse, real=False):
    """`pbmm_radix2` on (rows, n) f32: every stage over the whole row,
    twiddle of the bottom element i1 from row s of `_dif_twiddles`;
    `real`: the first stage of kernel 8's real rows."""
    n = re.shape[-1]
    tw_re, tw_im = radix2._dif_twiddles(n, inverse)
    re, im = re.copy(), im.copy()
    k = np.arange(n // 2)
    for s in range(n.bit_length() - 1):
        d = 1 << s if inverse else n >> (s + 1)
        j = k & (d - 1)
        i0 = ((k - j) << 1) + j
        i1 = i0 + d
        if real and s == 0:
            re[:, i0], im[:, i0], re[:, i1], im[:, i1] = _real_butterfly(
                re[:, i0], re[:, i1], tw_re[s, i1], tw_im[s, i1])
            continue
        re[:, i0], im[:, i0], re[:, i1], im[:, i1] = _butterfly(
            re[:, i0], im[:, i0], re[:, i1], im[:, i1], tw_re[s, i1],
            tw_im[s, i1], inverse)
    return re, im


def register_passes(re, im, inverse, keep=None, real=False):
    """The engine's schedule on (rows, n) f32: per pass, each group's 2^K
    points gathered, the pass's stages run on them, scattered back.
    `keep` (tiles, forward only): groups of passes whose spans are all
    under 128 run only in kept tiles, as `PbmmRpGroups::on`.  `real`
    (forward only): the first stage of the first pass is the real input's
    (`pbmm_rp_stages<..., REAL>`)."""
    n = re.shape[-1]
    cre, cim = radix2.compact_twiddles(n, inverse)
    re, im = re.copy(), im.copy()
    plan = row_plan(n, inverse)
    for i, (k, lst) in enumerate(plan):
        st, L = 1 << lst, 1 << k
        adj = not inverse and i == len(plan) - 1  # kernel 4's last pass
        base, lo = (a.reshape(-1) for a in groups(n, k, lst, adj))
        if keep is not None and (st << k) <= LANE:
            on = np.isin(base // LANE, keep)
            base, lo = base[on], lo[on]
        pos = base[:, None] + np.arange(L)[None, :] * st
        xr, xi = re[:, pos], im[:, pos]  # (rows, groups, L)
        for t in range(k):
            tt = t if inverse else k - 1 - t
            dl = 1 << tt
            for q in range(L):
                if q & dl:
                    continue
                w = (st << tt) - 1 + lo + (q & (dl - 1)) * st
                if real and i == 0 and t == 0:
                    (xr[..., q], xi[..., q], xr[..., q + dl],
                     xi[..., q + dl]) = _real_butterfly(
                        xr[..., q], xr[..., q + dl], cre[w], cim[w])
                    continue
                (xr[..., q], xi[..., q], xr[..., q + dl],
                 xi[..., q + dl]) = _butterfly(
                    xr[..., q], xi[..., q], xr[..., q + dl], xi[..., q + dl],
                    cre[w], cim[w], inverse)
        re[:, pos], im[:, pos] = xr, xi
    return re, im


def _bits(*arrays):
    return [np.ascontiguousarray(a, np.float32).view(np.uint32)
            for a in arrays]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", _ALL_N)
def test_dif_twiddles_match_jax(n, inverse):
    got = radix2._dif_twiddles(n, inverse)
    want = jfft._dif_twiddles(n, inverse)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", _ALL_N)
def test_compact_twiddles_hold_every_word(n, inverse):
    # Row s of the table (span d) is periodic with period d: word
    # d - 1 + (i mod d) of the compact table is its entry i, bit for bit.
    tw = jfft._dif_twiddles(n, inverse)
    compact = radix2.compact_twiddles(n, inverse)
    assert all(c.shape == (n - 1,) and c.dtype == np.float32
               for c in compact)
    i = np.arange(n)
    for s in range(n.bit_length() - 1):
        d = 1 << s if inverse else n >> (s + 1)
        for full, c in zip(_bits(*tw), _bits(*compact)):
            np.testing.assert_array_equal(c[d - 1 + (i % d)], full[s])


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("n", _ROW_N)
def test_register_passes_match_stage_by_stage(n, inverse):
    plan = row_plan(n, inverse)
    assert sum(k for k, _ in plan) == n.bit_length() - 1
    assert len(plan) <= MAXPASS and all(1 <= k <= KMAX for k, _ in plan)
    rng = np.random.default_rng(n + inverse)
    re, im = (rng.standard_normal((3, n)).astype(np.float32)
              for _ in range(2))
    im[0] = 0.0  # a real row, as kernel 4 feeds it: no shortcut taken
    want = stage_by_stage(re, im, inverse)
    got = register_passes(re, im, inverse)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    # And it is the DFT: bit-reversed out (DIF) or in (DIT).
    rev = radix2.bit_reverse_permutation(n)
    x = re.astype(np.float64) + 1j * im
    ref = (np.fft.fft(x)[:, rev] if not inverse
           else np.fft.ifft(x[:, rev], norm="forward"))
    z = got[0] + 1j * got[1].astype(np.float64)
    assert np.abs(z - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", _ROW_N)
def test_forward_skip_of_unkept_tiles_keeps_the_kept_lanes(n):
    # Kernel 4 runs the last 7 stages (spans 64 .. 1) only in the tiles it
    # stores: the kept lanes stay bit for bit those of every stage run.
    keep = kept_tiles(n)
    plan = row_plan(n, False)
    assert [k for k, _ in plan[-2:]] == [4, 3]
    assert all((1 << lst) << k <= LANE for k, lst in plan[-2:])
    rng = np.random.default_rng(7 * n)
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = np.zeros_like(re)
    want = stage_by_stage(re, im, False)
    got = register_passes(re, im, False, keep)
    lanes = np.concatenate([np.arange(t * LANE, (t + 1) * LANE)
                            for t in keep])
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g[:, lanes], w[:, lanes])


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("n", _ROW_N)
def test_shared_layout_offsets_and_banks(n, inverse):
    # The padded layout is one-to-one into N + N / 16 words; in every pass
    # point q of a group lies pad(q st) words past pad(base) (so the kernel
    # reaches it by an immediate offset), and the 32 threads of a warp
    # touch at most two words of a bank for each of their (j, q) accesses.
    # Kernel 4's last pass takes adjacent groups (adj), the others not.
    p = np.arange(n)
    assert len(set(pad(p))) == n and pad(p).max() < n + n // 16
    nt = n // P
    plan = row_plan(n, inverse)
    worst = []
    for i, (k, lst) in enumerate(plan):
        st = 1 << lst
        adj = not inverse and i == len(plan) - 1
        base, _ = groups(n, k, lst, adj)
        pos = base[:, :, None] + np.arange(1 << k) * st
        assert np.array_equal(pad(pos), pad(base)[:, :, None]
                              + pad(np.arange(1 << k) * st))
        ways = 1
        for w0 in range(0, nt, 32):
            banks = pad(pos[w0:w0 + 32]) % 32  # (threads, J, L)
            for j in range(banks.shape[1]):
                for q in range(banks.shape[2]):
                    ways = max(ways, np.bincount(banks[:, j, q]).max())
        worst.append(ways)
    assert max(worst) <= 2, worst


@pytest.mark.parametrize("magnitude", [True, False], ids=["abs", "re"])
@pytest.mark.parametrize("w", [256, 512])
def test_engine_model_of_kernel7_matches_jax(w, magnitude):
    # Kernel 7's function as the engine computes it (the Hermitian rebuild,
    # the register passes, |z| or Re z times the scale, each op rounded in
    # f32) against the JAX kernel in interpret mode.
    hb = 8
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(w)
    re, im = (rng.standard_normal((2, hb, wk)).astype(np.float32)
              for _ in range(2))
    xr, xi = (a.numpy().reshape(-1, w) for a in fused.rebuild_lanes(
        torch.from_numpy(re), torch.from_numpy(im), w))
    zr, zi = register_passes(xr, xi, True)
    scale = np.float32(1.0 / (hb * w))
    got = (np.sqrt(zr * zr + zi * zi) if magnitude else zr) * scale
    want = np.asarray(jfused.row_ifft_magnitude(
        jnp.asarray(re), jnp.asarray(im), magnitude=magnitude, pad_h=hb,
        full_w=w, interpret=True)).reshape(-1, w)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_engine_model_of_kernel4_matches_jax():
    # Kernel 4's function as the engine computes it (the pre stage's luma,
    # the centre pad and window, the register passes with the unkept
    # tiles' last 7 stages skipped, the kept lanes) against the JAX
    # kernel in interpret mode, at 200x300 (512 lanes, 3 of 4 tiles kept).
    h, w = 200, 300
    g = geometry_for(h, w, "tight")
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + h, g.pad_h)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 3, h, w), dtype=np.uint8)
    luma = tuple(float(c) for c in RGB_TO_YIQ[0])
    hc, off = fused._u8_args(torch.from_numpy(frames), g.pad_h, g.pad_w,
                             g.y0, g.x0, r0)
    f = fused.unit_float(torch.from_numpy(frames))
    y = fused.channel_mix(f[:, 0], f[:, 1], f[:, 2], luma)
    y = torch.nn.functional.pad(y, (g.x0, g.pad_w - w - g.x0, off,
                                    hc - off - h)).numpy()
    wy, wx = fused._hann_pair(g.pad_h, g.pad_w)
    x = (y * wy[r0:r0 + hc, None].astype(np.float32)) * wx.astype(np.float32)
    keep = kept_tiles(g.pad_w)
    zr, zi = register_passes(x.reshape(-1, g.pad_w),
                             np.zeros_like(x.reshape(-1, g.pad_w)), False,
                             keep)
    lanes = np.concatenate([np.arange(t * LANE, (t + 1) * LANE)
                            for t in keep])
    got = zr[:, lanes] + 1j * zi[:, lanes].astype(np.float64)
    want = jfused.windowed_row_fft_u8planar(
        jnp.asarray(frames), luma, pad_h=g.pad_h, pad_w=g.pad_w, y0=g.y0,
        x0=g.x0, row0=r0, keep_half=True, interpret=True)
    want = (np.asarray(want[0]) + 1j * np.asarray(want[1])).reshape(got.shape)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("keep_half", [True, False], ids=["kept", "full"])
@pytest.mark.parametrize("w", [256, 512])
def test_engine_model_of_kernel1_matches_jax(w, keep_half):
    # Kernel 1's function as the engine computes it (y * wy[row] * wx
    # rounded in f32 in the pre stage's order, the register passes with
    # the unkept tiles' last 7 stages skipped, the kept lanes): bit for bit
    # the stage-by-stage DIF on the same windowed rows (kernel 8's row pass,
    # the identity chip_smoke.py holds on the card), and against the JAX
    # kernel in interpret mode.
    pad_h, hc, row0 = 384, 192, 64
    rng = np.random.default_rng(w + keep_half)
    y = rng.random((2, hc, w)).astype(np.float32)
    wy, wx = fused._hann_pair(pad_h, w)
    x = ((y * wy[row0:row0 + hc, None]) * wx).reshape(-1, w)
    keep = kept_tiles(w) if keep_half else list(range(w // LANE))
    zr, zi = register_passes(x, np.zeros_like(x), False, keep)
    lanes = np.concatenate([np.arange(t * LANE, (t + 1) * LANE)
                            for t in keep])
    sr, si = stage_by_stage(x, np.zeros_like(x), False)
    for g, s in zip(_bits(zr[:, lanes], zi[:, lanes]),
                    _bits(sr[:, lanes], si[:, lanes])):
        np.testing.assert_array_equal(g, s)
    got = zr[:, lanes] + 1j * zi[:, lanes].astype(np.float64)
    want = jfused.windowed_row_fft(jnp.asarray(y), pad_h=pad_h, row0=row0,
                                   keep_half=keep_half, interpret=True)
    want = (np.asarray(want[0]) + 1j * np.asarray(want[1])).reshape(got.shape)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("n", [256, 512])
def test_engine_model_of_kernel8_matches_jax(n, kind):
    # Kernel 8's row pass as the row engine computes it (the register
    # passes; a real input's first stage reads no imaginary plane; the
    # inverse's scale one rounded product at the end): bit for bit the
    # stage-by-stage kernel it replaces (fft_rows_kernel, which keeps the
    # rows of 2 to 64 points), and against the JAX `_fft_axis` along
    # axis 2 in interpret mode.
    real, inverse = kind == "forward_real", kind == "inverse_scaled"
    b, h = 2, 8
    rng = np.random.default_rng(n + len(kind))
    re, im = (rng.standard_normal((b, h, n)).astype(np.float32)
              for _ in range(2))
    scale = 1.0 / (h * n) if inverse else 1.0
    x_im = np.zeros_like(re) if real else im
    zr, zi = register_passes(re.reshape(-1, n), x_im.reshape(-1, n), inverse,
                             real=real)
    sr, si = stage_by_stage(re.reshape(-1, n), x_im.reshape(-1, n), inverse,
                            real=real)
    if scale != 1.0:
        zr, zi, sr, si = (a * np.float32(scale) for a in (zr, zi, sr, si))
    for g, w in zip(_bits(zr, zi), _bits(sr, si)):
        np.testing.assert_array_equal(g, w)
    jfft.set_gm_precision("highest")
    try:
        want = jfft._fft_axis(jnp.asarray(re),
                              None if real else jnp.asarray(im), 2, inverse,
                              scale, True)
    finally:
        jfft.set_gm_precision("")
    got = (zr + 1j * zi.astype(np.float64)).reshape(b, h, n)
    want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
