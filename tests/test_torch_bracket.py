"""The bracket passes and the tight combine pass of padded sizes above 8192
(`pbmm_tpu_torch/csrc/col_pass.cuh`, `csrc/colspec_chunk.cu`), on the CPU.

- A numpy-f32 model of the split (the outer stages, spans 8192 and up, as
  passes of up to 6 stages over groups {base + q st} with the compact
  twiddle words; the inner stages on each contiguous 8192-point block)
  equals the stage-by-stage radix-2 (`common.cuh::pbmm_radix2`) bit for
  bit, forward (bracket first) and inverse (bracket last), at 16384 and
  32768 and, real input first, as kernel 8's row pass runs it; every pass
  touches each point once and only points inside the sequence.
- The words the blocks read: the first 8191 words of the compact table of
  n are the table of 8192, and the stage rows of the 8192 table are the
  first 8192 entries of n's.
- A numpy model of kernel 2's m > 64 four-step (the combine pass with its
  points staged in shared memory, words inside the 2 m 32 floats; the
  four-step twiddle; the 128-point DIF of each block; the fourstep row
  order) against `np.fft` at m = 65, 67 and 68, forward and inverse, max
  error / max magnitude < 1e-5.
- The planners at every padded size to 32768: the strips of kernels 2, 6
  and 12 fit a block and divide the kept lanes, the bracket plan, which
  heights take the second scratch, the kept-tile count, and the route of
  the y_only tail (`kernel3_serves`: kernels 7 + 10 above 8192 lanes)."""

import numpy as np
import pytest

from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.spectral import fused, radix2
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

B = 8192  # PBMM_BK_N
LANE = 128
_SMEM = 232448  # bytes of shared memory an H100 block may use


def _butterfly(xr, xi, ur, ui, tr, ti, inverse):
    """row_pass.cuh's butterfly, each product and sum rounded on its own
    (numpy f32 arithmetic has no FMA)."""
    if not inverse:
        br, bi = xr - ur, xi - ui
        return xr + ur, xi + ui, br * tr - bi * ti, br * ti + bi * tr
    zr, zi = ur * tr - ui * ti, ur * ti + ui * tr
    return xr + zr, xi + zi, xr - zr, xi - zi


def stage_by_stage(re, im, inverse, real=False):
    """pbmm_radix2 on (rows, n) f32 planes: the `_dif_twiddles` rows in
    execution order; real: the forward's first stage reads no imaginary
    plane (fft_axis.cu's real first stage)."""
    re, im = re.copy(), im.copy()
    rows, n = re.shape
    twr, twi = radix2._dif_twiddles(n, inverse)
    for s in range(n.bit_length() - 1):
        d = (1 << s) if inverse else n >> (s + 1)
        a = re.reshape(rows, n // (2 * d), 2, d)
        b = im.reshape(rows, n // (2 * d), 2, d)
        tr = twr[s].reshape(n // (2 * d), 2, d)[:, 1]
        ti = twi[s].reshape(n // (2 * d), 2, d)[:, 1]
        xr, xi, ur, ui = a[:, :, 0], b[:, :, 0], a[:, :, 1], b[:, :, 1]
        if real and s == 0:
            br = xr - ur
            out = (xr + ur, np.zeros_like(xr), br * tr, br * ti)
        else:
            out = _butterfly(xr, xi, ur, ui, tr, ti, inverse)
        a[:, :, 0], b[:, :, 0], a[:, :, 1], b[:, :, 1] = out
    return re, im


def bracket_groups(n, k, lst):
    """(G, L) point indices of a bracket pass: group g holds {base + q st},
    base = (g / st) st L + g mod st (col_pass.cuh::pbmm_cp_base), and its
    offset lo = g mod st into each twiddle row."""
    g = np.arange(n >> k)
    st = 1 << lst
    base = ((g >> lst) << (lst + k)) | (g & (st - 1))
    return base[:, None] + np.arange(1 << k)[None, :] * st, g & (st - 1)


def bracket_pass(re, im, k, lst, inverse, real=False):
    """One bracket pass in place (col_pass.cuh::pbmm_cp_stages, COMPACT):
    the group's points in registers, k stages, the compact word d - 1 +
    (i1 mod d) = (st << tt) - 1 + lo + (q mod dl) st of each butterfly."""
    n = re.shape[-1]
    ctr, cti = radix2.compact_twiddles(n, inverse)
    idx, lo = bracket_groups(n, k, lst)
    st, L = 1 << lst, 1 << k
    xr, xi = re[:, idx], im[:, idx]
    for t in range(k):
        tt = t if inverse else k - 1 - t
        dl = 1 << tt
        for q in range(L):
            if q & dl:
                continue
            w = (st << tt) - 1 + lo + (q & (dl - 1)) * st
            tr, ti = ctr[w], cti[w]
            if real and t == 0:
                br = xr[:, :, q] - xr[:, :, q + dl]
                out = (xr[:, :, q] + xr[:, :, q + dl],
                       np.zeros_like(br), br * tr, br * ti)
            else:
                out = _butterfly(xr[:, :, q], xi[:, :, q], xr[:, :, q + dl],
                                 xi[:, :, q + dl], tr, ti, inverse)
            (xr[:, :, q], xi[:, :, q], xr[:, :, q + dl],
             xi[:, :, q + dl]) = out
    re[:, idx], im[:, idx] = xr, xi


def bracketed(re, im, inverse, real=False):
    """The split of a transform longer than 8192: forward, the bracket
    passes then the inner stages on each 8192-point block; inverse, the
    other way round."""
    re, im = re.copy(), im.copy()
    rows, n = re.shape
    plan = fused.bracket_plan(n, inverse)

    def inner(r, i):
        r, i = stage_by_stage(r.reshape(-1, B), i.reshape(-1, B), inverse)
        return r.reshape(rows, n), i.reshape(rows, n)

    if inverse:
        re, im = inner(re, im)
    for p, (k, lst, _) in enumerate(plan):
        bracket_pass(re, im, k, lst, inverse, real=real and p == 0)
    if not inverse:
        re, im = inner(re, im)
    return re, im


def _bits(*arrays):
    return [np.asarray(a, np.float32).view(np.uint32) for a in arrays]


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("n", [16384, 32768])
def test_bracket_equals_stage_by_stage(n, inverse):
    rng = np.random.default_rng(n + inverse)
    re, im = (rng.standard_normal((2, n)).astype(np.float32)
              for _ in range(2))
    got = bracketed(re, im, inverse)
    want = stage_by_stage(re, im, inverse)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [16384, 32768])
def test_bracket_real_first_stage(n):
    """Kernel 8's real row pass: the bracket's first pass takes the real
    first stage, bit for bit the stage-by-stage one."""
    rng = np.random.default_rng(n)
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = np.zeros_like(re)
    got = bracketed(re, im, False, real=True)
    want = stage_by_stage(re, im, False, real=True)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("n", [16384, 32768, 1 << 20, 1 << 26])
def test_bracket_plan_covers_each_point_once(n, inverse):
    """Every pass's groups cover the sequence's points once each, inside
    [0, n), with the twiddle words inside n's compact table; the passes
    take the outer stages in order, at most 6 each."""
    plan = fused.bracket_plan(n, inverse)
    stages = n.bit_length() - 1
    assert sum(k for k, _, _ in plan) == stages - 13
    assert all(1 <= k <= 6 for k, _, _ in plan)
    assert [s0 for _, _, s0 in plan] == list(
        np.cumsum([0] + [k for k, _, _ in plan])[:-1])
    for k, lst, s0 in plan:
        # DIF: the pass's smallest span; DIT: its first.
        assert lst == (13 + s0 if inverse else stages - s0 - k)
        if n > 1 << 20:
            continue  # the index sets below are built for short lengths
        idx, lo = bracket_groups(n, k, lst)
        flat = np.sort(idx.ravel())
        np.testing.assert_array_equal(flat, np.arange(n))
        st = 1 << lst
        top = (st << (k - 1)) - 1 + lo.max() + ((1 << (k - 1)) - 1) * st
        assert top <= n - 2  # the compact table holds n - 1 words


@pytest.mark.parametrize("n", [16384, 32768])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_inner_blocks_read_the_block_tables(n, inverse):
    """The inner engines read n's tables as the tables of 8192: the
    compact words of spans below 8192, and the stage rows' first 8192
    entries."""
    cr, ci = radix2.compact_twiddles(n, inverse)
    br, bi = radix2.compact_twiddles(B, inverse)
    np.testing.assert_array_equal(cr[:B - 1], br)
    np.testing.assert_array_equal(ci[:B - 1], bi)
    fr, fi = radix2._dif_twiddles(n, inverse)
    er, ei = radix2._dif_twiddles(B, inverse)
    # Inverse rows run d = 1, 2, ...: row s of both has span 2^s.
    if inverse:
        np.testing.assert_array_equal(fr[:13, :B], er)
        np.testing.assert_array_equal(fi[:13, :B], ei)
    else:
        off = (n.bit_length() - 1) - 13
        np.testing.assert_array_equal(fr[off:, :B], er)
        np.testing.assert_array_equal(fi[off:, :B], ei)


# -- kernel 2 above m = 64: the combine pass and the 128-point blocks -------


def cs_row(p):
    """colspec_chunk.cu::cs_row: the in-block bit reversal of the
    four-step's 128-point factor."""
    q = p & 127
    rev = np.zeros_like(q)
    for b in range(7):
        rev |= ((q >> b) & 1) << (6 - b)
    return (p & ~127) | rev


def combine_pass(src_re, src_im, m, inverse, hs=None, row0=0):
    """cs_combine_kernel on (rows, wk) planes: per n2 and 32-column tile
    the m points staged at word i 32 + tx (inside the 2 m 32 floats), the
    outputs k of the combine, the four-step twiddle on the spectrum's
    side (forward after, inverse before)."""
    h, wk = m * LANE, src_re.shape[-1]
    fs_re, fs_im = (a[:, 0] for a in fused._fourstep_twiddle(h, False))
    cw_re, cw_im = fused._combine_matrix(m)
    hs = h if hs is None else hs
    out_re = np.zeros((hs if inverse else h, wk), np.float32)
    out_im = np.zeros_like(out_re)
    words = set()
    for n2 in range(LANE):
        for c0 in range(0, wk, 32):
            tx = np.arange(min(32, wk - c0))
            xr = np.zeros((m, 32), np.float32)
            xi = np.zeros((m, 32), np.float32)
            for i in range(m):
                words.add(i * 32 + 31)
                if not inverse:
                    r = i * LANE + n2 - row0
                    if 0 <= r < src_re.shape[0]:
                        xr[i, tx] = src_re[r, c0 + tx]
                        xi[i, tx] = src_im[r, c0 + tx]
                else:
                    p = i * LANE + n2
                    zr, zi = src_re[p, c0 + tx], src_im[p, c0 + tx]
                    tr, ti = fs_re[p], -fs_im[p]
                    xr[i, tx] = zr * tr - zi * ti
                    xi[i, tx] = zr * ti + zi * tr
            for k in range(m):
                wr = cw_re[k]
                wi = -cw_im[k] if inverse else cw_im[k]
                sr = (xr * wr[:, None] - xi * wi[:, None]).sum(0)
                si = (xr * wi[:, None] + xi * wr[:, None]).sum(0)
                if not inverse:
                    p = k * LANE + n2
                    tr, ti = fs_re[p], fs_im[p]
                    out_re[p, c0 + tx] = (sr * tr - si * ti)[tx]
                    out_im[p, c0 + tx] = (sr * ti + si * tr)[tx]
                else:
                    r = k * LANE + n2 - row0
                    if 0 <= r < hs:
                        out_re[r, c0 + tx] = sr[tx]
                        out_im[r, c0 + tx] = si[tx]
    assert max(words) < m * 32  # each plane's staged words stay inside
    return out_re, out_im


def blocks_128(re, im, inverse):
    """The 128-point radix-2 of each of the column's m blocks (down the
    rows: the chunk kernels' in-block passes, bit for bit the
    stage-by-stage transform)."""
    h, wk = re.shape
    r = re.T.reshape(wk * h // LANE, LANE)
    i = im.T.reshape(wk * h // LANE, LANE)
    r, i = stage_by_stage(r, i, inverse)
    return (np.ascontiguousarray(r.reshape(wk, h).T),
            np.ascontiguousarray(i.reshape(wk, h).T))


@pytest.mark.parametrize("m", [65, 67, 68])
def test_combine_pass_four_step_vs_numpy(m):
    h, wk, hc, row0 = m * LANE, 40, m * LANE - 200, 96
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((hc, wk))
         + 1j * rng.standard_normal((hc, wk))).astype(np.complex64)
    # Forward: the combine pass (the zero embed), the 128-point DIF of
    # every block, rows out in the fourstep layout.
    cr, ci = combine_pass(x.real.copy(), x.imag.copy(), m, False, row0=row0)
    cr, ci = blocks_128(cr, ci, False)
    spec = np.empty((h, wk), np.complex64)
    spec[cs_row(np.arange(h))] = cr + 1j * ci
    col = np.zeros((h, wk), np.complex128)
    col[row0:row0 + hc] = x
    want = np.fft.fft(col, axis=0)[fused._col_order(h)]
    assert np.abs(spec - want).max() / np.abs(want).max() < 1e-5
    # Inverse: the rows back from the fourstep layout through the
    # 128-point DIT of every block, then the conjugate combine pass.
    sr = np.ascontiguousarray(spec.real[cs_row(np.arange(h))])
    si = np.ascontiguousarray(spec.imag[cs_row(np.arange(h))])
    sr, si = blocks_128(sr, si, True)
    r0, hr = 64, h - 128
    got_r, got_i = combine_pass(sr, si, m, True, hs=hr, row0=r0)
    back = np.fft.ifft(want[np.argsort(fused._col_order(h))], axis=0) * h
    ref = back[r0:r0 + hr]
    got = got_r + 1j * got_i
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


# -- the planners at every padded size to 32768 -----------------------------

_PADS = list(range(LANE, 32768 + 1, LANE))


def test_planners_every_size():
    for h in _PADS:
        pow2 = h & (h - 1) == 0
        m = h // LANE
        s = fused.colspec_strip(h)
        # The rows a block of kernel 2 holds: the column up to 8192 (pow-2)
        # or m = 63, else an 8192-row block or a chunk of 32 blocks.
        held = min(h, B) if pow2 else (h if m < 64 else 32 * LANE)
        assert 2 * held * s * 4 <= _SMEM, h
        assert fused.colspec_big(h) == (h > B if pow2 else m > 64)
        inner = min(h, B)
        k12 = fused.col_strip(inner)
        assert 4 * inner * k12 * 4 <= _SMEM, h
        if pow2:
            plan = fused.bracket_plan(h, False)
            assert bool(plan) == (h > B)
            w = hermitian_kept_width(h) if h >= 512 else h
            k6 = fused.phase_col_strip(h, w)
            assert w % k6 == 0 and k6 >= k12
            assert 2 * inner * k6 * 4 <= _SMEM
        # The kept lanes of a padded width h divide by every strip.
        if pow2 and h >= 512:
            kept = hermitian_kept_width(h)
            assert kept % s == 0 and kept % k12 == 0


@pytest.mark.parametrize("w", [2048, 8192, 16384, 32768])
def test_kept_tiles_above_8192(w):
    """The kept half: w / 256 + 1 tiles (65 at 16384, 129 at 32768), the
    device table of kernels 1 and 4 holds each tile's kept position."""
    tiles = fused.kept_tiles(w)
    assert len(tiles) == w // 256 + 1
    (pos,) = fused.kept_positions(w, tuple(tiles))
    assert pos.shape == (w // LANE,) and pos.dtype == np.int32
    assert sorted(pos[pos >= 0]) == list(range(len(tiles)))
    src, rev = fused.lane_plan_tables(hermitian_kept_width(w), w)
    assert src.shape == rev.shape == (w // LANE,)
    assert src.max() < len(tiles)


@pytest.mark.parametrize("radius", [0, 2, 5, 13])
def test_kernel3_route_above_8192_lanes(radius):
    """Kernel 3 keeps a whole row in one block: above 8192 lanes the
    y_only tail takes kernels 7 + 10, and the predicates answer without
    raising."""
    for pad_w in (8192, 16384, 32768):
        rows = post_fused.kernel3_rows(radius, pad_w)
        if pad_w > B:
            assert rows == 0
            assert not post_fused.kernel3_serves(radius, pad_w)
            assert not post_fused.kernel3_serves(radius, pad_w, 15360)
        else:
            assert rows >= 0
