"""Kernel 2's frame-parallel schedule (`pbmm_tpu_torch/csrc/colspec_chunk.cu`
on `csrc/col_pass.cuh`'s in-block passes), checked on the CPU.

- The frame-parallel form (every frame's forward spectrum first, then each
  frame's phase pass against the unmodified spectrum of the frame before
  it) equals the frame-serial `colspec_chunk_ref` bit for bit on every
  branch but the IIR taps, at a pow-2 and a four-step height, one plane
  and three; and the IIR branch's three launches (every forward spectrum,
  the per-bin tap scan over the frames in order, every inverse) equal it
  bit for bit, rows, state and taps, y_only and rgb, pow-2 and tight.
- The strip planners at every padded height above 4096 (pow-2 8192 and
  tight m = 33-64): each strip's shared memory fits 227 KB and each
  width divides 4320p's kept lanes, and the heights above take device
  memory (`colspec_big`, `bracket_plan`); the in-block passes on strips of 2
  (H = 8192, m = 34 and 64) equal the stage-by-stage radix-2 bit for
  bit.
- The in-block plans (`pbmm_cb_k`, the passes' strides) and a numpy-f32
  model of the passes (groups {base + q st} of each (group, column) task,
  the compact twiddle words, `row_pass.cuh`'s butterflies, each product
  and sum rounded on its own) equal the stage-by-stage radix-2
  (`common.cuh::pbmm_radix2`) bit for bit at every height, forward and
  inverse, on one sequence (pow-2 heights) and on m stacked 128-point
  sequences (the four-step factor).
- Kernel 12's stage ranges (`csrc/kdecomp.cu`: gm [0, 7), rolls [7,
  log2 H), both, none) on the same passes at H = 256 to 8192: bit for
  bit the stage-by-stage radix-2 restricted to those stages, every warp
  access on 32 distinct banks at the strips of 2 to 16 kernel 6 takes.
- The strip's shared-memory layout (`pbmm_cb_swz`): one-to-one, point q of
  a group at the group's word XOR a constant, and every access of a warp
  (the passes, the phase loop, the m-point loops) on 32 distinct banks.
- The phase strip's asynchronous copies (`csrc/phase_inv.cuh`): the
  host's mirror of the ring's rule (`fused.phase_strip_smem`,
  `colspec_staged`) against the C rule's table at each height class and
  its constants in the header, and every quarter warp's 16-byte strip
  words on 32 distinct banks.
- The model of the whole schedule (the m-point DFT with the combine
  matrix, the four-step twiddle, the passes, the phase pass, the inverse)
  against the JAX kernel in interpret mode at H = 256 (pow-2) and 384
  (m = 3), T = 4, Wk = 128 and 256, max error / max magnitude < 1e-4 (the
  bar of tests/test_torch_branches.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.config import TemporalConfig
from pbmm_tpu_torch.spectral import fused, radix2

KMAX = 4  # PBMM_RP_KMAX
LANE = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_highest_traces():
    """Drop the JAX traces made at gm_precision "highest" when the module
    ends, so later tests of the process trace the default anew."""
    yield
    set_gm_precision("")
    jax.clear_caches()


# -- the plans and the layout (col_pass.cuh's in-block form) ---------------


def cb_plan(nlog, inverse, stages=None):
    """[(k, lst)] of each pass of the stages [sb, se) of a 2^nlog transform
    (`stages`; all of them by default): `pbmm_cb_k` (an even split, the
    longer first) and the pass's stride."""
    sb, se = stages or (0, nlog)
    count = se - sb
    np_ = -(-count // KMAX)
    ks = [count // np_ + (1 if i < count % np_ else 0) for i in range(np_)]
    out, s0 = [], sb
    for k in ks:
        out.append((k, s0 if inverse else nlog - s0 - k))
        s0 += k
    return out


def swz(p, s):
    """`pbmm_cb_swz<S>`: the low B = log2(32 / S) bits of p XOR the XOR of
    its higher B-bit digits."""
    b = 5 - (s.bit_length() - 1)
    f = np.zeros_like(p)
    for sh in range(b, 15, b):
        f ^= p >> sh
    return p ^ (f & ((1 << b) - 1))


def idx(p, c, s):
    """`pbmm_cb_idx<S>`: the shared-memory word of (row p, column c)."""
    return (swz(p, s) << (s.bit_length() - 1)) | c


def tasks(nlog, nseq, s, k, lst):
    """(column, base, lo) of every task e of a pass (`PbmmCbGroup`)."""
    e = np.arange((nseq << (nlog - k)) * s)
    c = e & (s - 1)
    g = e >> (s.bit_length() - 1)
    gl = g & ((1 << (nlog - k)) - 1)
    lo = gl & ((1 << lst) - 1)
    base = ((g >> (nlog - k)) << nlog) | ((gl >> lst) << (lst + k)) | lo
    return c, base, lo


def _butterfly(xr, xi, ur, ui, tr, ti, inverse):
    if not inverse:
        br, bi = xr - ur, xi - ui
        return (xr + ur, xi + ui, br * tr - bi * ti, br * ti + bi * tr)
    zr, zi = ur * tr - ui * ti, ur * ti + ui * tr
    return xr + zr, xi + zi, xr - zr, xi - zi


def stage_by_stage(re, im, nlog, inverse, stages=None):
    """`pbmm_radix2` on (cols, nseq 2^nlog) f32, each 2^nlog sequence on
    its own: every stage (or those of the range `stages`) over the whole
    sequence, the twiddle of the bottom element from row s of
    `_dif_twiddles`."""
    n = 1 << nlog
    tw_re, tw_im = radix2._dif_twiddles(n, inverse)
    re, im = re.copy(), im.copy()
    k = np.arange(re.shape[-1] // 2)
    for s in range(*(stages or (0, nlog))):
        d = 1 << s if inverse else n >> (s + 1)
        kk = k % (n // 2)
        j = kk & (d - 1)
        i0 = (k // (n // 2)) * n + ((kk - j) << 1) + j
        i1 = i0 + d
        re[:, i0], im[:, i0], re[:, i1], im[:, i1] = _butterfly(
            re[:, i0], im[:, i0], re[:, i1], im[:, i1], tw_re[s, i1 % n],
            tw_im[s, i1 % n], inverse)
    return re, im


def cb_passes(re, im, nlog, inverse, stages=None):
    """The in-block schedule on (cols, nseq 2^nlog) f32: per pass (of the
    stage range `stages`, all by default), each group's points gathered,
    the pass's stages run on them with the compact twiddle words,
    scattered back."""
    cre, cim = radix2.compact_twiddles(1 << nlog, inverse)
    re, im = re.copy(), im.copy()
    nseq = re.shape[-1] >> nlog
    if stages is not None and stages[0] == stages[1]:
        return re, im  # no stage: kernel 12's strip rows out as they are
    for k, lst in cb_plan(nlog, inverse, stages):
        st, L = 1 << lst, 1 << k
        c, base, lo = tasks(nlog, nseq, 1, k, lst)
        pos = base[:, None] + np.arange(L)[None, :] * st
        xr, xi = re[:, pos], im[:, pos]  # (cols, groups, L)
        for t in range(k):
            tt = t if inverse else k - 1 - t
            dl = 1 << tt
            for q in range(L):
                if q & dl:
                    continue
                w = (st << tt) - 1 + lo + (q & (dl - 1)) * st
                (xr[..., q], xi[..., q], xr[..., q + dl],
                 xi[..., q + dl]) = _butterfly(
                    xr[..., q], xi[..., q], xr[..., q + dl], xi[..., q + dl],
                    cre[w], cim[w], inverse)
        re[:, pos], im[:, pos] = xr, xi
    return re, im


def _bits(*arrays):
    return [np.ascontiguousarray(a, np.float32).view(np.uint32)
            for a in arrays]


# (nlog, nseq, S): every pow-2 height the kernel takes, and the four-step
# factor at m = 1, 3, 9 (1080p), 14, 17 (2160p), 28 and 32, each on its
# strip (`fused.colspec_strip`).
_POW2 = [(nlog, 1, fused.colspec_strip(1 << nlog)) for nlog in range(1, 13)]
_TIGHT = [(7, m, fused.colspec_strip(m * LANE))
          for m in (1, 3, 9, 14, 17, 28, 32)]


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("nlog,nseq,s", _POW2 + _TIGHT,
                         ids=[f"n{1 << a}x{b}" for a, b, _ in _POW2 + _TIGHT])
def test_in_block_passes_match_stage_by_stage(nlog, nseq, s, inverse):
    plan = cb_plan(nlog, inverse)
    assert sum(k for k, _ in plan) == nlog
    assert all(1 <= k <= KMAX for k, _ in plan)
    # No stride between 1 and the bank sweep 2^B: the warp's rows then
    # differ in bits 0 .. B - 1 (st >= 2^B) or K .. K + B - 1 (st = 1).
    b = 5 - (s.bit_length() - 1)
    if nlog >= 5:
        assert all(lst == 0 or lst >= b for _, lst in plan), plan
    rng = np.random.default_rng(nlog * 64 + nseq + inverse)
    n = nseq << nlog
    re, im = (rng.standard_normal((3, n)).astype(np.float32)
              for _ in range(2))
    im[0] = 0.0  # a real column: no shortcut taken
    want = stage_by_stage(re, im, nlog, inverse)
    got = cb_passes(re, im, nlog, inverse)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    # And each sequence is the DFT: bit-reversed out (DIF) or in (DIT).
    rev = radix2.bit_reverse_permutation(1 << nlog) if nlog else [0]
    x = (re.astype(np.float64) + 1j * im).reshape(3, nseq, 1 << nlog)
    ref = (np.fft.fft(x)[..., rev] if not inverse
           else np.fft.ifft(x[..., rev], norm="forward"))
    z = (got[0] + 1j * got[1].astype(np.float64)).reshape(ref.shape)
    assert np.abs(z - ref).max() < 1e-5 * np.abs(ref).max()


def _warps_conflict_free(words):
    """Each warp of 32 consecutive tasks on 32 distinct banks."""
    words = np.asarray(words)
    for w0 in range(0, len(words), 32):
        banks = words[w0:w0 + 32] % 32
        if len(np.unique(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("nlog,nseq,s", [c for c in _POW2 if c[0] >= 7]
                         + _TIGHT)
def test_strip_layout_offsets_and_banks(nlog, nseq, s, inverse):
    n = nseq << nlog
    p = np.arange(n)
    words = idx(p[:, None], np.arange(s)[None, :], s).reshape(-1)
    assert sorted(words) == list(range(n * s))  # one-to-one into n S words
    ls = s.bit_length() - 1
    for k, lst in cb_plan(nlog, inverse):
        c, base, _ = tasks(nlog, nseq, s, k, lst)
        w0 = idx(base, c, s)
        for q in range(1 << k):
            at = w0 ^ (swz(np.array(q << lst), s) << ls)
            np.testing.assert_array_equal(at, idx(base + q * (1 << lst), c,
                                                  s))
            assert _warps_conflict_free(at), (k, lst, q)
    # The phase loop (task e -> row e >> log2 S, column e mod S) and, at
    # tight heights, the m-point loops (rows k1 128 + n2).
    e = np.arange(n * s)
    assert _warps_conflict_free(idx(e >> ls, e & (s - 1), s))
    if nlog == 7:
        e = np.arange(LANE * s)
        for k1 in range(nseq):
            assert _warps_conflict_free(
                idx(k1 * LANE + (e >> ls), e & (s - 1), s))


# -- kernel 12's stage ranges (csrc/kdecomp.cu on the in-block passes) -------

_KD_PIECES = {"none": (), "gm": ("gm",), "rolls": ("rolls",),
              "both": ("gm", "rolls")}


def kd_stages(nlog, pieces):
    """Kernel 12's stage range of the pieces gm (span < 128) and rolls
    (span >= 128) at H = 2^nlog (`kdecomp.cu::kd_stages`): both, or gm
    where rolls has no stage, the whole inverse; no stage an empty
    range."""
    g = min(nlog, 7)
    gm, rolls = "gm" in pieces, "rolls" in pieces
    if gm and (rolls or g == nlog):
        return 0, nlog
    if gm:
        return 0, g
    if rolls and g < nlog:
        return g, nlog
    return g, g


def _kd_strips(nlog):
    """The strips of 2 to 16 columns kernel 12 takes at H = 2^nlog, as
    kernel 6 (`phase_col_strip`'s candidates: kernel 2's strip, its half
    and `col_strip`)."""
    h = 1 << nlog
    s2 = fused.colspec_strip(h)
    return sorted({s for s in (s2, s2 // 2, fused.col_strip(h))
                   if 2 <= s <= 16})


_KD_NLOG = range(8, 14)


@pytest.mark.parametrize("pieces", sorted(_KD_PIECES))
@pytest.mark.parametrize("nlog", _KD_NLOG, ids=[f"n{1 << n}" for n in
                                                _KD_NLOG])
def test_stage_range_passes_match_stage_by_stage(nlog, pieces):
    """Kernel 12's partial inverses: the in-block passes over the stage
    range of a piece set equal the stage-by-stage radix-2 restricted to
    the same stages (`kdecomp.py::_inverse_stages_ref`'s choice of them),
    bit for bit; both pieces are kernel 6's whole plan."""
    sb, se = kd_stages(nlog, _KD_PIECES[pieces])
    want_stages = [s for s in range(nlog)
                   if (s < 7 and "gm" in _KD_PIECES[pieces])
                   or (s >= 7 and "rolls" in _KD_PIECES[pieces])]
    assert list(range(sb, se)) == want_stages
    if pieces == "both":
        assert cb_plan(nlog, True, (sb, se)) == cb_plan(nlog, True)
    plan = cb_plan(nlog, True, (sb, se)) if se > sb else []
    assert sum(k for k, _ in plan) == se - sb
    assert all(1 <= k <= KMAX for k, _ in plan)
    rng = np.random.default_rng(nlog * 8 + len(pieces))
    re, im = (rng.standard_normal((3, 1 << nlog)).astype(np.float32)
              for _ in range(2))
    want = stage_by_stage(re, im, nlog, True, (sb, se))
    got = cb_passes(re, im, nlog, True, (sb, se))
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    if pieces == "none":
        np.testing.assert_array_equal(got[0], re)


@pytest.mark.parametrize("pieces", sorted(_KD_PIECES))
@pytest.mark.parametrize("nlog,s", [(n, s) for n in _KD_NLOG
                                    for s in _kd_strips(n)])
def test_stage_range_plans_banks(nlog, s, pieces):
    """Every warp access of kernel 12's range plans on 32 distinct banks:
    each pass's strides stay 1 or at least the bank sweep 2^B, and point
    q of a group lies at the group's word XOR a constant; with no stage,
    the rows written out from the strip (from the aligned run of 32 / S
    rows that holds r0, an odd r0 here)."""
    sb, se = kd_stages(nlog, _KD_PIECES[pieces])
    b = 5 - (s.bit_length() - 1)
    ls = s.bit_length() - 1
    if se == sb:
        n = 1 << nlog
        r0, r1 = n // 8 + 3, n - n // 8
        ra = r0 & ~((32 >> ls) - 1)
        e = np.arange((r1 - ra) * s)
        p, c = ra + (e >> ls), e & (s - 1)
        assert _warps_conflict_free(idx(p, c, s))
        keep = p >= r0  # every row of [r0, r1) once
        assert sorted(p[keep] * s + c[keep]) == list(range(r0 * s, r1 * s))
        return
    plan = cb_plan(nlog, True, (sb, se))
    assert all(lst == 0 or lst >= b for _, lst in plan), plan
    for k, lst in plan:
        c, base, _ = tasks(nlog, 1, s, k, lst)
        w0 = idx(base, c, s)
        for q in range(1 << k):
            at = w0 ^ (swz(np.array(q << lst), s) << ls)
            np.testing.assert_array_equal(at, idx(base + q * (1 << lst), c,
                                                  s))
            assert _warps_conflict_free(at), (k, lst, q)


# -- the frame-parallel form against the frame-serial plain version ---------

_BRANCHES = {
    "main": dict(),
    "rgb": dict(chroma="rgb"),
    "standard": dict(mode="standard"),
    "steerable": dict(orientations=4),
    "overlapping": dict(pyramid_levels=6, orientations=3),
    "non_integer": dict(phase_scale=2.5),
}


def _spectra(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    a[..., :8, :] = 0.0
    a[..., 8:16, :] = -0.0
    return torch.from_numpy(a)


def frame_parallel(rows_re, rows_im, prev_re, prev_im, cfg, pad_h, row0,
                   out_rows, full_w, planes):
    """`colspec_chunk` as the CUDA kernel schedules it, in torch: the
    forward spectra of all frames (launch 1), then each frame's phase pass
    against frame n - planes's spectrum, or the carried state, and the
    inverse (launch 2); new_prev is the last frame's spectrum."""
    n, _, w = rows_re.shape
    r0, r1 = out_rows
    order = torch.as_tensor(fused._col_order(pad_h))
    spec = [fused._col_fft_ref(rows_re[f], rows_im[f], pad_h, row0, order)
            for f in range(n)]
    host = fused._static_phase_planes(cfg, pad_h, w, full_w)
    host = None if host is None else tuple(map(torch.from_numpy, host))
    fy, fx = map(torch.from_numpy, fused._freq_tables(pad_h, w, full_w))
    outs = []
    for f in range(n):
        cr, ci = spec[f].real, spec[f].imag
        pr, pi_ = ((spec[f - planes].real, spec[f - planes].imag)
                   if f >= planes else (prev_re[f], prev_im[f]))
        res = fused._phase_block_ref(cr, ci, pr, pi_, fy, fx, cfg,
                                     static_planes=host)
        nat = torch.empty_like(spec[f])
        nat[order] = torch.complex(res[0], res[1])
        outs.append(torch.fft.ifft(nat, dim=0, norm="forward")[r0:r1])
    z = torch.stack(outs)
    last = spec[n - planes:]
    return (z.real, z.imag, torch.stack([s.real for s in last]),
            torch.stack([s.imag for s in last]))


@pytest.mark.parametrize("pad_h", [512, 384])
@pytest.mark.parametrize("name", sorted(_BRANCHES))
def test_frame_parallel_equals_frame_serial(name, pad_h):
    cfg = TCfg(phase_scale=10.0).tuned_for_tpu().replace(**_BRANCHES[name])
    planes = 3 if cfg.chroma == "rgb" else 1
    w, hc, row0, rows, t = 512, 256, 64, (64, 320), 3
    wk = fused.hermitian_kept_width(w)
    rng = np.random.default_rng(40)
    args = [_spectra(rng, (t * planes, hc, wk)) for _ in range(2)]
    args += [_spectra(rng, (planes, pad_h, wk)) for _ in range(2)]
    want = fused.colspec_chunk_ref(*args, cfg, pad_h, row0, out_rows=rows,
                                   full_w=w, planes=planes)
    got = frame_parallel(*args, cfg, pad_h, row0, rows, w, planes)
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        assert g.shape == x.shape
        assert torch.equal(g, x)


def iir_three_launches(rows_re, rows_im, prev_re, prev_im, cfg, pad_h, row0,
                       lp_fast, lp_slow, out_rows, full_w, planes):
    """The IIR branch as the CUDA kernel schedules it, in torch: the
    forward spectra of all frames (launch 1), then the tap scan (for each
    bin of each plane, the frames in order: the phase pass against the
    previous frame's unmodified spectrum, which stays in registers, the
    taps carried, the rotated bin written over the frame's scratch slot;
    torch runs the bins of a plane at once, each bin's arithmetic alone),
    then the inverse of every rotated spectrum (launch 2, no phase pass);
    new_prev and the taps are what the scan holds at its end."""
    n, _, w = rows_re.shape
    r0, r1 = out_rows
    order = torch.as_tensor(fused._col_order(pad_h))
    spec = [fused._col_fft_ref(rows_re[f], rows_im[f], pad_h, row0, order)
            for f in range(n)]
    host = fused._static_phase_planes(cfg, pad_h, w, full_w)
    host = None if host is None else tuple(map(torch.from_numpy, host))
    fy, fx = map(torch.from_numpy, fused._freq_tables(pad_h, w, full_w))
    rotated = [None] * n
    state = []
    for c in range(planes):
        pr, pi_, lf, ls = prev_re[c], prev_im[c], lp_fast[c], lp_slow[c]
        for f in range(c, n, planes):
            cr, ci = spec[f].real, spec[f].imag
            o_r, o_i, lf, ls = fused._phase_block_ref(
                cr, ci, pr, pi_, fy, fx, cfg, lf, ls, static_planes=host)
            rotated[f] = torch.complex(o_r, o_i)
            pr, pi_ = cr, ci
        state.append((pr, pi_, lf, ls))
    outs = []
    for f in range(n):
        nat = torch.empty_like(rotated[f])
        nat[order] = rotated[f]
        outs.append(torch.fft.ifft(nat, dim=0, norm="forward")[r0:r1])
    z = torch.stack(outs)
    return (z.real, z.imag) + tuple(torch.stack(x) for x in zip(*state))


_IIR = {"y_only": dict(), "rgb": dict(chroma="rgb"),
        "standard": dict(mode="standard")}


@pytest.mark.parametrize("pad_h", [512, 384])
@pytest.mark.parametrize("name", sorted(_IIR))
def test_iir_three_launches_equal_frame_serial(name, pad_h):
    cfg = TCfg(phase_scale=10.0).tuned_for_tpu().replace(
        temporal=TemporalConfig(mode="iir_bandpass"), **_IIR[name])
    planes = 3 if cfg.chroma == "rgb" else 1
    w, hc, row0, rows, t = 512, 256, 64, (64, 320), 4
    wk = fused.hermitian_kept_width(w)
    rng = np.random.default_rng(41)
    args = [_spectra(rng, (t * planes, hc, wk)) for _ in range(2)]
    args += [_spectra(rng, (planes, pad_h, wk)) for _ in range(2)]
    taps = [0.1 * _spectra(rng, (planes, pad_h, wk)) for _ in range(2)]
    want = fused.colspec_chunk_ref(*args, cfg, pad_h, row0, *taps,
                                   out_rows=rows, full_w=w, planes=planes)
    got = iir_three_launches(*args, cfg, pad_h, row0, *taps, rows, w,
                             planes)
    assert len(got) == len(want) == 6
    for g, x in zip(got, want):
        assert g.shape == x.shape
        assert torch.equal(g, x)


# -- the strips of the heights above 4096 (4320p) -----------------------------

_SMEM = 232448  # a block's shared memory on the H100 (227 KB)
_TALL = [8192] + [m * LANE for m in range(33, 65)]


@pytest.mark.parametrize("h", _TALL)
def test_tall_strips_fit_and_divide(h):
    """Kernel 2's strip (2 h S f32) and kernel 6's and kernel 12's (the
    same, or a half down to `col_strip`, where even 4 h S f32 fit) fit a
    block's shared memory at every padded height above 4096 up to 8192,
    pow-2 and tight m = 33-64; each divides 4320p's kept lanes (8192 padded
    lanes, 4224 kept); kernel 2's is 2 columns there (256-thread blocks at
    m > 32), `col_strip` 1."""
    s = fused.colspec_strip(h)
    assert s == 2
    assert 2 * h * s * 4 <= _SMEM  # the strip's two planes, f32
    assert 4 * h * fused.col_strip(h) * 4 <= _SMEM and fused.col_strip(h) == 1
    kept = fused.hermitian_kept_width(8192)
    assert kept == 4224
    for strip in (s, fused.col_strip(h)):
        assert kept % strip == 0
    if fused._is_pow2(h):
        k6 = fused.phase_col_strip(h, kept)
        assert k6 == s and kept % k6 == 0
        assert fused.phase_col_strip(h, kept + 1) == 1
    else:
        assert h // LANE > fused._COMBINE_MAX_PARAM
    # These heights fit a block's strip; the next ones up take device
    # memory: pow-2 columns above 8192 the bracket on 8192-row blocks (one
    # pass of 1 stage at 16384), tight ones above m = 64 the combine pass.
    assert not fused.colspec_big(h) and fused.bracket_plan(8192, False) == ()
    assert fused.colspec_big(16384) and fused.colspec_big(65 * LANE)
    assert fused.bracket_plan(16384, False) == ((1, 13, 0),)
    assert fused.colspec_strip(16384) == 2 == fused.phase_col_strip(
        16384, fused.hermitian_kept_width(16384))


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("nlog,nseq", [(13, 1), (7, 34), (7, 64)],
                         ids=["n8192", "n128x34", "n128x64"])
def test_in_block_passes_on_strips_of_2(nlog, nseq, inverse):
    """The in-block passes of the heights above 4096 (H = 8192 and the
    four-step factor at m = 34 and 64, strips of 2) equal the
    stage-by-stage radix-2 bit for bit, and their shared-memory words stay
    one-to-one with point q of a group at the group's word XOR a
    constant."""
    s = fused.colspec_strip(nseq << nlog)
    rng = np.random.default_rng(nlog * 64 + nseq + inverse)
    n = nseq << nlog
    re, im = (rng.standard_normal((2, n)).astype(np.float32)
              for _ in range(2))
    want = stage_by_stage(re, im, nlog, inverse)
    got = cb_passes(re, im, nlog, inverse)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    p = np.arange(n)
    words = idx(p[:, None], np.arange(s)[None, :], s).reshape(-1)
    assert sorted(words) == list(range(n * s))
    ls = s.bit_length() - 1
    for k, lst in cb_plan(nlog, inverse):
        c, base, _ = tasks(nlog, nseq, s, k, lst)
        w0 = idx(base, c, s)
        for q in range(1 << k):
            np.testing.assert_array_equal(
                w0 ^ (swz(np.array(q << lst), s) << ls),
                idx(base + q * (1 << lst), c, s))


# -- the whole schedule against the JAX kernel -------------------------------


def _cs_row(p, pow2):
    """`cs_row`: the JAX row of block row p."""
    if pow2:
        return p
    return (p & ~127) | radix2.bit_reverse_permutation(LANE)[p & 127]


def _f32_sum(terms):
    """sr += term, in f32, in order (the kernel's accumulation)."""
    acc = np.zeros_like(terms[0])
    for x in terms:
        acc = (acc + x).astype(np.float32)
    return acc


def model_forward(re, im, pad_h, row0):
    """Launch 1 on one frame's (Hc, W) content rows: the zero-embed, then
    the DIF passes (pow-2) or the m-point DFT, the four-step twiddle and
    the 128-point DIF passes (tight); (W, H) in the JAX row order."""
    w = re.shape[1]
    xr = np.zeros((w, pad_h), np.float32)
    xi = np.zeros((w, pad_h), np.float32)
    xr[:, row0:row0 + re.shape[0]] = re.T
    xi[:, row0:row0 + re.shape[0]] = im.T
    pow2 = fused._is_pow2(pad_h)
    if pow2:
        zr, zi = cb_passes(xr, xi, pad_h.bit_length() - 1, False)
    else:
        m = pad_h // LANE
        cwr, cwi = fused._combine_matrix(m)
        fsr, fsi = (a[:, 0] for a in fused._fourstep_twiddle(pad_h, False))
        ar = xr.reshape(w, m, LANE)
        ai = xi.reshape(w, m, LANE)
        br = np.empty_like(ar)
        bi = np.empty_like(ai)
        for k1 in range(m):
            sr = _f32_sum([ar[:, n1] * cwr[k1, n1] - ai[:, n1] * cwi[k1, n1]
                           for n1 in range(m)])
            si = _f32_sum([ar[:, n1] * cwi[k1, n1] + ai[:, n1] * cwr[k1, n1]
                           for n1 in range(m)])
            tr, ti = fsr[k1 * LANE:(k1 + 1) * LANE], fsi[k1 * LANE:
                                                        (k1 + 1) * LANE]
            br[:, k1] = sr * tr - si * ti
            bi[:, k1] = sr * ti + si * tr
        zr, zi = cb_passes(br.reshape(w, -1), bi.reshape(w, -1), 7, False)
    rows = _cs_row(np.arange(pad_h), pow2)
    outr, outi = np.empty_like(zr), np.empty_like(zi)
    outr[:, rows], outi[:, rows] = zr, zi
    return outr, outi


def model_inverse(zr, zi, pad_h):
    """Launch 2's inverse on one frame's (W, H) modified spectrum in the
    JAX row order: the DIT passes (pow-2), or the 128-point DIT passes,
    the conjugate twiddle and the conjugate m-point combine (tight);
    natural rows out."""
    pow2 = fused._is_pow2(pad_h)
    rows = _cs_row(np.arange(pad_h), pow2)
    xr, xi = zr[:, rows], zi[:, rows]  # block order
    if pow2:
        return cb_passes(xr, xi, pad_h.bit_length() - 1, True)
    m = pad_h // LANE
    w = zr.shape[0]
    xr, xi = cb_passes(xr, xi, 7, True)
    cwr, cwi = fused._combine_matrix(m)
    fsr, fsi = (a[:, 0] for a in fused._fourstep_twiddle(pad_h, False))
    ar, ai = xr.reshape(w, m, LANE), xi.reshape(w, m, LANE)
    tr, ti = fsr.reshape(m, LANE), -fsi.reshape(m, LANE)
    ur, ui = ar * tr - ai * ti, ar * ti + ai * tr
    out_r, out_i = np.empty_like(ar), np.empty_like(ai)
    for n1 in range(m):
        out_r[:, n1] = _f32_sum([ur[:, k1] * cwr[n1, k1]
                                 - ui[:, k1] * -cwi[n1, k1]
                                 for k1 in range(m)])
        out_i[:, n1] = _f32_sum([ur[:, k1] * -cwi[n1, k1]
                                 + ui[:, k1] * cwr[n1, k1]
                                 for k1 in range(m)])
    return out_r.reshape(w, -1), out_i.reshape(w, -1)


def model_chunk(rows_re, rows_im, prev_re, prev_im, cfg, pad_h, row0,
                out_rows):
    """The kernel's schedule on one plane: every forward spectrum first,
    then each frame's phase pass (the port's `_phase_block_ref`) against
    the frame before it, and the inverse."""
    n, _, w = rows_re.shape
    r0, r1 = out_rows
    spec = [model_forward(rows_re[f], rows_im[f], pad_h, row0)
            for f in range(n)]
    host = fused._static_phase_planes(cfg, pad_h, w, None)
    host = None if host is None else tuple(map(torch.from_numpy, host))
    fy, fx = map(torch.from_numpy, fused._freq_tables(pad_h, w, None))
    outs = []
    for f in range(n):
        cur = spec[f]
        prv = spec[f - 1] if f else (prev_re[0].T, prev_im[0].T)
        res = fused._phase_block_ref(
            *(torch.from_numpy(np.ascontiguousarray(a.T))
              for a in cur + tuple(prv)), fy, fx, cfg, static_planes=host)
        zr, zi = model_inverse(res[0].numpy().T, res[1].numpy().T, pad_h)
        outs.append((zr.T[r0:r1], zi.T[r0:r1]))
    return (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]),
            spec[-1][0].T[None], spec[-1][1].T[None])


@pytest.mark.parametrize("wk", [128, 256])
@pytest.mark.parametrize("pad_h", [256, 384])
def test_schedule_model_matches_jax(pad_h, wk):
    t, hc, row0, rows = 4, 192, 32, (32, 224)
    rng = np.random.default_rng(pad_h + wk)
    args = [rng.standard_normal((t, hc, wk)).astype(np.float32)
            for _ in range(2)]
    args += [rng.standard_normal((1, pad_h, wk)).astype(np.float32)
             for _ in range(2)]
    jc = JCfg(phase_scale=10.0).tuned_for_tpu()
    tc = TCfg(phase_scale=10.0).tuned_for_tpu()
    set_gm_precision("highest")
    try:
        want = jfused.colspec_chunk(
            *map(jnp.asarray, args), jc.replace(gm_precision="highest"),
            pad_h=pad_h, row0=row0, out_rows=rows, interpret=True)
    finally:
        set_gm_precision("")
    got = model_chunk(*args, tc, pad_h, row0, rows)
    for k in range(0, 4, 2):
        w = np.asarray(want[k]) + 1j * np.asarray(want[k + 1])
        g = got[k] + 1j * got[k + 1].astype(np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-4 * np.abs(w).max()


# -- the phase strip's asynchronous copies (csrc/phase_inv.cuh) -------------

_PHASE_INV = (Path(fused.__file__).resolve().parent.parent / "csrc"
              / "phase_inv.cuh")

# The C rule (csrc/phase_inv.cuh::pbmm_ps_smem, 512 threads a block) at
# each height class of kernel 2's launch 2: (rows a block holds, strip,
# ring slots on the main branch (prev and the host planes, 64 bytes a
# thread), slots for kernel 12's stream (prev, 32 bytes)); -1 the element
# loads (strips of 2), 0 cur alone.  The general pass keeps the element
# loads at every height.
_RING_TABLE = [
    # pow-2 heights: 16 columns to 1024 (H = 512 keeps its 3 blocks an SM),
    # 8 to 2048, 4 to 4096, 2 at 8192 (and on the bracket's 8192-row blocks)
    (32, 16, 1, 3), (128, 16, 1, 2), (256, 16, 0, 1), (512, 16, 0, 0),
    (1024, 16, 3, 4), (2048, 8, 3, 4), (4096, 4, 3, 4), (8192, 2, -1, -1),
    # tight m <= 14 on 16 columns: 1080p's m = 9 has room for 2 or 4
    (1 * LANE, 16, 1, 2), (3 * LANE, 16, 0, 0), (5 * LANE, 16, 1, 2),
    (7 * LANE, 16, 0, 0), (9 * LANE, 16, 2, 4), (11 * LANE, 16, 1, 3),
    (12 * LANE, 16, 1, 2), (13 * LANE, 16, 0, 1), (14 * LANE, 16, 0, 0),
    # m = 15-28 on 8 columns, 29-32 on 4, 33-63 on 2
    (15 * LANE, 8, 3, 4), (17 * LANE, 8, 2, 4), (25 * LANE, 8, 0, 1),
    (27 * LANE, 8, 0, 0), (28 * LANE, 8, 0, 0), (29 * LANE, 4, 3, 4),
    (34 * LANE, 2, -1, -1), (63 * LANE, 2, -1, -1),
    # m > 64: chunks of 32 blocks of 128 rows on 4 columns, and a last
    # chunk of 1 (m = 65)
    (32 * LANE, 4, 3, 4), (1 * LANE, 4, 1, 3),
]


def ring_depth(h, s, words):
    """Slots of the phase strip's ring `fused.phase_strip_smem` gives: -1
    where the element loads serve (strips of 2 and 1, the general pass),
    0 where cur alone takes the asynchronous copies."""
    if s < 4 or words == 0:
        return -1
    slot = 16 * words * 512
    return (fused.phase_strip_smem(h, s, words=words) - 8 * h * s) // slot


@pytest.mark.parametrize("h,s,main,stream", _RING_TABLE,
                         ids=[f"h{h}_s{s}" for h, s, _, _ in _RING_TABLE])
def test_phase_ring_rule_table(h, s, main, stream):
    """The host's mirror of the phase strip's shared memory and ring depth
    against the C rule's table, on the main branch (4 words a thread a
    slot), kernel 12's stream (2) and the general pass (none: the strip
    alone): the strip and that many slots, within a block's 227 KB; where
    the strip alone let 2-4 blocks share an SM, strip and ring still do; no
    room for a slot more below `PS_MAXD`."""
    strip = 8 * h * s
    blocks = min(4, fused._SMEM_SM // (strip + fused._SMEM_RESERVE))
    room = min(fused._SMEM_SM // blocks - fused._SMEM_RESERVE,
               fused._SMEM_BLOCK)
    assert fused.phase_strip_smem(h, s, words=0) == strip
    for words, depth in ((4, main), (2, stream)):
        smem = fused.phase_strip_smem(h, s, words=words)
        slot = 16 * words * 512
        assert ring_depth(h, s, words) == depth
        assert smem == strip + max(depth, 0) * slot
        assert smem <= room
        if 0 <= depth < fused.PS_MAXD:
            assert room - smem < slot


def test_phase_ring_constants_match_the_header():
    """The mirror's constants are the header's."""
    text = _PHASE_INV.read_text()
    got = dict(re.findall(r"#define (PBMM_\w+) (\d+)", text))
    assert int(got["PBMM_PS_MAXD"]) == fused.PS_MAXD
    assert int(got["PBMM_SM_SMEM"]) == fused._SMEM_SM
    assert int(got["PBMM_SMEM_BLOCK"]) == fused._SMEM_BLOCK
    assert int(got["PBMM_SMEM_RESERVE"]) == fused._SMEM_RESERVE


_CLASSES = ([(1 << n, True) for n in range(1, 13)]
            + [(8192, False), (16384, False), (32768, False)]
            + [(m * LANE, m <= 32 or m > 64) for m in range(1, 70)
               if m & (m - 1)])


@pytest.mark.parametrize("general", [False, True], ids=["main", "general"])
def test_colspec_staged_at_every_height_class(general):
    """`colspec_staged` (what `colspec_chunk.staged` counts): launch 2
    runs the asynchronous phase strip on the main branch wherever its
    strip is 4 columns or more (pow-2 to 4096, tight m <= 32 and the chunk
    kernels above m = 64), never on strips of 2, never on the general
    pass; its ring holds prev and the planes where a block has room."""
    for h, staged in _CLASSES:
        assert fused.colspec_staged(h, general) == (staged and not general), h
        held = (min(h, fused.BLOCK_N) if fused._is_pow2(h)
                else h if h // LANE < 64 else 32 * LANE)
        depth = ring_depth(held, fused.colspec_strip(h), 0 if general else 4)
        assert (depth >= 0) == (staged and not general), h


_GENERAL = {"main": (dict(), False), "standard": (dict(mode="standard"), True),
            "steerable": (dict(orientations=4), True),
            "scale_2_5": (dict(phase_scale=2.5), True),
            "iir": (dict(temporal=TemporalConfig(mode="iir_bandpass")), True)}


@pytest.mark.parametrize("name", sorted(_GENERAL))
def test_phase_general_mirrors_the_pass(name):
    """`fused._phase_general`, the host's copy of
    `phase_pass.cuh::pbmm_phase_general`: the main path's config (host
    planes, integer scale, two-frame) runs the main branch, each of
    standard mode, steerable sectors, a non-integer scale and the IIR taps
    the general pass."""
    change, general = _GENERAL[name]
    cfg = TCfg(phase_scale=10.0).tuned_for_tpu().replace(**change)
    plan = fused._phase_plan(cfg)
    host = fused._static_phase_planes(cfg, 384, 128, 256) is not None
    ints, _ = fused._phase_args(plan, host)
    assert fused._phase_general(ints) == general


@pytest.mark.parametrize("s", [4, 8, 16])
@pytest.mark.parametrize("h", [64, 1152, 2176, 4096])
def test_phase_strip_words_banks(h, s):
    """The asynchronous phase strip's accesses: thread t's word k is strip
    word w = t + 512 k (row w / (S / 4), columns 4 (w mod S / 4) ..); each
    quarter warp's 16-byte strip words (8 threads) cover 32 distinct banks,
    cp.async stores and float4 loads alike, and the strip's words are each
    one thread's (the ring's words lie at 4 t, consecutive)."""
    v = s // 4
    w = np.arange(h * v)
    p, c = w // v, (w % v) * 4
    word = idx(p, c, s)
    assert len(np.unique(word)) == len(word) and (word % 4 == 0).all()
    for q0 in range(0, len(w) - 7, 8):
        banks = (word[q0:q0 + 8, None] + np.arange(4)) % 32
        assert len(np.unique(banks)) == 32, (q0, banks)


def test_aligned16_copies_only_offset_views():
    """Kernels 6 and 12's wrappers hand the asynchronous copies 16-byte
    aligned planes: an aligned tensor as it is, a view off the 16-byte grid
    as an aligned copy with its values."""
    base = torch.arange(40, dtype=torch.float32)
    a = base[:36].view(3, 3, 4)
    b = base[1:37].view(3, 3, 4)
    got_a, got_b = fused.aligned16(a, b)
    assert got_a is a
    assert got_b.data_ptr() % 16 == 0 and torch.equal(got_b, b)
