"""The fused spectral stages of the chunk engine: kernels 1, 4, 2 and 7.

Counterpart of `pbmm_tpu/spectral/fused.py` for the tight-height chunk
engine:

  `windowed_row_fft`           Hann window x row FFT, Hermitian kept
                               tiles out (CUDA: `csrc/row_fft.cu`);
  `windowed_row_fft_u8planar`  the same from (T, 3, H, W) uint8 frames:
                               luma, pad and window inside the kernel
                               (CUDA: `csrc/row_fft.cu`, second entry);
  `colspec_chunk`              column FFT + band/phase pass + column IFFT
                               for a whole chunk, previous spectrum
                               carried on chip (CUDA: `csrc/colspec_chunk.cu`);
  `row_ifft_magnitude`         Hermitian rebuild + row IFFT + |z| of the
                               two-kernel tail (CUDA: `csrc/row_ifft.cu`);

plus the host tables they need.  Spectra keep the JAX package's working
layout: row (lane) axis bit-reversed and cut to the kept Hermitian tiles,
column axis in the four-step order of `col_freq_axis`.

Each public function takes its plain PyTorch version (`*_ref`) when the
tensors lie on the CPU and launches its CUDA kernel when they lie on the
card; there is no other switch and no fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pbmm_tpu_torch.core.color import channel_mix, unit_float
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.spectral.hermitian import (
    hermitian_kept_width,
    kept_lane_indices,
    kept_tiles,
    reconstruction_plan,
)
from pbmm_tpu_torch.spectral.radix2 import (
    _dif_twiddles,
    bit_reverse_permutation,
    bitrev_freq_axis,
    check_pow2,
)

_ROW_BLOCK = 64  # row quantum of the content/output row windows
_LANE = 128
_MAX_TILES = 64  # widest row the CUDA kernels take: 64 tiles (PBMM_MAX_TILES)
_COLSPEC_MAX_M = 16  # tallest four-step column of csrc/colspec_chunk.cu


def _hann_vec(n: int) -> np.ndarray:
    i = (np.arange(n, dtype=np.float64) + 0.5) / n
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i))).astype(np.float32)


def _hann_pair(pad_h: int, w: int):
    return _hann_vec(pad_h), _hann_vec(w)


def aligned_row_window(lo: int, hi: int, pad_h: int,
                       block: int = _ROW_BLOCK):
    """Smallest block-aligned [r0, r1) covering [lo, hi), clamped to the
    padded height: the content rows before the row FFT (the other padded
    rows are exact zeros) and the crop + blur-halo rows after the column
    IFFT (the only rows the output depends on)."""
    r0 = max(0, (lo // block) * block)
    r1 = min(pad_h, -(-hi // block) * block)
    return r0, r1


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def _check_fourstep(n: int) -> int:
    """m for a four-step column length n = m * 128 (not a power of two:
    those heights take the radix-2 layout, ROADMAP item 6)."""
    m = n // _LANE
    if n <= 0 or m * _LANE != n:
        raise ValueError(
            f"four-step column length must be a multiple of 128, got {n}")
    return m


def _fourstep_order(n: int) -> np.ndarray:
    """Frequency index held at each position of the four-step layout:
    position p = 128 k1 + k2 holds frequency k1 + m k2."""
    m = _check_fourstep(n)
    p = np.arange(n)
    return (p // _LANE) + m * (p % _LANE)


def col_freq_axis(n: int) -> np.ndarray:
    """Centred normalized frequency of each column position in the
    working layout: bitrev for pow-2 heights, four-step for tight heights
    (n = m * 128)."""
    if _is_pow2(n):
        return bitrev_freq_axis(n)
    v = _fourstep_order(n).astype(np.float64) / n
    return np.where(v < 0.5, v, v - 1.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _fourstep_twiddle(h: int, inverse: bool):
    """Per-row twiddle (re, im) of shape (h, 1): tw[k1*128 + n2] =
    W_H^{+-k1*n2}, the cross-factor twiddle of the four-step split."""
    _check_fourstep(h)
    p = np.arange(h)
    k1 = p // _LANE
    n2 = p % _LANE
    sign = +2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * ((k1 * n2) % h) / float(h))
    return (w.real.astype(np.float32)[:, None],
            w.imag.astype(np.float32)[:, None])


@functools.lru_cache(maxsize=16)
def _combine_matrix(m: int):
    """The m-point DFT weights W_m^{-k1*n1} as (m, m) f32 (re, im) — the
    cross-block combine of the four-step forward transform (the inverse
    uses their conjugates)."""
    k1 = np.arange(m)[:, None]
    n1 = np.arange(m)[None, :]
    w = np.exp(-2.0 * 1j * np.pi * ((k1 * n1) % m) / float(m))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _mask_params(cfg):
    """Per-level radial-profile parameters (kind, lo, hi, amplified)."""
    from pbmm_tpu_torch.pyramid.filters import radial_level_params

    return radial_level_params(
        cfg.pyramid_levels, cfg.min_frequency, cfg.max_frequency
    )


def _disjoint_bands(params):
    """The amplified bands' (lo, hi) sorted by lo when every amplified
    plane is a raised-cosine band and their interiors are pairwise
    disjoint (true for the reference defaults L=5, 0.05/0.45, where the
    bands touch at their zero endpoints); else None."""
    bands = [(lo, hi) for kind, lo, hi, amp in params if amp]
    if not bands or any(kind != "band" for kind, _, _, amp in params if amp):
        return None
    bands.sort()
    for (lo1, hi1), (lo2, hi2) in zip(bands, bands[1:]):
        # Touching endpoints are fine (the raised cosine is 0 there); the
        # epsilon absorbs fp rounding of the geometric band centres.
        if hi1 > lo2 + 1e-6 * (hi1 - lo1):
            return None
    return bands


@functools.lru_cache(maxsize=8)
def _static_phase_planes(cfg, h: int, wk: int, full_w: int):
    """Host-precomputed per-bin (total, m_amp) f32 planes (h, wk) of the
    pyramid mode with disjoint bands, in the working (four-step x kept
    bitrev) layout, evaluated in f64 from `radial_level_params`; None when
    the bands overlap (in-kernel mask evaluation, ROADMAP item 6).  The
    standard mode's weight plane is ROADMAP item 6 too."""
    if cfg.mode != "pyramid":
        raise NotImplementedError(
            f"mode={cfg.mode!r} is not ported yet (ROADMAP item 6)")
    fy = col_freq_axis(h).astype(np.float64)[:, None]
    if full_w is not None and full_w != wk:
        fx = bitrev_freq_axis(full_w)[kept_lane_indices(full_w)]
    else:
        fx = bitrev_freq_axis(wk)
    fx = fx.astype(np.float64)[None, :]
    freq = np.sqrt(fy * fy + fx * fx)
    params = _mask_params(cfg)
    if _disjoint_bands(params) is None:
        return None

    def smoothstep(t):
        t = np.clip(t, 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    total = np.zeros_like(freq)
    m_amp = np.zeros_like(freq)
    for kind, lo, hi, amp in params:
        if kind == "zero":
            m = np.zeros_like(freq)
        elif kind == "high":
            m = np.where(freq > hi, 1.0,
                         np.where(freq > lo,
                                  smoothstep((freq - lo) / (hi - lo)), 0.0))
        elif kind == "low":
            m = np.where(freq < lo, 1.0,
                         np.where(freq < hi,
                                  1.0 - smoothstep((freq - lo) / (hi - lo)),
                                  0.0))
        else:
            t = (freq - lo) / (hi - lo)
            m = np.where((freq >= lo) & (freq <= hi),
                         0.5 * (1.0 + np.cos(2.0 * np.pi * (t - 0.5))), 0.0)
        total += m
        if amp:
            m_amp += m  # disjoint: at most one band nonzero per bin
    return total.astype(np.float32), m_amp.astype(np.float32)


def fused_eligible(cfg) -> bool:
    """Whether the fully-fused spectral path serves this config (the
    JAX package's predicate, verbatim)."""
    return (
        cfg.use_fused_spectral
        and cfg.fft_backend == "pallas"
        and cfg.mode in ("pyramid", "standard")
        and cfg.temporal.mode in ("two_frame", "iir_bandpass")
        and not cfg.apply_magnitude_scale
    )


# ---------------------------------------------------------------------------
# Kernel 1: windowed row FFT
# ---------------------------------------------------------------------------


def _row_args(y: torch.Tensor, pad_h: int, row0: int, keep_half: bool):
    """Validate a row-FFT call; returns (pad_h, kept full-layout tiles,
    kept lane count)."""
    _, h, w = y.shape
    check_pow2(w, "row FFT length")
    if w % _LANE:
        raise ValueError(f"row FFT length must be a multiple of 128: {w}")
    pad_h = pad_h or h
    if not 0 <= row0 <= pad_h - h:
        raise ValueError(f"rows [{row0}, {row0 + h}) outside pad_h={pad_h}")
    if keep_half:
        return pad_h, kept_tiles(w), hermitian_kept_width(w)
    return pad_h, list(range(w // _LANE)), w


def windowed_row_fft_ref(y: torch.Tensor, pad_h: int = 0, row0: int = 0,
                         keep_half: bool = False):
    """Plain PyTorch version of `windowed_row_fft`: window, `torch.fft`,
    then the bit-reversal and kept-tile index maps.  Frames are
    transformed one at a time, so a chunk's split never changes a
    frame's arithmetic."""
    b, h, w = y.shape
    pad_h, _, wk = _row_args(y, pad_h, row0, keep_half)
    wy, wx = device_arrays(_hann_pair, (pad_h, w), y.device)
    wy, wx = wy[row0:row0 + h, None], wx[None, :]
    lanes = bit_reverse_permutation(w)
    if wk != w:
        lanes = lanes[kept_lane_indices(w)]
    lanes = torch.as_tensor(lanes, device=y.device)
    out_re = torch.empty((b, h, wk), dtype=torch.float32, device=y.device)
    out_im = torch.empty_like(out_re)
    for i in range(b):
        spec = torch.fft.fft(y[i] * wy * wx, dim=-1)[:, lanes]
        out_re[i] = spec.real
        out_im[i] = spec.imag
    return out_re, out_im


def windowed_row_fft(y: torch.Tensor, pad_h: int = 0, row0: int = 0,
                     keep_half: bool = False):
    """(B, Hc, W) content rows of the padded real Y plane -> row FFT of
    (hann_row x hann_col x y), bit-reversed lanes, only the kept
    Hermitian tiles when `keep_half` (re, im each (B, Hc, Wk) f32).
    `pad_h`/`row0` place the Hc rows inside the padded frame so the row
    window uses absolute rows (pad_h=0: Hc is the padded height).

    CPU tensors take `windowed_row_fft_ref`; CUDA tensors launch
    `csrc/row_fft.cu`."""
    if y.device.type == "cpu":
        return windowed_row_fft_ref(y, pad_h, row0, keep_half)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    b, h, w = y.shape
    pad_h, tiles, wk = _row_args(y, pad_h, row0, keep_half)
    if w > _MAX_TILES * _LANE:
        raise ValueError(f"the CUDA row kernel takes rows up to "
                         f"{_MAX_TILES * _LANE} lanes, got {w}")
    check_cuda("windowed_row_fft", (b, h, w), y)
    wy, wx = device_arrays(_hann_pair, (pad_h, w), y.device)
    twr, twi = device_arrays(_dif_twiddles, (w, False), y.device)
    out_re = torch.empty((b, h, wk), dtype=torch.float32, device=y.device)
    out_im = torch.empty_like(out_re)
    err = library().pbmm_row_fft(
        y.data_ptr(), wy[row0:row0 + h].data_ptr(), wx.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        c_ints(tiles), len(tiles), b, h, w, stream_handle(y.device))
    check_launch(err, "windowed_row_fft")
    windowed_row_fft.launches += 1
    return out_re, out_im


windowed_row_fft.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4: windowed row FFT straight from planar uint8 frames
# ---------------------------------------------------------------------------


def _u8_args(frames, pad_h: int, pad_w: int, y0: int, x0: int, row0: int):
    """Validate a u8 row-FFT call; returns (Hc, off): the content-row
    window [row0, row0 + Hc) of the padded frame and the row offset
    off = y0 - row0 of frame row 0 inside it (the JAX kernel's
    geometry)."""
    t, nch, h_in, w_in = frames.shape
    if nch != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"expected (T, 3, H, W) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    r1 = min(pad_h, -(-(y0 + h_in) // _ROW_BLOCK) * _ROW_BLOCK)
    hc, off = r1 - row0, y0 - row0
    if not (0 <= off < _ROW_BLOCK and hc % _ROW_BLOCK == 0
            and 0 <= x0 <= pad_w - w_in):
        raise ValueError(f"frames of {h_in}x{w_in} do not sit at "
                         f"({y0}, {x0}) of the rows from {row0} of a "
                         f"{pad_h}x{pad_w} pad")
    return hc, off


def windowed_row_fft_u8planar_ref(frames, coeffs, pad_h: int, pad_w: int,
                                  y0: int, x0: int, row0: int,
                                  keep_half: bool = False):
    """Plain PyTorch version of `windowed_row_fft_u8planar`: the pre
    stage's `unit_float` and luma FMA, the centre pad, then
    `windowed_row_fft_ref` (bit-identical to the f32 path by
    construction)."""
    hc, off = _u8_args(frames, pad_h, pad_w, y0, x0, row0)
    _, _, h_in, w_in = frames.shape
    f = unit_float(frames)
    y = channel_mix(f[:, 0], f[:, 1], f[:, 2], coeffs)
    slab = F.pad(y, (x0, pad_w - w_in - x0, off, hc - off - h_in))
    return windowed_row_fft_ref(slab, pad_h, row0, keep_half)


def windowed_row_fft_u8planar(frames, coeffs, pad_h: int, pad_w: int,
                              y0: int, x0: int, row0: int,
                              keep_half: bool = False):
    """(T, 3, H, W) planar uint8 frames -> row FFT of the windowed luma
    slab: Y = coeffs . (rgb / 255) in the pre stage's op order, the
    centre pad at (y0, x0) of the pad_h x pad_w frame, the content rows
    [row0, row0 + Hc) of `aligned_row_window`, the Hann window and
    kernel 1's row FFT.  Returns (re, im) each (T, Hc, Wk) f32; equal bit
    for bit to the pre stage + `windowed_row_fft` on the same frames.

    CPU tensors take `windowed_row_fft_u8planar_ref`; CUDA tensors launch
    `csrc/row_fft.cu::pbmm_row_fft_u8`."""
    if frames.device.type == "cpu":
        return windowed_row_fft_u8planar_ref(frames, coeffs, pad_h, pad_w,
                                             y0, x0, row0, keep_half)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    hc, off = _u8_args(frames, pad_h, pad_w, y0, x0, row0)
    t, _, h_in, w_in = frames.shape
    check_pow2(pad_w, "row FFT length")
    if pad_w % _LANE or pad_w > _MAX_TILES * _LANE:
        raise ValueError(f"the CUDA row kernel takes multiples of 128 up "
                         f"to {_MAX_TILES * _LANE} lanes, got {pad_w}")
    check_cuda("windowed_row_fft_u8planar", (t, 3, h_in, w_in), frames,
               dtype=torch.uint8)
    tiles = kept_tiles(pad_w) if keep_half else list(range(pad_w // _LANE))
    wk = len(tiles) * _LANE
    dev = frames.device
    wy, wx = device_arrays(_hann_pair, (pad_h, pad_w), dev)
    twr, twi = device_arrays(_dif_twiddles, (pad_w, False), dev)
    out_re = torch.empty((t, hc, wk), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    err = library().pbmm_row_fft_u8(
        frames.data_ptr(), wy[row0:row0 + hc].data_ptr(), wx.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), c_ints(tiles), len(tiles), t, hc, h_in, w_in,
        pad_w, off, x0, c_floats(coeffs), float(np.float32(1.0 / 255.0)),
        stream_handle(dev))
    check_launch(err, "windowed_row_fft_u8planar")
    windowed_row_fft_u8planar.launches += 1
    return out_re, out_im


windowed_row_fft_u8planar.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: column FFT + band/phase + column IFFT over a chunk
# ---------------------------------------------------------------------------


def _integer_power(cfg) -> int:
    """The slice's phase rotation: pyramid mode, radial bands, two-frame
    temporal mode and an integer phase_scale in [0, 64] (exact
    square-and-multiply of the unit rotation)."""
    if cfg.mode != "pyramid":
        raise NotImplementedError(
            f"mode={cfg.mode!r} is not ported yet (ROADMAP item 6)")
    if cfg.orientations > 1 and cfg.pyramid_levels >= 3:
        raise NotImplementedError(
            "steerable bands (orientations > 1) are not ported yet "
            "(ROADMAP item 6)")
    if cfg.temporal.mode != "two_frame":
        raise NotImplementedError(
            f"temporal mode {cfg.temporal.mode!r} is not ported yet "
            "(ROADMAP item 6)")
    s = float(cfg.phase_scale)
    if not (s.is_integer() and 0 <= s <= 64):
        raise NotImplementedError(
            f"non-integer phase_scale={s} (polynomial atan2/sincos rotation) "
            "is not ported yet (ROADMAP item 6)")
    return int(s)


def _colspec_args(rows_re, cfg, pad_h, row0, out_rows, full_w, planes):
    """Validate a colspec call; returns (power, r0, r1, tau2)."""
    n, hc, w = rows_re.shape
    if planes != 1:
        raise NotImplementedError(
            "chroma='rgb' (planes=3) is not ported yet (ROADMAP item 6)")
    if _is_pow2(pad_h):
        raise NotImplementedError(
            f"pow-2 column height {pad_h} (radix-2 column layout) is not "
            "ported yet (ROADMAP item 6)")
    _check_fourstep(pad_h)
    power = _integer_power(cfg)
    if _static_phase_planes(cfg, pad_h, w, full_w) is None:
        raise NotImplementedError(
            "overlapping pyramid bands (in-kernel mask evaluation) are not "
            "ported yet (ROADMAP item 6)")
    if not 0 <= row0 <= pad_h - hc:
        raise ValueError(f"rows [{row0}, {row0 + hc}) outside pad_h={pad_h}")
    r0, r1 = out_rows if out_rows is not None else (0, pad_h)
    if not 0 <= r0 < r1 <= pad_h:
        raise ValueError(f"bad out_rows {out_rows} for pad_h={pad_h}")
    tau2 = np.float32(cfg.magnitude_threshold) ** 2
    return power, r0, r1, tau2


def _phase_block_ref(cr, ci, pr, pi_, total, m, tau2, power):
    """The band/phase pass on one frame (plain torch, the JAX kernel's
    `_phase_block` branch for host planes and an integer rotation):
    out = cur * ((total - amped) + amped * unit(prev * conj(cur))**power),
    amped = m where min(|cur|^2, |prev|^2) * m^2 >= tau^2."""
    r_re = pr * cr + pi_ * ci  # prev * conj(cur)
    r_im = pi_ * cr - pr * ci
    min_mag2 = torch.minimum(cr * cr + ci * ci, pr * pr + pi_ * pi_)
    amped = torch.where(min_mag2 * (m * m) >= tau2, m, 0.0)
    m2 = r_re * r_re + r_im * r_im
    inv = torch.where(m2 > 0, torch.rsqrt(torch.clamp_min(m2, 1e-38)), 0.0)
    br, bi = r_re * inv, r_im * inv
    rr, ri = torch.ones_like(br), torch.zeros_like(bi)
    n = power
    while n > 0:
        if n & 1:
            rr, ri = rr * br - ri * bi, rr * bi + ri * br
        br, bi = br * br - bi * bi, 2.0 * br * bi
        n >>= 1
    p = total - amped
    g_re = p + amped * rr
    g_im = amped * ri
    return cr * g_re - ci * g_im, cr * g_im + ci * g_re


def colspec_chunk_ref(rows_re, rows_im, prev_re, prev_im, cfg, pad_h: int,
                      row0: int, out_rows=None, full_w=None,
                      planes: int = 1):
    """Plain PyTorch version of `colspec_chunk`: per frame, zero-embed,
    `torch.fft` down the columns, the four-step index map, the phase pass
    against the previous frame, the inverse map and an unnormalised
    inverse FFT."""
    power, r0, r1, tau2 = _colspec_args(rows_re, cfg, pad_h, row0,
                                        out_rows, full_w, planes)
    n, hc, w = rows_re.shape
    dev = rows_re.device
    total, m_amp = device_arrays(_static_phase_planes,
                                 (cfg, pad_h, w, full_w), dev)
    order = torch.as_tensor(_fourstep_order(pad_h), device=dev)
    out_re = torch.empty((n, r1 - r0, w), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    pr, pi_ = prev_re[0], prev_im[0]
    for f in range(n):
        x = torch.zeros((pad_h, w), dtype=torch.complex64, device=dev)
        x[row0:row0 + hc] = torch.complex(rows_re[f], rows_im[f])
        cur = torch.fft.fft(x, dim=0)[order]
        cr, ci = cur.real, cur.imag
        mr, mi = _phase_block_ref(cr, ci, pr, pi_, total, m_amp, tau2, power)
        nat = torch.empty_like(cur)
        nat[order] = torch.complex(mr, mi)
        z = torch.fft.ifft(nat, dim=0, norm="forward")[r0:r1]
        out_re[f] = z.real
        out_im[f] = z.imag
        pr, pi_ = cr, ci
    return (out_re, out_im, pr[None].contiguous(), pi_[None].contiguous())


def colspec_chunk(rows_re, rows_im, prev_re, prev_im, cfg, pad_h: int,
                  row0: int, out_rows=None, full_w=None, planes: int = 1):
    """Column FFT + band/phase amplification + column IFFT for a whole
    chunk, the previous frame's spectrum carried on chip.

    Args:
      rows_re/rows_im: (T, Hc, Wk) kernel-1 output, the row spectra of
        the windowed content rows.
      prev_re/prev_im: (1, H, Wk) carried previous-frame spectrum (the
        `VideoState` contract: four-step rows x kept bitrev lanes).
      pad_h/row0: the content slab sits at rows [row0, row0 + Hc) of the
        H = pad_h padded column.
      out_rows: (r0, r1) spatial rows of the inverse to write back.
      full_w: the padded width when the lanes are the kept Hermitian half.
    Returns (rre, rim (T, r1-r0, Wk), new_prev_re, new_prev_im (1, H, Wk)).

    CPU tensors take `colspec_chunk_ref`; CUDA tensors launch
    `csrc/colspec_chunk.cu`."""
    if rows_re.device.type == "cpu":
        return colspec_chunk_ref(rows_re, rows_im, prev_re, prev_im, cfg,
                                 pad_h, row0, out_rows, full_w, planes)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    power, r0, r1, tau2 = _colspec_args(rows_re, cfg, pad_h, row0,
                                        out_rows, full_w, planes)
    n, hc, w = rows_re.shape
    if n < 1:
        raise ValueError("colspec_chunk needs at least one frame")
    check_cuda("colspec_chunk", (n, hc, w), rows_re, rows_im)
    check_cuda("colspec_chunk", (1, pad_h, w), prev_re, prev_im)
    dev = rows_re.device
    m = _check_fourstep(pad_h)
    if m > _COLSPEC_MAX_M:
        raise ValueError(
            f"the CUDA column kernel takes heights up to "
            f"{_COLSPEC_MAX_M * _LANE} rows, got {pad_h}")
    total, m_amp = device_arrays(_static_phase_planes,
                                 (cfg, pad_h, w, full_w), dev)
    fsr, fsi = device_arrays(_fourstep_twiddle, (pad_h, False), dev)
    cwr, cwi = device_arrays(_combine_matrix, (m,), dev)
    dfr, dfi = device_arrays(_dif_twiddles, (_LANE, False), dev)
    dir_, dii = device_arrays(_dif_twiddles, (_LANE, True), dev)
    out_re = torch.empty((n, r1 - r0, w), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    np_re = torch.empty((1, pad_h, w), dtype=torch.float32, device=dev)
    np_im = torch.empty_like(np_re)
    err = library().pbmm_colspec_chunk(
        rows_re.data_ptr(), rows_im.data_ptr(), prev_re.data_ptr(),
        prev_im.data_ptr(), total.data_ptr(), m_amp.data_ptr(),
        fsr.data_ptr(), fsi.data_ptr(), cwr.data_ptr(), cwi.data_ptr(),
        dfr.data_ptr(), dfi.data_ptr(), dir_.data_ptr(), dii.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), np_re.data_ptr(),
        np_im.data_ptr(), n, hc, pad_h, w, row0, r0, r1, float(tau2), power,
        stream_handle(dev))
    check_launch(err, "colspec_chunk")
    colspec_chunk.launches += 1
    return out_re, out_im, np_re, np_im


colspec_chunk.launches = 0


# ---------------------------------------------------------------------------
# Kernel 7: Hermitian rebuild + row IFFT + |z| (the two-kernel tail)
# ---------------------------------------------------------------------------


def lane_plan(wk: int, w: int):
    """(source kept tile, conj-reversed flag) per full 128-lane tile: the
    Hermitian `reconstruction_plan` when the lanes are the kept half,
    else the identity."""
    if w == wk:
        return tuple((t, 0) for t in range(w // _LANE))
    return reconstruction_plan(w)


def _row_ifft_args(re, magnitude: bool, pad_h: int, full_w):
    """Validate a row-IFFT call; returns (full width, |z| scale)."""
    if not magnitude:
        raise NotImplementedError(
            "reconstruct='real' is not ported yet (ROADMAP item 6)")
    _, h, w = re.shape
    fw = full_w if full_w is not None else w
    check_pow2(fw, "row IFFT length")
    if fw % _LANE or w % _LANE:
        raise ValueError(f"widths must be multiples of 128: {w}, {fw}")
    return fw, 1.0 / ((pad_h or h) * fw)


def rebuilt_row_magnitude(re, im, fw: int, scale: float) -> torch.Tensor:
    """|row IFFT| * scale of (B, Hb, Wk) bit-reversed kept lanes, full
    width: lane gathers for the rebuild and the bit reversal, then
    `torch.fft` one frame at a time (the plain arithmetic behind kernels
    3 and 7)."""
    b, hb, wk = re.shape
    dev = re.device
    src, flip = [], []
    for kp, rev in lane_plan(wk, fw):
        lanes = np.arange(_LANE)
        src.append(kp * _LANE + (_LANE - 1 - lanes if rev else lanes))
        flip.append(np.full(_LANE, bool(rev)))
    # Natural lane k holds bit-reversed position rev(k).
    perm = bit_reverse_permutation(fw)
    gather = torch.as_tensor(np.concatenate(src)[perm], device=dev)
    flip = torch.as_tensor(np.concatenate(flip)[perm], device=dev)
    mag = torch.empty((b, hb, fw), dtype=torch.float32, device=dev)
    for f in range(b):
        x = torch.complex(re[f], im[f])[:, gather]
        x = torch.where(flip, x.conj(), x)
        z = torch.fft.ifft(x, dim=-1, norm="forward")
        mag[f] = torch.sqrt(z.real * z.real + z.imag * z.imag) * scale
    return mag


def row_ifft_magnitude_ref(re, im, magnitude: bool = True, pad_h: int = 0,
                           full_w=None):
    """Plain PyTorch version of `row_ifft_magnitude`."""
    fw, scale = _row_ifft_args(re, magnitude, pad_h, full_w)
    return rebuilt_row_magnitude(re, im, fw, scale)


def row_ifft_magnitude(re, im, magnitude: bool = True, pad_h: int = 0,
                       full_w=None):
    """(B, Hb, Wk) bit-reversed kept-lane rows -> (B, Hb, W) f32 |row
    IFFT| / (pad_h * W), full width: the missing tiles are rebuilt as
    conj(lane reversal) of kept ones (`reconstruction_plan`) when
    `full_w` exceeds Wk.  `pad_h` (default Hb) is the padded height of
    the normalisation.  Only `magnitude=True` (the reference's |z|) is
    served.

    CPU tensors take `row_ifft_magnitude_ref`; CUDA tensors launch
    `csrc/row_ifft.cu`."""
    if re.device.type == "cpu":
        return row_ifft_magnitude_ref(re, im, magnitude, pad_h, full_w)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    fw, scale = _row_ifft_args(re, magnitude, pad_h, full_w)
    b, hb, wk = re.shape
    if fw > _MAX_TILES * _LANE:
        raise ValueError(f"the CUDA row kernel takes rows up to "
                         f"{_MAX_TILES * _LANE} lanes, got {fw}")
    check_cuda("row_ifft_magnitude", (b, hb, wk), re, im)
    dev = re.device
    twr, twi = device_arrays(_dif_twiddles, (fw, True), dev)
    plan = lane_plan(wk, fw)
    out = torch.empty((b, hb, fw), dtype=torch.float32, device=dev)
    err = library().pbmm_row_ifft(
        re.data_ptr(), im.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out.data_ptr(), c_ints(kp for kp, _ in plan),
        c_ints(rev for _, rev in plan), len(plan), b, hb, wk, fw,
        float(scale), stream_handle(dev))
    check_launch(err, "row_ifft_magnitude")
    row_ifft_magnitude.launches += 1
    return out


row_ifft_magnitude.launches = 0
