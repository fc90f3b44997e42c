"""The fused spectral stages: kernels 1, 4, 2, 6, 5 and 7.

Counterpart of `pbmm_tpu/spectral/fused.py`:

  `windowed_row_fft`           Hann window x row FFT, Hermitian kept
                               tiles out (CUDA: `csrc/row_fft.cu`);
  `windowed_row_fft_u8planar`  the same from (T, 3, H, W) uint8 frames:
                               luma, pad and window inside the kernel
                               (CUDA: `csrc/row_fft.cu`, second entry);
  `colspec_chunk`              column FFT + band/phase pass + column IFFT
                               for a whole chunk, previous spectrum and
                               IIR taps carried on chip, every branch of
                               the JAX kernel (CUDA: `csrc/colspec_chunk.cu`);
  `phase_col_ifft`             one frame's band/phase pass against its
                               previous frame + column IFFT, the scan
                               engine's and the frame pair's (CUDA:
                               `csrc/phase_col_ifft.cu`);
  `col_fft_zero_padded`        the radix-2 column FFT at pow-2 heights:
                               the pre stage of the bootstrap state, the
                               scan engine and the frame pair (CUDA:
                               `csrc/col_fft.cu`);
  `row_ifft_magnitude`         Hermitian rebuild + row IFFT + |z| or Re z
                               of the two-kernel tail (CUDA:
                               `csrc/row_ifft.cu`);

plus the host tables they need.  Spectra keep the JAX package's working
layout: row (lane) axis bit-reversed and cut to the kept Hermitian tiles,
column axis in the order of `col_freq_axis` (bit-reversed at pow-2
heights, four-step at tight heights).

Each public function takes its plain PyTorch version (`*_ref`) when the
tensors lie on the CPU and launches its CUDA kernel when they lie on the
card; there is no other switch and no fallback.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pbmm_tpu_torch.core.color import channel_mix, unit_float
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
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
PBMM_COL_S = 4  # columns a block of the CUDA column kernels holds
_MAX_TILES = 64  # widest row the CUDA kernels take: 64 tiles (PBMM_MAX_TILES)


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
    """m for a four-step column length n = m * 128 (powers of two take
    the radix-2 layout instead)."""
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


@functools.lru_cache(maxsize=16)
def _col_order(n: int) -> np.ndarray:
    """Frequency index held at each position of the working column
    layout: bit-reversed at pow-2 heights (the radix-2 DIF output),
    four-step otherwise."""
    if _is_pow2(n):
        return bit_reverse_permutation(n)
    return _fourstep_order(n)


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


def lane_freq_axis(wk: int, full_w=None) -> np.ndarray:
    """Centred normalized frequency of each lane of the working layout:
    bit-reversed lanes, cut to the kept Hermitian tiles when `full_w`
    exceeds wk."""
    if full_w is not None and full_w != wk:
        return bitrev_freq_axis(full_w)[kept_lane_indices(full_w)]
    return bitrev_freq_axis(wk)


@functools.lru_cache(maxsize=16)
def _freq_tables(h: int, wk: int, full_w):
    """(fy (h, 1), fx (1, wk)) f32: the frequency of each column position
    and each lane, the axes the in-kernel masks and sector weights read."""
    return col_freq_axis(h)[:, None], lane_freq_axis(wk, full_w)[None, :]


def standard_weight(freq: np.ndarray, cfg) -> np.ndarray:
    """The standard mode's radial phase-delta weight w(f) in f64 at the
    bins' frequencies `freq` (`PhaseDifferenceComputeShader.compute:
    74-122`): the host plane kernels 2 and 6 read in standard mode."""
    f = np.minimum(freq / 0.707, 1.0)
    if not cfg.apply_bandpass:
        return np.ones_like(f)
    lo = max(float(cfg.low_freq_cutoff), 1e-3)
    hi_div = max(1.0 - float(cfg.high_freq_cutoff), 1e-3)
    steep = float(cfg.filter_steepness)
    w_pl = np.ones_like(f)
    w_pl = np.where(f < cfg.low_freq_cutoff, (f / lo) ** steep, w_pl)
    w_pl = np.where(f > cfg.high_freq_cutoff,
                    ((1.0 - f) / hi_div) ** steep, w_pl)
    w_pl = w_pl * float(cfg.motion_sensitivity)
    edge = float(cfg.edge_enhancement) if cfg.enhance_edges else 0.0
    if edge:
        t = (f - cfg.low_freq_cutoff) / (
            cfg.high_freq_cutoff - cfg.low_freq_cutoff)
        mid = (f > cfg.low_freq_cutoff) & (f < cfg.high_freq_cutoff)
        w_pl = np.where(mid, w_pl * (1.0 + edge * np.sin(
            np.pi * np.clip(t, 0.0, 1.0))), w_pl)
    return np.maximum(w_pl, 0.0)


@functools.lru_cache(maxsize=8)
def _static_phase_planes(cfg, h: int, wk: int, full_w: int):
    """Host-precomputed per-bin f32 planes (h, wk) in the working layout,
    evaluated in f64: the standard mode's weight plane (w,); the pyramid
    mode's (total, m_amp) when the amplified bands are disjoint; None when
    they overlap (the masks are then evaluated per bin in the phase pass).
    The JAX package's function, verbatim."""
    fy = col_freq_axis(h).astype(np.float64)[:, None]
    fx = lane_freq_axis(wk, full_w).astype(np.float64)[None, :]
    freq = np.sqrt(fy * fy + fx * fx)
    if cfg.mode == "standard":
        return (standard_weight(freq, cfg).astype(np.float32),)
    if cfg.mode != "pyramid":
        return None
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


@checked
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


@checked
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

_COLSPEC_MAX_H = 2048  # tallest column csrc/colspec_chunk.cu holds on chip
_MAX_ORIENTATIONS = 16  # sector count of the CUDA phase pass (CS_MAXK)
_MAX_LEVELS = 16  # radial levels of the CUDA phase pass (CS_MAXB)
_MASK_KINDS = ("zero", "high", "low", "band")


def _check_col_height(pad_h: int) -> None:
    if pad_h > _COLSPEC_MAX_H:
        raise ValueError(
            f"the CUDA column kernels hold columns up to {_COLSPEC_MAX_H} "
            f"rows in shared memory, got {pad_h}")


class _PhasePlan(NamedTuple):
    """The branch of the band/phase pass a config takes (JAX
    `_phase_block`, `fused.py:865-1016`)."""

    iir: bool  # streaming IIR taps filter the phase delta
    standard: bool  # whole-spectrum weighted rotation (`mode="standard"`)
    steer: int  # K sector windows per amplified band (0: radial only)
    power: int  # integer rotation power, or -1 for atan2 + sin/cos
    params: tuple  # (kind, lo, hi, amplified) per radial level
    tau2: np.float32  # magnitude gate, squared
    scale: np.float32  # phase_scale
    r_hi: np.float32  # IIR smoothing factors
    r_lo: np.float32


@functools.lru_cache(maxsize=32)
def _phase_plan(cfg) -> _PhasePlan:
    iir = cfg.temporal.mode == "iir_bandpass"
    standard = cfg.mode == "standard"
    steer = (cfg.orientations if not standard and cfg.orientations > 1
             and cfg.pyramid_levels >= 3 else 0)
    if steer > _MAX_ORIENTATIONS or cfg.pyramid_levels > _MAX_LEVELS:
        raise ValueError(
            f"the CUDA phase pass takes up to {_MAX_ORIENTATIONS} "
            f"orientations and {_MAX_LEVELS} pyramid levels, got "
            f"{cfg.orientations} and {cfg.pyramid_levels}")
    s = float(cfg.phase_scale)
    power = (int(s) if not (iir or standard) and s.is_integer()
             and 0 <= s <= 64 else -1)
    r_hi, r_lo = (cfg.temporal.smoothing_factors() if iir else (0.0, 0.0))
    return _PhasePlan(iir, standard, steer, power, _mask_params(cfg),
                      np.float32(cfg.magnitude_threshold) ** 2,
                      np.float32(s), np.float32(r_hi), np.float32(r_lo))


def _atan2z(y, x):
    """atan2 with the JAX kernel's zero convention (`_atan2_poly`): -0
    counts as +0 and (0, 0) gives 0.  IEEE atan2 gives pi for (+0, -0)
    and -pi for (-0, x < 0), which would turn the zero previous spectrum
    of the bootstrap into a delta of pi in the IIR taps."""
    return torch.atan2(y + 0.0, x + 0.0)


def _pow_int(x, n: int):
    """x**n for an integer 0 <= n <= 16 by square-and-multiply, in the
    JAX kernel's product order (`_pow_static`)."""
    acc, base = None, x
    while n > 0:
        if n & 1:
            acc = base if acc is None else acc * base
        base = base * base
        n >>= 1
    return acc if acc is not None else torch.ones_like(x)


def _unit_pow(r_re, r_im, n: int):
    """unit(r) ** n by square-and-multiply, r = prev * conj(cur) (the
    integer-power rotation; `phase_pass.cuh::cs_unit_pow`), 0 at r = 0."""
    m2 = r_re * r_re + r_im * r_im
    inv = torch.where(m2 > 0, torch.rsqrt(torch.clamp_min(m2, 1e-38)), 0.0)
    br, bi = r_re * inv, r_im * inv
    rot_re, rot_im = torch.ones_like(br), torch.zeros_like(bi)
    while n > 0:
        if n & 1:
            rot_re, rot_im = (rot_re * br - rot_im * bi,
                              rot_re * bi + rot_im * br)
        br, bi = br * br - bi * bi, 2.0 * br * bi
        n >>= 1
    return rot_re, rot_im


def _sector_consts(k: int):
    """(normaliser, [cos 2 phi_i], [sin 2 phi_i]) of the K sector
    windows, phi_i = pi i / K."""
    m = k - 1
    phi2 = [2.0 * np.pi * i / k for i in range(k)]
    return (4.0**m / (k * math.comb(2 * m, m)), [np.cos(p) for p in phi2],
            [np.sin(p) for p in phi2])


def _sector_weights(fy, fx, k: int):
    """The K partition-of-unity angular windows of the steerable
    extension, trig-free (JAX `_sector_weights`, `fused.py:725-763`):
    cos^2(theta - phi_k) from the double angle of (fx, fy), raised to the
    K - 1, times the constant normaliser."""
    fy, fx = torch.broadcast_tensors(fy, fx)
    r2 = fx * fx + fy * fy
    inv_r2 = torch.where(r2 > 0, 1.0 / torch.clamp_min(r2, 1e-38), 0.0)
    cos2t = torch.where(r2 > 0, (fx * fx - fy * fy) * inv_r2, 1.0)
    sin2t = 2.0 * fx * fy * inv_r2
    norm, cos2p, sin2p = _sector_consts(k)
    out = []
    for c, s in zip(cos2p, sin2p):
        c2 = 0.5 * (1.0 + cos2t * np.float32(c) + sin2t * np.float32(s))
        out.append(_pow_int(torch.clamp_min(c2, 0.0), k - 1)
                   * np.float32(norm))
    return out


def _eval_mask(kind: str, lo: float, hi: float, freq):
    """One radial level's mask at each bin (JAX `_eval_mask`)."""
    if kind == "zero":
        return torch.zeros_like(freq)
    t = torch.clamp((freq - lo) / np.float32(hi - lo), 0.0, 1.0)
    if kind == "high":
        return torch.where(freq > hi, 1.0,
                           torch.where(freq > lo, t * t * (3.0 - 2.0 * t),
                                       0.0))
    if kind == "low":
        return torch.where(freq < lo, 1.0, torch.where(
            freq < hi, 1.0 - t * t * (3.0 - 2.0 * t), 0.0))
    band = 0.5 * (1.0 + torch.cos(2.0 * np.pi * (t - 0.5)))
    return torch.where((freq >= lo) & (freq <= hi), band, 0.0)


def _phase_block_ref(cr, ci, pr, pi_, fy, fx, cfg, lpf=None, lps=None,
                     static_planes=None):
    """The band/phase pass on one frame's spectrum, every branch of the
    JAX kernel's `_phase_block` (`fused.py:865-1016`) as plain torch:

    - standard mode: rotate by delta * w * s, the weight w from the host
      plane, bins under the magnitude gate passed through;
    - pyramid mode: out = cur * ((total - amped) + amped * e^{i s delta}),
      amped the gated sum of the amplified masks (host planes, or every
      level's mask evaluated per bin when `static_planes` is None), each
      split into K sector windows when steerable;
    - the rotation by square-and-multiply of the unit rotation for an
      integer scale, else atan2 and sin/cos (IEEE functions in place of
      the TPU's polynomials; the same functions to their ~1e-8 error);
    - with the IIR taps, delta is band-passed first (lp += r (delta -
      lp), delta' = lp_fast - lp_slow) and the new taps are returned.

    fy (H, 1) and fx (1, Wk) are the bins' frequencies.  Returns (out_re,
    out_im), plus (new_lpf, new_lps) with the IIR taps."""
    plan = _phase_plan(cfg)
    tau2 = plan.tau2
    r_re = pr * cr + pi_ * ci  # prev * conj(cur)
    r_im = pi_ * cr - pr * ci
    taps = ()
    if plan.iir:
        delta = _atan2z(r_im, r_re)
        lpf = lpf + plan.r_hi * (delta - lpf)
        lps = lps + plan.r_lo * (delta - lps)
        delta_iir = lpf - lps
        taps = (lpf, lps)
    if plan.standard:
        delta = delta_iir if plan.iir else _atan2z(r_im, r_re)
        theta = delta * static_planes[0] * plan.scale
        rot_re, rot_im = torch.cos(theta), torch.sin(theta)
        gate_pass = ((cr * cr + ci * ci) < tau2) | ((pr * pr + pi_ * pi_)
                                                    < tau2)
        return (torch.where(gate_pass, cr, cr * rot_re - ci * rot_im),
                torch.where(gate_pass, ci, cr * rot_im + ci * rot_re)) + taps

    min_mag2 = torch.minimum(cr * cr + ci * ci, pr * pr + pi_ * pi_)
    sect = _sector_weights(fy, fx, plan.steer) if plan.steer else None

    def gated(m):
        if sect is None:
            return torch.where(min_mag2 * (m * m) >= tau2, m, 0.0)
        amped = torch.zeros_like(min_mag2)
        for a in sect:
            mk = m * a
            amped = amped + torch.where(min_mag2 * (mk * mk) >= tau2, mk,
                                        0.0)
        return amped

    if static_planes is not None:
        total, m = static_planes
        amped = gated(m)
    else:
        freq = torch.sqrt(fy * fy + fx * fx)
        total = torch.zeros_like(freq)
        amped = torch.zeros_like(min_mag2)
        for kind, lo, hi, amp in plan.params:
            m = _eval_mask(kind, lo, hi, freq)
            total = total + m
            if amp:
                amped = amped + gated(m)

    if plan.power >= 0:
        rot_re, rot_im = _unit_pow(r_re, r_im, plan.power)
    else:
        theta = plan.scale * (delta_iir if plan.iir
                              else _atan2z(r_im, r_re))
        rot_re, rot_im = torch.cos(theta), torch.sin(theta)
    p = total - amped
    g_re = p + amped * rot_re
    g_im = amped * rot_im
    return (cr * g_re - ci * g_im, cr * g_im + ci * g_re) + taps


def _colspec_args(rows_re, cfg, pad_h, row0, out_rows, planes, lp_fast,
                  lp_slow):
    """Validate a colspec call; returns (r0, r1)."""
    n, hc, w = rows_re.shape
    if planes < 1 or n % planes:
        raise ValueError(f"{n} rows do not hold whole frames of {planes} "
                         "planes")
    if _is_pow2(pad_h):
        check_pow2(pad_h, "radix-2 column height")
    else:
        _check_fourstep(pad_h)
    if (cfg.temporal.mode == "iir_bandpass") != (lp_fast is not None
                                                 and lp_slow is not None):
        raise ValueError("lp_fast/lp_slow carry planes go with, and only "
                         "with, temporal mode iir_bandpass")
    _phase_plan(cfg)
    if not 0 <= row0 <= pad_h - hc:
        raise ValueError(f"rows [{row0}, {row0 + hc}) outside pad_h={pad_h}")
    r0, r1 = out_rows if out_rows is not None else (0, pad_h)
    if not 0 <= r0 < r1 <= pad_h:
        raise ValueError(f"bad out_rows {out_rows} for pad_h={pad_h}")
    return r0, r1


def _col_fft_ref(re, im, pad_h: int, row0: int, order):
    """One frame's (Hc, W) content rows, zero-embedded at row0 of a
    pad_h column, through `torch.fft` and into the working row order:
    the forward half of kernels 2 and 5, one op sequence for both."""
    x = torch.zeros((pad_h, re.shape[-1]), dtype=torch.complex64,
                    device=re.device)
    x[row0:row0 + re.shape[0]] = torch.complex(re, im)
    return torch.fft.fft(x, dim=0)[order]


def colspec_chunk_ref(rows_re, rows_im, prev_re, prev_im, cfg, pad_h: int,
                      row0: int, lp_fast=None, lp_slow=None, out_rows=None,
                      full_w=None, planes: int = 1):
    """Plain PyTorch version of `colspec_chunk`: per plane and frame,
    zero-embed, `torch.fft` down the columns, the working-layout index
    map, `_phase_block_ref` against the previous frame, the inverse map
    and an unnormalised inverse FFT."""
    r0, r1 = _colspec_args(rows_re, cfg, pad_h, row0, out_rows, planes,
                           lp_fast, lp_slow)
    n, hc, w = rows_re.shape
    dev = rows_re.device
    host = _static_phase_planes(cfg, pad_h, w, full_w)
    if host is not None:
        host = device_arrays(_static_phase_planes, (cfg, pad_h, w, full_w),
                             dev)
    fy, fx = device_arrays(_freq_tables, (pad_h, w, full_w), dev)
    order = torch.as_tensor(_col_order(pad_h), device=dev)
    out_re = torch.empty((n, r1 - r0, w), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    state = []
    for c in range(planes):
        pr, pi_ = prev_re[c], prev_im[c]
        taps = (lp_fast[c], lp_slow[c]) if lp_fast is not None else ()
        for f in range(c, n, planes):
            cur = _col_fft_ref(rows_re[f], rows_im[f], pad_h, row0, order)
            cr, ci = cur.real, cur.imag
            res = _phase_block_ref(cr, ci, pr, pi_, fy, fx, cfg, *taps,
                                   static_planes=host)
            taps = res[2:]
            nat = torch.empty_like(cur)
            nat[order] = torch.complex(res[0], res[1])
            z = torch.fft.ifft(nat, dim=0, norm="forward")[r0:r1]
            out_re[f] = z.real
            out_im[f] = z.imag
            pr, pi_ = cr, ci
        state.append((pr, pi_) + tuple(taps))
    return (out_re, out_im) + tuple(torch.stack(s) for s in zip(*state))


def _phase_args(plan: _PhasePlan, host_planes: bool):
    """(ints, floats) of csrc/colspec_chunk.cu's PhaseArgs, in its field
    order."""
    bands = () if host_planes or plan.standard else plan.params
    pad = _MAX_LEVELS - len(bands)
    ints = [int(plan.iir), int(plan.standard), int(host_planes), plan.steer,
            plan.power, len(bands)]
    ints += [_MASK_KINDS.index(b[0]) for b in bands] + [0] * pad
    ints += [int(b[3]) for b in bands] + [0] * pad
    k = max(plan.steer, 1)
    norm, cos2p, sin2p = _sector_consts(k)
    floats = [plan.tau2, plan.scale, plan.r_hi, plan.r_lo, norm]
    floats += cos2p + [0.0] * (_MAX_ORIENTATIONS - k)
    floats += sin2p + [0.0] * (_MAX_ORIENTATIONS - k)
    for col in (1, 2):
        floats += [b[col] for b in bands] + [0.0] * pad
    floats += [b[2] - b[1] for b in bands] + [0.0] * pad
    return ints, floats


@checked
def colspec_chunk(rows_re, rows_im, prev_re, prev_im, cfg, pad_h: int,
                  row0: int, lp_fast=None, lp_slow=None, out_rows=None,
                  full_w=None, planes: int = 1):
    """Column FFT + band/phase amplification + column IFFT for a whole
    chunk, the previous frame's spectrum (and the IIR taps) carried on
    chip.

    Args:
      rows_re/rows_im: (T * planes, Hc, Wk) kernel-1 output, the row
        spectra of the windowed content rows, plane-minor frame-major
        ([Y0 I0 Q0 Y1 ...] for chroma="rgb").
      prev_re/prev_im: (planes, H, Wk) carried previous-frame spectrum
        (the `VideoState` contract: bit-reversed rows at pow-2 heights,
        four-step rows otherwise, x kept bitrev lanes).
      pad_h/row0: the content slab sits at rows [row0, row0 + Hc) of the
        H = pad_h padded column.
      lp_fast/lp_slow: (planes, H, Wk) IIR taps (iir_bandpass only).
      out_rows: (r0, r1) spatial rows of the inverse to write back.
      full_w: the padded width when the lanes are the kept Hermitian half.
    Returns (rre, rim (T * planes, r1 - r0, Wk), new_prev_re, new_prev_im
    (planes, H, Wk)[, new_lp_fast, new_lp_slow]).

    CPU tensors take `colspec_chunk_ref`; CUDA tensors launch
    `csrc/colspec_chunk.cu`."""
    if rows_re.device.type == "cpu":
        return colspec_chunk_ref(rows_re, rows_im, prev_re, prev_im, cfg,
                                 pad_h, row0, lp_fast, lp_slow, out_rows,
                                 full_w, planes)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    r0, r1 = _colspec_args(rows_re, cfg, pad_h, row0, out_rows, planes,
                           lp_fast, lp_slow)
    n, hc, w = rows_re.shape
    _check_col_height(pad_h)
    check_cuda("colspec_chunk", (n, hc, w), rows_re, rows_im)
    taps = (lp_fast, lp_slow) if lp_fast is not None else ()
    check_cuda("colspec_chunk", (planes, pad_h, w), prev_re, prev_im, *taps)
    dev = rows_re.device
    plan = _phase_plan(cfg)
    host = _static_phase_planes(cfg, pad_h, w, full_w)
    planes_d = (device_arrays(_static_phase_planes, (cfg, pad_h, w, full_w),
                              dev) if host is not None else ())
    planes_d = planes_d + (None,) * (2 - len(planes_d))
    fy, fx = device_arrays(_freq_tables, (pad_h, w, full_w), dev)
    if _is_pow2(pad_h):
        fs = cw = (None, None)
        tw = (device_arrays(_dif_twiddles, (pad_h, False), dev)
              + device_arrays(_dif_twiddles, (pad_h, True), dev))
    else:
        fs = device_arrays(_fourstep_twiddle, (pad_h, False), dev)
        cw = device_arrays(_combine_matrix, (pad_h // _LANE,), dev)
        tw = (device_arrays(_dif_twiddles, (_LANE, False), dev)
              + device_arrays(_dif_twiddles, (_LANE, True), dev))
    outs = [torch.empty((n, r1 - r0, w), dtype=torch.float32, device=dev)
            for _ in range(2)]
    outs += [torch.empty((planes, pad_h, w), dtype=torch.float32, device=dev)
             for _ in range(2 + len(taps))]
    ints, floats = _phase_args(plan, host is not None)
    ins = ((rows_re, rows_im, prev_re, prev_im) + (taps or (None, None))
           + planes_d + (fy, fx) + fs + cw + tw)
    err = library().pbmm_colspec_chunk(
        *(None if x is None else x.data_ptr()
          for x in ins + tuple(outs) + (None,) * (6 - len(outs))),
        c_ints(ints), c_floats(floats), n // planes, planes, hc, pad_h, w,
        row0, r0, r1, stream_handle(dev))
    check_launch(err, "colspec_chunk")
    colspec_chunk.launches += 1
    return tuple(outs)


colspec_chunk.launches = 0


# ---------------------------------------------------------------------------
# Kernel 6: one frame's band/phase pass + radix-2 column IFFT
# ---------------------------------------------------------------------------


def _phase_col_args(cur_re, cfg, out_rows, fx_values, lp_fast, lp_slow):
    """Validate a phase_col_ifft call; returns (r0, r1)."""
    _, h, _ = cur_re.shape
    check_pow2(h, "radix-2 column height")
    if fx_values is not None:
        raise NotImplementedError(
            "fx_values (the sharded engines' per-shard frequencies) is "
            "ROADMAP item 11")
    if (cfg.temporal.mode == "iir_bandpass") != (lp_fast is not None
                                                 and lp_slow is not None):
        raise ValueError("lp_fast/lp_slow carry planes go with, and only "
                         "with, temporal mode iir_bandpass")
    _phase_plan(cfg)
    r0, r1 = out_rows if out_rows is not None else (0, h)
    if not 0 <= r0 < r1 <= h:
        raise ValueError(f"bad out_rows {out_rows} for H={h}")
    return r0, r1


def phase_col_ifft_ref(cur_re, cur_im, prev_re, prev_im, cfg, out_rows=None,
                       full_w=None, fx_values=None, lp_fast=None,
                       lp_slow=None):
    """Plain PyTorch version of `phase_col_ifft`: per frame,
    `_phase_block_ref` against its prev, the inverse index map and an
    unnormalised inverse FFT down the columns (`colspec_chunk_ref`'s
    inverse half, one frame at a time)."""
    r0, r1 = _phase_col_args(cur_re, cfg, out_rows, fx_values, lp_fast,
                             lp_slow)
    b, h, w = cur_re.shape
    dev = cur_re.device
    host = _static_phase_planes(cfg, h, w, full_w)
    if host is not None:
        host = device_arrays(_static_phase_planes, (cfg, h, w, full_w), dev)
    fy, fx = device_arrays(_freq_tables, (h, w, full_w), dev)
    order = torch.as_tensor(_col_order(h), device=dev)
    out_re = torch.empty((b, r1 - r0, w), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    taps = []
    for f in range(b):
        tap_in = (lp_fast[f], lp_slow[f]) if lp_fast is not None else ()
        res = _phase_block_ref(cur_re[f], cur_im[f], prev_re[f], prev_im[f],
                               fy, fx, cfg, *tap_in, static_planes=host)
        nat = torch.empty((h, w), dtype=torch.complex64, device=dev)
        nat[order] = torch.complex(res[0], res[1])
        z = torch.fft.ifft(nat, dim=0, norm="forward")[r0:r1]
        out_re[f] = z.real
        out_im[f] = z.imag
        taps.append(res[2:])
    return (out_re, out_im) + tuple(torch.stack(t) for t in zip(*taps))


@checked
def phase_col_ifft(cur_re, cur_im, prev_re, prev_im, cfg, out_rows=None,
                   full_w=None, fx_values=None, lp_fast=None, lp_slow=None):
    """(B, H, W) spectra pair in the working layout (bit-reversed rows at
    a pow-2 height H, bit-reversed lanes, the kept Hermitian tiles when
    `full_w` exceeds W) -> the column IFFT of the phase-amplified
    spectrum, spatial rows `out_rows` = (r0, r1) only: (re, im) each
    (B, r1 - r0, W) f32, unnormalised; with the IIR band-pass also the
    new (B, H, W) taps from `lp_fast`/`lp_slow`.  Each frame is amplified
    against its own prev.  `fx_values` (the sharded engines') is not
    ported.

    CPU tensors take `phase_col_ifft_ref`; CUDA tensors launch
    `csrc/phase_col_ifft.cu`."""
    if cur_re.device.type == "cpu":
        return phase_col_ifft_ref(cur_re, cur_im, prev_re, prev_im, cfg,
                                  out_rows, full_w, fx_values, lp_fast,
                                  lp_slow)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    r0, r1 = _phase_col_args(cur_re, cfg, out_rows, fx_values, lp_fast,
                             lp_slow)
    b, h, w = cur_re.shape
    _check_col_height(h)
    if w % PBMM_COL_S:
        raise ValueError(f"the CUDA kernel takes widths that are multiples "
                         f"of {PBMM_COL_S}, got {w}")
    taps = (lp_fast, lp_slow) if lp_fast is not None else ()
    check_cuda("phase_col_ifft", (b, h, w), cur_re, cur_im, prev_re,
               prev_im, *taps)
    dev = cur_re.device
    host = _static_phase_planes(cfg, h, w, full_w)
    planes_d = (device_arrays(_static_phase_planes, (cfg, h, w, full_w),
                              dev) if host is not None else ())
    planes_d = planes_d + (None,) * (2 - len(planes_d))
    fy, fx = device_arrays(_freq_tables, (h, w, full_w), dev)
    twr, twi = device_arrays(_dif_twiddles, (h, True), dev)
    outs = [torch.empty((b, r1 - r0, w), dtype=torch.float32, device=dev)
            for _ in range(2)]
    outs += [torch.empty((b, h, w), dtype=torch.float32, device=dev)
             for _ in taps]
    ints, floats = _phase_args(_phase_plan(cfg), host is not None)
    ins = ((cur_re, cur_im, prev_re, prev_im) + (taps or (None, None))
           + planes_d + (fy, fx, twr, twi))
    err = library().pbmm_phase_col_ifft(
        *(None if x is None else x.data_ptr()
          for x in ins + tuple(outs) + (None,) * (4 - len(outs))),
        c_ints(ints), c_floats(floats), b, h, w, r0, r1,
        stream_handle(dev))
    check_launch(err, "phase_col_ifft")
    phase_col_ifft.launches += 1
    return tuple(outs)


phase_col_ifft.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5: zero-embedded radix-2 column FFT (pow-2 heights)
# ---------------------------------------------------------------------------


def _col_fft_args(re, pad_h: int, row0: int):
    _, hc, _ = re.shape
    check_pow2(pad_h, "radix-2 column height")
    if not 0 <= row0 <= pad_h - hc:
        raise ValueError(f"rows [{row0}, {row0 + hc}) outside pad_h={pad_h}")


def col_fft_zero_padded_ref(re, im, pad_h: int, row0: int = 0):
    """Plain PyTorch version of `col_fft_zero_padded`: `_col_fft_ref`, the
    forward half of `colspec_chunk_ref`, frame by frame."""
    _col_fft_args(re, pad_h, row0)
    order = torch.as_tensor(_col_order(pad_h), device=re.device)
    out_re = torch.empty((re.shape[0], pad_h, re.shape[-1]),
                         dtype=torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    for b in range(re.shape[0]):
        spec = _col_fft_ref(re[b], im[b], pad_h, row0, order)
        out_re[b] = spec.real
        out_im[b] = spec.imag
    return out_re, out_im


@checked
def col_fft_zero_padded(re, im, pad_h: int, row0: int = 0):
    """(B, Hc, W) row spectra of the content rows -> (B, pad_h, W)
    forward column FFT, the content slab zero-embedded at `row0` on chip
    (the zero rows are never read), rows bit-reversed: the radix-2 DIF of
    `colspec_chunk`'s pow-2 branch, the same op sequence, so the spectrum
    of a frame equals the one kernel 2 carries bit for bit.  pow-2
    heights only.

    CPU tensors take `col_fft_zero_padded_ref`; CUDA tensors launch
    `csrc/col_fft.cu`."""
    if re.device.type == "cpu":
        return col_fft_zero_padded_ref(re, im, pad_h, row0)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    _col_fft_args(re, pad_h, row0)
    b, hc, w = re.shape
    _check_col_height(pad_h)
    check_cuda("col_fft_zero_padded", (b, hc, w), re, im)
    dev = re.device
    twr, twi = device_arrays(_dif_twiddles, (pad_h, False), dev)
    out_re = torch.empty((b, pad_h, w), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    err = library().pbmm_col_fft(
        re.data_ptr(), im.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), b, hc, pad_h, w, row0,
        stream_handle(dev))
    check_launch(err, "col_fft_zero_padded")
    col_fft_zero_padded.launches += 1
    return out_re, out_im


col_fft_zero_padded.launches = 0


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


def _row_ifft_args(re, pad_h: int, full_w):
    """Validate a row-IFFT call; returns (full width, 1 / (pad_h W))."""
    _, h, w = re.shape
    fw = full_w if full_w is not None else w
    check_pow2(fw, "row IFFT length")
    if fw % _LANE or w % _LANE:
        raise ValueError(f"widths must be multiples of 128: {w}, {fw}")
    return fw, 1.0 / ((pad_h or h) * fw)


def rebuilt_row_ifft(re, im, fw: int, scale: float,
                     magnitude: bool = True) -> torch.Tensor:
    """|row IFFT| * scale (or Re * scale) of (B, Hb, Wk) bit-reversed kept
    lanes, full width: lane gathers for the rebuild and the bit reversal,
    then `torch.fft` one frame at a time (the plain arithmetic behind
    kernels 3 and 7)."""
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
    out = torch.empty((b, hb, fw), dtype=torch.float32, device=dev)
    for f in range(b):
        x = torch.complex(re[f], im[f])[:, gather]
        x = torch.where(flip, x.conj(), x)
        z = torch.fft.ifft(x, dim=-1, norm="forward")
        out[f] = (torch.sqrt(z.real * z.real + z.imag * z.imag)
                  if magnitude else z.real) * scale
    return out


def row_ifft_magnitude_ref(re, im, magnitude: bool = True, pad_h: int = 0,
                           full_w=None):
    """Plain PyTorch version of `row_ifft_magnitude`."""
    fw, scale = _row_ifft_args(re, pad_h, full_w)
    return rebuilt_row_ifft(re, im, fw, scale, magnitude)


@checked
def row_ifft_magnitude(re, im, magnitude: bool = True, pad_h: int = 0,
                       full_w=None):
    """(B, Hb, Wk) bit-reversed kept-lane rows -> (B, Hb, W) f32 |row
    IFFT| / (pad_h * W), or Re / (pad_h * W) with `magnitude=False`
    (`reconstruct="real"`), full width: the missing tiles are rebuilt as
    conj(lane reversal) of kept ones (`reconstruction_plan`) when
    `full_w` exceeds Wk.  `pad_h` (default Hb) is the padded height of
    the normalisation.

    CPU tensors take `row_ifft_magnitude_ref`; CUDA tensors launch
    `csrc/row_ifft.cu`."""
    if re.device.type == "cpu":
        return row_ifft_magnitude_ref(re, im, magnitude, pad_h, full_w)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    fw, scale = _row_ifft_args(re, pad_h, full_w)
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
        float(scale), int(magnitude), stream_handle(dev))
    check_launch(err, "row_ifft_magnitude")
    row_ifft_magnitude.launches += 1
    return out


row_ifft_magnitude.launches = 0
