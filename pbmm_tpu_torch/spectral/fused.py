"""The fused spectral stages: kernels 1, 4, the front end, 2, 6, 5 and 7.

Counterpart of `pbmm_tpu/spectral/fused.py`:

  `windowed_row_fft`           Hann window x row FFT, Hermitian kept
                               tiles out (CUDA: `csrc/row_fft.cu`);
  `windowed_row_fft_u8planar`  the same from (T, 3, H, W) uint8 frames:
                               luma, pad and window inside the kernel
                               (CUDA: `csrc/row_fft.cu`, second entry);
  `windowed_row_fft_frames`    the same from the frames in every input
                               form of the batched chunk engine, one
                               plane (Y) or three (Y, I, Q): the front
                               end (the same kernel as kernel 4);
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

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pbmm_tpu_torch.core.color import channel_mix, is_planar, unit_float
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
    device_arrays,
    device_ints,
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
    compact_twiddles,
)
from pbmm_tpu_torch.utils.profiling import counted

_ROW_BLOCK = 64  # row quantum of the content/output row windows
_LANE = 128
# The longest sequence the CUDA block engines hold (csrc/col_pass.cuh
# PBMM_BK_N): longer pow-2 columns run bracket passes through device
# memory around them, on a scratch of the whole planes.  A row of up to
# ROW_BLOCK_N lanes fits one block of the row engine (row_pass.cuh
# PBMM_RP_BLOCKN); longer rows are bracketed on BLOCK_N-lane blocks.
BLOCK_N = 8192
ROW_BLOCK_N = 16384


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


def kept_positions(w: int, tiles: tuple):
    """(positions,): the kept position of each of the w / 128 tiles of a
    row (-1 where the tile is not kept), the device table kernels 1 and 4
    read."""
    pos = np.full(w // _LANE, -1, np.int32)
    pos[list(tiles)] = np.arange(len(tiles), dtype=np.int32)
    return (pos,)


def _scratch(shape, big: bool, device):
    """The (re, im) scratch planes a bracketed transform runs through
    (`big`: a row above `ROW_BLOCK_N` lanes, a column above `BLOCK_N` rows
    or above m = 64), else two Nones."""
    if not big:
        return None, None
    return tuple(torch.empty(shape, dtype=torch.float32, device=device)
                 for _ in range(2))


def aligned16(*xs):
    """The tensors, each copied where its data does not start on 16 bytes
    (a view's offset): the phase strip's asynchronous copies read 16-byte
    words (csrc/phase_inv.cuh)."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def _ptrs(*xs):
    """Device pointers of tensors (None stays a null)."""
    return tuple(None if x is None else x.data_ptr() for x in xs)


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
    `csrc/row_fft.cu::pbmm_row_fft` (the row engine of
    `csrc/row_pass.cuh`, one block a row up to 16384 lanes; longer rows
    bracketed through a scratch, `csrc/col_pass.cuh`), which refuses
    misaligned planes."""
    if y.device.type == "cpu":
        return windowed_row_fft_ref(y, pad_h, row0, keep_half)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    b, h, w = y.shape
    pad_h, tiles, wk = _row_args(y, pad_h, row0, keep_half)
    check_cuda("windowed_row_fft", (b, h, w), y)
    wy, wx = device_arrays(_hann_pair, (pad_h, w), y.device)
    twr, twi = device_arrays(compact_twiddles, (w, False), y.device)
    (pos,) = device_ints(kept_positions, (w, tuple(tiles)), y.device)
    out_re = torch.empty((b, h, wk), dtype=torch.float32, device=y.device)
    out_im = torch.empty_like(out_re)
    sc = _scratch((b * h, w), w > ROW_BLOCK_N, y.device)
    err = library().pbmm_row_fft(
        y.data_ptr(), wy[row0:row0 + h].data_ptr(), wx.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        c_ints(tiles), pos.data_ptr(), len(tiles), b, h, w, *_ptrs(*sc),
        stream_handle(y.device))
    check_launch(err, "windowed_row_fft")
    windowed_row_fft.launches += 1
    return out_re, out_im


counted(windowed_row_fft)


# ---------------------------------------------------------------------------
# Kernel 4 and the front end: windowed row FFT straight from the frames
# ---------------------------------------------------------------------------


def _frames_args(frames, pad_h: int, pad_w: int, y0: int, x0: int,
                 row0: int):
    """Validate a call on source frames; returns (planar, Hc, off): the
    layout, the content-row window [row0, row0 + Hc) of the padded frame
    and the row offset off = y0 - row0 of frame row 0 inside it (the JAX
    kernel's geometry)."""
    planar = is_planar(frames)
    if (frames.ndim != 4 or not (planar or frames.shape[-1] == 3)
            or frames.dtype not in (torch.uint8, torch.float32)):
        raise ValueError(f"expected (T, 3, H, W) or (T, H, W, 3) uint8 or "
                         f"f32 frames, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    h_in, w_in = frames.shape[-2:] if planar else frames.shape[1:3]
    r1 = min(pad_h, -(-(y0 + h_in) // _ROW_BLOCK) * _ROW_BLOCK)
    hc, off = r1 - row0, y0 - row0
    if not (0 <= off < _ROW_BLOCK and hc % _ROW_BLOCK == 0
            and 0 <= x0 <= pad_w - w_in):
        raise ValueError(f"frames of {h_in}x{w_in} do not sit at "
                         f"({y0}, {x0}) of the rows from {row0} of a "
                         f"{pad_h}x{pad_w} pad")
    return planar, hc, off


def frames_slab(frames, coeff_rows, pad_w: int, x0: int, off: int,
                hc: int) -> torch.Tensor:
    """The torch pre stage of the front end: `unit_float`, one
    `channel_mix` a colour row, the planes stacked plane-minor
    frame-major, and the centre pad into the Hc content rows of the
    padded width: (T * len(coeff_rows), Hc, pad_w) f32."""
    f = unit_float(frames)
    rgb = ((f[:, 0], f[:, 1], f[:, 2]) if is_planar(frames)
           else (f[..., 0], f[..., 1], f[..., 2]))
    planes = [channel_mix(*rgb, row) for row in coeff_rows]
    y = planes[0] if len(planes) == 1 else torch.stack(
        planes, dim=-3).reshape((-1,) + tuple(planes[0].shape[-2:]))
    h_in, w_in = y.shape[-2:]
    return F.pad(y, (x0, pad_w - w_in - x0, off, hc - off - h_in))


def windowed_row_fft_frames_ref(frames, coeff_rows, pad_h: int, pad_w: int,
                                y0: int, x0: int, row0: int,
                                keep_half: bool = False):
    """Plain PyTorch version of `windowed_row_fft_frames`: `frames_slab`
    (the torch pre stage), then `windowed_row_fft_ref`."""
    _, hc, off = _frames_args(frames, pad_h, pad_w, y0, x0, row0)
    return windowed_row_fft_ref(
        frames_slab(frames, coeff_rows, pad_w, x0, off, hc), pad_h, row0,
        keep_half)


def _row_fft_frames(name, frames, coeff_rows, pad_h, pad_w, y0, x0, row0,
                    keep_half):
    """Launch `csrc/row_fft.cu::pbmm_row_fft_frames` (kernel 4 and the
    front end) on CUDA frames; returns (re, im)."""
    from pbmm_tpu_torch.kernels.build import check_launch, library

    planar, hc, off = _frames_args(frames, pad_h, pad_w, y0, x0, row0)
    t = frames.shape[0]
    h_in, w_in = frames.shape[-2:] if planar else frames.shape[1:3]
    check_pow2(pad_w, "row FFT length")
    if pad_w % _LANE:
        raise ValueError(f"the CUDA row kernel takes multiples of 128 "
                         f"lanes, got {pad_w}")
    if len(coeff_rows) not in (1, 3):
        raise ValueError(f"{name} forms 1 or 3 planes, got "
                         f"{len(coeff_rows)} colour rows")
    check_cuda(name, tuple(frames.shape), frames, dtype=frames.dtype)
    tiles = kept_tiles(pad_w) if keep_half else list(range(pad_w // _LANE))
    wk = len(tiles) * _LANE
    n = t * len(coeff_rows)
    dev = frames.device
    wy, wx = device_arrays(_hann_pair, (pad_h, pad_w), dev)
    twr, twi = device_arrays(compact_twiddles, (pad_w, False), dev)
    (pos,) = device_ints(kept_positions, (pad_w, tuple(tiles)), dev)
    out_re = torch.empty((n, hc, wk), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    sc = _scratch((n * hc, pad_w), pad_w > ROW_BLOCK_N, dev)
    err = library().pbmm_row_fft_frames(
        frames.data_ptr(), c_floats(np.ravel(coeff_rows)),
        wy[row0:row0 + hc].data_ptr(), wx.data_ptr(), twr.data_ptr(),
        twi.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), c_ints(tiles),
        pos.data_ptr(), int(frames.dtype == torch.uint8), int(planar),
        len(coeff_rows), len(tiles), t, hc, h_in, w_in, pad_w, off, x0,
        float(np.float32(1.0 / 255.0)), *_ptrs(*sc), stream_handle(dev))
    check_launch(err, name)
    return out_re, out_im


@checked
def windowed_row_fft_frames(frames, coeff_rows, pad_h: int, pad_w: int,
                            y0: int, x0: int, row0: int,
                            keep_half: bool = False):
    """(T, 3, H, W) or (T, H, W, 3) uint8 or f32 frames -> row FFT of the
    windowed planes of the padded frame, the batched chunk engine's front
    end: for each of the colour rows `coeff_rows` (one, Y; or three, Y,
    I, Q) the plane coeffs . unit_float(rgb) in the pre stage's op order,
    the centre pad at (y0, x0) of the pad_h x pad_w frame, the content
    rows [row0, row0 + Hc) of `aligned_row_window`, the Hann window and
    kernel 1's row FFT.  Returns (re, im) each (T * planes, Hc, Wk) f32,
    plane-minor frame-major; equal bit for bit to the torch pre stage
    (`frames_slab`) + `windowed_row_fft` on the same frames.  The JAX
    package leaves this pre stage to XLA (`pbmm_tpu/engine/pipeline.py:
    171 preprocess_cl`); here no YIQ plane or padded slab is built.

    CPU tensors take `windowed_row_fft_frames_ref`; CUDA tensors launch
    `csrc/row_fft.cu::pbmm_row_fft_frames` (kernel 4's kernel on the row
    engine of `csrc/row_pass.cuh`, templated on the element type, runtime
    strides for the layout; rows above 16384 lanes bracketed through a
    scratch)."""
    if frames.device.type == "cpu":
        return windowed_row_fft_frames_ref(frames, coeff_rows, pad_h, pad_w,
                                           y0, x0, row0, keep_half)
    out = _row_fft_frames("windowed_row_fft_frames", frames, coeff_rows,
                          pad_h, pad_w, y0, x0, row0, keep_half)
    windowed_row_fft_frames.launches += 1
    return out


counted(windowed_row_fft_frames)


def _u8_args(frames, pad_h: int, pad_w: int, y0: int, x0: int, row0: int):
    """Validate a call of kernel 4; returns (Hc, off) as `_frames_args`."""
    if (frames.ndim != 4 or frames.shape[1] != 3
            or frames.dtype != torch.uint8):
        raise ValueError(f"expected (T, 3, H, W) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    return _frames_args(frames, pad_h, pad_w, y0, x0, row0)[1:]


def windowed_row_fft_u8planar_ref(frames, coeffs, pad_h: int, pad_w: int,
                                  y0: int, x0: int, row0: int,
                                  keep_half: bool = False):
    """Plain PyTorch version of `windowed_row_fft_u8planar`: the pre
    stage's `unit_float` and luma FMA, the centre pad, then
    `windowed_row_fft_ref` (bit-identical to the f32 path by
    construction)."""
    _u8_args(frames, pad_h, pad_w, y0, x0, row0)
    return windowed_row_fft_frames_ref(frames, (coeffs,), pad_h, pad_w, y0,
                                       x0, row0, keep_half)


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
    The JAX package's u8 route; `windowed_row_fft_frames` on these
    frames with the one row.

    CPU tensors take `windowed_row_fft_u8planar_ref`; CUDA tensors launch
    `csrc/row_fft.cu::pbmm_row_fft_frames` (the row engine of
    `csrc/row_pass.cuh`; rows above 16384 lanes bracketed through a
    scratch)."""
    if frames.device.type == "cpu":
        return windowed_row_fft_u8planar_ref(frames, coeffs, pad_h, pad_w,
                                             y0, x0, row0, keep_half)
    _u8_args(frames, pad_h, pad_w, y0, x0, row0)
    out = _row_fft_frames("windowed_row_fft_u8planar", frames, (coeffs,),
                          pad_h, pad_w, y0, x0, row0, keep_half)
    windowed_row_fft_u8planar.launches += 1
    return out


counted(windowed_row_fft_u8planar)


# ---------------------------------------------------------------------------
# Kernel 2: column FFT + band/phase + column IFFT over a chunk
# ---------------------------------------------------------------------------

_COMBINE_MAX_PARAM = 32  # largest m whose combine is a kernel parameter
_MAX_ORIENTATIONS = 16  # sector count of the CUDA phase pass (CS_MAXK)
_MAX_LEVELS = 16  # radial levels of the CUDA phase pass (CS_MAXB)
_MASK_KINDS = ("zero", "high", "low", "band")


def col_strip(h: int) -> int:
    """The narrowest strip of kernel 6 (and of kernel 12, which takes
    kernel 6's strips) at column height h: 4 up to 2048 rows, 2 up to
    4096, 1 above (taller pow-2 columns run on their 8192-row blocks)
    (csrc/common.cuh::pbmm_col_strip); their widths are multiples of
    it."""
    return 4 if h <= 2048 else 2 if h <= 4096 else 1


def colspec_strip(h: int) -> int:
    """Columns a block of kernel 2 holds at column height h: the widest
    power of two up to 16 whose strip (2 h S floats) fits a block's 227
    KB, 2 at least: 16 to 1024 rows (pow-2) or m = 14 (tight), 8 to 2048
    or m = 28, 4 to 4096 or m = 32, 2 above (pow-2 columns above 8192 on
    their 8192-row blocks; the tight heights at m = 33-63 keep 2 for their
    256-thread blocks), and 4 above m = 64, the strip of the chunk kernels
    (csrc/colspec_chunk.cu::cs_strip); its widths are multiples of it."""
    m = h // _LANE
    if _is_pow2(h):
        return 16 if h <= 1024 else 8 if h <= 2048 else 4 if h <= 4096 else 2
    return (16 if m <= 14 else 8 if m <= 28 else 4
            if m <= _COMBINE_MAX_PARAM else 2 if m < 64 else 4)


# A block's and an SM's shared memory on the H100, the card's reserve a
# block, and the words a thread's ring of the phase strip runs ahead
# (csrc/phase_inv.cuh).
_SMEM_BLOCK, _SMEM_SM, _SMEM_RESERVE = 232448, 233472, 1024
PS_MAXD = 4


def phase_strip_smem(h: int, s: int, threads: int = 512,
                     words: int = 4) -> int:
    """Dynamic shared memory (bytes) of a launch of the phase strip
    (kernel 2's launch 2, kernels 6 and 12) at height h on strips of s
    columns, `threads` a block (csrc/phase_inv.cuh::pbmm_ps_smem): the
    strip, 2 h s f32, and on strips of 4 and more a ring of up to
    `PS_MAXD` slots of a thread's `words` 16-byte words (4 on the main
    branch: prev and the two host planes; 2 for kernel 12's stream; 0 on
    the general pass, which keeps the element loads), in the room the strip
    leaves one block without lowering the blocks an SM its shared memory
    allows (at most 2048 threads an SM)."""
    strip, slot = 8 * h * s, 16 * words * threads
    if s < 4 or words < 1:
        return strip
    nb = min(2048 // threads, _SMEM_SM // (strip + _SMEM_RESERVE))
    top = min(_SMEM_SM // max(nb, 1) - _SMEM_RESERVE, _SMEM_BLOCK)
    return strip + min(max(top - strip, 0) // slot, PS_MAXD) * slot


def colspec_staged(h: int, general: bool = False) -> bool:
    """Whether kernel 2's launch 2 at column height h runs its phase pass
    on asynchronous copies (csrc/phase_inv.cuh::pbmm_ps_async: the main
    branch on strips of 4 columns and more, `colspec_strip`), the host's
    mirror of what the C entry reports and `colspec_chunk.staged` counts.
    Never on the general pass (`_phase_general`: the IIR taps among
    others), which keeps the element loads."""
    return not general and colspec_strip(h) >= 4


def phase_col_strip(h: int, w: int) -> int:
    """Columns a block of kernel 6 holds at column height h and width w:
    kernel 2's strip (`colspec_strip`), or the widest half of it that
    divides w, down to `col_strip(h)` (csrc/phase_col_ifft.cu); above
    `BLOCK_N` rows, the strip of the 8192-row blocks it runs on."""
    h = min(h, BLOCK_N)
    s = colspec_strip(h)
    while w % s and s > col_strip(h):
        s //= 2
    return s


def colspec_big(h: int) -> bool:
    """Whether kernel 2 runs a column of height h through device memory
    (a second scratch spectrum): pow-2 heights above `BLOCK_N` (the
    bracket) and tight heights above m = 64 (the combine pass)."""
    return h > BLOCK_N if _is_pow2(h) else h // _LANE > 64


def bracket_plan(n: int, inverse: bool):
    """The bracket of a radix-2 transform of length n
    (csrc/col_pass.cuh::pbmm_bracket_plan): a (k, lst, s0) per pass
    through device memory, the outer log2(n) - 13 stages (spans `BLOCK_N`
    and up) split into passes of at most 6, the longer first; k stages a
    pass, its stride 2^lst, s0 the bracket's stages before it (the C plan
    counts the whole transform's: 13 more on the inverse).  Empty at n <=
    `BLOCK_N`."""
    check_pow2(n)
    stages = n.bit_length() - 1
    outer = stages - (BLOCK_N.bit_length() - 1)
    if outer <= 0:
        return ()
    np_ = -(-outer // 6)
    plan, s0 = [], 0
    for i in range(np_):
        k = outer // np_ + (1 if i < outer % np_ else 0)
        lst = (BLOCK_N.bit_length() - 1 + s0) if inverse else stages - s0 - k
        plan.append((k, lst, s0))
        s0 += k
    return tuple(plan)


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
    weight: tuple  # the standard weight's terms (`_weight_terms`)


def _weight_terms(cfg):
    """The standard mode's weight w(f) as the JAX kernel evaluates it
    per bin (`_standard_weight_block`): ((bandpass, integer steepness or
    -1), (1 / 0.707, low and high cutoff, 1 / max(lc, 1e-3),
    1 / max(1 - hc, 1e-3), steepness, sensitivity, edge gain or 0,
    hc - lc)), the floats as f32."""
    lc, hc = float(cfg.low_freq_cutoff), float(cfg.high_freq_cutoff)
    steep = float(cfg.filter_steepness)
    steep_pow = int(steep) if steep.is_integer() and 0 <= steep <= 16 else -1
    edge = float(cfg.edge_enhancement) if cfg.enhance_edges else 0.0
    floats = (1.0 / 0.707, lc, hc, 1.0 / max(lc, 1e-3),
              1.0 / max(1.0 - hc, 1e-3), steep,
              float(cfg.motion_sensitivity), edge, hc - lc)
    return ((int(cfg.apply_bandpass), steep_pow),
            tuple(np.float32(v) for v in floats))


def standard_weight_block(freq, cfg):
    """The standard mode's weight w(f) at the bins' frequencies `freq`,
    in f32, as kernel 6 evaluates it per bin where no host plane serves
    (the sharded engines' per-shard frequencies; JAX
    `_standard_weight_block`, `fused.py:619-646`; `standard_weight` is
    the host plane's f64 form)."""
    (bandpass, steep_pow), (f_scale, lc, hc, inv_lo, inv_hi, steep, sens,
                            edge, mid_span) = _weight_terms(cfg)
    f = torch.clamp_max(freq * f_scale, 1.0)
    if not bandpass:
        return torch.ones_like(f)

    def pw(x):
        if steep_pow >= 0:
            return _pow_int(x, steep_pow)
        return torch.exp(steep * torch.log(torch.clamp_min(x, 1e-38)))

    w = torch.ones_like(f)
    w = torch.where(f < lc, pw(f * inv_lo), w)
    w = torch.where(f > hc, pw((1.0 - f) * inv_hi), w)
    w = w * sens
    if edge:
        t = torch.clamp((f - lc) / mid_span, 0.0, 1.0)
        s = torch.cos(np.float32(np.pi) * (t - np.float32(0.5)))
        w = torch.where((f > lc) & (f < hc), w * (1.0 + edge * s), w)
    return torch.clamp_min(w, 0.0)


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
                      np.float32(s), np.float32(r_hi), np.float32(r_lo),
                      _weight_terms(cfg))


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
      plane (or `standard_weight_block` at each bin's frequency when
      `static_planes` is None), bins under the magnitude gate passed
      through;
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
        w = (static_planes[0] if static_planes is not None
             else standard_weight_block(torch.sqrt(fy * fy + fx * fx), cfg))
        theta = delta * w * plan.scale
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


def _phase_general(ints) -> bool:
    """csrc/phase_pass.cuh::pbmm_phase_general on `_phase_args`' ints:
    whether the phase pass runs its general branch (the IIR taps, standard
    mode, no host planes, steerable sectors or a non-integer scale) rather
    than the main path's."""
    iir, standard, host_planes, steer, power = ints[:5]
    return bool(iir or standard or not host_planes or steer or power < 0)


def _phase_args(plan: _PhasePlan, host_planes: bool):
    """(ints, floats) of csrc/phase_pass.cuh's PhaseArgs, in its field
    order; standard mode without host planes carries its weight's terms
    (`std_weight`)."""
    bands = () if host_planes or plan.standard else plan.params
    pad = _MAX_LEVELS - len(bands)
    ints = [int(plan.iir), int(plan.standard), int(host_planes), plan.steer,
            plan.power, len(bands)]
    ints += [_MASK_KINDS.index(b[0]) for b in bands] + [0] * pad
    ints += [int(b[3]) for b in bands] + [0] * pad
    std_weight = plan.standard and not host_planes
    w_ints, w_floats = plan.weight if std_weight else ((0, 0), (0.0,) * 9)
    ints += [int(std_weight), *w_ints]
    k = max(plan.steer, 1)
    norm, cos2p, sin2p = _sector_consts(k)
    floats = [plan.tau2, plan.scale, plan.r_hi, plan.r_lo, norm]
    floats += cos2p + [0.0] * (_MAX_ORIENTATIONS - k)
    floats += sin2p + [0.0] * (_MAX_ORIENTATIONS - k)
    for col in (1, 2):
        floats += [b[col] for b in bands] + [0.0] * pad
    floats += [b[2] - b[1] for b in bands] + [0.0] * pad
    floats += list(w_floats)
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
    `csrc/colspec_chunk.cu`: the forward spectra of all frames go to a
    scratch tensor first, and the frames' phase passes and inverses then
    run in parallel (two launches, counted as one call; the call adds 1
    to `colspec_chunk.staged` where the C entry reports that the second
    brings its operands in by asynchronous copies, the rule
    `colspec_staged` mirrors); with the IIR taps a scan
    between them walks each bin's frames in order (three launches; the
    third brings the rotated spectra in by asynchronous copies, and the
    call adds 1 to `colspec_chunk.copied` where the C entry reports it).
    Above 8192 rows (pow-2) the two launches run on every
    8192-row block between a forward and an inverse bracket pass, and
    above m = 64 (tight) the four-step's combine runs as a pass of its
    own; both through a second scratch (`colspec_big`).  Any padded
    height; planes that start on 16 bytes."""
    if rows_re.device.type == "cpu":
        return colspec_chunk_ref(rows_re, rows_im, prev_re, prev_im, cfg,
                                 pad_h, row0, lp_fast, lp_slow, out_rows,
                                 full_w, planes)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    r0, r1 = _colspec_args(rows_re, cfg, pad_h, row0, out_rows, planes,
                           lp_fast, lp_slow)
    n, hc, w = rows_re.shape
    if w % colspec_strip(pad_h):
        raise ValueError(f"the CUDA kernel 2 takes widths that are multiples "
                         f"of {colspec_strip(pad_h)} at H = {pad_h}, got {w}")
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
    # Twiddles: the compact table of n = 128 at tight heights, else H.
    n_tw = pad_h if _is_pow2(pad_h) else _LANE
    tw = (device_arrays(compact_twiddles, (n_tw, False), dev)
          + device_arrays(compact_twiddles, (n_tw, True), dev))
    if _is_pow2(pad_h):
        fs, cw, cwd = (None, None), (None, None), (None, None)
    else:
        m = pad_h // _LANE
        fs = device_arrays(_fourstep_twiddle, (pad_h, False), dev)
        cw = tuple(c_floats(a.ravel())  # host arrays: passed by value
                   for a in _combine_matrix(m))
        cwd = (device_arrays(_combine_matrix, (m,), dev)
               if m > _COMBINE_MAX_PARAM else (None, None))
    spec = tuple(torch.empty((n, pad_h, w), dtype=torch.float32, device=dev)
                 for _ in range(2))
    spec2 = _scratch((n, pad_h, w), colspec_big(pad_h), dev)
    outs = [torch.empty((n, r1 - r0, w), dtype=torch.float32, device=dev)
            for _ in range(2)]
    outs += [torch.empty((planes, pad_h, w), dtype=torch.float32, device=dev)
             for _ in range(2 + len(taps))]
    ints, floats = _phase_args(plan, host is not None)
    ins = ((rows_re, rows_im, prev_re, prev_im) + (taps or (None, None))
           + planes_d + (fy, fx) + fs + cw + cwd + tw + spec)
    staged, copied = ctypes.c_int(0), ctypes.c_int(0)
    err = library().pbmm_colspec_chunk(
        *(x.data_ptr() if torch.is_tensor(x) else x
          for x in ins + tuple(outs) + (None,) * (6 - len(outs)) + spec2),
        c_ints(ints), c_floats(floats), n // planes, planes, hc, pad_h, w,
        row0, r0, r1, ctypes.byref(staged), ctypes.byref(copied),
        stream_handle(dev))
    check_launch(err, "colspec_chunk")
    colspec_chunk.launches += 1
    colspec_chunk.staged += staged.value
    colspec_chunk.copied += copied.value
    return tuple(outs)


counted(colspec_chunk)
# Calls whose launch 2 ran the phase pass on asynchronous copies, and calls
# whose launch 3 (after the IIR tap scan) brought the rotated spectra in by
# asynchronous copies, as the C entry reports them (`colspec_staged`
# mirrors the first rule); not launch counters.
colspec_chunk.staged = 0
colspec_chunk.copied = 0


# ---------------------------------------------------------------------------
# Kernel 6: one frame's band/phase pass + radix-2 column IFFT
# ---------------------------------------------------------------------------


def _phase_col_args(cur_re, cfg, out_rows, fx_values, lp_fast, lp_slow):
    """Validate a phase_col_ifft call; returns (r0, r1)."""
    _, h, w = cur_re.shape
    check_pow2(h, "radix-2 column height")
    if fx_values is not None and (
            tuple(fx_values.shape) != (w,)
            or fx_values.dtype != torch.float32
            or fx_values.device != cur_re.device):
        raise ValueError(f"fx_values must be a ({w},) f32 tensor on "
                         f"{cur_re.device}, got {tuple(fx_values.shape)} "
                         f"{fx_values.dtype} on {fx_values.device}")
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
    host, fy, fx = _phase_col_tables(cfg, h, w, full_w, fx_values, dev)
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


def _phase_col_tables(cfg, h: int, w: int, full_w, fx_values, dev):
    """(host planes or None, fy (h, 1), fx (1, w)) of a kernel 6 call:
    with `fx_values` those are the lane frequencies and no host plane
    serves (JAX `phase_col_ifft`, `fused.py:1038-1041`, `:1111`)."""
    fy, fx = device_arrays(_freq_tables, (h, w, full_w), dev)
    if fx_values is not None:
        return None, fy, fx_values.reshape(1, w)
    host = None
    if _static_phase_planes(cfg, h, w, full_w) is not None:
        host = device_arrays(_static_phase_planes, (cfg, h, w, full_w), dev)
    return host, fy, fx


@checked
def phase_col_ifft(cur_re, cur_im, prev_re, prev_im, cfg, out_rows=None,
                   full_w=None, fx_values=None, lp_fast=None, lp_slow=None):
    """(B, H, W) spectra pair in the working layout (bit-reversed rows at
    a pow-2 height H, bit-reversed lanes, the kept Hermitian tiles when
    `full_w` exceeds W) -> the column IFFT of the phase-amplified
    spectrum, spatial rows `out_rows` = (r0, r1) only: (re, im) each
    (B, r1 - r0, W) f32, unnormalised; with the IIR band-pass also the
    new (B, H, W) taps from `lp_fast`/`lp_slow`.  Each frame is amplified
    against its own prev.  `fx_values`, a (W,) f32 tensor beside the
    spectra, gives each lane's frequency in place of the table of the
    layout (the sharded engines pass a shard's slice of
    `bitrev_freq_axis(W_full)`); no host plane serves then, and the masks,
    the sector windows and the standard mode's weight are evaluated at
    each bin.

    CPU tensors take `phase_col_ifft_ref`; CUDA tensors launch
    `csrc/phase_col_ifft.cu`, kernel 2's phase pass and inverse on strips
    of `phase_col_strip(H, W)` columns, all frames at once (above 8192
    rows on every 8192-row block into a scratch, then the inverse
    bracket)."""
    if cur_re.device.type == "cpu":
        return phase_col_ifft_ref(cur_re, cur_im, prev_re, prev_im, cfg,
                                  out_rows, full_w, fx_values, lp_fast,
                                  lp_slow)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    r0, r1 = _phase_col_args(cur_re, cfg, out_rows, fx_values, lp_fast,
                             lp_slow)
    b, h, w = cur_re.shape
    if w % col_strip(h):
        raise ValueError(f"the CUDA kernel takes widths that are multiples "
                         f"of {col_strip(h)} at H = {h}, got {w}")
    taps = (lp_fast, lp_slow) if lp_fast is not None else ()
    check_cuda("phase_col_ifft", (b, h, w), cur_re, cur_im, prev_re,
               prev_im, *taps)
    cur_re, cur_im, prev_re, prev_im = aligned16(cur_re, cur_im, prev_re,
                                                 prev_im)
    dev = cur_re.device
    host, fy, fx = _phase_col_tables(cfg, h, w, full_w, fx_values, dev)
    planes_d = (host or ()) + (None,) * (2 - len(host or ()))
    fx = fx.contiguous()
    twr, twi = device_arrays(compact_twiddles, (h, True), dev)
    outs = [torch.empty((b, r1 - r0, w), dtype=torch.float32, device=dev)
            for _ in range(2)]
    outs += [torch.empty((b, h, w), dtype=torch.float32, device=dev)
             for _ in taps]
    ints, floats = _phase_args(_phase_plan(cfg), host is not None)
    ins = ((cur_re, cur_im, prev_re, prev_im) + (taps or (None, None))
           + planes_d + (fy, fx, twr, twi))
    sc = _scratch((b, h, w), h > BLOCK_N, dev)
    err = library().pbmm_phase_col_ifft(
        *_ptrs(*(ins + tuple(outs) + (None,) * (4 - len(outs)) + sc)),
        c_ints(ints), c_floats(floats), b, h, w, r0, r1,
        phase_col_strip(h, w), stream_handle(dev))
    check_launch(err, "phase_col_ifft")
    phase_col_ifft.launches += 1
    return tuple(outs)


counted(phase_col_ifft)


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
    heights only (any, on the card: three passes at 16384).

    CPU tensors take `col_fft_zero_padded_ref`; CUDA tensors launch
    `csrc/col_fft.cu`."""
    if re.device.type == "cpu":
        return col_fft_zero_padded_ref(re, im, pad_h, row0)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    _col_fft_args(re, pad_h, row0)
    b, hc, w = re.shape
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


counted(col_fft_zero_padded)


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


def lane_plan_tables(wk: int, w: int):
    """`lane_plan` as the two int tables kernel 7 reads: the source kept
    tile and the conj-reversed flag of each of the w / 128 tiles."""
    plan = np.asarray(lane_plan(wk, w), np.int32).reshape(-1, 2)
    return plan[:, 0].copy(), plan[:, 1].copy()


def _row_ifft_args(re, pad_h: int, full_w):
    """Validate a row-IFFT call; returns (full width, 1 / (pad_h W))."""
    _, h, w = re.shape
    fw = full_w if full_w is not None else w
    check_pow2(fw, "row IFFT length")
    if fw % _LANE or w % _LANE:
        raise ValueError(f"widths must be multiples of 128: {w}, {fw}")
    return fw, 1.0 / ((pad_h or h) * fw)


@functools.lru_cache(maxsize=16)
def _rebuild_index(wk: int, fw: int):
    """(kept lane, conjugated) of each of the fw bit-reversed positions:
    the Hermitian rebuild of `lane_plan` as a gather."""
    src, flip = [], []
    for kp, rev in lane_plan(wk, fw):
        lanes = np.arange(_LANE)
        src.append(kp * _LANE + (_LANE - 1 - lanes if rev else lanes))
        flip.append(np.full(_LANE, bool(rev)))
    return np.concatenate(src), np.concatenate(flip)


def rebuild_lanes(re, im, fw: int):
    """(..., Wk) bit-reversed kept lanes -> the (re, im) (..., fw) rows
    they stand for, still bit-reversed: each missing tile conj(lane
    reversal) of its kept partner, by torch gathers.  Kernel 7's input
    as kernel 8's row pass takes it (`tests/test_torch_cuda.py`)."""
    src, flip = _rebuild_index(re.shape[-1], fw)
    src = torch.as_tensor(src, device=re.device)
    flip = torch.as_tensor(flip, device=re.device)
    xi = im[..., src]
    return (re[..., src].contiguous(),
            torch.where(flip, -xi, xi).contiguous())


def rebuilt_row_ifft(re, im, fw: int, scale: float,
                     magnitude: bool = True) -> torch.Tensor:
    """|row IFFT| * scale (or Re * scale) of (B, Hb, Wk) bit-reversed kept
    lanes, full width: lane gathers for the rebuild and the bit reversal,
    then `torch.fft` one frame at a time (the plain arithmetic behind
    kernels 3 and 7)."""
    b, hb, wk = re.shape
    dev = re.device
    src, flip = _rebuild_index(wk, fw)
    # Natural lane k holds bit-reversed position rev(k).
    perm = bit_reverse_permutation(fw)
    gather = torch.as_tensor(src[perm], device=dev)
    flip = torch.as_tensor(flip[perm], device=dev)
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
    `csrc/row_ifft.cu` (the row engine of `csrc/row_pass.cuh`; rows above
    16384 lanes bracketed through a scratch)."""
    if re.device.type == "cpu":
        return row_ifft_magnitude_ref(re, im, magnitude, pad_h, full_w)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    fw, scale = _row_ifft_args(re, pad_h, full_w)
    b, hb, wk = re.shape
    check_cuda("row_ifft_magnitude", (b, hb, wk), re, im)
    dev = re.device
    twr, twi = device_arrays(compact_twiddles, (fw, True), dev)
    src, rev = device_ints(lane_plan_tables, (wk, fw), dev)
    out = torch.empty((b, hb, fw), dtype=torch.float32, device=dev)
    sc = _scratch((b * hb, fw), fw > ROW_BLOCK_N, dev)
    err = library().pbmm_row_ifft(
        re.data_ptr(), im.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out.data_ptr(), src.data_ptr(), rev.data_ptr(), fw // _LANE, b, hb,
        wk, fw, float(scale), int(magnitude), *_ptrs(*sc),
        stream_handle(dev))
    check_launch(err, "row_ifft_magnitude")
    row_ifft_magnitude.launches += 1
    return out


counted(row_ifft_magnitude)
