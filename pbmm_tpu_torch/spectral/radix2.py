"""The radix-2 transforms of the bit-reversed spectral layout: host
tables and kernel 8.

Counterpart of `pbmm_tpu/spectral/pallas_fft.py`: the bit-reversal table,
the frequency value of each bit-reversed bin, the per-stage twiddle
vectors, and `_fft_axis` (kernel 8, CUDA: `csrc/fft_axis.cu`) with the 2D
transforms `fft2_bitrev` / `ifft2_bitrev` of the unfused
`fft_backend="pallas"` path.  The forward transform is decimation in
frequency (natural order in, bit-reversed out) and the inverse is
decimation in time (bit-reversed in, natural out), so the permutations
cancel across forward -> phase -> inverse and never run as a gather.

The CUDA kernels of this package read `_dif_twiddles` as their twiddle
tables (the row engine of kernels 1, 4, 7 and 8's row pass, and kernel
2, its `compact_twiddles`), so
both packages use the same f64-derived f32 constants.  The
TPU kernel's 128 x 128 group matmul and its bf16 split work around the
TPU's matmul precision; here every stage is an f32 butterfly, and
`MagnifyConfig.gm_precision` changes nothing.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pbmm_tpu_torch.kernels import (
    check_cuda,
    checked,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.utils.profiling import counted


def check_pow2(n: int, what: str = "radix-2 length") -> None:
    """Raise unless n is a power of two >= 2: a radix-2 routine given
    another length would compute garbage without complaint."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two >= 2, got {n}")


def bit_reverse_permutation(n: int) -> np.ndarray:
    """Bit-reversed index table (the reference's `ComputeBitRevIndices`,
    `FFT.compute:79-96`)."""
    check_pow2(n)
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=16)
def _dif_twiddles(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stage twiddle vectors, (log2(n), n) f32 re/im, rows in
    execution order.

    Forward DIF stage with half-distance d (d = n/2, ..., 1):
        top'(r) = x[r] + x[r+d];  bottom'(r+d) = (x[r] - x[r+d]) * tw[r+d]
    with tw[p] = W_{2d}^{p mod d}.  Inverse DIT stage (d = 1, ..., n/2) on
    bit-reversed input uses the conjugate twiddles:
        top'(r) = x[r] + x[r+d] * tw;  bottom'(r+d) = x[r] - x[r+d] * tw.
    """
    check_pow2(n)
    stages = n.bit_length() - 1
    re = np.empty((stages, n), np.float32)
    im = np.empty((stages, n), np.float32)
    idx = np.arange(n)
    sign = +2.0 if inverse else -2.0
    ds = [n >> (s + 1) for s in range(stages)]  # forward order
    if inverse:
        ds = ds[::-1]
    for row, d in enumerate(ds):
        j = idx % d
        w = np.exp(sign * 1j * np.pi * j / (2 * d))
        re[row] = w.real.astype(np.float32)
        im[row] = w.imag.astype(np.float32)
    return re, im


@functools.lru_cache(maxsize=16)
def compact_twiddles(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The n - 1 distinct words of `_dif_twiddles(n, inverse)`, (n - 1,)
    f32 re/im: the row of span d holds W_{2d}^{i mod d}, periodic with
    period d, so word d - 1 + j (j < d) is its entry j.  The twiddle table
    of the row engine (`csrc/row_pass.cuh`, kernels 1, 4 and 7) and of
    kernel 2's in-block column passes (`csrc/col_pass.cuh`), which reads
    word d - 1 + (i1 mod d) for the bottom element i1 of a butterfly."""
    re, im = _dif_twiddles(n, inverse)
    stages = n.bit_length() - 1
    out_re = np.empty(n - 1, np.float32)
    out_im = np.empty(n - 1, np.float32)
    for row in range(stages):
        d = 1 << row if inverse else n >> (row + 1)
        out_re[d - 1:2 * d - 1] = re[row, :d]
        out_im[d - 1:2 * d - 1] = im[row, :d]
    return out_re, out_im


def bitrev_freq_axis(n: int) -> np.ndarray:
    """Centred normalized frequency value of each bit-reversed bin: the
    value the reference's x/N - 0.5 grid assigns to this bin's frequency."""
    rev = bit_reverse_permutation(n)
    k = rev.astype(np.float64) / n
    return np.where(k < 0.5, k, k - 1.0).astype(np.float32)


def _fft_axis_args(re, im, axis: int, inverse: bool) -> int:
    """Validate an `_fft_axis` call; returns the transform length."""
    if re.ndim != 3 or axis not in (1, 2):
        raise ValueError(f"expected (B, H, W) planes and axis 1 or 2, got "
                         f"{tuple(re.shape)} and axis {axis}")
    if im is None and inverse:
        raise ValueError("a real input (im None) is forward only")
    n = re.shape[axis]
    check_pow2(n, "radix-2 length")
    return n


def _fft_axis_ref(re, im, axis: int, inverse: bool, scale: float = 1.0):
    """Plain PyTorch version of `_fft_axis`: `torch.fft` along the axis,
    with the bit-reversal map on the spectral side, then the scale."""
    n = _fft_axis_args(re, im, axis, inverse)
    rev = torch.as_tensor(bit_reverse_permutation(n), device=re.device)
    x = re.to(torch.complex64) if im is None else torch.complex(re, im)
    if inverse:
        z = torch.fft.ifft(x.index_select(axis, rev), dim=axis,
                           norm="forward")
    else:
        z = torch.fft.fft(x, dim=axis).index_select(axis, rev)
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    if scale != 1.0:
        zr, zi = zr * np.float32(scale), zi * np.float32(scale)
    return zr, zi


_ROW_ENGINE_MIN = 128  # shortest row of the row engine (PBMM_RP_MINN)


@checked
def _fft_axis(re, im, axis: int, inverse: bool, scale: float = 1.0):
    """(B, H, W) f32 re/im -> the same shape transformed along `axis` (1 =
    H, 2 = W): forward natural -> bit-reversed, inverse bit-reversed ->
    natural and unnormalised; `scale` multiplies the output.  `im=None`
    is a real input (forward only): no imaginary plane is read.

    CPU tensors take `_fft_axis_ref`; CUDA tensors launch
    `csrc/fft_axis.cu`: along the rows (axis 2) the row engine of
    kernels 1, 4 and 7 from 128 points up (its inverse takes planes that
    start on 16 bytes), the stage-by-stage kernel at 2 to 64 points (a
    routing by length: both compute the same bits), rows above 16384
    points bracketed around it (`csrc/col_pass.cuh`); along the columns
    the column engine of kernel 5, at any length."""
    if re.device.type == "cpu":
        return _fft_axis_ref(re, im, axis, inverse, scale)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    n = _fft_axis_args(re, im, axis, inverse)
    check_cuda("_fft_axis", tuple(re.shape), re,
               *(() if im is None else (im,)))
    dev = re.device
    engine = axis == 2 and n >= _ROW_ENGINE_MIN
    twr, twi = device_arrays(compact_twiddles if engine else _dif_twiddles,
                             (n, bool(inverse)), dev)
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(re)
    b, h, w = re.shape
    err = library().pbmm_fft_axis(
        re.data_ptr(), None if im is None else im.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), b, h, w, axis, int(inverse), float(scale),
        stream_handle(dev))
    check_launch(err, "_fft_axis")
    _fft_axis.launches += 1
    return out_re, out_im


counted(_fft_axis)


def fft2_bitrev(y: torch.Tensor):
    """Real (B, H, W) f32 -> (re, im) spectrum, both axes bit-reversed."""
    re, im = _fft_axis(y.to(torch.float32).contiguous(), None, 2, False)
    return _fft_axis(re, im, 1, False)


def ifft2_bitrev(re: torch.Tensor, im: torch.Tensor):
    """(re, im) bit-reversed spectrum -> the complex spatial result (re,
    im), normalised by 1 / (H W)."""
    _, h, w = re.shape
    re, im = _fft_axis(re, im, 1, True)
    return _fft_axis(re, im, 2, True, 1.0 / (h * w))
