"""Host tables of the radix-2 transforms (bit-reversed spectral layout).

Counterpart of `pbmm_tpu/spectral/pallas_fft.py`'s host side: the
bit-reversal table, the frequency value of each bit-reversed bin, and the
per-stage twiddle vectors.  The forward row transform is decimation in
frequency (natural order in, bit-reversed out) and the inverse is
decimation in time (bit-reversed in, natural out), so the permutations
cancel across forward -> phase -> inverse and never run as a gather.

The CUDA kernels of this package read `_dif_twiddles` as their twiddle
tables, so both packages use the same f64-derived f32 constants.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


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


def bitrev_freq_axis(n: int) -> np.ndarray:
    """Centred normalized frequency value of each bit-reversed bin: the
    value the reference's x/N - 0.5 grid assigns to this bin's frequency."""
    rev = bit_reverse_permutation(n)
    k = rev.astype(np.float64) / n
    return np.where(k < 0.5, k, k - 1.0).astype(np.float32)
