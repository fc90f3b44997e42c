"""Four-step (Bailey) FFT as dense matrix products: `fft_backend="mxu"`.

Counterpart of `pbmm_tpu/spectral/mxu_fft.py`.  Each N-point DFT is
factored into two matrix products with a twiddle multiply between:

    n = N2*n1 + n2,  k = k1 + N1*k2        (N = N1*N2, N1 <= 128)
    X[k1 + N1*k2] = sum_n2 W_N^(n2*k1) * W_N2^(n2*k2)
                        * sum_n1 x[N2*n1 + n2] * W_N1^(n1*k1)

    step 1  reshape (N1, N2), transpose -> A[n2, n1]
    step 2  B = A @ DFT_N1                  (contraction K = N1)
    step 3  C = B * twiddle[n2, k1]         (elementwise)
    step 4  D = DFT_N2^T @ C                (contraction K = N2)
    step 5  flatten (k2 major, k1 minor) -> natural-order spectrum

The JAX package writes the products as XLA einsums outside any Pallas
kernel, so the port writes them as `torch.matmul` (cuBLAS on the card)
and no kernel of its own.  Complex arithmetic is split re/im as there;
the transforms return `complex64`.

The products must run in IEEE f32 (the JAX package's
`Precision.HIGHEST`): TF32 keeps 10 mantissa bits and breaks the
> 100 dB bar.  On a CUDA tensor every transform checks the process's
matmul precision at each call and raises `ValueError` when TF32 (or a
bf16 pass) is allowed; it never changes that setting itself.  On the
CPU the setting does not apply.

`rfft2_mxu` / `irfft2_mxu` produce and consume `torch.fft.rfft2`'s
natural half-spectrum layout, the pipeline's `use_rfft=True` layout:
  - forward rows: the input is real, so step 2 is 2 real products
    instead of 4, and only output rows k2 <= N2/2 are computed;
  - inverse rows: the Hermitian extension (a flip and a conjugate), then
    a full inverse four-step, keeping the real part.

The DFT and twiddle tables are built in float64 numpy, rounded to f32 as
the JAX package rounds them, and kept as tensors on each device they
are used on (the scan engine calls the transforms once a frame).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _split(n: int) -> Tuple[int, int]:
    """N1*N2 = n with N1 <= 128 maximal (both powers of two)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"mxu fft requires power-of-two length, got {n}")
    n1 = min(128, n)
    return n1, n // n1


def _dft_mat(n: int, inverse: bool, scale: float = 1.0):
    """(n, n) DFT matrix as an (re, im) f32 numpy pair; W^(jk), sign by
    direction, `scale` folded in before the rounding."""
    k = np.arange(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(k, k) / n
    return ((np.cos(ang) * scale).astype(np.float32),
            (np.sin(ang) * scale).astype(np.float32))


def _twiddle(n: int, inverse: bool):
    """(N2, N1) twiddle table W_N^(n2*k1), f32 re/im."""
    n1, n2 = _split(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# (kind, n, inverse, scale, out_rows, device) -> (re, im) on that device.
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _table(kind: str, n: int, inverse: bool, device: torch.device,
           scale: float = 1.0, out_rows: int = 0):
    """A cached table on `device`: "dft" the (n, n) matrix, "dft_t" the
    step-4 matrix transposed to (out_rows or n, n), "twiddle" the
    (N2, N1) twiddles."""
    key = (kind, n, inverse, scale, out_rows, device)
    tab = _TABLES.get(key)
    if tab is None:
        if kind == "twiddle":
            pair = _twiddle(n, inverse)
        elif kind == "dft":
            pair = _dft_mat(n, inverse, scale)
        else:
            pair = tuple(m[:, :out_rows or n].T
                         for m in _dft_mat(n, inverse, scale))
        tab = tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                    for m in pair)
        _TABLES[key] = tab
    return tab


def check_matmul_precision(x: torch.Tensor) -> None:
    """Raise `ValueError` when `x` lies on a CUDA card and the process
    lets float32 matrix products round below IEEE f32 (TF32 or bf16)."""
    if not x.is_cuda:
        return
    why = None
    fp32 = getattr(torch.backends.cuda.matmul, "fp32_precision", None)
    if fp32 == "tf32":
        why = "torch.backends.cuda.matmul.fp32_precision is 'tf32'"
    elif torch.get_float32_matmul_precision() != "highest":
        why = ("torch.get_float32_matmul_precision() is "
               f"{torch.get_float32_matmul_precision()!r}")
    elif torch.backends.cuda.matmul.allow_tf32:
        why = "torch.backends.cuda.matmul.allow_tf32 is True"
    if why:
        raise ValueError(
            f"fft_backend='mxu' needs IEEE float32 matrix products, but {why}"
            ": set torch.backends.cuda.matmul.allow_tf32 = False (or "
            "torch.set_float32_matmul_precision('highest')) before the call")


def _four_step_last(xr: torch.Tensor, xi: Optional[torch.Tensor], n: int,
                    inverse: bool, scale: float = 1.0, out_rows: int = 0,
                    imag: bool = True):
    """N-point DFT along the last axis of (..., n) split-complex input.

    `xi=None` marks a purely real input (halves step 2).  `out_rows` > 0
    computes only the first `out_rows` values of the k2 (major) output
    coordinate, the half-spectrum crop.  `scale` folds a normalisation
    into the step-4 matrix.  `imag=False` skips the imaginary part of
    step 4 (returned as None), which XLA drops where the caller keeps
    only the real part.  Returns (re, im) with last dim n if
    out_rows == 0 else out_rows * N1."""
    n1, n2 = _split(n)
    lead = tuple(xr.shape[:-1])
    dev = xr.device
    # step 1: n = N2*n1 + n2  ->  A[..., n2, n1]
    xr = xr.reshape(lead + (n1, n2)).transpose(-1, -2)
    w1r, w1i = _table("dft", n1, inverse, dev)
    if xi is None:
        br, bi = xr @ w1r, xr @ w1i  # real input: 2 products
    else:
        xi = xi.reshape(lead + (n1, n2)).transpose(-1, -2)
        br = xr @ w1r - xi @ w1i
        bi = xr @ w1i + xi @ w1r
    tr, ti = _table("twiddle", n, inverse, dev)
    cr = br * tr - bi * ti
    ci = br * ti + bi * tr
    # step 4: D[k2, k1] = sum_n2 W2[n2, k2] C[n2, k1], as W2^T @ C.
    w2r, w2i = _table("dft_t", n2, inverse, dev, scale, out_rows)
    shape = lead + ((out_rows or n2) * n1,)
    dr = (w2r @ cr - w2i @ ci).reshape(shape)
    return dr, (w2i @ cr + w2r @ ci).reshape(shape) if imag else None


def _fft_axis(xr, xi, axis: int, inverse: bool, scale: float = 1.0):
    """Full c2c transform along `axis` (moveaxis + four-step + back)."""
    xr = torch.movedim(xr, axis, -1)
    xi = None if xi is None else torch.movedim(xi, axis, -1)
    rr, ri = _four_step_last(xr, xi, xr.shape[-1], inverse, scale)
    return torch.movedim(rr, -1, axis), torch.movedim(ri, -1, axis)


def rfft2_mxu(y: torch.Tensor) -> torch.Tensor:
    """Real (..., H, W) f32 -> (..., H, W // 2 + 1) complex64, equal to
    `torch.fft.rfft2` to f32 rounding.

    Row stage: the real-input four-step along -1 keeping k2 <= N2/2 (then
    a slice to exactly W // 2 + 1 bins).  Column stage: a full c2c along
    -2."""
    check_matmul_precision(y)
    w = y.shape[-1]
    _, n2 = _split(w)
    rr, ri = _four_step_last(y.to(torch.float32), None, w, inverse=False,
                             out_rows=n2 // 2 + 1)
    rr, ri = rr[..., :w // 2 + 1], ri[..., :w // 2 + 1]
    rr, ri = _fft_axis(rr, ri, -2, inverse=False)
    return torch.complex(rr, ri)


def irfft2_mxu(spec: torch.Tensor, pad_w: int) -> torch.Tensor:
    """Half-spectrum (..., H, K) -> real (..., H, pad_w), equal to
    `torch.fft.irfft2(spec, s=(H, pad_w))` to f32 rounding.

    Inverse c2c along -2 (1/H folded into step 4), the Hermitian
    extension along -1, the inverse four-step (1/W folded in), real
    part."""
    check_matmul_precision(spec)
    h = spec.shape[-2]
    sr, si = _fft_axis(spec.real, spec.imag, -2, inverse=True, scale=1.0 / h)
    # Hermitian extension: X[W-k] = conj(X[k]) for k = 1..W/2-1.
    tail = slice(1, pad_w - (pad_w // 2 + 1) + 1)
    fr = torch.cat([sr, torch.flip(sr[..., tail], (-1,))], dim=-1)
    fi = torch.cat([si, -torch.flip(si[..., tail], (-1,))], dim=-1)
    rr, _ = _four_step_last(fr, fi, pad_w, inverse=True, scale=1.0 / pad_w,
                            imag=False)
    return rr


def fft2_mxu(y: torch.Tensor) -> torch.Tensor:
    """Real (..., H, W) -> the full natural-order complex64 spectrum (the
    c2c path, for tests; the pipeline uses the rfft pair above)."""
    check_matmul_precision(y)
    rr, ri = _four_step_last(y.to(torch.float32), None, y.shape[-1], False)
    rr, ri = _fft_axis(rr, ri, -2, inverse=False)
    return torch.complex(rr, ri)
