"""Centred 2D FFT/IFFT of the `fft_backend="xla"` path, as `torch.fft`.

Counterpart of `pbmm_tpu/spectral/fft.py`.  The JAX package leaves these
transforms to XLA's FFT, so the port leaves them to cuFFT (through
`torch.fft`) and writes no kernel for them.  DC-centring: the reference's
(-1)^(x+y) premodulation equals `fftshift` of the plain spectrum for even
sizes, and its conj-FFT-conj-normalise-centre inverse equals
`ifft2(ifftshift(.))` (`MotionMagnificationProcessor.cs:508-620`).
"""

from __future__ import annotations

import torch


def fft2_centered(y: torch.Tensor) -> torch.Tensor:
    """Real (..., H, W) f32 -> DC-centred complex64 spectrum."""
    spec = torch.fft.fft2(y.to(torch.complex64))
    return torch.fft.fftshift(spec, dim=(-2, -1))


def ifft2_centered(spec: torch.Tensor) -> torch.Tensor:
    """DC-centred complex spectrum -> complex spatial result (the caller
    takes |z| or Re z)."""
    return torch.fft.ifft2(torch.fft.ifftshift(spec, dim=(-2, -1)))


def rfft2_half(y: torch.Tensor) -> torch.Tensor:
    """Real (..., H, W) f32 -> the (..., H, W // 2 + 1) half-spectrum in
    natural rfft layout; the phase pass preserves Hermitian symmetry, so
    the half carries the whole result (`MagnifyConfig.use_rfft`)."""
    return torch.fft.rfft2(y)


def irfft2_half(spec: torch.Tensor, pad_w: int) -> torch.Tensor:
    """Half-spectrum -> real spatial result (..., H, pad_w)."""
    return torch.fft.irfft2(spec, s=(spec.shape[-2], pad_w))
