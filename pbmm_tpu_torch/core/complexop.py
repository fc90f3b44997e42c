"""Complex-number helpers of the per-frame pipeline.

Counterpart of `pbmm_tpu/core/complexop.py`: spectra cross public
boundaries and the carried state as (re, im) f32 pairs, and the torch
ops of the scan engine work on complex64 tensors between them.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def wrap_phase(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi]: the reference's `normalize_phase` while-loop
    (`PhaseDifferenceComputeShader.compute:63-71`) as one round-half-even
    correction, exact for |x| < 2 pi."""
    return x - TWO_PI * torch.round(x / TWO_PI)


def split(z: torch.Tensor):
    """complex -> contiguous (re, im) f32 pair (the kernels' operands)."""
    return z.real.contiguous(), z.imag.contiguous()


def combine(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re, im) f32 pair -> complex64."""
    return torch.complex(re, im)
