"""Temporal-filter state of the phase-delta stream.

Counterpart of `pbmm_tpu/phase/temporal.py`'s `TemporalState` and
`temporal_init`.  The two-frame mode carries zero-size taps; the
streaming IIR band-pass carries the two low-pass taps, (C, Hp, Wk) f32
each in the spectra's working layout, which kernel 2
(`spectral.fused.colspec_chunk`) updates on chip frame by frame
(lp += r (delta - lp); the rotation uses lp_fast - lp_slow).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class TemporalState(NamedTuple):
    lp_fast: torch.Tensor  # delta-plane-shaped f32
    lp_slow: torch.Tensor  # delta-plane-shaped f32


def temporal_init(shape: Tuple[int, ...], temporal_cfg,
                  device=None) -> TemporalState:
    """`shape` is the per-frame delta-plane shape, e.g. (C, H, W)."""
    if temporal_cfg.mode == "two_frame":
        z = torch.zeros((0,) * len(shape), dtype=torch.float32,
                        device=device)
        return TemporalState(z, z)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return TemporalState(z, z)
