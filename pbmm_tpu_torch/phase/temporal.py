"""Temporal-filter state of the phase-delta stream.

Counterpart of `pbmm_tpu/phase/temporal.py`.  The two-frame mode
carries zero-size taps; the streaming IIR band-pass carries the two
low-pass taps, (C, Hp, Wk) f32 each in the spectra's working layout
(lp += r (delta - lp); the rotation uses lp_fast - lp_slow).  Kernels 2
and 6 update them on chip; `temporal_apply` is the scan engine's torch
form.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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


def temporal_apply(delta: torch.Tensor, state: TemporalState, temporal_cfg
                   ) -> Tuple[torch.Tensor, TemporalState]:
    """Filter one frame's delta plane: (lp_fast - lp_slow, new taps) with
    lp += r (delta - lp); the two-frame mode passes delta through."""
    if temporal_cfg.mode == "two_frame":
        return delta, state
    r_hi, r_lo = temporal_cfg.smoothing_factors()
    lp_fast = state.lp_fast + np.float32(r_hi) * (delta - state.lp_fast)
    lp_slow = state.lp_slow + np.float32(r_lo) * (delta - state.lp_slow)
    return lp_fast - lp_slow, TemporalState(lp_fast, lp_slow)
