"""Standard (non-pyramid) mode: whole-spectrum phase-delta amplification
weighted by a radial spatial-frequency band-pass.

Counterpart of `pbmm_tpu/phase/standard.py` (`ProcessPhaseDifference`,
`PhaseDifferenceComputeShader.compute:74-179`), as torch ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def bandpass_weight_map(pad_h: int, pad_w: int, cfg,
                        layout: str = "centered",
                        device=None) -> torch.Tensor:
    """w(f) per bin in f32 on `device`, in the spectrum's `layout` (JAX
    `bandpass_weight_map_jnp`): f the radius scaled so the corner maps to
    1, the steep low/high ramps, `motion_sensitivity`, the mid-band edge
    boost (zero unless `enhance_edges`), clamped at 0; all ones without
    `apply_bandpass`."""
    from pbmm_tpu_torch.pyramid.filters import freq_grid

    f = torch.clamp_max(freq_grid(pad_h, pad_w, layout, device) / 0.707,
                        1.0)
    if not cfg.apply_bandpass:
        return torch.ones_like(f)
    steep = cfg.filter_steepness
    w = torch.ones_like(f)
    w = torch.where(f < cfg.low_freq_cutoff,
                    w * (f / max(cfg.low_freq_cutoff, 1e-3)) ** steep, w)
    w = torch.where(f > cfg.high_freq_cutoff,
                    w * ((1.0 - f) / max(1.0 - cfg.high_freq_cutoff, 1e-3))
                    ** steep, w)
    w = w * cfg.motion_sensitivity
    edge = cfg.edge_enhancement if cfg.enhance_edges else 0.0
    mid = (f > cfg.low_freq_cutoff) & (f < cfg.high_freq_cutoff)
    w = torch.where(mid, w * (1.0 + edge * torch.sin(
        np.pi * (f - cfg.low_freq_cutoff)
        / (cfg.high_freq_cutoff - cfg.low_freq_cutoff))), w)
    return torch.clamp_min(w, 0.0)


def standard_phase_amplify(cur, prev, weight, phase_scale: float,
                           magnitude_threshold: float,
                           magnitude_scale: float = 1.0,
                           apply_magnitude_scale: bool = False,
                           delta_override: Optional[torch.Tensor] = None):
    """out = gate ? cur : cur * exp(i wrap(arg prev - arg cur) w scale),
    the gate passing bins where either magnitude is under the threshold.
    The reference computes `magnitude_scale` and never applies it
    (`:169,175-178`); it multiplies here only with
    `apply_magnitude_scale`."""
    from pbmm_tpu_torch.phase.amplify import _expi, phase_delta

    gate = ((torch.abs(cur) < magnitude_threshold)
            | (torch.abs(prev) < magnitude_threshold))
    delta = phase_delta(cur, prev) if delta_override is None \
        else delta_override
    modified = cur * _expi(delta * weight * phase_scale)
    if apply_magnitude_scale:
        modified = modified * np.float32(magnitude_scale)
    return torch.where(gate, cur, modified)
