"""Frequency-domain filter banks ("pyramid levels").

Counterpart of `pbmm_tpu/pyramid/filters.py`: `radial_level_params`, the
single source of truth for the per-level ramps of the radial bank; the
frequency axes of every spectral layout (`freq_axes`, `freq_grid`); the
procedural masks of the scan engine's phase pass (`radial_profile`,
`angular_profiles`, `procedural_mask_planes`); and the host banks of the
mask-plane forms (`filter_bank`, `amplified_level_flags`).  The reference
bank is radial only and does not tile to unity; the steerable
`orientations` split each mid band into K angular sectors.  The `_jnp`
suffix of the JAX names is dropped: here the procedural forms are torch.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch


def radial_level_params(levels: int, min_f: float, max_f: float):
    """(kind, lo, hi, amplified) per level, kind in {"high", "low", "band",
    "zero"}, exactly as `GeneratePyramidFilters` derives them
    (`PyramidOperations.compute:25-87`): level 0 high-pass ramps over
    [0.8*maxF, maxF]; level L-1 low-pass over [minF, 1.2*minF]; mid bands
    raised-cosine over [c/2, 3c/2] with geometric centre spacing; L=3
    hits the reference's NaN-ratio quirk -> all-zero mid mask."""
    lo_f, hi_f = float(min_f), float(max_f)
    out = []
    for i in range(levels):
        amp = 0 < i < levels - 1
        if i == 0:
            out.append(("high", 0.8 * hi_f, hi_f, False))
        elif i == levels - 1:
            out.append(("low", lo_f, 1.2 * lo_f, False))
        elif levels == 3:
            out.append(("zero", 0.0, 0.0, False))
        else:
            r = (i - 1) / (levels - 3)
            c = lo_f * (hi_f / lo_f) ** (1.0 - r)
            out.append(("band", 0.5 * c, 1.5 * c, amp))
    return tuple(out)


def _smoothstep_np(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _freq_grid_np(pad_h: int, pad_w: int):
    """The compute shader's fx = x/W - 0.5, fy = y/H - 0.5 in f64
    (`PyramidOperations.compute:32-37`)."""
    fy = np.arange(pad_h, dtype=np.float64) / pad_h - 0.5
    fx = np.arange(pad_w, dtype=np.float64) / pad_w - 0.5
    return fy[:, None], fx[None, :]


@functools.lru_cache(maxsize=16)
def _radial_bank_np(pad_h: int, pad_w: int, levels: int,
                    min_freq: float, max_freq: float) -> np.ndarray:
    """(L, H, W) f32 radial masks on the centred grid, evaluated in f64
    from `radial_level_params` (`PyramidOperations.compute:25-87`; the
    L = 3 mid band is all zero, as in the reference)."""
    fy, fx = _freq_grid_np(pad_h, pad_w)
    freq = np.sqrt(fx * fx + fy * fy)
    masks = np.zeros((levels, pad_h, pad_w), dtype=np.float64)
    for i, (kind, lo, hi, _) in enumerate(
            radial_level_params(levels, min_freq, max_freq)):
        masks[i] = radial_profile_from_params(
            freq, kind, lo, hi, smoothstep=_smoothstep_np, cos=np.cos,
            where=np.where, zeros_like=np.zeros_like)
    return masks.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _steerable_bank_np(pad_h: int, pad_w: int, levels: int, min_freq: float,
                       max_freq: float, orientations: int) -> np.ndarray:
    """The steerable extension's bank: each mid band split into K
    partition-of-unity sectors |cos(theta - pi k / K)|^(2(K-1)),
    normalised; (2 + (L - 2) K, H, W) f32 for L >= 3."""
    radial = _radial_bank_np(pad_h, pad_w, levels, min_freq, max_freq)
    if orientations <= 1 or levels < 3:
        return radial
    k_or = orientations
    fy, fx = _freq_grid_np(pad_h, pad_w)
    theta = np.arctan2(np.broadcast_to(fy, radial.shape[1:]),
                       np.broadcast_to(fx, radial.shape[1:]))
    power = 2 * (k_or - 1)
    ang = np.empty((k_or,) + radial.shape[1:], dtype=np.float64)
    for k in range(k_or):
        ang[k] = np.abs(np.cos(theta - np.pi * k / k_or)) ** power
    total = ang.sum(axis=0)
    ang /= np.where(total == 0.0, 1.0, total)
    out = [radial[0]]
    for i in range(1, levels - 1):
        for k in range(k_or):
            out.append(radial[i] * ang[k])
    out.append(radial[-1])
    return np.stack(out).astype(np.float32)


def freq_axes(pad_h: int, pad_w: int, layout: str = "centered",
              device=None):
    """(fy (H, 1), fx (1, Wk)) f32 normalised frequency axes on `device`
    (JAX `freq_axes_jnp`): "centered" the DC-centred grid x/W - 0.5;
    "rfft" the natural half-spectrum (row ky at the centred value of
    (ky + H/2) % H, columns kx/W for kx <= W/2); "bitrev2d" both axes in
    bit-reversed order (the radix-2 kernels' layout)."""
    from pbmm_tpu_torch.spectral.radix2 import bitrev_freq_axis

    f32 = dict(dtype=torch.float32, device=device)
    if layout == "centered":
        fy = torch.arange(pad_h, **f32) / pad_h - 0.5
        fx = torch.arange(pad_w, **f32) / pad_w - 0.5
    elif layout == "rfft":
        ky = (torch.arange(pad_h, dtype=torch.int32, device=device)
              + pad_h // 2) % pad_h
        fy = ky.to(torch.float32) / pad_h - 0.5
        fx = torch.arange(pad_w // 2 + 1, **f32) / pad_w
    elif layout == "bitrev2d":
        fy = torch.as_tensor(bitrev_freq_axis(pad_h), device=device)
        fx = torch.as_tensor(bitrev_freq_axis(pad_w), device=device)
    else:
        raise ValueError(f"unknown spectrum layout: {layout!r}")
    return fy[:, None], fx[None, :]


def freq_grid(pad_h: int, pad_w: int, layout: str = "centered",
              device=None) -> torch.Tensor:
    """The radial frequency of each bin, from `freq_axes`."""
    fy, fx = freq_axes(pad_h, pad_w, layout, device)
    return torch.sqrt(fy ** 2 + fx ** 2)


def _smoothstep(t):
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def radial_profile_from_params(freq, kind: str, lo: float, hi: float,
                               smoothstep=_smoothstep, cos=torch.cos,
                               where=torch.where, zeros_like=torch.zeros_like,
                               div=operator.truediv):
    """One level's mask from its `radial_level_params` entry; the array
    functions (and the division by the ramp's width) are injectable so the
    f64 numpy banks share the ramps."""
    if kind == "zero":
        return zeros_like(freq)
    if kind == "high":
        return where(freq > hi, 1.0,
                     where(freq > lo, smoothstep(div(freq - lo, hi - lo)),
                           0.0))
    if kind == "low":
        return where(freq < lo, 1.0,
                     where(freq < hi,
                           1.0 - smoothstep(div(freq - lo, hi - lo)), 0.0))
    t = div(freq - lo, hi - lo)
    band = 0.5 * (1.0 + cos(2.0 * np.pi * (t - 0.5)))
    return where((freq >= lo) & (freq <= hi), band, 0.0)


def radial_profile(freq: torch.Tensor, i: int, levels: int, min_f: float,
                   max_f: float) -> torch.Tensor:
    """Level i's mask as a function of the radius (JAX
    `radial_profile_jnp`)."""
    kind, lo, hi, _ = radial_level_params(levels, min_f, max_f)[i]
    return radial_profile_from_params(freq, kind, lo, hi)


def angular_profiles(pad_h: int, pad_w: int, orientations: int,
                     layout: str = "centered", device=None):
    """The K partition-of-unity angular windows of `_steerable_bank_np`
    in f32 on `device` (JAX `angular_profiles_jnp`); |cos|^even, so the
    rfft half-plane agrees with the full grid's Hermitian mirror."""
    fy, fx = freq_axes(pad_h, pad_w, layout, device)
    fy, fx = torch.broadcast_tensors(fy, fx)
    theta = torch.atan2(fy, fx)
    k_or = orientations
    power = 2 * (k_or - 1) if k_or > 1 else 0
    raw = []
    for k in range(k_or):
        c = torch.cos(theta - np.pi * k / k_or)
        raw.append(torch.abs(c) ** power if power else torch.ones_like(c))
    total = sum(raw)
    total = torch.where(total == 0.0, 1.0, total)
    return [a / total for a in raw]


def procedural_mask_planes(pad_h: int, pad_w: int, cfg,
                           layout: str = "centered", device=None):
    """Yield (mask plane, amplified) pairs computed on the fly, in the
    order of `filter_bank` + `amplified_level_flags`.  `pad_w` is the full
    width even for layout "rfft" (planes are then (H, W // 2 + 1))."""
    levels = cfg.pyramid_levels
    freq = freq_grid(pad_h, pad_w, layout, device)
    use_steer = cfg.orientations > 1 and levels >= 3
    ang = (angular_profiles(pad_h, pad_w, cfg.orientations, layout, device)
           if use_steer else None)
    for i in range(levels):
        radial = radial_profile(freq, i, levels, cfg.min_frequency,
                                cfg.max_frequency)
        amplified = 0 < i < levels - 1
        if use_steer and amplified:
            for a in ang:
                yield radial * a, True
        else:
            yield radial, amplified


def radial_filter_bank(pad_h, pad_w, levels, min_freq, max_freq,
                       device=None) -> torch.Tensor:
    return torch.as_tensor(_radial_bank_np(
        pad_h, pad_w, levels, float(min_freq), float(max_freq)),
        device=device)


def steerable_filter_bank(pad_h, pad_w, levels, min_freq, max_freq,
                          orientations, device=None) -> torch.Tensor:
    return torch.as_tensor(_steerable_bank_np(
        pad_h, pad_w, levels, float(min_freq), float(max_freq),
        int(orientations)), device=device)


def filter_bank(pad_h: int, pad_w: int, cfg, device=None) -> torch.Tensor:
    """The bank the config selects, (n_masks, H, W) f32, centred grid."""
    if cfg.orientations > 1:
        return steerable_filter_bank(pad_h, pad_w, cfg.pyramid_levels,
                                     cfg.min_frequency, cfg.max_frequency,
                                     cfg.orientations, device)
    return radial_filter_bank(pad_h, pad_w, cfg.pyramid_levels,
                              cfg.min_frequency, cfg.max_frequency, device)


def amplified_level_flags(cfg) -> np.ndarray:
    """Which mask planes are phase-amplified: not level 0 (high-pass)
    nor L-1 (low-pass) (`PyramidPhaseDifference.compute:73-77`); every
    sector of a mid band with orientations.  (n_masks,) bool."""
    levels = cfg.pyramid_levels
    if cfg.orientations > 1 and levels >= 3:
        n_mid = (levels - 2) * cfg.orientations
        return np.array([False] + [True] * n_mid + [False])
    flags = np.zeros(levels, dtype=bool)
    if levels >= 3:
        flags[1:-1] = True
    return flags
