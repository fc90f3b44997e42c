"""Pyramid-mode phase-difference amplification, as torch ops.

Counterpart of `pbmm_tpu/phase/amplify.py`.  The reference's band loop
(per band i: cur_i = cur m_i, prev_i = prev m_i; the ends pass through;
bins under the magnitude gate pass through; the others rotate by
phase_scale * wrap(arg prev_i - arg cur_i); sum over i —
`PyramidOperations.compute`, `PyramidPhaseDifference.compute:58-101`)
collapses to one pass, since a real non-negative mask does not change a
bin's phase:

    E = sum of the gated amplified masks; P = sum of all masks - E
    result = cur * (P + E * exp(i * phase_scale * delta))

`pyramid_phase_amplify_naive` keeps the literal loop as the test oracle
of the fused forms.  These are the scan engine's XLA-side passes in the
JAX package; the `use_pallas` kernel is `phase.fused_kernels`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pbmm_tpu_torch.core.complexop import wrap_phase


def _expi(x: torch.Tensor) -> torch.Tensor:
    """exp(i x) for real f32 x, as complex64."""
    return torch.complex(torch.cos(x), torch.sin(x))


def pyramid_phase_amplify(cur, prev, masks, amp_flags, phase_scale: float,
                          magnitude_threshold: float,
                          delta_override: Optional[torch.Tensor] = None):
    """The fused pass with explicit (n_masks, H, W) mask planes and their
    (n_masks,) amplified flags, on DC-centred spectra (..., H, W)."""
    cur_mag, prev_mag = torch.abs(cur), torch.abs(prev)
    delta = wrap_phase(torch.angle(prev) - torch.angle(cur))
    if delta_override is not None:
        delta = delta_override
    flags = torch.as_tensor(np.asarray(amp_flags), device=cur.device)
    shape = (masks.shape[0],) + (1,) * (cur.ndim - 2) + tuple(
        cur.shape[-2:])
    m = masks.reshape(shape)
    amp = (flags.reshape((-1,) + (1,) * cur.ndim)
           & (cur_mag[None] * m >= magnitude_threshold)
           & (prev_mag[None] * m >= magnitude_threshold))
    mask_total = torch.sum(m * torch.ones_like(cur_mag)[None], dim=0)
    amplified_sum = torch.sum(torch.where(amp, m, 0.0), dim=0)
    pass_sum = mask_total - amplified_sum
    return cur * (pass_sum + amplified_sum * _expi(phase_scale * delta))


def phase_delta(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """wrap(arg(prev) - arg(cur)) as one atan2: arg(prev * conj(cur))."""
    return torch.angle(prev * torch.conj(cur))


def _unit_rotation(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """e^{i delta} without trig: prev * conj(cur) at unit modulus; zero
    bins give 0 (they are always gated to pass-through).  1e-38 is
    subnormal in f32; nothing here flushes it."""
    r = prev * torch.conj(cur)
    m2 = r.real ** 2 + r.imag ** 2
    inv = torch.where(m2 > 0, torch.rsqrt(torch.clamp_min(m2, 1e-38)), 0.0)
    return r * inv


def _integer_power(z: torch.Tensor, n: int) -> torch.Tensor:
    """z ** n by square-and-multiply (n >= 0)."""
    result, base = None, z
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result if result is not None else torch.ones_like(z)


def rotation_term(cur, prev, phase_scale: float,
                  delta_override: Optional[torch.Tensor] = None):
    """exp(i phase_scale wrap(arg prev - arg cur)): trig-free for an
    integer scale in [0, 64] ((prev conj(cur) / |.|) ** s), else atan2
    and cos/sin."""
    s = float(phase_scale)
    if delta_override is None and s.is_integer() and 0 <= s <= 64:
        return _integer_power(_unit_rotation(cur, prev), int(s))
    delta = phase_delta(cur, prev) if delta_override is None \
        else delta_override
    return _expi(s * delta)


def pyramid_phase_amplify_procedural(cur, prev, cfg,
                                     delta_override=None,
                                     layout: str = "centered",
                                     full_pad_w: Optional[int] = None):
    """The scan engine's pass: the math of `pyramid_phase_amplify` with
    every mask evaluated per bin from the radial and angular profiles in
    the spectrum's `layout` ("centered", "rfft", "bitrev2d"); for "rfft"
    `full_pad_w` is the spatial width."""
    from pbmm_tpu_torch.pyramid.filters import procedural_mask_planes

    pad_h = cur.shape[-2]
    pad_w = full_pad_w if layout == "rfft" else cur.shape[-1]
    cur_mag, prev_mag = torch.abs(cur), torch.abs(prev)
    tau = cfg.magnitude_threshold
    total = torch.zeros(tuple(cur.shape[-2:]), dtype=torch.float32,
                        device=cur.device)
    amped = torch.zeros_like(cur_mag)
    for m, amplified in procedural_mask_planes(pad_h, pad_w, cfg, layout,
                                               cur.device):
        total = total + m
        if amplified:
            gate = (cur_mag * m >= tau) & (prev_mag * m >= tau)
            amped = amped + torch.where(gate, m, 0.0)
    rot = rotation_term(cur, prev, cfg.phase_scale, delta_override)
    return cur * ((total - amped) + amped * rot)


def pyramid_phase_amplify_naive(cur, prev, masks, amp_flags,
                                phase_scale: float,
                                magnitude_threshold: float):
    """The reference's band loop, literally: filter, gate, rotate,
    accumulate, band by band."""
    acc = torch.zeros_like(cur)
    for i in range(masks.shape[0]):
        m = masks[i]
        cur_i, prev_i = cur * m, prev * m
        if not bool(amp_flags[i]):
            acc = acc + cur_i
            continue
        gate = ((torch.abs(cur_i) < magnitude_threshold)
                | (torch.abs(prev_i) < magnitude_threshold))
        delta = wrap_phase(torch.angle(prev_i) - torch.angle(cur_i))
        acc = acc + torch.where(gate, cur_i,
                                cur_i * _expi(phase_scale * delta))
    return acc
