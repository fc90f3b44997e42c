"""The band/phase pass on whole spectra as one kernel (kernel 9).

Counterpart of `pbmm_tpu/phase/pallas_kernels.py` (renamed: the port holds
no Pallas): `amplify_procedural` (JAX `_amplify_pallas_procedural`; CUDA:
`csrc/amplify_procedural.cu`) and `pyramid_phase_amplify_pallas_procedural`
(the public name kept), the `use_pallas=True` pass of the scan engine.  In
one pass per bin: the radial masks of `radial_level_params` evaluated at
the bin's frequency, the steerable sectors when `orientations > 1`, the
magnitude gate on min(|cur|, |prev|), the rotation by square-and-multiply
of the unit rotation for an integer scale or atan2 and cos/sin otherwise,
and the collapse cur ((total - amped) + amped rot).  The spectra are full
(`use_rfft=False`) in the "centered" (`fft_backend="xla"`) or "bitrev2d"
(`"pallas"`) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
    stream_handle,
)
from pbmm_tpu_torch.utils.profiling import counted

_MAX_LEVELS = 16  # csrc/amplify_procedural.cu AP_MAXB
_MAX_ORIENTATIONS = 16  # AP_MAXK
_MASK_KINDS = ("zero", "high", "low", "band")


def _steer(levels: int, orientations: int) -> int:
    return orientations if orientations > 1 and levels >= 3 else 0


def _int_power(phase_scale: float) -> int:
    """The integer power of an integer scale in [0, 64], else -1."""
    s = float(phase_scale)
    return int(s) if s.is_integer() and 0 <= s <= 64 else -1


def _check_args(cur_re, fy, fx, levels, orientations):
    c, h, w = cur_re.shape
    if tuple(fy.shape) != (h,) or tuple(fx.shape) != (w,):
        raise ValueError(f"fy {tuple(fy.shape)} and fx {tuple(fx.shape)} do "
                         f"not match spectra of {h} x {w}")
    if levels < 1 or levels > _MAX_LEVELS \
            or _steer(levels, orientations) > _MAX_ORIENTATIONS:
        raise ValueError(f"the kernel takes 1 to {_MAX_LEVELS} levels and "
                         f"up to {_MAX_ORIENTATIONS} orientations, got "
                         f"{levels} and {orientations}")


def _div_rn(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / f32(b) rounded once, as the kernel's `__fdiv_rn` and the JAX
    kernel's division: on a CUDA tensor torch takes a Python divisor as
    a * (1 / b), two roundings that move t by an ulp now and then and, at
    a magnitude gate g m ~ tau, flip a bin; a divisor tensor on a's device
    is divided in one rounding (on the CPU both forms are one)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def amplify_procedural_ref(cur_re, cur_im, prev_re, prev_im, fy, fx,
                           levels: int, min_f: float, max_f: float,
                           phase_scale: float, tau: float,
                           orientations: int):
    """Plain PyTorch version of `amplify_procedural`, in the JAX kernel's
    order of operations (`pallas_kernels.py:53-128`)."""
    from pbmm_tpu_torch.pyramid.filters import (
        radial_level_params,
        radial_profile_from_params,
    )
    from pbmm_tpu_torch.spectral.fused import _sector_weights

    _check_args(cur_re, fy, fx, levels, orientations)
    cr, ci, pr, pi_ = cur_re, cur_im, prev_re, prev_im
    fy, fx = fy[:, None], fx[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    gate_mag = torch.minimum(torch.sqrt(cr * cr + ci * ci),
                             torch.sqrt(pr * pr + pi_ * pi_))
    steer = _steer(levels, orientations)
    sect = _sector_weights(fy, fx, steer) if steer else None
    total = torch.zeros_like(f)
    amped = torch.zeros_like(cr)
    for i, (kind, lo, hi, _) in enumerate(
            radial_level_params(levels, min_f, max_f)):
        m = radial_profile_from_params(f, kind, lo, hi, div=_div_rn)
        total = total + m
        if 0 < i < levels - 1:
            for mk in ([m * a for a in sect] if sect else [m]):
                amped = amped + torch.where(gate_mag * mk >= tau, mk, 0.0)
    rr = pr * cr + pi_ * ci  # prev * conj(cur)
    ri = pi_ * cr - pr * ci
    n = _int_power(phase_scale)
    if n >= 0:
        m2 = rr * rr + ri * ri
        inv = torch.where(m2 > 0, torch.rsqrt(torch.clamp_min(m2, 1e-38)),
                          0.0)
        br, bi = rr * inv, ri * inv
        wr, wi = torch.ones_like(br), torch.zeros_like(bi)
        first = True
        while n > 0:
            if n & 1:
                if first:
                    wr, wi, first = br, bi, False
                else:
                    wr, wi = wr * br - wi * bi, wr * bi + wi * br
            n >>= 1
            if n:
                br, bi = br * br - bi * bi, 2.0 * br * bi
    else:
        ang = np.float32(phase_scale) * torch.atan2(ri, rr)
        wr, wi = torch.cos(ang), torch.sin(ang)
    er = (total - amped) + amped * wr
    ei = amped * wi
    return cr * er - ci * ei, cr * ei + ci * er


def _proc_args(levels, min_f, max_f, phase_scale, tau, orientations):
    """(ints, floats) of csrc/amplify_procedural.cu's ProcArgs."""
    from pbmm_tpu_torch.pyramid.filters import radial_level_params
    from pbmm_tpu_torch.spectral.fused import _sector_consts

    params = radial_level_params(levels, min_f, max_f)
    pad = _MAX_LEVELS - len(params)
    steer = _steer(levels, orientations)
    ints = [levels, steer, _int_power(phase_scale)]
    ints += [_MASK_KINDS.index(p[0]) for p in params] + [0] * pad
    k = max(steer, 1)
    norm, cos2p, sin2p = _sector_consts(k)
    floats = [tau, phase_scale, norm]
    floats += cos2p + [0.0] * (_MAX_ORIENTATIONS - k)
    floats += sin2p + [0.0] * (_MAX_ORIENTATIONS - k)
    for col in (1, 2):
        floats += [p[col] for p in params] + [0.0] * pad
    floats += [p[2] - p[1] for p in params] + [0.0] * pad
    return ints, floats


@checked
def amplify_procedural(cur_re, cur_im, prev_re, prev_im, fy, fx,
                       levels: int, min_f: float, max_f: float,
                       phase_scale: float, tau: float, orientations: int):
    """(C, H, W) cur/prev spectra (re, im f32) + each row's and lane's
    frequency fy (H,), fx (W,) -> the amplified spectrum (re, im), every
    mask evaluated per bin (no mask planes are read).

    CPU tensors take `amplify_procedural_ref`; CUDA tensors launch
    `csrc/amplify_procedural.cu`."""
    if cur_re.device.type == "cpu":
        return amplify_procedural_ref(cur_re, cur_im, prev_re, prev_im, fy,
                                      fx, levels, min_f, max_f, phase_scale,
                                      tau, orientations)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    _check_args(cur_re, fy, fx, levels, orientations)
    c, h, w = cur_re.shape
    check_cuda("amplify_procedural", (c, h, w), cur_re, cur_im, prev_re,
               prev_im)
    check_cuda("amplify_procedural", (h,), fy)
    check_cuda("amplify_procedural", (w,), fx)
    dev = cur_re.device
    out_re = torch.empty_like(cur_re)
    out_im = torch.empty_like(cur_re)
    ints, floats = _proc_args(levels, min_f, max_f, phase_scale, tau,
                              orientations)
    err = library().pbmm_amplify_procedural(
        cur_re.data_ptr(), cur_im.data_ptr(), prev_re.data_ptr(),
        prev_im.data_ptr(), fy.data_ptr(), fx.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), c_ints(ints), c_floats(floats), c, h, w,
        stream_handle(dev))
    check_launch(err, "amplify_procedural")
    amplify_procedural.launches += 1
    return out_re, out_im


counted(amplify_procedural)


def pyramid_phase_amplify_pallas_procedural(cur: torch.Tensor,
                                            prev: torch.Tensor, cfg,
                                            layout: str) -> torch.Tensor:
    """The constant-free band/phase pass of `use_pallas=True` on complex
    (..., H, W) spectra in `layout` ("centered" or "bitrev2d"): kernel 9
    over every leading plane, the radial bank and the steerable sectors,
    no temporal override."""
    from pbmm_tpu_torch.pyramid.filters import freq_axes

    shape = cur.shape
    h, w = shape[-2:]
    cur = cur.reshape((-1, h, w))
    prev = prev.reshape((-1, h, w))
    fy, fx = freq_axes(h, w, layout, cur.device)
    out_re, out_im = amplify_procedural(
        cur.real.contiguous(), cur.imag.contiguous(),
        prev.real.contiguous(), prev.imag.contiguous(),
        fy[:, 0].contiguous(), fx[0].contiguous(),
        int(cfg.pyramid_levels), float(cfg.min_frequency),
        float(cfg.max_frequency), float(cfg.phase_scale),
        float(cfg.magnitude_threshold), int(cfg.orientations))
    return torch.complex(out_re, out_im).reshape(shape)
