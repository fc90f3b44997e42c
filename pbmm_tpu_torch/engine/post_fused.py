"""Kernel 3 of the main path: row IFFT merged with the post stage.

Counterpart of `pbmm_tpu/engine/post_pallas.py` (renamed: the port holds
no Pallas) for what the main path runs: `_radius`, `_out_block`,
`post_pallas_ok` (the geometry predicate, kept under its JAX name so the
two packages route alike) and `rowifft_post_fused` with the "tuple3"
output layout (CUDA: `csrc/rowifft_post.cu`).

The chain per frame: rebuild the missing Hermitian tiles, row IFFT
(bit-reversed lanes in, natural out), |z| / (pad_h * pad_w), the
reference's 5-tap blur horizontally then vertically, the crop, the
windowed original I/Q, YIQ -> RGB and the [0, 1] clip
(`MotionMagnificationProcessor.cs:196-205`).  The reconstruction never
leaves the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from pbmm_tpu_torch.core.color import YIQ_TO_RGB
from pbmm_tpu_torch.core.window import Geometry, blur_taps, geometry_for
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda_f32,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.spectral.hermitian import reconstruction_plan
from pbmm_tpu_torch.spectral.radix2 import (
    _dif_twiddles,
    bit_reverse_permutation,
    check_pow2,
)

_LANE = 128


def _radius(cfg) -> int:
    return (len(blur_taps(cfg.blur_size)) - 1) // 2


def _out_block(h: int) -> int:
    """Largest 8-multiple divisor of h that is <= 192; 0 if none exists."""
    best = 0
    for ob in range(8, 193, 8):
        if h % ob == 0:
            best = ob
    return best


def post_pallas_ok(geom: Geometry, cfg, rows0: int, region_h: int) -> bool:
    """Whether the merged row-IFFT + post kernel serves this geometry —
    the JAX package's predicate, verbatim, so both packages take the
    same tail (its block constraints are the TPU kernel's; the CUDA
    kernel needs only the halo conditions, which this implies)."""
    r = _radius(cfg)
    if not (geom.y0 >= r and geom.x0 >= r
            and geom.pad_h - geom.y0 - geom.in_h >= r
            and geom.pad_w - geom.x0 - geom.in_w >= r):
        return False
    if geom.in_w % 128 != 0 or geom.pad_w % 128 != 0:
        return False
    ob = _out_block(geom.in_h)
    if not ob:
        return False
    yoff = geom.y0 - rows0 - r  # region row of the first V-tap
    if yoff < 0:
        return False
    e = yoff % 8
    s = yoff - e
    wve = -(-(ob + 2 * r + e) // 8) * 8
    if s + wve > 2 * ob:
        return False
    last_need = ob * (geom.in_h // ob - 1) + s + wve
    return last_need <= region_h


def _lane_plan(wk: int, w: int):
    """(source kept position, conj-reversed flag) per full 128-lane tile:
    the Hermitian plan when the lanes are the kept half, else identity."""
    if w == wk:
        return tuple((t, 0) for t in range(w // _LANE))
    return reconstruction_plan(w)


def _check_post(rre, cfg, in_h, in_w, pad_mode, rows0, full_w, out_layout):
    """Validate a call; returns (geometry, full width)."""
    if out_layout != "tuple3":
        raise NotImplementedError(
            f"out_layout={out_layout!r} is not ported yet (ROADMAP item 5)")
    if cfg.reconstruct != "magnitude":
        raise NotImplementedError(
            "reconstruct='real' is not ported yet (ROADMAP item 6)")
    if cfg.compensate_window or cfg.apply_yiq_gains:
        raise NotImplementedError(
            "compensate_window / apply_yiq_gains are not ported yet "
            "(ROADMAP item 6)")
    t, hr, wk = rre.shape
    wp = full_w if full_w is not None else wk
    check_pow2(wp, "row IFFT length")
    if wp % _LANE or wk % _LANE:
        raise ValueError(f"widths must be multiples of 128: {wk}, {wp}")
    geom = geometry_for(in_h, in_w, pad_mode)
    r = _radius(cfg)
    yrow0 = geom.y0 - rows0
    if (yrow0 - r < 0 or yrow0 + in_h + r > hr or geom.x0 < r
            or geom.x0 + in_w + r > wp):
        raise ValueError("the blur halo of the crop leaves the region rows "
                         f"(rows0={rows0}, region height {hr})")
    return geom, wp


def rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                           in_h: int, in_w: int, pad_mode: str, full_w=None,
                           out_layout: str = "tuple3"):
    """Plain PyTorch version of `rowifft_post_fused`: lane gathers for the
    rebuild and the bit reversal, `torch.fft` per frame, the blur as
    rolls and row slices."""
    geom, wp = _check_post(rre, cfg, in_h, in_w, pad_mode, rows0, full_w,
                           out_layout)
    t, hr, wk = rre.shape
    dev = rre.device
    src, flip = [], []
    for kp, rev in _lane_plan(wk, wp):
        lanes = np.arange(_LANE)
        src.append(kp * _LANE + (_LANE - 1 - lanes if rev else lanes))
        flip.append(np.full(_LANE, bool(rev)))
    src = np.concatenate(src)
    flip = torch.as_tensor(np.concatenate(flip), device=dev)
    # Natural lane k holds bit-reversed position rev(k).
    gather = torch.as_tensor(src[bit_reverse_permutation(wp)], device=dev)
    flip = flip[torch.as_tensor(bit_reverse_permutation(wp), device=dev)]
    scale = 1.0 / (geom.pad_h * wp)
    mag = torch.empty((t, hr, wp), dtype=torch.float32, device=dev)
    for f in range(t):
        x = torch.complex(rre[f], rim[f])[:, gather]
        x = torch.where(flip, x.conj(), x)
        z = torch.fft.ifft(x, dim=-1, norm="forward")
        mag[f] = torch.sqrt(z.real * z.real + z.imag * z.imag) * scale
    taps = blur_taps(cfg.blur_size)
    r = _radius(cfg)
    hb = mag * taps[r]
    for k in range(1, r + 1):
        hb = hb + (torch.roll(mag, k, -1) * taps[r - k]
                   + torch.roll(mag, -k, -1) * taps[r + k])
    top = geom.y0 - rows0 - r
    vb = hb[:, top:top + in_h] * taps[0]
    for k in range(1, 2 * r + 1):
        vb = vb + hb[:, top + k:top + k + in_h] * taps[k]
    y = vb[..., geom.x0:geom.x0 + in_w]
    iw = i_plane * win
    qw = q_plane * win
    m = YIQ_TO_RGB
    return tuple(
        torch.clamp(y * float(m[d, 0]) + iw * float(m[d, 1])
                    + qw * float(m[d, 2]), 0.0, 1.0)
        for d in range(3))


def rowifft_post_fused(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                       in_h: int, in_w: int, pad_mode: str, full_w=None,
                       out_layout: str = "tuple3"):
    """(T, Hr, Wk) column-IFFT output rows (region rows from `rows0`,
    bit-reversed kept lanes) + (T, H, W) original I/Q planes + (H, W)
    crop-region Hann -> three (T, H, W) R, G, B planes in [0, 1].

    `full_w`: the padded width when the lanes are the kept Hermitian
    half.  CPU tensors take `rowifft_post_fused_ref`; CUDA tensors launch
    `csrc/rowifft_post.cu`."""
    if rre.device.type == "cpu":
        return rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg,
                                      rows0, in_h, in_w, pad_mode, full_w,
                                      out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom, wp = _check_post(rre, cfg, in_h, in_w, pad_mode, rows0, full_w,
                           out_layout)
    t, hr, wk = rre.shape
    # csrc/rowifft_post.cu holds one complex row plus 8 output rows and
    # their blur halo of |z| in shared memory (227 KB a block on an H100),
    # and takes blur radii up to 4 (PP_MAXR).
    r = _radius(cfg)
    if r > 4 or (2 + 8 + 2 * r) * wp * 4 > 232448:
        raise ValueError(f"the CUDA post kernel takes blur radius <= 4 and "
                         f"rows that fit shared memory; got radius {r}, "
                         f"{wp} lanes")
    check_cuda_f32("rowifft_post_fused", (t, hr, wk), rre, rim)
    check_cuda_f32("rowifft_post_fused", (t, in_h, in_w), i_plane, q_plane)
    check_cuda_f32("rowifft_post_fused", (in_h, in_w), win)
    dev = rre.device
    twr, twi = device_arrays(_dif_twiddles, (wp, True), dev)
    plan = _lane_plan(wk, wp)
    outs = [torch.empty((t, in_h, in_w), dtype=torch.float32, device=dev)
            for _ in range(3)]
    err = library().pbmm_rowifft_post(
        rre.data_ptr(), rim.data_ptr(), i_plane.data_ptr(),
        q_plane.data_ptr(), win.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        c_ints(kp for kp, _ in plan), c_ints(rev for _, rev in plan),
        len(plan), c_floats(blur_taps(cfg.blur_size)), _radius(cfg),
        c_floats(YIQ_TO_RGB.reshape(-1)), t, hr, wk, wp, in_h, in_w,
        geom.y0 - rows0, geom.x0, float(1.0 / (geom.pad_h * wp)),
        stream_handle(dev))
    check_launch(err, "rowifft_post_fused")
    rowifft_post_fused.launches += 1
    return tuple(outs)


rowifft_post_fused.launches = 0
