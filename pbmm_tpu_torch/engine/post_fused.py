"""Kernel 3 of the main path: row IFFT merged with the post stage.

Counterpart of `pbmm_tpu/engine/post_pallas.py` (renamed: the port holds
no Pallas) for what the main path runs: `_radius`, `_out_block`,
`post_pallas_ok` (the geometry predicate, kept under its JAX name so the
two packages route alike) and `rowifft_post_fused` in all three output
layouts, with f32 I/Q planes or uint8 source frames for the chroma
(CUDA: `csrc/rowifft_post.cu`).

The chain per frame: rebuild the missing Hermitian tiles, row IFFT
(bit-reversed lanes in, natural out), |z| / (pad_h * pad_w), the
reference's 5-tap blur horizontally then vertically, the crop, the
windowed original I/Q, YIQ -> RGB and the [0, 1] clip
(`MotionMagnificationProcessor.cs:196-205`).  The reconstruction never
leaves the kernel.
"""

from __future__ import annotations

import torch

from pbmm_tpu_torch.core.color import RGB_TO_YIQ, YIQ_TO_RGB, channel_mix
from pbmm_tpu_torch.core.window import Geometry, blur_taps, geometry_for
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.spectral.fused import lane_plan, rebuilt_row_magnitude
from pbmm_tpu_torch.spectral.radix2 import _dif_twiddles, check_pow2

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


_LAYOUTS = ("tuple3", "planar", "planar_u8")  # csrc/rowifft_post.cu order


def _u8_chroma_coeffs():
    """The I and Q rows of RGB -> YIQ with the 1/255 scale folded in, as
    the JAX kernel forms them (`post_pallas.py:326-331`): the u8 chroma
    path multiplies the raw 0-255 values by these."""
    s = 1.0 / 255.0
    my = RGB_TO_YIQ
    return tuple(float(my[d, c] * s) for d in (1, 2) for c in range(3))


def _check_post(rre, i_plane, q_plane, rgb_u8, cfg, in_h, in_w, pad_mode,
                rows0, full_w, out_layout):
    """Validate a call; returns (geometry, full width)."""
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    if (rgb_u8 is None) == (i_plane is None or q_plane is None):
        raise ValueError("pass either the f32 I/Q planes or rgb_u8")
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
                           rgb_u8=None, out_layout: str = "tuple3"):
    """Plain PyTorch version of `rowifft_post_fused`: the rebuild and row
    IFFT of `rebuilt_row_magnitude`, the blur as rolls and row slices,
    the chroma and RGB matrix as f32 multiplies and adds in the JAX
    kernel's order."""
    geom, wp = _check_post(rre, i_plane, q_plane, rgb_u8, cfg, in_h, in_w,
                           pad_mode, rows0, full_w, out_layout)
    mag = rebuilt_row_magnitude(rre, rim, wp, 1.0 / (geom.pad_h * wp))
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
    if rgb_u8 is not None:
        c = _u8_chroma_coeffs()
        rgb = [rgb_u8[:, k].to(torch.float32) for k in range(3)]
        iw = channel_mix(*rgb, c[:3]) * win
        qw = channel_mix(*rgb, c[3:]) * win
    else:
        iw = i_plane * win
        qw = q_plane * win
    chans = tuple(torch.clamp(channel_mix(y, iw, qw, YIQ_TO_RGB[d]), 0.0, 1.0)
                  for d in range(3))
    if out_layout == "tuple3":
        return chans
    planar = torch.stack(chans, dim=1)
    if out_layout == "planar":
        return planar
    return torch.round(planar * 255.0).to(torch.uint8)


def rowifft_post_fused(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                       in_h: int, in_w: int, pad_mode: str, full_w=None,
                       rgb_u8=None, out_layout: str = "tuple3"):
    """(T, Hr, Wk) column-IFFT output rows (region rows from `rows0`,
    bit-reversed kept lanes) + the original chroma + (H, W) crop-region
    Hann -> RGB in [0, 1].

    The chroma is either the (T, H, W) f32 I/Q planes or, with
    `rgb_u8`, the (T, 3, H, W) uint8 source frames, from which the
    kernel derives I/Q itself (i_plane/q_plane None).  `out_layout`:
    "tuple3" (three (T, H, W) f32 planes), "planar" (one (T, 3, H, W)
    f32 array) or "planar_u8" (the same as round(255 x) in uint8).
    `full_w`: the padded width when the lanes are the kept Hermitian
    half.

    CPU tensors take `rowifft_post_fused_ref`; CUDA tensors launch
    `csrc/rowifft_post.cu`."""
    if rre.device.type == "cpu":
        return rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg,
                                      rows0, in_h, in_w, pad_mode, full_w,
                                      rgb_u8, out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom, wp = _check_post(rre, i_plane, q_plane, rgb_u8, cfg, in_h, in_w,
                           pad_mode, rows0, full_w, out_layout)
    t, hr, wk = rre.shape
    # csrc/rowifft_post.cu holds one complex row plus 8 output rows and
    # their blur halo of |z| in shared memory (227 KB a block on an H100),
    # and takes blur radii up to 4 (PP_MAXR).
    r = _radius(cfg)
    if r > 4 or (2 + 8 + 2 * r) * wp * 4 > 232448:
        raise ValueError(f"the CUDA post kernel takes blur radius <= 4 and "
                         f"rows that fit shared memory; got radius {r}, "
                         f"{wp} lanes")
    check_cuda("rowifft_post_fused", (t, hr, wk), rre, rim)
    check_cuda("rowifft_post_fused", (in_h, in_w), win)
    if rgb_u8 is None:
        check_cuda("rowifft_post_fused", (t, in_h, in_w), i_plane, q_plane)
        chroma = (i_plane.data_ptr(), q_plane.data_ptr(), None)
    else:
        check_cuda("rowifft_post_fused", (t, 3, in_h, in_w), rgb_u8,
                   dtype=torch.uint8)
        chroma = (None, None, rgb_u8.data_ptr())
    dev = rre.device
    if out_layout == "tuple3":
        outs = [torch.empty((t, in_h, in_w), dtype=torch.float32,
                            device=dev) for _ in range(3)]
    else:
        dt = torch.uint8 if out_layout == "planar_u8" else torch.float32
        outs = [torch.empty((t, 3, in_h, in_w), dtype=dt, device=dev)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    twr, twi = device_arrays(_dif_twiddles, (wp, True), dev)
    plan = lane_plan(wk, wp)
    err = library().pbmm_rowifft_post(
        rre.data_ptr(), rim.data_ptr(), *chroma, win.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), *ptrs,
        c_ints(kp for kp, _ in plan), c_ints(rev for _, rev in plan),
        len(plan), c_floats(blur_taps(cfg.blur_size)), r,
        c_floats(YIQ_TO_RGB.reshape(-1)), c_floats(_u8_chroma_coeffs()),
        _LAYOUTS.index(out_layout), t, hr, wk, wp, in_h, in_w,
        geom.y0 - rows0, geom.x0, float(1.0 / (geom.pad_h * wp)),
        stream_handle(dev))
    check_launch(err, "rowifft_post_fused")
    rowifft_post_fused.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


rowifft_post_fused.launches = 0
