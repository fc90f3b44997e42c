"""The post kernels: kernels 3, 11 and 10.

Counterpart of `pbmm_tpu/engine/post_pallas.py` (renamed: the port holds
no Pallas): `_radius`, `_out_block`, `post_pallas_ok` (the geometry
predicate, kept under its JAX name so the two packages route alike),
`rowifft_post_fused` (kernel 3, the y_only tail; CUDA:
`csrc/rowifft_post.cu`), `post_fused_rgb` (kernel 11, the chroma="rgb"
tail after kernel 7; CUDA: `csrc/post_rgb.cu`) and `post_fused` (kernel
10, the y_only tail after kernel 7; CUDA: `csrc/post_rgb.cu`), all in the
three output layouts.  Like the JAX package's, the engines reach
`post_fused` only through `engine.video._post_block`, where kernel 3
always serves first: no entry point launches it.

Kernel 3's chain per frame: rebuild the missing Hermitian tiles, row
IFFT (bit-reversed lanes in, natural out), |z| (or Re z) / (pad_h *
pad_w), the reference's 5-tap blur horizontally then vertically, the
crop, the windowed original I/Q, the optional window compensation and
YIQ gains, YIQ -> RGB and the [0, 1] clip
(`MotionMagnificationProcessor.cs:196-205`).  The reconstruction never
leaves the kernel.  Kernel 11 runs the same blur, crop and epilogue on
the three reconstructed YIQ planes.
"""

from __future__ import annotations

import numpy as np
import torch

from pbmm_tpu_torch.core.color import RGB_TO_YIQ, YIQ_TO_RGB, channel_mix
from pbmm_tpu_torch.core.window import Geometry, blur_taps, geometry_for
from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.spectral.fused import lane_plan, rebuilt_row_ifft
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


def _halo_check(geom, r: int, rows0: int, hr: int, wp: int) -> None:
    yrow0 = geom.y0 - rows0
    if (yrow0 - r < 0 or yrow0 + geom.in_h + r > hr or geom.x0 < r
            or geom.x0 + geom.in_w + r > wp):
        raise ValueError("the blur halo of the crop leaves the region rows "
                         f"(rows0={rows0}, region height {hr})")


def _check_post(rre, i_plane, q_plane, rgb_u8, cfg, in_h, in_w, pad_mode,
                rows0, full_w, out_layout):
    """Validate a call; returns (geometry, full width)."""
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    if (rgb_u8 is None) == (i_plane is None or q_plane is None):
        raise ValueError("pass either the f32 I/Q planes or rgb_u8")
    t, hr, wk = rre.shape
    wp = full_w if full_w is not None else wk
    check_pow2(wp, "row IFFT length")
    if wp % _LANE or wk % _LANE:
        raise ValueError(f"widths must be multiples of 128: {wk}, {wp}")
    geom = geometry_for(in_h, in_w, pad_mode)
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom, wp


def _blur_crop(rec, cfg, geom, rows0: int):
    """(T, Hr, W) region rows -> (T, H, W_in): the reference's blur,
    horizontal taps first (wrapping around the padded width, as
    `pltpu.roll` does; the crop never reaches the wrap), then vertical,
    and the crop, in the JAX kernels' order of products and sums."""
    taps = blur_taps(cfg.blur_size)
    r = _radius(cfg)
    hb = rec * taps[r]
    for k in range(1, r + 1):
        hb = hb + (torch.roll(rec, k, -1) * taps[r - k]
                   + torch.roll(rec, -k, -1) * taps[r + k])
    top = geom.y0 - rows0 - r
    vb = hb[:, top:top + geom.in_h] * taps[0]
    for k in range(1, 2 * r + 1):
        vb = vb + hb[:, top + k:top + k + geom.in_h] * taps[k]
    return vb[..., geom.x0:geom.x0 + geom.in_w]


def _finish(y, iw, qw, win, cfg, out_layout: str):
    """The kernels' epilogue: ÷ max(win, 1e-3) (as a multiply by its
    reciprocal) when `compensate_window`, the YIQ gains when
    `apply_yiq_gains`, YIQ -> RGB with the [0, 1] clip, then the output
    layout (`post_pallas.py:167-178,335-359,476-487`)."""
    if cfg.compensate_window:
        inv = 1.0 / torch.clamp_min(win, 1e-3)
        y, iw, qw = y * inv, iw * inv, qw * inv
    if cfg.apply_yiq_gains:
        g = [np.float32(v) for v in cfg.yiq_gains]
        y, iw, qw = y * g[0], iw * g[1], qw * g[2]
    chans = tuple(torch.clamp(channel_mix(y, iw, qw, YIQ_TO_RGB[d]), 0.0, 1.0)
                  for d in range(3))
    if out_layout == "tuple3":
        return chans
    planar = torch.stack(chans, dim=1)
    if out_layout == "planar":
        return planar
    return torch.round(planar * 255.0).to(torch.uint8)


def _epilogue_args(cfg):
    """(compensate, gains, g_y, g_i, g_q) of the CUDA epilogues."""
    return (int(cfg.compensate_window), int(cfg.apply_yiq_gains),
            *(float(g) for g in cfg.yiq_gains))


def _outputs(t, in_h, in_w, out_layout, dev):
    """The output tensors of a layout and their three pointers."""
    if out_layout == "tuple3":
        outs = [torch.empty((t, in_h, in_w), dtype=torch.float32,
                            device=dev) for _ in range(3)]
    else:
        dt = torch.uint8 if out_layout == "planar_u8" else torch.float32
        outs = [torch.empty((t, 3, in_h, in_w), dtype=dt, device=dev)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    return outs, ptrs


def rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                           in_h: int, in_w: int, pad_mode: str, full_w=None,
                           rgb_u8=None, out_layout: str = "tuple3"):
    """Plain PyTorch version of `rowifft_post_fused`: the rebuild and row
    IFFT of `rebuilt_row_ifft`, `_blur_crop`, the windowed chroma and
    `_finish`, as f32 multiplies and adds in the JAX kernel's order."""
    geom, wp = _check_post(rre, i_plane, q_plane, rgb_u8, cfg, in_h, in_w,
                           pad_mode, rows0, full_w, out_layout)
    rec = rebuilt_row_ifft(rre, rim, wp, 1.0 / (geom.pad_h * wp),
                           cfg.reconstruct == "magnitude")
    y = _blur_crop(rec, cfg, geom, rows0)
    if rgb_u8 is not None:
        c = _u8_chroma_coeffs()
        rgb = [rgb_u8[:, k].to(torch.float32) for k in range(3)]
        iw = channel_mix(*rgb, c[:3]) * win
        qw = channel_mix(*rgb, c[3:]) * win
    else:
        iw = i_plane * win
        qw = q_plane * win
    return _finish(y, iw, qw, win, cfg, out_layout)


@checked
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
    half.  `cfg.reconstruct`, `compensate_window` and the YIQ gains are
    served as in the JAX kernel.

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
    outs, ptrs = _outputs(t, in_h, in_w, out_layout, dev)
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
        int(cfg.reconstruct == "magnitude"), *_epilogue_args(cfg),
        stream_handle(dev))
    check_launch(err, "rowifft_post_fused")
    rowifft_post_fused.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


rowifft_post_fused.launches = 0


# ---------------------------------------------------------------------------
# Kernel 11: the chroma="rgb" post tail
# ---------------------------------------------------------------------------


def _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode, out_layout):
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    t3, hr, wp = chans3.shape
    if t3 % 3:
        raise ValueError(f"{t3} rows are not whole frames of 3 planes")
    geom = geometry_for(in_h, in_w, pad_mode)
    if wp != geom.pad_w:
        raise ValueError(f"region rows of {wp} lanes for a pad width of "
                         f"{geom.pad_w}")
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom


def post_fused_rgb_ref(chans3, win, cfg, rows0: int, in_h: int, in_w: int,
                       pad_mode: str, out_layout: str = "tuple3"):
    """Plain PyTorch version of `post_fused_rgb`: `_blur_crop` of each
    plane, then `_finish`."""
    geom = _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode,
                           out_layout)
    y, iw, qw = (_blur_crop(chans3[c::3], cfg, geom, rows0)
                 for c in range(3))
    return _finish(y, iw, qw, win, cfg, out_layout)


@checked
def post_fused_rgb(chans3, win, cfg, rows0: int, in_h: int, in_w: int,
                   pad_mode: str, out_layout: str = "tuple3"):
    """(3T, Hr, Wp) reconstruction rows (plane-minor frame-major: frame
    t's Y/I/Q at rows 3t..3t+2, region rows from `rows0`) + (H, W)
    crop-region Hann -> RGB in [0, 1]: the chroma="rgb" tail, where all
    three planes are processed reconstructions.  Each plane is blurred
    and cropped; then the window compensation, the YIQ gains, YIQ -> RGB
    and the clip, written in `out_layout` as `rowifft_post_fused` does.
    Callers have checked `post_pallas_ok`.

    CPU tensors take `post_fused_rgb_ref`; CUDA tensors launch
    `csrc/post_rgb.cu`."""
    if chans3.device.type == "cpu":
        return post_fused_rgb_ref(chans3, win, cfg, rows0, in_h, in_w,
                                  pad_mode, out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom = _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode,
                           out_layout)
    t3, hr, wp = chans3.shape
    r = _radius(cfg)
    if r > 4:
        raise ValueError(f"the CUDA post kernel takes blur radius <= 4, "
                         f"got {r}")
    check_cuda("post_fused_rgb", (t3, hr, wp), chans3)
    check_cuda("post_fused_rgb", (in_h, in_w), win)
    dev = chans3.device
    outs, ptrs = _outputs(t3 // 3, in_h, in_w, out_layout, dev)
    err = library().pbmm_post_rgb(
        chans3.data_ptr(), win.data_ptr(), *ptrs,
        c_floats(blur_taps(cfg.blur_size)), r,
        c_floats(YIQ_TO_RGB.reshape(-1)), _LAYOUTS.index(out_layout),
        t3 // 3, hr, wp, in_h, in_w, geom.y0 - rows0, geom.x0,
        *_epilogue_args(cfg), stream_handle(dev))
    check_launch(err, "post_fused_rgb")
    post_fused_rgb.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


post_fused_rgb.launches = 0


# ---------------------------------------------------------------------------
# Kernel 10: the y_only post tail on reconstructed rows
# ---------------------------------------------------------------------------


def _check_post_yonly(chans, i_plane, q_plane, cfg, rows0, in_h, in_w,
                      pad_mode, out_layout):
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    t, hr, wp = chans.shape
    geom = geometry_for(in_h, in_w, pad_mode)
    if wp != geom.pad_w:
        raise ValueError(f"region rows of {wp} lanes for a pad width of "
                         f"{geom.pad_w}")
    for pl in (i_plane, q_plane):
        if tuple(pl.shape) != (t, in_h, in_w):
            raise ValueError(f"chroma plane {tuple(pl.shape)} for {t} "
                             f"frames of {in_h} x {in_w}")
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom


def post_fused_ref(chans, i_plane, q_plane, win, cfg, rows0: int, in_h: int,
                   in_w: int, pad_mode: str, out_layout: str = "tuple3"):
    """Plain PyTorch version of `post_fused`: `_blur_crop` of the Y rows,
    the windowed chroma, then `_finish`."""
    geom = _check_post_yonly(chans, i_plane, q_plane, cfg, rows0, in_h,
                             in_w, pad_mode, out_layout)
    y = _blur_crop(chans, cfg, geom, rows0)
    return _finish(y, i_plane * win, q_plane * win, win, cfg, out_layout)


@checked
def post_fused(chans, i_plane, q_plane, win, cfg, rows0: int, in_h: int,
               in_w: int, pad_mode: str, out_layout: str = "tuple3"):
    """(T, Hr, Wp) reconstruction rows of Y (region rows from `rows0`) +
    (T, H, W) original I/Q planes + (H, W) crop-region Hann -> RGB in
    [0, 1]: the blur, the crop, the windowed chroma, the window
    compensation and YIQ gains, YIQ -> RGB and the clip (`posttail`'s
    math), written in `out_layout` as `post_fused_rgb` does.  Callers
    have checked `post_pallas_ok`.

    CPU tensors take `post_fused_ref`; CUDA tensors launch
    `csrc/post_rgb.cu::pbmm_post_yonly`."""
    if chans.device.type == "cpu":
        return post_fused_ref(chans, i_plane, q_plane, win, cfg, rows0,
                              in_h, in_w, pad_mode, out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom = _check_post_yonly(chans, i_plane, q_plane, cfg, rows0, in_h,
                             in_w, pad_mode, out_layout)
    t, hr, wp = chans.shape
    r = _radius(cfg)
    if r > 4:
        raise ValueError(f"the CUDA post kernel takes blur radius <= 4, "
                         f"got {r}")
    check_cuda("post_fused", (t, hr, wp), chans)
    check_cuda("post_fused", (t, in_h, in_w), i_plane, q_plane)
    check_cuda("post_fused", (in_h, in_w), win)
    dev = chans.device
    outs, ptrs = _outputs(t, in_h, in_w, out_layout, dev)
    err = library().pbmm_post_yonly(
        chans.data_ptr(), i_plane.data_ptr(), q_plane.data_ptr(),
        win.data_ptr(), *ptrs, c_floats(blur_taps(cfg.blur_size)), r,
        c_floats(YIQ_TO_RGB.reshape(-1)), _LAYOUTS.index(out_layout), t, hr,
        wp, in_h, in_w, geom.y0 - rows0, geom.x0, *_epilogue_args(cfg),
        stream_handle(dev))
    check_launch(err, "post_fused")
    post_fused.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


post_fused.launches = 0
