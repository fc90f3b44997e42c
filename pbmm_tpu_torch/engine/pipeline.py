"""Pre stage and routing predicates of the chunk engine.

Counterpart of `pbmm_tpu/engine/pipeline.py` for the chunk engine:
`hermitian_active`, `blur_row_window`, `preprocess_cl` (interleaved or
planar, f32 or u8 frames, stopping after the row FFT) and the y_only
`posttail` of the two-kernel tail.  The Y/I/Q plane FMAs, the centre pad
and `posttail` are plain torch ops, as the JAX package leaves them to
XLA; kernel 1 (`spectral.fused.windowed_row_fft`) or, for planar uint8
frames, kernel 4 (`windowed_row_fft_u8planar`) does the row FFT.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import (
    RGB_TO_YIQ,
    channel_mix,
    unit_float,
    yiq_to_rgb,
)
from pbmm_tpu_torch.core.window import (
    Geometry,
    blur_taps,
    blur_then_crop,
    geometry_for,
    hann2d_region,
)
from pbmm_tpu_torch.spectral.fused import (
    aligned_row_window,
    fused_eligible,
    windowed_row_fft,
    windowed_row_fft_u8planar,
)
from pbmm_tpu_torch.spectral.hermitian import hermitian_saves


def is_planar(frames) -> bool:
    """(T, 3, H, W) channel-planar frames (the y4m / video-file layout),
    as against the reference's interleaved (T, H, W, 3)."""
    return (frames.ndim == 4 and frames.shape[1] == 3
            and frames.shape[-1] != 3)


def hermitian_active(cfg: MagnifyConfig, geom: Geometry) -> bool:
    """Whether the Hermitian-half kept-lane layout is in effect: the
    fully-fused path serves the config, the padded sizes tile cleanly and
    the layout actually saves lanes."""
    return (
        cfg.use_hermitian_spectral
        and fused_eligible(cfg)
        and geom.pad_h % 128 == 0
        and geom.pad_w % 128 == 0
        and hermitian_saves(geom.pad_w)
    )


def blur_row_window(geom: Geometry, cfg: MagnifyConfig):
    """Block-aligned spatial-row cover of the crop region plus the blur
    halo: the only inverse-transform rows the output depends on."""
    radius = (len(blur_taps(cfg.blur_size)) - 1) // 2
    return aligned_row_window(
        geom.y0 - radius, geom.y0 + geom.in_h + radius, geom.pad_h
    )


def preprocess_cl(frames: torch.Tensor, cfg: MagnifyConfig,
                  want_iq: bool = True):
    """Channels-last pre stage: interleaved (T, H, W, 3) or planar
    (T, 3, H, W) RGB, f32 or uint8 -> (re, im, i_plane, q_plane), re/im
    the (T, Hc, Wk) row spectra of the windowed content rows of the
    padded Y plane and i/q the (T, H, W) original chroma.  It stops after
    the row FFT: the chunk engine runs the column stages itself (the JAX
    function's `through_col=False` form).

    `want_iq=False` builds no I/Q planes (they return None): the caller
    takes the chroma from the uint8 planes inside kernel 3.  Planar
    uint8 frames then go straight to kernel 4, which forms the luma,
    pad and window itself; every other input takes the torch FMAs and
    kernel 1."""
    if not fused_eligible(cfg):
        raise NotImplementedError(
            "only the fused spectral path (MagnifyConfig().tuned_for_tpu()) "
            "is ported; fft_backend='xla'/'mxu' and the unfused kernels are "
            "ROADMAP items 8 and 10")
    if cfg.chroma != "y_only":
        raise NotImplementedError(
            "chroma='rgb' is not ported yet (ROADMAP item 6)")
    planar = is_planar(frames)
    h_in, w_in = frames.shape[-2:] if planar else frames.shape[-3:-1]
    geom = geometry_for(h_in, w_in, cfg.pad_mode)
    keep = hermitian_active(cfg, geom)
    r0, r1 = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    m = RGB_TO_YIQ
    if (planar and frames.dtype == torch.uint8 and not want_iq
            and geom.pad_w & (geom.pad_w - 1) == 0):
        re, im = windowed_row_fft_u8planar(
            frames, tuple(float(c) for c in m[0]), pad_h=geom.pad_h,
            pad_w=geom.pad_w, y0=geom.y0, x0=geom.x0, row0=r0,
            keep_half=keep)
        return re, im, None, None
    f = unit_float(frames)
    rgb = (f[:, 0], f[:, 1], f[:, 2]) if planar else (
        f[..., 0], f[..., 1], f[..., 2])
    y, i_plane, q_plane = (channel_mix(*rgb, m[d]) if d == 0 or want_iq
                           else None for d in range(3))
    slab = F.pad(y, (geom.x0, geom.pad_w - geom.in_w - geom.x0,
                     geom.y0 - r0, r1 - geom.y0 - geom.in_h))
    re, im = windowed_row_fft(slab, pad_h=geom.pad_h, row0=r0,
                              keep_half=keep)
    return re, im, i_plane, q_plane


def posttail(chans: torch.Tensor, yiq_small: torch.Tensor,
             cfg: MagnifyConfig, row0: int = 0) -> torch.Tensor:
    """The post stage on the real reconstruction, as torch ops: blur ->
    crop -> processed Y with the windowed original I/Q -> YIQ -> RGB with
    the [0, 1] clip (`MotionMagnificationProcessor.cs:196-205`).

    chans: (T, 1, Hr, pad_w) |z| rows from padded row `row0`;
    yiq_small: (T, 3, H, W), of which planes 1 and 2 (I, Q) are read.
    Returns (T, 3, H, W) RGB.  The y_only branch of the JAX function."""
    if cfg.chroma != "y_only":
        raise NotImplementedError(
            "chroma='rgb' is not ported yet (ROADMAP item 6)")
    if cfg.compensate_window or cfg.apply_yiq_gains:
        raise NotImplementedError(
            "compensate_window / apply_yiq_gains are not ported yet "
            "(ROADMAP item 6)")
    h, w = yiq_small.shape[-2:]
    geom = geometry_for(h, w, cfg.pad_mode)
    # The row window shifts the crop origin; the Hann region below keeps
    # the true padded geometry.
    geom_rows = Geometry(geom.in_h, geom.in_w, chans.shape[-2], geom.pad_w,
                         geom.y0 - row0, geom.x0)
    chans = blur_then_crop(chans, geom_rows, cfg.blur_size)
    win_c = hann2d_region(geom, device=chans.device)
    out_yiq = torch.cat([chans[..., 0:1, :, :],
                         yiq_small[..., 1:, :, :] * win_c], dim=-3)
    return yiq_to_rgb(out_yiq, saturate=True, axis=-3)
