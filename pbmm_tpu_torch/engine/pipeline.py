"""Pre stage and routing predicates of the chunk engine.

Counterpart of `pbmm_tpu/engine/pipeline.py` for the chunk engine:
`hermitian_active`, `blur_row_window`, `preprocess_cl` (interleaved or
planar, f32 or u8 frames, y_only or rgb, stopping after the row FFT),
`preprocess` (one frame's whole spectrum, for the pow-2 bootstrap) and
the `posttail` of the two-kernel tail.  The Y/I/Q plane FMAs, the centre
pad and `posttail` are plain torch ops, as the JAX package leaves them
to XLA; kernel 1 (`spectral.fused.windowed_row_fft`) or, for planar
uint8 y_only frames, kernel 4 (`windowed_row_fft_u8planar`) does the row
FFT, and kernel 5 (`col_fft_zero_padded`) the column FFT of `preprocess`.
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
    col_fft_zero_padded,
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


def _luma_chroma(frames, cfg: MagnifyConfig, want_iq: bool):
    """The FFT-bound planes and the original chroma of (T, H, W, 3) or
    (T, 3, H, W) frames, as torch FMAs in the JAX package's order:
    y_only -> (Y (T, H, W), I, Q) with I/Q None unless `want_iq`; rgb ->
    (the (3T, H, W) Y/I/Q stack, plane-minor frame-major, None, None)."""
    f = unit_float(frames)
    rgb = (f[:, 0], f[:, 1], f[:, 2]) if is_planar(frames) else (
        f[..., 0], f[..., 1], f[..., 2])
    if cfg.chroma == "rgb":
        planes = [channel_mix(*rgb, RGB_TO_YIQ[d]) for d in range(3)]
        return torch.stack(planes, dim=-3).reshape(
            (-1,) + tuple(planes[0].shape[-2:])), None, None
    return tuple(channel_mix(*rgb, RGB_TO_YIQ[d]) if d == 0 or want_iq
                 else None for d in range(3))


def _row_spectra(fft_in, geom: Geometry, cfg: MagnifyConfig):
    """Centre-pad (N, H, W) planes to the content rows of the padded
    frame and run kernel 1 on them."""
    r0, r1 = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    slab = F.pad(fft_in, (geom.x0, geom.pad_w - geom.in_w - geom.x0,
                          geom.y0 - r0, r1 - geom.y0 - geom.in_h))
    return windowed_row_fft(slab, pad_h=geom.pad_h, row0=r0,
                            keep_half=hermitian_active(cfg, geom))


def check_fused(cfg: MagnifyConfig) -> None:
    """Raise for the spectral paths the port does not serve."""
    if not fused_eligible(cfg):
        raise NotImplementedError(
            "only the fused spectral path (MagnifyConfig().tuned_for_tpu()) "
            "is ported; fft_backend='xla'/'mxu' and the unfused kernels are "
            "ROADMAP items 8 and 10")


def preprocess(frame: torch.Tensor, cfg: MagnifyConfig):
    """One (H, W, 3) or (3, H, W) RGB frame -> its (C, pad_h, Wk) spectrum
    (re, im) in the working layout: C = 1 (Y) or 3 (Y, I, Q with
    chroma="rgb"); the torch FMAs, kernel 1 on the content rows and
    kernel 5 (the zero-embedded radix-2 column FFT).  The
    `fft_backend="pallas"` branch of the JAX function, the one
    `video_init` runs; pow-2 heights only (tight heights start a stream
    through kernel 2 instead).  The YIQ planes the JAX function also
    returns feed the scan engine (ROADMAP item 8) and are not built."""
    check_fused(cfg)
    planar = is_planar(frame[None])
    h_in, w_in = frame.shape[-2:] if planar else frame.shape[-3:-1]
    geom = geometry_for(h_in, w_in, cfg.pad_mode)
    if geom.pad_h & (geom.pad_h - 1):
        raise ValueError(
            f"preprocess takes pow-2 column heights (radix-2 kernel 5); "
            f"pad_h={geom.pad_h} starts through magnify_video's chunk "
            "kernel")
    fft_in, _, _ = _luma_chroma(frame[None], cfg, want_iq=False)
    re, im = _row_spectra(fft_in, geom, cfg)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    return col_fft_zero_padded(re, im, pad_h=geom.pad_h, row0=r0)


def preprocess_cl(frames: torch.Tensor, cfg: MagnifyConfig,
                  want_iq: bool = True):
    """Channels-last pre stage: interleaved (T, H, W, 3) or planar
    (T, 3, H, W) RGB, f32 or uint8 -> (re, im, i_plane, q_plane), re/im
    the row spectra of the windowed content rows of the padded planes:
    (T, Hc, Wk) of Y with i/q the (T, H, W) original chroma (y_only), or
    (3T, Hc, Wk) of Y, I and Q, plane-minor frame-major, with i/q None
    (chroma="rgb").  It stops after the row FFT: the chunk engine runs
    the column stages itself (the JAX function's `through_col=False`
    form).

    `want_iq=False` builds no I/Q planes (they return None): the caller
    takes the chroma from the uint8 planes inside kernel 3.  Planar
    uint8 frames then go straight to kernel 4 (y_only), which forms the
    luma, pad and window itself; every other input takes the torch FMAs
    and kernel 1."""
    check_fused(cfg)
    planar = is_planar(frames)
    h_in, w_in = frames.shape[-2:] if planar else frames.shape[-3:-1]
    geom = geometry_for(h_in, w_in, cfg.pad_mode)
    if (planar and frames.dtype == torch.uint8 and cfg.chroma != "rgb"
            and not want_iq and geom.pad_w & (geom.pad_w - 1) == 0):
        r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h,
                                   geom.pad_h)
        re, im = windowed_row_fft_u8planar(
            frames, tuple(float(c) for c in RGB_TO_YIQ[0]),
            pad_h=geom.pad_h, pad_w=geom.pad_w, y0=geom.y0, x0=geom.x0,
            row0=r0, keep_half=hermitian_active(cfg, geom))
        return re, im, None, None
    fft_in, i_plane, q_plane = _luma_chroma(frames, cfg, want_iq)
    re, im = _row_spectra(fft_in, geom, cfg)
    return re, im, i_plane, q_plane


def posttail(chans: torch.Tensor, geom: Geometry, cfg: MagnifyConfig,
             row0: int = 0, iq=None) -> torch.Tensor:
    """The post stage on the real reconstruction, as torch ops: blur ->
    crop -> chroma -> optional window compensation and YIQ gains -> YIQ
    -> RGB with the [0, 1] clip (`MotionMagnificationProcessor.cs:
    196-205`; the JAX function, `pipeline.py:483-526`).

    chans: (T, C, Hr, pad_w) reconstruction rows from padded row `row0`
    of the frame `geom`: C = 1, the processed Y, with `iq` the (T, H, W)
    original I and Q planes (windowed here); or C = 3, the processed Y,
    I and Q (chroma="rgb", `iq` None).  Returns (T, 3, H, W) RGB."""
    # The row window shifts the crop origin; the Hann region below keeps
    # the true padded geometry.
    geom_rows = Geometry(geom.in_h, geom.in_w, chans.shape[-2], geom.pad_w,
                         geom.y0 - row0, geom.x0)
    chans = blur_then_crop(chans, geom_rows, cfg.blur_size)
    win_c = hann2d_region(geom, device=chans.device)
    if chans.shape[-3] == 3:
        out_yiq = chans
    else:
        out_yiq = torch.cat([chans, torch.stack(iq, dim=-3) * win_c],
                            dim=-3)
    if cfg.compensate_window:
        out_yiq = out_yiq / torch.clamp_min(win_c, 1e-3)
    if cfg.apply_yiq_gains:
        gains = torch.tensor(cfg.yiq_gains, dtype=torch.float32,
                             device=chans.device).reshape((3, 1, 1))
        out_yiq = out_yiq * gains
    return yiq_to_rgb(out_yiq, saturate=True, axis=-3)
