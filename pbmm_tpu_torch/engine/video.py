"""Chunked video magnification: the spectrum-resident chunk engine.

Counterpart of `pbmm_tpu/engine/video.py` for the batched chunk engine
(`engine="batched"`, `cache_prev_spectrum=True`, the fused spectral
path): `magnify_video -> _magnify_bootstrap -> _chunk_colspec`, the
bypass and `video_init`.  Per chunk, the pre stage and kernel 1 (row FFT;
kernel 4 from planar uint8 y_only frames), kernel 2 (column FFT + phase
+ column IFFT, the previous spectrum and the IIR taps carried on chip)
and the tail run in turn, and the last frame's spectrum is returned as
the state for the next chunk.  The tail is kernel 3 (row IFFT + post,
writing the output layout) for y_only where `post_pallas_ok` holds, else
kernel 7 (row IFFT) and then kernel 11 (chroma="rgb" where
`post_pallas_ok` holds) or the torch `posttail`.

Every config of that engine is served: pyramid or standard mode, radial
or steerable bands, any phase scale, the two-frame or the IIR temporal
model, y_only or rgb chroma, tight or pow-2 padding, both
reconstructions, the window compensation and YIQ gains, and the bypass.
A stream starts (`state=None`) through kernel 2 against a zero previous
spectrum at tight heights or with planar frames, else from `video_init`
(kernel 5 on frame 0), as in the JAX package.

The carried state is `VideoState`, with the JAX package's leaves, shapes
and spectral layout (`engine.state` converts between the two packages).
Frame 0 of a stream passes through unchanged, like the reference's first
rendered frame (`MotionMagnificationProcessor.cs:111-117`).

The other engines (`engine="scan"`, `cache_prev_spectrum=False`, the
unfused backends) raise `NotImplementedError` naming the ROADMAP item
that brings them; none is routed elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import RGB_TO_YIQ, channel_mix, unit_float
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine.pipeline import (
    blur_row_window,
    check_fused,
    hermitian_active,
    is_planar,
    posttail,
    preprocess,
    preprocess_cl,
)
from pbmm_tpu_torch.engine.post_fused import (
    post_fused_rgb,
    post_pallas_ok,
    rowifft_post_fused,
)
from pbmm_tpu_torch.phase.temporal import TemporalState, temporal_init
from pbmm_tpu_torch.spectral.fused import (
    aligned_row_window,
    colspec_chunk,
    row_ifft_magnitude,
)
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width


class VideoState(NamedTuple):
    """Chunk-boundary state, the JAX package's leaves."""

    prev_spec_re: torch.Tensor  # (C, Hp, Wk) f32
    prev_spec_im: torch.Tensor
    prev_frame: torch.Tensor  # (0, 0, 0) f32 while spectra are cached
    temporal: TemporalState
    frame_idx: int  # frames consumed so far


def _working_width(cfg: MagnifyConfig, geom) -> int:
    return (hermitian_kept_width(geom.pad_w)
            if hermitian_active(cfg, geom) else geom.pad_w)


def _planes(cfg: MagnifyConfig) -> int:
    return 3 if cfg.chroma == "rgb" else 1


def _norm_shape(frames):
    """The frames' shape in the interleaved convention (T, H, W, 3)."""
    if is_planar(frames):
        t, _, h, w = frames.shape
        return (t, h, w, 3)
    return tuple(frames.shape)


def _emit(chans_cf: torch.Tensor, cfg: MagnifyConfig) -> torch.Tensor:
    """Channels-first (..., 3, H, W) f32 in [0, 1] -> the configured
    output layout."""
    if cfg.output_layout == "interleaved":
        return torch.movedim(chans_cf, -3, -1).contiguous()
    if cfg.output_layout == "planar":
        return chans_cf
    return torch.round(chans_cf * 255.0).to(torch.uint8)


def _layout_out(res, cfg: MagnifyConfig):
    """A post kernel's output in its layout ("tuple3" for interleaved)
    -> the configured output layout."""
    if cfg.output_layout == "interleaved":
        return torch.stack(list(res), dim=-1)
    return res


def _check_supported(frames, cfg: MagnifyConfig) -> None:
    """Raise for what only the entry point decides; each stage's wrapper
    rejects the configs and geometries its kernel does not serve."""
    if cfg.engine != "batched" or not cfg.cache_prev_spectrum:
        raise NotImplementedError(
            "the per-frame scan engine (engine='scan' or "
            "cache_prev_spectrum=False) is not ported yet (ROADMAP item 8)")
    check_fused(cfg)
    if frames.ndim != 4 or not (is_planar(frames) or frames.shape[-1] == 3):
        raise ValueError(f"expected (T, H, W, 3) or (T, 3, H, W) frames, "
                         f"got {tuple(frames.shape)}")
    if frames.shape[0] < 1:
        raise ValueError("magnify_video needs at least one frame")
    _, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    if geom.pad_h % 128 or _working_width(cfg, geom) % 128:
        # The JAX package runs these sizes on the scan engine
        # (`_colspec_ok` False).
        raise NotImplementedError(
            f"padded frames of {geom.pad_h}x{geom.pad_w} do not tile the "
            "chunk engine; the per-frame scan engine is ROADMAP item 8")


def _post_block(rec, i_plane, q_plane, cfg, geom, rows):
    """The post stage of the two-kernel tail on the (T * C, Hr, W)
    reconstruction rows: kernel 11 for chroma="rgb" where
    `post_pallas_ok` holds, else `posttail` as torch ops.  (For y_only
    the JAX package's `_post_block` takes `post_fused` where
    `post_pallas_ok` holds; the chunk engine never reaches it there,
    since the merged kernel 3 serves those geometries.)"""
    hr = rows[1] - rows[0]
    c = _planes(cfg)
    if post_pallas_ok(geom, cfg, rows[0], hr):
        if c == 1:
            raise NotImplementedError(
                "post_fused (the scan engine's post kernel) is not ported "
                "yet (ROADMAP item 8)")
        win = hann2d_region(geom, device=rec.device)
        return _layout_out(post_fused_rgb(
            rec, win, cfg, rows[0], geom.in_h, geom.in_w, cfg.pad_mode,
            out_layout=_POST_LAYOUT[cfg.output_layout]), cfg)
    chans = rec.reshape((rec.shape[0] // c, c, hr, geom.pad_w))
    iq = None if c == 3 else (i_plane, q_plane)
    return _emit(posttail(chans, geom, cfg, row0=rows[0], iq=iq), cfg)


_POST_LAYOUT = {"interleaved": "tuple3", "planar": "planar",
                "planar_u8": "planar_u8"}


def _tail_block(rre, rim, i_plane, q_plane, cfg, geom, rows, rgb_u8=None):
    """Column-IFFT output rows -> frames in the configured layout.

    For y_only where `post_pallas_ok` holds (as in the JAX package), the
    merged kernel 3 writes the layout itself, taking the chroma from
    `rgb_u8` ((T, 3, H, W) uint8 source frames) when given, else from
    the I/Q planes.  Otherwise kernel 7 (row IFFT + |z| or Re z) and
    `_post_block`; uint8 sources then give their I/Q planes here, once,
    as torch ops."""
    h, w = geom.in_h, geom.in_w
    if cfg.chroma != "rgb" and post_pallas_ok(geom, cfg, rows[0],
                                              rows[1] - rows[0]):
        win = hann2d_region(geom, device=rre.device)
        return _layout_out(rowifft_post_fused(
            rre, rim, i_plane, q_plane, win, cfg, rows[0], h, w,
            cfg.pad_mode, full_w=geom.pad_w, rgb_u8=rgb_u8,
            out_layout=_POST_LAYOUT[cfg.output_layout]), cfg)
    if rgb_u8 is not None:
        f = unit_float(rgb_u8)
        i_plane, q_plane = (channel_mix(f[:, 0], f[:, 1], f[:, 2],
                                        RGB_TO_YIQ[d]) for d in (1, 2))
    rec = row_ifft_magnitude(rre, rim,
                             magnitude=(cfg.reconstruct == "magnitude"),
                             pad_h=geom.pad_h, full_w=geom.pad_w)
    return _post_block(rec, i_plane, q_plane, cfg, geom, rows)


def _chunk_colspec(frames, state: VideoState, cfg: MagnifyConfig):
    """One chunk: the pre stage and kernel 1 (or kernel 4) over every
    frame, kernel 2 over the chunk with the previous spectrum (and the
    IIR taps) carried on chip, then the tail."""
    t, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    rows = blur_row_window(geom, cfg)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    # Planar uint8 sources feed kernel 4 and kernel 3's u8 chroma path:
    # no f32 plane of the source is ever built (the JAX package's gate).
    rgb_u8 = None
    if (is_planar(frames) and frames.dtype == torch.uint8
            and cfg.chroma != "rgb"
            and post_pallas_ok(geom, cfg, rows[0], rows[1] - rows[0])):
        rgb_u8 = frames
    rre_rows, rim_rows, i_plane, q_plane = preprocess_cl(
        frames, cfg, want_iq=rgb_u8 is None)
    iir = cfg.temporal.mode == "iir_bandpass"
    taps = (state.temporal.lp_fast, state.temporal.lp_slow) if iir else ()
    res = colspec_chunk(
        rre_rows, rim_rows, state.prev_spec_re, state.prev_spec_im, cfg,
        geom.pad_h, r0, *taps, out_rows=rows, full_w=geom.pad_w,
        planes=_planes(cfg))
    temporal = TemporalState(*res[4:]) if iir else state.temporal
    outs = _tail_block(res[0], res[1], i_plane, q_plane, cfg, geom, rows,
                       rgb_u8=rgb_u8)
    new_state = VideoState(res[2], res[3], state.prev_frame, temporal,
                           state.frame_idx + t)
    return outs, new_state


def _first_passthrough(frames, cfg: MagnifyConfig) -> torch.Tensor:
    """Frame 0 in the configured output layout: the reference's first
    rendered frame is the source frame, unmodified."""
    f0 = unit_float(frames[0])
    return _emit(f0 if is_planar(frames) else torch.movedim(f0, -1, -3),
                 cfg)


def _zero_state(geom, cfg: MagnifyConfig, device, frame_idx: int):
    """A zero spectrum and zero taps: every gate then passes the next
    frame through, the reference's own first-frame behaviour."""
    shape = (_planes(cfg), geom.pad_h, _working_width(cfg, geom))
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return VideoState(
        zeros, zeros,
        torch.zeros((0, 0, 0), dtype=torch.float32, device=device),
        temporal_init(shape, cfg.temporal, device=device), frame_idx)


def video_init(first_frame, cfg: MagnifyConfig) -> VideoState:
    """Bootstrap state from frame 0 ((H, W, 3) or (3, H, W)), the cached
    spectrum branch of the JAX function: frame 0's spectrum (kernels 1
    and 5), zero taps, `frame_idx` 1 (frame 0 has passed through)."""
    re, im = preprocess(first_frame, cfg)
    return VideoState(
        re, im,
        torch.zeros((0, 0, 0), dtype=torch.float32, device=re.device),
        temporal_init(tuple(re.shape), cfg.temporal, device=re.device), 1)


def _magnify_bootstrap(frames, cfg: MagnifyConfig):
    """Stream start.  At tight heights, and for planar frames, frame 0
    runs through the chunk kernel against a zero previous spectrum
    (every gate sees |prev| = 0, so frame 0's spectrum passes unmodified
    and becomes the state; the IIR delta is atan2(0, 0) = 0, so the taps
    stay zero), and its output is replaced by frame 0 itself.  Otherwise
    `video_init` takes frame 0's spectrum (kernel 5) and the chunk
    kernel runs frames 1.. against it; a one-frame clip then returns the
    passthrough and that state."""
    _, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    first = _first_passthrough(frames, cfg)
    if cfg.pad_mode == "tight" or is_planar(frames):
        outs, state = _chunk_colspec(
            frames, _zero_state(geom, cfg, frames.device, 0), cfg)
        outs[0] = first
        return outs, state
    state = video_init(frames[0], cfg)
    if frames.shape[0] == 1:
        return first[None], state
    outs, state = _chunk_colspec(frames[1:], state, cfg)
    return torch.cat([first[None], outs]), state


def _bypass_state(frames, cfg: MagnifyConfig) -> VideoState:
    """The state a bypassed clip leaves (JAX `_bypass_state`): a zero
    spectrum at tight heights, else `video_init` of the last frame."""
    t, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    if cfg.pad_mode == "tight":
        return _zero_state(geom, cfg, frames.device, t)
    return video_init(frames[-1], cfg)._replace(frame_idx=t)


def magnify_video(frames, cfg: MagnifyConfig,
                  state: VideoState = None
                  ) -> Tuple[torch.Tensor, VideoState]:
    """Magnify a clip.

    Args:
      frames: RGB frames, interleaved (T, H, W, 3) or planar (T, 3, H, W),
        f32 in [0, 1] or uint8; a torch tensor (on the CPU or the card;
        the output and state live on the same device) or a numpy array
        (CPU).
      cfg: any `MagnifyConfig().tuned_for_tpu()` variant the JAX
        package's batched chunk engine serves, with any `output_layout`.
      state: the carry of a previous chunk (streaming / resume), or None
        to start a stream: frame 0 then passes through unmodified.

    Returns (out_frames, final_state); out_frames follow
    `cfg.output_layout`: interleaved (T, H, W, 3) f32, planar
    (T, 3, H, W) f32 or planar (T, 3, H, W) uint8.  Chunked streaming:
    call repeatedly with consecutive clips, threading the returned state.
    With `apply_motion_magnification=False` the frames pass through
    untouched while the state keeps tracking them
    (`MotionMagnificationProcessor.cs:126-139,142`).
    """
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(frames)
    _check_supported(frames, cfg)
    if not cfg.apply_motion_magnification:
        new_state = _bypass_state(frames, cfg)
        if state is not None:
            new_state = new_state._replace(
                frame_idx=state.frame_idx + frames.shape[0])
        f = unit_float(frames)
        return _emit(f if is_planar(frames) else torch.movedim(f, -1, -3),
                     cfg), new_state
    if state is None:
        return _magnify_bootstrap(frames, cfg)
    return _chunk_colspec(frames, state, cfg)
