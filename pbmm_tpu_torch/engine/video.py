"""Chunked video magnification: the spectrum-resident chunk engine.

Counterpart of `pbmm_tpu/engine/video.py` for the chunk engine,
`magnify_video -> _magnify_bootstrap -> _chunk_colspec`
on tight geometry: per chunk, the pre stage and kernel 1 (row FFT; kernel
4 from planar uint8 frames), kernel 2 (column FFT + phase + column IFFT,
previous spectrum carried on chip) and the tail run in turn, and the last
frame's spectrum is returned as the state for the next chunk.  The tail
is kernel 3 (row IFFT + post, writing the output layout) where
`post_pallas_ok` holds, else kernel 7 (row IFFT + |z|) and `posttail`.

The carried state is `VideoState`, with the JAX package's leaves, shapes
and spectral layout (`engine.state` converts between the two packages).
Frame 0 of a stream passes through unchanged, like the reference's first
rendered frame (`MotionMagnificationProcessor.cs:111-117`).

Configurations outside this slice raise `NotImplementedError` naming the
ROADMAP item that brings them; none is routed elsewhere.
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
    hermitian_active,
    is_planar,
    posttail,
    preprocess_cl,
)
from pbmm_tpu_torch.engine.post_fused import (
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


def _check_supported(frames, cfg: MagnifyConfig) -> None:
    """Raise for what only the entry point decides; each stage's wrapper
    rejects the configs and geometries its kernel does not serve."""
    if not cfg.apply_motion_magnification:
        raise NotImplementedError(
            "apply_motion_magnification=False (bypass state) is not ported "
            "yet (ROADMAP item 6)")
    if cfg.engine != "batched" or not cfg.cache_prev_spectrum:
        raise NotImplementedError(
            "the per-frame scan engine (engine='scan' or "
            "cache_prev_spectrum=False) is not ported yet (ROADMAP item 8)")
    if frames.ndim != 4 or not (is_planar(frames) or frames.shape[-1] == 3):
        raise ValueError(f"expected (T, H, W, 3) or (T, 3, H, W) frames, "
                         f"got {tuple(frames.shape)}")
    if frames.shape[0] < 1:
        raise ValueError("magnify_video needs at least one frame")


def _post_block(rec, i_plane, q_plane, cfg, geom, rows):
    """The y_only post stage of the two-kernel tail on the (T, Hr, W)
    |z| rows: `posttail` as torch ops.  (Where `post_pallas_ok` holds, the
    JAX package's `_post_block` takes `post_fused`; the chunk engine
    never reaches it there, since the merged kernel 3 serves those
    geometries.)"""
    hr = rows[1] - rows[0]
    if post_pallas_ok(geom, cfg, rows[0], hr):
        raise NotImplementedError(
            "post_fused (the scan engine's post kernel) is not ported yet "
            "(ROADMAP item 8)")
    chans = rec.reshape((rec.shape[0], 1, hr, geom.pad_w))
    yiq3 = torch.stack([i_plane, i_plane, q_plane], dim=-3)
    return _emit(posttail(chans, yiq3, cfg, row0=rows[0]), cfg)


def _tail_block(rre, rim, i_plane, q_plane, cfg, geom, rows, rgb_u8=None):
    """Column-IFFT output rows -> frames in the configured layout.

    Where `post_pallas_ok` holds (as in the JAX package), the merged
    kernel 3 writes the layout itself, taking the chroma from `rgb_u8`
    ((T, 3, H, W) uint8 source frames) when given, else from the I/Q
    planes.  Otherwise kernel 7 (row IFFT + |z|) and `posttail`; uint8
    sources then give their I/Q planes here, once, as torch ops."""
    h, w = geom.in_h, geom.in_w
    if post_pallas_ok(geom, cfg, rows[0], rows[1] - rows[0]):
        win = hann2d_region(geom, device=rre.device)
        out_layout = {"interleaved": "tuple3", "planar": "planar",
                      "planar_u8": "planar_u8"}[cfg.output_layout]
        res = rowifft_post_fused(
            rre, rim, i_plane, q_plane, win, cfg, rows[0], h, w,
            cfg.pad_mode, full_w=geom.pad_w, rgb_u8=rgb_u8,
            out_layout=out_layout)
        if out_layout == "tuple3":
            return torch.stack(list(res), dim=-1)
        return res
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
    frame, kernel 2 over the chunk with the previous spectrum carried on
    chip, then the tail."""
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
    rres, rims, npr, npi = colspec_chunk(
        rre_rows, rim_rows, state.prev_spec_re, state.prev_spec_im, cfg,
        pad_h=geom.pad_h, row0=r0, out_rows=rows, full_w=geom.pad_w,
        planes=1)
    outs = _tail_block(rres, rims, i_plane, q_plane, cfg, geom, rows,
                       rgb_u8=rgb_u8)
    new_state = VideoState(npr, npi, state.prev_frame, state.temporal,
                           state.frame_idx + t)
    return outs, new_state


def _first_passthrough(frames, cfg: MagnifyConfig) -> torch.Tensor:
    """Frame 0 in the configured output layout: the reference's first
    rendered frame is the source frame, unmodified."""
    f0 = unit_float(frames[0])
    return _emit(f0 if is_planar(frames) else torch.movedim(f0, -1, -3),
                 cfg)


def _magnify_bootstrap(frames, cfg: MagnifyConfig):
    """Stream start at tight heights: frame 0 runs through the chunk
    kernel against a zero previous spectrum (every gate sees |prev| = 0,
    so frame 0's spectrum passes unmodified and becomes the state), and
    its output is replaced by frame 0 itself, unmodified."""
    _, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    wk = _working_width(cfg, geom)
    zeros = torch.zeros((1, geom.pad_h, wk), dtype=torch.float32,
                        device=frames.device)
    state = VideoState(
        zeros, zeros,
        torch.zeros((0, 0, 0), dtype=torch.float32, device=frames.device),
        temporal_init((1, geom.pad_h, wk), cfg.temporal,
                      device=frames.device),
        0,
    )
    outs, final_state = _chunk_colspec(frames, state, cfg)
    outs[0] = _first_passthrough(frames, cfg)
    return outs, final_state


def magnify_video(frames, cfg: MagnifyConfig,
                  state: VideoState = None
                  ) -> Tuple[torch.Tensor, VideoState]:
    """Magnify a clip.

    Args:
      frames: RGB frames, interleaved (T, H, W, 3) or planar (T, 3, H, W),
        f32 in [0, 1] or uint8; a torch tensor (on the CPU or the card;
        the output and state live on the same device) or a numpy array
        (CPU).
      cfg: the port serves `MagnifyConfig().tuned_for_tpu()
        .replace(pad_mode="tight")` and its two-frame pyramid variants,
        with any `output_layout`.
      state: the carry of a previous chunk (streaming / resume), or None
        to start a stream: frame 0 then passes through unmodified.

    Returns (out_frames, final_state); out_frames follow
    `cfg.output_layout`: interleaved (T, H, W, 3) f32, planar
    (T, 3, H, W) f32 or planar (T, 3, H, W) uint8.  Chunked streaming:
    call repeatedly with consecutive clips, threading the returned state.
    """
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(frames)
    _check_supported(frames, cfg)
    if state is None:
        return _magnify_bootstrap(frames, cfg)
    return _chunk_colspec(frames, state, cfg)
