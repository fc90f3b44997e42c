"""Chunked video magnification: the spectrum-resident chunk engine.

Counterpart of `pbmm_tpu/engine/video.py` for the main path,
`magnify_video -> _magnify_bootstrap -> _chunk_colspec`
on tight geometry: per chunk, the pre stage and kernel 1 (row FFT), kernel
2 (column FFT + phase + column IFFT, previous spectrum carried on chip)
and kernel 3 (row IFFT + post) run in turn, and the last frame's spectrum
is returned as the state for the next chunk.

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
from pbmm_tpu_torch.core.color import unit_float
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine.pipeline import (
    blur_row_window,
    hermitian_active,
    preprocess_cl,
)
from pbmm_tpu_torch.engine.post_fused import (
    post_pallas_ok,
    rowifft_post_fused,
)
from pbmm_tpu_torch.phase.temporal import TemporalState, temporal_init
from pbmm_tpu_torch.spectral.fused import aligned_row_window, colspec_chunk
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


def _check_supported(frames, cfg: MagnifyConfig) -> None:
    """Raise NotImplementedError for what only the entry point decides;
    each stage's wrapper rejects the configs and geometries its kernel
    does not serve."""
    if not cfg.apply_motion_magnification:
        raise NotImplementedError(
            "apply_motion_magnification=False (bypass state) is not ported "
            "yet (ROADMAP item 6)")
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise NotImplementedError(
            f"frames of shape {tuple(frames.shape)}: only interleaved "
            "(T, H, W, 3) input is ported (planar I/O: ROADMAP item 5)")
    if cfg.output_layout != "interleaved":
        raise NotImplementedError(
            f"output_layout={cfg.output_layout!r} is not ported yet "
            "(ROADMAP item 5)")
    if cfg.engine != "batched" or not cfg.cache_prev_spectrum:
        raise NotImplementedError(
            "the per-frame scan engine (engine='scan' or "
            "cache_prev_spectrum=False) is not ported yet (ROADMAP item 8)")
    if frames.shape[0] < 1:
        raise ValueError("magnify_video needs at least one frame")


def _tail_block(rre, rim, i_plane, q_plane, cfg, geom, rows, h, w):
    """Column-IFFT output rows -> (T, H, W, 3) RGB through the merged
    row-IFFT + post kernel, where `post_pallas_ok` routes the JAX package
    to it too; the two-kernel tail is ROADMAP item 6."""
    if not post_pallas_ok(geom, cfg, rows[0], rows[1] - rows[0]):
        raise NotImplementedError(
            f"{h}x{w} frames need the two-kernel tail (row_ifft_magnitude + "
            "post_fused), not ported yet (ROADMAP item 6)")
    win = hann2d_region(geom, device=rre.device)
    r, g, b = rowifft_post_fused(
        rre, rim, i_plane, q_plane, win, cfg, rows[0], h, w, cfg.pad_mode,
        full_w=geom.pad_w, out_layout="tuple3")
    return torch.stack([r, g, b], dim=-1)


def _chunk_colspec(frames, state: VideoState, cfg: MagnifyConfig):
    """One chunk: pre + kernel 1 over every frame, kernel 2 over the
    chunk with the previous spectrum carried on chip, kernel 3."""
    t, h, w, _ = frames.shape
    geom = geometry_for(h, w, cfg.pad_mode)
    rows = blur_row_window(geom, cfg)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    rre_rows, rim_rows, i_plane, q_plane = preprocess_cl(frames, cfg)
    rres, rims, npr, npi = colspec_chunk(
        rre_rows, rim_rows, state.prev_spec_re, state.prev_spec_im, cfg,
        pad_h=geom.pad_h, row0=r0, out_rows=rows, full_w=geom.pad_w,
        planes=1)
    outs = _tail_block(rres, rims, i_plane, q_plane, cfg, geom, rows, h, w)
    new_state = VideoState(npr, npi, state.prev_frame, state.temporal,
                           state.frame_idx + t)
    return outs, new_state


def _magnify_bootstrap(frames, cfg: MagnifyConfig):
    """Stream start at tight heights: frame 0 runs through the chunk
    kernel against a zero previous spectrum (every gate sees |prev| = 0,
    so frame 0's spectrum passes unmodified and becomes the state), and
    its output is replaced by frame 0 itself, unmodified."""
    _, h, w, _ = frames.shape
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
    outs[0] = unit_float(frames[0])
    return outs, final_state


def magnify_video(frames, cfg: MagnifyConfig,
                  state: VideoState = None
                  ) -> Tuple[torch.Tensor, VideoState]:
    """Magnify a clip.

    Args:
      frames: (T, H, W, 3) RGB, f32 in [0, 1] or uint8, a torch tensor (on
        the CPU or the card; the output and state live on the same
        device) or a numpy array (CPU).
      cfg: the slice serves `MagnifyConfig().tuned_for_tpu()
        .replace(pad_mode="tight")` and its two-frame pyramid variants.
      state: the carry of a previous chunk (streaming / resume), or None
        to start a stream: frame 0 then passes through unmodified.

    Returns (out_frames (T, H, W, 3) f32, final_state).  Chunked streaming:
    call repeatedly with consecutive clips, threading the returned state.
    """
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(frames)
    _check_supported(frames, cfg)
    if state is None:
        return _magnify_bootstrap(frames, cfg)
    return _chunk_colspec(frames, state, cfg)
