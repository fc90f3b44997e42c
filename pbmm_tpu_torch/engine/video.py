"""Chunked video magnification: the batched chunk engine and the per-frame
scan engine.

Counterpart of `pbmm_tpu/engine/video.py`: `magnify_video` ->
`_magnify_bootstrap` -> `_magnify_chunk`, which routes a chunk the way
the JAX package does:

- the batched engine `_chunk_colspec` where `cfg.engine == "batched"`
  and `_colspec_ok` holds (the pallas backend's fused spectral path with
  cached spectra and padded sizes that tile by 128): per chunk, the pre
  stage's front end (the planes, pad and window in the row FFT's loads;
  kernel 4 from planar uint8 y_only frames), kernel 2 (column FFT + phase
  + column IFFT, the previous spectrum and the IIR taps carried on chip)
  and the tail (kernel 3 with the chroma from the source frames, or
  kernel 7 then kernel 11 or the torch `posttail`), the post kernels
  writing the output layout themselves;
- else the scan engine `_chunk_scan`, a Python loop of `video_step` over
  the frames (the JAX package's `lax.scan`): `pipeline.preprocess` of the
  frame (and of the previous frame with `cache_prev_spectrum=False`), the
  band/phase pass and the inverse (`torch.fft` for the xla backend;
  kernels 1, 5, 6, 7 on the fused pallas path; kernels 1, 5, 9 and 8 on
  the unfused one), then `posttail`;
- except that the pallas backend at tight heights runs only on the
  batched engine and raises `ValueError` elsewhere, as in the JAX
  package.

`cfg.engine` alone selects the engine (the JAX package's `PBMM_SCANFREE`
environment override, a TPU A/B switch, is not ported).  The carried
state is `VideoState`, with the JAX package's leaves, shapes and
spectral layout (`engine.state` converts between the two packages).
Frame 0 of a stream passes through unchanged, like the reference's first
rendered frame (`MotionMagnificationProcessor.cs:111-117`).
`fft_backend="mxu"` takes the scan engine, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import unit_float
from pbmm_tpu_torch.core.complexop import combine, split
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine.pipeline import (
    _posttail,
    amplify_reconstruct_fused,
    amplify_spectrum,
    blur_row_window,
    fused_reconstruct_ok,
    hermitian_active,
    is_planar,
    on_device,
    postprocess,
    posttail,
    preprocess,
    preprocess_cl,
)
from pbmm_tpu_torch.engine.post_fused import (
    post_fused,
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
from pbmm_tpu_torch.utils.profiling import scope


class VideoState(NamedTuple):
    """Chunk-boundary state, the JAX package's leaves."""

    prev_spec_re: torch.Tensor  # (C, Hp, Wk) f32; (0, 0, 0) without cache
    prev_spec_im: torch.Tensor
    prev_frame: torch.Tensor  # (H, W, 3) f32 without cache, else (0, 0, 0)
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


@functools.lru_cache(maxsize=8)
def _crop_window(geom, device) -> torch.Tensor:
    """`hann2d_region` of a geometry on a device, built once: the post
    kernels only read it, so a chunk launches nothing to make it."""
    return hann2d_region(geom, device=device)


def _post_block(rec, i_plane, q_plane, cfg, geom, rows):
    """The post stage of the two-kernel tail on the (T * C, Hr, W)
    reconstruction rows, routed as the JAX package's `_post_block`:
    where `post_pallas_ok` holds, kernel 11 (chroma="rgb") or kernel 10
    (`post_fused`, y_only; never reached from the chunk engine, where
    kernel 3 serves those geometries first), each writing the configured
    layout itself; else `posttail` as torch ops."""
    hr = rows[1] - rows[0]
    c = _planes(cfg)
    if post_pallas_ok(geom, cfg, rows[0], hr):
        win = _crop_window(geom, rec.device)
        if c == 3:
            return post_fused_rgb(rec, win, cfg, rows[0], geom.in_h,
                                  geom.in_w, cfg.pad_mode,
                                  out_layout=cfg.output_layout)
        return post_fused(rec, i_plane, q_plane, win, cfg, rows[0],
                          geom.in_h, geom.in_w, cfg.pad_mode,
                          out_layout=cfg.output_layout)
    chans = rec.reshape((rec.shape[0] // c, c, hr, geom.pad_w))
    iq = None if c == 3 else (i_plane, q_plane)
    return _emit(_posttail(chans, geom, cfg, row0=rows[0], iq=iq), cfg)


def _tail_block(rre, rim, i_plane, q_plane, cfg, geom, rows, src=None):
    """Column-IFFT output rows -> frames in the configured layout.

    For y_only where `post_pallas_ok` holds (as in the JAX package), the
    merged kernel 3 (or, where its blocks do not serve, kernels 7 + 10)
    writes the layout itself, taking the chroma from `src` (the source
    frames, any input form) when given, else from the I/Q planes.
    Otherwise kernel 7 (row IFFT + |z| or Re z) and `_post_block`."""
    h, w = geom.in_h, geom.in_w
    if cfg.chroma != "rgb" and post_pallas_ok(geom, cfg, rows[0],
                                              rows[1] - rows[0]):
        win = _crop_window(geom, rre.device)
        return rowifft_post_fused(
            rre, rim, i_plane, q_plane, win, cfg, rows[0], h, w,
            cfg.pad_mode, full_w=geom.pad_w, src=src,
            out_layout=cfg.output_layout)
    rec = row_ifft_magnitude(rre, rim,
                             magnitude=(cfg.reconstruct == "magnitude"),
                             pad_h=geom.pad_h, full_w=geom.pad_w)
    return _post_block(rec, i_plane, q_plane, cfg, geom, rows)


def _chunk_colspec(frames, state: VideoState, cfg: MagnifyConfig):
    """One chunk: the front end (kernel 4 from planar uint8 y_only frames)
    over every frame, kernel 2 over the chunk with the previous spectrum
    (and the IIR taps) carried on chip, then the tail."""
    t, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    rows = blur_row_window(geom, cfg)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    # Where the post kernels serve a y_only chunk they take the chroma
    # from the source frames: no plane of the source is ever built.
    src = None
    if cfg.chroma != "rgb" and post_pallas_ok(geom, cfg, rows[0],
                                              rows[1] - rows[0]):
        src = frames
    # The stage spans sit around the calls through this module's globals
    # `preprocess_cl`, `colspec_chunk` and `_tail_block`, looked up at
    # call time.
    with scope("pbmm.frontend", timed=frames):
        rre_rows, rim_rows, i_plane, q_plane = preprocess_cl(
            frames, cfg, want_iq=src is None)
    iir = cfg.temporal.mode == "iir_bandpass"
    taps = (state.temporal.lp_fast, state.temporal.lp_slow) if iir else ()
    with scope("pbmm.colspec", timed=frames):
        res = colspec_chunk(
            rre_rows, rim_rows, state.prev_spec_re, state.prev_spec_im, cfg,
            geom.pad_h, r0, *taps, out_rows=rows, full_w=geom.pad_w,
            planes=_planes(cfg))
    temporal = TemporalState(*res[4:]) if iir else state.temporal
    with scope("pbmm.tail", timed=frames):
        outs = _tail_block(res[0], res[1], i_plane, q_plane, cfg, geom,
                           rows, src=src)
    new_state = VideoState(res[2], res[3], state.prev_frame, temporal,
                           state.frame_idx + t)
    return outs, new_state


def _colspec_ok(cfg: MagnifyConfig, frame_shape) -> bool:
    """Whether the batched chunk engine serves this config and frame
    shape: cached spectra, either temporal mode, and the fused spectral
    path at padded sizes that tile by 128 (the JAX predicate)."""
    if not (cfg.cache_prev_spectrum
            and cfg.temporal.mode in ("two_frame", "iir_bandpass")):
        return False
    geom = geometry_for(frame_shape[-3], frame_shape[-2], cfg.pad_mode)
    return fused_reconstruct_ok(cfg, (geom.pad_h, _working_width(cfg, geom)))


def _tight_pallas(cfg: MagnifyConfig) -> bool:
    return cfg.pad_mode == "tight" and cfg.fft_backend == "pallas"


def video_init(first_frame, cfg: MagnifyConfig, device=None) -> VideoState:
    """Bootstrap state from frame 0 ((H, W, 3)): its spectrum (cached
    spectra) or the frame itself (`cache_prev_spectrum=False`), zero
    taps, `frame_idx` 1 (frame 0 has passed through).  A torch tensor
    runs where it lies; numpy on `device` (default: the first CUDA
    card)."""
    first_frame = on_device(first_frame, device)
    spec, _ = preprocess(first_frame, cfg)
    dev = spec.device
    empty = torch.zeros((0, 0, 0), dtype=torch.float32, device=dev)
    if cfg.cache_prev_spectrum:
        sre, sim = split(spec)
        pframe = empty
    else:
        sre = sim = empty
        pframe = unit_float(first_frame)
    return VideoState(sre, sim, pframe,
                      temporal_init(tuple(spec.shape), cfg.temporal,
                                    device=dev), 1)


def video_step(state: VideoState, frame, cfg: MagnifyConfig):
    """One (H, W, 3) frame of the scan engine; returns (new state, the
    magnified frame in the configured output layout)."""
    cur_spec, cur_yiq = preprocess(frame, cfg)
    if cfg.cache_prev_spectrum:
        prev_spec = combine(state.prev_spec_re, state.prev_spec_im)
    else:
        # Reference-faithful: re-process the previous frame
        # (`MotionMagnificationProcessor.cs:151-156`).
        prev_spec, _ = preprocess(state.prev_frame, cfg)
    if fused_reconstruct_ok(cfg, cur_spec.shape):
        # Kernels 6 and 7: only the crop + blur-halo rows are written.
        geom = geometry_for(frame.shape[-3], frame.shape[-2], cfg.pad_mode)
        rows = blur_row_window(geom, cfg)
        chans, temporal = amplify_reconstruct_fused(
            cur_spec, prev_spec, cfg, out_rows=rows, full_w=geom.pad_w,
            temporal_state=state.temporal)
        out = _emit(posttail(chans, cur_yiq, cfg, row0=rows[0]), cfg)
    else:
        mod_spec, temporal = amplify_spectrum(cur_spec, prev_spec, cfg,
                                              state.temporal)
        out = _emit(postprocess(mod_spec, cur_yiq, cfg), cfg)
    if cfg.cache_prev_spectrum:
        sre, sim = split(cur_spec)
        pframe = state.prev_frame
    else:
        sre, sim = state.prev_spec_re, state.prev_spec_im
        pframe = unit_float(frame)
    return VideoState(sre, sim, pframe, temporal, state.frame_idx + 1), out


def _chunk_scan(frames, state: VideoState, cfg: MagnifyConfig):
    """The scan engine over a chunk of (T, H, W, 3) frames, in order."""
    outs = []
    for f in range(frames.shape[0]):
        state, out = video_step(state, frames[f], cfg)
        outs.append(out)
    return torch.stack(outs), state


def _magnify_chunk(frames, state: VideoState, cfg: MagnifyConfig):
    if (cfg.engine == "batched" and frames.shape[0] > 0
            and _colspec_ok(cfg, _norm_shape(frames))):
        return _chunk_colspec(frames, state, cfg)
    if _tight_pallas(cfg):
        # The per-frame kernels are radix-2 on the column axis; only the
        # chunk engine carries the four-step tight-height transform.
        raise ValueError(
            "pad_mode='tight' with fft_backend='pallas' requires the "
            "batched engine with cached spectra (engine='batched', "
            "cache_prev_spectrum=True, fused spectral path); use "
            "fft_backend='xla' for other engine combinations")
    return _chunk_scan(frames, state, cfg)


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


def _magnify_bootstrap(frames, cfg: MagnifyConfig):
    """Stream start.  Where the chunk engine serves the clip and the
    pallas backend runs at tight heights, or the frames are planar,
    frame 0 runs through the chunk against a zero previous spectrum
    (every gate sees |prev| = 0, so frame 0's spectrum passes unmodified
    and becomes the state; the IIR delta is atan2(0, 0) = 0, so the taps
    stay zero), and its output is replaced by frame 0 itself.  Otherwise
    `video_init` takes frame 0 and the chunk runs frames 1.. against it;
    a one-frame clip then returns the passthrough and that state."""
    _, h, w, _ = _norm_shape(frames)
    geom = geometry_for(h, w, cfg.pad_mode)
    first = _first_passthrough(frames, cfg)
    if ((_tight_pallas(cfg) or is_planar(frames))
            and _colspec_ok(cfg, _norm_shape(frames))):
        outs, state = _magnify_chunk(
            frames, _zero_state(geom, cfg, frames.device, 0), cfg)
        outs[0] = first
        return outs, state
    state = video_init(frames[0], cfg)
    if frames.shape[0] == 1:
        return first[None], state
    outs, state = _magnify_chunk(frames[1:], state, cfg)
    return torch.cat([first[None], outs]), state


def _bypass_state(frames, cfg: MagnifyConfig) -> VideoState:
    """The state a bypassed clip of (T, H, W, 3) frames leaves (JAX
    `_bypass_state`): a zero spectrum for the pallas backend at tight
    heights, else `video_init` of the last frame."""
    t, h, w, _ = frames.shape
    if _tight_pallas(cfg):
        return _zero_state(geometry_for(h, w, cfg.pad_mode), cfg,
                           frames.device, t)
    return video_init(frames[-1], cfg)._replace(frame_idx=t)


def magnify_video(frames, cfg: MagnifyConfig, state: VideoState = None,
                  device=None) -> Tuple[torch.Tensor, VideoState]:
    """Magnify a clip.

    Args:
      frames: RGB frames, interleaved (T, H, W, 3) or planar (T, 3, H, W),
        f32 in [0, 1] or uint8.  A torch tensor runs where it lies (the
        output and state live on the same device); a numpy array runs on
        `device`, by default the first CUDA card (there is no fallback
        to the CPU: pass device="cpu" to run there).
      cfg: any `MagnifyConfig`, with any `output_layout`.
      state: the carry of a previous chunk (streaming / resume), or None
        to start a stream: frame 0 then passes through unmodified.

    Returns (out_frames, final_state); out_frames follow
    `cfg.output_layout`: interleaved (T, H, W, 3) f32, planar
    (T, 3, H, W) f32 or planar (T, 3, H, W) uint8.  Chunked streaming:
    call repeatedly with consecutive clips, threading the returned state.
    With `apply_motion_magnification=False` the frames pass through
    untouched while the state keeps tracking them
    (`MotionMagnificationProcessor.cs:126-139,142`).

    Each call, from the frames on their device on, is the span
    `pbmm.chunk` (`utils.profiling.scope`), the root of its chunk's
    spans.
    """
    frames = on_device(frames, device)
    with scope("pbmm.chunk", timed=frames, chunk=True):
        return _magnify_video(frames, cfg, state)


def _magnify_video(frames, cfg: MagnifyConfig, state):
    if frames.ndim != 4 or not (is_planar(frames) or frames.shape[-1] == 3):
        raise ValueError(f"expected (T, H, W, 3) or (T, 3, H, W) frames, "
                         f"got {tuple(frames.shape)}")
    if frames.shape[0] < 1:
        raise ValueError("magnify_video needs at least one frame")
    if is_planar(frames) and not (cfg.engine == "batched" and _colspec_ok(
            cfg, _norm_shape(frames))):
        # Planar frames are first-class only on the chunk engine; every
        # other path takes the interleaved layout.
        frames = torch.movedim(frames, 1, -1)
    if not cfg.apply_motion_magnification:
        new_state = _bypass_state(
            torch.movedim(frames, 1, -1) if is_planar(frames) else frames,
            cfg)
        if state is not None:
            new_state = new_state._replace(
                frame_idx=state.frame_idx + frames.shape[0])
        f = unit_float(frames)
        return _emit(f if is_planar(frames) else torch.movedim(f, -1, -3),
                     cfg), new_state
    if state is None:
        return _magnify_bootstrap(frames, cfg)
    return _magnify_chunk(frames, state, cfg)
