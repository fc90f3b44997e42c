"""The per-frame pipeline and the pre stage of the chunk engine.

Counterpart of `pbmm_tpu/engine/pipeline.py`.  Per frame (the scan engine
and the stateless pair; the reference's sequence,
`MotionMagnificationProcessor.cs:145-232`):

    rgb -> yiq -> pad + Hann window       `preprocess`
    forward FFT of the processed planes   (same)
    band/phase pass against prev          `amplify_spectrum`
    inverse FFT, |z| or Re z              `reconstruct`
    blur -> chroma -> yiq -> rgb -> crop  `posttail` (`postprocess`)

`fft_backend="xla"` is `torch.fft` (cuFFT), as the JAX package leaves it
to XLA, with the band/phase pass as torch ops or, with `use_pallas`,
kernel 9 (`phase.fused_kernels`).  `"pallas"` runs kernel 1 (row FFT)
and kernel 5 (column FFT) in `preprocess`, and either kernel 6 (phase +
column IFFT) and kernel 7 (row IFFT + |z|) in `amplify_reconstruct_fused`
where `fused_reconstruct_ok` holds, or kernel 8 (`ifft2_bitrev`) in
`reconstruct`.  `"mxu"` is the four-step matmul DFT
(`spectral.mxu_fft`, `torch.matmul` in IEEE f32) in the rfft layout.

For the chunk engine: `hermitian_active`, `blur_row_window` and
`preprocess_cl` (interleaved or planar, f32 or u8 frames, y_only or rgb,
stopping after the row FFT): the front end forms the Y/I/Q planes, the
pad and the window in its loads (kernel 4 for planar uint8 y_only
frames), where the JAX package leaves them to XLA.  The scan engine's
per-frame pre stage (`preprocess`) and the post tail keep them as plain
torch ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import (
    RGB_TO_YIQ,
    channel_mix,
    is_planar,
    rgb_to_yiq,
    unit_float,
    yiq_to_rgb,
)
from pbmm_tpu_torch.core.complexop import split
from pbmm_tpu_torch.core.window import (
    Geometry,
    blur_taps,
    blur_then_crop,
    geometry_for,
    hann2d,
    hann2d_region,
    pad_center,
)
from pbmm_tpu_torch.phase.amplify import (
    phase_delta,
    pyramid_phase_amplify_procedural,
)
from pbmm_tpu_torch.phase.fused_kernels import (
    pyramid_phase_amplify_pallas_procedural,
)
from pbmm_tpu_torch.phase.standard import (
    bandpass_weight_map,
    standard_phase_amplify,
)
from pbmm_tpu_torch.phase.temporal import (
    TemporalState,
    temporal_apply,
    temporal_init,
)
from pbmm_tpu_torch.spectral.fft import (
    fft2_centered,
    ifft2_centered,
    irfft2_half,
    rfft2_half,
)
from pbmm_tpu_torch.spectral.fused import (
    aligned_row_window,
    col_fft_zero_padded,
    fused_eligible,
    phase_col_ifft,
    row_ifft_magnitude,
    windowed_row_fft,
    windowed_row_fft_frames,
    windowed_row_fft_u8planar,
)
from pbmm_tpu_torch.spectral.hermitian import hermitian_saves
from pbmm_tpu_torch.spectral.mxu_fft import irfft2_mxu, rfft2_mxu
from pbmm_tpu_torch.spectral.radix2 import ifft2_bitrev
from pbmm_tpu_torch.utils.profiling import scope


def default_device() -> torch.device:
    """The first CUDA card: where the entry points run numpy input when
    the caller names no device.  Raises when there is none (there is no
    fallback to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pbmm_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' (or CPU tensors) to run on the CPU")
    return torch.device("cuda", 0)


def on_device(x, device=None) -> torch.Tensor:
    """`x` as a tensor: a torch tensor stays where it lies unless
    `device` names another; anything numpy reads goes to `device`, else
    to `default_device()`."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a).to(
        device if device is not None else default_device())


def _geometry(frame_shape, cfg: MagnifyConfig) -> Geometry:
    return geometry_for(frame_shape[-3], frame_shape[-2], cfg.pad_mode)


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


def chroma_planes(frames) -> tuple:
    """The original (T, H, W) I and Q planes of (T, H, W, 3) or
    (T, 3, H, W) frames, as torch FMAs in the JAX package's order: what
    the torch post tail reads where the post kernels do not serve."""
    f = unit_float(frames)
    rgb = (f[:, 0], f[:, 1], f[:, 2]) if is_planar(frames) else (
        f[..., 0], f[..., 1], f[..., 2])
    return tuple(channel_mix(*rgb, RGB_TO_YIQ[d]) for d in (1, 2))


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

    Every input form goes to the front end
    (`fused.windowed_row_fft_frames`), which forms the planes, the pad
    and the window in its loads, bit for bit the torch pre stage + kernel
    1; planar uint8 y_only frames to kernel 4, its JAX package's route
    (the same kernel, the same bits).  No YIQ plane or padded slab is
    built.  `want_iq=False` builds no I/Q planes either (they return
    None): the caller takes the chroma from the source frames inside the
    post kernels.  `fft_backend="pallas"` only."""
    if cfg.fft_backend != "pallas":
        raise ValueError("preprocess_cl is the pallas backend's pre stage")
    planar = is_planar(frames)
    h_in, w_in = frames.shape[-2:] if planar else frames.shape[-3:-1]
    geom = geometry_for(h_in, w_in, cfg.pad_mode)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    args = (geom.pad_h, geom.pad_w, geom.y0, geom.x0, r0)
    keep = hermitian_active(cfg, geom)
    y_only = cfg.chroma != "rgb"
    if planar and frames.dtype == torch.uint8 and y_only:
        re, im = windowed_row_fft_u8planar(
            frames, tuple(float(c) for c in RGB_TO_YIQ[0]), *args,
            keep_half=keep)
    else:
        rows = RGB_TO_YIQ[:1] if y_only else RGB_TO_YIQ
        re, im = windowed_row_fft_frames(
            frames, tuple(tuple(float(c) for c in r) for r in rows),
            *args, keep_half=keep)
    if y_only and want_iq:
        return (re, im) + chroma_planes(frames)
    return re, im, None, None


def _posttail(chans: torch.Tensor, geom: Geometry, cfg: MagnifyConfig,
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
    with scope("pbmm.blur"):
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


def preprocess(frame_rgb, cfg: MagnifyConfig):
    """(..., H, W, 3) RGB -> (spectra (..., C, Hp, Wk) complex64, YIQ at
    input resolution (..., 3, H, W) f32): C = 1 (Y) or 3 (Y, I, Q with
    chroma="rgb"), padded and windowed, then transformed: `torch.fft`
    (rfft half or DC-centred full spectrum) for `fft_backend="xla"`;
    kernel 1 on the content rows and kernel 5 down the columns (both
    axes bit-reversed, kept Hermitian lanes where `hermitian_active`)
    for `"pallas"`, at pow-2 heights only: tight heights are served by
    the chunk engine's four-step kernel and raise here, as in the JAX
    package."""
    with scope("pbmm.preprocess"):
        return _preprocess(frame_rgb, cfg)


def _preprocess(frame_rgb, cfg: MagnifyConfig):
    geom = _geometry(frame_rgb.shape, cfg)
    yiq = rgb_to_yiq(torch.movedim(unit_float(frame_rgb), -1, -3), axis=-3)
    chans_small = yiq if cfg.chroma == "rgb" else yiq[..., 0:1, :, :]
    if cfg.fft_backend == "pallas":
        if geom.pad_h & (geom.pad_h - 1):
            raise ValueError(
                "pad_mode='tight' with fft_backend='pallas' is served by "
                "engine.video.magnify_video (spectrum-resident chunk "
                "engine); the standalone pow-2 column kernel cannot "
                f"transform pad_h={geom.pad_h}.  Use magnify_video, or "
                "fft_backend='xla' for this entry point.")
        r0, r1 = aligned_row_window(geom.y0, geom.y0 + geom.in_h,
                                    geom.pad_h)
        slab = F.pad(chans_small, (geom.x0, geom.pad_w - geom.in_w - geom.x0,
                                   geom.y0 - r0, r1 - geom.y0 - geom.in_h))
        shape = tuple(slab.shape)
        with scope("pbmm.fft"):
            re, im = windowed_row_fft(slab.reshape((-1,) + shape[-2:]),
                                      pad_h=geom.pad_h, row0=r0,
                                      keep_half=hermitian_active(cfg, geom))
            re, im = col_fft_zero_padded(re, im, pad_h=geom.pad_h, row0=r0)
        spec = torch.complex(re, im).reshape(
            shape[:-2] + (geom.pad_h, re.shape[-1]))
        return spec, yiq
    chans = pad_center(chans_small, geom) * hann2d(
        geom.pad_h, geom.pad_w, device=yiq.device)
    with scope("pbmm.fft"):
        if cfg.fft_backend == "mxu":
            spec = rfft2_mxu(chans)
        elif cfg.use_rfft:
            spec = rfft2_half(chans)
        else:
            spec = fft2_centered(chans)
    return spec, yiq


def amplify_spectrum(cur_spec, prev_spec, cfg: MagnifyConfig,
                     temporal_state: Optional[TemporalState] = None):
    """The pyramid or standard band/phase pass on complex spectra in the
    backend's layout ("bitrev2d" for pallas, "rfft" with `use_rfft`, else
    "centered"); with the IIR band-pass the phase delta is filtered first
    and the new taps come back.  Returns (modified spectrum, taps)."""
    with scope("pbmm.phase_amplify"):
        return _amplify_spectrum(cur_spec, prev_spec, cfg, temporal_state)


def _amplify_spectrum(cur_spec, prev_spec, cfg: MagnifyConfig,
                      temporal_state: Optional[TemporalState]):
    pad_h = cur_spec.shape[-2]
    if cfg.fft_backend == "pallas":
        layout = "bitrev2d"
    elif cfg.use_rfft:
        layout = "rfft"
    else:
        layout = "centered"
    # The rfft array is (H, W // 2 + 1); pow-2 widths make W unambiguous.
    pad_w = (2 * (cur_spec.shape[-1] - 1) if cfg.use_rfft
             else cur_spec.shape[-1])
    delta_override = None
    new_state = temporal_state
    if cfg.temporal.mode != "two_frame":
        delta = phase_delta(cur_spec, prev_spec)
        if temporal_state is None:
            temporal_state = temporal_init(tuple(delta.shape), cfg.temporal,
                                           device=delta.device)
        delta_override, new_state = temporal_apply(delta, temporal_state,
                                                   cfg.temporal)
    if cfg.mode == "pyramid":
        if cfg.use_pallas and delta_override is None and pad_w % 128 == 0:
            mod = pyramid_phase_amplify_pallas_procedural(
                cur_spec, prev_spec, cfg, layout)
        else:
            mod = pyramid_phase_amplify_procedural(
                cur_spec, prev_spec, cfg, delta_override=delta_override,
                layout=layout, full_pad_w=pad_w)
    else:
        weight = bandpass_weight_map(pad_h, pad_w, cfg, layout,
                                     device=cur_spec.device)
        mod = standard_phase_amplify(
            cur_spec, prev_spec, weight, cfg.phase_scale,
            cfg.magnitude_threshold, cfg.magnitude_scale,
            cfg.apply_magnitude_scale, delta_override=delta_override)
    return mod, new_state


def reconstruct(mod_spec, cfg: MagnifyConfig, pad_w: int) -> torch.Tensor:
    """Modified spectrum -> the real reconstruction at padded resolution:
    |z| of the inverse (the reference's, `FFT.compute:143-150`) or, with
    `reconstruct="real"`, Re z.  The pallas backend's inverse is kernel 8
    twice (`ifft2_bitrev`)."""
    with scope("pbmm.ifft"):
        if cfg.fft_backend == "pallas":
            shape = mod_spec.shape
            rre, rim = ifft2_bitrev(*split(mod_spec.reshape(
                (-1,) + tuple(shape[-2:]))))
            rec = torch.complex(rre, rim).reshape(shape)
        elif cfg.fft_backend == "mxu":
            rec = irfft2_mxu(mod_spec, pad_w)  # real by construction
        elif cfg.use_rfft:
            rec = irfft2_half(mod_spec, pad_w)  # real by construction
        else:
            rec = ifft2_centered(mod_spec)
    if cfg.reconstruct == "magnitude":
        return torch.abs(rec)
    return rec.real if rec.is_complex() else rec


def fused_reconstruct_ok(cfg: MagnifyConfig, spec_shape) -> bool:
    """Whether kernels 6 and 7 (phase + column IFFT, row IFFT + |z|)
    serve this config and working size."""
    h, w = spec_shape[-2:]
    return fused_eligible(cfg) and h % 128 == 0 and w % 128 == 0


def amplify_reconstruct_fused(cur_spec, prev_spec, cfg: MagnifyConfig,
                              out_rows=None, full_w=None,
                              temporal_state=None):
    """The band/phase pass fused into the column IFFT (kernel 6), and the
    row IFFT fused with |z| (kernel 7): `reconstruct(amplify(...))` on
    the spatial rows `out_rows` only, the modified spectrum never stored.
    Returns ((..., r1 - r0, full width) f32, taps)."""
    shape = tuple(cur_spec.shape)
    fw = full_w if full_w is not None else shape[-1]
    r0, r1 = out_rows if out_rows is not None else (0, shape[-2])
    flat = (-1,) + shape[-2:]
    iir = cfg.temporal.mode == "iir_bandpass"
    taps = {}
    if iir:
        taps = dict(lp_fast=temporal_state.lp_fast.reshape(flat),
                    lp_slow=temporal_state.lp_slow.reshape(flat))
    with scope("pbmm.phase_ifft_fused"):
        res = phase_col_ifft(*split(cur_spec.reshape(flat)),
                             *split(prev_spec.reshape(flat)), cfg,
                             out_rows=out_rows, full_w=fw, **taps)
    new_state = (TemporalState(res[2].reshape(shape), res[3].reshape(shape))
                 if iir else temporal_state)
    rec = row_ifft_magnitude(res[0], res[1],
                             magnitude=(cfg.reconstruct == "magnitude"),
                             pad_h=shape[-2], full_w=fw)
    return rec.reshape(shape[:-2] + (r1 - r0, fw)), new_state


def posttail(chans, yiq_small, cfg: MagnifyConfig, row0: int = 0):
    """The post stage on (..., C, Hr, Wp) reconstruction rows from padded
    row `row0` with the (..., 3, H, W) input-resolution YIQ (only its
    I/Q planes are read, for y_only): blur -> crop -> windowed chroma ->
    compensation and gains -> YIQ -> RGB, saturated; (..., 3, H, W)."""
    h, w = yiq_small.shape[-2:]
    geom = geometry_for(h, w, cfg.pad_mode)
    lead = tuple(chans.shape[:-3])
    c4 = chans.reshape((-1,) + tuple(chans.shape[-3:]))
    if cfg.chroma == "rgb":
        out = _posttail(c4, geom, cfg, row0)
    else:
        y4 = yiq_small.reshape((-1,) + tuple(yiq_small.shape[-3:]))
        out = _posttail(c4[:, 0:1], geom, cfg, row0, iq=(y4[:, 1], y4[:, 2]))
    return out.reshape(lead + tuple(out.shape[-3:]))


def postprocess(mod_spec, yiq_small, cfg: MagnifyConfig) -> torch.Tensor:
    """(..., C, Hp, Wp) modified spectra + (..., 3, H, W) YIQ -> (..., 3,
    H, W) RGB: `reconstruct`, then `posttail`
    (`MotionMagnificationProcessor.cs:196-205`)."""
    h, w = yiq_small.shape[-2:]
    geom = geometry_for(h, w, cfg.pad_mode)
    return posttail(reconstruct(mod_spec, cfg, geom.pad_w), yiq_small, cfg)


def magnify_frame_pair(prev_rgb, cur_rgb, cfg: MagnifyConfig,
                       device=None) -> torch.Tensor:
    """Stateless two-frame magnification, reference-faithful: both frames
    are fully pre-processed (the reference re-FFTs the previous frame,
    `MotionMagnificationProcessor.cs:151-156`).

    prev_rgb, cur_rgb: (H, W, 3) RGB in [0, 1] (or uint8); torch tensors
    run where they lie, numpy arrays on `device` (default: the first CUDA
    card).  Returns (H, W, 3) f32 RGB."""
    cur_rgb = on_device(cur_rgb, device)
    prev_rgb = on_device(prev_rgb, cur_rgb.device)
    if not cfg.apply_motion_magnification:
        # The reference's bypass (`MotionMagnificationProcessor.cs:126-139`).
        return unit_float(cur_rgb)
    cur_spec, cur_yiq = preprocess(cur_rgb, cfg)
    prev_spec, _ = preprocess(prev_rgb, cfg)
    if (fused_reconstruct_ok(cfg, cur_spec.shape)
            and cfg.temporal.mode == "two_frame"):
        geom = _geometry(cur_rgb.shape, cfg)
        rows = blur_row_window(geom, cfg)
        chans, _ = amplify_reconstruct_fused(cur_spec, prev_spec, cfg,
                                             out_rows=rows,
                                             full_w=geom.pad_w)
        return torch.movedim(posttail(chans, cur_yiq, cfg, row0=rows[0]),
                             -3, -1)
    mod_spec, _ = amplify_spectrum(cur_spec, prev_spec, cfg)
    return torch.movedim(postprocess(mod_spec, cur_yiq, cfg), -3, -1)
