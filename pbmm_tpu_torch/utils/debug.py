"""Debug / observability renderers (counterpart of `pbmm_tpu/utils/debug.py`).

The reference's visual-debugging surface as torch functions: the spectrum
magnitude/phase views behind `showMagnitude`/`showPhase`
(`MotionMagnificationProcessor.cs:234-257`) and the standard-mode
diagnostic kernels (`PhaseDifferenceComputeShader.compute:182-259`, dead
code in the reference but useful for parity debugging).
"""

from __future__ import annotations

import numpy as np
import torch

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.complexop import wrap_phase
from pbmm_tpu_torch.core.window import crop_center
from pbmm_tpu_torch.engine.pipeline import _geometry, preprocess
from pbmm_tpu_torch.phase.standard import bandpass_weight_map


def magnitude_view(spec: torch.Tensor) -> torch.Tensor:
    """Log-scaled spectrum magnitude, `ConvertComplexMagToTexScaled`
    (`FFT.compute:153-161`): log10(10|z| + 1) / 4."""
    return torch.log10(10.0 * torch.abs(spec) + 1.0) / 4.0


def phase_view(spec: torch.Tensor) -> torch.Tensor:
    """Normalized absolute phase, `ConvertComplexPhaseToTex`
    (`FFT.compute:164-172`): |atan2(im, re)| / (pi/2)."""
    return torch.abs(torch.angle(spec)) / (np.pi / 2.0)


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """GPU-convention bilinear resample of the last two axes: destination
    pixel centers map to source texture coordinates (u, v) = ((x+0.5)/W_out,
    (y+0.5)/H_out), sampled at source texel grid (u*W_src - 0.5) with
    clamp-to-edge (Unity's default sampler state for RenderTextures)."""
    src_h, src_w = img.shape[-2:]
    dev = img.device
    sy = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5)
          / out_h * src_h - 0.5)
    sx = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5)
          / out_w * src_w - 0.5)
    y0 = torch.clamp(torch.floor(sy), 0, src_h - 1).long()
    x0 = torch.clamp(torch.floor(sx), 0, src_w - 1).long()
    y1 = torch.clamp_max(y0 + 1, src_h - 1)
    x1 = torch.clamp_max(x0 + 1, src_w - 1)
    fy = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)
    fx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)
    rows0, rows1 = img[..., y0, :], img[..., y1, :]
    top = rows0[..., x0] * (1 - fx) + rows0[..., x1] * fx
    bot = rows1[..., x0] * (1 - fx) + rows1[..., x1] * fx
    return top * (1 - fy[..., :, None]) + bot * fy[..., :, None]


def split_screen(left: torch.Tensor, right: torch.Tensor,
                 out_h: int = 0, out_w: int = 0) -> torch.Tensor:
    """Side-by-side composite: each input's FULL texture is bilinearly
    resampled into one half-width quad of the output, as `ShowSplitScreen`
    draws each texture over a half-screen ortho quad with full [0,1]
    texcoords (`MotionMagnificationProcessor.cs:458-487`)."""
    out_h = out_h or left.shape[-2]
    out_w = out_w or left.shape[-1]
    return torch.cat(
        [bilinear_resize(left, out_h, out_w // 2),
         bilinear_resize(right, out_h, out_w - out_w // 2)],
        dim=-1,
    )


def spatial_frequency_map(pad_h: int, pad_w: int,
                          device=None) -> torch.Tensor:
    """`GenerateSpatialFrequencyMap` (`PhaseDifferenceComputeShader.compute:
    182-192`): radius / 0.707 clamped to 1."""
    fy = torch.arange(pad_h, dtype=torch.float32, device=device) / pad_h - 0.5
    fx = torch.arange(pad_w, dtype=torch.float32, device=device) / pad_w - 0.5
    return torch.clamp_max(
        torch.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2) / 0.707, 1.0)


def bandpass_weights_view(pad_h: int, pad_w: int, cfg: MagnifyConfig,
                          device=None) -> torch.Tensor:
    """(H, W, 3) color-coded weight map, `GenerateBandpassWeights`
    (`PhaseDifferenceComputeShader.compute:195-217`): blue = rejected,
    green = passed (scaled), red = enhanced."""
    w = bandpass_weight_map(pad_h, pad_w, cfg, device=device)
    w_n = torch.clamp(w / max(cfg.motion_sensitivity * 2.0, 1.0), 0.0, 1.0)
    blue = w_n < 0.1
    red = w_n > 1.5  # unreachable after the clamp, as in the shader
    r = torch.where(red, 1.0, 0.0)
    g = torch.where(blue | red, 0.0, w_n)
    b = torch.where(blue, 1.0, 0.0)
    return torch.stack([r, g, b], dim=-1)


def filtered_phase_delta_view(cur: torch.Tensor, prev: torch.Tensor,
                              cfg: MagnifyConfig) -> torch.Tensor:
    """`GenerateFilteredPhaseDelta` (`PhaseDifferenceComputeShader.compute:
    220-259`): weighted wrapped delta mapped [-pi, pi] -> [0, 1]; gated bins
    render black (0)."""
    pad_h, pad_w = cur.shape[-2:]
    w = bandpass_weight_map(pad_h, pad_w, cfg, device=cur.device)
    gate = ((torch.abs(cur) < cfg.magnitude_threshold)
            | (torch.abs(prev) < cfg.magnitude_threshold))
    delta = wrap_phase(torch.angle(prev) - torch.angle(cur)) * w
    norm = (delta + np.pi) / (2.0 * np.pi)
    return torch.where(gate, 0.0, norm)


def debug_frame_view(frame_rgb: torch.Tensor, cfg: MagnifyConfig,
                     show_magnitude: bool = True,
                     show_phase: bool = False) -> torch.Tensor:
    """The `ProcessDebugView` path (`MotionMagnificationProcessor.cs:
    234-257`): FFT the current frame's Y plane and render the requested
    spectrum view(s), cropped back to frame size, as (H, W, 3).  Both
    flags set => split screen."""
    geom = _geometry(frame_rgb.shape, cfg)
    # Debug views render the DC-centered full spectrum whatever the
    # production spectral path.
    spec, _ = preprocess(frame_rgb,
                         cfg.replace(use_rfft=False, fft_backend="xla"))
    spec0 = spec[..., 0, :, :]
    if show_magnitude and show_phase:
        img = split_screen(magnitude_view(spec0), phase_view(spec0))
    elif show_phase:
        img = phase_view(spec0)
    else:
        img = magnitude_view(spec0)
    img = crop_center(img, geom)
    return torch.stack([img] * 3, dim=-1)
