"""RGB <-> YIQ color constants and the unit-float frame convention.

Counterpart of `pbmm_tpu/core/color.py`: the NTSC matrices of the
reference fragment shaders (`RGBToYIQ.shader:46-50`,
`YIQToRGB.shader:51-55`), as float32 numpy constants so both packages
fold the same scalars into their kernels; and the two frame layouts.
"""

from __future__ import annotations

import numpy as np
import torch


def is_planar(frames) -> bool:
    """(T, 3, H, W) channel-planar frames (the y4m / video-file layout),
    as against the reference's interleaved (T, H, W, 3)."""
    return (frames.ndim == 4 and frames.shape[1] == 3
            and frames.shape[-1] != 3)


def unit_float(x: torch.Tensor) -> torch.Tensor:
    """Frames to f32 in [0, 1]: uint8 inputs are scaled by 1/255, other
    dtypes are cast as-is (the original [0, 1] f32 contract)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * np.float32(1.0 / 255.0)
    return x.to(torch.float32)


# Rows: Y, I, Q.  `RGBToYIQ.shader:46-50`.
RGB_TO_YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.596, -0.274, -0.322],
        [0.211, -0.523, 0.312],
    ],
    dtype=np.float32,
)

# Rows: R, G, B.  `YIQToRGB.shader:51-55`.  (Not the exact inverse of the
# above — the reference hardcodes both matrices; both are reproduced.)
YIQ_TO_RGB = np.array(
    [
        [1.0, 0.956, 0.621],
        [1.0, -0.272, -0.647],
        [1.0, -1.106, 1.703],
    ],
    dtype=np.float32,
)


def channel_mix(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                row) -> torch.Tensor:
    """row[0] c0 + row[1] c1 + row[2] c2 as f32 multiplies and adds in
    that order: the JAX package's order for every colour-matrix row,
    which the CUDA kernels reproduce bit for bit."""
    return c0 * float(row[0]) + c1 * float(row[1]) + c2 * float(row[2])


def _apply_3x3(x: torch.Tensor, m: np.ndarray, axis: int = -1
               ) -> torch.Tensor:
    """A 3x3 channel transform along `axis`, one `channel_mix` per row."""
    chans = [x.select(axis, k) for k in range(3)]
    rows = [channel_mix(*chans, m[d]) for d in range(3)]
    return torch.stack(rows, dim=axis if axis >= 0 else x.ndim + axis)


def rgb_to_yiq(rgb: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """RGB -> YIQ along the channel `axis` (`RGBToYIQ.shader:46-50`)."""
    return _apply_3x3(rgb, RGB_TO_YIQ, axis)


def yiq_to_rgb(yiq: torch.Tensor, saturate: bool = True,
               axis: int = -1) -> torch.Tensor:
    """YIQ -> RGB along the channel `axis`; `saturate` applies the
    reference's [0, 1] clamp after the matrix (`YIQToRGB.shader:76`)."""
    rgb = _apply_3x3(yiq, YIQ_TO_RGB, axis)
    if saturate:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    return rgb
