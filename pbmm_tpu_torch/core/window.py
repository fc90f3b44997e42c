"""Pad geometry, the crop-region Hann window and the blur taps.

Counterpart of `pbmm_tpu/core/window.py` for what the main path uses:
`Geometry`/`geometry_for` (pad sizes and centre offsets), `blur_taps`
(the reference's bilinear 5-tap blur as discrete taps), `hann2d_region`
(the padded-frame Hann window on the crop region, which windows the
original chroma in the post stage), the blur of the two-kernel tail
(`gaussian_blur5`, `blur_then_crop`, torch ops), and the scan engine's
`pad_center`, `hann2d` and `crop_center`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Geometry(NamedTuple):
    """Static pad/crop geometry, all ints."""

    in_h: int
    in_w: int
    pad_h: int
    pad_w: int
    y0: int  # top offset of the image inside the padded frame
    x0: int  # left offset


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def geometry_for(in_h: int, in_w: int,
                 pad_mode: str = "square_pow2") -> Geometry:
    """Pad sizes: "square_pow2" (the reference rule, N = next pow2 of
    max(h, w) on both axes), "rect_pow2" (each axis on its own) or
    "tight" (height to the next multiple of 128, width to the next power
    of two — 1080p pads to 1152 x 2048).  Centre placement as the
    reference's GL quad: (N - w) / 2 pixels."""
    if pad_mode == "square_pow2":
        n = _next_pow2(max(in_h, in_w))
        pad_h = pad_w = n
    elif pad_mode == "rect_pow2":
        pad_h, pad_w = _next_pow2(in_h), _next_pow2(in_w)
    elif pad_mode == "tight":
        pad_h = max(-(-in_h // 128) * 128, 128)
        pad_w = _next_pow2(in_w)
    else:
        raise ValueError(f"unknown pad_mode: {pad_mode!r}")
    return Geometry(in_h, in_w, pad_h, pad_w,
                    (pad_h - in_h) // 2, (pad_w - in_w) // 2)


def hann2d_region(geom: Geometry, device=None) -> torch.Tensor:
    """The padded-frame Hann window restricted to the crop region,
    (in_h, in_w) f32, evaluated in f32 as the JAX package does."""
    iy = (torch.arange(geom.in_h, dtype=torch.float32, device=device)
          + geom.y0 + 0.5) / geom.pad_h
    ix = (torch.arange(geom.in_w, dtype=torch.float32, device=device)
          + geom.x0 + 0.5) / geom.pad_w
    wy = 0.5 * (1.0 - torch.cos(2.0 * np.float32(np.pi) * iy))
    wx = 0.5 * (1.0 - torch.cos(2.0 * np.float32(np.pi) * ix))
    return wy[:, None] * wx[None, :]


def hann2d(pad_h: int, pad_w: int, device=None) -> torch.Tensor:
    """The separable 2D Hann window over the padded frame, (pad_h, pad_w)
    f32 at pixel-centre uv (`WindowingFunction.shader:46-70`), evaluated
    in f32 as the JAX package does."""
    iy = (torch.arange(pad_h, dtype=torch.float32, device=device)
          + 0.5) / pad_h
    ix = (torch.arange(pad_w, dtype=torch.float32, device=device)
          + 0.5) / pad_w
    wy = 0.5 * (1.0 - torch.cos(2.0 * np.float32(np.pi) * iy))
    wx = 0.5 * (1.0 - torch.cos(2.0 * np.float32(np.pi) * ix))
    return wy[:, None] * wx[None, :]


def pad_center(img: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Centre-pad the last two (spatial) dims with zeros, (..., H, W) ->
    (..., pad_h, pad_w) (`MotionMagnificationProcessor.cs:358-384`)."""
    return F.pad(img, (geom.x0, geom.pad_w - geom.in_w - geom.x0,
                       geom.y0, geom.pad_h - geom.in_h - geom.y0))


def crop_center(img: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Centre-crop the last two dims back to (..., H, W)."""
    return img[..., geom.y0:geom.y0 + geom.in_h,
               geom.x0:geom.x0 + geom.in_w]


@functools.lru_cache(maxsize=8)
def blur_taps(blur_size: float = 0.5) -> Tuple[float, ...]:
    """Discrete equivalent of the reference's bilinear-sampled 5-tap blur
    (`GaussianBlur.shader:52-57`): each fractional tap splats onto its two
    neighbouring texels; at _BlurSize = 0.5 this is a symmetric 5-tap
    kernel, derived here from the shader's constants."""
    offs = np.array([1.3846153846, 3.2307692308]) * blur_size
    wts = np.array([0.3162162162, 0.0702702703])
    radius = int(np.ceil(offs.max()))
    taps = np.zeros(2 * radius + 1, dtype=np.float64)
    taps[radius] = 0.2270270270
    for off, w in zip(offs, wts):
        lo = int(np.floor(off))
        frac = off - lo
        for sign in (+1, -1):
            taps[radius + sign * lo] += w * (1.0 - frac)
            taps[radius + sign * (lo + 1)] += w * frac
    return tuple(float(t) for t in taps)


def _blur_axis(img: torch.Tensor, taps: Tuple[float, ...],
               axis: int) -> torch.Tensor:
    """A symmetric 1D kernel along `axis` (-1 or -2) with edge-replicate
    padding (the clamp wrap mode of the reference's render textures)."""
    radius = (len(taps) - 1) // 2
    pad = (radius, radius, 0, 0) if axis == -1 else (0, 0, radius, radius)
    padded = F.pad(img.reshape((-1,) + tuple(img.shape[-2:])), pad,
                   mode="replicate")
    padded = padded.reshape(tuple(img.shape[:-2]) + tuple(padded.shape[1:]))
    n = img.shape[axis]
    out = None
    for k, t in enumerate(taps):
        term = padded.narrow(axis, k, n) * t
        out = term if out is None else out + term
    return out


def gaussian_blur5(img: torch.Tensor, blur_size: float = 0.5
                   ) -> torch.Tensor:
    """Separable blur over the last two axes, horizontal then vertical
    like the reference (`MotionMagnificationProcessor.cs:423-433`)."""
    taps = blur_taps(blur_size)
    return _blur_axis(_blur_axis(img, taps, -1), taps, -2)


def blur_then_crop(img: torch.Tensor, geom: Geometry,
                   blur_size: float = 0.5) -> torch.Tensor:
    """`crop(gaussian_blur5(img))` computed on the crop region plus its
    blur halo only: bit-identical, since each kept pixel reads at most
    `radius` texels away, and where the halo is clipped the sub-region's
    edge is the padded image's edge, which edge-replicate reproduces."""
    radius = (len(blur_taps(blur_size)) - 1) // 2
    hy0 = min(radius, geom.y0)
    hx0 = min(radius, geom.x0)
    hy1 = min(radius, geom.pad_h - geom.y0 - geom.in_h)
    hx1 = min(radius, geom.pad_w - geom.x0 - geom.in_w)
    sub = img[..., geom.y0 - hy0:geom.y0 + geom.in_h + hy1,
              geom.x0 - hx0:geom.x0 + geom.in_w + hx1]
    sub = gaussian_blur5(sub, blur_size)
    return sub[..., hy0:hy0 + geom.in_h, hx0:hx0 + geom.in_w]
