"""Pre stage and routing predicates of the chunk engine.

Counterpart of `pbmm_tpu/engine/pipeline.py` for the main path:
`hermitian_active`, `blur_row_window` and `preprocess_cl` (interleaved
f32 or u8 frames, stopping after the row FFT).
The Y plane FMA and the centre pad are plain torch ops, as the JAX package
leaves them to XLA; kernel 1 (`spectral.fused.windowed_row_fft`) follows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import RGB_TO_YIQ, unit_float
from pbmm_tpu_torch.core.window import Geometry, blur_taps, geometry_for
from pbmm_tpu_torch.spectral.fused import (
    aligned_row_window,
    fused_eligible,
    windowed_row_fft,
)
from pbmm_tpu_torch.spectral.hermitian import hermitian_saves


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


def preprocess_cl(frames: torch.Tensor, cfg: MagnifyConfig):
    """Channels-last pre stage: interleaved (T, H, W, 3) RGB -> (re, im,
    i_plane, q_plane), re/im the (T, Hc, Wk) row spectra of the windowed
    content rows of the padded Y plane and i/q the (T, H, W) original
    chroma.  It stops after the row FFT: the chunk engine runs the column
    stages itself (the JAX function's `through_col=False` form)."""
    if not fused_eligible(cfg):
        raise NotImplementedError(
            "only the fused spectral path (MagnifyConfig().tuned_for_tpu()) "
            "is ported; fft_backend='xla'/'mxu' and the unfused kernels are "
            "ROADMAP items 8 and 10")
    if cfg.chroma != "y_only":
        raise NotImplementedError(
            "chroma='rgb' is not ported yet (ROADMAP item 6)")
    h_in, w_in = frames.shape[-3], frames.shape[-2]
    geom = geometry_for(h_in, w_in, cfg.pad_mode)
    keep = hermitian_active(cfg, geom)
    r0, r1 = aligned_row_window(geom.y0, geom.y0 + geom.in_h, geom.pad_h)
    m = RGB_TO_YIQ
    f = unit_float(frames)
    y, i_plane, q_plane = (
        f[..., 0] * float(m[d, 0]) + f[..., 1] * float(m[d, 1])
        + f[..., 2] * float(m[d, 2])
        for d in range(3)
    )
    slab = F.pad(y, (geom.x0, geom.pad_w - geom.in_w - geom.x0,
                     geom.y0 - r0, r1 - geom.y0 - geom.in_h))
    re, im = windowed_row_fft(slab, pad_h=geom.pad_h, row0=r0,
                              keep_half=keep)
    return re, im, i_plane, q_plane
