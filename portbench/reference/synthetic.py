"""Frozen copy of the synthetic test sequences (an oscillating bar, a
single-tone bar, an oscillating blob), float32 RGB in [0, 1].

Copied without change below this docstring from
`pbmm_tpu_torch/oracle/synthetic.py` at commit 46ab5a86602a (a copy of
`pbmm_tpu/oracle/synthetic.py`).  `harness/inputs.py` draws the
benchmark's frames on the card from the same shapes (the bar's profile
and motion), with seeded texture and noise.
"""

from __future__ import annotations

import numpy as np


def oscillating_bar(
    size: int = 128,
    frames: int = 64,
    amplitude: float = 0.8,
    period: float = 16.0,
    bar_width: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """(T, size, size, 3) f32 RGB: a soft vertical bar oscillating
    horizontally by sub-pixel amounts (the motion regime phase-based
    magnification targets), over a low-contrast noise background."""
    rng = np.random.default_rng(seed)
    bg = 0.25 + 0.05 * rng.random((size, size))
    x = np.arange(size)
    out = np.empty((frames, size, size, 3), np.float32)
    for t in range(frames):
        cx = size / 2 + amplitude * np.sin(2.0 * np.pi * t / period)
        profile = np.exp(-0.5 * ((x - cx) / bar_width) ** 2)
        img = np.clip(bg + 0.6 * profile[None, :], 0.0, 1.0)
        out[t] = np.stack([img, img * 0.9, img * 0.8], axis=-1)
    return out


def single_tone_bar(
    size: int = 64,
    frames: int = 90,
    fps: float = 30.0,
    f_hz: float = 1.5,
    amp: float = 0.1,
    sigma: float = 1.2,
) -> np.ndarray:
    """(T, size, size, 3) f32: ONE centered soft vertical bar oscillating
    horizontally at a single temporal frequency `f_hz` — the probe for the
    IIR temporal band-pass's frequency selectivity.  One tone per clip on
    purpose: the pipeline's per-bin phase deltas are *global* (the FFT
    mixes every moving feature in the frame), so two tones in one clip
    contaminate each other's measurement."""
    x = np.arange(size, dtype=np.float64)
    out = np.empty((frames, size, size, 3), np.float32)
    for t in range(frames):
        c = size / 2 + amp * np.sin(2.0 * np.pi * f_hz * t / fps)
        img = 0.2 + 0.6 * np.exp(-0.5 * ((x - c) / sigma) ** 2)
        frame = np.broadcast_to(img[None, :], (size, size))
        out[t] = np.clip(frame, 0.0, 1.0)[..., None].repeat(3, axis=-1)
    return out


def oscillating_gaussian_blob(
    height: int = 128,
    width: int = 128,
    frames: int = 32,
    amplitude: float = 0.5,
    period: float = 8.0,
    sigma: float = 10.0,
) -> np.ndarray:
    """(T, H, W, 3) f32: 2D Gaussian blob oscillating diagonally."""
    yy, xx = np.mgrid[0:height, 0:width]
    out = np.empty((frames, height, width, 3), np.float32)
    for t in range(frames):
        d = amplitude * np.sin(2.0 * np.pi * t / period)
        cy, cx = height / 2 + d, width / 2 + d
        img = 0.2 + 0.7 * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)
        )
        out[t] = img[..., None].repeat(3, axis=-1)
    return out.astype(np.float32)
