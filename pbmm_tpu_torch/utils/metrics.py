"""Quality metrics for parity checks (BASELINE.md: PSNR >= 35 dB vs oracle).

A copy of `pbmm_tpu/utils/metrics.py` (numpy only), so the port needs
nothing of the JAX package; a CPU test holds both copies equal."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def ssim_global(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Global (single-window) SSIM — cheap gate for synthetic parity tests;
    NOT the standard metric (see `ssim`)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )


def _gaussian_taps(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return g / g.sum()


def _filter2_valid(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable 'valid'-mode 2D filter over the LAST TWO axes."""
    k = len(taps)

    def conv_axis(v, axis):
        n = v.shape[axis] - k + 1
        out = None
        for i, t in enumerate(taps):
            sl = [slice(None)] * v.ndim
            sl[axis] = slice(i, i + n)
            term = v[tuple(sl)] * t
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(x, -1), -2)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0,
         window: int = 11, sigma: float = 1.5) -> float:
    """Mean structural similarity (Wang et al. 2004): 11x11 Gaussian
    (sigma 1.5) local statistics over the last two (spatial) axes, C1 =
    (0.01*peak)^2, C2 = (0.03*peak)^2; leading axes (frames/channels)
    average into the mean.  A trailing size-3 channel axis is moved out of
    the spatial window."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim >= 3 and a.shape[-1] in (1, 3, 4):
        a = np.moveaxis(a, -1, 0)
        b = np.moveaxis(b, -1, 0)
    if min(a.shape[-1], a.shape[-2]) < window:
        return ssim_global(a, b, peak)
    taps = _gaussian_taps(window, sigma)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _filter2_valid(a, taps)
    mu_b = _filter2_valid(b, taps)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    va = _filter2_valid(a * a, taps) - mu_aa
    vb = _filter2_valid(b * b, taps) - mu_bb
    cov = _filter2_valid(a * b, taps) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (va + vb + c2)
    )
    return float(ssim_map.mean())
