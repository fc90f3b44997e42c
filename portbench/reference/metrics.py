"""Frozen copy of `psnr`, from `pbmm_tpu_torch/utils/metrics.py` at
commit 46ab5a86602a (a copy of `pbmm_tpu/utils/metrics.py`), unchanged,
and `psnr_frames`, the same formula over each frame of a batch on the
tensors' device (the check's frames are too large to copy to the host)."""

from __future__ import annotations

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def psnr_frames(a: torch.Tensor, b: torch.Tensor,
                peak: float = 1.0) -> list:
    """`psnr` of each frame a[i] against b[i], in float64."""
    d = (a.to(torch.float64) - b.to(torch.float64)).reshape(a.shape[0], -1)
    mse = (d * d).mean(dim=1).tolist()
    return [float("inf") if m == 0 else float(10.0 * np.log10(peak * peak / m))
            for m in mse]
