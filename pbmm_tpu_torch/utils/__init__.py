"""Metrics, checks, profiling and debug views (counterpart of
`pbmm_tpu/utils/`)."""

from pbmm_tpu_torch.utils.metrics import psnr, ssim, ssim_global

__all__ = ["psnr", "ssim", "ssim_global"]
