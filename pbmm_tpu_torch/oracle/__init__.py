"""The fp64 numpy oracle and the synthetic clips, copies of
`pbmm_tpu/oracle/` (numpy only)."""

from pbmm_tpu_torch.oracle.reference import (
    oracle_magnify_pair,
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu_torch.oracle.synthetic import (
    oscillating_bar,
    oscillating_gaussian_blob,
    single_tone_bar,
)

__all__ = [
    "oracle_magnify_pair",
    "oracle_magnify_video",
    "oracle_magnify_video_iir",
    "oscillating_bar",
    "oscillating_gaussian_blob",
    "single_tone_bar",
]
