"""pbmm_tpu_torch — the PyTorch / CUDA port of pbmm_tpu for NVIDIA Hopper.

A second package beside the JAX reference `pbmm_tpu`, with its module
paths, config fields and entry points.  This slice serves the main path:
`magnify_video` with `MagnifyConfig().tuned_for_tpu().replace(
pad_mode="tight")` (pyramid, two-frame, y_only, interleaved frames),
through three hand-written CUDA kernels for sm_90a:

    spectral/fused.py::windowed_row_fft     csrc/row_fft.cu
    spectral/fused.py::colspec_chunk        csrc/colspec_chunk.cu
    engine/post_fused.py::rowifft_post_fused csrc/rowifft_post.cu

Tensors on the CPU take each kernel's plain PyTorch version (`*_ref`);
tensors on the card launch the kernels (built with nvcc at first use,
`kernels/build.py`).  The package imports neither jax nor pbmm_tpu.
"""

from pbmm_tpu_torch.config import MagnifyConfig, TemporalConfig
from pbmm_tpu_torch.engine.video import magnify_video

__all__ = ["MagnifyConfig", "TemporalConfig", "magnify_video"]
