"""pbmm_tpu_torch — the PyTorch / CUDA port of pbmm_tpu for NVIDIA Hopper.

A second package beside the JAX reference `pbmm_tpu`, with its module
paths, config fields and entry points: `magnify_video` (the batched chunk
engine where the JAX package takes it, else the per-frame scan engine)
and `magnify_frame_pair`, for every `MagnifyConfig`.  Every TPU kernel
on those paths is a hand-written CUDA kernel for sm_90a under `csrc/`
(numbered as in PERF.md):

    spectral/fused.py::windowed_row_fft[_u8planar]  csrc/row_fft.cu      1, 4
    spectral/fused.py::windowed_row_fft_frames       csrc/row_fft.cu      front end
    spectral/fused.py::colspec_chunk                 csrc/colspec_chunk.cu 2
    engine/post_fused.py::rowifft_post_fused         csrc/rowifft_post.cu  3
    spectral/fused.py::col_fft_zero_padded           csrc/col_fft.cu       5
    spectral/fused.py::phase_col_ifft                csrc/phase_col_ifft.cu 6
    spectral/fused.py::row_ifft_magnitude            csrc/row_ifft.cu      7
    spectral/radix2.py::_fft_axis                    csrc/fft_axis.cu      8
    phase/fused_kernels.py::amplify_procedural       csrc/amplify_procedural.cu 9
    engine/post_fused.py::post_fused[_rgb]           csrc/post_rgb.cu      10, 11
    tools/kdecomp.py::kdecomp_variant                csrc/kdecomp.cu       12
    tools/kexp.py::copy_probe                        csrc/copy_probe.cu    13
    tools/trig_probe.py::trig_probe                  csrc/trig_probe.cu    14

The front end is kernel 4's kernel on every input form of the batched
chunk engine: the pre stage the JAX package leaves to XLA (the YIQ
planes, the pad, the window) happens in its loads.  Kernels 12-14 serve
the measurement path: `tools/` holds the counterparts
of the JAX package's `benchmarks/` scripts, `tools/parity.py` and
`tools/multihost.py`, and `utils/` its metrics, checks, profiling and
debug views.  `parallel/` holds the multi-device engines on
`torch.distributed` (the batched clip, the ("data", "frame")-sharded
batch, the rows-sharded spatial engine).  `fft_backend="mxu"` is
`spectral/mxu_fft.py`, the four-step DFT as `torch.matmul` products (the
JAX package's XLA einsums, no kernel); `native/` the host C++ `.npy`
prefetch loader that `io/stream.py` reads `.npy` inputs through.

Tensors on the CPU take each kernel's plain PyTorch version (`*_ref`);
tensors on the card launch the kernels (built with nvcc at first use,
`kernels/build.py`); numpy input runs on the card unless the caller
passes `device`.  The package imports neither jax nor pbmm_tpu.
"""

from pbmm_tpu_torch.config import MagnifyConfig, TemporalConfig
from pbmm_tpu_torch.engine.pipeline import magnify_frame_pair
from pbmm_tpu_torch.engine.video import magnify_video

__all__ = ["MagnifyConfig", "TemporalConfig", "magnify_frame_pair",
           "magnify_video"]
