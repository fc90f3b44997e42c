"""Pure-numpy transcription of the reference pipeline — the executable spec.

A copy of `pbmm_tpu/oracle/reference.py`, line for line below this
paragraph, so the port and its card suite (`tests/test_torch_cuda.py`)
hold their results against the oracle without importing the JAX package
(whose `__init__` imports jax); a CPU test requires both copies to give
equal arrays.

This module re-states, in double precision numpy, exactly the math the Unity
reference performs per frame (every formula cited to its HLSL/C# source).  It
is deliberately written as a straight-line, per-band, unfused program — the
*opposite* shape from the fused TPU implementation — so agreement between the
two is meaningful evidence of correctness (SURVEY.md §4, test strategy (b)).

Pipeline per frame pair (SURVEY.md §3.2):
  RGB->YIQ (`RGBToYIQ.shader:46-50`)
  center-pad to NxN, black borders (`MotionMagnificationProcessor.cs:358-384`)
  2D Hann window at pixel-center uv (`WindowingFunction.shader:46-70`)
  Y-plane FFT, DC-centered via (-1)^(x+y) premodulation
    (`FFT.compute:113-120,175-189`; == fftshift(fft2(y)) for even N)
  pyramid: per-band mask multiply, per-band phase-delta rotation with
    magnitude gate, skip-ends rule, accumulate
    (`PyramidOperations.compute`, `PyramidPhaseDifference.compute`)
  standard: whole-spectrum rotation weighted by the radial bandpass
    (`PhaseDifferenceComputeShader.compute:124-179`)
  IFFT via conj-FFT-conj-normalize-center; output = |z|
    (`MotionMagnificationProcessor.cs:563-620`, `FFT.compute:143-150`)
  bilinear 5-tap Gaussian at _BlurSize=0.5, H then V
    (`GaussianBlur.shader:52-57`, `MotionMagnificationProcessor.cs:423-433`)
  combine processed Y with *windowed* I/Q (`CombineYIQChannels.shader:44-57`)
  YIQ->RGB + saturate (`YIQToRGB.shader:51-55,76`), center-crop
"""

from __future__ import annotations

import numpy as np

RGB_TO_YIQ = np.array(
    [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]]
)
YIQ_TO_RGB = np.array(
    [[1.0, 0.956, 0.621], [1.0, -0.272, -0.647], [1.0, -1.106, 1.703]]
)


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_geometry(h, w, pad_mode="square_pow2"):
    if pad_mode == "square_pow2":
        n = _next_pow2(max(h, w))
        ph = pw = n
    elif pad_mode == "tight":
        # height -> smallest multiple of 128 (core.window.geometry_for)
        ph, pw = max(-(-h // 128) * 128, 128), _next_pow2(w)
    else:
        ph, pw = _next_pow2(h), _next_pow2(w)
    return ph, pw, (ph - h) // 2, (pw - w) // 2


def _hann(n):
    # uv at pixel centers: (i + 0.5)/N  (`WindowingFunction.shader:57-63`)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * (np.arange(n) + 0.5) / n))


def _smoothstep(t):
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _wrap(x):
    # `normalize_phase` while-loop (`PhaseDifferenceComputeShader.compute:
    # 63-71`); single round-half-even correction is equivalent for |x|<2pi.
    return x - 2.0 * np.pi * np.round(x / (2.0 * np.pi))


def pyramid_masks(ph, pw, levels, min_f, max_f):
    """`GeneratePyramidFilters` (`PyramidOperations.compute:25-87`)."""
    fy = np.arange(ph)[:, None] / ph - 0.5
    fx = np.arange(pw)[None, :] / pw - 0.5
    freq = np.hypot(fx, fy)
    out = np.zeros((levels, ph, pw))
    for i in range(levels):
        if i == 0:
            m = np.where(freq > max_f, 1.0,
                         np.where(freq > 0.8 * max_f,
                                  _smoothstep((freq - 0.8 * max_f) / (0.2 * max_f)),
                                  0.0))
        elif i == levels - 1:
            m = np.where(freq < min_f, 1.0,
                         np.where(freq < 1.2 * min_f,
                                  1.0 - _smoothstep((freq - min_f) / (0.2 * min_f)),
                                  0.0))
        else:
            if levels == 3:
                m = np.zeros_like(freq)  # NaN-ratio quirk: mask is all-zero
            else:
                r = (i - 1) / (levels - 3)
                c = min_f * (max_f / min_f) ** (1.0 - r)
                lo, hi = c - 0.5 * c, c + 0.5 * c
                t = (freq - lo) / (hi - lo)
                m = np.where((freq >= lo) & (freq <= hi),
                             0.5 * (1.0 + np.cos(2.0 * np.pi * (t - 0.5))), 0.0)
        out[i] = m
    return out


def steerable_mask_planes(ph, pw, levels, min_f, max_f, orientations):
    """fp64 mask planes + amplified flags for the steerable angular
    extension (green-field vs the reference, whose bank is radial only —
    `PyramidOperations.compute:25-87`; spec: mid radial bands split into K
    partition-of-unity angular sectors cos^(2(K-1))(theta - pi k/K),
    normalized across sectors so the K sector masks of a band sum back to
    the radial band exactly; high/low pass stay radial and unamplified).

    Written independently of `pyramid.filters._steerable_bank_np` (direct
    per-plane formulas, no shared code) so end-to-end agreement pins the
    production bank's *values*, not just its partition-of-unity algebra.

    Returns (planes (n, ph, pw) float64, amplified (n,) bool).
    """
    radial = pyramid_masks(ph, pw, levels, min_f, max_f)
    if orientations <= 1 or levels < 3:
        flags = np.zeros(levels, bool)
        flags[1:-1] = levels >= 3
        return radial, flags
    fy = np.arange(ph)[:, None] / ph - 0.5
    fx = np.arange(pw)[None, :] / pw - 0.5
    theta = np.arctan2(fy + 0.0 * fx, fx + 0.0 * fy)
    p = 2 * (orientations - 1)
    sect = np.stack([
        np.abs(np.cos(theta - np.pi * k / orientations)) ** p
        for k in range(orientations)
    ])
    denom = sect.sum(axis=0)
    sect /= np.where(denom == 0.0, 1.0, denom)
    planes = [radial[0]]
    flags = [False]
    for i in range(1, levels - 1):
        for k in range(orientations):
            planes.append(radial[i] * sect[k])
            flags.append(True)
    planes.append(radial[-1])
    flags.append(False)
    return np.stack(planes), np.asarray(flags, bool)


def standard_weight(ph, pw, cfg):
    """`calculate_spatial_frequency` + `calculate_bandpass_weight`
    (`PhaseDifferenceComputeShader.compute:74-122`)."""
    fy = np.arange(ph)[:, None] / ph - 0.5
    fx = np.arange(pw)[None, :] / pw - 0.5
    f = np.minimum(np.hypot(fx, fy) / 0.707, 1.0)
    if not cfg.apply_bandpass:
        return np.ones_like(f)
    w = np.ones_like(f)
    w = np.where(f < cfg.low_freq_cutoff,
                 w * (f / max(cfg.low_freq_cutoff, 1e-3)) ** cfg.filter_steepness, w)
    w = np.where(f > cfg.high_freq_cutoff,
                 w * ((1.0 - f) / max(1.0 - cfg.high_freq_cutoff, 1e-3))
                 ** cfg.filter_steepness, w)
    w = w * cfg.motion_sensitivity
    edge = cfg.edge_enhancement if cfg.enhance_edges else 0.0
    mid = (f > cfg.low_freq_cutoff) & (f < cfg.high_freq_cutoff)
    w = np.where(mid, w * (1.0 + edge * np.sin(
        np.pi * (f - cfg.low_freq_cutoff)
        / (cfg.high_freq_cutoff - cfg.low_freq_cutoff))), w)
    return np.maximum(w, 0.0)


def _derived_blur_taps(blur_size=0.5):
    """Discrete equivalent of the bilinear-sampled 5-tap blur
    (`GaussianBlur.shader:52-57` at _BlurSize=0.5)."""
    offs = np.array([1.3846153846, 3.2307692308]) * blur_size
    wts = np.array([0.3162162162, 0.0702702703])
    radius = int(np.ceil(offs.max()))
    taps = np.zeros(2 * radius + 1)
    taps[radius] = 0.2270270270
    for off, w in zip(offs, wts):
        lo = int(np.floor(off))
        fr = off - lo
        for s in (+1, -1):
            taps[radius + s * lo] += w * (1.0 - fr)
            taps[radius + s * (lo + 1)] += w * fr
    return taps


def _blur_1d(img, taps, axis):
    radius = (len(taps) - 1) // 2
    pads = [(0, 0)] * img.ndim
    pads[axis] = (radius, radius)
    p = np.pad(img, pads, mode="edge")  # clamp wrap mode at texture borders
    out = np.zeros_like(img)
    n = img.shape[axis]
    for k, t in enumerate(taps):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(k, k + n)
        out += p[tuple(sl)] * t
    return out


def _preprocess(frame, cfg):
    """-> ((C, ph, pw) spectra, windowed padded YIQ, geometry).  C = 1
    (the Y plane, reference behavior) or 3 when chroma="rgb" (all YIQ
    planes FFT-bound — the TPU extension; r5: the oracle previously
    amplified only Y even for rgb configs, so rgb parity numbers were
    comparing against the WRONG spec)."""
    h, w = frame.shape[:2]
    ph, pw, y0, x0 = _pad_geometry(h, w, cfg.pad_mode)
    yiq = frame @ RGB_TO_YIQ.T
    padded = np.zeros((ph, pw, 3))
    padded[y0 : y0 + h, x0 : x0 + w] = yiq
    win = _hann(ph)[:, None] * _hann(pw)[None, :]
    windowed = padded * win[..., None]
    nch = 3 if getattr(cfg, "chroma", "y_only") == "rgb" else 1
    spec = np.stack([
        np.fft.fftshift(np.fft.fft2(windowed[..., c])) for c in range(nch)
    ])
    return spec, windowed, (ph, pw, y0, x0)


def _amplify(cur, prev, cfg, ph, pw, delta_override=None):
    tau = cfg.magnitude_threshold
    scale = cfg.phase_scale
    if cfg.mode == "pyramid":
        if getattr(cfg, "orientations", 0) > 1 and cfg.pyramid_levels >= 3:
            masks, flags = steerable_mask_planes(
                ph, pw, cfg.pyramid_levels, cfg.min_frequency,
                cfg.max_frequency, cfg.orientations)
        else:
            masks = pyramid_masks(ph, pw, cfg.pyramid_levels,
                                  cfg.min_frequency, cfg.max_frequency)
            flags = np.zeros(len(masks), bool)
            flags[1:-1] = len(masks) >= 3
        acc = np.zeros_like(cur)
        for i in range(len(masks)):
            ci = cur * masks[i]
            pi = prev * masks[i]
            if not flags[i]:
                acc += ci  # skip-ends (`PyramidPhaseDifference.compute:73-77`)
                continue
            gate = (np.abs(ci) < tau) | (np.abs(pi) < tau)
            if delta_override is None:
                delta = _wrap(np.angle(pi) - np.angle(ci))
            else:
                delta = delta_override  # arg(m*z) == arg(z) for m > 0
            acc += np.where(gate, ci, ci * np.exp(1j * scale * delta))
        return acc
    else:
        wmap = standard_weight(ph, pw, cfg)
        gate = (np.abs(cur) < tau) | (np.abs(prev) < tau)
        if delta_override is None:
            delta = _wrap(np.angle(prev) - np.angle(cur))
        else:
            delta = delta_override
        out = cur * np.exp(1j * scale * (delta * wmap))
        return np.where(gate, cur, out)


def _postprocess(mod_spec, windowed, geom, cfg):
    """(C, ph, pw) modified spectra -> clipped RGB.  C = 1: processed Y
    + windowed original I/Q; C = 3 (chroma="rgb"): all three planes are
    processed reconstructions (`posttail`'s rgb branch)."""
    ph, pw, y0, x0 = geom
    rec = np.fft.ifft2(np.fft.ifftshift(mod_spec, axes=(-2, -1)))
    y = np.abs(rec) if cfg.reconstruct == "magnitude" else np.real(rec)
    taps = _derived_blur_taps(cfg.blur_size)
    y = _blur_1d(y, taps, -1)  # horizontal first (`:428-429`)
    y = _blur_1d(y, taps, -2)
    if y.shape[0] == 3:
        out_yiq = np.moveaxis(y, 0, -1)
    else:
        out_yiq = np.stack(
            [y[0], windowed[..., 1], windowed[..., 2]], axis=-1)
    return np.clip(out_yiq @ YIQ_TO_RGB.T, 0.0, 1.0)


def oracle_magnify_pair(prev_frame: np.ndarray, cur_frame: np.ndarray, cfg):
    """(H, W, 3) float RGB pair -> magnified (H, W, 3), float64."""
    h, w = cur_frame.shape[:2]
    cur, cur_win, geom = _preprocess(np.asarray(cur_frame, np.float64), cfg)
    prev, _, _ = _preprocess(np.asarray(prev_frame, np.float64), cfg)
    ph, pw, y0, x0 = geom
    mod = _amplify(cur, prev, cfg, ph, pw)
    rgb = _postprocess(mod, cur_win, geom, cfg)
    return rgb[y0 : y0 + h, x0 : x0 + w]


def oracle_magnify_video(frames: np.ndarray, cfg) -> np.ndarray:
    """(T, H, W, 3) -> (T, H, W, 3); frame 0 passes through
    (`MotionMagnificationProcessor.cs:111-117`)."""
    out = [np.asarray(frames[0], np.float64)]
    for t in range(1, len(frames)):
        out.append(oracle_magnify_pair(frames[t - 1], frames[t], cfg))
    return np.stack(out)


def oracle_magnify_video_iir(frames: np.ndarray, cfg) -> np.ndarray:
    """fp64 straight-line transcription of the streaming IIR temporal mode
    (the TPU extension; `phase/temporal.py`, BASELINE.json configs 2-5):
    the per-bin phase-delta stream is band-passed with the difference of
    two first-order low-passes carried across frames before amplification.

    Mirrors `engine.video` exactly: frame 0 passes through; the previous
    frame's spectrum is the predecessor's (cache semantics); the low-pass
    states start at zero.
    """
    assert cfg.temporal.mode == "iir_bandpass"
    r_hi, r_lo = cfg.temporal.smoothing_factors()
    frames = np.asarray(frames, np.float64)
    h, w = frames.shape[1:3]
    out = [frames[0]]
    prev_spec, _, geom = _preprocess(frames[0], cfg)
    ph, pw, y0, x0 = geom
    lp_fast = np.zeros(prev_spec.shape)
    lp_slow = np.zeros(prev_spec.shape)
    for t in range(1, len(frames)):
        cur_spec, cur_win, _ = _preprocess(frames[t], cfg)
        delta = _wrap(np.angle(prev_spec) - np.angle(cur_spec))
        lp_fast = lp_fast + r_hi * (delta - lp_fast)
        lp_slow = lp_slow + r_lo * (delta - lp_slow)
        filtered = lp_fast - lp_slow
        mod = _amplify(cur_spec, prev_spec, cfg, ph, pw,
                       delta_override=filtered)
        rgb = _postprocess(mod, cur_win, geom, cfg)
        out.append(rgb[y0:y0 + h, x0:x0 + w])
        prev_spec = cur_spec
    return np.stack(out)
