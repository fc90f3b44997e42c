"""The fp64 oracle (`oracle_np.py`) restated in PyTorch, so that it runs
on the card in float64: the benchmark's reference for `correct`.

Nothing of the program under test is imported or read: the reference
takes the configuration as the plain dict of the configuration file
(`configs/<name>.json`, "magnify"), the source frames as the benchmark
made them, and works out again everything the program derives (the
padded planes, the spectra, the carried previous spectrum, the IIR taps,
the blur and the colour transform).

Each step follows `oracle_np.py` line for line; the per-band loop takes
the phase delta of the unmasked spectra once (arg(m z) = arg(z) for a
mask m > 0; where m = 0 both sides are gated), which the oracle's
algebra allows.  `tests/test_portbench_reference.py` holds this module
equal to the numpy oracle.

`Reference(..., store=torch.bfloat16)` is the control: the same steps in
float32 arithmetic with every stage's result (the windowed planes, the
spectra and so the carried spectrum, the IIR taps, the modified
spectrum, the reconstruction, the RGB output) rounded to bfloat16, the
step below the float32 the configuration states.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import oracle_np

RGB_TO_YIQ = oracle_np.RGB_TO_YIQ
YIQ_TO_RGB = oracle_np.YIQ_TO_RGB


class Reference:
    """The reference pipeline for one configuration and frame size on one
    device.  `cfg` is the configuration file's "magnify" dict."""

    def __init__(self, cfg: dict, height: int, width: int, device,
                 store: Optional[torch.dtype] = None):
        for unsupported in ("compensate_window", "apply_yiq_gains",
                            "apply_magnitude_scale"):
            if cfg.get(unsupported):
                raise ValueError(f"the oracle has no {unsupported}")
        self.cfg = cfg
        self.h, self.w = height, width
        self.dev = torch.device(device)
        self.store = store
        self.real = torch.float32 if store is not None else torch.float64
        self.cplx = (torch.complex64 if store is not None
                     else torch.complex128)
        ph, pw, y0, x0 = oracle_np._pad_geometry(height, width,
                                                 cfg["pad_mode"])
        self.geom = (ph, pw, y0, x0)
        self.planes = 3 if cfg["chroma"] == "rgb" else 1
        self.win = self._t(oracle_np._hann(ph)[:, None]
                           * oracle_np._hann(pw)[None, :])
        self.rgb_to_yiq = self._t(RGB_TO_YIQ)
        self.yiq_to_rgb = self._t(YIQ_TO_RGB)
        self.taps = [float(t) for t in
                     oracle_np._derived_blur_taps(cfg["blur_size"])]
        ns = _Namespace(cfg)
        if cfg["mode"] == "pyramid":
            if cfg["orientations"] > 1 and cfg["pyramid_levels"] >= 3:
                masks, flags = oracle_np.steerable_mask_planes(
                    ph, pw, cfg["pyramid_levels"], cfg["min_frequency"],
                    cfg["max_frequency"], cfg["orientations"])
            else:
                masks = oracle_np.pyramid_masks(
                    ph, pw, cfg["pyramid_levels"], cfg["min_frequency"],
                    cfg["max_frequency"])
                flags = np.zeros(len(masks), bool)
                flags[1:-1] = len(masks) >= 3
            self.masks = [self._t(m) for m in masks]
            self.flags = [bool(f) for f in flags]
        else:
            self.wmap = self._t(oracle_np.standard_weight(ph, pw, ns))
        if cfg["temporal"]["mode"] == "iir_bandpass":
            t = cfg["temporal"]
            self.r_hi = 1.0 - math.exp(
                -2.0 * math.pi * t["high_hz"] / t["fps"])
            self.r_lo = 1.0 - math.exp(
                -2.0 * math.pi * t["low_hz"] / t["fps"])

    # -- precision -----------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            self.dev, self.real)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's result as stored: unchanged in the reference, rounded
        to `store` (real and imaginary parts apart) in the control."""
        if self.store is None:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(self.store).to(self.real),
                                 x.imag.to(self.store).to(self.real))
        return x.to(self.store).to(self.real)

    # -- stages (oracle_np._preprocess, _amplify, _postprocess) --------
    def rgb(self, frame: torch.Tensor) -> torch.Tensor:
        """A source frame as the benchmark holds it (uint8 (3, H, W)
        planar, or float32 (H, W, 3) interleaved) -> (H, W, 3) RGB in
        [0, 1] in the working precision."""
        if frame.dtype == torch.uint8:
            return self._q(frame.to(self.dev).permute(1, 2, 0).to(
                self.real) / 255.0)
        return self._q(frame.to(self.dev, self.real))

    def preprocess(self, rgb: torch.Tensor):
        """-> ((C, ph, pw) centred spectra, (ph, pw, 3) windowed YIQ)."""
        ph, pw, y0, x0 = self.geom
        yiq = rgb @ self.rgb_to_yiq.T
        padded = torch.zeros((ph, pw, 3), dtype=self.real, device=self.dev)
        padded[y0:y0 + self.h, x0:x0 + self.w] = yiq
        windowed = self._q(padded * self.win[..., None])
        planes = windowed[..., :self.planes].permute(2, 0, 1)
        spec = torch.fft.fftshift(torch.fft.fft2(planes.to(self.cplx)),
                                  dim=(-2, -1))
        return self._q(spec), windowed

    def amplify(self, cur, prev, delta_override=None):
        cfg = self.cfg
        tau, scale = cfg["magnitude_threshold"], cfg["phase_scale"]
        if delta_override is None:
            delta = _wrap(torch.angle(prev) - torch.angle(cur))
        else:
            delta = delta_override
        if cfg["mode"] == "pyramid":
            rot = torch.polar(torch.ones_like(delta), scale * delta)
            acur, aprev = cur.abs(), prev.abs()
            acc = torch.zeros_like(cur)
            for m, amplified in zip(self.masks, self.flags):
                ci = cur * m
                if not amplified:
                    acc = acc + ci
                    continue
                gate = (acur * m < tau) | (aprev * m < tau)
                acc = acc + torch.where(gate, ci, ci * rot)
            return self._q(acc)
        gate = (cur.abs() < tau) | (prev.abs() < tau)
        out = cur * torch.polar(torch.ones_like(delta),
                                scale * (delta * self.wmap))
        return self._q(torch.where(gate, cur, out))

    def postprocess(self, mod, windowed) -> torch.Tensor:
        """(C, ph, pw) modified spectra -> (H, W, 3) RGB in [0, 1]."""
        ph, pw, y0, x0 = self.geom
        rec = torch.fft.ifft2(torch.fft.ifftshift(mod, dim=(-2, -1)))
        y = rec.abs() if self.cfg["reconstruct"] == "magnitude" else rec.real
        y = self._q(y)
        y = _blur(_blur(y, self.taps, -1), self.taps, -2)
        if self.planes == 3:
            out_yiq = y.permute(1, 2, 0)
        else:
            out_yiq = torch.stack([y[0], windowed[..., 1], windowed[..., 2]],
                                  dim=-1)
        rgb = (out_yiq @ self.yiq_to_rgb.T).clamp(0.0, 1.0)
        return self._q(rgb[y0:y0 + self.h, x0:x0 + self.w])

    # -- streams ---------------------------------------------------------
    def two_frame(self, prev_frame, frames) -> torch.Tensor:
        """Frames magnified each against its predecessor
        (`oracle_magnify_pair` over the chunk): `prev_frame` is the
        stream's frame before `frames[0]`.  -> (T, H, W, 3)."""
        prev, _ = self.preprocess(self.rgb(prev_frame))
        outs = []
        for f in frames:
            cur, win = self.preprocess(self.rgb(f))
            outs.append(self.postprocess(self.amplify(cur, prev), win))
            prev = cur
        return torch.stack(outs)

    def iir(self, frames, keep: int) -> torch.Tensor:
        """`oracle_magnify_video_iir` over `frames`, whose first is the
        frame the taps start from at zero (the stream's frame 0, or a
        frame far enough back that the taps' memory of what came before
        has decayed: see `iir_replay_frames`); returns the last `keep`
        outputs, (keep, H, W, 3)."""
        prev, _ = self.preprocess(self.rgb(frames[0]))
        lp_fast = torch.zeros(prev.shape, dtype=self.real, device=self.dev)
        lp_slow = torch.zeros_like(lp_fast)
        outs = []
        n = len(frames)
        for t in range(1, n):
            cur, win = self.preprocess(self.rgb(frames[t]))
            delta = _wrap(torch.angle(prev) - torch.angle(cur))
            lp_fast = self._q(lp_fast + self.r_hi * (delta - lp_fast))
            lp_slow = self._q(lp_slow + self.r_lo * (delta - lp_slow))
            if t >= n - keep:
                mod = self.amplify(cur, prev, delta_override=lp_fast - lp_slow)
                outs.append(self.postprocess(mod, win))
            prev = cur
        return torch.stack(outs)

    def iir_replay_frames(self, bound: float = 1e-12) -> int:
        """Frames of history the IIR replay starts from.  Each tap
        follows lp <- (1 - r) lp + r delta with |delta| <= pi, so starting
        it at zero L frames back instead of at its true value leaves an
        error of at most pi (1 - r)^L; the slow tap's r is the smaller.
        The band (lp_fast - lp_slow) is then off by at most 2 pi
        (1 - r_lo)^L, below `bound` radians."""
        return int(math.ceil(math.log(bound / (2.0 * math.pi))
                             / math.log(1.0 - self.r_lo)))


class _Namespace:
    """Attribute access to the configuration dict, for the oracle's
    helpers that read `cfg.<field>`."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def _blur(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """`oracle_np._blur_1d` on (C, H, W): a symmetric kernel along `axis`
    with edge-replicate padding."""
    radius = (len(taps) - 1) // 2
    pad = (radius, radius, 0, 0) if axis == -1 else (0, 0, radius, radius)
    p = F.pad(img[None], pad, mode="replicate")[0]
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for k, t in enumerate(taps):
        out = out + p.narrow(axis, k, n) * t
    return out
