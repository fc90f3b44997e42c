"""The cell's source frames: a ring of decoded frames made on the device
from the seed.

Each frame is textured content with sub-pixel motion: a few colour
gratings of seeded frequency, orientation and phase drifting together,
the soft vertical bar of `reference/synthetic.py::oscillating_bar`
oscillating across them and a Gaussian blob moving diagonally, plus
seeded sensor noise drawn afresh for every frame.  Every motion is
periodic over the ring, a whole number of cycles, so the stream wraps
from the last frame to the first as smoothly as between any two, and the
bar and the blob move within the EVM band (0.4-3 Hz at 30 fps) while the
gratings drift below it.

The small parameters come from numpy's generator seeded with `seed`; the
noise from a `torch.Generator` on the device, in one call per block of
frames.  The same seed gives the same frames on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BLOCK = 16  # frames drawn at a time (bounds the float32 temporaries)


def make_ring(seed: int, frames: int, height: int, width: int, fmt: str,
              content: dict, device) -> torch.Tensor:
    """`frames` frames of (height, width): uint8 planar (T, 3, H, W) for
    `fmt` "u8_planar", float32 interleaved (T, H, W, 3) in [0, 1] for
    "f32_interleaved"."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = content["gratings"]
    theta = rng.uniform(0.0, math.pi, k)
    cyc = rng.uniform(content["min_cycles_per_px"],
                      content["max_cycles_per_px"], k)
    fx, fy = cyc * np.cos(theta), cyc * np.sin(theta)
    phase = rng.uniform(0.0, 2.0 * math.pi, k)
    amp = rng.uniform(0.5, 1.0, (3, k))
    amp *= content["texture_contrast"] / amp.sum(axis=1, keepdims=True)
    base = rng.uniform(0.3, 0.5, 3)
    tint = (1.0, 0.9, 0.8)

    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    if fmt == "u8_planar":
        ring = torch.empty((frames, 3, height, width), dtype=torch.uint8,
                           device=dev)
    elif fmt == "f32_interleaved":
        ring = torch.empty((frames, height, width, 3), dtype=torch.float32,
                           device=dev)
    else:
        raise ValueError(f"unknown frame format {fmt!r}")
    noise = content["noise_levels"] / 255.0
    for b0 in range(0, frames, _BLOCK):
        nb = min(_BLOCK, frames - b0)
        img = torch.empty((nb, 3, height, width), dtype=torch.float32,
                          device=dev)
        for i in range(nb):
            img[i] = _frame(b0 + i, frames, content, x, y, fx, fy, phase,
                            amp, base, tint)
        img += noise * torch.randn(img.shape, generator=gen, device=dev)
        img.clamp_(0.0, 1.0)
        if fmt == "u8_planar":
            ring[b0:b0 + nb] = torch.round(img * 255.0).to(torch.uint8)
        else:
            ring[b0:b0 + nb] = img.permute(0, 2, 3, 1)
    return ring


def _frame(t, frames, content, x, y, fx, fy, phase, amp, base, tint):
    """Frame t of the ring before noise: (3, H, W) float32."""
    s = 2.0 * math.pi * t / frames
    dx = content["drift_px"] * math.sin(s * content["drift_cycles"])
    dy = 0.5 * content["drift_px"] * math.cos(s * content["drift_cycles"])
    h, w = y.numel(), x.numel()
    img = torch.empty((3, h, w), dtype=torch.float32, device=x.device)
    for c in range(3):
        img[c] = base[c]
    for j in range(len(fx)):
        # cos(a(x) + b(y)) as two outer products of 1-D tables.
        ax = 2.0 * math.pi * fx[j] * (x - dx) + phase[j]
        by = 2.0 * math.pi * fy[j] * (y - dy)
        grating = (torch.cos(by)[:, None] * torch.cos(ax)[None, :]
                   - torch.sin(by)[:, None] * torch.sin(ax)[None, :])
        for c in range(3):
            img[c] += float(amp[c, j]) * grating
    # oscillating_bar's profile, moving by sub-pixel amounts.
    cx = w / 2 + content["bar_px"] * math.sin(s * content["bar_cycles"])
    bar = 0.6 * torch.exp(-0.5 * ((x - cx) / content["bar_width"]) ** 2)
    by_ = h / 2 + content["blob_px"] * math.sin(s * content["blob_cycles"])
    bx_ = w / 3 + content["blob_px"] * math.sin(s * content["blob_cycles"])
    sig = content["blob_sigma"]
    blob = 0.3 * (torch.exp(-0.5 * ((y - by_) / sig) ** 2)[:, None]
                  * torch.exp(-0.5 * ((x - bx_) / sig) ** 2)[None, :])
    for c in range(3):
        img[c] += tint[c] * (bar[None, :] + blob)
    return img
