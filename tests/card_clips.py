"""The seeded clips the card runs its paths on, on the host: one builder
for the card suite (`tests/test_torch_cuda.py`) and the timer
(`chip_smoke.py`), so both hold and time the same frames."""

import functools

import numpy as np

from pbmm_tpu_torch.oracle import synthetic

# name -> ((frames, height, width), seed) of the shifted-noise clips above
# 1080p: a 2160p chunk of 8, 4320p and 16K chunks of 2.
_NOISE = {"noise4k": ((8, 2160, 3840), 3), "noise8k": ((2, 4320, 7680), 4),
          "noise16k": ((2, 8640, 15360), 5)}


@functools.lru_cache(maxsize=None)
def clip(name):
    """"noise*": shifted noise, interleaved f32 (the JAX bench's clip at
    1080p, 16 frames); "*_u8": the same frames as planar uint8 codes;
    "540p": uint8 noise at 960x540 over 255 (interleaved f32); "bar*": the
    oscillating bar (1080p's rounded to uint8 codes; the branches that
    rotate by atan2 want the motion the method targets), "bar720" 720p."""
    if name in ("noise", "noise_u8"):
        base = np.random.default_rng(0).random((1080, 1920, 3)).astype(
            np.float32)
        f = np.stack([np.roll(base, i, axis=1) * (0.95 + 0.01 * i)
                      for i in range(16)]).astype(np.float32)
        return f if name == "noise" else np.ascontiguousarray(np.moveaxis(
            np.round(f * 255.0).astype(np.uint8), -1, 1))
    if name in ("540p", "540p_u8"):
        b = np.random.default_rng(1).integers(0, 256, (540, 960, 3),
                                              dtype=np.uint8)
        u8 = np.stack([np.roll(b, i, axis=1) for i in range(16)])
        return ((u8 / 255.0).astype(np.float32) if name == "540p"
                else np.ascontiguousarray(np.moveaxis(u8, -1, 1)))
    if name in ("bar", "bar_u8"):
        u8 = np.ascontiguousarray(np.moveaxis(np.round(
            synthetic.oscillating_bar(size=1920, frames=16, bar_width=2)
            [:, :1080] * 255.0).astype(np.uint8), -1, 1))
        return u8 if name == "bar_u8" else np.ascontiguousarray(
            np.moveaxis(u8, 1, -1) / 255.0, np.float32)
    if name == "bar720":
        return np.ascontiguousarray(synthetic.oscillating_bar(
            size=1280, frames=16, bar_width=2)[:, :720])
    (t, h, w), seed = _NOISE[name]
    base = np.random.default_rng(seed).random((h, w, 3), np.float32)
    return np.stack([np.roll(base, shift=i, axis=1) * (0.95 + 0.01 * i)
                     for i in range(t)]).astype(np.float32)
