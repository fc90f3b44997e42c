"""Per-stage device time of the per-frame pipeline at 1080p on one card.

    python -m pbmm_tpu_torch.tools.profile_stages [--frames 8]

Counterpart of `benchmarks/profile_stages.py`: each stage of the per-frame
engine (`engine/pipeline.py`) on an 8-frame batch, timed by CUDA events,
printed in ms a frame.  Diagnostics only.  The config is
`tuned_for_tpu()` with full lanes (`use_hermitian_spectral=False`): the
unfused stages (`amplify_spectrum`, `postprocess`, `ifft2_bitrev`) take
power-of-two widths, and the kept Hermitian lanes (1152 of 2048) are not
one; the JAX script times its unfused stages on the kept lanes all the
same, on lengths its radix-2 tables do not fit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def stages(device, cfg=None, h: int = 1080, w: int = 1920, t: int = 8):
    """[(name, fn, args)] of `benchmarks/profile_stages.py:57-85`: the
    pre stage, the band/phase pass, the post stage and the whole pair
    over the batch, then kernel 8's 2D transforms alone, blur + crop of
    the padded |spectrum| and |ifft|.  Inputs from numpy with seed 0 (a
    noise frame shifted by one column a frame)."""
    from pbmm_tpu_torch.config import MagnifyConfig
    from pbmm_tpu_torch.core.window import (
        crop_center,
        gaussian_blur5,
        geometry_for,
    )
    from pbmm_tpu_torch.engine import pipeline as P
    from pbmm_tpu_torch.spectral.radix2 import fft2_bitrev, ifft2_bitrev

    cfg = cfg or MagnifyConfig().tuned_for_tpu().replace(
        use_hermitian_spectral=False)
    base = np.random.default_rng(0).random((h, w, 3)).astype(np.float32)
    fd = torch.from_numpy(np.stack([np.roll(base, i, axis=1)
                                    for i in range(t)])).to(device)
    spec, yiq = P.preprocess(fd, cfg)
    prev_spec = torch.roll(spec, 1, dims=0)
    amp = P.amplify_spectrum(spec, prev_spec, cfg)[0]
    re = spec.real.reshape((-1,) + tuple(spec.shape[-2:])).contiguous()
    im = spec.imag.reshape((-1,) + tuple(spec.shape[-2:])).contiguous()
    geom = geometry_for(h, w, cfg.pad_mode)
    pad = torch.abs(spec.reshape((-1, 1) + tuple(spec.shape[-2:])))
    return [
        ("preprocess (pad+hann+yiq)", lambda x: P.preprocess(x, cfg), (fd,)),
        ("amplify (bands+phase)",
         lambda c, p: P.amplify_spectrum(c, p, cfg)[0], (spec, prev_spec)),
        ("postprocess (ifft+blur+crop)",
         lambda m, y: P.postprocess(m, y, cfg), (amp, yiq)),
        ("full pair (per frame)", lambda c, p: [
            P.magnify_frame_pair(p[i], c[i], cfg) for i in range(t)],
         (fd, torch.roll(fd, 1, dims=0))),
        ("ifft2_bitrev alone", lambda r, i: ifft2_bitrev(r, i)[0], (re, im)),
        ("fft2_bitrev alone", lambda r: fft2_bitrev(r)[0], (re,)),
        ("blur full-pad + crop", lambda x: crop_center(
            gaussian_blur5(x, cfg.blur_size), geom), (pad,)),
        ("abs(ifft) only",
         lambda r, i: torch.abs(torch.complex(*ifft2_bitrev(r, i))),
         (re, im)),
    ]


def run(device, t: int = 8, reps: int = 8):
    """[(name, ms a frame)] of every stage, warm CUDA-event medians."""
    from pbmm_tpu_torch.tools.kexp import timed

    return [(name, timed(fn, args, reps=reps)[0] / t)
            for name, fn, args in stages(device, t=t)]


def main(argv=None) -> int:
    from pbmm_tpu_torch.tools import require_card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    dev = require_card("profile_stages")
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    for name, ms in run(dev, args.frames, args.reps):
        print(f"{name:28s} {ms:7.3f} ms/frame", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
