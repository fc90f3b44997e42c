"""The y_only tail's two routes on the card, timed against each other.

    python -m pbmm_tpu_torch.tools.post_times [--reps 10]

Kernel 3 (`rowifft_post_fused` with route=False) against kernel 7 +
kernel 10 (`row_ifft_magnitude`, then `post_fused`), which give the same
bits, at three padded widths: 1024 lanes (768 x 896, square_pow2), 2048
(1080p tight) and 4096 (2160p, square_pow2); 16 frames made with numpy
from a seed; every blur radius 2-14 where a kernel-3 block fits shared
memory; the f32 I/Q planes to tuple3 and the uint8 frames to planar_u8
(`route_calls`).  Each line says which route `post_fused.kernel3_serves`
takes there.  Each call is timed by `kexp.timed` (the device's time, warm
and cold L2); the last line is one JSON object {call: [warm ms, cold
ms]}.  It measures the card and exits 1 without one."""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pbmm_tpu_torch import MagnifyConfig
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.engine.pipeline import blur_row_window
from pbmm_tpu_torch.spectral.fused import row_ifft_magnitude
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width
from pbmm_tpu_torch.tools.kexp import timed

# (height, width, pad_mode) of the three padded widths.
SHAPES = ((768, 896, "square_pow2"), (1080, 1920, "tight"),
          (2160, 3840, "square_pow2"))


def _blur_size(radius: int) -> float:
    """A blur_size whose taps have this radius (1 and up)."""
    return (radius - 0.5) / 3.2307692308


def route_calls(device, h: int = 1080, w: int = 1920, pad_mode: str = "tight",
                radii=range(2, 15), t: int = 16):
    """'radius r, f32|u8' -> (kernel 3's call, kernel 7 + kernel 10's
    call) of the y_only tail on (t, h, w) frames, f32 I/Q to tuple3 and
    uint8 frames to planar_u8, at each radius where a kernel-3 block fits
    (`kernel3_rows`), on the region rows of the largest radius (CPU
    tensors take the plain versions)."""
    geom = geometry_for(h, w, pad_mode)
    radii = [r for r in radii if post_fused.kernel3_rows(r, geom.pad_w, w)]
    base = MagnifyConfig().tuned_for_tpu().replace(pad_mode=pad_mode)
    rows = blur_row_window(geom, base.replace(blur_size=_blur_size(
        max(radii))))
    hr, wk = rows[1] - rows[0], hermitian_kept_width(geom.pad_w)
    rng = np.random.default_rng(10)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    i_pl, q_pl = (dev_t(rng.uniform(-0.5, 0.5, (t, h, w))) for _ in range(2))
    u8 = torch.from_numpy(rng.integers(0, 256, (t, 3, h, w),
                                       dtype=np.uint8)).to(device)
    s = 0.3 * geom.pad_h * np.sqrt(geom.pad_w)
    rre, rim = (dev_t(s * rng.standard_normal((t, hr, wk)))
                for _ in range(2))
    win = hann2d_region(geom, device=device)
    post = (rows[0], h, w, pad_mode)
    out = {}
    for r in radii:
        c = base.replace(blur_size=_blur_size(r))
        assert post_fused._radius(c) == r
        for what, chroma, src, lay in (("f32", (i_pl, q_pl), None, "tuple3"),
                                       ("u8", (None, None), u8, "planar_u8")):
            out[f"radius {r}, {what}"] = (
                lambda c=c, chroma=chroma, src=src, lay=lay:
                post_fused.rowifft_post_fused(
                    rre, rim, *chroma, win, c, *post, full_w=geom.pad_w,
                    src=src, out_layout=lay, route=False),
                lambda c=c, chroma=chroma, src=src, lay=lay:
                post_fused.post_fused(
                    row_ifft_magnitude(rre, rim, pad_h=geom.pad_h,
                                       full_w=geom.pad_w),
                    *chroma, win, c, *post, lay, src=src))
    return out


def main(argv=None) -> int:
    import argparse

    from pbmm_tpu_torch.tools import require_card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = require_card("post_times")
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    res = {}
    for h, w, mode in SHAPES:
        pad_w = geometry_for(h, w, mode).pad_w
        for name, pair in route_calls(dev, h, w, mode).items():
            r = int(name.split()[1].rstrip(","))
            routed = ("kernel 3" if post_fused.kernel3_serves(r, pad_w, w)
                      else "kernels 7 + 10")
            times = [timed(fn, reps=args.reps, device=dev) for fn in pair]
            key = f"{pad_w} lanes, {h}x{w}, {name}"
            res[key] = times
            print(f"{key}: kernel 3 {times[0][0]:.4f} ms warm / "
                  f"{times[0][1]:.4f} cold, kernels 7 + 10 {times[1][0]:.4f}"
                  f" / {times[1][1]:.4f}; routed to {routed}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
