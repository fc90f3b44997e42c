"""Parity report: the port against the fp64 numpy oracle.

    python -m pbmm_tpu_torch.tools.parity [--size 128] [--frames 8] \
        [--configs all]

Prints one JSON line per configuration with PSNR/SSIM against the port's
copy of `oracle/reference.py` (the executable transcription of the
Unity/HLSL math), the cases of `pbmm_tpu/tools/parity.py`.  The BASELINE
contract is >= 35 dB (BASELINE.md).  `main()` runs on the first CUDA
card; `run_parity(..., device="cpu")` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json


def run_parity(size=128, frames=8, which="all", device=None):
    from pbmm_tpu_torch.config import MagnifyConfig
    from pbmm_tpu_torch.engine.video import magnify_video
    from pbmm_tpu_torch.oracle.reference import oracle_magnify_video
    from pbmm_tpu_torch.oracle.synthetic import oscillating_bar
    from pbmm_tpu_torch.utils.metrics import psnr, ssim

    clip = oscillating_bar(size=size, frames=frames, bar_width=2)
    cases = {
        "pyramid_defaults": MagnifyConfig(),
        "scene_params": MagnifyConfig.scene_defaults(),
        "standard": MagnifyConfig(mode="standard"),
        "standard_no_bandpass": MagnifyConfig(mode="standard",
                                              apply_bandpass=False),
        "full_fft": MagnifyConfig(use_rfft=False),
        "real_reconstruction": MagnifyConfig(reconstruct="real"),
        "high_scale": MagnifyConfig(phase_scale=25.0),
        "no_cache": MagnifyConfig(cache_prev_spectrum=False),
    }
    if which != "all":
        names = which.split(",")
        cases = {k: v for k, v in cases.items() if k in names}
    results = []
    for name, cfg in cases.items():
        out, _ = magnify_video(clip, cfg, device=device)
        want = oracle_magnify_video(clip, cfg)
        got = out.cpu().numpy()
        row = {
            "case": name,
            "psnr_db": round(psnr(got, want), 1),
            "ssim": round(ssim(got, want), 5),
            "pass_35db": bool(psnr(got, want) >= 35.0),
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv=None):
    from pbmm_tpu_torch.tools import require_card

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--configs", default="all")
    args = ap.parse_args(argv)
    dev = require_card("parity")
    results = run_parity(args.size, args.frames, args.configs, device=dev)
    return 0 if all(r["pass_35db"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
