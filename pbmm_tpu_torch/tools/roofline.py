"""Roofline accounting for the tuned 1080p hot path on an NVIDIA H100.

    python -m pbmm_tpu_torch.tools.roofline [--reps 20] [--json]

Counterpart of `benchmarks/roofline.py`: the same analytic per-stage
model of device-memory bytes and FLOPs per frame (`hot_path_stages`,
`hot_path_stages_u8`, on the port's geometry helpers; the f32 path's pre
stage and row FFT as one stage, the front end, and its tail reading the
frames' chroma, as the port runs them), against the H100
SXM's published peaks (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
cores: no stage uses the tensor cores, so the FLOP share is of the f32
peak), and, on the card, each stage's time by CUDA events
(`measure_stages`) with its achieved GB/s and its share of the memory
roofline.  `roofline_table` also sets each stage's bytes against the
row-tile copy ceiling that kernel 13 measures (`tools.kexp`, rows of a
16-frame stack, cold): the rate a pure copy in the port's row pattern
reaches on this card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

H100_HBM_GBPS = 3350.0
H100_F32_TFLOPS = 67.0

_F = 4  # f32 bytes
_T_AMORT = 16  # the chunk over which the carried state is amortised


def _geometry(h, w, cfg):
    from pbmm_tpu_torch.core.window import blur_taps, geometry_for
    from pbmm_tpu_torch.engine.pipeline import (
        blur_row_window,
        hermitian_active,
    )
    from pbmm_tpu_torch.spectral.fused import aligned_row_window
    from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

    geom = geometry_for(h, w, cfg.pad_mode)
    hp, wp = geom.pad_h, geom.pad_w
    wk = hermitian_kept_width(wp) if hermitian_active(cfg, geom) else wp
    r0, r1 = aligned_row_window(geom.y0, geom.y0 + geom.in_h, hp)
    b0, b1 = blur_row_window(geom, cfg)
    taps = len(blur_taps(cfg.blur_size))
    return hp, wp, wk, r1 - r0, b1 - b0, taps


def hot_path_stages(h: int = 1080, w: int = 1920, cfg=None):
    """[(name, bytes in, bytes out, flops)] for one frame through the
    tuned fused path as the port runs it (f32 interleaved frames in and
    out): the front end (the Y plane, the pad and the Hann window formed
    in the row FFT's loads, `fused.windowed_row_fft_frames`), kernel 2,
    and kernel 3 taking the chroma from the frames and writing the
    interleaved output.  The JAX model's arithmetic (`roofline.py:39-109`)
    for each stage, its pre stage and row FFT merged as the front end
    merges them: bytes exact (each stage reads its operands once and
    writes its outputs once; constants ignored), FLOPs the classical
    5 N log2 N per complex FFT plus per-element counts."""
    from pbmm_tpu_torch.config import MagnifyConfig

    cfg = cfg or MagnifyConfig().tuned_for_tpu()
    hp, wp, wk, hc, hr, taps = _geometry(h, w, cfg)
    lg_w, lg_h = math.log2(wp), math.log2(hp)
    return [
        ("front end: rgb->Y + pad + Hann + row-FFT", h * w * 3 * _F,
         2 * hc * wk * _F, int(hc * 5 * wp * lg_w + 2 * hc * wp) + 5 * h * w),
        ("colspec: col-FFT + phase + col-IFFT (r5)",
         2 * hc * wk * _F + (4 * hp * wk * _F) // _T_AMORT,
         2 * hr * wk * _F + (4 * hp * wk * _F) // _T_AMORT,
         int(2 * wk * 5 * hp * lg_h + hp * wk * 80)),
        ("row-IFFT + post (merged, frames' chroma)",
         (2 * hr * wk + 3 * h * w) * _F, 3 * h * w * _F,
         int(hr * 5 * wp * lg_w + 4 * hr * wp) + (4 * taps + 9 + 10) * h * w),
    ]


def hot_path_stages_u8(h: int = 1080, w: int = 1920, cfg=None):
    """The same for the u8 planar pipeline (planar uint8 in, planar u8
    out, tight geometry; `roofline.py:112-162`): kernel 4, kernel 2,
    kernel 3 with the u8 chroma."""
    from pbmm_tpu_torch.config import MagnifyConfig

    cfg = cfg or MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight")
    hp, wp, wk, hc, hr, taps = _geometry(h, w, cfg)
    lg_w, lg_h = math.log2(wp), math.log2(hp)
    u8_in = 3 * h * w
    return [
        ("k1 u8-ingest + row-FFT (Hann fused)", 2 * u8_in, 2 * hc * wk * _F,
         int(hc * 5 * wp * lg_w + 8 * h * w)),
        ("colspec: col-FFT + phase + col-IFFT",
         2 * hc * wk * _F + (4 * hp * wk * _F) // _T_AMORT,
         2 * hr * wk * _F + (4 * hp * wk * _F) // _T_AMORT,
         int(2 * wk * 5 * hp * lg_h + hp * wk * 80)),
        ("row-IFFT + post (u8 chroma, u8 out)", 2 * hr * wk * _F + u8_in,
         3 * h * w,
         int(hr * 5 * wp * lg_w + 4 * hr * wp) + (4 * taps + 9 + 10) * h * w),
    ]


def measure_stages(h: int = 1080, w: int = 1920, cfg=None, reps: int = 20,
                   device=None):
    """Each stage of `hot_path_stages` run on the card at its shapes and
    timed by CUDA events (median of `reps`, warm): the front end on one
    f32 interleaved frame, kernel 2 on a 16-frame chunk divided by 16,
    kernel 3 on one frame (chroma from the frame, interleaved out).
    Returns [(name, seconds per frame)]."""
    from pbmm_tpu_torch.config import MagnifyConfig
    from pbmm_tpu_torch.core.color import RGB_TO_YIQ
    from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
    from pbmm_tpu_torch.engine.pipeline import (
        blur_row_window,
        hermitian_active,
    )
    from pbmm_tpu_torch.engine.post_fused import rowifft_post_fused
    from pbmm_tpu_torch.spectral.fused import (
        aligned_row_window,
        col_fft_zero_padded,
        colspec_chunk,
        windowed_row_fft_frames,
    )
    from pbmm_tpu_torch.tools.kexp import timed

    cfg = cfg or MagnifyConfig().tuned_for_tpu()
    dev = device if device is not None else torch.device("cuda", 0)
    geom = geometry_for(h, w, cfg.pad_mode)
    hp, wp = geom.pad_h, geom.pad_w
    keep = hermitian_active(cfg, geom)
    r0, _ = aligned_row_window(geom.y0, geom.y0 + geom.in_h, hp)
    rows = blur_row_window(geom, cfg)
    frame = torch.from_numpy(np.random.default_rng(0).random(
        (1, h, w, 3)).astype(np.float32)).to(dev)
    luma = (tuple(float(c) for c in RGB_TO_YIQ[0]),)

    def front(fr):
        return windowed_row_fft_frames(fr, luma, hp, wp, geom.y0, geom.x0,
                                       r0, keep_half=keep)

    re1, im1 = front(frame)
    t = _T_AMORT
    stream_re = torch.cat([re1 + 0.1 * k for k in range(t)])
    stream_im = torch.cat([im1 + 0.1 * k for k in range(t)])
    if hp & (hp - 1) == 0:
        prev = col_fft_zero_padded(re1, im1, pad_h=hp, row0=r0)
    else:
        prev = (torch.zeros((1, hp, re1.shape[-1]), device=dev),) * 2
    pre_, pim = prev[0] + 1.0, prev[1] + 1.0
    rre, rim = colspec_chunk(stream_re[:1], stream_im[:1], pre_, pim, cfg,
                             hp, r0, out_rows=rows, full_w=wp)[:2]
    win = hann2d_region(geom, device=dev)
    stages = [
        (front, (frame,), 1),
        (lambda a, b: colspec_chunk(a, b, pre_, pim, cfg, hp, r0,
                                    out_rows=rows, full_w=wp),
         (stream_re, stream_im), t),
        (lambda a, b: rowifft_post_fused(a, b, None, None, win, cfg,
                                         rows[0], h, w, cfg.pad_mode,
                                         full_w=wp, src=frame,
                                         out_layout="interleaved"),
         (rre, rim), 1),
    ]
    names = [s[0] for s in hot_path_stages(h, w, cfg)]
    return [(name, timed(fn, args, reps=reps)[0] / 1e3 / n)
            for name, (fn, args, n) in zip(names, stages)]


def roofline_table(h: int = 1080, w: int = 1920, cfg=None, reps: int = 20,
                   measured=None, copy_gbps=None):
    """-> (rows, summary).  rows: per stage, the analytic bytes and
    GFLOP, the roofline ms at 3.35 TB/s, the measured ms (`measured`, or
    `measure_stages` on the card), achieved GB/s, % of the memory
    roofline, % of the f32 FLOP peak, and, given `copy_gbps` (kernel 13's
    row-tile copy ceiling), the ms a copy at that rate would take and the
    stage's share of it."""
    stages = hot_path_stages(h, w, cfg)
    if measured is None:
        measured = measure_stages(h, w, cfg, reps)
    rows = []
    for (name, bi, bo, fl), (_, sec) in zip(stages, measured):
        bts = bi + bo
        roof_ms = bts / (H100_HBM_GBPS * 1e9) * 1e3
        ms = sec * 1e3
        row = {
            "stage": name,
            "hbm_mb": round(bts / 1e6, 1),
            "gflop": round(fl / 1e9, 2),
            "roofline_ms": round(roof_ms, 4),
            "measured_ms": round(ms, 4),
            "achieved_gbps": round(bts / sec / 1e9, 0),
            "pct_of_roofline": round(100.0 * roof_ms / ms, 1),
            "pct_of_f32_peak": round(
                100.0 * fl / sec / (H100_F32_TFLOPS * 1e12), 2),
        }
        if copy_gbps:
            ceil_ms = bts / (copy_gbps * 1e9) * 1e3
            row["copy_ceiling_ms"] = round(ceil_ms, 4)
            row["pct_of_copy_ceiling"] = round(100.0 * ceil_ms / ms, 1)
        rows.append(row)
    tot_bytes = sum(bi + bo for _, bi, bo, _ in stages)
    tot_flops = sum(fl for *_, fl in stages)
    tot_ms = sum(r["measured_ms"] for r in rows)
    roof = tot_bytes / (H100_HBM_GBPS * 1e9) * 1e3
    bottleneck = max(rows, key=lambda r: r["measured_ms"])
    summary = {
        "total_hbm_mb_per_frame": round(tot_bytes / 1e6, 1),
        "total_gflop_per_frame": round(tot_flops / 1e9, 2),
        "hbm_roofline_ms_per_frame": round(roof, 4),
        "measured_ms_per_frame_sum": round(tot_ms, 4),
        "pct_of_hbm_roofline": round(100.0 * roof / tot_ms, 1),
        "pct_of_f32_peak": round(
            100.0 * tot_flops / (tot_ms / 1e3) / (H100_F32_TFLOPS * 1e12), 2),
        "copy_ceiling_gbps": copy_gbps,
        "bottleneck_stage": bottleneck["stage"],
        "bottleneck_ms": bottleneck["measured_ms"],
        "bottleneck_pct_of_roofline": bottleneck["pct_of_roofline"],
    }
    return rows, summary


def print_table(rows, summary, file=sys.stderr):
    ceil = summary.get("copy_ceiling_gbps")
    hdr = (f"{'stage':42s} {'MB':>6s} {'GFLOP':>6s} {'roof ms':>8s} "
           f"{'meas ms':>8s} {'GB/s':>6s} {'%roof':>6s} {'%f32':>5s}")
    if ceil:
        hdr += f" {'copy ms':>8s} {'%copy':>6s}"
    print(hdr, file=file)
    for r in rows:
        line = (f"{r['stage']:42s} {r['hbm_mb']:6.1f} {r['gflop']:6.2f} "
                f"{r['roofline_ms']:8.4f} {r['measured_ms']:8.4f} "
                f"{r['achieved_gbps']:6.0f} {r['pct_of_roofline']:6.1f} "
                f"{r['pct_of_f32_peak']:5.2f}")
        if ceil:
            line += (f" {r['copy_ceiling_ms']:8.4f} "
                     f"{r['pct_of_copy_ceiling']:6.1f}")
        print(line, file=file)
    print(f"TOTAL {summary['total_hbm_mb_per_frame']} MB/frame, "
          f"{summary['total_gflop_per_frame']} GFLOP/frame; roofline "
          f"{summary['hbm_roofline_ms_per_frame']} ms at 3.35 TB/s vs "
          f"measured {summary['measured_ms_per_frame_sum']} ms "
          f"({summary['pct_of_hbm_roofline']}% of the roofline, "
          f"{summary['pct_of_f32_peak']}% of the f32 peak); row-tile copy "
          f"ceiling {ceil if ceil else 'not measured'} GB/s; bottleneck: "
          f"{summary['bottleneck_stage']} ({summary['bottleneck_ms']} ms, "
          f"{summary['bottleneck_pct_of_roofline']}% of its roofline)",
          file=file)


def _four_step_flops(lead: int, n: int, real_in: bool, out_rows: int = 0,
                     imag: bool = True) -> int:
    """f32 operations of `mxu_fft._four_step_last` on `lead` rows of n
    points: each (M, K) @ (K, N) product 2 M K N, each elementwise sum,
    difference and twiddle product one."""
    n1 = min(128, n)
    n2 = n // n1
    rows = lead * n2  # step 2's rows (..., n2, n1)
    if real_in:
        step2 = 2 * (2 * rows * n1 * n1)
    else:
        step2 = 4 * (2 * rows * n1 * n1) + 2 * rows * n1
    step3 = 6 * lead * n
    out = lead * (out_rows or n2) * n1  # step 4's outputs a part
    parts = 2 if imag else 1
    step4 = parts * (2 * (2 * out * n2) + out)
    return step2 + step3 + step4


def mxu_transform_work(shape, inverse: bool = False):
    """(bytes, f32 operations) of `rfft2_mxu` on real (..., H, W) f32
    frames, or with `inverse` of `irfft2_mxu` back to them, counted from
    `spectral/mxu_fft.py`'s products and elementwise steps (the Hermitian
    extension's negation included).  Bytes: the input read once and the
    output written once; the reshapes and transposes between the
    products move more, which the bound leaves out."""
    b = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    h, w = shape[-2:]
    k = w // 2 + 1
    nbytes = b * h * w * _F + b * h * k * 2 * _F
    cols = _four_step_flops(b * k, h, real_in=False)
    if inverse:
        rows = _four_step_flops(b * h, w, real_in=False, imag=False)
        ops = cols + rows + b * h * (w - k)
    else:
        n2 = w // min(128, w)
        ops = _four_step_flops(b * h, w, real_in=True,
                               out_rows=n2 // 2 + 1) + cols
    return nbytes, ops


def row_copy_ceiling(device, reps: int = 10) -> float:
    """GB/s of kernel 13 copying two (16, 1152, 2048) planes by rows, one
    row a block, cold: the ceiling of the port's row pattern."""
    from pbmm_tpu_torch.tools.kexp import copy_gbps, experiments, timed

    fn, args = experiments(device, {"copy_rowblocks"}, row_block=1,
                           frames=16)["copy_rowblocks"]
    return copy_gbps(2 * 2 * args[0].numel() * 4,
                     timed(fn, args, reps=reps)[1])


def main(argv=None) -> int:
    from pbmm_tpu_torch.tools import require_card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    dev = require_card("roofline")
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    rows, summary = roofline_table(args.height, args.width, reps=args.reps,
                                   copy_gbps=row_copy_ceiling(dev))
    if args.json:
        print(json.dumps({"stages": rows, "summary": summary}))
    else:
        print_table(rows, summary, file=sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
