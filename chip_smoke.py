#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its lines; any failure raises, so the script exits
non-zero without the final line:

  0. device: the card's name and power limit (exits without a CUDA card);
  1. build: nvcc compiles the kernels of pbmm_tpu_torch/csrc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, from inputs made with numpy from a seed
     (spectra: max error / max magnitude < 1e-4; images: max abs < 1e-4;
     uint8 images: 1 code): kernels 1-3 at 1080p, kernel 4 on (16, 3,
     1080, 1920) uint8 frames (also bit for bit against the pre stage +
     kernel 1), kernel 3's u8-chroma / planar_u8 and f32 / planar
     variants, kernel 7 at the 1080p and 960x540 region shapes; and the
     config matrix's: kernel 5 at 1080p square_pow2, kernel 11 at 1080p
     rgb, kernel 2's branches (pow-2, 3 planes with the IIR taps,
     standard mode at 2.5 on 720p rect_pow2, steerable overlapping bands,
     a non-integer pyramid scale), kernel 7's Re z and kernel 3's real /
     compensate / gains variant; and the scan engine's and the unfused
     backends': kernel 6 (two-frame, IIR taps at 720p rect_pow2,
     standard, steerable over overlapping bands, full lanes; also bit
     for bit against kernel 2's output rows on the spectra kernel 5
     gives), kernel 8 (forward real, forward complex and inverse with a
     scale, on both axes), kernel 9 ("centered" and "bitrev2d" layouts,
     integer and 2.5 scale, steerable) and kernel 10 (which no entry
     point reaches: it is held here only), at 1080p shapes; and the
     measurement path's: kernel 12 (kdecomp, all six piece sets at H =
     2048, its full variant bit for bit against kernel 6 on kdecomp's
     planes and on the bar's spectra), kernel 13 (the copy probe, rows of
     1 and 64, strips of 4, 8 and 32 columns, bit for bit) and kernel 14
     (the trig probe: every op code against its plain version and fp64,
     with the JAX probe's tolerances, signed and exact zeros included);
  3. end to end, each path run as two chunks with the state threaded,
     every launch count set to 0 just before the path and read just
     after (each of its kernels must have launched, and kernel 1 must not
     on the u8 path):
     - f32 1080p, the bench clip (chunks of 16, shifted noise): outputs
       finite in [0, 1], chunks of 8 + 8 equal one chunk of 16 bit for
       bit, frames 0-3 > 100 dB PSNR against the fp64 numpy oracle;
     - u8 1080p: planar uint8 in, planar and planar_u8 out (kernels 4,
       2, 3): 8 + 8 equals 16 bit for bit, planar_u8 equals
       round(255 planar), planar frames 0-3 > 100 dB against the oracle;
     - 540p: 960x540 interleaved f32 and planar uint8 in, the two-kernel
       tail (kernels 1, 2, 7): > 100 dB against the oracle;
     - stream: a 32-frame 1080p 420jpeg y4m through `stream_magnify`
       with ingest="u8" (kernels 4, 2, 3), equal to `magnify_video` on
       the device-decoded chunks;
     - (a) 1080p square_pow2 (the CLI's `--fast` default), interleaved
       f32, the bench clip: kernels 5, 1, 2, 3; the state kernel 5 gives
       frame 0 equals bit for bit the one kernel 2 carries out of a
       zero-prev start (planar frames), and so do both streams after 16;
     - (b) 1080p tight, chroma="rgb", IIR, planar uint8 in and planar_u8
       out (a 1080p oscillating bar): kernels 1, 2, 7, 11;
     - (c) 1280x720 rect_pow2 (1024x2048), mode="standard",
       phase_scale=2.5 (a 720p oscillating bar): kernels 5, 1, 2, 3;
     - (d) 1080p tight, orientations=4, pyramid_levels=6 (overlapping
       bands), reconstruct="real", compensate_window, YIQ gains (1.0,
       1.2, 0.8), the bench clip: kernels 1, 2, 3 (no oracle covers it);
     - (e) the default `MagnifyConfig()` (the CLI without --fast):
       torch.fft and the scan engine, no kernel, a 1080p oscillating bar;
     - (f) `tuned_for_tpu()` with engine="scan", 1080p square_pow2, the
       bar: kernels 1, 5, 6, 7 and the torch posttail; and its
       cache_prev_spectrum=False + IIR variant at 720p rect_pow2 (kernel
       6 with the taps);
     - (g) fft_backend="pallas", use_rfft=False, use_pallas=True, 1080p,
       the bar: kernels 1, 5, 9, 8;
     - (h) `magnify_frame_pair` on (f)'s config: kernels 1, 5, 6, 7, each
       pair equal bit for bit to (f)'s frame;
     - (i) the measurement path, through the tools: `roofline_table` at
       1080p (kernels 1, 2, 3 and the row-tile copy ceiling), kexp's
       experiments (kernels 1, 5, 6, 7 and both copies at kexp's shape
       and on a 16-frame stack), kdecomp's six variants, the trig probe,
       and the CLI's `--demo bar --fast --trace DIR --stats` (the trace
       must name kernel 1) and `--debug-view split`: kernels 12, 13, 14;
     each finite in [0, 1], 8 + 8 equal to 16 bit for bit, (a)-(c) and
       (e)-(h) > 100 dB against the oracle on frames 0-3 (the oracle runs
       on host threads while the card works);
  4. timing with CUDA events after warm-up (medians): steady-state chunk
     frames/s of each path (pairs/s for (h)), each kernel and each
     variant or branch beside its plain version and, for the FFT kernels,
     one `torch.fft` call on the same shape and axis (the copy probe:
     one `Tensor.copy_`; the trig probe's atan2: `torch.atan2`), and the
     y4m stream's frames/s with the host's parse share.  Kernels, plain
     versions and library calls are timed by the device's time alone
     (`tools.kexp.timed`: a spin of the card ahead of each event pair
     covers the host's enqueue), each kernel warm (relaunched on the same
     inputs) and cold (a 128 MB write before each launch, outside the
     timing: its inputs out of L2), and also, as before, with the host's
     enqueue inside one event pair around one call (`ms_enqueued`);
  5. with --profile only: torch.profiler over a few steady-state chunks
     of the f32 1080p, u8 1080p, 540p paths and paths (a)-(g), printing
     where the device time of a chunk goes (each kernel's share) and the
     device's idle share with the profiler on.

The line before the last but one is one JSON object with the kernels'
records: each kernel's launches on the path named beside it, its max abs
error against its plain version, the kernel's, the plain version's and
the library call's times, and its bound: the larger of the bytes it must
move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100
SXM's published peaks), counted from this run's shapes.  Then the
card's name and power limit; the last line is {"ok": true, "device":
{...}}.  The script imports neither jax nor the JAX package: the oracle
and the synthetic clips are the port's numpy copies.
"""

import argparse
from concurrent.futures import ThreadPoolExecutor
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H, W, T = 1080, 1920, 16
H540, W540 = 540, 960  # a frame size outside post_pallas_ok
H720, W720 = 720, 1280  # rect_pow2 pads it to 1024 x 2048
SPEC_TOL = 1e-4  # max error / max magnitude, spectra
IMG_TOL = 1e-4  # max abs error, images in [0, 1]


def log(*a):
    print(*a, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spec_err(got, want):
    """(max abs error, max error / max magnitude) of complex pairs."""
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    den = max(float(w.abs().max()) for w in want)
    return num, num / den


def psnr_db(got, want):
    mse = float(np.mean((np.asarray(got, np.float64) - want) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def profile_chunks(torch, chunk, card, what, n=5, top=12):
    """Phase 5: device time per chunk by kernel, and the idle share, from
    torch.profiler over `n` chunks (wall time from CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            chunk()
        b.record()
        b.synchronize()
    wall_ms = a.elapsed_time(b) / n

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return float(v if v is not None else e.self_cuda_time_total)

    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log(f"[5] {what}: torch.profiler recorded no device time: shares "
            "not measured")
        return
    log(f"[5] {card}: {what}, per chunk of {T} frames, mean of {n}: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{100 * (1 - busy_ms / wall_ms):.1f} % (profiler on)")
    for e in kernels[:top]:
        ms = dev_us(e) / 1e3 / n
        log(f"[5]   {100 * ms / busy_ms:5.1f} %  {ms:.3f} ms  "
            f"{e.count / n:g} launches  {e.key[:100]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 5, the per-kernel device-time "
                             "breakdown of a steady-state chunk")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    sys.path.insert(0, str(ROOT))
    import pbmm_tpu_torch
    from pbmm_tpu_torch import TemporalConfig
    from pbmm_tpu_torch.core.color import RGB_TO_YIQ
    from pbmm_tpu_torch.core.complexop import split
    from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
    from pbmm_tpu_torch.engine import post_fused
    from pbmm_tpu_torch.engine.pipeline import (
        blur_row_window,
        magnify_frame_pair,
        preprocess,
        preprocess_cl,
    )
    from pbmm_tpu_torch.io import stream, y4m
    from pbmm_tpu_torch.io.device_decode import ycbcr_planes_to_rgb_planar_u8
    from pbmm_tpu_torch.kernels.build import build, library
    from pbmm_tpu_torch.oracle import reference as oracle
    from pbmm_tpu_torch.oracle import synthetic
    from pbmm_tpu_torch.phase import fused_kernels
    from pbmm_tpu_torch.pyramid.filters import freq_axes
    from pbmm_tpu_torch.spectral import fused, radix2
    from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width
    from pbmm_tpu_torch import cli as port_cli
    from pbmm_tpu_torch.tools import kdecomp, kexp, roofline, trig_probe
    from pbmm_tpu_torch.utils.debug import debug_frame_view

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 0. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[0] device: {kind}; nvidia-smi name, power limit: {card}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build(verbose=True)
    library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # -- 2. kernels vs plain versions at their paths' shapes ---------------
    cfg = pbmm_tpu_torch.MagnifyConfig().tuned_for_tpu().replace(
        pad_mode="tight")
    geom = geometry_for(H, W, "tight")
    rows = blur_row_window(geom, cfg)
    wk = hermitian_kept_width(geom.pad_w)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(1234)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def dev_u8(shape):
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    y = dev_t(rng.random((T, geom.pad_h, geom.pad_w)))
    rows_re = dev_t(rng.standard_normal((T, geom.pad_h, wk)))
    rows_im = dev_t(rng.standard_normal((T, geom.pad_h, wk)))
    prev_re = dev_t(rng.standard_normal((1, geom.pad_h, wk)))
    prev_im = dev_t(rng.standard_normal((1, geom.pad_h, wk)))
    scale = 0.3 * geom.pad_h * geom.pad_w / np.sqrt(geom.pad_w)
    rre = dev_t(scale * rng.standard_normal((T, hr, wk)))
    rim = dev_t(scale * rng.standard_normal((T, hr, wk)))
    i_pl = dev_t(rng.uniform(-0.6, 0.6, (T, H, W)))
    q_pl = dev_t(rng.uniform(-0.5, 0.5, (T, H, W)))
    win = hann2d_region(geom, device=dev)
    u8_frames = dev_u8((T, 3, H, W))
    luma = tuple(float(c) for c in RGB_TO_YIQ[0])
    r0, _ = fused.aligned_row_window(geom.y0, geom.y0 + H, geom.pad_h)
    u8_args = (u8_frames, luma, geom.pad_h, geom.pad_w, geom.y0, geom.x0,
               r0, True)
    g540 = geometry_for(H540, W540, "tight")
    rows540 = blur_row_window(g540, cfg)
    hr540, wk540 = rows540[1] - rows540[0], hermitian_kept_width(g540.pad_w)
    s540 = 0.3 * g540.pad_h * g540.pad_w / np.sqrt(g540.pad_w)
    rre540 = dev_t(s540 * rng.standard_normal((T, hr540, wk540)))
    rim540 = dev_t(s540 * rng.standard_normal((T, hr540, wk540)))
    post_args = (rre, rim, i_pl, q_pl, win, cfg, rows[0], H, W, "tight")
    post_u8_args = (rre, rim, None, None, win, cfg, rows[0], H, W, "tight")

    # The config matrix's paths (a)-(d) and their shapes.
    cfg_sq = cfg.replace(pad_mode="square_pow2")
    cfg_rgb = cfg.replace(chroma="rgb", output_layout="planar_u8",
                          temporal=TemporalConfig(mode="iir_bandpass"))
    cfg_std = cfg.replace(pad_mode="rect_pow2", mode="standard",
                          phase_scale=2.5)
    cfg_str = cfg.replace(orientations=4, pyramid_levels=6,
                          reconstruct="real", compensate_window=True,
                          apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8))
    g_sq = geometry_for(H, W, "square_pow2")
    r0_sq, r1_sq = fused.aligned_row_window(g_sq.y0, g_sq.y0 + H, g_sq.pad_h)
    rows_sq = blur_row_window(g_sq, cfg_sq)
    hr_sq = rows_sq[1] - rows_sq[0]
    sq_re, sq_im = (dev_t(rng.standard_normal((T, r1_sq - r0_sq, wk)))
                    for _ in range(2))
    sq_prev = [dev_t(rng.standard_normal((1, g_sq.pad_h, wk)))
               for _ in range(2)]
    g720 = geometry_for(H720, W720, "rect_pow2")
    r0_720, r1_720 = fused.aligned_row_window(g720.y0, g720.y0 + H720,
                                              g720.pad_h)
    rows720 = blur_row_window(g720, cfg_std)
    # The branches that rotate by atan2 (IIR, standard, a non-integer
    # scale) take row spectra of an oscillating bar, the motion the method
    # targets: on random spectra some bins sit at atan2's branch cut
    # (Re < 0, Im ~ 0), where two FFTs that differ in the last bit pick
    # opposite sides and the rotation differs by 2 pi s.  Paths (b) and (c)
    # run the same clips, for the same reason against the fp64 oracle.
    bar_u8 = np.ascontiguousarray(np.moveaxis(np.round(
        synthetic.oscillating_bar(size=W, frames=T, bar_width=2)[:, :H]
        * 255.0).astype(np.uint8), -1, 1))
    bar720 = np.ascontiguousarray(synthetic.oscillating_bar(
        size=W720, frames=T, bar_width=2)[:, :H720])
    bar_f01 = np.moveaxis(bar_u8, 1, -1) / 255.0
    bar_d = torch.from_numpy(bar_u8).to(dev)
    bar720_d = torch.from_numpy(bar720).to(dev)
    rgb_rows = preprocess_cl(bar_d, cfg_rgb)[:2]
    rgb_state = [torch.zeros((3, geom.pad_h, wk), device=dev)
                 for _ in range(4)]
    std_re, std_im = preprocess_cl(bar720_d, cfg_std)[:2]
    std_prev = [torch.zeros((1, g720.pad_h, wk), device=dev)
                for _ in range(2)]
    bar_rows = preprocess_cl(dev_t(bar_f01), cfg)[:2]
    rec3 = dev_t(rng.uniform(-0.2, 0.9, (3 * T, hr, geom.pad_w)))
    rre3, rim3 = (dev_t(scale * rng.standard_normal((3 * T, hr, wk)))
                  for _ in range(2))
    rgb_post_args = (rec3, win, cfg_rgb, rows[0], H, W, "tight")
    quirk_post_args = (rre, rim, i_pl, q_pl, win, cfg_str, rows[0], H, W,
                       "tight")

    # The scan engine's and the unfused backends' configs and kernel
    # inputs (kernels 6, 8, 9, 10), at the shapes paths (f)-(h) give them:
    # whole spectra of two 1080p bar frames from kernels 1 and 5.
    cfg_e = pbmm_tpu_torch.MagnifyConfig()
    cfg_f = cfg_sq.replace(engine="scan")
    cfg_fi = cfg.replace(pad_mode="rect_pow2", cache_prev_spectrum=False,
                         temporal=TemporalConfig(mode="iir_bandpass"))
    cfg_g = pbmm_tpu_torch.MagnifyConfig(fft_backend="pallas",
                                         use_rfft=False, use_pallas=True)
    bar_il_d = dev_t(bar_f01)  # (T, 1080, 1920, 3) f32, interleaved

    def spectra(frame, c):
        return split(preprocess(frame, c)[0])

    k6_cur, k6_prev = (spectra(bar_il_d[i], cfg_f) for i in (1, 0))
    k6i_cur, k6i_prev = (spectra(bar720_d[i], cfg_fi) for i in (1, 0))
    k6i_taps = [0.1 * dev_t(rng.standard_normal(tuple(k6i_cur[0].shape)))
                for _ in range(2)]
    cfg_full = cfg_sq.replace(use_hermitian_spectral=False)
    k6f_cur, k6f_prev = (spectra(bar_il_d[i], cfg_full) for i in (1, 0))
    k6_kw = dict(out_rows=rows_sq, full_w=g_sq.pad_w)
    k8_re, k8_im = (dev_t(rng.standard_normal((1, g_sq.pad_h, g_sq.pad_w)))
                    for _ in range(2))
    k9_cur, k9_prev = (spectra(bar_il_d[i], cfg_g) for i in (1, 0))
    k9c_cur, k9c_prev = (spectra(bar_il_d[i], cfg_e.replace(use_rfft=False))
                         for i in (1, 0))
    fyb, fxb = freq_axes(g_sq.pad_h, g_sq.pad_w, "bitrev2d", dev)
    fyc, fxc = freq_axes(g_sq.pad_h, g_sq.pad_w, "centered", dev)
    axes_b = (fyb[:, 0].contiguous(), fxb[0].contiguous())
    axes_c = (fyc[:, 0].contiguous(), fxc[0].contiguous())

    def k9_args(c):
        return (c.pyramid_levels, c.min_frequency, c.max_frequency,
                c.phase_scale, c.magnitude_threshold, c.orientations)

    rec1 = rec3[0::3].contiguous()  # (T, Hr, W) Y rows for kernel 10
    yonly_post_args = (rec1, i_pl, q_pl, win, cfg, rows[0], H, W, "tight")

    def both(fn, *a, **k):
        """(kernel call, plain-version call) of one wrapper."""
        ref = next(getattr(m, fn.__name__ + "_ref") for m in (
            fused, post_fused, radix2, fused_kernels, kdecomp, kexp,
            trig_probe) if hasattr(m, fn.__name__ + "_ref"))
        return (lambda: fn(*a, **k)), (lambda: ref(*a, **k))

    # The measurement path's kernels (12-14) at the tools' shapes:
    # kdecomp's four (1, 2048, 1152) planes and rows, kexp's copy planes
    # (1, 1152, 2048) and a 16-frame stack, the trig probe's planes.
    cfg_t = pbmm_tpu_torch.MagnifyConfig().tuned_for_tpu()
    kd_rows, kd_fw = (384, 1600), g_sq.pad_w
    kd = kdecomp.kdecomp_inputs(dev)
    rng_m = np.random.default_rng(5)
    cp1, cp16 = ([torch.from_numpy(rng_m.random(kexp.copy_shape(n),
                                                np.float32)).to(dev)
                  for _ in range(2)] for n in (1, 16))
    tp_in = [torch.from_numpy(a).to(dev)
             for a in trig_probe.probe_inputs(0)["atan2"].values()]

    calls = {
        "windowed_row_fft": both(fused.windowed_row_fft, y, geom.pad_h, 0,
                                 True),
        "colspec_chunk": both(fused.colspec_chunk, rows_re, rows_im, prev_re,
                              prev_im, cfg, geom.pad_h, 0, out_rows=rows,
                              full_w=geom.pad_w),
        "rowifft_post_fused": both(post_fused.rowifft_post_fused, *post_args,
                                   full_w=geom.pad_w),
        "windowed_row_fft_u8planar": both(fused.windowed_row_fft_u8planar,
                                          *u8_args),
        "row_ifft_magnitude": both(fused.row_ifft_magnitude, rre, rim,
                                   pad_h=geom.pad_h, full_w=geom.pad_w),
        "col_fft_zero_padded": both(fused.col_fft_zero_padded, sq_re[:1],
                                    sq_im[:1], g_sq.pad_h, r0_sq),
        "post_fused_rgb": both(post_fused.post_fused_rgb, *rgb_post_args,
                               out_layout="planar_u8"),
        "phase_col_ifft": both(fused.phase_col_ifft, *k6_cur, *k6_prev,
                               cfg_f, **k6_kw),
        "_fft_axis": both(radix2._fft_axis, k8_re, k8_im, 1, True, 1.0),
        "amplify_procedural": both(fused_kernels.amplify_procedural,
                                   *k9_cur, *k9_prev, *axes_b,
                                   *k9_args(cfg_g)),
        "post_fused": both(post_fused.post_fused, *yonly_post_args),
        "kdecomp_variant": both(kdecomp.kdecomp_variant, *kd, cfg_t,
                                kdecomp.VARIANTS[-1][1], kd_rows,
                                full_w=kd_fw),
        "copy_probe": both(kexp.copy_probe, *cp1, "rows", 1),
        "trig_probe": both(trig_probe.trig_probe, "atan2", *tp_in),
    }
    variants = {  # kernel 3's new variants and kernel 7 at 540p shapes
        "rowifft_post_fused[u8, planar_u8]": both(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            rgb_u8=u8_frames, out_layout="planar_u8"),
        "rowifft_post_fused[f32, planar]": both(
            post_fused.rowifft_post_fused, *post_args, full_w=geom.pad_w,
            out_layout="planar"),
        "row_ifft_magnitude[540p]": both(
            fused.row_ifft_magnitude, rre540, rim540, pad_h=g540.pad_h,
            full_w=g540.pad_w),
        # The config matrix's branches, at their paths' shapes.
        "colspec_chunk[pow-2, square_pow2 1080p]": both(
            fused.colspec_chunk, sq_re, sq_im, *sq_prev, cfg_sq, g_sq.pad_h,
            r0_sq, out_rows=rows_sq, full_w=g_sq.pad_w),
        "colspec_chunk[rgb 3 planes, IIR]": both(
            fused.colspec_chunk, *rgb_rows, *rgb_state[:2], cfg_rgb,
            geom.pad_h, 0, *rgb_state[2:], out_rows=rows, full_w=geom.pad_w,
            planes=3),
        "colspec_chunk[standard, 2.5, rect_pow2 720p]": both(
            fused.colspec_chunk, std_re, std_im, *std_prev, cfg_std,
            g720.pad_h, r0_720, out_rows=rows720, full_w=g720.pad_w),
        "colspec_chunk[steerable 4, overlapping bands]": both(
            fused.colspec_chunk, rows_re, rows_im, prev_re, prev_im, cfg_str,
            geom.pad_h, 0, out_rows=rows, full_w=geom.pad_w),
        "colspec_chunk[pyramid, 2.5]": both(
            fused.colspec_chunk, *bar_rows, rgb_state[0][:1],
            rgb_state[1][:1],
            cfg.replace(phase_scale=2.5), geom.pad_h, 0, out_rows=rows,
            full_w=geom.pad_w),
        "row_ifft_magnitude[Re z, 1080p rgb]": both(
            fused.row_ifft_magnitude, rre3, rim3, magnitude=False,
            pad_h=geom.pad_h, full_w=geom.pad_w),
        "rowifft_post_fused[real, compensate, gains]": both(
            post_fused.rowifft_post_fused, *quirk_post_args,
            full_w=geom.pad_w),
        "post_fused_rgb[tuple3, compensate, gains]": both(
            post_fused.post_fused_rgb, rec3, win, cfg_str.replace(
                chroma="rgb"), rows[0], H, W, "tight"),
        # The scan engine's and the unfused backends' branches.
        "phase_col_ifft[IIR taps, 720p rect_pow2]": both(
            fused.phase_col_ifft, *k6i_cur, *k6i_prev, cfg_fi,
            out_rows=blur_row_window(g720, cfg_fi), full_w=g720.pad_w,
            lp_fast=k6i_taps[0], lp_slow=k6i_taps[1]),
        "phase_col_ifft[standard]": both(
            fused.phase_col_ifft, *k6_cur, *k6_prev,
            cfg_f.replace(mode="standard"), **k6_kw),
        "phase_col_ifft[steerable 4, overlapping bands]": both(
            fused.phase_col_ifft, *k6_cur, *k6_prev,
            cfg_f.replace(orientations=4, pyramid_levels=6), **k6_kw),
        "phase_col_ifft[full lanes]": both(
            fused.phase_col_ifft, *k6f_cur, *k6f_prev, cfg_full, **k6_kw),
        "_fft_axis[inverse, axis 2, scale]": both(
            radix2._fft_axis, k8_re, k8_im, 2, True,
            1.0 / (g_sq.pad_h * g_sq.pad_w)),
        "_fft_axis[forward real, axis 2]": both(
            radix2._fft_axis, k8_re, None, 2, False),
        "_fft_axis[forward real, axis 1]": both(
            radix2._fft_axis, k8_re, None, 1, False),
        "_fft_axis[forward complex, axis 1]": both(
            radix2._fft_axis, k8_re, k8_im, 1, False),
        "_fft_axis[forward complex, axis 2]": both(
            radix2._fft_axis, k8_re, k8_im, 2, False),
        "amplify_procedural[centered]": both(
            fused_kernels.amplify_procedural, *k9c_cur, *k9c_prev, *axes_c,
            *k9_args(cfg_g)),
        "amplify_procedural[2.5]": both(
            fused_kernels.amplify_procedural, *k9_cur, *k9_prev, *axes_b,
            *k9_args(cfg_g.replace(phase_scale=2.5))),
        "amplify_procedural[steerable 4]": both(
            fused_kernels.amplify_procedural, *k9_cur, *k9_prev, *axes_b,
            *k9_args(cfg_g.replace(orientations=4))),
        "post_fused[planar_u8]": both(
            post_fused.post_fused, *yonly_post_args, out_layout="planar_u8"),
        "post_fused[compensate, gains]": both(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_str, rows[0],
            H, W, "tight"),
        # The measurement path's kernels: kdecomp's other piece sets, the
        # copy patterns at both sizes.
        **{f"kdecomp_variant[{name}]": both(
            kdecomp.kdecomp_variant, *kd, cfg_t, pieces, kd_rows,
            full_w=kd_fw) for name, pieces in kdecomp.VARIANTS[:-1]},
        **{f"copy_probe[{pat} {blk}{', 16 frames' if big else ''}]": both(
            kexp.copy_probe, *(cp16 if big else cp1), pat, blk)
           for big in (False, True)
           for pat, blk in (("rows", 1), ("rows", 64), ("lanes", 4),
                            ("lanes", 8), ("lanes", 32))
           if big or (pat, blk) != ("rows", 1)},
    }
    # What each kernel's call above must move and compute, and the one
    # torch call that computes the same transform (FFT kernels only):
    # name -> (bytes, f32 operations, library call or None).  Bytes: each
    # input read once, each output written once.  Operations: 5 n log2 n
    # per complex radix-2 transform of length n, and per element of the
    # other stages a count of their multiplies and adds (the phase pass
    # ~40, a mask level ~15, a (2r + 1)^2 blur tap pair 2, the post
    # epilogue ~20), so the bound is a floor.
    f4 = 4
    n_sq = g_sq.pad_h * g_sq.pad_w

    def fft_ops(n, count):
        return 5.0 * n * np.log2(n) * count

    blur = 2 * (2 * post_fused._radius(cfg) + 1) ** 2
    hc_sq = r1_sq - r0_sq
    u8_r0, u8_r1 = fused.aligned_row_window(geom.y0, geom.y0 + H, geom.pad_h)
    work = {
        "windowed_row_fft": (
            f4 * y.numel() + 2 * f4 * T * geom.pad_h * wk,
            fft_ops(geom.pad_w, T * geom.pad_h) + 2 * y.numel(),
            lambda: torch.fft.fft(y, dim=-1)),
        "colspec_chunk": (
            f4 * (2 * rows_re.numel() + 4 * prev_re.numel()
                  + 2 * T * hr * wk),
            fft_ops(geom.pad_h, 2 * T * wk) + 40 * T * geom.pad_h * wk, None),
        "rowifft_post_fused": (
            f4 * (2 * rre.numel() + 2 * i_pl.numel() + H * W + 3 * T * H * W),
            fft_ops(geom.pad_w, T * hr) + (blur + 20) * T * H * W, None),
        "windowed_row_fft_u8planar": (
            u8_frames.numel() + 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 8 * T * H * W,
            lambda: torch.fft.fft(y[:, u8_r0:u8_r1], dim=-1)),
        "row_ifft_magnitude": (
            f4 * (2 * rre.numel() + T * hr * geom.pad_w),
            fft_ops(geom.pad_w, T * hr) + 3 * T * hr * geom.pad_w,
            lambda: torch.fft.irfft(irfft_in, n=geom.pad_w, dim=-1)),
        "col_fft_zero_padded": (
            2 * f4 * (hc_sq * wk + g_sq.pad_h * wk),
            fft_ops(g_sq.pad_h, wk), lambda: torch.fft.fft(col_in, dim=-2)),
        "post_fused_rgb": (
            f4 * (rec3.numel() + H * W) + 3 * T * H * W,
            (3 * blur + 20) * T * H * W, None),
        "phase_col_ifft": (
            f4 * (4 * k6_cur[0].numel() + 2 * hr_sq * wk),
            fft_ops(g_sq.pad_h, wk) + 40 * g_sq.pad_h * wk, None),
        "_fft_axis": (
            f4 * 4 * n_sq, fft_ops(g_sq.pad_h, g_sq.pad_w),
            lambda: torch.fft.ifft(fft_in, dim=-2)),
        "amplify_procedural": (
            f4 * (6 * n_sq + g_sq.pad_h + g_sq.pad_w),
            (15 * cfg_g.pyramid_levels + 40) * n_sq, None),
        "post_fused": (
            f4 * (rec1.numel() + 2 * i_pl.numel() + H * W + 3 * T * H * W),
            (blur + 20) * T * H * W, None),
        "kdecomp_variant": (
            f4 * (4 * kd[0].numel() + 2 * (kd_rows[1] - kd_rows[0]) * wk),
            fft_ops(g_sq.pad_h, wk) + 40 * g_sq.pad_h * wk,
            lambda: torch.fft.ifft(kd_in, dim=-2)),
        "copy_probe": (2 * 2 * f4 * cp1[0].numel(), 0,
                       lambda: cp_dst.copy_(cp_pair)),
        "trig_probe": (3 * f4 * tp_in[0].numel(), 20 * tp_in[0].numel(),
                       lambda: torch.atan2(*tp_in)),
    }
    assert set(work) == set(calls)
    irfft_in = torch.complex(rre[..., :geom.pad_w // 2 + 1].contiguous(),
                             rim[..., :geom.pad_w // 2 + 1].contiguous())
    col_in = torch.complex(sq_prev[0], sq_prev[1])
    fft_in = torch.complex(k8_re, k8_im)
    kd_in = torch.complex(kd[0], kd[1])
    cp_pair = torch.stack(cp1)
    cp_dst = torch.empty_like(cp_pair)

    records = {}
    for name, (kern, plain) in {**calls, **variants}.items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        if name.startswith(("copy_probe", "kdecomp_variant[stream only]")):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            rel, tol, what = err, 0.0, "max abs (bit for bit)"
            ok = same
        elif got[0].dtype == torch.uint8:
            err = max(int((g.int() - w.int()).abs().max())
                      for g, w in zip(got, want))
            rel, tol, what = err, 1, "max code difference"
            ok = rel <= tol
        elif name.startswith(("rowifft_post_fused", "post_fused")):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel, tol, what = err, IMG_TOL, "max abs"
            ok = np.isfinite(rel) and rel < tol
        else:
            if len(got) == 1:  # |z| planes: one real spectrum-scale image
                pairs, refs = [(got[0], None)], [(want[0], None)]
            else:
                pairs = [(got[k], got[k + 1]) for k in range(0, len(got), 2)]
                refs = [(want[k], want[k + 1])
                        for k in range(0, len(want), 2)]
            if len(got) == 6:
                # The IIR taps, weighted by the magnitude of the bin each
                # rotates: at bins at the FFTs' rounding floor (~1e-7 of
                # the maximum) the phase delta is noise in both versions
                # and the taps differ; there they rotate nothing.
                mag = torch.complex(want[2], want[3]).abs()
                pairs, refs = pairs[:2], refs[:2]
                for g, w in zip(got[4:], want[4:]):
                    e = float(((g - w).abs() * mag).max())
                    r = e / float((w.abs() * mag).max())
                    log(f"[2] {name}: IIR tap weighted by |S|: max err / max "
                        f"{r:.3e}, unweighted max abs "
                        f"{float((g - w).abs().max()):.3e}")
                    if not r < SPEC_TOL:
                        raise AssertionError(f"{name}: IIR taps {r}")
            err, rel = 0.0, 0.0
            for (gr, gi), (wr, wi) in zip(pairs, refs):
                gz = gr if gi is None else torch.complex(gr, gi)
                wz = wr if wi is None else torch.complex(wr, wi)
                e, r = spec_err([gz], [wz])
                err, rel = max(err, e), max(rel, r)
            tol, what = SPEC_TOL, "max err / max magnitude"
            ok = np.isfinite(rel) and rel < tol
        log(f"[2] {name}: {what} {rel:.3e} (bound {tol:g}), max abs "
            f"{err:.3e}, shapes {[tuple(g.shape) for g in got]} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rel} > {tol}")
        records[name] = {"max_abs_err": float(err)}
    # Kernel 4's contract: the torch pre stage + kernel 1, bit for bit.
    k4 = fused.windowed_row_fft_u8planar(*u8_args)
    pre = preprocess_cl(u8_frames, cfg, want_iq=True)
    same = torch.equal(k4[0], pre[0]) and torch.equal(k4[1], pre[1])
    log(f"[2] windowed_row_fft_u8planar == pre stage + windowed_row_fft on "
        f"the same (16, 3, 1080, 1920) u8 frames: {same}")
    if not same:
        raise AssertionError("kernel 4 differs from the pre stage + kernel 1")
    del k4, pre
    # Kernel 6 = kernel 2's phase pass and inverse: on the spectra kernel 5
    # gives, its rows equal kernel 2's bit for bit (1080p square_pow2).
    k5 = fused.col_fft_zero_padded(sq_re, sq_im, g_sq.pad_h, r0_sq)
    k2 = fused.colspec_chunk(sq_re, sq_im, *sq_prev, cfg_sq, g_sq.pad_h,
                             r0_sq, **k6_kw)
    k6 = fused.phase_col_ifft(
        *k5, *(torch.cat([p, c[:-1]]) for p, c in zip(sq_prev, k5)), cfg_sq,
        **k6_kw)
    same = torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])
    log(f"[2] phase_col_ifft on kernel 5's spectra == colspec_chunk's output "
        f"rows, (16, {hr_sq}, {wk}) at 1080p square_pow2: {same}")
    if not same:
        raise AssertionError("kernel 6 differs from kernel 2's output rows")
    del k5, k2, k6
    # Kernel 12's full variant = kernel 6, bit for bit: on kdecomp's
    # planes (tuned_for_tpu(), rows (384, 1600)) and on the bar's spectra.
    full = kdecomp.VARIANTS[-1][1]
    for what, ins, c, rr in (
            ("kdecomp's (1, 2048, 1152) planes", kd, cfg_t, kd_rows),
            ("the 1080p bar's spectra", (*k6_cur, *k6_prev), cfg_f,
             rows_sq)):
        k12 = kdecomp.kdecomp_variant(*ins, c, full, rr, full_w=kd_fw)
        k6 = fused.phase_col_ifft(*ins, c, out_rows=rr, full_w=kd_fw)
        same = all(torch.equal(a, b) for a, b in zip(k12, k6))
        log(f"[2] kdecomp_variant (phase + gm + rolls) == phase_col_ifft on "
            f"{what}: {same}")
        if not same:
            raise AssertionError("kernel 12's full variant differs from "
                                 "kernel 6")
    # Kernel 14: every op code against fp64 (the JAX probe's tolerances)
    # and its plain version, signed and exact zeros included.
    for r in trig_probe.run_probe(dev):
        ok = r["ok"] and r["max_abs_vs_plain"] <= r["tol"]
        log(f"[2] trig_probe {r['name']}: max err vs fp64 "
            f"{r['max_err']:.3e} (bound {r['tol']:g}), vs plain "
            f"{r['max_abs_vs_plain']:.3e}, finite {r['finite']} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"trig_probe {r['name']}: {r}")

    # -- 3. end to end, path by path -----------------------------------------
    wrappers = {"windowed_row_fft": fused.windowed_row_fft,
                "colspec_chunk": fused.colspec_chunk,
                "rowifft_post_fused": post_fused.rowifft_post_fused,
                "windowed_row_fft_u8planar": fused.windowed_row_fft_u8planar,
                "row_ifft_magnitude": fused.row_ifft_magnitude,
                "col_fft_zero_padded": fused.col_fft_zero_padded,
                "post_fused_rgb": post_fused.post_fused_rgb,
                "phase_col_ifft": fused.phase_col_ifft,
                "_fft_axis": radix2._fft_axis,
                "amplify_procedural": fused_kernels.amplify_procedural,
                "post_fused": post_fused.post_fused,
                "kdecomp_variant": kdecomp.kdecomp_variant,
                "copy_probe": kexp.copy_probe,
                "trig_probe": trig_probe.trig_probe}
    path_launches = {}

    def run_path(name, must, must_not, fn):
        """Run fn() with every count at 0; check and record the counts."""
        for f in wrappers.values():
            f.launches = 0
        res = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in wrappers.items()}
        path_launches[name] = got
        log(f"[3] {name}: launches {got}")
        if not all(got[k] >= 1 for k in must) or any(got[k] for k in
                                                    must_not):
            raise AssertionError(f"{name}: expected launches of {must} and "
                                 f"none of {must_not}, got {got}")
        return res

    def two_chunks(frames_d, c):
        o1, s1 = pbmm_tpu_torch.magnify_video(frames_d, c)
        o2, s2 = pbmm_tpu_torch.magnify_video(frames_d, c, s1)
        return o1, s1, o2, s2

    def check_split(frames_d, c, out1, s1, what):
        oa, sa = pbmm_tpu_torch.magnify_video(frames_d[:8], c)
        ob, sb = pbmm_tpu_torch.magnify_video(frames_d[8:], c, sa)
        if not (torch.equal(torch.cat([oa, ob]), out1)
                and all(torch.equal(a, b) for a, b in zip(
                    sb[:2] + tuple(sb.temporal),
                    s1[:2] + tuple(s1.temporal)))):
            raise AssertionError(f"{what}: chunks of 8 + 8 differ from one "
                                 "chunk of 16")
        log(f"[3] {what}: chunks 8 + 8 equal one chunk of 16 bit for bit "
            "(frames and state)")

    def check_frames(what, outs, shape, dtype):
        for o in outs:
            if tuple(o.shape) != shape or o.dtype != dtype:
                raise AssertionError(f"{what}: {tuple(o.shape)} {o.dtype}")
            if dtype == torch.float32 and not (
                    torch.isfinite(o).all() and o.min() >= 0 and o.max() <= 1):
                raise AssertionError(f"{what}: values outside [0, 1] or not "
                                     "finite")
        log(f"[3] {what}: outputs {shape} {dtype}, finite in [0, 1]")

    # The fp64 oracle of every path runs on host threads (numpy releases
    # the GIL in its loops) while the card works; all of them end before
    # phase 4 times anything.
    pool = ThreadPoolExecutor(4)

    def oracle_job(frames01, c):
        """The oracle on frames 0-3 of `frames01` (interleaved, in [0, 1])
        under config c, started on a host thread."""
        fn = (oracle.oracle_magnify_video_iir
              if c.temporal.mode == "iir_bandpass"
              else oracle.oracle_magnify_video)

        def run():
            t0 = time.perf_counter()
            return fn(frames01[:4], c), time.perf_counter() - t0
        return pool.submit(run)

    def vs_oracle(outs, job):
        """PSNR of frames 0-3 of each (name, interleaved output) against
        the oracle's result of `job`."""
        want, secs = job.result()
        dbs = []
        for name, got in outs:
            db = psnr_db(got[:4].double().cpu().numpy(), want)
            log(f"[3] {name}: PSNR vs the fp64 oracle, frames 0-3: "
                f"{db:.2f} dB (bound > 100; oracle {secs:.1f} s on a host "
                "thread)")
            if not db > 100:
                raise AssertionError(f"{name}: PSNR {db} dB <= 100")
            dbs.append(db)
        return dbs

    # The clips, and their oracles started at once.
    # f32 1080p, the bench clip (the JAX bench's main path)
    base = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, shift=i, axis=1) * (0.95 + 0.01 * i)
                       for i in range(T)]).astype(np.float32)
    frames_d = torch.from_numpy(frames).to(dev)
    frames_u8 = np.ascontiguousarray(np.moveaxis(
        np.round(frames * 255.0).astype(np.uint8), -1, 1))
    b540 = np.random.default_rng(1).integers(0, 256, (H540, W540, 3),
                                             dtype=np.uint8)
    f540_u8 = np.stack([np.roll(b540, shift=i, axis=1) for i in range(T)])
    f540 = (f540_u8 / 255.0).astype(np.float32)
    jobs = {"f32": oracle_job(frames, cfg),
            "u8": oracle_job(np.moveaxis(frames_u8, 1, -1) / 255.0, cfg),
            "540p": oracle_job(f540, cfg),
            "a": oracle_job(frames, cfg_sq),
            "b": oracle_job(bar_f01, cfg_rgb),
            "c": oracle_job(bar720, cfg_std),
            # One oracle serves (e)-(h): the same bar and geometry, the
            # backends and engines compute the same function.
            "bar": oracle_job(bar_f01, cfg_e),
            "f_iir": oracle_job(bar720, cfg_fi)}

    out1, s1, out2, s2 = run_path(
        "f32 1080p", ("windowed_row_fft", "colspec_chunk",
                      "rowifft_post_fused"), (),
        lambda: two_chunks(frames_d, cfg))
    launches = path_launches["f32 1080p"]
    for name, o in (("chunk 1", out1), ("chunk 2", out2)):
        if tuple(o.shape) != (T, H, W, 3) or o.dtype != torch.float32:
            raise AssertionError(f"{name}: shape {tuple(o.shape)} {o.dtype}")
        if not (torch.isfinite(o).all() and o.min() >= 0 and o.max() <= 1):
            raise AssertionError(f"{name}: values outside [0, 1] or not "
                                 "finite")
    if tuple(s2.prev_spec_re.shape) != (1, geom.pad_h, wk):
        raise AssertionError(f"state shape {tuple(s2.prev_spec_re.shape)}")
    log(f"[3] outputs {tuple(out1.shape)} finite in [0, 1]; state "
        f"{tuple(s2.prev_spec_re.shape)}, frame_idx {s2.frame_idx}")
    check_split(frames_d, cfg, out1, s1, "f32 1080p")
    psnr, = vs_oracle([("f32 1080p", out1)], jobs["f32"])

    # u8 1080p: planar uint8 in, planar and planar_u8 out
    u8_d = torch.from_numpy(frames_u8).to(dev)
    cfg_pl = cfg.replace(output_layout="planar")
    cfg_u8 = cfg.replace(output_layout="planar_u8")
    u8_kernels = ("windowed_row_fft_u8planar", "colspec_chunk",
                  "rowifft_post_fused")
    pl1, pls1, pl2, _ = run_path("u8 1080p -> planar", u8_kernels,
                                 ("windowed_row_fft",),
                                 lambda: two_chunks(u8_d, cfg_pl))
    q1, _, q2, _ = run_path("u8 1080p -> planar_u8", u8_kernels,
                            ("windowed_row_fft",),
                            lambda: two_chunks(u8_d, cfg_u8))
    for name, o, dt in (("planar", pl1, torch.float32),
                        ("planar_u8", q1, torch.uint8)):
        if tuple(o.shape) != (T, 3, H, W) or o.dtype != dt:
            raise AssertionError(f"u8 -> {name}: {tuple(o.shape)} {o.dtype}")
    if not all(torch.equal(q, torch.round(p * 255.0).to(torch.uint8))
               for q, p in ((q1, pl1), (q2, pl2))):
        raise AssertionError("planar_u8 differs from round(255 planar)")
    log("[3] u8 1080p: planar_u8 equals round(255 planar) exactly, both "
        "chunks")
    check_split(u8_d, cfg_pl, pl1, pls1, "u8 1080p -> planar")
    psnr_u8, = vs_oracle([("u8 1080p -> planar", torch.movedim(pl1, 1, -1))],
                         jobs["u8"])

    # 540p: the two-kernel tail, interleaved f32 and planar u8 in
    f540_d = torch.from_numpy(f540).to(dev)
    p540_d = torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(f540_u8, -1, 1))).to(dev)
    tail_kernels = ("windowed_row_fft", "colspec_chunk", "row_ifft_magnitude")
    o540, *_ = run_path("540p f32", tail_kernels, ("rowifft_post_fused",),
                        lambda: two_chunks(f540_d, cfg))
    ou540, *_ = run_path("540p u8", tail_kernels, ("rowifft_post_fused",),
                         lambda: two_chunks(p540_d, cfg))
    if tuple(o540.shape) != (T, H540, W540, 3):
        raise AssertionError(f"540p: shape {tuple(o540.shape)}")
    # f540 is the u8 frames / 255 (to an f32 ulp): one oracle run holds
    # both inputs.
    psnr_540, psnr_540u8 = vs_oracle(
        [("540p f32", o540), ("540p u8", ou540)], jobs["540p"])

    # The config matrix.  (a) 1080p square_pow2, interleaved f32: the
    # stream starts from kernel 5's spectrum of frame 0.
    path_a = "(a) 1080p square_pow2"
    sq_kernels = ("col_fft_zero_padded", "windowed_row_fft", "colspec_chunk",
                  "rowifft_post_fused")
    a1, sa1, a2, _ = run_path(
        path_a, sq_kernels, ("windowed_row_fft_u8planar",
                             "row_ifft_magnitude", "post_fused_rgb"),
        lambda: two_chunks(frames_d, cfg_sq))
    check_frames(path_a, (a1, a2), (T, H, W, 3), torch.float32)
    check_split(frames_d, cfg_sq, a1, sa1, path_a)
    # Planar frames start through kernel 2 against a zero spectrum: the
    # two starts must carry the same bits, after frame 0 and after 16.
    planar_d = frames_d.permute(0, 3, 1, 2).contiguous()
    k5 = pbmm_tpu_torch.magnify_video(frames_d[:1], cfg_sq)[1]
    k2 = pbmm_tpu_torch.magnify_video(planar_d[:1], cfg_sq)[1]
    pa1, psa1 = pbmm_tpu_torch.magnify_video(
        planar_d, cfg_sq.replace(output_layout="planar"))
    same = (all(torch.equal(x, y) for x, y in zip(k5[:2], k2[:2]))
            and all(torch.equal(x, y) for x, y in zip(psa1[:2], sa1[:2]))
            and torch.equal(pa1.permute(0, 2, 3, 1), a1))
    log(f"[3] {path_a}: the kernel-5 start (interleaved) equals the "
        f"kernel-2 zero-prev start (planar) bit for bit, state after frame "
        f"0 and after 16, and the 16 frames: {same}")
    if not same:
        raise AssertionError("kernel 5's bootstrap differs from kernel 2's")
    del planar_d, pa1
    psnr_a, = vs_oracle([(path_a, a1)], jobs["a"])

    # (b) 1080p tight, rgb, IIR, planar uint8 in, planar_u8 out.
    path_b = "(b) 1080p rgb IIR u8 -> planar_u8"
    b1, sb1, b2, sb2 = run_path(
        path_b, ("windowed_row_fft", "colspec_chunk", "row_ifft_magnitude",
                 "post_fused_rgb"),
        ("windowed_row_fft_u8planar", "rowifft_post_fused",
         "col_fft_zero_padded"),
        lambda: two_chunks(bar_d, cfg_rgb))
    check_frames(path_b, (b1, b2), (T, 3, H, W), torch.uint8)
    taps = sb2.temporal
    if not (tuple(taps.lp_fast.shape) == (3, geom.pad_h, wk)
            and all(torch.isfinite(x).all() for x in taps)
            and taps.lp_fast.any()):
        raise AssertionError(f"{path_b}: IIR taps {tuple(taps.lp_fast.shape)}"
                             " not finite or all zero")
    check_split(bar_d, cfg_rgb, b1, sb1, path_b)
    bf = pbmm_tpu_torch.magnify_video(
        bar_d[:4], cfg_rgb.replace(output_layout="planar"))[0]
    if not torch.equal(b1[:4], torch.round(bf * 255.0).to(torch.uint8)):
        raise AssertionError(f"{path_b}: planar_u8 differs from round(255 "
                             "planar)")
    log(f"[3] {path_b}: IIR taps (3, {geom.pad_h}, {wk}) finite; planar_u8 "
        "equals round(255 planar) on frames 0-3")
    psnr_b, = vs_oracle([(path_b + " (planar f32)", bf.movedim(1, -1))],
                        jobs["b"])

    # (c) 1280x720 rect_pow2 (1024 x 2048), standard mode, phase_scale 2.5.
    path_c = "(c) 720p rect_pow2 standard 2.5"
    c1, sc1, c2, _ = run_path(
        path_c, sq_kernels, ("windowed_row_fft_u8planar",
                             "row_ifft_magnitude", "post_fused_rgb"),
        lambda: two_chunks(bar720_d, cfg_std))
    check_frames(path_c, (c1, c2), (T, H720, W720, 3), torch.float32)
    check_split(bar720_d, cfg_std, c1, sc1, path_c)
    psnr_c, = vs_oracle([(path_c, c1)], jobs["c"])

    # (d) 1080p tight: steerable sectors over overlapping bands, Re z,
    # window compensation, YIQ gains (no oracle covers the last two).
    path_d = "(d) 1080p steerable real compensate gains"
    d1, sd1, d2, _ = run_path(
        path_d, ("windowed_row_fft", "colspec_chunk", "rowifft_post_fused"),
        ("col_fft_zero_padded", "row_ifft_magnitude", "post_fused_rgb",
         "windowed_row_fft_u8planar"),
        lambda: two_chunks(frames_d, cfg_str))
    check_frames(path_d, (d1, d2), (T, H, W, 3), torch.float32)
    check_split(frames_d, cfg_str, d1, sd1, path_d)

    # The scan engine and the unfused backends on the 1080p bar.
    none_of = tuple(wrappers)
    scan_k = ("windowed_row_fft", "col_fft_zero_padded", "phase_col_ifft",
              "row_ifft_magnitude")
    not_scan = ("colspec_chunk", "rowifft_post_fused", "_fft_axis",
                "amplify_procedural", "post_fused", "post_fused_rgb",
                "windowed_row_fft_u8planar")
    path_e = "(e) 1080p MagnifyConfig() (torch.fft, scan)"
    e1, se1, e2, _ = run_path(path_e, (), none_of,
                              lambda: two_chunks(bar_il_d, cfg_e))
    check_frames(path_e, (e1, e2), (T, H, W, 3), torch.float32)
    check_split(bar_il_d, cfg_e, e1, se1, path_e)
    psnr_e, = vs_oracle([(path_e, e1)], jobs["bar"])

    path_f = "(f) 1080p tuned scan square_pow2"
    f1, sf1, f2, _ = run_path(path_f, scan_k, not_scan,
                              lambda: two_chunks(bar_il_d, cfg_f))
    check_frames(path_f, (f1, f2), (T, H, W, 3), torch.float32)
    check_split(bar_il_d, cfg_f, f1, sf1, path_f)
    psnr_f, = vs_oracle([(path_f, f1)], jobs["bar"])

    path_fi = "(f) 720p rect_pow2 tuned scan, no cache, IIR"
    fi1, sfi1, fi2, sfi2 = run_path(path_fi, scan_k, not_scan,
                                    lambda: two_chunks(bar720_d, cfg_fi))
    check_frames(path_fi, (fi1, fi2), (T, H720, W720, 3), torch.float32)
    taps = sfi2.temporal
    if not (tuple(sfi2.prev_frame.shape) == (H720, W720, 3)
            and all(torch.isfinite(x).all() for x in taps)
            and taps.lp_fast.any()):
        raise AssertionError(f"{path_fi}: state {tuple(sfi2.prev_frame.shape)}"
                             ", taps not finite or all zero")
    check_split(bar720_d, cfg_fi, fi1, sfi1, path_fi)
    psnr_fi, = vs_oracle([(path_fi, fi1)], jobs["f_iir"])

    path_g = "(g) 1080p pallas unfused, use_pallas"
    g1, sg1, g2, _ = run_path(
        path_g, ("windowed_row_fft", "col_fft_zero_padded",
                 "amplify_procedural", "_fft_axis"),
        ("phase_col_ifft", "colspec_chunk", "row_ifft_magnitude",
         "rowifft_post_fused", "post_fused", "post_fused_rgb"),
        lambda: two_chunks(bar_il_d, cfg_g))
    check_frames(path_g, (g1, g2), (T, H, W, 3), torch.float32)
    check_split(bar_il_d, cfg_g, g1, sg1, path_g)
    psnr_g, = vs_oracle([(path_g, g1)], jobs["bar"])

    path_h = "(h) 1080p magnify_frame_pair, tuned"
    pairs = run_path(path_h, scan_k, not_scan, lambda: [
        magnify_frame_pair(bar_il_d[i - 1], bar_il_d[i], cfg_f)
        for i in range(1, 4)])
    check_frames(path_h, pairs, (H, W, 3), torch.float32)
    same = all(torch.equal(p, f1[i]) for i, p in enumerate(pairs, 1))
    log(f"[3] {path_h}: pairs (0, 1), (1, 2), (2, 3) equal (f)'s frames "
        f"1-3 bit for bit: {same}")
    if not same:
        raise AssertionError("magnify_frame_pair differs from the scan step")
    psnr_h, = vs_oracle([(path_h, torch.stack([bar_il_d[0], *pairs]))],
                        jobs["bar"])
    pool.shutdown(wait=True)

    # (i) the measurement path, through the tools' functions and the CLI.
    path_i = "(i) measurement path"
    meas_dir = tempfile.mkdtemp(prefix="pbmm_meas_")

    def measurement():
        t0 = time.perf_counter()
        res = {"copy_gbps": roofline.row_copy_ceiling(dev)}
        res["roofline"] = roofline.roofline_table(
            reps=10, copy_gbps=res["copy_gbps"])
        res["ceilings"] = {
            f"{pat} {blk}, {label}": (planes[0].numel(), kexp.timed(
                kexp.copy_probe, (*planes, pat, blk)))
            for label, planes in (("1 frame", cp1), ("16 frames", cp16))
            for pat, blk in (("rows", 1), ("rows", 64), ("lanes", 4),
                             ("lanes", 8), ("lanes", 32))}
        res["kexp"] = {n: kexp.timed(fn, a) for n, (fn, a) in
                       kexp.experiments(dev, {
                           "rowfft_kept", "colfft_kept", "phase_kept",
                           "rowifft_kept"}).items()}
        res["kdecomp"] = kdecomp.run_kdecomp(dev, reps=10)
        res["trig"] = trig_probe.run_probe(dev)
        demo_out = os.path.join(meas_dir, "demo.npy")
        trace_dir = os.path.join(meas_dir, "trace")
        rc = port_cli.main(
            ["--demo", "bar", "--fast", "--trace", trace_dir, "--stats",
             "--output", demo_out])
        view_out = os.path.join(meas_dir, "view.npy")
        rc2 = port_cli.main(
            ["--demo", "bar", "--debug-view", "split", "--output", view_out])
        res["cli"] = (rc, rc2, demo_out, trace_dir, view_out)
        res["seconds"] = time.perf_counter() - t0
        return res

    try:
        meas = run_path(path_i, ("kdecomp_variant", "copy_probe",
                                 "trig_probe", "windowed_row_fft",
                                 "colspec_chunk", "rowifft_post_fused"), (),
                        measurement)
        rc, rc2, demo_out, trace_dir, view_out = meas["cli"]
        if rc != 0 or rc2 != 0:
            raise AssertionError(f"{path_i}: the CLI exited {rc}, {rc2}")
        demo = np.load(demo_out)
        if demo.shape != (64, 128, 128, 3) or not np.isfinite(demo).all():
            raise AssertionError(f"{path_i}: --demo bar gave {demo.shape}")
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        text = open(traces[0]).read() if len(traces) == 1 else ""
        named = [k for k in ("row_fft_kernel", "pbmm.colspec_chunk",
                             "pbmm.preprocess") if k in text]
        log(f"[3] {path_i}: --demo bar --fast --trace: {len(traces)} trace "
            f"file(s), {len(text) / 1e6:.1f} MB, naming {named}")
        if "row_fft_kernel" not in named:
            raise AssertionError(f"{path_i}: the trace names no kernel 1")
        view = np.load(view_out)
        bar = synthetic.oscillating_bar(bar_width=2)
        want = debug_frame_view(torch.from_numpy(bar[1]), cfg_e,
                                show_magnitude=True, show_phase=True)
        err = float(np.abs(view[1, :, :64] - want[:, :64].numpy()).max())
        log(f"[3] {path_i}: --debug-view split {view.shape}, magnitude half "
            f"of frame 1 against the CPU's: max abs {err:.3e} (bound 1e-4)")
        if view.shape != (64, 128, 128, 3) or not err < 1e-4:
            raise AssertionError(f"{path_i}: --debug-view split disagrees")
        bad = [r for r in meas["trig"] if not r["ok"]]
        if bad:
            raise AssertionError(f"{path_i}: trig probe {bad}")
    finally:
        shutil.rmtree(meas_dir, ignore_errors=True)
    log(f"[3] {path_i}: {meas['seconds']:.1f} s")
    roofline.print_table(*meas["roofline"], file=sys.stdout)
    for name, (numel, (warm, cold)) in meas["ceilings"].items():
        nbytes = 2 * 2 * 4 * numel
        log(f"[3] {card}: copy ceiling, {name}, {nbytes / 1e6:.1f} MB "
            f"moved: warm {warm:.4f} ms {kexp.copy_gbps(nbytes, warm):.0f} "
            f"GB/s, cold {cold:.4f} ms {kexp.copy_gbps(nbytes, cold):.0f} "
            "GB/s")
    for name, (warm, cold) in meas["kexp"].items():
        log(f"[3] {card}: kexp {name}: warm {warm:.4f} ms, cold {cold:.4f} "
            "ms")
    for name, warm, cold in meas["kdecomp"]:
        log(f"[3] {card}: kdecomp {name}: warm {warm:.4f} ms, cold "
            f"{cold:.4f} ms")
    for name, (warm, cold) in kdecomp.split(meas["kdecomp"]).items():
        log(f"[3] {card}: kdecomp split, {name}: warm {warm:.4f} ms, cold "
            f"{cold:.4f} ms")

    # stream: a 1080p 420jpeg y4m through stream_magnify(ingest="u8")
    tmp = tempfile.mkdtemp(prefix="pbmm_smoke_")
    try:
        clip = os.path.join(tmp, "clip.y4m")
        t0 = time.perf_counter()
        y4m.save_y4m(clip, np.concatenate([frames, frames[::-1]]),
                     colorspace="420jpeg")
        log(f"[3] stream: wrote a 32-frame 1080p 420jpeg y4m in "
            f"{time.perf_counter() - t0:.1f} s")
        got = run_path("stream u8", u8_kernels, ("windowed_row_fft",),
                       lambda: list(stream.stream_magnify(
                           clip, cfg_u8, chunk_frames=T, ingest="u8",
                           device=dev)))
        with open(clip, "rb") as f:
            planes = list(y4m.read_y4m_planes(f, clip))
        want, st = [], None
        for i in range(0, len(planes), T):
            yy, cb, cr = (torch.from_numpy(np.stack(
                [p[k] for p in planes[i:i + T]])).to(dev) for k in range(3))
            o, st = pbmm_tpu_torch.magnify_video(
                ycbcr_planes_to_rgb_planar_u8(yy, cb, cr, H, W), cfg_u8, st)
            want.append(o.cpu().numpy())
        if not (len(got) == len(want) == 2 and all(
                np.array_equal(a, b) for a, b in zip(got, want))):
            raise AssertionError("stream_magnify differs from magnify_video "
                                 "on the device-decoded chunks")
        log("[3] stream: 2 chunks of (16, 3, 1080, 1920) uint8, equal to "
            "magnify_video on the device-decoded chunks")

        # -- 4. timing -------------------------------------------------------
        def steady(frames_d, c, what, reps=10):
            state = [pbmm_tpu_torch.magnify_video(frames_d, c)[1]]

            def chunk():
                out, state[0] = pbmm_tpu_torch.magnify_video(frames_d, c,
                                                             state[0])
                return out

            ms = time_ms(torch, chunk, reps=reps, warmup=2)
            fps_ = T / (ms / 1e3)
            log(f"[4] {card}: {what}: steady-state chunk of {T} frames "
                f"{ms:.3f} ms median of {reps} -> {fps_:.2f} frames/s, "
                f"{ms / T:.4f} ms/frame")
            return chunk, ms, fps_

        chunk, chunk_ms, fps = steady(frames_d, cfg, "f32 1080p")
        chunk_u8, ms_u8, fps_u8 = steady(u8_d, cfg_u8,
                                         "u8 1080p -> planar_u8")
        _, ms_pl, fps_pl = steady(u8_d, cfg_pl, "u8 1080p -> planar")
        chunk_540, ms_540, fps_540 = steady(f540_d, cfg, "540p f32")
        matrix = {}
        for what, fd, c in ((path_a, frames_d, cfg_sq),
                            (path_b, bar_d, cfg_rgb),
                            (path_c, bar720_d, cfg_std),
                            (path_d, frames_d, cfg_str)):
            matrix[what] = steady(fd, c, what)
        scan_paths = {}
        for what, fd, c, db in ((path_e, bar_il_d, cfg_e, psnr_e),
                                (path_f, bar_il_d, cfg_f, psnr_f),
                                (path_fi, bar720_d, cfg_fi, psnr_fi),
                                (path_g, bar_il_d, cfg_g, psnr_g)):
            scan_paths[what] = steady(fd, c, what) + (db,)
        pair_ms = time_ms(torch, lambda: magnify_frame_pair(
            bar_il_d[0], bar_il_d[1], cfg_f))
        log(f"[4] {card}: {path_h}: {pair_ms:.3f} ms a pair, median of 10 "
            f"-> {1e3 / pair_ms:.2f} pairs/s")
        for name, (kern, plain) in {**calls, **variants}.items():
            enq_ms = time_ms(torch, kern)
            k_ms, cold_ms = kexp.timed(kern, device=dev)
            p_ms = kexp.timed(plain, reps=5, warmup=1, device=dev)[0]
            records[name].update(ms=k_ms, ms_cold=cold_ms, plain_ms=p_ms,
                                 ms_enqueued=enq_ms)
            log(f"[4] {card}: {name} {k_ms:.4f} ms warm, {cold_ms:.4f} ms "
                f"cold L2, plain PyTorch version {p_ms:.4f} ms (device "
                f"medians, at its path's shapes); {enq_ms:.4f} ms with the "
                "host's enqueue inside the event pair")
        for name, (nbytes, ops, lib) in work.items():
            byte_ms, op_ms = nbytes / 3.35e9, ops / 67e9
            records[name].update(
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                library_ms=kexp.timed(lib, device=dev)[0] if lib else None)
            log(f"[4] {card}: {name}: bound {records[name]['bound_ms']:.4f} "
                f"ms ({records[name]['bound_by']}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP), kernel {records[name]['ms']:.4f} "
                f"ms; library call "
                + (f"{records[name]['library_ms']:.4f} ms" if lib
                   else "none"))
        # The y4m stream end to end, and the host's parse alone.
        list(stream.stream_magnify(clip, cfg_u8, chunk_frames=T,
                                   ingest="u8", device=dev))
        t0 = time.perf_counter()
        n = sum(c.shape[0] for c in stream.stream_magnify(
            clip, cfg_u8, chunk_frames=T, ingest="u8", device=dev))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(clip, "rb") as f:
            for _ in y4m.read_y4m_planes(f, clip):
                pass
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in stream._open_chunk_source(clip, T, planar_u8=True,
                                           device=dev):
            pass
        torch.cuda.synchronize()
        source_s = time.perf_counter() - t0
        fps_stream = n / stream_s
        log(f"[4] {card}: y4m stream (32 1080p 420jpeg frames, u8 ingest, "
            f"planar_u8 out, host clock): {stream_s:.3f} s -> "
            f"{fps_stream:.2f} frames/s; the host's y4m parse alone "
            f"{parse_s:.3f} s, {100 * parse_s / stream_s:.1f} % of it; the "
            f"chunk source (parse, batching, host -> device, decode) "
            f"{source_s:.3f} s, {100 * source_s / stream_s:.1f} %; "
            "magnify and device -> host the rest")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 5. where the time goes (opt-in) -------------------------------------
    if args.profile:
        profile_chunks(torch, chunk, card, "f32 1080p")
        profile_chunks(torch, chunk_u8, card, "u8 1080p -> planar_u8")
        profile_chunks(torch, chunk_540, card, "540p f32")
        for what, (fn, _, _) in matrix.items():
            profile_chunks(torch, fn, card, what)
        for what, (fn, _, _, _) in scan_paths.items():
            profile_chunks(torch, fn, card, what)

    sources = {
        "windowed_row_fft": ("pbmm_tpu_torch/csrc/row_fft.cu",
                             "pbmm_tpu/spectral/fused.py:79", "f32 1080p"),
        "colspec_chunk": ("pbmm_tpu_torch/csrc/colspec_chunk.cu",
                          "pbmm_tpu/spectral/fused.py:1310", "f32 1080p"),
        "rowifft_post_fused": ("pbmm_tpu_torch/csrc/rowifft_post.cu",
                               "pbmm_tpu/engine/post_pallas.py:198",
                               "f32 1080p"),
        "windowed_row_fft_u8planar": ("pbmm_tpu_torch/csrc/row_fft.cu",
                                      "pbmm_tpu/spectral/fused.py:168",
                                      "u8 1080p -> planar_u8"),
        "row_ifft_magnitude": ("pbmm_tpu_torch/csrc/row_ifft.cu",
                               "pbmm_tpu/spectral/fused.py:1236",
                               "540p f32"),
        "col_fft_zero_padded": ("pbmm_tpu_torch/csrc/col_fft.cu",
                                "pbmm_tpu/spectral/fused.py:303", path_a),
        "post_fused_rgb": ("pbmm_tpu_torch/csrc/post_rgb.cu",
                           "pbmm_tpu/engine/post_pallas.py:398", path_b),
        "phase_col_ifft": ("pbmm_tpu_torch/csrc/phase_col_ifft.cu",
                           "pbmm_tpu/spectral/fused.py:1022", path_f),
        "_fft_axis": ("pbmm_tpu_torch/csrc/fft_axis.cu",
                      "pbmm_tpu/spectral/pallas_fft.py:405", path_g),
        "amplify_procedural": ("pbmm_tpu_torch/csrc/amplify_procedural.cu",
                               "pbmm_tpu/phase/pallas_kernels.py:136",
                               path_g),
        # No entry point of either package reaches kernel 10 (kernel 3
        # serves every y_only geometry where post_pallas_ok holds): it is
        # held against its plain version in phase 2 only.
        "post_fused": ("pbmm_tpu_torch/csrc/post_rgb.cu",
                       "pbmm_tpu/engine/post_pallas.py:91", None),
        "kdecomp_variant": ("pbmm_tpu_torch/csrc/kdecomp.cu",
                            "benchmarks/kdecomp.py:42", path_i),
        "copy_probe": ("pbmm_tpu_torch/csrc/copy_probe.cu",
                       "benchmarks/kexp.py:70", path_i),
        "trig_probe": ("pbmm_tpu_torch/csrc/trig_probe.cu",
                       "benchmarks/trig_probe.py:27", path_i),
    }
    kernels = []
    for name, (src, rep, path) in sources.items():
        rec = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": path_launches[path][name] if path else 0,
               "path": path or "none: phase 2 only", **records[name]}
        extra = {k: records[k] for k in variants if k.startswith(name + "[")}
        if extra:
            rec["variants"] = extra
        kernels.append(rec)
    log(json.dumps({
        "kernels": kernels, "fps_1080p": fps, "chunk_ms": chunk_ms,
        "psnr_vs_oracle_db": psnr,
        "paths": {
            "u8 1080p -> planar_u8": {"fps": fps_u8, "chunk_ms": ms_u8},
            "u8 1080p -> planar": {"fps": fps_pl, "chunk_ms": ms_pl,
                                   "psnr_vs_oracle_db": psnr_u8},
            "540p f32": {"fps": fps_540, "chunk_ms": ms_540,
                         "psnr_vs_oracle_db": psnr_540},
            "540p u8": {"psnr_vs_oracle_db": psnr_540u8},
            "stream u8": {"fps": fps_stream, "seconds": stream_s,
                          "host_parse_share": parse_s / stream_s,
                          "chunk_source_share": source_s / stream_s},
            **{what: {"fps": f, "chunk_ms": m, **(
                {"psnr_vs_oracle_db": db} if db is not None else {})}
               for (what, (_, m, f)), db in zip(
                   matrix.items(), (psnr_a, psnr_b, psnr_c, None))},
            **{what: {"fps": f, "chunk_ms": m, "psnr_vs_oracle_db": db}
               for what, (_, m, f, db) in scan_paths.items()},
            path_h: {"pairs_per_s": 1e3 / pair_ms, "pair_ms": pair_ms,
                     "psnr_vs_oracle_db": psnr_h},
            path_i: {"seconds": meas["seconds"],
                     "row_copy_ceiling_gbps": meas["copy_gbps"],
                     "roofline": meas["roofline"][1],
                     "kdecomp_split_ms": kdecomp.split(meas["kdecomp"])},
        },
        "launches_by_path": path_launches}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
