#!/usr/bin/env python3
"""Time the PyTorch port's kernels and paths on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Before it times a kernel case it holds the case's output against its
plain version's, at the card suite's bars (`check_case`); the card suite
holds the rest: each kernel in its branches and identities, each path end
to end against the fp64 oracle (python -m pytest --noconftest
tests/test_torch_cuda.py [-k NAME]).  Phases, each printing its lines (an
error exits non-zero without the final line):

  0. device: the card's name and power limit (exits without a CUDA card);
  1. build: nvcc compiles the kernels of pbmm_tpu_torch/csrc for sm_90a;
  4. timing with CUDA events after warm-up (medians):
     - each path's steady-state chunk (frames/s; pairs/s for (h)) and
       the kernels one chunk launches: f32 1080p (tight,
       `tuned_for_tpu()`), u8 1080p (planar uint8 in, planar and
       planar_u8 out), 540p f32 and u8 (the two-kernel tail), (a) 1080p
       square_pow2, (b) 1080p rgb + IIR uint8 -> planar_u8, (c) 720p
       rect_pow2 standard at 2.5, (d) 1080p steerable over overlapping
       bands with Re z, window compensation and YIQ gains, (e) the
       default `MagnifyConfig()`, (f) the tuned scan engine (and at 720p
       without the cached spectrum, with the IIR taps), (g) the unfused
       pallas backend, (h) `magnify_frame_pair`, (j) 2160p, (k) 1080p at
       blur radii 15 (f32 and u8) and 5, (l) 4320p, (m) 16K ((j), (l)
       and (m) square_pow2, tight and on the scan engine; (m) also on the
       pallas backend); (n) one call of each multi-device engine on a
       world of one over NCCL; (o) the mxu backend with its idle share
       (torch.profiler), its `magnify_frame_pair` and its two transforms
       alone beside torch.fft and their bound;
     - each case of `kernel_table` (a kernel at the shapes its path gives
       it, its branches, shapes and layouts; inputs made from seeds),
       held against its plain version, then timed warm (relaunched on the same inputs) and cold (a 128 MB write
       before each launch, outside the timing: its inputs out of L2) by
       the device's time alone (`tools.kexp.timed`: a spin of the card
       ahead of each event pair covers the host's enqueue), and with the
       host's enqueue inside one event pair (`ms_enqueued`), beside its
       plain version, its bound and its library call (one torch call
       that computes the same transform);
     - the designs' alternatives: kernel 6 on half its strip, kernel 3
       with 1, 2 and 4 region rows in flight at radii 2 and 5, kernel 3
       against kernel 7 + kernel 10 at radii 2-14;
     - (i) the measurement path through the tools: the roofline table at
       1080p, the copy probe's rows and strips of 2-32 columns beside
       `Tensor.copy_` (one frame and a 16-frame stack, GB/s warm and
       cold), kexp's experiments, kdecomp's six variants and kernel 6 at
       one frame and at 16, the CLI's `--demo bar --fast --trace` and
       `--debug-view split`;
     - the y4m stream's frames/s with the host's parse share, and (p)
       the .npy stream on the host clock: the native loader against the
       memmap, u8 and f32, each chunk source alone, and the loader's f32
       mode (the JAX package's contract: uint8 scaled on the host);
  5. with --profile only: torch.profiler over a few steady-state chunks
     of each path of phase 4 but the streams and the pair: each kernel's
     share of a chunk's device time and the idle share, profiler on.

The line before the last but one is one JSON object: the kernels'
records (each kernel's launches in one steady chunk of the path named
beside it, its times, its plain version's and its library call's, and
its bound: the larger of the bytes it must move over 3.35 TB/s and its
f32 operations over 67 TFLOP/s, the H100 SXM's published peaks, counted
from this run's shapes; its other cases under "variants"), the paths'
records and the launches by path.  Then the card's name and power
limit; the last line is {"ok": true, "device": {...}}.  The script
imports neither jax nor the JAX package.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
H, W, T = 1080, 1920, 16
H540, W540 = 540, 960  # a frame size outside post_pallas_ok
H720, W720 = 720, 1280  # rect_pow2 pads it to 1024 x 2048
H4K, W4K, T4K = 2160, 3840, 8  # square_pow2: 4096 x 4096; tight: 2176 rows
H8K, W8K, T8K = 4320, 7680, 2  # square_pow2: 8192 x 8192; tight: 4352 rows
H16, W16, T16 = 8640, 15360, 2  # 16K: 16384 x 16384; tight: 8704 rows
M_TOP = 63  # the four-step's largest m (m = 64 is 8192 rows: radix-2)
F4 = 4  # bytes of an f32
SPEC_TOL = 1e-4  # max error / max magnitude, spectra
IMG_TOL = 1e-4  # max abs error, images in [0, 1]
# Kernel 13's patterns: rows a block, and strips of columns.
COPY_PATTERNS = (("rows", 1), ("rows", 64), ("lanes", 2), ("lanes", 4),
                 ("lanes", 8), ("lanes", 16), ("lanes", 32))


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


def fft_ops(n, count):
    """f32 operations of `count` complex radix-2 transforms of length n."""
    return 5.0 * n * np.log2(n) * count


def profile_chunks(torch, chunk, card, what, n=5, top=12, tag="[5]"):
    """Device time per chunk by kernel, and the idle share, from
    torch.profiler over `n` chunks (wall time from CUDA events).  Returns
    (wall ms, device busy ms) a chunk, or None without device time."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return float(v if v is not None else e.self_cuda_time_total)

    chunk()
    torch.cuda.synchronize()
    # A torch.profiler session now and then records no device event at
    # all: up to three sessions, the first with device time counts.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                chunk()
            b.record()
            torch.cuda.synchronize()
        wall_ms = a.elapsed_time(b) / n
        # The port's `pbmm.*` stage ranges (utils/profiling.py) show on the
        # device timeline too, spanning the kernels they hold: they are not
        # device work of their own.
        kernels = sorted(
            (e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.key.startswith("pbmm.")),
            key=dev_us, reverse=True)
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
        if busy_ms:
            break
    if busy_ms == 0:
        log(f"{tag} {what}: torch.profiler recorded no device time: shares "
            "not measured")
        return None
    log(f"{tag} {card}: {what}, per chunk (phase 4's length), mean of {n}: "
        f"wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{100 * (1 - busy_ms / wall_ms):.1f} % (profiler on)")
    for e in kernels[:top]:
        ms = dev_us(e) / 1e3 / n
        log(f"{tag}   {100 * ms / busy_ms:5.1f} %  {ms:.3f} ms  "
            f"{e.count / n:g} launches  {e.key[:100]}")
    return wall_ms, busy_ms


# -- 0. device ----------------------------------------------------------------

def phase_device(torch):
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[0] device: {kind}; nvidia-smi name, power limit: {card}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return kind, card


# -- 1. build -----------------------------------------------------------------

def phase_build():
    from pbmm_tpu_torch.kernels.build import build, library

    t0 = time.perf_counter()
    build(verbose=True)
    library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s")


# -- 4. timing ----------------------------------------------------------------

def clips(torch, dev):
    """The paths' clips on the card (the card suite's, `tests/card_clips.py`),
    their configs and names."""
    import pbmm_tpu_torch
    from pbmm_tpu_torch import TemporalConfig

    sys.path.insert(0, str(ROOT / "tests"))
    from card_clips import clip

    iir = TemporalConfig(mode="iir_bandpass")
    c = SimpleNamespace()
    # f32 1080p, the bench clip (the JAX bench's main path), and its uint8
    # planar codes; 540p as f32 and planar uint8; shifted noise at 2160p,
    # 4320p and 16K; the oscillating bar (the branches that rotate by atan2
    # want it: on random spectra some bins sit at atan2's branch cut) at
    # 1080p as planar uint8 codes and as f32 interleaved, and at 720p.
    c.frames = clip("noise")
    for attr, name in (("frames_d", "noise"), ("u8_d", "noise_u8"),
                       ("f540_d", "540p"), ("u8_540_d", "540p_u8"),
                       ("frames4k_d", "noise4k"), ("frames8k_d", "noise8k"),
                       ("frames16_d", "noise16k"), ("bar_d", "bar_u8"),
                       ("bar_il_d", "bar"), ("bar720_d", "bar720")):
        setattr(c, attr, torch.from_numpy(clip(name)).to(dev))
    clip.cache_clear()
    # The configs of the paths.
    c.cfg_j = pbmm_tpu_torch.MagnifyConfig().tuned_for_tpu()
    c.cfg = c.cfg_j.replace(pad_mode="tight")
    c.cfg_sq = c.cfg.replace(pad_mode="square_pow2")
    c.cfg_pl = c.cfg.replace(output_layout="planar")
    c.cfg_u8 = c.cfg.replace(output_layout="planar_u8")
    c.cfg_rgb = c.cfg.replace(chroma="rgb", output_layout="planar_u8",
                              temporal=iir)
    c.cfg_std = c.cfg.replace(pad_mode="rect_pow2", mode="standard",
                              phase_scale=2.5)
    c.cfg_str = c.cfg.replace(orientations=4, pyramid_levels=6,
                              reconstruct="real", compensate_window=True,
                              apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8))
    c.cfg_b15, c.cfg_b40, c.cfg_b45 = (c.cfg.replace(blur_size=b)
                                       for b in (1.5, 4.0, 4.5))
    c.cfg_e = pbmm_tpu_torch.MagnifyConfig()
    c.cfg_f = c.cfg_sq.replace(engine="scan")
    c.cfg_fi = c.cfg.replace(pad_mode="rect_pow2", cache_prev_spectrum=False,
                             temporal=iir)
    c.cfg_g = pbmm_tpu_torch.MagnifyConfig(fft_backend="pallas",
                                           use_rfft=False, use_pallas=True)
    c.cfg_o = pbmm_tpu_torch.MagnifyConfig(fft_backend="mxu")
    return c


def kernel_table(torch, dev, c):
    """The table of kernel cases at the shapes their paths give them
    (`cases`: name -> case; a kernel's main call first, then its other
    branches, shapes and layouts as "name[...]"), and the inputs the
    designs' alternatives read."""
    from pbmm_tpu_torch.core.color import RGB_TO_YIQ
    from pbmm_tpu_torch.core.complexop import split
    from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
    from pbmm_tpu_torch.engine import post_fused
    from pbmm_tpu_torch.engine.pipeline import (
        blur_row_window,
        preprocess,
        preprocess_cl,
    )
    from pbmm_tpu_torch.phase import fused_kernels
    from pbmm_tpu_torch.pyramid.filters import freq_axes
    from pbmm_tpu_torch.spectral import fused, radix2
    from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width
    from pbmm_tpu_torch.tools import kdecomp, kexp, trig_probe

    t = SimpleNamespace()
    cfg, cfg_sq, cfg_rgb, cfg_str, cfg_j = (c.cfg, c.cfg_sq, c.cfg_rgb,
                                            c.cfg_str, c.cfg_j)
    cfg_b15, cfg_b40, cfg_b45 = c.cfg_b15, c.cfg_b40, c.cfg_b45
    t.cfg, t.cfg_b15 = cfg, cfg_b15
    geom = t.geom = geometry_for(H, W, "tight")
    rows = t.rows = blur_row_window(geom, cfg)
    wk = t.wk = hermitian_kept_width(geom.pad_w)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(1234)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def dev_u8(shape):
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def dev_n(shape, scale=1.0):  # f32 normals, made in f32 on the host
        return dev_t(scale * rng.standard_normal(shape, dtype=np.float32))

    def case(fn, *a, work=None, lib=None, **k):
        """One case: the wrapper and its arguments, what the call must
        move and compute (`work`: bytes, f32 operations) and the library
        call beside it (`lib`)."""
        return SimpleNamespace(fn=fn, args=a, kwargs=k, work=work, lib=lib)

    y = dev_t(rng.random((T, geom.pad_h, geom.pad_w)))
    rows_re = dev_t(rng.standard_normal((T, geom.pad_h, wk)))
    rows_im = dev_t(rng.standard_normal((T, geom.pad_h, wk)))
    prev_re = dev_t(rng.standard_normal((1, geom.pad_h, wk)))
    prev_im = dev_t(rng.standard_normal((1, geom.pad_h, wk)))
    scale = 0.3 * geom.pad_h * geom.pad_w / np.sqrt(geom.pad_w)
    rre = t.rre = dev_t(scale * rng.standard_normal((T, hr, wk)))
    rim = t.rim = dev_t(scale * rng.standard_normal((T, hr, wk)))
    i_pl = t.i_pl = dev_t(rng.uniform(-0.6, 0.6, (T, H, W)))
    q_pl = t.q_pl = dev_t(rng.uniform(-0.5, 0.5, (T, H, W)))
    win = t.win = hann2d_region(geom, device=dev)
    u8_frames = dev_u8((T, 3, H, W))
    luma = tuple(float(v) for v in RGB_TO_YIQ[0])
    r0, _ = fused.aligned_row_window(geom.y0, geom.y0 + H, geom.pad_h)
    u8_args = (u8_frames, luma, geom.pad_h, geom.pad_w, geom.y0, geom.x0,
               r0, True)
    # The front end's inputs at 1080p: the main path's f32 interleaved
    # frames, and the other input forms (their own seed).
    rng_fe = np.random.default_rng(15)
    fe_f32 = dev_t(rng_fe.random((T, H, W, 3), np.float32))
    fe_u8 = torch.from_numpy(rng_fe.integers(0, 256, (T, H, W, 3),
                                             dtype=np.uint8)).to(dev)
    fe_planar = fe_f32.permute(0, 3, 1, 2).contiguous()
    rows3 = tuple(tuple(float(v) for v in r) for r in RGB_TO_YIQ)
    fe_geo = (geom.pad_h, geom.pad_w, geom.y0, geom.x0, r0, True)
    g540 = geometry_for(H540, W540, "tight")
    rows540 = blur_row_window(g540, cfg)
    hr540, wk540 = rows540[1] - rows540[0], hermitian_kept_width(g540.pad_w)
    s540 = 0.3 * g540.pad_h * g540.pad_w / np.sqrt(g540.pad_w)
    rre540 = dev_t(s540 * rng.standard_normal((T, hr540, wk540)))
    rim540 = dev_t(s540 * rng.standard_normal((T, hr540, wk540)))
    post_args = (rre, rim, i_pl, q_pl, win, cfg, rows[0], H, W, "tight")
    post_u8_args = (rre, rim, None, None, win, cfg, rows[0], H, W, "tight")

    # The config matrix's shapes: (a) square_pow2, (b) rgb + IIR, (c) 720p
    # rect_pow2 standard, (d) steerable with the quirks.
    g_sq = t.g_sq = geometry_for(H, W, "square_pow2")
    r0_sq, r1_sq = fused.aligned_row_window(g_sq.y0, g_sq.y0 + H, g_sq.pad_h)
    rows_sq = blur_row_window(g_sq, cfg_sq)
    hr_sq = rows_sq[1] - rows_sq[0]
    sq_re, sq_im = (dev_t(rng.standard_normal((T, r1_sq - r0_sq, wk)))
                    for _ in range(2))
    sq_prev = [dev_t(rng.standard_normal((1, g_sq.pad_h, wk)))
               for _ in range(2)]
    g720 = geometry_for(H720, W720, "rect_pow2")
    r0_720, _ = fused.aligned_row_window(g720.y0, g720.y0 + H720, g720.pad_h)
    rows720 = blur_row_window(g720, c.cfg_std)
    # The branches that rotate by atan2 (IIR, standard, a non-integer
    # scale) take row spectra of the oscillating bar.
    rgb_rows = preprocess_cl(c.bar_d, cfg_rgb)[:2]
    rgb_state = [torch.zeros((3, geom.pad_h, wk), device=dev)
                 for _ in range(4)]
    std_re, std_im = preprocess_cl(c.bar720_d, c.cfg_std)[:2]
    std_prev = [torch.zeros((1, g720.pad_h, wk), device=dev)
                for _ in range(2)]
    bar_rows = preprocess_cl(c.bar_il_d, cfg)[:2]
    rec3 = dev_t(rng.uniform(-0.2, 0.9, (3 * T, hr, geom.pad_w)))
    rre3, rim3 = (dev_t(scale * rng.standard_normal((3 * T, hr, wk)))
                  for _ in range(2))
    rgb_post_args = (rec3, win, cfg_rgb, rows[0], H, W, "tight")
    quirk_post_args = (rre, rim, i_pl, q_pl, win, cfg_str, rows[0], H, W,
                       "tight")

    # The scan engine's and the unfused backends' kernel inputs (kernels
    # 6, 8, 9, 10), at the shapes paths (f)-(h) give them: whole spectra
    # of two 1080p bar frames from kernels 1 and 5.
    def spectra(frame, cf):
        return split(preprocess(frame, cf)[0])

    cfg_f, cfg_fi, cfg_g = c.cfg_f, c.cfg_fi, c.cfg_g
    k6_cur, k6_prev = (spectra(c.bar_il_d[i], cfg_f) for i in (1, 0))
    k6i_cur, k6i_prev = (spectra(c.bar720_d[i], cfg_fi) for i in (1, 0))
    k6i_taps = [0.1 * dev_t(rng.standard_normal(tuple(k6i_cur[0].shape)))
                for _ in range(2)]
    cfg_full = cfg_sq.replace(use_hermitian_spectral=False)
    k6f_cur, k6f_prev = (spectra(c.bar_il_d[i], cfg_full) for i in (1, 0))
    k6_kw = dict(out_rows=rows_sq, full_w=g_sq.pad_w)
    k8_re, k8_im = (dev_t(rng.standard_normal((1, g_sq.pad_h, g_sq.pad_w)))
                    for _ in range(2))
    k9_cur, k9_prev = (spectra(c.bar_il_d[i], cfg_g) for i in (1, 0))
    k9c_cur, k9c_prev = (spectra(c.bar_il_d[i],
                                 c.cfg_e.replace(use_rfft=False))
                         for i in (1, 0))
    fyb, fxb = freq_axes(g_sq.pad_h, g_sq.pad_w, "bitrev2d", dev)
    fyc, fxc = freq_axes(g_sq.pad_h, g_sq.pad_w, "centered", dev)
    axes_b = (fyb[:, 0].contiguous(), fxb[0].contiguous())
    axes_c = (fyc[:, 0].contiguous(), fxc[0].contiguous())

    def k9_args(cf):
        return (cf.pyramid_levels, cf.min_frequency, cf.max_frequency,
                cf.phase_scale, cf.magnitude_threshold, cf.orientations)

    rec1 = rec3[0::3].contiguous()  # (T, Hr, W) Y rows for kernel 10
    yonly_post_args = (rec1, i_pl, q_pl, win, cfg, rows[0], H, W, "tight")

    # Blur radii 5, 13 and 15 (blur_size 1.5, 4.0 and 4.5) share the
    # 1080p region rows of radius 2.
    assert all(blur_row_window(geom, cf) == rows
               for cf in (cfg_b15, cfg_b40, cfg_b45))
    # 2160p: square_pow2 (H = 4096, kernel 5's two passes, kernels 2 and 6
    # on strips of 4 and 2) and tight (H = 2176, four-step m = 17), a chunk
    # of 8.
    g4k = geometry_for(H4K, W4K, "square_pow2")
    g4t = geometry_for(H4K, W4K, "tight")
    wk4 = hermitian_kept_width(g4k.pad_w)
    r0_4k, r1_4k = fused.aligned_row_window(g4k.y0, g4k.y0 + H4K, g4k.pad_h)
    rows_4k = blur_row_window(g4k, cfg_j)
    rows_4t = blur_row_window(g4t, cfg)
    r0_4t, r1_4t = fused.aligned_row_window(g4t.y0, g4t.y0 + H4K, g4t.pad_h)
    k4_re, k4_im = (dev_t(rng.standard_normal((T4K, r1_4k - r0_4k, wk4)))
                    for _ in range(2))
    k4_prev = [dev_t(rng.standard_normal((1, g4k.pad_h, wk4)))
               for _ in range(2)]
    k4_next = [dev_t(rng.standard_normal((1, g4k.pad_h, wk4)))
               for _ in range(2)]
    t4_re, t4_im = (dev_t(rng.standard_normal((T4K, r1_4t - r0_4t, wk4)))
                    for _ in range(2))
    t4_prev = [dev_t(rng.standard_normal((1, g4t.pad_h, wk4)))
               for _ in range(2)]
    k4_kw = dict(out_rows=rows_4k, full_w=g4k.pad_w)
    # 4320p: square_pow2 (H = 8192: kernel 5's three passes, kernels 2 and
    # 6 on strips of 2, kernel 12 on strips of 1) and tight (H = 4352, the
    # four-step at m = 34, its combine matrix in device memory), a chunk of
    # 2 at 4320p's 4224 kept lanes; and the four-step's largest m, 63
    # (8064 rows).
    g8k = geometry_for(H8K, W8K, "square_pow2")
    g8t = geometry_for(H8K, W8K, "tight")
    wk8 = hermitian_kept_width(g8k.pad_w)
    r0_8k, r1_8k = fused.aligned_row_window(g8k.y0, g8k.y0 + H8K, g8k.pad_h)
    rows_8k = blur_row_window(g8k, cfg_j)
    rows_8t = blur_row_window(g8t, cfg)
    r0_8t, r1_8t = fused.aligned_row_window(g8t.y0, g8t.y0 + H8K, g8t.pad_h)
    k8k_re, k8k_im = (dev_t(rng.standard_normal((T8K, r1_8k - r0_8k, wk8)))
                      for _ in range(2))
    k8k_prev = [dev_t(rng.standard_normal((1, g8k.pad_h, wk8)))
                for _ in range(2)]
    k8k_next = [dev_t(rng.standard_normal((1, g8k.pad_h, wk8)))
                for _ in range(2)]
    t8_re, t8_im = (dev_t(rng.standard_normal((T8K, r1_8t - r0_8t, wk8)))
                    for _ in range(2))
    t8_prev = [dev_t(rng.standard_normal((1, g8t.pad_h, wk8)))
               for _ in range(2)]
    h63 = M_TOP * 128
    rows_63 = (32, h63 - 32)
    t63_re, t63_im = (dev_t(rng.standard_normal((T8K, h63 - 64, wk8)))
                      for _ in range(2))
    t63_prev = [dev_t(rng.standard_normal((1, h63, wk8))) for _ in range(2)]
    k8_kw = dict(out_rows=rows_8k, full_w=g8k.pad_w)
    # Kernel 8's row pass at 8192 points on as many elements as at 2048.
    k8w_re, k8w_im = (dev_t(rng.standard_normal((1, 512, 8192)))
                      for _ in range(2))
    # 16K (15360x8640), path (m)'s shapes: square_pow2 pads to 16384 x
    # 16384 (the bracket passes: kernels 1, 4, 7 and 8's rows of 16384
    # lanes, kernels 2, 5, 6, 12 and 8's columns of 16384 rows), tight to
    # 8704 rows (m = 68: kernel 2's combine pass), chunks of 2; the tail
    # takes kernels 7 + 10 (11 with rgb) on 15360-column crops.
    g16 = geometry_for(H16, W16, "square_pow2")
    g16t = geometry_for(H16, W16, "tight")
    wk16 = hermitian_kept_width(g16.pad_w)
    r0_16, r1_16 = fused.aligned_row_window(g16.y0, g16.y0 + H16, g16.pad_h)
    r0_16t, r1_16t = fused.aligned_row_window(g16t.y0, g16t.y0 + H16,
                                              g16t.pad_h)
    rows_16 = blur_row_window(g16, cfg_j)
    rows_16t = blur_row_window(g16t, cfg)
    hr16 = rows_16[1] - rows_16[0]
    k16_re, k16_im = (dev_n((T16, r1_16 - r0_16, wk16)) for _ in range(2))
    k16_prev = [dev_n((1, g16.pad_h, wk16)) for _ in range(2)]
    k16_next = [dev_n((1, g16.pad_h, wk16)) for _ in range(2)]
    t16_re, t16_im = (dev_n((T16, r1_16t - r0_16t, wk16)) for _ in range(2))
    t16_prev = [dev_n((1, g16t.pad_h, wk16)) for _ in range(2)]
    k16_kw = dict(out_rows=rows_16, full_w=g16.pad_w)
    y16 = dev_t(rng.random((T16, r1_16 - r0_16, g16.pad_w), np.float32))
    s16 = 0.3 * g16.pad_h * np.sqrt(g16.pad_w)
    rre16, rim16 = (dev_n((T16, hr16, wk16), s16) for _ in range(2))
    u8_16 = dev_u8((T16, 3, H16, W16))
    u8_args16 = (u8_16, luma, g16.pad_h, g16.pad_w, g16.y0, g16.x0, r0_16,
                 True)
    win16 = hann2d_region(g16, device=dev)
    rec16_1 = dev_t(rng.random((T16, hr16, g16.pad_w), np.float32))
    k8x_re, k8x_im = (dev_n((1, g16.pad_h, g16.pad_w)) for _ in range(2))
    fyb16, fxb16 = freq_axes(g16.pad_h, g16.pad_w, "bitrev2d", dev)
    axes_b16 = (fyb16[:, 0].contiguous(), fxb16[0].contiguous())
    # Kernel 9 at (m) (g)'s call: the whole spectra of path (m)'s frames 1
    # and 0.
    k9x_cur, k9x_prev = (spectra(c.frames16_d[i], cfg_g) for i in (1, 0))

    # The measurement path's kernels (12-14) at the tools' shapes:
    # kdecomp's four (1, 2048, 1152) planes and rows, kexp's copy planes
    # (1, 1152, 2048) and a 16-frame stack, the trig probe's planes.
    kd_rows, kd_fw = (384, 1600), g_sq.pad_w
    kd = kdecomp.kdecomp_inputs(dev)
    rng_m = np.random.default_rng(5)
    cp1, cp16 = ([torch.from_numpy(rng_m.random(kexp.copy_shape(n),
                                                np.float32)).to(dev)
                  for _ in range(2)] for n in (1, 16))
    tp_in = [torch.from_numpy(a).to(dev)
             for a in trig_probe.probe_inputs(0)["atan2"].values()]

    # What each call must move and compute, for its bound (`work`): bytes,
    # each input read once and each output written once; f32 operations,
    # 5 n log2 n per complex radix-2 transform of length n and per element
    # of the other stages a count of their multiplies and adds (the phase
    # pass ~40, a mask level ~15, the separable blur 4 r + 1 products and
    # sums a pixel and plane each way, the post epilogue ~20), so the
    # bound is a floor.  `lib`: the one torch call that computes the same
    # transform (FFT kernels and the probes).
    n_sq = g_sq.pad_h * g_sq.pad_w
    hc_sq = r1_sq - r0_sq
    u8_r0, u8_r1 = fused.aligned_row_window(geom.y0, geom.y0 + H, geom.pad_h)
    u8_rows = T * (u8_r1 - u8_r0)
    hr8k, hr8t = rows_8k[1] - rows_8k[0], rows_8t[1] - rows_8t[0]
    n8k = 8192 * 512

    def post_work(kernel, cf, u8=False, layout="tuple3"):
        """(bytes, f32 operations) of one call of post kernel 3, 10 or 11
        at the 1080p shapes under config cf: the region rows the output
        needs (the crop's H + 2 r rows; kernel 3: all kept lanes of each,
        its row transform's input; 10 and 11: the W + 2 r columns the
        blur reads), the chroma (f32 I/Q, the uint8 frames (u8 True) or
        the f32 frames (u8 "f32"); none for 11), the window where the
        call reads it and the three output
        planes; the blur 2 (4 r + 1) a pixel and plane (2 r + 1 products
        and 2 r sums each way), the epilogue 20, kernel 3's row transform
        5 W log2 W a region row."""
        px, r = T * H * W, post_fused._radius(cf)
        planes = 3 if kernel == 11 else 1
        rows_in = (2 * T * (H + 2 * r) * wk if kernel == 3
                   else planes * T * (H + 2 * r) * (W + 2 * r))
        chroma = (0 if kernel == 11 else 3 * F4 * px if u8 == "f32"
                  else 3 * px if u8 else 2 * F4 * px)
        window = 0 if kernel == 11 and not cf.compensate_window else H * W
        out = 3 * px * (1 if layout == "planar_u8" else F4)
        ops = (2 * (4 * r + 1) * planes + 20) * px
        if kernel == 3:
            ops += fft_ops(geom.pad_w, T * (H + 2 * r))
        return F4 * (rows_in + window) + chroma + out, ops

    def colspec_work(rows_t, prev_t, n_rows, h, hr_, wk_, taps=False):
        """Kernel 2: the content rows in, the output rows out, the state
        (prev, with the IIR taps) in and out; the column transforms both
        ways and the phase pass."""
        state = (4 if taps else 2) * prev_t.numel()
        return (F4 * (2 * rows_t.numel() + 2 * state + 2 * n_rows * hr_ * wk_),
                fft_ops(h, 2 * n_rows * wk_) + 40 * n_rows * h * wk_)

    def col_work(rows_t, h, wk_):
        """Kernel 5 on one frame: its content rows in, the column out."""
        return (2 * F4 * (rows_t.shape[1] * wk_ + h * wk_), fft_ops(h, wk_))

    def phase_work(cur, h, hr_, wk_):
        """Kernel 6 on one frame: four planes and two host planes in, the
        output rows out."""
        return (F4 * (6 * cur.numel() + 2 * hr_ * wk_),
                fft_ops(h, wk_) + 40 * h * wk_)

    def axis_work(x, n, count, planes):
        """Kernel 8: `planes` planes of x's size read and written."""
        return F4 * planes * x.numel(), fft_ops(n, count)

    kd_work = (F4 * (4 * kd[0].numel() + 2 * (kd_rows[1] - kd_rows[0]) * wk),
               fft_ops(g_sq.pad_h, wk) + 40 * g_sq.pad_h * wk)
    irfft_in = torch.complex(rre[..., :geom.pad_w // 2 + 1].contiguous(),
                             rim[..., :geom.pad_w // 2 + 1].contiguous())
    col_in = torch.complex(sq_prev[0], sq_prev[1])
    fft_in = torch.complex(k8_re, k8_im)
    fft_in8 = torch.complex(k8w_re, k8w_im)
    kd_in = torch.complex(kd[0], kd[1])
    cp_pairs = {n: torch.stack(cp) for n, cp in ((1, cp1), (16, cp16))}
    cp_dsts = {n: torch.empty_like(cp) for n, cp in cp_pairs.items()}
    fft16 = torch.complex(k8x_re, k8x_im)
    col16 = torch.complex(k16_prev[0], k16_prev[1])
    irfft16 = torch.complex(rre16[..., :g16.pad_w // 2 + 1].contiguous(),
                            rim16[..., :g16.pad_w // 2 + 1].contiguous())

    t.cases = {
        # One call a kernel at its main path's shapes.
        "windowed_row_fft": case(
            fused.windowed_row_fft, y, geom.pad_h, 0, True,
            work=(F4 * y.numel() + 2 * F4 * T * geom.pad_h * wk,
                  fft_ops(geom.pad_w, T * geom.pad_h) + 2 * y.numel()),
            lib=lambda: torch.fft.fft(y, dim=-1)),
        "colspec_chunk": case(
            fused.colspec_chunk, rows_re, rows_im, prev_re, prev_im, cfg,
            geom.pad_h, 0, out_rows=rows, full_w=geom.pad_w,
            work=(F4 * (2 * rows_re.numel() + 4 * prev_re.numel()
                        + 2 * T * hr * wk),
                  fft_ops(geom.pad_h, 2 * T * wk)
                  + 40 * T * geom.pad_h * wk)),
        "rowifft_post_fused": case(
            post_fused.rowifft_post_fused, *post_args, full_w=geom.pad_w,
            work=post_work(3, cfg)),
        "windowed_row_fft_u8planar": case(
            fused.windowed_row_fft_u8planar, *u8_args,
            work=(u8_frames.numel() + 2 * F4 * u8_rows * wk,
                  fft_ops(geom.pad_w, u8_rows) + 8 * T * H * W),
            lib=lambda: torch.fft.fft(y[:, u8_r0:u8_r1], dim=-1)),
        # the frames read once, the kept spectrum written; the plane's 5
        # products and sums and the window's 2 a pixel
        "windowed_row_fft_frames": case(
            fused.windowed_row_fft_frames, fe_f32, rows3[:1], *fe_geo,
            work=(F4 * fe_f32.numel() + 2 * F4 * u8_rows * wk,
                  fft_ops(geom.pad_w, u8_rows) + 7 * T * H * W),
            lib=lambda: torch.fft.fft(y[:, u8_r0:u8_r1], dim=-1)),
        "row_ifft_magnitude": case(
            fused.row_ifft_magnitude, rre, rim, pad_h=geom.pad_h,
            full_w=geom.pad_w,
            work=(F4 * (2 * rre.numel() + T * hr * geom.pad_w),
                  fft_ops(geom.pad_w, T * hr) + 3 * T * hr * geom.pad_w),
            lib=lambda: torch.fft.irfft(irfft_in, n=geom.pad_w, dim=-1)),
        "col_fft_zero_padded": case(
            fused.col_fft_zero_padded, sq_re[:1], sq_im[:1], g_sq.pad_h,
            r0_sq, work=(2 * F4 * (hc_sq * wk + g_sq.pad_h * wk),
                         fft_ops(g_sq.pad_h, wk)),
            lib=lambda: torch.fft.fft(col_in, dim=-2)),
        "post_fused_rgb": case(
            post_fused.post_fused_rgb, *rgb_post_args, out_layout="planar_u8",
            work=post_work(11, cfg_rgb, layout="planar_u8")),
        "phase_col_ifft": case(  # + the two host planes of the main branch
            fused.phase_col_ifft, *k6_cur, *k6_prev, cfg_f, **k6_kw,
            work=phase_work(k6_cur[0], g_sq.pad_h, hr_sq, wk)),
        "_fft_axis": case(
            radix2._fft_axis, k8_re, k8_im, 1, True, 1.0,
            work=(F4 * 4 * n_sq, fft_ops(g_sq.pad_h, g_sq.pad_w)),
            lib=lambda: torch.fft.ifft(fft_in, dim=-2)),
        "amplify_procedural": case(
            fused_kernels.amplify_procedural, *k9_cur, *k9_prev, *axes_b,
            *k9_args(cfg_g),
            work=(F4 * (6 * n_sq + g_sq.pad_h + g_sq.pad_w),
                  (15 * cfg_g.pyramid_levels + 40) * n_sq)),
        "post_fused": case(post_fused.post_fused, *yonly_post_args,
                           work=post_work(10, cfg)),
        "kdecomp_variant": case(
            kdecomp.kdecomp_variant, *kd, cfg_j, kdecomp.VARIANTS[-1][1],
            kd_rows, full_w=kd_fw, work=kd_work,
            lib=lambda: torch.fft.ifft(kd_in, dim=-2)),
        "copy_probe": case(
            kexp.copy_probe, *cp1, "rows", 1,
            work=(2 * 2 * F4 * cp1[0].numel(), 0),
            lib=lambda: cp_dsts[1].copy_(cp_pairs[1])),
        "trig_probe": case(
            trig_probe.trig_probe, "atan2", *tp_in,
            work=(3 * F4 * tp_in[0].numel(), 20 * tp_in[0].numel()),
            lib=lambda: torch.atan2(*tp_in)),
        # The front end's other input forms, and the tail's source chroma
        # and interleaved layout at the main path's call.
        "windowed_row_fft_frames[u8 interleaved]": case(
            fused.windowed_row_fft_frames, fe_u8, rows3[:1], *fe_geo,
            work=(fe_u8.numel() + 2 * F4 * u8_rows * wk,
                  fft_ops(geom.pad_w, u8_rows) + 8 * T * H * W)),
        "windowed_row_fft_frames[f32 planar]": case(
            fused.windowed_row_fft_frames, fe_planar, rows3[:1], *fe_geo,
            work=(F4 * fe_planar.numel() + 2 * F4 * u8_rows * wk,
                  fft_ops(geom.pad_w, u8_rows) + 7 * T * H * W)),
        "windowed_row_fft_frames[rgb 3 planes]": case(
            fused.windowed_row_fft_frames, fe_f32, rows3, *fe_geo,
            work=(F4 * fe_f32.numel() + 3 * 2 * F4 * u8_rows * wk,
                  3 * (fft_ops(geom.pad_w, u8_rows) + 7 * T * H * W))),
        "rowifft_post_fused[f32 frames, interleaved]": case(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=fe_f32, out_layout="interleaved",
            work=post_work(3, cfg, "f32", "interleaved")),
        "rowifft_post_fused[u8 frames, interleaved]": case(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=fe_u8, out_layout="interleaved",
            work=post_work(3, cfg, True, "interleaved")),
        "post_fused_rgb[interleaved]": case(
            post_fused.post_fused_rgb, *rgb_post_args,
            out_layout="interleaved",
            work=post_work(11, cfg_rgb, False, "interleaved")),
        "rowifft_post_fused[u8, planar_u8]": case(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8",
            work=post_work(3, cfg, True, "planar_u8")),
        "rowifft_post_fused[f32, planar]": case(
            post_fused.rowifft_post_fused, *post_args, full_w=geom.pad_w,
            out_layout="planar", work=post_work(3, cfg, False, "planar")),
        "row_ifft_magnitude[540p]": case(
            fused.row_ifft_magnitude, rre540, rim540, pad_h=g540.pad_h,
            full_w=g540.pad_w),
        # The config matrix's branches, at their paths' shapes.
        "colspec_chunk[pow-2, square_pow2 1080p]": case(
            fused.colspec_chunk, sq_re, sq_im, *sq_prev, cfg_sq, g_sq.pad_h,
            r0_sq, out_rows=rows_sq, full_w=g_sq.pad_w),
        "colspec_chunk[rgb 3 planes, IIR]": case(
            fused.colspec_chunk, *rgb_rows, *rgb_state[:2], cfg_rgb,
            geom.pad_h, 0, *rgb_state[2:], out_rows=rows, full_w=geom.pad_w,
            planes=3, work=colspec_work(rgb_rows[0], rgb_state[0], 3 * T,
                                        geom.pad_h, hr, wk, True)),
        "colspec_chunk[standard, 2.5, rect_pow2 720p]": case(
            fused.colspec_chunk, std_re, std_im, *std_prev, c.cfg_std,
            g720.pad_h, r0_720, out_rows=rows720, full_w=g720.pad_w),
        "colspec_chunk[steerable 4, overlapping bands]": case(
            fused.colspec_chunk, rows_re, rows_im, prev_re, prev_im, cfg_str,
            geom.pad_h, 0, out_rows=rows, full_w=geom.pad_w),
        "colspec_chunk[pyramid, 2.5]": case(
            fused.colspec_chunk, *bar_rows, rgb_state[0][:1],
            rgb_state[1][:1], cfg.replace(phase_scale=2.5), geom.pad_h, 0,
            out_rows=rows, full_w=geom.pad_w),
        "row_ifft_magnitude[Re z, 1080p rgb]": case(
            fused.row_ifft_magnitude, rre3, rim3, magnitude=False,
            pad_h=geom.pad_h, full_w=geom.pad_w),
        "rowifft_post_fused[real, compensate, gains]": case(
            post_fused.rowifft_post_fused, *quirk_post_args,
            full_w=geom.pad_w, work=post_work(3, cfg_str)),
        "post_fused_rgb[tuple3, compensate, gains]": case(
            post_fused.post_fused_rgb, rec3, win,
            cfg_str.replace(chroma="rgb"), rows[0], H, W, "tight",
            work=post_work(11, cfg_str.replace(chroma="rgb"))),
        # The scan engine's and the unfused backends' branches.
        "phase_col_ifft[IIR taps, 720p rect_pow2]": case(
            fused.phase_col_ifft, *k6i_cur, *k6i_prev, cfg_fi,
            out_rows=blur_row_window(g720, cfg_fi), full_w=g720.pad_w,
            lp_fast=k6i_taps[0], lp_slow=k6i_taps[1]),
        "phase_col_ifft[standard]": case(
            fused.phase_col_ifft, *k6_cur, *k6_prev,
            cfg_f.replace(mode="standard"), **k6_kw),
        "phase_col_ifft[steerable 4, overlapping bands]": case(
            fused.phase_col_ifft, *k6_cur, *k6_prev,
            cfg_f.replace(orientations=4, pyramid_levels=6), **k6_kw),
        "phase_col_ifft[full lanes]": case(
            fused.phase_col_ifft, *k6f_cur, *k6f_prev, cfg_full, **k6_kw),
        # Kernel 8's row pass (the row engine) beside one torch.fft call
        # along the rows, at 2048 points; its column pass.
        "_fft_axis[inverse, axis 2, scale]": case(
            radix2._fft_axis, k8_re, k8_im, 2, True,
            1.0 / (g_sq.pad_h * g_sq.pad_w),
            work=axis_work(k8_re, g_sq.pad_w, g_sq.pad_h, 4),
            lib=lambda: torch.fft.ifft(fft_in, dim=-1)),
        "_fft_axis[forward real, axis 2]": case(
            radix2._fft_axis, k8_re, None, 2, False,
            work=axis_work(k8_re, g_sq.pad_w, g_sq.pad_h, 3),
            lib=lambda: torch.fft.fft(k8_re, dim=-1)),
        "_fft_axis[forward real, axis 1]": case(
            radix2._fft_axis, k8_re, None, 1, False),
        "_fft_axis[forward complex, axis 1]": case(
            radix2._fft_axis, k8_re, k8_im, 1, False),
        "_fft_axis[forward complex, axis 2]": case(
            radix2._fft_axis, k8_re, k8_im, 2, False,
            work=axis_work(k8_re, g_sq.pad_w, g_sq.pad_h, 4),
            lib=lambda: torch.fft.fft(fft_in, dim=-1)),
        "amplify_procedural[centered]": case(
            fused_kernels.amplify_procedural, *k9c_cur, *k9c_prev, *axes_c,
            *k9_args(cfg_g)),
        "amplify_procedural[2.5]": case(
            fused_kernels.amplify_procedural, *k9_cur, *k9_prev, *axes_b,
            *k9_args(cfg_g.replace(phase_scale=2.5))),
        "amplify_procedural[steerable 4]": case(
            fused_kernels.amplify_procedural, *k9_cur, *k9_prev, *axes_b,
            *k9_args(cfg_g.replace(orientations=4))),
        "post_fused[planar_u8]": case(
            post_fused.post_fused, *yonly_post_args, out_layout="planar_u8",
            work=post_work(10, cfg, False, "planar_u8")),
        "post_fused[compensate, gains]": case(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_str, rows[0],
            H, W, "tight", work=post_work(10, cfg_str)),
        # Blur radii 5, 13 and 15 (kernels 3, 11, 10; kernel 3's route).
        "rowifft_post_fused[blur 1.5, radius 5]": case(
            post_fused.rowifft_post_fused, rre, rim, i_pl, q_pl, win,
            cfg_b15, rows[0], H, W, "tight", full_w=geom.pad_w,
            work=post_work(3, cfg_b15)),
        "rowifft_post_fused[blur 4.0, radius 13: kernels 7 + 10, u8, "
        "planar_u8]": case(
            post_fused.rowifft_post_fused, rre, rim, None, None, win,
            cfg_b40, rows[0], H, W, "tight", full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8",
            work=post_work(3, cfg_b40, True, "planar_u8")),
        "rowifft_post_fused[blur 4.5, radius 15: kernels 7 + 10, u8, "
        "planar_u8]": case(
            post_fused.rowifft_post_fused, rre, rim, None, None, win,
            cfg_b45, rows[0], H, W, "tight", full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8",
            work=post_work(3, cfg_b45, True, "planar_u8")),
        **{f"post_fused_rgb[blur {b}, radius {r}]": case(
            post_fused.post_fused_rgb, rec3, win,
            cfg_rgb.replace(blur_size=b), rows[0], H, W, "tight",
            out_layout="planar_u8",
            work=post_work(11, cfg_rgb.replace(blur_size=b), False,
                           "planar_u8"))
           for b, r in ((1.5, 5), (4.0, 13))},
        "post_fused[blur 4.0, radius 13, u8 chroma, planar_u8]": case(
            post_fused.post_fused, rec1, None, None, win, cfg_b40, rows[0],
            H, W, "tight", "planar_u8", src=u8_frames,
            work=post_work(10, cfg_b40, True, "planar_u8")),
        "post_fused[u8 chroma, planar_u8]": case(
            post_fused.post_fused, rec1, None, None, win, cfg, rows[0], H,
            W, "tight", "planar_u8", src=u8_frames,
            work=post_work(10, cfg, True, "planar_u8")),
        "post_fused[blur 1.5, radius 5]": case(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_b15, rows[0],
            H, W, "tight", work=post_work(10, cfg_b15)),
        # Path (k)'s calls: f32 frames (tuple3), u8 frames to planar_u8.
        "post_fused[blur 4.5, radius 15]": case(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_b45, rows[0],
            H, W, "tight", work=post_work(10, cfg_b45)),
        "post_fused[blur 4.5, radius 15, f32 frames, interleaved]": case(
            post_fused.post_fused, rec1, None, None, win, cfg_b45, rows[0],
            H, W, "tight", "interleaved", src=fe_f32,
            work=post_work(10, cfg_b45, "f32", "interleaved")),
        "post_fused[blur 4.5, radius 15, u8 chroma, planar_u8]": case(
            post_fused.post_fused, rec1, None, None, win, cfg_b45, rows[0],
            H, W, "tight", "planar_u8", src=u8_frames,
            work=post_work(10, cfg_b45, True, "planar_u8")),
        "post_fused_rgb[blur 4.5, radius 15]": case(
            post_fused.post_fused_rgb, rec3, win,
            cfg_rgb.replace(blur_size=4.5), rows[0], H, W, "tight",
            out_layout="planar_u8",
            work=post_work(11, cfg_rgb.replace(blur_size=4.5), False,
                           "planar_u8")),
        # 2160p: H = 4096 (kernel 2 on strips of 4; kernel 5's passes) and
        # m = 17.
        "colspec_chunk[pow-2, H 4096, 2160p square_pow2]": case(
            fused.colspec_chunk, k4_re, k4_im, *k4_prev, cfg_j, g4k.pad_h,
            r0_4k, **k4_kw),
        "colspec_chunk[tight m 17, 2160p]": case(
            fused.colspec_chunk, t4_re, t4_im, *t4_prev, cfg, g4t.pad_h,
            r0_4t, out_rows=rows_4t, full_w=g4t.pad_w),
        "col_fft_zero_padded[H 4096, 2160p]": case(
            fused.col_fft_zero_padded, k4_re[:1], k4_im[:1], g4k.pad_h,
            r0_4k),
        "phase_col_ifft[H 4096, 2160p]": case(
            fused.phase_col_ifft, *k4_next, *k4_prev, cfg_j, **k4_kw),
        "kdecomp_variant[phase + gm + rolls, H 4096]": case(
            kdecomp.kdecomp_variant, *k4_next, *k4_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_4k, full_w=g4k.pad_w),
        # 4320p: H = 8192 (kernels 2 and 6 on strips of 2, 12 on strips of
        # 1, kernel 5's three passes), tight m = 34 and m = 63.
        "colspec_chunk[pow-2, H 8192, 4320p square_pow2]": case(
            fused.colspec_chunk, k8k_re, k8k_im, *k8k_prev, cfg_j,
            g8k.pad_h, r0_8k, **k8_kw,
            work=colspec_work(k8k_re, k8k_prev[0], T8K, g8k.pad_h, hr8k,
                              wk8)),
        "colspec_chunk[tight m 34, 4320p]": case(
            fused.colspec_chunk, t8_re, t8_im, *t8_prev, cfg, g8t.pad_h,
            r0_8t, out_rows=rows_8t, full_w=g8t.pad_w,
            work=colspec_work(t8_re, t8_prev[0], T8K, g8t.pad_h, hr8t, wk8)),
        f"colspec_chunk[tight m {M_TOP}, {h63} rows]": case(
            fused.colspec_chunk, t63_re, t63_im, *t63_prev, cfg, h63, 32,
            out_rows=rows_63, full_w=g8k.pad_w,
            work=colspec_work(t63_re, t63_prev[0], T8K, h63,
                              rows_63[1] - rows_63[0], wk8)),
        "col_fft_zero_padded[H 8192, 4320p]": case(
            fused.col_fft_zero_padded, k8k_re[:1], k8k_im[:1], g8k.pad_h,
            r0_8k, work=col_work(k8k_re, g8k.pad_h, wk8)),
        "phase_col_ifft[H 8192, 4320p]": case(
            fused.phase_col_ifft, *k8k_next, *k8k_prev, cfg_j, **k8_kw,
            work=phase_work(k8k_next[0], g8k.pad_h, hr8k, wk8)),
        "kdecomp_variant[phase + gm + rolls, H 8192]": case(
            kdecomp.kdecomp_variant, *k8k_next, *k8k_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_8k, full_w=g8k.pad_w,
            work=(F4 * (4 * k8k_next[0].numel() + 2 * hr8k * wk8),
                  fft_ops(g8k.pad_h, wk8) + 40 * g8k.pad_h * wk8)),
        # Kernel 8's row pass (the row engine) at 8192 points.
        "_fft_axis[inverse, axis 2, scale, 8192]": case(
            radix2._fft_axis, k8w_re, k8w_im, 2, True, 1.0 / (512 * 8192),
            work=(F4 * 4 * n8k, fft_ops(8192, 512)),
            lib=lambda: torch.fft.ifft(fft_in8, dim=-1)),
        "_fft_axis[forward real, axis 2, 8192]": case(
            radix2._fft_axis, k8w_re, None, 2, False,
            work=(F4 * 3 * n8k, fft_ops(8192, 512)),
            lib=lambda: torch.fft.fft(k8w_re, dim=-1)),
        "_fft_axis[forward complex, axis 2, 8192]": case(
            radix2._fft_axis, k8w_re, k8w_im, 2, False,
            work=(F4 * 4 * n8k, fft_ops(8192, 512)),
            lib=lambda: torch.fft.fft(fft_in8, dim=-1)),
        # 16K, path (m)'s calls: every kernel past 8192 points (the bracket
        # passes around the block engines; kernel 2's combine pass at m =
        # 68), kernels 10 on a 15360-column crop and 9 on (m) (g)'s full
        # 16384 x 16384 spectra; beside the one torch.fft call that
        # computes the same transform.
        "windowed_row_fft[16384 lanes, 16K square_pow2]": case(
            fused.windowed_row_fft, y16, g16.pad_h, r0_16, True,
            work=(F4 * (y16.numel() + 2 * y16.shape[0] * y16.shape[1] * wk16),
                  fft_ops(g16.pad_w, y16.shape[0] * y16.shape[1])),
            lib=lambda: torch.fft.fft(y16, dim=-1)),
        "windowed_row_fft_u8planar[16384 lanes, 16K]": case(
            fused.windowed_row_fft_u8planar, *u8_args16,
            work=(u8_16.numel() + F4 * 2 * T16 * (r1_16 - r0_16) * wk16,
                  fft_ops(g16.pad_w, T16 * (r1_16 - r0_16))),
            lib=lambda: torch.fft.fft(y16, dim=-1)),
        "windowed_row_fft_frames[16384 lanes, 16K square_pow2]": case(
            fused.windowed_row_fft_frames, c.frames16_d, rows3[:1],
            g16.pad_h, g16.pad_w, g16.y0, g16.x0, r0_16, True,
            work=(F4 * c.frames16_d.numel()
                  + F4 * 2 * T16 * (r1_16 - r0_16) * wk16,
                  fft_ops(g16.pad_w, T16 * (r1_16 - r0_16))
                  + 7 * T16 * H16 * W16)),
        "colspec_chunk[pow-2, H 16384, 16K square_pow2]": case(
            fused.colspec_chunk, k16_re, k16_im, *k16_prev, cfg_j,
            g16.pad_h, r0_16, **k16_kw,
            work=colspec_work(k16_re, k16_prev[0], T16, g16.pad_h, hr16,
                              wk16)),
        "colspec_chunk[tight m 68, 16K]": case(
            fused.colspec_chunk, t16_re, t16_im, *t16_prev, cfg, g16t.pad_h,
            r0_16t, out_rows=rows_16t, full_w=g16t.pad_w,
            # the combine's m complex MACs a point each way, the 128-point
            # factor and the phase pass
            work=(colspec_work(t16_re, t16_prev[0], T16, g16t.pad_h,
                               rows_16t[1] - rows_16t[0], wk16)[0],
                  8 * 68 * 2 * T16 * g16t.pad_h * wk16
                  + fft_ops(128, 2 * T16 * 68 * wk16)
                  + 40 * T16 * g16t.pad_h * wk16)),
        "col_fft_zero_padded[H 16384, 16K]": case(
            fused.col_fft_zero_padded, k16_re[:1], k16_im[:1], g16.pad_h,
            r0_16, work=col_work(k16_re, g16.pad_h, wk16),
            lib=lambda: torch.fft.fft(col16, dim=-2)),
        "phase_col_ifft[H 16384, 16K]": case(
            fused.phase_col_ifft, *k16_next, *k16_prev, cfg_j, **k16_kw,
            work=phase_work(k16_next[0], g16.pad_h, hr16, wk16)),
        "kdecomp_variant[phase + gm + rolls, H 16384]": case(
            kdecomp.kdecomp_variant, *k16_next, *k16_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_16, full_w=g16.pad_w,
            work=(F4 * (4 * k16_next[0].numel() + 2 * hr16 * wk16),
                  fft_ops(g16.pad_h, wk16) + 40 * g16.pad_h * wk16),
            lib=lambda: torch.fft.ifft(col16, dim=-2)),
        "row_ifft_magnitude[16384 lanes, 16K]": case(
            fused.row_ifft_magnitude, rre16, rim16, pad_h=g16.pad_h,
            full_w=g16.pad_w,
            work=(F4 * (2 * rre16.numel() + T16 * hr16 * g16.pad_w),
                  fft_ops(g16.pad_w, T16 * hr16)),
            lib=lambda: torch.fft.irfft(irfft16, n=g16.pad_w, dim=-1)),
        "post_fused[16K, crop 15360, f32 frames, interleaved]": case(
            post_fused.post_fused, rec16_1, None, None, win16, cfg_j,
            rows_16[0], H16, W16, "square_pow2", "interleaved",
            src=c.frames16_d,
            work=(F4 * (T16 * (H16 + 4) * (W16 + 4) + 3 * T16 * H16 * W16
                        + win16.numel() + 3 * T16 * H16 * W16),
                  (2 * (4 * 2 + 1) + 20) * T16 * H16 * W16)),
        "_fft_axis[inverse, axis 2, scale, 16384]": case(
            radix2._fft_axis, k8x_re, k8x_im, 2, True,
            1.0 / (g16.pad_h * g16.pad_w),
            work=axis_work(k8x_re, g16.pad_w, g16.pad_h, 4),
            lib=lambda: torch.fft.ifft(fft16, dim=-1)),
        "_fft_axis[forward real, axis 2, 16384]": case(
            radix2._fft_axis, k8x_re, None, 2, False,
            work=axis_work(k8x_re, g16.pad_w, g16.pad_h, 3),
            lib=lambda: torch.fft.fft(k8x_re, dim=-1)),
        "_fft_axis[inverse, axis 1, 16384]": case(
            radix2._fft_axis, k8x_re, k8x_im, 1, True, 1.0,
            work=axis_work(k8x_re, g16.pad_h, g16.pad_w, 4),
            lib=lambda: torch.fft.ifft(fft16, dim=-2)),
        "_fft_axis[forward complex, axis 1, 16384]": case(
            radix2._fft_axis, k8x_re, k8x_im, 1, False,
            work=axis_work(k8x_re, g16.pad_h, g16.pad_w, 4),
            lib=lambda: torch.fft.fft(fft16, dim=-2)),
        # 4 planes in, 2 out; ~15 f32 operations a level and bin and ~40
        # for the gate and the rotation
        "amplify_procedural[16K (g), (1, 16384, 16384)]": case(
            fused_kernels.amplify_procedural, *k9x_cur, *k9x_prev,
            *axes_b16, *k9_args(cfg_g),
            work=(F4 * 6 * k8x_re.numel(), (15 * 5 + 40) * k8x_re.numel())),
        # The measurement path's kernels: kdecomp's other piece sets (kernel
        # 12's bytes), the copy patterns at both sizes (their planes, read
        # once, written once).
        **{f"kdecomp_variant[{name}]": case(
            kdecomp.kdecomp_variant, *kd, cfg_j, pieces, kd_rows,
            full_w=kd_fw, work=kd_work)
           for name, pieces in kdecomp.VARIANTS[:-1]},
        **{f"copy_probe[{pat} {blk}{', 16 frames' if n > 1 else ''}]": case(
            kexp.copy_probe, *cp, pat, blk,
            work=(2 * 2 * F4 * cp[0].numel(), 0),
            lib=(lambda: cp_dsts[16].copy_(cp_pairs[16]))
            if (n, pat, blk) == (16, "rows", 1) else None)
           for n, cp in ((1, cp1), (16, cp16)) for pat, blk in COPY_PATTERNS
           if n > 1 or (pat, blk) != ("rows", 1)},
    }
    # Path (n)'s kernels at the shapes rows shards of a 1080p square_pow2
    # frame give them (p = 2, 4, 8: the last shard, idx = p - 1): kernel 6
    # with fx_values on the shard's column slice (T, 2048, 2048 / p) of the
    # whole-lane spectra of the 16 bar frames (each frame's prev the one
    # before), with the shard's slice of the bit-reversed lane table;
    # kernel 8 on the row band (T, 2048 / p, 2048) (real) and the column
    # slice (complex), kernel 7 on the row band.
    n_re, n_im = (x.reshape(T, g_sq.pad_h, g_sq.pad_w).contiguous() for x in
                  split(preprocess(c.bar_il_d, cfg_full)[0]))
    n_prev = [torch.cat([x[:1], x[:-1]]).contiguous() for x in (n_re, n_im)]
    fx_table = dev_t(radix2.bitrev_freq_axis(g_sq.pad_w))
    n_branches = {"pyramid": cfg_full,
                  "standard 2.5": cfg_full.replace(mode="standard",
                                                   phase_scale=2.5),
                  "steerable 4, overlapping bands": cfg_full.replace(
                      orientations=4, pyramid_levels=6),
                  "IIR taps": cfg_full.replace(temporal=c.cfg_fi.temporal)}
    for p_ in (2, 4, 8):
        wc_, hp_ = g_sq.pad_w // p_, g_sq.pad_h // p_
        sl = slice((p_ - 1) * wc_, p_ * wc_)
        cur_ = [x[..., sl].contiguous() for x in (n_re, n_im)]
        prv_ = [x[..., sl].contiguous() for x in n_prev]
        fx_ = fx_table[sl].contiguous()
        for br, cf in n_branches.items():
            taps_ = ({} if cf.temporal.mode == "two_frame" else dict(zip(
                ("lp_fast", "lp_slow"),
                (0.1 * dev_t(rng.standard_normal((T, g_sq.pad_h, wc_)))
                 for _ in range(2)))))
            # planes read (spectra, prev, taps) and written (rows, taps)
            n_io = 10 if taps_ else 6
            t.cases[f"phase_col_ifft[fx_values, {br}, W/p {wc_}]"] = case(
                fused.phase_col_ifft, *cur_, *prv_, cf, fx_values=fx_,
                **taps_, work=(
                    F4 * (n_io * T * g_sq.pad_h * wc_ + wc_),
                    fft_ops(g_sq.pad_h, T * wc_)
                    + (40 + 15 * cf.pyramid_levels) * T * g_sq.pad_h * wc_))
        band = dev_t(rng.random((T, hp_, g_sq.pad_w)))
        k7_ = [dev_t(scale * rng.standard_normal((T, hp_, g_sq.pad_w)))
               for _ in range(2)]
        t.cases[f"_fft_axis[shard rows, forward real, H/p {hp_}]"] = case(
            radix2._fft_axis, band, None, 2, False,
            work=axis_work(band, g_sq.pad_w, T * hp_, 3))
        t.cases[f"_fft_axis[shard columns, forward complex, W/p {wc_}]"] = (
            case(radix2._fft_axis, *cur_, 1, False,
                 work=axis_work(cur_[0], g_sq.pad_h, T * wc_, 4)))
        t.cases[f"row_ifft_magnitude[shard rows, H/p {hp_}]"] = case(
            fused.row_ifft_magnitude, *k7_, pad_h=g_sq.pad_h,
            work=(F4 * 3 * k7_[0].numel(),
                  fft_ops(g_sq.pad_w, T * hp_) + 3 * k7_[0].numel()))
    return t


def kernel_calls(case):
    """(kernel call, plain-version call) of one case of the table."""
    from pbmm_tpu_torch.engine import post_fused
    from pbmm_tpu_torch.phase import fused_kernels
    from pbmm_tpu_torch.spectral import fused, radix2
    from pbmm_tpu_torch.tools import kdecomp, kexp, trig_probe

    fn, a, k = case.fn, case.args, case.kwargs
    ref = next(getattr(m, fn.__name__ + "_ref") for m in (
        fused, post_fused, radix2, fused_kernels, kdecomp, kexp,
        trig_probe) if hasattr(m, fn.__name__ + "_ref"))
    return (lambda: fn(*a, **k)), (lambda: ref(*a, **k))


def check_case(torch, name, got, want):
    """Holds one case's kernel output against its plain version's, at the
    card suite's bars: bit for bit where the kernel only moves data (the
    copy probe, kdecomp's piece sets without the phase piece), 1 code for
    uint8, max abs < 1e-4 for the post kernels' images, and max error /
    max magnitude < 1e-4 for spectra (the IIR taps weighted by the
    magnitude of the bin each rotates).  Raises on a miss."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    got, want = list(got), list(want)

    def rel(g, w, weight=None):
        e, m = (g - w).abs(), w.abs()
        if weight is not None:
            e, m = e * weight, m * weight
        return float(e.max()) / float(m.max())

    if name.startswith(("copy_probe", "kdecomp_variant[stream only]",
                        "kdecomp_variant[+gm matmul]",
                        "kdecomp_variant[+rolls]")):
        miss = [i for i, (g, w) in enumerate(zip(got, want))
                if not torch.equal(g, w)]
        bar = "bit for bit"
    elif got[0].dtype == torch.uint8:
        miss = [i for i, (g, w) in enumerate(zip(got, want))
                if int((g.int() - w.int()).abs().max()) > 1]
        bar = "1 code"
    elif name.startswith(("rowifft_post_fused", "post_fused")):
        miss = [i for i, (g, w) in enumerate(zip(got, want))
                if not float((g - w).abs().max()) < IMG_TOL]
        bar = f"max abs < {IMG_TOL:g}"
    else:
        # Re/Im pairs as complex planes; a lone plane (|z|, Re z) as is.
        # Where six planes come back, the last two are the IIR taps: at
        # bins at the FFTs' rounding floor (~1e-7 of the maximum) the
        # phase delta is noise in both versions, and there they rotate
        # nothing.
        n = 4 if len(got) == 6 else len(got)
        z = ([(torch.complex(got[k], got[k + 1]),
               torch.complex(want[k], want[k + 1])) for k in range(0, n, 2)]
             if n > 1 else [(got[0], want[0])])
        errs = [rel(g, w) for g, w in z]
        if len(got) == 6:
            mag = z[1][1].abs()
            errs += [rel(g, w, mag) for g, w in zip(got[4:], want[4:])]
        miss = [i for i, e in enumerate(errs) if not e < SPEC_TOL]
        bar = f"max error / max magnitude < {SPEC_TOL:g}"
    if miss:
        raise AssertionError(f"{name}: comparisons {miss} of "
                             f"{[tuple(g.shape) for g in got]} disagree with "
                             f"the plain version ({bar})")


def time_kernels(torch, dev, card, t):
    """Each case held against its plain version (`check_case`), then its
    warm, cold and enqueued times beside its plain version's, its bound
    and its library call; the designs' alternatives."""
    from pbmm_tpu_torch.engine import post_fused
    from pbmm_tpu_torch.spectral import fused
    from pbmm_tpu_torch.tools import kexp, post_times

    records = {}
    for name, case in t.cases.items():
        kern, plain = kernel_calls(case)
        check_case(torch, name, kern(), plain())
        enq_ms = time_ms(torch, kern)
        k_ms, cold_ms = kexp.timed(kern, device=dev)
        p_ms = kexp.timed(plain, reps=5, warmup=1, device=dev)[0]
        rec = records[name] = dict(
            ms=k_ms, ms_cold=cold_ms, plain_ms=p_ms, ms_enqueued=enq_ms,
            library_ms=case.lib and kexp.timed(case.lib, device=dev)[0])
        line = (f"[4] {card}: {name} {k_ms:.4f} ms warm, {cold_ms:.4f} ms "
                f"cold L2, plain PyTorch version {p_ms:.4f} ms (device "
                f"medians, at its path's shapes); {enq_ms:.4f} ms with the "
                "host's enqueue inside the event pair")
        if case.work:
            nbytes, ops = case.work
            byte_ms, op_ms = nbytes / 3.35e9, ops / 67e9
            rec.update(bound_ms=max(byte_ms, op_ms),
                       bound_by="bytes" if byte_ms >= op_ms else "operations")
            line += (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                     f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
        if case.lib:
            line += f"; library call {rec['library_ms']:.4f} ms"
        log(line)
    for name, num in (("row_ifft_magnitude", 7),
                      ("windowed_row_fft_u8planar", 4),
                      ("windowed_row_fft", 1)):
        rec = records[name]
        log(f"[4] {card}: kernel {num} ({name}, the row engine) "
            f"{rec['ms']:.4f} ms warm against its library call "
            f"{rec['library_ms']:.4f} ms: "
            f"{rec['ms'] / rec['library_ms']:.2f}x; bound "
            f"{rec['bound_ms']:.4f} ms")
    # The designs' alternatives, for the record: kernel 6 on half its
    # strip (at one 1080p frame, 288 blocks: one wave of 3 an SM would
    # hold at 64 KB, were the block smaller), and kernel 3 with 1, 2
    # and 4 region rows in flight at radii 2 and 5.
    strip = fused.phase_col_strip
    try:
        fused.phase_col_strip = lambda h, w: strip(h, w) // 2
        half = kexp.timed(kernel_calls(t.cases["phase_col_ifft"])[0],
                          device=dev)
    finally:
        fused.phase_col_strip = strip
    log(f"[4] {card}: phase_col_ifft on half its strip "
        f"({strip(t.g_sq.pad_h, t.wk) // 2} columns) {half[0]:.4f} ms warm, "
        f"{half[1]:.4f} ms cold, against "
        f"{records['phase_col_ifft']['ms']:.4f} / "
        f"{records['phase_col_ifft']['ms_cold']:.4f} on "
        f"{strip(t.g_sq.pad_h, t.wk)}")
    records["phase_col_ifft"]["half_strip_ms"] = half
    threads = post_fused._KERNEL3_THREADS
    for cf in (t.cfg, t.cfg_b15):
        for n in (128, 256, 512):
            try:
                post_fused._KERNEL3_THREADS = n
                rows_in = post_fused.kernel3_rows(post_fused._radius(cf),
                                                  t.geom.pad_w, W)
                ms = kexp.timed(lambda: post_fused.rowifft_post_fused(
                    t.rre, t.rim, t.i_pl, t.q_pl, t.win, cf, t.rows[0], H,
                    W, "tight", full_w=t.geom.pad_w, route=False),
                    device=dev)
            finally:
                post_fused._KERNEL3_THREADS = threads
            log(f"[4] {card}: rowifft_post_fused at radius "
                f"{post_fused._radius(cf)}, {rows_in} region rows in "
                f"flight ({n} threads): {ms[0]:.4f} ms warm, {ms[1]:.4f} "
                "ms cold")
    # Kernel 3 against kernel 7 + kernel 10, which give the same bits,
    # at radii 2-14 at 1080p (kernel 3 also where the route takes
    # kernels 7 + 10): f32 I/Q to tuple3 and the uint8 frames to
    # planar_u8.
    route = {}
    for name, (k3_fn, k7_10_fn) in post_times.route_calls(dev).items():
        k3, k7_10 = (kexp.timed(fn, device=dev)
                     for fn in (k3_fn, k7_10_fn))
        route[name] = {"kernel3": k3, "kernels7_10": k7_10}
        log(f"[4] {card}: {name}: kernel 3 {k3[0]:.4f} ms warm / "
            f"{k3[1]:.4f} cold, kernel 7 + kernel 10 {k7_10[0]:.4f} / "
            f"{k7_10[1]:.4f}")
    records["rowifft_post_fused"]["route_vs_kernels7_10"] = route
    return records


def launched(torch, fn):
    """(fn(), {kernel wrapper: launches during the call})."""
    from pbmm_tpu_torch.utils.profiling import launch_counts

    before = launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, {k: n - before[k] for k, n in launch_counts().items()}


def time_paths(torch, dev, card, c):
    """Each path's steady-state chunk (frames/s, and the kernels one chunk
    launches), (h)'s pairs, (n)'s engines on a world of one, (o)'s idle
    share and its transforms alone: (the chunks phase 5 profiles, the
    paths' records, the launches by path)."""
    import pbmm_tpu_torch
    from pbmm_tpu_torch.engine.pipeline import magnify_frame_pair
    from pbmm_tpu_torch.parallel import (
        magnify_batch_sharded,
        magnify_clip_batched,
        magnify_video_spatial,
        make_mesh,
    )
    from pbmm_tpu_torch.spectral import mxu_fft
    from pbmm_tpu_torch.tools import kexp, roofline

    paths, launches, chunks = {}, {}, {}

    def steady(what, frames_d, cf, reps=10):
        state = [pbmm_tpu_torch.magnify_video(frames_d, cf)[1]]

        def chunk():
            out, state[0] = pbmm_tpu_torch.magnify_video(frames_d, cf,
                                                         state[0])
            return out

        n = frames_d.shape[0]
        ms = time_ms(torch, chunk, reps=reps, warmup=2)
        launches[what] = launched(torch, chunk)[1]
        paths[what] = {"fps": n / (ms / 1e3), "chunk_ms": ms}
        chunks[what] = chunk
        log(f"[4] {card}: {what}: steady-state chunk of {n} frames "
            f"{ms:.3f} ms median of {reps} -> {paths[what]['fps']:.2f} "
            f"frames/s, {ms / n:.4f} ms/frame")

    scan = c.cfg_j.replace(engine="scan")
    for what, fd, cf in (
            ("f32 1080p", c.frames_d, c.cfg),
            ("u8 1080p -> planar_u8", c.u8_d, c.cfg_u8),
            ("u8 1080p -> planar", c.u8_d, c.cfg_pl),
            ("540p f32", c.f540_d, c.cfg),
            ("540p u8", c.u8_540_d, c.cfg),
            ("(a) 1080p square_pow2", c.frames_d, c.cfg_sq),
            ("(b) 1080p rgb IIR u8 -> planar_u8", c.bar_d, c.cfg_rgb),
            ("(c) 720p rect_pow2 standard 2.5", c.bar720_d, c.cfg_std),
            ("(d) 1080p steerable real compensate gains", c.frames_d,
             c.cfg_str),
            ("(j) 2160p square_pow2", c.frames4k_d, c.cfg_j),
            ("(j) 2160p tight", c.frames4k_d, c.cfg),
            ("(j) 2160p tuned scan square_pow2", c.frames4k_d[:3], scan),
            ("(l) 4320p square_pow2", c.frames8k_d, c.cfg_j),
            ("(l) 4320p tight", c.frames8k_d, c.cfg),
            ("(l) 4320p tuned scan square_pow2", c.frames8k_d, scan),
            ("(k) 1080p blur 4.5 (kernels 7 + 10)", c.frames_d, c.cfg_b45),
            ("(k) 1080p blur 4.5 u8 -> planar_u8", c.u8_d,
             c.cfg_b45.replace(output_layout="planar_u8")),
            ("(k) 1080p blur 1.5 (kernel 3)", c.frames_d, c.cfg_b15),
            ("(m) 16K square_pow2", c.frames16_d, c.cfg_j),
            ("(m) 16K tight", c.frames16_d, c.cfg),
            ("(m) 16K tuned scan square_pow2", c.frames16_d, scan),
            ("(m) 16K pallas unfused, use_pallas", c.frames16_d, c.cfg_g),
            ("(e) 1080p MagnifyConfig() (torch.fft, scan)", c.bar_il_d,
             c.cfg_e),
            ("(f) 1080p tuned scan square_pow2", c.bar_il_d, c.cfg_f),
            ("(f) 720p rect_pow2 tuned scan, no cache, IIR", c.bar720_d,
             c.cfg_fi),
            ("(g) 1080p pallas unfused, use_pallas", c.bar_il_d, c.cfg_g)):
        steady(what, fd, cf)

    def pair(what, cf):
        def fn():
            return magnify_frame_pair(c.bar_il_d[0], c.bar_il_d[1], cf)

        pair_ms = time_ms(torch, fn)
        launches[what] = launched(torch, fn)[1]
        paths[what] = {"pairs_per_s": 1e3 / pair_ms, "pair_ms": pair_ms}
        log(f"[4] {card}: {what}: {pair_ms:.3f} ms a pair, median of 10 "
            f"-> {1e3 / pair_ms:.2f} pairs/s")

    pair("(h) 1080p magnify_frame_pair, tuned", c.cfg_f)
    # Path (n): each engine's call on its clip, on a world of one over
    # NCCL (one card: NCCL refuses two ranks on one GPU); on a mesh of one
    # the spatial engine's rank block is the whole clip.
    mesh11 = make_mesh((1, 1))
    rows1 = make_mesh((1,), ("rows",))
    cfg_iir720 = c.cfg_sq.replace(pad_mode="rect_pow2",
                                  temporal=c.cfg_fi.temporal)
    n_calls = {
        "(n) 1080p magnify_clip_batched, tuned": (
            c.frames_d, lambda: magnify_clip_batched(c.frames_d, c.cfg_sq)),
        "(n) 1080p magnify_batch_sharded, (1, 1) mesh": (
            c.frames_d, lambda: magnify_batch_sharded(c.frames_d[None],
                                                      c.cfg_sq, mesh11)),
        **{what: (fd, (lambda fd=fd, cf=cf: magnify_video_spatial(
            fd, cf, rows1))) for what, fd, cf in (
            ("(n) 1080p magnify_video_spatial, rows 1", c.frames_d,
             c.cfg_sq),
            ("(n) 720p magnify_video_spatial, standard 2.5, rows 1",
             c.bar720_d, c.cfg_std),
            ("(n) 720p magnify_video_spatial, IIR, rows 1", c.bar720_d,
             cfg_iir720))}}
    for what, (fd, fn) in n_calls.items():
        ms = time_ms(torch, fn, reps=5, warmup=1)
        launches[what] = launched(torch, fn)[1]
        paths[what] = {"fps": fd.shape[0] / (ms / 1e3), "call_ms": ms}
        chunks[what] = fn
        log(f"[4] {card}: {what}: {ms:.3f} ms a call of "
            f"{fd.shape[0]} frames, median of 5 -> "
            f"{paths[what]['fps']:.2f} frames/s")
    # (o): frames/s a steady chunk and the device's idle share, then
    # the two transforms alone at (1, 2048, 2048) beside torch.fft on
    # the same tensors and their bound (tools/roofline.py's count of
    # mxu_fft.py's products and elementwise steps).
    path_o = "(o) mxu 1080p"
    steady(path_o, c.bar_il_d, c.cfg_o)
    pair(path_o + " magnify_frame_pair", c.cfg_o)
    prof_o = profile_chunks(torch, chunks[path_o], card, path_o, n=3,
                            tag="[4]")
    y_np = np.random.default_rng(21).standard_normal((1, 2048, 2048)).astype(
        np.float32)
    y_mx = torch.from_numpy(y_np).to(dev)
    half_mx = torch.from_numpy(np.fft.rfft2(y_np.astype(np.float64)).astype(
        np.complex64)).to(dev)
    mxu_times = {}
    for name, fn, lib, inv in (
            ("rfft2_mxu", lambda: mxu_fft.rfft2_mxu(y_mx),
             lambda: torch.fft.rfft2(y_mx), False),
            ("irfft2_mxu", lambda: mxu_fft.irfft2_mxu(half_mx, 2048),
             lambda: torch.fft.irfft2(half_mx, s=(2048, 2048)), True)):
        warm, cold = kexp.timed(fn, device=dev)
        lib_ms = kexp.timed(lib, device=dev)[0]
        nbytes, ops = roofline.mxu_transform_work((1, 2048, 2048), inv)
        byte_ms, op_ms = nbytes / 3.35e9, ops / 67e9
        mxu_times[name] = {
            "ms": warm, "ms_cold": cold, "library_ms": lib_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        log(f"[4] {card}: {name} on (1, 2048, 2048): {warm:.4f} ms warm,"
            f" {cold:.4f} ms cold; torch.fft {lib_ms:.4f} ms; bound "
            f"{max(byte_ms, op_ms):.4f} ms ({ops / 1e9:.2f} GFLOP at 67 "
            f"TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    paths[path_o].update(
        idle_share=None if prof_o is None else 1 - prof_o[1] / prof_o[0],
        transforms_1x2048x2048=mxu_times)
    return chunks, paths, launches


def time_measurement(torch, dev, card):
    """(i) the measurement path through the tools: the row-tile copy
    ceiling and the roofline table at 1080p, the copy probe's patterns
    beside `Tensor.copy_` at one frame and on a 16-frame stack, kexp's
    experiments, kdecomp's variants and kernel 6 at one frame and at 16,
    the trig probe, the CLI's `--demo bar --fast --trace --stats` and
    `--debug-view split`.  Returns (its record, the launches it made)."""
    from pbmm_tpu_torch import cli
    from pbmm_tpu_torch.tools import kdecomp, kexp, roofline, trig_probe

    rng_m = np.random.default_rng(5)
    planes = {label: [torch.from_numpy(rng_m.random(kexp.copy_shape(n),
                                                    np.float32)).to(dev)
                      for _ in range(2)]
              for label, n in (("1 frame", 1), ("16 frames", 16))}

    def measurement():
        t0 = time.perf_counter()
        res = {"copy_gbps": roofline.row_copy_ceiling(dev)}
        res["roofline"] = roofline.roofline_table(
            reps=10, copy_gbps=res["copy_gbps"])
        res["ceilings"] = {}
        for label, pl in planes.items():
            pair = torch.stack(pl)
            dst = torch.empty_like(pair)
            res["ceilings"][f"Tensor.copy_, {label}"] = (
                pl[0].numel(), kexp.timed(lambda: dst.copy_(pair),
                                          device=dev))
            del pair, dst
            for pat, blk in COPY_PATTERNS:
                res["ceilings"][f"{pat} {blk}, {label}"] = (
                    pl[0].numel(), kexp.timed(kexp.copy_probe,
                                              (*pl, pat, blk)))
        res["kexp"] = {n: kexp.timed(fn, a) for n, (fn, a) in
                       kexp.experiments(dev, {
                           "rowfft_kept", "colfft_kept", "phase_kept",
                           "rowifft_kept"}).items()}
        # Kernel 12's variants and kernel 6 at one frame and at 16 (kernel
        # 2's launch-2 frame count on a chunk of 16).
        res["kdecomp"] = kdecomp.run_kdecomp(dev, reps=10)
        res["kdecomp16"] = kdecomp.run_kdecomp(dev, reps=10, frames=16)
        trig_probe.run_probe(dev)
        # The CLI on the card: the demo clip with a trace, and the debug
        # view.
        t_cli = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="pbmm_smoke_") as tmp:
            for argv in (["--demo", "bar", "--fast", "--trace",
                          os.path.join(tmp, "trace"), "--stats"],
                         ["--demo", "bar", "--debug-view", "split"]):
                argv += ["--output", os.path.join(tmp, "out.npy")]
                if cli.main(argv) != 0:
                    raise RuntimeError(f"the CLI exited non-zero: {argv}")
        res["cli_seconds"] = time.perf_counter() - t_cli
        res["seconds"] = time.perf_counter() - t0
        return res

    path_i = "(i) measurement path"
    meas, moved = launched(torch, measurement)
    log(f"[4] {path_i}: {meas['seconds']:.1f} s, the CLI's two calls "
        f"{meas['cli_seconds']:.1f} s of it")
    roofline.print_table(*meas["roofline"], file=sys.stdout)
    for name, (numel, (warm, cold)) in meas["ceilings"].items():
        nbytes = 2 * 2 * 4 * numel
        log(f"[4] {card}: copy ceiling, {name}, {nbytes / 1e6:.1f} MB "
            f"moved: warm {warm:.4f} ms {kexp.copy_gbps(nbytes, warm):.0f} "
            f"GB/s, cold {cold:.4f} ms {kexp.copy_gbps(nbytes, cold):.0f} "
            "GB/s")
    for label in planes:
        cp_rows1 = meas["ceilings"][f"rows 1, {label}"][1]
        cp_lib = meas["ceilings"][f"Tensor.copy_, {label}"][1]
        log(f"[4] {card}: copy probe rows 1 against Tensor.copy_, {label}: "
            f"warm {cp_rows1[0] / cp_lib[0]:.3f}x, cold "
            f"{cp_rows1[1] / cp_lib[1]:.3f}x")
    for name, (warm, cold) in meas["kexp"].items():
        log(f"[4] {card}: kexp {name}: warm {warm:.4f} ms, cold {cold:.4f} "
            "ms")
    for key, kd_b in (("kdecomp", 1), ("kdecomp16", 16)):
        for name, warm, cold in meas[key]:
            log(f"[4] {card}: kdecomp B = {kd_b}, {name}: warm {warm:.4f} "
                f"ms, cold {cold:.4f} ms")
        for name, (warm, cold) in kdecomp.split(meas[key]).items():
            log(f"[4] {card}: kdecomp split B = {kd_b}, {name}: warm "
                f"{warm:.4f} ms, cold {cold:.4f} ms")
        kd_t = {name: warm for name, warm, _ in meas[key]}
        kd_full, kd_6 = kd_t[kdecomp.VARIANTS[-1][0]], kd_t[kdecomp.KERNEL6]
        log(f"[4] {card}: kdecomp B = {kd_b}: the full variant "
            f"{kd_full:.4f} ms warm against kernel 6's {kd_6:.4f}: "
            f"{kd_full / kd_6:.3f}x")
    record = {"seconds": meas["seconds"], "cli_seconds": meas["cli_seconds"],
              "row_copy_ceiling_gbps": meas["copy_gbps"],
              "roofline": meas["roofline"][1],
              "copy_ceilings_ms": {
                  name: ms for name, (_, ms) in meas["ceilings"].items()},
              "kdecomp_split_ms": kdecomp.split(meas["kdecomp"]),
              "kdecomp_split_ms_16_frames": kdecomp.split(meas["kdecomp16"])}
    return record, moved


def time_streams(torch, dev, card, c):
    """The y4m stream (u8 ingest) with the host's parse share, and (p) the
    .npy stream: the native loader against the memmap route, u8 and f32,
    each chunk source alone.  Returns (records, launches)."""
    import pbmm_tpu_torch
    from pbmm_tpu_torch import native
    from pbmm_tpu_torch.io import stream, y4m

    records, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="pbmm_smoke_")
    try:
        clip = os.path.join(tmp, "clip.y4m")
        frames32 = np.concatenate([c.frames, c.frames[::-1]])
        y4m.save_y4m(clip, frames32, colorspace="420jpeg")
        _, launches["stream u8"] = launched(torch, lambda: list(
            stream.stream_magnify(clip, c.cfg_u8, chunk_frames=T,
                                  ingest="u8", device=dev)))
        t0 = time.perf_counter()
        n = sum(ch.shape[0] for ch in stream.stream_magnify(
            clip, c.cfg_u8, chunk_frames=T, ingest="u8", device=dev))
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
        records["stream u8"] = {"fps": n / stream_s, "seconds": stream_s,
                                "host_parse_share": parse_s / stream_s,
                                "chunk_source_share": source_s / stream_s}
        log(f"[4] {card}: y4m stream (32 1080p 420jpeg frames, u8 ingest, "
            f"planar_u8 out, host clock): {stream_s:.3f} s -> "
            f"{n / stream_s:.2f} frames/s; the host's y4m parse alone "
            f"{parse_s:.3f} s, {100 * parse_s / stream_s:.1f} % of it; the "
            f"chunk source (parse, batching, host -> device, decode) "
            f"{source_s:.3f} s, {100 * source_s / stream_s:.1f} %; "
            "magnify and device -> host the rest")

        # (p): a 32-frame 1080p uint8 .npy and its f32 twin on the host
        # clock, the native loader against the memmap route
        # (frame_chunks + magnify_video, the same chunks) on the same
        # files, medians of 3; and each chunk source alone (read,
        # convert, host -> device).
        path_p = "(p) npy stream native"
        u8 = np.round(frames32 * 255.0).astype(np.uint8)
        npy = {"u8": os.path.join(tmp, "clip_u8.npy"),
               "f32": os.path.join(tmp, "clip_f32.npy")}
        np.save(npy["u8"], u8)
        np.save(npy["f32"], u8 * np.float32(1.0 / 255.0))
        del u8, frames32

        def memmap_stream(pth):
            st, n = None, 0
            for ch in stream.frame_chunks(pth, T, device=dev):
                o, st = pbmm_tpu_torch.magnify_video(ch, c.cfg_sq, st)
                n += o.cpu().numpy().shape[0]
            return n

        def native_stream(pth):
            return sum(ch.shape[0] for ch in stream.stream_magnify(
                pth, c.cfg_sq, chunk_frames=T, device=dev))

        def chunk_source(pth, route):
            if route == "native f32 mode":
                with native.NativeFrameLoader(pth, T) as ld:
                    return sum(torch.from_numpy(ch).to(dev).shape[0]
                               for ch in ld)
            it = (stream._open_chunk_source(pth, T, device=dev)
                  if route == "native" else
                  stream.frame_chunks(pth, T, device=dev))
            return sum(ch.shape[0] for ch in it)

        def host_s(fn, *a):
            fn(*a)
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = fn(*a)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return n, statistics.median(secs)

        p_times = {}
        for fmt, pth in npy.items():
            _, launches[f"{path_p} {fmt}"] = launched(
                torch, lambda: native_stream(pth))
            for route, fn in (("native", native_stream),
                              ("memmap", memmap_stream)):
                n, secs = host_s(fn, pth)
                _, src_s = host_s(chunk_source, pth, route)
                p_times[f"{fmt} {route}"] = {
                    "fps": n / secs, "seconds": secs, "source_seconds": src_s}
                log(f"[4] {card}: {path_p}, {fmt} .npy, {route}: 32 frames "
                    f"{secs:.3f} s -> {n / secs:.2f} frames/s (host clock, "
                    f"median of 3); the chunk source alone {src_s:.3f} s")
            # The loader's f32 mode (uint8 scaled on the host), the JAX
            # package's contract, as a chunk source only.
            _, src_s = host_s(chunk_source, pth, "native f32 mode")
            p_times[f"{fmt} native f32 mode"] = {"source_seconds": src_s}
            log(f"[4] {card}: {path_p}, {fmt} .npy: the chunk source alone "
                f"in the loader's f32 mode {src_s:.3f} s")
        records[path_p] = p_times
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches


def phase_timing(torch, dev, card):
    """Phase 4: returns the chunks phase 5 profiles and the JSON record."""
    from pbmm_tpu_torch.parallel.launcher import (
        free_port,
        init_world,
        rank_device,
    )

    c = clips(torch, dev)
    t = kernel_table(torch, dev, c)
    records = time_kernels(torch, dev, card, t)
    del t
    torch.cuda.empty_cache()
    init_world(f"tcp://127.0.0.1:{free_port()}", 1, 0, rank_device())
    chunks, paths, launches = time_paths(torch, dev, card, c)
    path_i = "(i) measurement path"
    paths[path_i], launches[path_i] = time_measurement(torch, dev, card)
    streams, stream_launches = time_streams(torch, dev, card, c)
    paths.update(streams)
    launches.update(stream_launches)
    # Each kernel's record: its launches in one steady chunk of the path
    # named beside it (the probes': in the measurement path).
    sources = {
        # Kernel 1 serves the per-frame pre stage (the front end took its
        # place on the batched engine's chunks).
        "windowed_row_fft": ("pbmm_tpu_torch/csrc/row_fft.cu",
                             "pbmm_tpu/spectral/fused.py:79",
                             "(f) 1080p tuned scan square_pow2"),
        "colspec_chunk": ("pbmm_tpu_torch/csrc/colspec_chunk.cu",
                          "pbmm_tpu/spectral/fused.py:1310", "f32 1080p"),
        "rowifft_post_fused": ("pbmm_tpu_torch/csrc/rowifft_post.cu",
                               "pbmm_tpu/engine/post_pallas.py:198",
                               "f32 1080p"),
        "windowed_row_fft_u8planar": ("pbmm_tpu_torch/csrc/row_fft.cu",
                                      "pbmm_tpu/spectral/fused.py:168",
                                      "u8 1080p -> planar_u8"),
        # The front end takes kernel 1's place on the batched engine's
        # chunks, with the pre stage the JAX package leaves to XLA
        # (pbmm_tpu/engine/pipeline.py:171 preprocess_cl).
        "windowed_row_fft_frames": ("pbmm_tpu_torch/csrc/row_fft.cu",
                                    "pbmm_tpu/spectral/fused.py:79",
                                    "f32 1080p"),
        "row_ifft_magnitude": ("pbmm_tpu_torch/csrc/row_ifft.cu",
                               "pbmm_tpu/spectral/fused.py:1236",
                               "540p f32"),
        "col_fft_zero_padded": ("pbmm_tpu_torch/csrc/col_fft.cu",
                                "pbmm_tpu/spectral/fused.py:303",
                                "(f) 1080p tuned scan square_pow2"),
        "post_fused_rgb": ("pbmm_tpu_torch/csrc/post_rgb.cu",
                           "pbmm_tpu/engine/post_pallas.py:398",
                           "(b) 1080p rgb IIR u8 -> planar_u8"),
        "phase_col_ifft": ("pbmm_tpu_torch/csrc/phase_col_ifft.cu",
                           "pbmm_tpu/spectral/fused.py:1022",
                           "(f) 1080p tuned scan square_pow2"),
        "_fft_axis": ("pbmm_tpu_torch/csrc/fft_axis.cu",
                      "pbmm_tpu/spectral/pallas_fft.py:405",
                      "(g) 1080p pallas unfused, use_pallas"),
        "amplify_procedural": ("pbmm_tpu_torch/csrc/amplify_procedural.cu",
                               "pbmm_tpu/phase/pallas_kernels.py:136",
                               "(g) 1080p pallas unfused, use_pallas"),
        # Kernel 10 takes the y_only tail where no kernel-3 block fits
        # (path (k)); the JAX package reaches it only through _post_block.
        "post_fused": ("pbmm_tpu_torch/csrc/post_rgb.cu",
                       "pbmm_tpu/engine/post_pallas.py:91",
                       "(k) 1080p blur 4.5 (kernels 7 + 10)"),
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
               "launches": launches[path][name], "path": path,
               **records[name]}
        extra = {k: v for k, v in records.items() if k.startswith(name + "[")}
        if extra:
            rec["variants"] = extra
        kernels.append(rec)
    report = {"kernels": kernels, "fps_1080p": paths["f32 1080p"]["fps"],
              "chunk_ms": paths["f32 1080p"]["chunk_ms"],
              "paths": paths, "launches_by_path": launches}
    return chunks, report


# -- 5. where the time goes (opt-in) ------------------------------------------

def phase_profile(torch, card, chunks):
    for what, chunk in chunks.items():
        profile_chunks(torch, chunk, card, what)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 5, the per-kernel device-time "
                             "breakdown of a steady-state chunk")
    args = parser.parse_args()
    # Path (m) holds 16K planes beside the kernel table's tensors: let the
    # allocator grow segments rather than leave freed blocks stranded.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind, card = phase_device(torch)
    phase_build()
    chunks, report = phase_timing(torch, dev, card)
    if args.profile:
        phase_profile(torch, card, chunks)
    log(json.dumps(report))
    dist.destroy_process_group()
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
