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
     uint8 images: 1 code): kernels 1-3 at 1080p (kernel 1, on the row
     engine, also bit for bit against kernel 8's row pass (the same
     engine, since it runs rows of 128 points and more there)
     on the same windowed rows at 1080p, 960x540 and 4096 lanes; kernel
     2, frame-parallel, at the tight heights to 1e-4 of the spectrum),
     kernel 4 on (16, 3, 1080, 1920) uint8 frames (also bit for bit
     against the pre stage + kernel 1), the front end (kernel 4's kernel
     on every input form: f32 interleaved, uint8 interleaved with three
     planes, f32 planar at 1080p and 16K's f32 frames at 16384 lanes,
     each bit for bit against the torch pre stage + kernel 1), kernels 3
     and 10 with the chroma from f32 and uint8 interleaved and f32 planar
     frames bit for bit against the same kernel on the torch pre stage's
     I/Q planes, and the interleaved layout of kernels 3, 10 and 11 bit
     for bit against the stack of tuple3, kernel 3's u8-chroma /
     planar_u8 and f32 / planar
     variants, kernel 7 at the 1080p and 960x540 region shapes (also bit
     for bit against kernel 8's row pass on the rebuilt rows + torch's
     |z|, there, at 2160p's 4096 lanes and for Re z); and the
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
     integer and 2.5 scale, steerable) and kernel 10 (the y_only tail
     after kernel 7, from blur radius 6 at 1080p), at 1080p shapes; and the
     measurement path's: kernel 12 (kdecomp, all six piece sets at H =
     2048, its full variant bit for bit against kernel 6 on kdecomp's
     planes and on the bar's spectra), kernel 13 (the copy probe, rows of
     1 and 64, strips of 2, 4, 8, 16 and 32 columns, bit for bit) and
     kernel 14
     (the trig probe: every op code against its plain version and fp64,
     with the JAX probe's tolerances, signed and exact zeros included);
     blur radii 5, 13 and 15 (kernels 3, 11, 10 with f32 and uint8
     chroma, kernel 10 at path (k)'s call, and kernel 3's route through
     kernels 7 + 10 where its block does not fit); kernel 3 bit for bit
     against kernel 7 + kernel 10 on the same
     rows at radii 2 and 5, f32 and uint8 chroma, tuple3 and planar_u8;
     2160p's heights: kernel 2 at H = 4096 and at tight m = 17, kernels
     5, 6 and 12 at H = 4096 (the IIR branch at 4096 is held by the
     card-only tests); 4320p's: kernel 2 at H = 8192 and at tight m = 34
     and 63 (m = 64 is H = 8192), kernels 5, 6 and 12 at H = 8192; kernel
     8's row pass (the row engine) at 8192 points in its three kinds;
     kernel 6, one frame a launch and all frames in one, bit for bit
     against kernel 2's rows at H = 2048, 4096 and 8192 (kernel 5's last
     spectrum = kernel 2's state), and kernel 12 against kernel 6 at 4096
     and 8192; path (n)'s kernels at the shapes 2-, 4- and 8-way rows
     shards of a 1080p square_pow2 frame give them: kernel 6 with
     fx_values (the last shard's column slice (16, 2048, 2048 / p) of the
     bar's whole-lane spectra and its slice of the bit-reversed lane
     table) in four branches (pyramid, standard at 2.5, steerable over
     overlapping bands, the IIR taps), each also bit for bit against the
     same columns of one 2048-lane call with the whole table; kernel 8 on
     the row band (16, 2048 / p, 2048) (real) and the column slice
     (complex), kernel 7 on the row band with pad_h; and the mxu
     backend's transforms (`spectral/mxu_fft.py`, torch.matmul in IEEE
     f32, no kernel): rfft2_mxu, irfft2_mxu and fft2_mxu at (1, 2048,
     2048) and (3, 1024, 2048) against torch.fft and numpy float64 (max
     error / max magnitude < 2e-5), and a call with TF32 allowed refused;
  3. end to end, each path run as two chunks with the state threaded,
     every launch count set to 0 just before the path and read just
     after (each of its kernels must have launched, and kernel 1 must not
     on the u8 path):
     - f32 1080p, the bench clip (chunks of 16, shifted noise): outputs
       finite in [0, 1], chunks of 8 + 8 equal one chunk of 16 bit for
       bit, frames 0-3 > 100 dB PSNR against the fp64 numpy oracle; one
       steady chunk launches the front end, kernel 2 and kernel 3 once
       each and nothing else, and torch.profiler sees no torch kernel in
       it (no YIQ plane, padded slab or output stack);
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
     - (j) 3840x2160 `tuned_for_tpu()` (square_pow2, 4096x4096), chunks
       of 8, shifted noise: kernels 5, 1, 2, 3, frames 0-1 > 100 dB
       against the oracle; 2160p tight (H = 2176, m = 17): kernels 1, 2,
       3; the scan engine at 4096 (3 frames): kernels 1, 5, 6, 7, > 100
       dB;
     - (l) 7680x4320 `tuned_for_tpu()` (square_pow2, 8192x8192), chunks
       of 2, shifted noise: kernels 5, 1, 2, 3 (or 7 + 10 where
       `kernel3_serves` routes them); 4320p tight (H = 4352, m = 34):
       kernels 1, 2 and the tail; the scan engine at 8192 (2 frames):
       kernels 1, 5, 6, 7; each > 100 dB against the oracle on frames 0-1,
       the batched two with chunks of 1 + 1 equal to one of 2;
     - (k) 1080p tight at blur_size 4.5 (radius 15), the bench clip: no
       kernel-3 block fits (and from radius 6 at 1080p the route takes
       kernels 7 + 10 anyway), so kernels 1, 2, 7, 10 (and 4, 2, 7, 10 from
       planar uint8 to planar_u8), > 100 dB; and at blur_size 1.5
       (radius 5): kernels 1, 2, 3;
     - (n) the multi-device engines (`pbmm_tpu_torch.parallel`) on a
       world of one over NCCL: `magnify_clip_batched` at 1080p
       `tuned_for_tpu()` on the bench clip (kernels 1, 8, 6, 7; > 100 dB
       against the oracle), `magnify_batch_sharded` on a (1, 1) mesh
       (bit for bit the batched clip), `magnify_video_spatial` on a
       ("rows",) mesh of one (kernels 8, 6 with fx_values, 7) at 1080p
       square_pow2 and at 720p rect_pow2 in standard mode at 2.5 and
       with the IIR taps, each > 70 dB against `magnify_video` on the
       same config (its PSNR against the oracle on frames 0-1 printed);
     - (o) `MagnifyConfig(fft_backend="mxu")` (the CLI's `--fft-backend
       mxu`), the 1080p bar at square_pow2: the scan engine on the mxu
       transforms, no kernel; > 100 dB against the oracle, > 70 dB
       against (e), and one `magnify_frame_pair` > 100 dB against the
       chunk's frame;
     - (p) a 32-frame 1080p uint8 .npy and its f32 twin through
       `stream_magnify` with `tuned_for_tpu()` (kernels 5, 1, 2, 3), read
       by the native loader (`pbmm_tpu_torch/native`, built with g++, in
       its raw mode through a pinned host buffer; the run fails if it
       does not serve every chunk): bit for bit the memmap route
       and `magnify_video` on the whole clip, u8 equal to its twin, and
       `stream_magnify_resumable` stopped after one chunk and resumed
       equal to an uninterrupted run;
     - (i) the measurement path, through the tools: `roofline_table` at
       1080p (kernels 1, 2, 3 and the row-tile copy ceiling), kexp's
       experiments (kernels 1, 5, 6, 7), the copy probe's rows and strips
       of 2-32 columns beside `Tensor.copy_` at kexp's shape and on a
       16-frame stack (GB/s, warm and cold), kdecomp's six variants and
       kernel 6 on the same planes at one frame and at 16 (each piece's
       share, and the full variant against kernel 6), the trig probe,
       and the CLI's `--demo bar --fast --trace DIR --stats` (the trace
       must name kernel 1) and `--debug-view split`: kernels 12, 13, 14;
     each finite in [0, 1], two half chunks equal to one chunk bit for
       bit, (a)-(c), (e)-(h) and (k) > 100 dB against the oracle on frames
       0-3 (the oracle runs on host threads while the card works);
  4. timing with CUDA events after warm-up (medians): steady-state chunk
     frames/s of each path (pairs/s for (h)), each kernel and each
     variant or branch beside its plain version and, for the FFT kernels,
     one `torch.fft` call on the same shape and axis (the copy probe:
     one `Tensor.copy_`; the trig probe's atan2: `torch.atan2`; kernel
     8's row pass beside `torch.fft` along dim -1; kernels 7, 4 and 1, the
     row engine's, each on a line of its own beside its call), the
     designs' alternatives (kernel 6 on half its strip, kernel 3 with 1, 2
     and 4 region rows in flight at radii 2 and 5, kernel 3 against
     kernel 7 + kernel 10 at radii 2-14, f32 and uint8 chroma), and the
     y4m stream's
     frames/s with the host's parse share; path (n)'s calls (frames/s of
     one call of each engine); path (o)'s chunk with its idle share
     (torch.profiler) and the two mxu transforms alone beside
     torch.fft and their bound; path (p)'s .npy stream on the host clock,
     the native loader against the memmap, u8 and f32, and each chunk
     source alone, with the loader's f32 mode (the JAX package's
     contract: uint8 scaled on the host) beside them.  Kernels, plain
     versions and library calls are timed by the device's time alone
     (`tools.kexp.timed`: a spin of the card ahead of each event pair
     covers the host's enqueue), each kernel warm (relaunched on the same
     inputs) and cold (a 128 MB write before each launch, outside the
     timing: its inputs out of L2), and also, as before, with the host's
     enqueue inside one event pair around one call (`ms_enqueued`);
  5. with --profile only: torch.profiler over a few steady-state chunks
     of the f32 1080p, u8 1080p, 540p paths and paths (a)-(g), (j)-(o)
     (one call of each engine of (n)),
     printing where the device time of a chunk goes (each kernel's
     share) and the device's idle share with the profiler on.

The line before the last but one is one JSON object with the kernels'
records: each kernel's launches on the path named beside it, its max abs
error against its plain version, the kernel's, the plain version's and
the library call's times, and its bound: the larger of the bytes it must
move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100
SXM's published peaks), counted from this run's shapes (the post
kernels' variants carry theirs too).  Then the
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
H4K, W4K, T4K = 2160, 3840, 8  # square_pow2: 4096 x 4096; tight: 2176 rows
H8K, W8K, T8K = 4320, 7680, 2  # square_pow2: 8192 x 8192; tight: 4352 rows
H16, W16, T16 = 8640, 15360, 2  # 16K: 16384 x 16384; tight: 8704 rows
M_TOP = 63  # the four-step's largest m (m = 64 is 8192 rows: radix-2)
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


def spec_err(got, want):
    """(max abs error, max error / max magnitude) of complex pairs."""
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    den = max(float(w.abs().max()) for w in want)
    return num, num / den


def psnr_db(got, want):
    mse = float(np.mean((np.asarray(got, np.float64) - want) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def profile_chunks(torch, chunk, card, what, n=5, top=12, tag="[5]"):
    """Phase 5: device time per chunk by kernel, and the idle share, from
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 5, the per-kernel device-time "
                             "breakdown of a steady-state chunk")
    args = parser.parse_args()
    # Path (m) holds 16K planes beside the earlier paths' tensors: let the
    # allocator grow segments rather than leave freed blocks stranded.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
        chroma_planes,
        magnify_frame_pair,
        preprocess,
        preprocess_cl,
    )
    from pbmm_tpu_torch.io import stream, y4m
    from pbmm_tpu_torch.io.device_decode import ycbcr_planes_to_rgb_planar_u8
    from pbmm_tpu_torch.kernels.build import build, library
    from pbmm_tpu_torch import native
    from pbmm_tpu_torch.oracle import reference as oracle
    from pbmm_tpu_torch.parallel import (
        magnify_batch_sharded,
        magnify_clip_batched,
        magnify_video_spatial,
        make_mesh,
    )
    from pbmm_tpu_torch.parallel.launcher import (
        free_port,
        init_world,
        rank_device,
    )
    from pbmm_tpu_torch.oracle import synthetic
    from pbmm_tpu_torch.phase import fused_kernels
    from pbmm_tpu_torch.pyramid.filters import freq_axes
    from pbmm_tpu_torch.spectral import fused, radix2
    from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width
    from pbmm_tpu_torch.spectral import mxu_fft
    from pbmm_tpu_torch import cli as port_cli
    from pbmm_tpu_torch.tools import (
        kdecomp,
        kexp,
        post_times,
        roofline,
        trig_probe,
    )
    from pbmm_tpu_torch.utils.debug import debug_frame_view

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 0. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[0] device: {kind}; nvidia-smi name, power limit: {card}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # Path (m)'s fp64 oracles (16K: 16384 x 16384 FFTs, ~50 GB of host
    # memory at square_pow2, ~370 s) start first, one after the other on a
    # thread of their own, and run beside the build and phases 2-4; their
    # results are read after phase 4.  Square_pow2's serves the scan engine
    # and (g) too (the same function); then tight's.
    base16 = np.random.default_rng(5).random((H16, W16, 3), np.float32)
    frames16 = np.stack([np.roll(base16, shift=i, axis=1) * (0.95 + 0.01 * i)
                         for i in range(T16)]).astype(np.float32)
    del base16
    big_pool = ThreadPoolExecutor(1)

    def oracle16(c):
        def run():
            t1 = time.perf_counter()
            return (oracle.oracle_magnify_video(frames16, c),
                    time.perf_counter() - t1)
        return big_pool.submit(run)

    cfg_tuned = pbmm_tpu_torch.MagnifyConfig().tuned_for_tpu()
    jobs16 = {"m": oracle16(cfg_tuned),
              "mt": oracle16(cfg_tuned.replace(pad_mode="tight"))}

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
    # The front end's inputs at 1080p: the main path's f32 interleaved
    # frames, and the other input forms (its own seed).
    rng_fe = np.random.default_rng(15)
    fe_f32 = dev_t(rng_fe.random((T, H, W, 3), np.float32))
    fe_u8 = torch.from_numpy(rng_fe.integers(0, 256, (T, H, W, 3),
                                             dtype=np.uint8)).to(dev)
    fe_planar = fe_f32.permute(0, 3, 1, 2).contiguous()
    rows3 = tuple(tuple(float(c) for c in r) for r in RGB_TO_YIQ)
    fe_geo = (geom.pad_h, geom.pad_w, geom.y0, geom.x0, r0, True)
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

    # Blur radii 5, 13 and 15 (blur_size 1.5, 4.0 and 4.5): kernel 3 with
    # a longer ring at 5; kernels 7 + 10 in its place at 13 (from radius
    # 6 a kernel-3 block leaves one block an SM) and 15 (no kernel-3 block fits 2048 lanes
    # and 1920 columns); kernels 11 and 10 with 11, 27 and 31 taps a row.
    cfg_b15, cfg_b40, cfg_b45 = (cfg.replace(blur_size=b)
                                 for b in (1.5, 4.0, 4.5))
    assert all(blur_row_window(geom, c) == rows
               for c in (cfg_b15, cfg_b40, cfg_b45))
    assert post_fused.kernel3_serves(post_fused._radius(cfg_b15),
                                     geom.pad_w, W)
    assert not any(post_fused.kernel3_serves(post_fused._radius(c),
                                             geom.pad_w, W)
                   for c in (cfg_b40, cfg_b45))
    # 2160p: square_pow2 (H = 4096, kernel 5's two passes, kernels 2 and 6
    # on strips of 4 and 2) and tight (H = 2176, four-step m = 17), a chunk
    # of 8.
    cfg_j = cfg_tuned
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
    def dev_n(shape, scale=1.0):  # f32 normals, made in f32 on the host
        return dev_t(scale * rng.standard_normal(shape, dtype=np.float32))

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
    # and 0 (random spectra at this size: the card-only
    # test_amplify_procedural_16k_random_spectra).
    frames16_d = torch.from_numpy(frames16).to(dev)
    k9x_cur, k9x_prev = (spectra(frames16_d[i], cfg_g) for i in (1, 0))

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
        "windowed_row_fft_frames": both(fused.windowed_row_fft_frames,
                                        fe_f32, rows3[:1], *fe_geo),
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
        # The front end's other input forms, and the tail's source chroma
        # and interleaved layout at the main path's call.
        "windowed_row_fft_frames[u8 interleaved]": both(
            fused.windowed_row_fft_frames, fe_u8, rows3[:1], *fe_geo),
        "windowed_row_fft_frames[f32 planar]": both(
            fused.windowed_row_fft_frames, fe_planar, rows3[:1], *fe_geo),
        "windowed_row_fft_frames[rgb 3 planes]": both(
            fused.windowed_row_fft_frames, fe_f32, rows3, *fe_geo),
        "rowifft_post_fused[f32 frames, interleaved]": both(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=fe_f32, out_layout="interleaved"),
        "rowifft_post_fused[u8 frames, interleaved]": both(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=fe_u8, out_layout="interleaved"),
        "post_fused_rgb[interleaved]": both(
            post_fused.post_fused_rgb, *rgb_post_args,
            out_layout="interleaved"),
        "rowifft_post_fused[u8, planar_u8]": both(
            post_fused.rowifft_post_fused, *post_u8_args, full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8"),
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
        # Blur radii 5, 13 and 15 (kernels 3, 11, 10; kernel 3's route).
        "rowifft_post_fused[blur 1.5, radius 5]": both(
            post_fused.rowifft_post_fused, rre, rim, i_pl, q_pl, win,
            cfg_b15, rows[0], H, W, "tight", full_w=geom.pad_w),
        "rowifft_post_fused[blur 4.0, radius 13: kernels 7 + 10, u8, "
        "planar_u8]": both(
            post_fused.rowifft_post_fused, rre, rim, None, None, win,
            cfg_b40, rows[0], H, W, "tight", full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8"),
        "rowifft_post_fused[blur 4.5, radius 15: kernels 7 + 10, u8, "
        "planar_u8]": both(
            post_fused.rowifft_post_fused, rre, rim, None, None, win,
            cfg_b45, rows[0], H, W, "tight", full_w=geom.pad_w,
            src=u8_frames, out_layout="planar_u8"),
        "post_fused_rgb[blur 1.5, radius 5]": both(
            post_fused.post_fused_rgb, rec3, win,
            cfg_rgb.replace(blur_size=1.5), rows[0], H, W, "tight",
            out_layout="planar_u8"),
        "post_fused_rgb[blur 4.0, radius 13]": both(
            post_fused.post_fused_rgb, rec3, win,
            cfg_rgb.replace(blur_size=4.0), rows[0], H, W, "tight",
            out_layout="planar_u8"),
        "post_fused[blur 4.0, radius 13, u8 chroma, planar_u8]": both(
            post_fused.post_fused, rec1, None, None, win, cfg_b40, rows[0],
            H, W, "tight", "planar_u8", src=u8_frames),
        "post_fused[u8 chroma, planar_u8]": both(
            post_fused.post_fused, rec1, None, None, win, cfg, rows[0], H,
            W, "tight", "planar_u8", src=u8_frames),
        "post_fused[blur 1.5, radius 5]": both(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_b15, rows[0],
            H, W, "tight"),
        # Path (k)'s calls: f32 frames (tuple3), u8 frames to planar_u8.
        "post_fused[blur 4.5, radius 15]": both(
            post_fused.post_fused, rec1, i_pl, q_pl, win, cfg_b45, rows[0],
            H, W, "tight"),
        "post_fused[blur 4.5, radius 15, f32 frames, interleaved]": both(
            post_fused.post_fused, rec1, None, None, win, cfg_b45, rows[0],
            H, W, "tight", "interleaved", src=fe_f32),
        "post_fused[blur 4.5, radius 15, u8 chroma, planar_u8]": both(
            post_fused.post_fused, rec1, None, None, win, cfg_b45, rows[0],
            H, W, "tight", "planar_u8", src=u8_frames),
        "post_fused_rgb[blur 4.5, radius 15]": both(
            post_fused.post_fused_rgb, rec3, win,
            cfg_rgb.replace(blur_size=4.5), rows[0], H, W, "tight",
            out_layout="planar_u8"),
        # 2160p: H = 4096 (kernel 2 on strips of 4; kernel 5's passes) and
        # m = 17.
        "colspec_chunk[pow-2, H 4096, 2160p square_pow2]": both(
            fused.colspec_chunk, k4_re, k4_im, *k4_prev, cfg_j, g4k.pad_h,
            r0_4k, **k4_kw),
        "colspec_chunk[tight m 17, 2160p]": both(
            fused.colspec_chunk, t4_re, t4_im, *t4_prev, cfg, g4t.pad_h,
            r0_4t, out_rows=rows_4t, full_w=g4t.pad_w),
        "col_fft_zero_padded[H 4096, 2160p]": both(
            fused.col_fft_zero_padded, k4_re[:1], k4_im[:1], g4k.pad_h,
            r0_4k),
        "phase_col_ifft[H 4096, 2160p]": both(
            fused.phase_col_ifft, *k4_next, *k4_prev, cfg_j, **k4_kw),
        "kdecomp_variant[phase + gm + rolls, H 4096]": both(
            kdecomp.kdecomp_variant, *k4_next, *k4_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_4k, full_w=g4k.pad_w),
        # 4320p: H = 8192 (kernels 2 and 6 on strips of 2, 12 on strips of
        # 1, kernel 5's three passes), tight m = 34 and m = 63.
        "colspec_chunk[pow-2, H 8192, 4320p square_pow2]": both(
            fused.colspec_chunk, k8k_re, k8k_im, *k8k_prev, cfg_j,
            g8k.pad_h, r0_8k, **k8_kw),
        "colspec_chunk[tight m 34, 4320p]": both(
            fused.colspec_chunk, t8_re, t8_im, *t8_prev, cfg, g8t.pad_h,
            r0_8t, out_rows=rows_8t, full_w=g8t.pad_w),
        f"colspec_chunk[tight m {M_TOP}, {h63} rows]": both(
            fused.colspec_chunk, t63_re, t63_im, *t63_prev, cfg, h63, 32,
            out_rows=rows_63, full_w=g8k.pad_w),
        "col_fft_zero_padded[H 8192, 4320p]": both(
            fused.col_fft_zero_padded, k8k_re[:1], k8k_im[:1], g8k.pad_h,
            r0_8k),
        "phase_col_ifft[H 8192, 4320p]": both(
            fused.phase_col_ifft, *k8k_next, *k8k_prev, cfg_j, **k8_kw),
        "kdecomp_variant[phase + gm + rolls, H 8192]": both(
            kdecomp.kdecomp_variant, *k8k_next, *k8k_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_8k, full_w=g8k.pad_w),
        # Kernel 8's row pass (the row engine) at 8192 points.
        "_fft_axis[inverse, axis 2, scale, 8192]": both(
            radix2._fft_axis, k8w_re, k8w_im, 2, True, 1.0 / (512 * 8192)),
        "_fft_axis[forward real, axis 2, 8192]": both(
            radix2._fft_axis, k8w_re, None, 2, False),
        "_fft_axis[forward complex, axis 2, 8192]": both(
            radix2._fft_axis, k8w_re, k8w_im, 2, False),
        # 16K, path (m)'s calls: every kernel past 8192 points (the bracket
        # passes around the block engines; kernel 2's combine pass at m =
        # 68), kernels 10 on a 15360-column crop and 9 on (m) (g)'s full
        # 16384 x 16384 spectra.
        "windowed_row_fft[16384 lanes, 16K square_pow2]": both(
            fused.windowed_row_fft, y16, g16.pad_h, r0_16, True),
        "windowed_row_fft_u8planar[16384 lanes, 16K]": both(
            fused.windowed_row_fft_u8planar, *u8_args16),
        "windowed_row_fft_frames[16384 lanes, 16K square_pow2]": both(
            fused.windowed_row_fft_frames, frames16_d, rows3[:1], g16.pad_h,
            g16.pad_w, g16.y0, g16.x0, r0_16, True),
        "colspec_chunk[pow-2, H 16384, 16K square_pow2]": both(
            fused.colspec_chunk, k16_re, k16_im, *k16_prev, cfg_j,
            g16.pad_h, r0_16, **k16_kw),
        "colspec_chunk[tight m 68, 16K]": both(
            fused.colspec_chunk, t16_re, t16_im, *t16_prev, cfg, g16t.pad_h,
            r0_16t, out_rows=rows_16t, full_w=g16t.pad_w),
        "col_fft_zero_padded[H 16384, 16K]": both(
            fused.col_fft_zero_padded, k16_re[:1], k16_im[:1], g16.pad_h,
            r0_16),
        "phase_col_ifft[H 16384, 16K]": both(
            fused.phase_col_ifft, *k16_next, *k16_prev, cfg_j, **k16_kw),
        "kdecomp_variant[phase + gm + rolls, H 16384]": both(
            kdecomp.kdecomp_variant, *k16_next, *k16_prev, cfg_j,
            kdecomp.VARIANTS[-1][1], rows_16, full_w=g16.pad_w),
        "row_ifft_magnitude[16384 lanes, 16K]": both(
            fused.row_ifft_magnitude, rre16, rim16, pad_h=g16.pad_h,
            full_w=g16.pad_w),
        "post_fused[16K, crop 15360, f32 frames, interleaved]": both(
            post_fused.post_fused, rec16_1, None, None, win16, cfg_j,
            rows_16[0], H16, W16, "square_pow2", "interleaved",
            src=frames16_d),
        "_fft_axis[inverse, axis 2, scale, 16384]": both(
            radix2._fft_axis, k8x_re, k8x_im, 2, True,
            1.0 / (g16.pad_h * g16.pad_w)),
        "_fft_axis[forward real, axis 2, 16384]": both(
            radix2._fft_axis, k8x_re, None, 2, False),
        "_fft_axis[inverse, axis 1, 16384]": both(
            radix2._fft_axis, k8x_re, k8x_im, 1, True, 1.0),
        "_fft_axis[forward complex, axis 1, 16384]": both(
            radix2._fft_axis, k8x_re, k8x_im, 1, False),
        "amplify_procedural[16K (g), (1, 16384, 16384)]": both(
            fused_kernels.amplify_procedural, *k9x_cur, *k9x_prev,
            *axes_b16, *k9_args(cfg_g)),
        # The measurement path's kernels: kdecomp's other piece sets, the
        # copy patterns at both sizes.
        **{f"kdecomp_variant[{name}]": both(
            kdecomp.kdecomp_variant, *kd, cfg_t, pieces, kd_rows,
            full_w=kd_fw) for name, pieces in kdecomp.VARIANTS[:-1]},
        **{f"copy_probe[{pat} {blk}{', 16 frames' if big else ''}]": both(
            kexp.copy_probe, *(cp16 if big else cp1), pat, blk)
           for big in (False, True) for pat, blk in COPY_PATTERNS
           if big or (pat, blk) != ("rows", 1)},
    }
    # The post kernels' variants above: (kernel, config, uint8 chroma,
    # layout), for their bounds (post_work below).
    post_variants = {
        "rowifft_post_fused[f32 frames, interleaved]": (
            3, cfg, "f32", "interleaved"),
        "rowifft_post_fused[u8 frames, interleaved]": (
            3, cfg, True, "interleaved"),
        "post_fused_rgb[interleaved]": (11, cfg_rgb, False, "interleaved"),
        "post_fused[blur 4.5, radius 15, f32 frames, interleaved]": (
            10, cfg_b45, "f32", "interleaved"),
        "rowifft_post_fused[u8, planar_u8]": (3, cfg, True, "planar_u8"),
        "rowifft_post_fused[f32, planar]": (3, cfg, False, "planar"),
        "rowifft_post_fused[real, compensate, gains]": (3, cfg_str),
        "post_fused_rgb[tuple3, compensate, gains]": (
            11, cfg_str.replace(chroma="rgb")),
        "post_fused[planar_u8]": (10, cfg, False, "planar_u8"),
        "post_fused[compensate, gains]": (10, cfg_str),
        "rowifft_post_fused[blur 1.5, radius 5]": (3, cfg_b15),
        "rowifft_post_fused[blur 4.0, radius 13: kernels 7 + 10, u8, "
        "planar_u8]": (
            3, cfg_b40, True, "planar_u8"),
        "rowifft_post_fused[blur 4.5, radius 15: kernels 7 + 10, u8, "
        "planar_u8]": (3, cfg_b45, True, "planar_u8"),
        "post_fused_rgb[blur 1.5, radius 5]": (
            11, cfg_rgb.replace(blur_size=1.5), False, "planar_u8"),
        "post_fused_rgb[blur 4.0, radius 13]": (
            11, cfg_rgb.replace(blur_size=4.0), False, "planar_u8"),
        "post_fused_rgb[blur 4.5, radius 15]": (
            11, cfg_rgb.replace(blur_size=4.5), False, "planar_u8"),
        "post_fused[blur 4.0, radius 13, u8 chroma, planar_u8]": (
            10, cfg_b40, True, "planar_u8"),
        "post_fused[u8 chroma, planar_u8]": (10, cfg, True, "planar_u8"),
        "post_fused[blur 1.5, radius 5]": (10, cfg_b15),
        "post_fused[blur 4.5, radius 15]": (10, cfg_b45),
        "post_fused[blur 4.5, radius 15, u8 chroma, planar_u8]": (
            10, cfg_b45, True, "planar_u8"),
    }
    assert set(post_variants) | {
        "post_fused[16K, crop 15360, f32 frames, interleaved]"} == {
        k for k in variants if k.startswith(("rowifft_post_fused",
                                             "post_fused"))}
    # What each kernel's call above must move and compute, and the one
    # torch call that computes the same transform (FFT kernels only):
    # name -> (bytes, f32 operations, library call or None).  Bytes: each
    # input read once, each output written once.  Operations: 5 n log2 n
    # per complex radix-2 transform of length n, and per element of the
    # other stages a count of their multiplies and adds (the phase pass
    # ~40, a mask level ~15, the separable blur 4 r + 1 products and sums
    # a pixel and plane each way, the post epilogue ~20), so the bound is
    # a floor.
    f4 = 4
    n_sq = g_sq.pad_h * g_sq.pad_w

    def fft_ops(n, count):
        return 5.0 * n * np.log2(n) * count

    def post_work(kernel, c, u8=False, layout="tuple3"):
        """(bytes, f32 operations) of one call of post kernel 3, 10 or 11
        at the 1080p shapes under config c: the region rows the output
        needs (the crop's H + 2 r rows; kernel 3: all kept lanes of each,
        its row transform's input; 10 and 11: the W + 2 r columns the
        blur reads), the chroma (f32 I/Q, the uint8 frames (u8 True) or
        the f32 frames (u8 "f32"); none for 11), the window where the
        call reads it and the three output
        planes; the blur 2 (4 r + 1) a pixel and plane (2 r + 1 products
        and 2 r sums each way), the epilogue 20, kernel 3's row transform
        5 W log2 W a region row."""
        px, r = T * H * W, post_fused._radius(c)
        planes = 3 if kernel == 11 else 1
        rows_in = (2 * T * (H + 2 * r) * wk if kernel == 3
                   else planes * T * (H + 2 * r) * (W + 2 * r))
        chroma = (0 if kernel == 11 else 3 * f4 * px if u8 == "f32"
                  else 3 * px if u8 else 2 * f4 * px)
        window = 0 if kernel == 11 and not c.compensate_window else H * W
        out = 3 * px * (1 if layout == "planar_u8" else f4)
        ops = (2 * (4 * r + 1) * planes + 20) * px
        if kernel == 3:
            ops += fft_ops(geom.pad_w, T * (H + 2 * r))
        return f4 * (rows_in + window) + chroma + out, ops

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
        "rowifft_post_fused": (*post_work(3, cfg), None),
        "windowed_row_fft_u8planar": (
            u8_frames.numel() + 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 8 * T * H * W,
            lambda: torch.fft.fft(y[:, u8_r0:u8_r1], dim=-1)),
        # the frames read once, the kept spectrum written; the plane's 5
        # products and sums and the window's 2 a pixel
        "windowed_row_fft_frames": (
            f4 * fe_f32.numel() + 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 7 * T * H * W,
            lambda: torch.fft.fft(y[:, u8_r0:u8_r1], dim=-1)),
        "row_ifft_magnitude": (
            f4 * (2 * rre.numel() + T * hr * geom.pad_w),
            fft_ops(geom.pad_w, T * hr) + 3 * T * hr * geom.pad_w,
            lambda: torch.fft.irfft(irfft_in, n=geom.pad_w, dim=-1)),
        "col_fft_zero_padded": (
            2 * f4 * (hc_sq * wk + g_sq.pad_h * wk),
            fft_ops(g_sq.pad_h, wk), lambda: torch.fft.fft(col_in, dim=-2)),
        "post_fused_rgb": (*post_work(11, cfg_rgb, layout="planar_u8"),
                           None),
        "phase_col_ifft": (  # + the two host planes of the main branch
            f4 * (6 * k6_cur[0].numel() + 2 * hr_sq * wk),
            fft_ops(g_sq.pad_h, wk) + 40 * g_sq.pad_h * wk, None),
        "_fft_axis": (
            f4 * 4 * n_sq, fft_ops(g_sq.pad_h, g_sq.pad_w),
            lambda: torch.fft.ifft(fft_in, dim=-2)),
        "amplify_procedural": (
            f4 * (6 * n_sq + g_sq.pad_h + g_sq.pad_w),
            (15 * cfg_g.pyramid_levels + 40) * n_sq, None),
        "post_fused": (*post_work(10, cfg), None),
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

    def colspec_bytes(rows_t, prev_t, n_rows, hr_, wk_, taps=False):
        """Bytes one kernel 2 call must move: the content rows in, the
        output rows out, the state (prev, with the IIR taps) in and out."""
        state = (4 if taps else 2) * prev_t.numel()
        return f4 * (2 * rows_t.numel() + 2 * state + 2 * n_rows * hr_ * wk_)

    hr8k, hr8t = rows_8k[1] - rows_8k[0], rows_8t[1] - rows_8t[0]
    n8k = 8192 * 512
    # The variants' bounds, where this PR's kernels run: kernel 2's IIR
    # call of path (b), the heights of 4320p, kernel 8's row pass.
    variant_work = {
        "colspec_chunk[rgb 3 planes, IIR]": (
            colspec_bytes(rgb_rows[0], rgb_state[0], 3 * T, hr, wk, True),
            fft_ops(geom.pad_h, 2 * 3 * T * wk)
            + 40 * 3 * T * geom.pad_h * wk),
        "colspec_chunk[pow-2, H 8192, 4320p square_pow2]": (
            colspec_bytes(k8k_re, k8k_prev[0], T8K, hr8k, wk8),
            fft_ops(g8k.pad_h, 2 * T8K * wk8) + 40 * T8K * g8k.pad_h * wk8),
        "colspec_chunk[tight m 34, 4320p]": (
            colspec_bytes(t8_re, t8_prev[0], T8K, hr8t, wk8),
            fft_ops(g8t.pad_h, 2 * T8K * wk8) + 40 * T8K * g8t.pad_h * wk8),
        f"colspec_chunk[tight m {M_TOP}, {h63} rows]": (
            colspec_bytes(t63_re, t63_prev[0], T8K, rows_63[1] - rows_63[0],
                          wk8),
            fft_ops(h63, 2 * T8K * wk8) + 40 * T8K * h63 * wk8),
        "col_fft_zero_padded[H 8192, 4320p]": (
            2 * f4 * ((r1_8k - r0_8k) * wk8 + g8k.pad_h * wk8),
            fft_ops(g8k.pad_h, wk8)),
        "phase_col_ifft[H 8192, 4320p]": (
            f4 * (6 * k8k_next[0].numel() + 2 * hr8k * wk8),
            fft_ops(g8k.pad_h, wk8) + 40 * g8k.pad_h * wk8),
        "kdecomp_variant[phase + gm + rolls, H 8192]": (
            f4 * (4 * k8k_next[0].numel() + 2 * hr8k * wk8),
            fft_ops(g8k.pad_h, wk8) + 40 * g8k.pad_h * wk8),
        "_fft_axis[inverse, axis 2, scale]": (
            f4 * 4 * n_sq, fft_ops(g_sq.pad_w, g_sq.pad_h)),
        "_fft_axis[forward real, axis 2]": (
            f4 * 3 * n_sq, fft_ops(g_sq.pad_w, g_sq.pad_h)),
        "_fft_axis[forward complex, axis 2]": (
            f4 * 4 * n_sq, fft_ops(g_sq.pad_w, g_sq.pad_h)),
        "_fft_axis[inverse, axis 2, scale, 8192]": (
            f4 * 4 * n8k, fft_ops(8192, 512)),
        "_fft_axis[forward real, axis 2, 8192]": (
            f4 * 3 * n8k, fft_ops(8192, 512)),
        "_fft_axis[forward complex, axis 2, 8192]": (
            f4 * 4 * n8k, fft_ops(8192, 512)),
        # 16K (m): the same counts at 16384 points.
        "windowed_row_fft[16384 lanes, 16K square_pow2]": (
            f4 * (y16.numel() + 2 * y16.shape[0] * y16.shape[1] * wk16),
            fft_ops(g16.pad_w, y16.shape[0] * y16.shape[1])),
        "windowed_row_fft_u8planar[16384 lanes, 16K]": (
            u8_16.numel() + f4 * 2 * T16 * (r1_16 - r0_16) * wk16,
            fft_ops(g16.pad_w, T16 * (r1_16 - r0_16))),
        "windowed_row_fft_frames[16384 lanes, 16K square_pow2]": (
            f4 * frames16_d.numel() + f4 * 2 * T16 * (r1_16 - r0_16) * wk16,
            fft_ops(g16.pad_w, T16 * (r1_16 - r0_16)) + 7 * T16 * H16 * W16),
        "windowed_row_fft_frames[u8 interleaved]": (
            fe_u8.numel() + 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 8 * T * H * W),
        "windowed_row_fft_frames[f32 planar]": (
            f4 * fe_planar.numel() + 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 7 * T * H * W),
        "windowed_row_fft_frames[rgb 3 planes]": (
            f4 * fe_f32.numel() + 3 * 2 * f4 * T * (u8_r1 - u8_r0) * wk,
            3 * (fft_ops(geom.pad_w, T * (u8_r1 - u8_r0)) + 7 * T * H * W)),
        "colspec_chunk[pow-2, H 16384, 16K square_pow2]": (
            colspec_bytes(k16_re, k16_prev[0], T16, hr16, wk16),
            fft_ops(g16.pad_h, 2 * T16 * wk16) + 40 * T16 * g16.pad_h * wk16),
        "colspec_chunk[tight m 68, 16K]": (
            colspec_bytes(t16_re, t16_prev[0], T16,
                          rows_16t[1] - rows_16t[0], wk16),
            # the combine's m complex MACs a point each way, the 128-point
            # factor and the phase pass
            8 * 68 * 2 * T16 * g16t.pad_h * wk16
            + fft_ops(128, 2 * T16 * 68 * wk16)
            + 40 * T16 * g16t.pad_h * wk16),
        "col_fft_zero_padded[H 16384, 16K]": (
            2 * f4 * ((r1_16 - r0_16) * wk16 + g16.pad_h * wk16),
            fft_ops(g16.pad_h, wk16)),
        "phase_col_ifft[H 16384, 16K]": (
            f4 * (6 * k16_next[0].numel() + 2 * hr16 * wk16),
            fft_ops(g16.pad_h, wk16) + 40 * g16.pad_h * wk16),
        "kdecomp_variant[phase + gm + rolls, H 16384]": (
            f4 * (4 * k16_next[0].numel() + 2 * hr16 * wk16),
            fft_ops(g16.pad_h, wk16) + 40 * g16.pad_h * wk16),
        "row_ifft_magnitude[16384 lanes, 16K]": (
            f4 * (2 * rre16.numel() + T16 * hr16 * g16.pad_w),
            fft_ops(g16.pad_w, T16 * hr16)),
        "_fft_axis[inverse, axis 2, scale, 16384]": (
            f4 * 4 * k8x_re.numel(), fft_ops(g16.pad_w, g16.pad_h)),
        "_fft_axis[forward real, axis 2, 16384]": (
            f4 * 3 * k8x_re.numel(), fft_ops(g16.pad_w, g16.pad_h)),
        "_fft_axis[inverse, axis 1, 16384]": (
            f4 * 4 * k8x_re.numel(), fft_ops(g16.pad_h, g16.pad_w)),
        "_fft_axis[forward complex, axis 1, 16384]": (
            f4 * 4 * k8x_re.numel(), fft_ops(g16.pad_h, g16.pad_w)),
        # 4 planes in, 2 out; ~15 f32 operations a level and bin and ~40
        # for the gate and the rotation
        "amplify_procedural[16K (g), (1, 16384, 16384)]": (
            f4 * 6 * k8x_re.numel(), (15 * 5 + 40) * k8x_re.numel()),
        "post_fused[16K, crop 15360, f32 frames, interleaved]": (
            f4 * (T16 * (H16 + 4) * (W16 + 4) + 3 * T16 * H16 * W16
                  + win16.numel() + 3 * T16 * H16 * W16),
            (2 * (4 * 2 + 1) + 20) * T16 * H16 * W16),
    }
    # Path (n)'s kernels at the shapes rows shards of a 1080p square_pow2
    # frame give them (p = 2, 4, 8: the last shard, idx = p - 1): kernel 6
    # with fx_values on the shard's column slice (T, 2048, 2048 / p) of the
    # whole-lane spectra of the 16 bar frames (each frame's prev the one
    # before), with the shard's slice of the bit-reversed lane table;
    # kernel 8 on the row band (T, 2048 / p, 2048) (real) and the column
    # slice (complex), kernel 7 on the row band.
    n_re, n_im = (x.reshape(T, g_sq.pad_h, g_sq.pad_w).contiguous() for x in
                  split(preprocess(bar_il_d, cfg_full)[0]))
    n_prev = [torch.cat([x[:1], x[:-1]]).contiguous() for x in (n_re, n_im)]
    fx_table = dev_t(radix2.bitrev_freq_axis(g_sq.pad_w))
    cfg_n_iir = cfg_full.replace(temporal=TemporalConfig(mode="iir_bandpass"))
    n_branches = {"pyramid": cfg_full,
                  "standard 2.5": cfg_full.replace(mode="standard",
                                                   phase_scale=2.5),
                  "steerable 4, overlapping bands": cfg_full.replace(
                      orientations=4, pyramid_levels=6),
                  "IIR taps": cfg_n_iir}
    shard_variants, shard_work, shard_slices = {}, {}, {}
    for p_ in (2, 4, 8):
        wc_, hp_ = g_sq.pad_w // p_, g_sq.pad_h // p_
        sl = slice((p_ - 1) * wc_, p_ * wc_)
        cur_ = [x[..., sl].contiguous() for x in (n_re, n_im)]
        prv_ = [x[..., sl].contiguous() for x in n_prev]
        fx_ = fx_table[sl].contiguous()
        shard_slices[p_] = (sl, cur_, prv_, fx_)
        for br, c in n_branches.items():
            taps_ = ({} if c.temporal.mode == "two_frame" else dict(zip(
                ("lp_fast", "lp_slow"),
                (0.1 * dev_t(rng.standard_normal((T, g_sq.pad_h, wc_)))
                 for _ in range(2)))))
            name = f"phase_col_ifft[fx_values, {br}, W/p {wc_}]"
            shard_variants[name] = both(fused.phase_col_ifft, *cur_, *prv_,
                                        c, fx_values=fx_, **taps_)
            # planes read (spectra, prev, taps) and written (rows, taps)
            n_io = 10 if taps_ else 6
            shard_work[name] = (
                f4 * (n_io * T * g_sq.pad_h * wc_ + wc_),
                fft_ops(g_sq.pad_h, T * wc_)
                + (40 + 15 * c.pyramid_levels) * T * g_sq.pad_h * wc_)
        band = dev_t(rng.random((T, hp_, g_sq.pad_w)))
        k7_ = [dev_t(scale * rng.standard_normal((T, hp_, g_sq.pad_w)))
               for _ in range(2)]
        shard_variants[f"_fft_axis[shard rows, forward real, H/p {hp_}]"] = (
            both(radix2._fft_axis, band, None, 2, False))
        shard_work[f"_fft_axis[shard rows, forward real, H/p {hp_}]"] = (
            f4 * 3 * band.numel(), fft_ops(g_sq.pad_w, T * hp_))
        shard_variants[
            f"_fft_axis[shard columns, forward complex, W/p {wc_}]"] = both(
                radix2._fft_axis, *cur_, 1, False)
        shard_work[f"_fft_axis[shard columns, forward complex, W/p {wc_}]"] = (
            f4 * 4 * cur_[0].numel(), fft_ops(g_sq.pad_h, T * wc_))
        shard_variants[f"row_ifft_magnitude[shard rows, H/p {hp_}]"] = both(
            fused.row_ifft_magnitude, *k7_, pad_h=g_sq.pad_h)
        shard_work[f"row_ifft_magnitude[shard rows, H/p {hp_}]"] = (
            f4 * 3 * k7_[0].numel(),
            fft_ops(g_sq.pad_w, T * hp_) + 3 * k7_[0].numel())
    variants.update(shard_variants)
    variant_work.update(shard_work)
    # The measurement path's variants: kdecomp's other piece sets move
    # kernel 12's bytes; the copies their planes, read once, written once.
    variant_work.update({
        f"kdecomp_variant[{name}]": work["kdecomp_variant"][:2]
        for name, _ in kdecomp.VARIANTS[:-1]})
    variant_work.update({
        name: (2 * 2 * f4 * (cp16 if "16 frames" in name else cp1)[0].numel(),
               0) for name in variants if name.startswith("copy_probe[")})
    assert set(variant_work) <= set(variants)
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
        if name.startswith(("copy_probe", "kdecomp_variant[stream only]",
                            "kdecomp_variant[+gm matmul]",
                            "kdecomp_variant[+rolls]")):
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
    # Kernel 6 with fx_values on a shard's column slice = the same columns
    # of one full-width call with the whole table, bit for bit (columns
    # are independent), in every branch of path (n).
    for br, c in n_branches.items():
        taps_w = ({} if c.temporal.mode == "two_frame" else dict(zip(
            ("lp_fast", "lp_slow"), (0.1 * dev_t(rng.standard_normal(
                (T, g_sq.pad_h, g_sq.pad_w))) for _ in range(2)))))
        whole = fused.phase_col_ifft(n_re, n_im, *n_prev, c,
                                     fx_values=fx_table, **taps_w)
        for p_, (sl, cur_, prv_, fx_) in shard_slices.items():
            part = fused.phase_col_ifft(
                *cur_, *prv_, c, fx_values=fx_,
                **{k: v[..., sl].contiguous() for k, v in taps_w.items()})
            same = all(torch.equal(a, b[..., sl]) for a, b in
                       zip(part, whole))
            log(f"[2] phase_col_ifft[fx_values, {br}] on the column slice "
                f"of shard {p_ - 1} of {p_} ({cur_[0].shape[-1]} lanes) == "
                f"the same columns of one 2048-lane call: {same}")
            if not same:
                raise AssertionError(f"kernel 6 on a column slice differs "
                                     f"from the full-width call ({br}, "
                                     f"p = {p_})")
        del whole
    # Kernel 4's contract: the torch pre stage + kernel 1, bit for bit.
    def pre_stage_k1(fr, gg, r0_, rws=(luma,)):
        """The torch pre stage (`frames_slab`) + kernel 1 on frames."""
        gi = (gg.pad_h, gg.pad_w, gg.y0, gg.x0, r0_)
        _, hc_, off_ = fused._frames_args(fr, *gi)
        return fused.windowed_row_fft(
            fused.frames_slab(fr, rws, gg.pad_w, gg.x0, off_, hc_),
            gg.pad_h, r0_, True)

    k4 = fused.windowed_row_fft_u8planar(*u8_args)
    pre = pre_stage_k1(u8_frames, geom, r0)
    same = torch.equal(k4[0], pre[0]) and torch.equal(k4[1], pre[1])
    log(f"[2] windowed_row_fft_u8planar == pre stage + windowed_row_fft on "
        f"the same (16, 3, 1080, 1920) u8 frames: {same}")
    if not same:
        raise AssertionError("kernel 4 differs from the pre stage + kernel 1")
    del k4, pre
    # The same at 16K (15360 pixels a row, 16384 lanes: the bracket's byte
    # loads and the row engine on 8192-lane blocks).
    k4 = fused.windowed_row_fft_u8planar(*u8_args16)
    pre = pre_stage_k1(u8_16, g16, r0_16)
    same = torch.equal(k4[0], pre[0]) and torch.equal(k4[1], pre[1])
    log(f"[2] windowed_row_fft_u8planar == pre stage + windowed_row_fft on "
        f"the same {tuple(u8_16.shape)} u8 frames (16K, 16384 lanes): {same}")
    if not same:
        raise AssertionError("kernel 4 differs from the pre stage + kernel 1 "
                             "at 16K")
    del k4, pre
    # The front end = the torch pre stage (`frames_slab`: unit_float, the
    # colour rows, the centre pad) + kernel 1, bit for bit: the main
    # path's f32 interleaved frames, uint8 interleaved with three planes,
    # f32 planar, and path (m)'s 16K frames (16384 lanes).
    for what, fr, rws, gg, r0_ in (
            ("f32 interleaved, Y", fe_f32, rows3[:1], geom, r0),
            ("u8 interleaved, Y I Q", fe_u8, rows3, geom, r0),
            ("f32 planar, Y", fe_planar, rows3[:1], geom, r0),
            ("16K f32 interleaved, Y", frames16_d, rows3[:1], g16, r0_16)):
        got = fused.windowed_row_fft_frames(
            fr, rws, gg.pad_h, gg.pad_w, gg.y0, gg.x0, r0_, True)
        want = pre_stage_k1(fr, gg, r0_, rws)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        log(f"[2] windowed_row_fft_frames == pre stage + windowed_row_fft on "
            f"{what} {tuple(fr.shape)} -> {tuple(got[0].shape)}: {same}")
        if not same:
            raise AssertionError(f"the front end differs from the pre stage "
                                 f"+ kernel 1 ({what})")
    del got, want
    # Kernels 3 and 10 with the chroma from the source frames = the same
    # kernel on the I/Q planes the torch pre stage forms (f32 and uint8
    # interleaved frames, f32 planar), and the interleaved layout = the
    # stack of tuple3 (kernels 3, 10, 11), bit for bit, at radius 2
    # (kernel 3) and 15 (kernel 3's route: kernels 7 + 10).
    for c in (cfg, cfg_b45):
        for fr in (fe_f32, fe_u8, fe_planar):
            iq_fr = chroma_planes(fr)
            for lay in ("tuple3", "interleaved"):
                a3 = post_fused.rowifft_post_fused(
                    rre, rim, *iq_fr, win, c, rows[0], H, W, "tight",
                    full_w=geom.pad_w, out_layout=lay)
                b3 = post_fused.rowifft_post_fused(
                    rre, rim, None, None, win, c, rows[0], H, W, "tight",
                    full_w=geom.pad_w, src=fr, out_layout=lay)
                a10 = post_fused.post_fused(rec1, *iq_fr, win, c, rows[0], H,
                                            W, "tight", lay)
                b10 = post_fused.post_fused(rec1, None, None, win, c, rows[0],
                                            H, W, "tight", lay, src=fr)
                if lay == "tuple3":
                    a3, b3, a10, b10 = (torch.stack(x, -1)
                                        for x in (a3, b3, a10, b10))
                    tup3, tup10 = a3, a10
                same = torch.equal(a3, b3) and torch.equal(a10, b10)
                if lay == "interleaved":
                    same = (same and torch.equal(a3, tup3)
                            and torch.equal(a10, tup10))
                log(f"[2] kernels 3 and 10 at radius {post_fused._radius(c)}, "
                    f"{lay}: source chroma from {fr.dtype} "
                    f"{tuple(fr.shape)} == the I/Q planes' call"
                    + (", == the stack of tuple3" if lay == "interleaved"
                       else "") + f": {same}")
                if not same:
                    raise AssertionError("the source chroma or the "
                                         "interleaved layout differs")
    del a3, b3, a10, b10, tup3, tup10, iq_fr
    got = post_fused.post_fused_rgb(*rgb_post_args, out_layout="interleaved")
    same = torch.equal(got, torch.stack(post_fused.post_fused_rgb(
        *rgb_post_args), -1))
    log(f"[2] post_fused_rgb, interleaved == the stack of tuple3: {same}")
    if not same:
        raise AssertionError("kernel 11's interleaved layout differs")
    # Kernel 1 and kernel 7 past the row engine's 8192 lanes (the bracket
    # around it on 8192-lane blocks) = kernel 8's row pass (the same
    # split) on the same rows, bit for bit: 512 rows of 16K's 16384 lanes.
    g1 = y16[:, :256].contiguous()
    got = fused.windowed_row_fft(g1, g16.pad_h, r0_16, True)
    wy1, wx1 = (torch.from_numpy(a).to(dev)
                for a in fused._hann_pair(g16.pad_h, g16.pad_w))
    yw = (g1 * wy1[r0_16:r0_16 + 256, None]) * wx1
    zr, zi = radix2._fft_axis(yw, torch.zeros_like(yw), 2, False)
    lanes = torch.as_tensor(fused.kept_lane_indices(g16.pad_w), device=dev)
    same = torch.equal(got[0], zr[..., lanes]) and torch.equal(
        got[1], zi[..., lanes])
    log(f"[2] windowed_row_fft == _fft_axis's row pass on the windowed rows, "
        f"kept tiles, {tuple(g1.shape)} (16K, 16384 lanes): {same}")
    if not same:
        raise AssertionError("kernel 1 differs from kernel 8's row pass at "
                             "16384 lanes")
    a16, b16 = (x[:, :256].contiguous() for x in (rre16, rim16))
    got = fused.row_ifft_magnitude(a16, b16, pad_h=g16.pad_h,
                                   full_w=g16.pad_w)
    zr, zi = radix2._fft_axis(*fused.rebuild_lanes(a16, b16, g16.pad_w), 2,
                              True, 1.0)
    want = torch.sqrt(zr * zr + zi * zi) * (1.0 / (g16.pad_h * g16.pad_w))
    same = torch.equal(got, want)
    log(f"[2] row_ifft_magnitude == _fft_axis's row pass + torch |z| on "
        f"{tuple(a16.shape)} -> {tuple(got.shape)} (16K, 16384 lanes): {same}")
    if not same:
        raise AssertionError("kernel 7 differs from kernel 8's row pass + "
                             "torch at 16384 lanes")
    del g1, got, yw, zr, zi, want, a16, b16
    # Kernel 1 on the row engine (csrc/row_pass.cuh) = the DIF of kernel
    # 8's row pass (the same engine, its own load and store) on a zero
    # imaginary plane (pbmm_radix2's butterflies, the same twiddle words)
    # on the same windowed rows, y *
    # wy[row] * wx in kernel 1's op order, kept tiles, bit for bit: at
    # 1080p, 960x540 and 2160p's 4096 lanes.
    rng1 = np.random.default_rng(11)
    for what, g, yy in (
            ("1080p", geom, y),
            ("960x540", g540, dev_t(rng1.random((T, g540.pad_h,
                                                  g540.pad_w)))),
            ("2160p, 4096 lanes", g4t, dev_t(rng1.random((2, g4t.pad_h,
                                                          g4t.pad_w))))):
        got = fused.windowed_row_fft(yy, g.pad_h, 0, True)
        wy1, wx1 = (torch.from_numpy(a).to(dev)
                    for a in fused._hann_pair(g.pad_h, g.pad_w))
        yw = (yy * wy1[:, None]) * wx1
        zr, zi = radix2._fft_axis(yw, torch.zeros_like(yw), 2, False)
        lanes = torch.as_tensor(fused.kept_lane_indices(g.pad_w), device=dev)
        same = torch.equal(got[0], zr[..., lanes]) and torch.equal(
            got[1], zi[..., lanes])
        log(f"[2] windowed_row_fft == _fft_axis's row pass on the windowed "
            f"rows, kept tiles, {tuple(yy.shape)} ({what}): {same}")
        if not same:
            raise AssertionError(f"kernel 1 differs from kernel 8's row "
                                 f"pass at {what}")
        del got, yw, zr, zi
    # Kernel 7 on the row engine (csrc/row_pass.cuh) = kernel 8's row pass
    # (the same engine, its own load and store) on the rows the plan
    # rebuilds,
    # then torch's sqrt(re re + im im) * scale (or re * scale), bit for
    # bit: the same butterflies in the same order, |z| rounded as torch
    # rounds it.  At 1080p, 960x540, 2160p's 4096 lanes, and Re z.
    rng7 = np.random.default_rng(7)
    s4k = 0.3 * g4k.pad_h * g4k.pad_w / np.sqrt(g4k.pad_w)
    r4k = [dev_t(s4k * rng7.standard_normal(
        (1, rows_4k[1] - rows_4k[0], wk4))) for _ in range(2)]
    for what, (a, b), ph, fw, mag in (
            ("1080p", (rre, rim), geom.pad_h, geom.pad_w, True),
            ("960x540", (rre540, rim540), g540.pad_h, g540.pad_w, True),
            ("2160p, 4096 lanes", r4k, g4k.pad_h, g4k.pad_w, True),
            ("1080p rgb, Re z", (rre3, rim3), geom.pad_h, geom.pad_w,
             False)):
        got = fused.row_ifft_magnitude(a, b, mag, pad_h=ph, full_w=fw)
        zr, zi = radix2._fft_axis(*fused.rebuild_lanes(a, b, fw), 2, True,
                                  1.0)
        want = ((torch.sqrt(zr * zr + zi * zi) if mag else zr)
                * (1.0 / (ph * fw)))
        same = torch.equal(got, want)
        log(f"[2] row_ifft_magnitude == _fft_axis's row pass + torch "
            f"{'|z|' if mag else 'Re z'} on {tuple(a.shape)} -> "
            f"{tuple(got.shape)} ({what}): {same}")
        if not same:
            raise AssertionError(f"kernel 7 differs from kernel 8's row pass "
                                 f"+ torch at {what}")
        del got, zr, zi, want
    del r4k
    # Kernel 6 runs kernel 2's phase pass and inverse (csrc/phase_inv.cuh):
    # on the spectra kernel 5 gives, its rows equal kernel 2's bit for bit,
    # all frames in one launch and one frame a launch (a grid of strips x
    # frames), at 1080p square_pow2 (H = 2048), 2160p (H = 4096), 16
    # frames each, and 4320p (H = 8192, 2 frames); kernel 5's spectrum of
    # the last frame is the state kernel 2 carries out; and kernel 12 =
    # kernel 6 at H = 4096 and 8192.
    rng6 = np.random.default_rng(6)
    k6_cases = (
        ("1080p square_pow2", (sq_re, sq_im), sq_prev, cfg_sq, g_sq, r0_sq,
         k6_kw),
        ("2160p square_pow2", [dev_t(rng6.standard_normal(
            (T, r1_4k - r0_4k, wk4))) for _ in range(2)], k4_prev, cfg_j,
         g4k, r0_4k, k4_kw),
        ("4320p square_pow2", [dev_t(rng6.standard_normal(
            (T8K, r1_8k - r0_8k, wk8))) for _ in range(2)], k8k_prev, cfg_j,
         g8k, r0_8k, k8_kw),
        ("16K square_pow2", (k16_re, k16_im), k16_prev, cfg_j, g16, r0_16,
         k16_kw))
    for what, (cre, cim), prv0, c, g, c_r0, kw in k6_cases:
        nf = cre.shape[0]
        k5 = fused.col_fft_zero_padded(cre, cim, g.pad_h, c_r0)
        k2 = fused.colspec_chunk(cre, cim, *prv0, c, g.pad_h, c_r0, **kw)
        prv = [torch.cat([p, x[:-1]]) for p, x in zip(prv0, k5)]
        k6 = fused.phase_col_ifft(*k5, *prv, c, **kw)
        all_frames = all(torch.equal(a, b) for a, b in zip(k6, k2))
        ones = [fused.phase_col_ifft(*(x[i:i + 1] for x in (*k5, *prv)), c,
                                     **kw) for i in range(nf)]
        one_frame = all(torch.equal(o[k][0], k2[k][i])
                        for i, o in enumerate(ones) for k in range(2))
        state = all(torch.equal(k2[2 + k][0], k5[k][-1]) for k in range(2))
        log(f"[2] phase_col_ifft on kernel 5's spectra == colspec_chunk's "
            f"output rows, {tuple(k6[0].shape)} at {what} (H = {g.pad_h}, "
            f"strips of {fused.phase_col_strip(g.pad_h, k5[0].shape[-1])}"
            f"): {nf} frames a launch {all_frames}, one frame a launch "
            f"{one_frame}; kernel 5's last spectrum == kernel 2's state "
            f"{state}")
        if not (all_frames and one_frame and state):
            raise AssertionError(f"kernel 6 or kernel 5 differs from kernel "
                                 f"2 at {what}")
        if g.pad_h >= g4k.pad_h:
            k12 = kdecomp.kdecomp_variant(*k5, *prv, c,
                                          kdecomp.VARIANTS[-1][1], kw[
                                              "out_rows"], full_w=g.pad_w)
            same = all(torch.equal(a, b) for a, b in zip(k12, k6))
            log(f"[2] at H = {g.pad_h}: kdecomp_variant (phase + gm + rolls)"
                f" == phase_col_ifft: {same}")
            if not same:
                raise AssertionError(f"at H = {g.pad_h} kernel 12 differs "
                                     "from kernel 6")
        del k5, k2, k6, prv, ones
    del k6_cases
    # Kernel 3 = kernel 7 + kernel 10, bit for bit: the same |z| rows (the
    # row engine, kernel 7's load and rounding) and the blur, chroma and
    # epilogue in kernel 10's order, at radii 2 and 5, f32 and uint8
    # chroma, tuple3 and planar_u8, on the 1080p region rows.
    for c in (cfg, cfg_b15):
        rec = fused.row_ifft_magnitude(rre, rim, pad_h=geom.pad_h,
                                       full_w=geom.pad_w)
        for chroma, u8 in (((i_pl, q_pl), None), ((None, None), u8_frames)):
            for lay in ("tuple3", "planar_u8"):
                k3 = post_fused.rowifft_post_fused(
                    rre, rim, *chroma, win, c, rows[0], H, W, "tight",
                    full_w=geom.pad_w, src=u8, out_layout=lay)
                k10 = post_fused.post_fused(rec, *chroma, win, c, rows[0], H,
                                            W, "tight", lay, src=u8)
                k3, k10 = ((x,) if torch.is_tensor(x) else x
                           for x in (k3, k10))
                same = all(torch.equal(a, b) for a, b in zip(k3, k10))
                log(f"[2] rowifft_post_fused == row_ifft_magnitude + "
                    f"post_fused at radius {post_fused._radius(c)}, "
                    f"{'u8' if u8 is not None else 'f32'} chroma, {lay}: "
                    f"{same}")
                if not same:
                    raise AssertionError("kernel 3 differs from kernel 7 + "
                                         "kernel 10")
        del rec, k3, k10
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

    # The mxu backend's transforms (spectral/mxu_fft.py: torch.matmul
    # products in IEEE f32, the JAX package's XLA einsums, no kernel of
    # the port's) at path (o)'s shape (1, 2048, 2048) (1080p square_pow2,
    # y_only) and at 720p rect_pow2 rgb's (3, 1024, 2048), against
    # torch.fft on the same tensors and numpy's float64 FFTs of the same
    # seeded inputs: max error / max magnitude < 2e-5 (the JAX tests'
    # bar).  With TF32 allowed a call raises; the setting is restored.
    mxu_tol = 2e-5
    mxu_in = {}
    for shape in ((1, 2048, 2048), (3, 1024, 2048)):
        y_np = np.random.default_rng(21).standard_normal(shape).astype(
            np.float32)
        y_d = dev_t(y_np)
        h_, w_ = shape[1:]
        r64 = np.fft.rfft2(y_np.astype(np.float64))
        half = torch.from_numpy(r64.astype(np.complex64)).to(dev)
        for name, got, lib, ref in (
                ("rfft2_mxu", lambda: mxu_fft.rfft2_mxu(y_d),
                 lambda: torch.fft.rfft2(y_d), lambda: r64),
                ("fft2_mxu", lambda: mxu_fft.fft2_mxu(y_d),
                 lambda: torch.fft.fft2(y_d),
                 lambda: np.fft.fft2(y_np.astype(np.float64))),
                ("irfft2_mxu", lambda: mxu_fft.irfft2_mxu(half, w_),
                 lambda: torch.fft.irfft2(half, s=(h_, w_)),
                 lambda: y_np.astype(np.float64))):
            g = got().cpu().numpy()
            want_lib = lib().cpu().numpy()
            want64 = ref()
            e_lib = float(np.abs(g - want_lib).max() / np.abs(want_lib).max())
            e_64 = float(np.abs(g - want64).max() / np.abs(want64).max())
            log(f"[2] {name} on {shape}: max error / max magnitude "
                f"{e_lib:.3e} against torch.fft, {e_64:.3e} against numpy "
                f"float64 (bound {mxu_tol:g})")
            if not (g.shape == want64.shape and e_lib < mxu_tol
                    and e_64 < mxu_tol):
                raise AssertionError(f"{name} on {shape}: {e_lib}, {e_64}")
            del g, want_lib, want64
        mxu_in[shape] = (y_d, half)
    y_mx, half_mx = mxu_in[(1, 2048, 2048)]
    y_mx_np = y_mx.cpu().numpy().astype(np.float64)
    rows64 = np.fft.fft(y_mx_np, axis=-1)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        try:
            mxu_fft.rfft2_mxu(y_mx)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("rfft2_mxu ran with TF32 allowed")
        # What the refusal keeps out: the row stage's products in TF32.
        tf_rows = mxu_fft._four_step_last(y_mx, None, 2048, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ieee_rows = mxu_fft._four_step_last(y_mx, None, 2048, False)
    errs = [float(np.abs((r.cpu().numpy() + 1j * i.cpu().numpy()) - rows64)
                  .max() / np.abs(rows64).max())
            for r, i in (tf_rows, ieee_rows)]
    log(f"[2] mxu with TF32 allowed: refused ({refusal[:70]}...); the row "
        f"stage's products in TF32 err {errs[0]:.3e} of the max magnitude "
        f"against float64, in IEEE f32 {errs[1]:.3e}")
    del tf_rows, ieee_rows, rows64, y_mx_np

    # -- 3. end to end, path by path -----------------------------------------
    wrappers = {"windowed_row_fft": fused.windowed_row_fft,
                "windowed_row_fft_frames": fused.windowed_row_fft_frames,
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
        n = frames_d.shape[0]
        oa, sa = pbmm_tpu_torch.magnify_video(frames_d[:n // 2], c)
        ob, sb = pbmm_tpu_torch.magnify_video(frames_d[n // 2:], c, sa)
        if not (torch.equal(torch.cat([oa, ob]), out1)
                and all(torch.equal(a, b) for a, b in zip(
                    sb[:2] + tuple(sb.temporal),
                    s1[:2] + tuple(s1.temporal)))):
            raise AssertionError(f"{what}: chunks of {n // 2} + {n - n // 2}"
                                 f" differ from one chunk of {n}")
        log(f"[3] {what}: chunks {n // 2} + {n - n // 2} equal one chunk of "
            f"{n} bit for bit (frames and state)")

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

    def oracle_job(frames01, c, n=4):
        """The oracle on frames 0 to n - 1 of `frames01` (interleaved, in
        [0, 1]) under config c, started on a host thread."""
        fn = (oracle.oracle_magnify_video_iir
              if c.temporal.mode == "iir_bandpass"
              else oracle.oracle_magnify_video)

        def run():
            t0 = time.perf_counter()
            return fn(frames01[:n], c), time.perf_counter() - t0
        return pool.submit(run)

    def vs_oracle(outs, job):
        """PSNR of the first frames of each (name, interleaved output)
        against the oracle's result of `job` (as many frames as it has)."""
        want, secs = job.result()
        dbs = []
        for name, got in outs:
            n = want.shape[0]
            db = psnr_db(got[:n].double().cpu().numpy(), want)
            log(f"[3] {name}: PSNR vs the fp64 oracle, frames 0-{n - 1}: "
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
    base4k = np.random.default_rng(3).random((H4K, W4K, 3), np.float32)
    frames4k = np.stack([np.roll(base4k, shift=i, axis=1)
                         * (0.95 + 0.01 * i) for i in range(T4K)])
    frames4k_d = torch.from_numpy(frames4k).to(dev)
    base8k = np.random.default_rng(4).random((H8K, W8K, 3), np.float32)
    frames8k = np.stack([np.roll(base8k, shift=i, axis=1)
                         * (0.95 + 0.01 * i) for i in range(T8K)])
    frames8k_d = torch.from_numpy(frames8k).to(dev)
    del base8k
    cfg_k = cfg_b45
    # The 4320p oracles (fp64 FFTs of 8192 x 8192) first: the longest.
    jobs = {"l": oracle_job(frames8k, cfg_j, n=2),
            "lt": oracle_job(frames8k, cfg, n=2),
            "f32": oracle_job(frames, cfg),
            "j": oracle_job(frames4k, cfg_j, n=2),
            "k": oracle_job(frames, cfg_k),
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
        "f32 1080p", ("windowed_row_fft_frames", "colspec_chunk",
                      "rowifft_post_fused"),
        tuple(k for k in wrappers if k not in (
            "windowed_row_fft_frames", "colspec_chunk",
            "rowifft_post_fused")),
        lambda: two_chunks(frames_d, cfg))
    launches = path_launches["f32 1080p"]
    # One steady-state chunk alone: the front end, kernel 2 (one call, two
    # launches) and kernel 3 launch once each, and no torch kernel runs (no
    # YIQ plane, padded slab or output stack; torch.profiler's device
    # kernels hold nothing of at::native).
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):  # a session now and then records no device event
        for f in wrappers.values():
            f.launches = 0
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof1:
            pbmm_tpu_torch.magnify_video(frames_d, cfg, s2)
            torch.cuda.synchronize()
        one = {k: f.launches for k, f in wrappers.items() if f.launches}
        dev_kernels = sorted({
            e.key for e in prof1.key_averages() if e.device_type
            == torch.autograd.DeviceType.CUDA and not e.key.startswith(
                "pbmm.")})
        if dev_kernels:
            break
    log(f"[3] f32 1080p, one steady chunk: launches {one}; device kernels "
        f"{dev_kernels}")
    if one != {"windowed_row_fft_frames": 1, "colspec_chunk": 1,
               "rowifft_post_fused": 1}:
        raise AssertionError(f"f32 1080p chunk: launches {one}")
    if not dev_kernels or any("at::native" in k for k in dev_kernels):
        raise AssertionError(f"f32 1080p chunk: torch kernels {dev_kernels}")
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
                                 ("windowed_row_fft",
                                  "windowed_row_fft_frames"),
                                 lambda: two_chunks(u8_d, cfg_pl))
    q1, _, q2, _ = run_path("u8 1080p -> planar_u8", u8_kernels,
                            ("windowed_row_fft", "windowed_row_fft_frames"),
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
    # The torch posttail reads I/Q planes here (post_pallas_ok fails):
    # the front end (kernel 4 for planar uint8) and torch's I/Q FMAs.
    tail_kernels = ("colspec_chunk", "row_ifft_magnitude")
    o540, *_ = run_path("540p f32", ("windowed_row_fft_frames",)
                        + tail_kernels, ("rowifft_post_fused",
                                         "windowed_row_fft"),
                        lambda: two_chunks(f540_d, cfg))
    ou540, *_ = run_path("540p u8", ("windowed_row_fft_u8planar",)
                         + tail_kernels, ("rowifft_post_fused",
                                          "windowed_row_fft"),
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
    # Square paddings start the stream with kernels 5 and 1 on frame 0
    # (`video_init`); every chunk then takes the front end.
    sq_kernels = ("col_fft_zero_padded", "windowed_row_fft",
                  "windowed_row_fft_frames", "colspec_chunk",
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
        path_b, ("windowed_row_fft_frames", "colspec_chunk",
                 "row_ifft_magnitude",
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
        path_d, ("windowed_row_fft_frames", "colspec_chunk",
                 "rowifft_post_fused"),
        ("col_fft_zero_padded", "row_ifft_magnitude", "post_fused_rgb",
         "windowed_row_fft_u8planar", "windowed_row_fft"),
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

    # (o) fft_backend="mxu" (the CLI's --fft-backend mxu): the scan engine
    # with the four-step transforms as torch.matmul products, the torch
    # phase pass in the rfft layout and the torch tail; no kernel of the
    # port's launches.  The 1080p bar at square_pow2, two chunks.
    path_o = "(o) mxu 1080p"
    cfg_o = pbmm_tpu_torch.MagnifyConfig(fft_backend="mxu")
    o1, so1, o2, _ = run_path(path_o, (), none_of,
                              lambda: two_chunks(bar_il_d, cfg_o))
    check_frames(path_o, (o1, o2), (T, H, W, 3), torch.float32)
    check_split(bar_il_d, cfg_o, o1, so1, path_o)
    psnr_o, = vs_oracle([(path_o, o1)], jobs["bar"])
    psnr_o_xla = psnr_db(o1.double().cpu().numpy(),
                         e1.double().cpu().numpy())
    log(f"[3] {path_o}: PSNR against (e), the same clip with "
        f"fft_backend='xla': {psnr_o_xla:.2f} dB (bound > 70)")
    if not psnr_o_xla > 70:
        raise AssertionError(f"{path_o}: {psnr_o_xla} dB against xla")
    pair_o = run_path(path_o + " magnify_frame_pair", (), none_of,
                      lambda: magnify_frame_pair(bar_il_d[0], bar_il_d[1],
                                                 cfg_o))
    check_frames(path_o + " pair", (pair_o,), (H, W, 3), torch.float32)
    psnr_o_pair = psnr_db(pair_o.double().cpu().numpy(),
                          o1[1].double().cpu().numpy())
    log(f"[3] {path_o}: magnify_frame_pair(0, 1) against the chunk's frame "
        f"1: bit for bit {torch.equal(pair_o, o1[1])}, {psnr_o_pair:.2f} dB "
        "(bound > 100)")
    if not psnr_o_pair > 100:
        raise AssertionError(f"{path_o}: the pair {psnr_o_pair} dB")
    del o2, pair_o

    # (n) the multi-device engines on a world of one over NCCL (one card:
    # NCCL refuses two ranks on one GPU): the batched clip (kernels 1, 8,
    # 6, 7), the ("data", "frame") sharded batch on a (1, 1) mesh (bit for
    # bit the batched clip) and the rows-sharded spatial engine on a
    # ("rows",) mesh of one (the kernel route: 8, 6 with fx_values, 7),
    # at 1080p square_pow2 on the bench clip, and at 720p rect_pow2 in
    # standard mode at 2.5 and with the IIR taps on the bar.  On a mesh of
    # one the spatial engine's rank block is the whole clip.
    init_world(f"tcp://127.0.0.1:{free_port()}", 1, 0, rank_device())
    mesh11 = make_mesh((1, 1))
    rows1 = make_mesh((1,), ("rows",))
    clip_k = ("windowed_row_fft", "_fft_axis", "phase_col_ifft",
              "row_ifft_magnitude")
    not_clip = ("colspec_chunk", "rowifft_post_fused", "col_fft_zero_padded",
                "amplify_procedural", "post_fused", "post_fused_rgb",
                "windowed_row_fft_u8planar")
    spatial_k = ("_fft_axis", "phase_col_ifft", "row_ifft_magnitude")
    path_n = "(n) 1080p magnify_clip_batched, tuned"
    n1 = run_path(path_n, clip_k, not_clip,
                  lambda: magnify_clip_batched(frames_d, cfg_sq))
    check_frames(path_n, (n1,), (T, H, W, 3), torch.float32)
    psnr_n, = vs_oracle([(path_n, n1)], jobs["a"])
    path_ns = "(n) 1080p magnify_batch_sharded, (1, 1) mesh"
    ns1 = run_path(path_ns, clip_k, not_clip,
                   lambda: magnify_batch_sharded(frames_d[None], cfg_sq,
                                                 mesh11))
    same = torch.equal(ns1[0], n1)
    log(f"[3] {path_ns}: equal to magnify_clip_batched bit for bit: {same}")
    if not same:
        raise AssertionError(f"{path_ns} differs from the batched clip")
    del ns1
    spatial_runs = {
        "(n) 1080p magnify_video_spatial, rows 1": (frames_d, cfg_sq, a1,
                                                    jobs["a"]),
        "(n) 720p magnify_video_spatial, standard 2.5, rows 1": (
            bar720_d, cfg_std, c1, jobs["c"]),
        "(n) 720p magnify_video_spatial, IIR, rows 1": (
            bar720_d, cfg_sq.replace(pad_mode="rect_pow2",
                                     temporal=cfg_fi.temporal), None,
            jobs["f_iir"]),
    }
    psnr_spatial = {}
    for what, (fd, c, single, job) in spatial_runs.items():
        got = run_path(what, spatial_k, ("windowed_row_fft", "colspec_chunk",
                                         "col_fft_zero_padded",
                                         "rowifft_post_fused"),
                       lambda: magnify_video_spatial(fd, c, rows1))
        check_frames(what, (got,), tuple(fd.shape), torch.float32)
        if single is None:
            single = pbmm_tpu_torch.magnify_video(fd, c)[0]
        db = psnr_db(got.double().cpu().numpy(),
                     single.double().cpu().numpy())
        want, _ = job.result()
        db_o = psnr_db(got[:2].double().cpu().numpy(), want[:2])
        log(f"[3] {what}: PSNR vs the single-card magnify_video on the same "
            f"config {db:.2f} dB (bound > 70); vs the fp64 oracle, frames "
            f"0-1: {db_o:.2f} dB")
        if not db > 70:
            raise AssertionError(f"{what}: PSNR {db} dB <= 70")
        psnr_spatial[what] = {"psnr_vs_magnify_video_db": db,
                              "psnr_vs_oracle_db": db_o}
        del got

    # (j) 2160p: 3840x2160 tuned_for_tpu() (square_pow2, H = 4096): the
    # stream starts through kernel 5, kernels 1, 2 (strips of 4), 3 (8
    # rows a block at radius 2, 4096 lanes).  Then 2160p tight (H = 2176,
    # the four-step at m = 17) and the scan engine at H = 4096 (kernel 6).
    path_j = "(j) 2160p square_pow2"
    j1, sj1, j2, _ = run_path(
        path_j, sq_kernels, ("windowed_row_fft_u8planar",
                             "row_ifft_magnitude", "post_fused_rgb",
                             "post_fused"),
        lambda: two_chunks(frames4k_d, cfg_j))
    check_frames(path_j, (j1, j2), (T4K, H4K, W4K, 3), torch.float32)
    check_split(frames4k_d, cfg_j, j1, sj1, path_j)
    if tuple(sj1.prev_spec_re.shape) != (1, g4k.pad_h, wk4):
        raise AssertionError(f"{path_j}: state "
                             f"{tuple(sj1.prev_spec_re.shape)}")
    psnr_j, = vs_oracle([(path_j, j1)], jobs["j"])
    path_jt = "(j) 2160p tight"
    jt1, sjt1, jt2, _ = run_path(
        path_jt, ("windowed_row_fft_frames", "colspec_chunk",
                  "rowifft_post_fused"),
        ("col_fft_zero_padded", "row_ifft_magnitude", "post_fused",
         "windowed_row_fft"),
        lambda: two_chunks(frames4k_d, cfg))
    check_frames(path_jt, (jt1, jt2), (T4K, H4K, W4K, 3), torch.float32)
    if tuple(sjt1.prev_spec_re.shape) != (1, g4t.pad_h, wk4):
        raise AssertionError(f"{path_jt}: state "
                             f"{tuple(sjt1.prev_spec_re.shape)}")
    path_js = "(j) 2160p tuned scan square_pow2"
    js1 = run_path(path_js, scan_k, not_scan,
                   lambda: pbmm_tpu_torch.magnify_video(
                       frames4k_d[:3], cfg_j.replace(engine="scan"))[0])
    check_frames(path_js, (js1,), (3, H4K, W4K, 3), torch.float32)
    psnr_js, = vs_oracle([(path_js, js1)], jobs["j"])

    # (l) 4320p: 7680x4320 tuned_for_tpu() (square_pow2, H = 8192): the
    # stream starts through kernel 5 (three passes), kernels 1 (8192
    # lanes), 2 (strips of 2) and the tail `kernel3_serves` names (kernel
    # 3, or kernels 7 + 10).  Then 4320p tight (H = 4352, the four-step at
    # m = 34) and the scan engine at H = 8192 on 2 frames (kernel 6).
    def tail_of(g):
        return (("rowifft_post_fused",) if post_fused.kernel3_serves(
            post_fused._radius(cfg), g.pad_w, W8K)
            else ("row_ifft_magnitude", "post_fused"))

    path_l = "(l) 4320p square_pow2"
    l1, sl1, l2, _ = run_path(
        path_l, ("col_fft_zero_padded", "windowed_row_fft",
                 "windowed_row_fft_frames", "colspec_chunk")
        + tail_of(g8k), ("windowed_row_fft_u8planar", "post_fused_rgb"),
        lambda: two_chunks(frames8k_d, cfg_j))
    check_frames(path_l, (l1, l2), (T8K, H8K, W8K, 3), torch.float32)
    check_split(frames8k_d, cfg_j, l1, sl1, path_l)
    if tuple(sl1.prev_spec_re.shape) != (1, g8k.pad_h, wk8):
        raise AssertionError(f"{path_l}: state "
                             f"{tuple(sl1.prev_spec_re.shape)}")
    path_lt = "(l) 4320p tight"
    lt1, slt1, lt2, _ = run_path(
        path_lt, ("windowed_row_fft_frames", "colspec_chunk")
        + tail_of(g8t), ("col_fft_zero_padded", "windowed_row_fft_u8planar",
                         "post_fused_rgb", "windowed_row_fft"),
        lambda: two_chunks(frames8k_d, cfg))
    check_frames(path_lt, (lt1, lt2), (T8K, H8K, W8K, 3), torch.float32)
    check_split(frames8k_d, cfg, lt1, slt1, path_lt)
    if tuple(slt1.prev_spec_re.shape) != (1, g8t.pad_h, wk8):
        raise AssertionError(f"{path_lt}: state "
                             f"{tuple(slt1.prev_spec_re.shape)}")
    path_ls = "(l) 4320p tuned scan square_pow2"
    ls1 = run_path(path_ls, scan_k, not_scan,
                   lambda: pbmm_tpu_torch.magnify_video(
                       frames8k_d, cfg_j.replace(engine="scan"))[0])
    check_frames(path_ls, (ls1,), (T8K, H8K, W8K, 3), torch.float32)
    psnr_l, psnr_ls = vs_oracle([(path_l, l1), (path_ls, ls1)], jobs["l"])
    psnr_lt, = vs_oracle([(path_lt, lt1)], jobs["lt"])
    del l2, lt2, ls1

    # (m) 16K: 15360x8640 in chunks of 2, shifted noise, the state threaded
    # across two chunks.  square_pow2 (16384 x 16384): kernel 5 (three
    # passes), kernel 1 and kernel 7 on 16384 lanes (the bracket around
    # the row engine), kernel 2 bracketed around its launches on 8192-row
    # blocks, the tail on kernels 7 + 10 (no kernel-3 block holds 16384
    # lanes).  Tight (8704 rows, m = 68): kernel 2's combine pass.  The
    # scan engine on 2 frames: kernels 1, 5, 6 (bracketed), 7.  (g), the
    # unfused pallas backend with use_pallas: kernel 8 on both axes at
    # 16384 and kernel 9.  Each route: its launch counters, two chunks of
    # 1 = one of 2 bit for bit, > 100 dB against the oracle on frames 0-1
    # (read after phase 4).
    tail16 = ("row_ifft_magnitude", "post_fused")
    assert not post_fused.kernel3_serves(post_fused._radius(cfg), g16.pad_w,
                                         W16)
    path_m = "(m) 16K square_pow2"
    m1, sm1, m2, _ = run_path(
        path_m, ("col_fft_zero_padded", "windowed_row_fft",
                 "windowed_row_fft_frames", "colspec_chunk") + tail16, ("windowed_row_fft_u8planar", "post_fused_rgb",
                   "rowifft_post_fused"),
        lambda: two_chunks(frames16_d, cfg_j))
    check_frames(path_m, (m1, m2), (T16, H16, W16, 3), torch.float32)
    check_split(frames16_d, cfg_j, m1, sm1, path_m)
    if tuple(sm1.prev_spec_re.shape) != (1, g16.pad_h, wk16):
        raise AssertionError(f"{path_m}: state "
                             f"{tuple(sm1.prev_spec_re.shape)}")
    outs16 = {path_m: m1.cpu()}
    del m1, m2, sm1
    torch.cuda.empty_cache()
    path_mt = "(m) 16K tight"
    mt1, smt1, mt2, _ = run_path(
        path_mt, ("windowed_row_fft_frames", "colspec_chunk") + tail16,
        ("col_fft_zero_padded", "windowed_row_fft_u8planar",
         "post_fused_rgb", "rowifft_post_fused", "windowed_row_fft"),
        lambda: two_chunks(frames16_d, cfg))
    check_frames(path_mt, (mt1, mt2), (T16, H16, W16, 3), torch.float32)
    check_split(frames16_d, cfg, mt1, smt1, path_mt)
    if tuple(smt1.prev_spec_re.shape) != (1, g16t.pad_h, wk16):
        raise AssertionError(f"{path_mt}: state "
                             f"{tuple(smt1.prev_spec_re.shape)}")
    outs16[path_mt] = mt1.cpu()
    del mt1, mt2, smt1
    torch.cuda.empty_cache()
    path_ms = "(m) 16K tuned scan square_pow2"
    cfg_ms = cfg_j.replace(engine="scan")
    ms1, sms1 = run_path(path_ms, scan_k, not_scan,
                         lambda: pbmm_tpu_torch.magnify_video(frames16_d,
                                                              cfg_ms))
    check_frames(path_ms, (ms1,), (T16, H16, W16, 3), torch.float32)
    check_split(frames16_d, cfg_ms, ms1, sms1, path_ms)
    outs16[path_ms] = ms1.cpu()
    del ms1, sms1
    torch.cuda.empty_cache()
    path_mg = "(m) 16K pallas unfused, use_pallas"
    mg1, smg1 = run_path(
        path_mg, ("windowed_row_fft", "col_fft_zero_padded",
                  "amplify_procedural", "_fft_axis"),
        ("phase_col_ifft", "colspec_chunk", "row_ifft_magnitude",
         "rowifft_post_fused", "post_fused", "post_fused_rgb"),
        lambda: pbmm_tpu_torch.magnify_video(frames16_d, cfg_g))
    check_frames(path_mg, (mg1,), (T16, H16, W16, 3), torch.float32)
    check_split(frames16_d, cfg_g, mg1, smg1, path_mg)
    # Frames 0-1 of each route, on the host for the oracle's comparison
    # after phase 4.
    outs16[path_mg] = mg1.cpu()
    del mg1, smg1
    torch.cuda.empty_cache()

    # (k) 1080p tight at blur_size 4.5 (radius 15): no kernel-3 block
    # fits, so kernel 7 and kernel 10 take the tail; f32 and u8 in.
    path_k = "(k) 1080p blur 4.5 (kernels 7 + 10)"
    k_kernels = ("colspec_chunk", "row_ifft_magnitude", "post_fused")
    k1, sk1, k2_, _ = run_path(
        path_k, ("windowed_row_fft_frames",) + k_kernels,
        ("rowifft_post_fused", "post_fused_rgb", "col_fft_zero_padded",
         "windowed_row_fft"),
        lambda: two_chunks(frames_d, cfg_k))
    check_frames(path_k, (k1, k2_), (T, H, W, 3), torch.float32)
    check_split(frames_d, cfg_k, k1, sk1, path_k)
    ku1, *_ = run_path(
        path_k + " u8 -> planar_u8", ("windowed_row_fft_u8planar",)
        + k_kernels, ("rowifft_post_fused", "windowed_row_fft",
                      "windowed_row_fft_frames"),
        lambda: two_chunks(u8_d, cfg_k.replace(output_layout="planar_u8")))
    check_frames(path_k + " u8", (ku1,), (T, 3, H, W), torch.uint8)
    psnr_k, = vs_oracle([(path_k, k1)], jobs["k"])
    path_k15 = "(k) 1080p blur 1.5 (kernel 3)"
    k15, *_ = run_path(
        path_k15, ("windowed_row_fft_frames", "colspec_chunk",
                   "rowifft_post_fused"),
        ("row_ifft_magnitude", "post_fused", "windowed_row_fft"),
        lambda: two_chunks(frames_d, cfg_b15))
    check_frames(path_k15, (k15,), (T, H, W, 3), torch.float32)
    pool.shutdown(wait=True)

    # (i) the measurement path, through the tools' functions and the CLI.
    path_i = "(i) measurement path"
    meas_dir = tempfile.mkdtemp(prefix="pbmm_meas_")

    def measurement():
        t0 = time.perf_counter()
        res = {"copy_gbps": roofline.row_copy_ceiling(dev)}
        res["roofline"] = roofline.roofline_table(
            reps=10, copy_gbps=res["copy_gbps"])
        res["ceilings"] = {}
        for label, planes in (("1 frame", cp1), ("16 frames", cp16)):
            pair = torch.stack(planes)
            dst = torch.empty_like(pair)
            res["ceilings"][f"Tensor.copy_, {label}"] = (
                planes[0].numel(), kexp.timed(lambda: dst.copy_(pair),
                                              device=dev))
            del pair, dst
            for pat, blk in COPY_PATTERNS:
                res["ceilings"][f"{pat} {blk}, {label}"] = (
                    planes[0].numel(), kexp.timed(
                        kexp.copy_probe, (*planes, pat, blk)))
        res["kexp"] = {n: kexp.timed(fn, a) for n, (fn, a) in
                       kexp.experiments(dev, {
                           "rowfft_kept", "colfft_kept", "phase_kept",
                           "rowifft_kept"}).items()}
        # Kernel 12's variants and kernel 6 at one frame and at 16 (kernel
        # 2's launch-2 frame count on a chunk of 16).
        res["kdecomp"] = kdecomp.run_kdecomp(dev, reps=10)
        res["kdecomp16"] = kdecomp.run_kdecomp(dev, reps=10, frames=16)
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
        named = [k for k in ("row_fft_f32_kernel", "pbmm.chunk",
                             "pbmm.colspec", "pbmm.launch.") if k in text]
        log(f"[3] {path_i}: --demo bar --fast --trace: {len(traces)} trace "
            f"file(s), {len(text) / 1e6:.1f} MB, naming {named}")
        if "row_fft_f32_kernel" not in named:
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
    for label in ("1 frame", "16 frames"):
        cp_rows1 = meas["ceilings"][f"rows 1, {label}"][1]
        cp_lib = meas["ceilings"][f"Tensor.copy_, {label}"][1]
        log(f"[3] {card}: copy probe rows 1 against Tensor.copy_, {label}: "
            f"warm {cp_rows1[0] / cp_lib[0]:.3f}x, cold "
            f"{cp_rows1[1] / cp_lib[1]:.3f}x")
    for name, (warm, cold) in meas["kexp"].items():
        log(f"[3] {card}: kexp {name}: warm {warm:.4f} ms, cold {cold:.4f} "
            "ms")
    for key, kd_b in (("kdecomp", 1), ("kdecomp16", 16)):
        for name, warm, cold in meas[key]:
            log(f"[3] {card}: kdecomp B = {kd_b}, {name}: warm {warm:.4f} "
                f"ms, cold {cold:.4f} ms")
        for name, (warm, cold) in kdecomp.split(meas[key]).items():
            log(f"[3] {card}: kdecomp split B = {kd_b}, {name}: warm "
                f"{warm:.4f} ms, cold {cold:.4f} ms")
        kd_t = {name: warm for name, warm, _ in meas[key]}
        kd_full, kd_6 = kd_t[kdecomp.VARIANTS[-1][0]], kd_t[kdecomp.KERNEL6]
        log(f"[3] {card}: kdecomp B = {kd_b}: the full variant "
            f"{kd_full:.4f} ms warm against kernel 6's {kd_6:.4f}: "
            f"{kd_full / kd_6:.3f}x")

    # stream: a 1080p 420jpeg y4m through stream_magnify(ingest="u8")
    tmp = tempfile.mkdtemp(prefix="pbmm_smoke_")
    try:
        clip = os.path.join(tmp, "clip.y4m")
        t0 = time.perf_counter()
        y4m.save_y4m(clip, np.concatenate([frames, frames[::-1]]),
                     colorspace="420jpeg")
        log(f"[3] stream: wrote a 32-frame 1080p 420jpeg y4m in "
            f"{time.perf_counter() - t0:.1f} s")
        got = run_path("stream u8", u8_kernels,
                       ("windowed_row_fft", "windowed_row_fft_frames"),
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

        # (p) the .npy route of --stream and of resumable runs: a 32-frame
        # 1080p uint8 .npy and its f32 twin (u8 * float32(1 / 255)) through
        # stream_magnify with tuned_for_tpu() (square_pow2: kernels 5, 1,
        # 2, 3), read by the native prefetch loader, which must serve here.
        path_p = "(p) npy stream native"
        if not native.native_available():
            raise AssertionError(f"{path_p}: the native .npy loader did not "
                                 "build (no g++?)")
        clip_u8 = np.round(np.concatenate([frames, frames[::-1]])
                           * 255.0).astype(np.uint8)
        npy = {"u8": os.path.join(tmp, "clip_u8.npy"),
               "f32": os.path.join(tmp, "clip_f32.npy")}
        np.save(npy["u8"], clip_u8)
        np.save(npy["f32"], clip_u8 * np.float32(1.0 / 255.0))
        del clip_u8
        p_out = {}
        for fmt, pth in npy.items():
            native.NativeFrameLoader.served = 0
            got = run_path(f"{path_p} {fmt}", sq_kernels,
                           ("windowed_row_fft_u8planar",),
                           lambda: list(stream.stream_magnify(
                               pth, cfg_sq, chunk_frames=T, device=dev)))
            if native.NativeFrameLoader.served != 2:
                raise AssertionError(
                    f"{path_p} {fmt}: the native loader served "
                    f"{native.NativeFrameLoader.served} of 2 chunks")
            want, st = [], None
            for c in stream.frame_chunks(pth, T, device=dev):
                o, st = pbmm_tpu_torch.magnify_video(c, cfg_sq, st)
                want.append(o.cpu().numpy())
            whole = pbmm_tpu_torch.magnify_video(
                torch.from_numpy(np.load(pth)).to(dev), cfg_sq)[0]
            same = (len(got) == len(want) == 2
                    and all(np.array_equal(a, b) for a, b in zip(got, want))
                    and np.array_equal(np.concatenate(got),
                                       whole.cpu().numpy()))
            log(f"[3] {path_p} {fmt}: 2 chunks of 16 through the native "
                f"loader equal the memmap route and magnify_video on the "
                f"whole clip bit for bit: {same}")
            if not same:
                raise AssertionError(f"{path_p} {fmt}: differs")
            p_out[fmt] = np.concatenate(got)
            del got, want, whole
        if not np.array_equal(p_out["u8"], p_out["f32"]):
            raise AssertionError(f"{path_p}: u8 and its f32 twin differ")
        out_a, out_b = (os.path.join(tmp, n) for n in ("ra.npy", "rb.npy"))
        ck = os.path.join(tmp, "ck.npz")
        kw = dict(chunk_frames=T, device=dev)
        n_a = stream.stream_magnify_resumable(npy["u8"], out_a, cfg_sq,
                                              checkpoint=ck, max_chunks=1,
                                              **kw)
        n_b = stream.stream_magnify_resumable(npy["u8"], out_a, cfg_sq,
                                              checkpoint=ck, **kw)
        n_c = stream.stream_magnify_resumable(npy["u8"], out_b, cfg_sq, **kw)
        same = ((n_a, n_b, n_c) == (T, 2 * T, 2 * T)
                and np.array_equal(np.load(out_a), np.load(out_b))
                and np.array_equal(np.load(out_a), p_out["u8"]))
        log(f"[3] {path_p}: u8 equals its f32 twin bit for bit; resumable "
            f"stopped after chunk 1 ({n_a} frames) and resumed ({n_b}) equals "
            f"an uninterrupted run ({n_c}) and the stream: {same}")
        if not same:
            raise AssertionError(f"{path_p}: the resumed run differs")
        for f in (out_a, out_b, ck):
            os.remove(f)
        del p_out

        # -- 4. timing -------------------------------------------------------
        def steady(frames_d, c, what, reps=10):
            state = [pbmm_tpu_torch.magnify_video(frames_d, c)[1]]

            def chunk():
                out, state[0] = pbmm_tpu_torch.magnify_video(frames_d, c,
                                                             state[0])
                return out

            n = frames_d.shape[0]
            ms = time_ms(torch, chunk, reps=reps, warmup=2)
            fps_ = n / (ms / 1e3)
            log(f"[4] {card}: {what}: steady-state chunk of {n} frames "
                f"{ms:.3f} ms median of {reps} -> {fps_:.2f} frames/s, "
                f"{ms / n:.4f} ms/frame")
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
                            (path_d, frames_d, cfg_str),
                            (path_j, frames4k_d, cfg_j),
                            (path_jt, frames4k_d, cfg),
                            (path_l, frames8k_d, cfg_j),
                            (path_lt, frames8k_d, cfg),
                            (path_k, frames_d, cfg_k),
                            (path_k15, frames_d, cfg_b15),
                            (path_m, frames16_d, cfg_j),
                            (path_mt, frames16_d, cfg)):
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
        # Path (n): each engine's call on its clip, on the world of one.
        n_calls = {
            path_n: (frames_d, lambda: magnify_clip_batched(frames_d,
                                                            cfg_sq)),
            path_ns: (frames_d, lambda: magnify_batch_sharded(
                frames_d[None], cfg_sq, mesh11)),
            **{what: (fd, (lambda fd=fd, c=c: magnify_video_spatial(
                fd, c, rows1))) for what, (fd, c, _, _) in
               spatial_runs.items()}}
        n_paths = {}
        for what, (fd, fn) in n_calls.items():
            ms = time_ms(torch, fn, reps=5, warmup=1)
            n_paths[what] = {"fps": fd.shape[0] / (ms / 1e3), "call_ms": ms,
                             **psnr_spatial.get(what, {})}
            log(f"[4] {card}: {what}: {ms:.3f} ms a call of "
                f"{fd.shape[0]} frames, median of 5 -> "
                f"{n_paths[what]['fps']:.2f} frames/s")
        n_paths[path_n]["psnr_vs_oracle_db"] = psnr_n
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
        def bound(name, nbytes, ops):
            byte_ms, op_ms = nbytes / 3.35e9, ops / 67e9
            records[name].update(
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations")

        for name, (nbytes, ops, lib) in work.items():
            bound(name, nbytes, ops)
            records[name].update(
                library_ms=kexp.timed(lib, device=dev)[0] if lib else None)
            log(f"[4] {card}: {name}: bound {records[name]['bound_ms']:.4f} "
                f"ms ({records[name]['bound_by']}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP), kernel {records[name]['ms']:.4f} "
                f"ms; library call "
                + (f"{records[name]['library_ms']:.4f} ms" if lib
                   else "none"))
        # The designs' alternatives, for the record: kernel 6 on half its
        # strip (at one 1080p frame, 288 blocks: one wave of 3 an SM would
        # hold at 64 KB, were the block smaller), and kernel 3 with 1, 2
        # and 4 region rows in flight at radii 2 and 5.
        strip = fused.phase_col_strip
        try:
            fused.phase_col_strip = lambda h, w: strip(h, w) // 2
            half = kexp.timed(calls["phase_col_ifft"][0], device=dev)
        finally:
            fused.phase_col_strip = strip
        log(f"[4] {card}: phase_col_ifft on half its strip "
            f"({strip(g_sq.pad_h, wk) // 2} columns) {half[0]:.4f} ms warm, "
            f"{half[1]:.4f} ms cold, against {records['phase_col_ifft']['ms']:.4f} "
            f"/ {records['phase_col_ifft']['ms_cold']:.4f} on "
            f"{strip(g_sq.pad_h, wk)}")
        records["phase_col_ifft"]["half_strip_ms"] = half
        threads = post_fused._KERNEL3_THREADS
        for c in (cfg, cfg_b15):
            for n in (128, 256, 512):
                try:
                    post_fused._KERNEL3_THREADS = n
                    rows_in = post_fused.kernel3_rows(post_fused._radius(c),
                                                      geom.pad_w, W)
                    ms = kexp.timed(lambda: post_fused.rowifft_post_fused(
                        rre, rim, i_pl, q_pl, win, c, rows[0], H, W, "tight",
                        full_w=geom.pad_w, route=False), device=dev)
                finally:
                    post_fused._KERNEL3_THREADS = threads
                log(f"[4] {card}: rowifft_post_fused at radius "
                    f"{post_fused._radius(c)}, {rows_in} region rows in "
                    f"flight ({n} threads): {ms[0]:.4f} ms warm, {ms[1]:.4f} "
                    "ms cold")
        for name, spec in [*((n, post_work(*v)) for n, v in
                             post_variants.items()),
                           *variant_work.items()]:
            nbytes, ops = spec
            bound(name, nbytes, ops)
            log(f"[4] {card}: {name}: bound {records[name]['bound_ms']:.4f} "
                f"ms ({records[name]['bound_by']}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP), kernel {records[name]['ms']:.4f} "
                f"ms warm, {records[name]['ms_cold']:.4f} ms cold")
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
        # Kernel 8's row pass (the row engine) beside one torch.fft call
        # along the rows, at 2048 and 8192 points.
        fft_in8 = torch.complex(k8w_re, k8w_im)
        for name, lib in (
                ("_fft_axis[inverse, axis 2, scale]",
                 lambda: torch.fft.ifft(fft_in, dim=-1)),
                ("_fft_axis[forward complex, axis 2]",
                 lambda: torch.fft.fft(fft_in, dim=-1)),
                ("_fft_axis[forward real, axis 2]",
                 lambda: torch.fft.fft(k8_re, dim=-1)),
                ("_fft_axis[inverse, axis 2, scale, 8192]",
                 lambda: torch.fft.ifft(fft_in8, dim=-1)),
                ("_fft_axis[forward complex, axis 2, 8192]",
                 lambda: torch.fft.fft(fft_in8, dim=-1)),
                ("_fft_axis[forward real, axis 2, 8192]",
                 lambda: torch.fft.fft(k8w_re, dim=-1))):
            records[name]["library_ms"] = kexp.timed(lib, device=dev)[0]
            log(f"[4] {card}: {name} {records[name]['ms']:.4f} ms warm "
                f"against its library call (torch.fft along dim -1) "
                f"{records[name]['library_ms']:.4f} ms")
        # The kernels past 8192 points (16K) beside the one torch.fft
        # call that computes the same transform.
        fft16 = torch.complex(k8x_re, k8x_im)
        col16 = torch.complex(k16_prev[0], k16_prev[1])
        irfft16 = torch.complex(rre16[..., :g16.pad_w // 2 + 1].contiguous(),
                                rim16[..., :g16.pad_w // 2 + 1].contiguous())
        for name, lib, what in (
                ("windowed_row_fft[16384 lanes, 16K square_pow2]",
                 lambda: torch.fft.fft(y16, dim=-1), "fft dim -1"),
                ("windowed_row_fft_u8planar[16384 lanes, 16K]",
                 lambda: torch.fft.fft(y16, dim=-1), "fft dim -1"),
                ("col_fft_zero_padded[H 16384, 16K]",
                 lambda: torch.fft.fft(col16, dim=-2), "fft dim -2"),
                ("kdecomp_variant[phase + gm + rolls, H 16384]",
                 lambda: torch.fft.ifft(col16, dim=-2), "ifft dim -2"),
                ("row_ifft_magnitude[16384 lanes, 16K]",
                 lambda: torch.fft.irfft(irfft16, n=g16.pad_w, dim=-1),
                 "irfft dim -1"),
                ("_fft_axis[inverse, axis 2, scale, 16384]",
                 lambda: torch.fft.ifft(fft16, dim=-1), "ifft dim -1"),
                ("_fft_axis[forward real, axis 2, 16384]",
                 lambda: torch.fft.fft(k8x_re, dim=-1), "fft dim -1"),
                ("_fft_axis[inverse, axis 1, 16384]",
                 lambda: torch.fft.ifft(fft16, dim=-2), "ifft dim -2"),
                ("_fft_axis[forward complex, axis 1, 16384]",
                 lambda: torch.fft.fft(fft16, dim=-2), "fft dim -2")):
            records[name]["library_ms"] = kexp.timed(lib, device=dev)[0]
            log(f"[4] {card}: {name} {records[name]['ms']:.4f} ms warm, "
                f"bound {records[name]['bound_ms']:.4f} ms, against its "
                f"library call (torch.fft.{what}) "
                f"{records[name]['library_ms']:.4f} ms")
        del fft16, col16, irfft16
        # The copy probe's rows on the 16-frame stack beside one
        # Tensor.copy_ of the same pair.
        cp_pair16 = torch.stack(cp16)
        cp_dst16 = torch.empty_like(cp_pair16)
        name = "copy_probe[rows 1, 16 frames]"
        records[name]["library_ms"] = kexp.timed(
            lambda: cp_dst16.copy_(cp_pair16), device=dev)[0]
        log(f"[4] {card}: {name} {records[name]['ms']:.4f} ms warm, bound "
            f"{records[name]['bound_ms']:.4f} ms, against its library call "
            f"(Tensor.copy_) {records[name]['library_ms']:.4f} ms")
        del cp_pair16, cp_dst16
        for name, num in (("row_ifft_magnitude", 7),
                          ("windowed_row_fft_u8planar", 4),
                          ("windowed_row_fft", 1)):
            rec = records[name]
            log(f"[4] {card}: kernel {num} ({name}, the row engine) "
                f"{rec['ms']:.4f} ms warm against its library call "
                f"{rec['library_ms']:.4f} ms: "
                f"{rec['ms'] / rec['library_ms']:.2f}x; bound "
                f"{rec['bound_ms']:.4f} ms")
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

        # (o): frames/s a steady chunk and the device's idle share, then
        # the two transforms alone at (1, 2048, 2048) beside torch.fft on
        # the same tensors and their bound (tools/roofline.py's count of
        # mxu_fft.py's products and elementwise steps).
        chunk_o, ms_o, fps_o = steady(bar_il_d, cfg_o, path_o)
        prof_o = profile_chunks(torch, chunk_o, card, path_o, n=3, tag="[4]")
        idle_o = None if prof_o is None else 1 - prof_o[1] / prof_o[0]
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

        # (p): the .npy stream on the host clock, the native loader against
        # the memmap route (frame_chunks + magnify_video, the same chunks)
        # on the same files, medians of 3; and each chunk source alone
        # (read, convert, host -> device).
        def memmap_stream(pth):
            st, n = None, 0
            for c in stream.frame_chunks(pth, T, device=dev):
                o, st = pbmm_tpu_torch.magnify_video(c, cfg_sq, st)
                n += o.cpu().numpy().shape[0]
            return n

        def native_stream(pth):
            return sum(c.shape[0] for c in stream.stream_magnify(
                pth, cfg_sq, chunk_frames=T, device=dev))

        def chunk_source(pth, route):
            if route == "native f32 mode":
                with native.NativeFrameLoader(pth, T) as ld:
                    return sum(torch.from_numpy(c).to(dev).shape[0]
                               for c in ld)
            it = (stream._open_chunk_source(pth, T, device=dev)
                  if route == "native" else
                  stream.frame_chunks(pth, T, device=dev))
            return sum(c.shape[0] for c in it)

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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Path (m)'s oracles, which ran beside phases 2-4.
    psnr_m, psnr_ms, psnr_mg = vs_oracle(
        [(p, outs16[p]) for p in (path_m, path_ms, path_mg)], jobs16["m"])
    psnr_mt, = vs_oracle([(path_mt, outs16[path_mt])], jobs16["mt"])
    big_pool.shutdown(wait=True)

    # -- 5. where the time goes (opt-in) -------------------------------------
    if args.profile:
        profile_chunks(torch, chunk, card, "f32 1080p")
        profile_chunks(torch, chunk_u8, card, "u8 1080p -> planar_u8")
        profile_chunks(torch, chunk_540, card, "540p f32")
        for what, (fn, _, _) in matrix.items():
            profile_chunks(torch, fn, card, what)
        for what, (fn, _, _, _) in scan_paths.items():
            profile_chunks(torch, fn, card, what)
        for what, (_, fn) in n_calls.items():
            profile_chunks(torch, fn, card, what)
        profile_chunks(torch, chunk_o, card, path_o)

    sources = {
        # Kernel 1 serves the per-frame pre stage (the front end took its
        # place on the batched engine's chunks).
        "windowed_row_fft": ("pbmm_tpu_torch/csrc/row_fft.cu",
                             "pbmm_tpu/spectral/fused.py:79", path_f),
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
        # Kernel 10 takes the y_only tail where no kernel-3 block fits
        # (path (k)); the JAX package reaches it only through _post_block.
        "post_fused": ("pbmm_tpu_torch/csrc/post_rgb.cu",
                       "pbmm_tpu/engine/post_pallas.py:91", path_k),
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
                   matrix.items(), (psnr_a, psnr_b, psnr_c, None, psnr_j,
                                    None, psnr_l, psnr_lt, psnr_k, None,
                                    psnr_m, psnr_mt))},
            **{what: {"fps": f, "chunk_ms": m, "psnr_vs_oracle_db": db}
               for what, (_, m, f, db) in scan_paths.items()},
            path_h: {"pairs_per_s": 1e3 / pair_ms, "pair_ms": pair_ms,
                     "psnr_vs_oracle_db": psnr_h},
            path_js: {"psnr_vs_oracle_db": psnr_js},
            path_ls: {"psnr_vs_oracle_db": psnr_ls},
            **n_paths,
            path_ms: {"psnr_vs_oracle_db": psnr_ms},
            path_mg: {"psnr_vs_oracle_db": psnr_mg},
            path_o: {"fps": fps_o, "chunk_ms": ms_o, "idle_share": idle_o,
                     "psnr_vs_oracle_db": psnr_o,
                     "psnr_vs_xla_db": psnr_o_xla,
                     "pair_vs_chunk_db": psnr_o_pair,
                     "transforms_1x2048x2048": mxu_times},
            path_p: p_times,
            path_i: {"seconds": meas["seconds"],
                     "row_copy_ceiling_gbps": meas["copy_gbps"],
                     "roofline": meas["roofline"][1],
                     "copy_ceilings_ms": {
                         name: ms for name, (_, ms) in
                         meas["ceilings"].items()},
                     "kdecomp_split_ms": kdecomp.split(meas["kdecomp"]),
                     "kdecomp_split_ms_16_frames": kdecomp.split(
                         meas["kdecomp16"])},
        },
        "launches_by_path": path_launches}))
    dist.destroy_process_group()
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        # Stop at once: the oracle threads would otherwise run to their end
        # before the interpreter exits.
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
