#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its lines; any failure raises, so the script exits
non-zero without the final line:

  0. device: the card's name and power limit (exits without a CUDA card);
  1. build: nvcc compiles the kernels of pbmm_tpu_torch/csrc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, at the
     1080p main-path shapes, from inputs made with numpy from a seed
     (spectra: max error / max magnitude < 1e-4; images: max abs < 1e-4);
  3. end to end on the bench clip (1080p, chunks of 16, shifted noise):
     magnify_video with no state, then again with the returned state, as
     a streaming caller does; every kernel's launch count must rise, outputs
     must be finite in [0, 1], chunks of 8 + 8 must equal one chunk of 16
     bit for bit, and the first 4 frames must score > 100 dB PSNR against
     the fp64 numpy oracle;
  4. timing with CUDA events after warm-up (medians): steady-state chunk
     frames/s, and each kernel beside its plain version;
  5. with --profile only: torch.profiler over a few steady-state chunks,
     printing where the device time of a chunk goes (each kernel's share)
     and the device's idle share with the profiler on.

The line before the last is one JSON object with the kernels' records;
the last line is {"ok": true, "device": {...}}.  The script imports
neither jax nor the JAX package; the oracle modules (numpy only) are
loaded by file path.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H, W, T = 1080, 1920, 16
SPEC_TOL = 1e-4  # max error / max magnitude, spectra
IMG_TOL = 1e-4  # max abs error, images in [0, 1]


def log(*a):
    print(*a, flush=True)


def load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    if spec is None:
        raise FileNotFoundError(ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def profile_chunks(torch, chunk, card, n=5, top=12):
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
        log("[5] torch.profiler recorded no device time: shares not "
            "measured")
        return
    log(f"[5] {card}: per chunk of {T} 1080p frames, mean of {n}: wall "
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
    from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
    from pbmm_tpu_torch.engine import post_fused
    from pbmm_tpu_torch.engine.pipeline import blur_row_window
    from pbmm_tpu_torch.kernels.build import build, library
    from pbmm_tpu_torch.spectral import fused
    from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

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

    # -- 2. kernels vs plain versions at 1080p shapes ----------------------
    cfg = pbmm_tpu_torch.MagnifyConfig().tuned_for_tpu().replace(
        pad_mode="tight")
    geom = geometry_for(H, W, "tight")
    rows = blur_row_window(geom, cfg)
    wk = hermitian_kept_width(geom.pad_w)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(1234)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

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

    calls = {
        "windowed_row_fft": (
            lambda: fused.windowed_row_fft(y, geom.pad_h, 0, True),
            lambda: fused.windowed_row_fft_ref(y, geom.pad_h, 0, True)),
        "colspec_chunk": (
            lambda: fused.colspec_chunk(
                rows_re, rows_im, prev_re, prev_im, cfg, geom.pad_h, 0,
                out_rows=rows, full_w=geom.pad_w),
            lambda: fused.colspec_chunk_ref(
                rows_re, rows_im, prev_re, prev_im, cfg, geom.pad_h, 0,
                out_rows=rows, full_w=geom.pad_w)),
        "rowifft_post_fused": (
            lambda: post_fused.rowifft_post_fused(
                rre, rim, i_pl, q_pl, win, cfg, rows[0], H, W, "tight",
                full_w=geom.pad_w),
            lambda: post_fused.rowifft_post_fused_ref(
                rre, rim, i_pl, q_pl, win, cfg, rows[0], H, W, "tight",
                full_w=geom.pad_w)),
    }
    records = {}
    for name, (kern, plain) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if name == "rowifft_post_fused":
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel, tol, what = err, IMG_TOL, "max abs"
        else:
            pairs = [(got[k], got[k + 1]) for k in range(0, len(got), 2)]
            refs = [(want[k], want[k + 1]) for k in range(0, len(want), 2)]
            err, rel = 0.0, 0.0
            for (gr, gi), (wr, wi) in zip(pairs, refs):
                e, r = spec_err([torch.complex(gr, gi)],
                                [torch.complex(wr, wi)])
                err, rel = max(err, e), max(rel, r)
            tol, what = SPEC_TOL, "max err / max magnitude"
        ok = np.isfinite(rel) and rel < tol
        log(f"[2] {name}: {what} {rel:.3e} (bound {tol:g}), max abs "
            f"{err:.3e}, shapes {[tuple(g.shape) for g in got]} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rel} >= {tol}")
        records[name] = {"max_abs_err": err}

    # -- 3. end to end -----------------------------------------------------
    base = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, shift=i, axis=1) * (0.95 + 0.01 * i)
                       for i in range(T)]).astype(np.float32)
    frames_d = torch.from_numpy(frames).to(dev)
    wrappers = {"windowed_row_fft": fused.windowed_row_fft,
                "colspec_chunk": fused.colspec_chunk,
                "rowifft_post_fused": post_fused.rowifft_post_fused}
    for fn in wrappers.values():
        fn.launches = 0
    out1, s1 = pbmm_tpu_torch.magnify_video(frames_d, cfg)
    out2, s2 = pbmm_tpu_torch.magnify_video(frames_d, cfg, s1)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"[3] launches during the two main-path chunks: {launches}")
    if not all(n >= 1 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
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
    oa, sa = pbmm_tpu_torch.magnify_video(frames_d[:8], cfg)
    ob, sb = pbmm_tpu_torch.magnify_video(frames_d[8:], cfg, sa)
    if not (torch.equal(torch.cat([oa, ob]), out1)
            and torch.equal(sb.prev_spec_re, s1.prev_spec_re)
            and torch.equal(sb.prev_spec_im, s1.prev_spec_im)):
        raise AssertionError("chunks of 8 + 8 differ from one chunk of 16")
    log("[3] chunks 8 + 8 equal one chunk of 16 bit for bit (frames and "
        "state)")
    oracle = load_by_path("_pbmm_oracle_reference",
                          "pbmm_tpu/oracle/reference.py")
    t0 = time.perf_counter()
    want = oracle.oracle_magnify_video(frames[:4], cfg)
    got = out1[:4].double().cpu().numpy()
    mse = float(np.mean((got - want) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)
    log(f"[3] PSNR vs the fp64 oracle, frames 0-3: {psnr:.2f} dB "
        f"(bound > 100; oracle {time.perf_counter() - t0:.1f} s on the host)")
    if not psnr > 100:
        raise AssertionError(f"PSNR {psnr} dB <= 100")

    # -- 4. timing -----------------------------------------------------------
    state = [s2]

    def chunk():
        out, state[0] = pbmm_tpu_torch.magnify_video(frames_d, cfg, state[0])
        return out

    chunk_ms = time_ms(torch, chunk, reps=10, warmup=2)
    fps = T / (chunk_ms / 1e3)
    log(f"[4] {card}: steady-state chunk of {T} 1080p frames "
        f"{chunk_ms:.3f} ms median of 10 -> {fps:.2f} frames/s, "
        f"{chunk_ms / T:.4f} ms/frame")
    for name, (kern, plain) in calls.items():
        k_ms = time_ms(torch, kern)
        p_ms = time_ms(torch, plain)
        records[name].update(ms=k_ms, plain_ms=p_ms)
        log(f"[4] {card}: {name} {k_ms:.4f} ms, plain PyTorch version "
            f"{p_ms:.4f} ms (median of 10, chunk of {T} frames)")

    # -- 5. where the time goes (opt-in) -------------------------------------
    if args.profile:
        profile_chunks(torch, chunk, card)

    sources = {
        "windowed_row_fft": ("pbmm_tpu_torch/csrc/row_fft.cu",
                             "pbmm_tpu/spectral/fused.py:79"),
        "colspec_chunk": ("pbmm_tpu_torch/csrc/colspec_chunk.cu",
                          "pbmm_tpu/spectral/fused.py:1310"),
        "rowifft_post_fused": ("pbmm_tpu_torch/csrc/rowifft_post.cu",
                               "pbmm_tpu/engine/post_pallas.py:198"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": records[name]["max_abs_err"],
         "ms": records[name]["ms"], "plain_ms": records[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]
    log(json.dumps({"kernels": kernels, "fps_1080p": fps,
                    "chunk_ms": chunk_ms, "psnr_vs_oracle_db": psnr}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
