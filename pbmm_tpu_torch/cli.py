"""Command-line entry point of the port.

    python -m pbmm_tpu_torch.cli --input clip.npy --output out.npy \
        --fast --pad-mode tight
    python -m pbmm_tpu_torch.cli --stream --ingest u8 --fast \
        --pad-mode tight --output-layout planar_u8 --input clip.y4m \
        --output -

The parser and `config_from_args` are those of `pbmm_tpu/cli.py`, so one
command line configures either package.  Served: the whole-file mode and
the three `--stream` modes (the resumable `--checkpoint` loop, the
`--output -` y4m pipe loop and whole output), with the default config
(`torch.fft`, the scan engine), `--fast` (the batched engine where it
serves the frames) and any `--engine`, `--no-cache-prev-spectrum`,
`--fft-backend xla|pallas`, `--full-spectrum`, `--apply-magnitude-scale`,
`--pad-mode`, `--chroma`, `--temporal`, `--mode`, `--orientations`,
`--levels`, `--phase-scale`, `--reconstruct`, `--compensate-window`,
`--yiq-gains` and `--no-magnify`.  `--stats` names the engine that ran.
`--demo bar|blob` magnifies a synthetic clip in place of `--input`,
`--debug-view magnitude|phase|split` renders spectrum views instead of
magnifying, and `--trace LOGDIR` writes a `torch.profiler` Chrome trace
of the run into LOGDIR.  `--fft-backend mxu` exits 2 naming ROADMAP item
10.  It runs on the first CUDA card and exits with an error when there
is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbmm_tpu_torch",
        description="Phase-based motion magnification on an NVIDIA GPU "
                    "(the PyTorch / CUDA port of pbmm_tpu)",
    )
    p.add_argument("--input", help="input video (.npy/.npz/.y4m, THWC), or "
                                   "'-' for a y4m stream on stdin (pipe "
                                   "mode, e.g. `ffmpeg ... -f yuv4mpegpipe "
                                   "- | pbmm --input - --stream ...`)")
    p.add_argument("--demo", choices=["bar", "blob"],
                   help="generate a synthetic demo clip instead of --input")
    p.add_argument("--output", required=True,
                   help="output path (.npy/.npz/.y4m), or '-' for a live "
                        "y4m stream on stdout (with --stream: pipe to a "
                        "player, e.g. `... --output - | mpv -`)")
    p.add_argument("--mode", default="pyramid", choices=["pyramid", "standard"])
    p.add_argument("--phase-scale", type=float, default=10.0)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--min-frequency", type=float, default=0.05)
    p.add_argument("--max-frequency", type=float, default=0.45)
    p.add_argument("--orientations", type=int, default=0)
    p.add_argument("--magnitude-threshold", type=float, default=0.01)
    p.add_argument("--low-cutoff", type=float, default=0.05)
    p.add_argument("--high-cutoff", type=float, default=0.4)
    p.add_argument("--steepness", type=float, default=3.0)
    p.add_argument("--motion-sensitivity", type=float, default=1.5)
    p.add_argument("--edge-enhancement", type=float, default=0.8)
    p.add_argument("--no-edges", action="store_true")
    p.add_argument("--no-bandpass", action="store_true")
    p.add_argument("--chroma", default="y_only", choices=["y_only", "rgb"])
    p.add_argument("--output-layout", default="interleaved",
                   choices=["interleaved", "planar", "planar_u8"],
                   help="planar/planar_u8 ((T,3,H,W), written directly by "
                        "the post kernel — no channel interleave; "
                        "planar_u8 quarters the output bytes)")
    p.add_argument("--gm-precision", default="",
                   choices=["", "b3", "highest", "default"],
                   help="accepted for config parity with pbmm_tpu; the "
                        "port computes in full f32 whatever it says")
    p.add_argument("--pad-mode", default="square_pow2",
                   choices=["square_pow2", "rect_pow2", "tight"],
                   help="tight: height to the next 128 multiple (1080p -> "
                        "1152x2048, 0.56x the reference's pixels; r5)")
    p.add_argument("--reconstruct", default="magnitude",
                   choices=["magnitude", "real"])
    p.add_argument("--temporal", default="two_frame",
                   choices=["two_frame", "iir_bandpass"])
    p.add_argument("--temporal-low-hz", type=float, default=0.4)
    p.add_argument("--temporal-high-hz", type=float, default=3.0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "scan", "batched"],
                   help="batched/auto = the chunk engine where it serves "
                        "the config (else the scan engine); scan = the "
                        "per-frame engine")
    p.add_argument("--checkpoint", help="state file: loaded if it exists, "
                                        "saved after the run (streaming)")
    p.add_argument("--debug-view", choices=["magnitude", "phase", "split"],
                   help="render spectrum debug views instead of magnifying "
                        "(the reference's showMagnitude/showPhase toggles)")
    p.add_argument("--stream", action="store_true",
                   help="stream the input in chunks (flat memory for "
                        "long videos)")
    p.add_argument("--chunk-frames", type=int, default=8)
    p.add_argument("--ingest", default="f32", choices=["f32", "u8"],
                   help="u8: y4m sources decode to planar uint8 RGB on "
                        "the card, feeding the 8-bit ingestion kernels "
                        "(adds the one 8-bit rounding every rgb24 "
                        "decoder applies)")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON line of timing/shape stats to stderr")
    p.add_argument("--fast", action="store_true",
                   help="the fused spectral configuration "
                        "(MagnifyConfig.tuned_for_tpu(), the one the port's "
                        "kernels serve); PSNR-equivalent output")
    # --- full inspector surface (quirk switches + backend selection) ---
    p.add_argument("--no-magnify", action="store_true",
                   help="applyMotionMagnification=false bypass: frames "
                        "pass through untouched (A/B output)")
    p.add_argument("--fft-backend", default=None,
                   choices=["xla", "pallas", "mxu"],
                   help="spectral backend (default: config default / "
                        "--fast); pallas implies --full-spectrum")
    p.add_argument("--full-spectrum", action="store_true",
                   help="use_rfft=False: literal full-complex spectra "
                        "instead of the Hermitian half")
    p.add_argument("--blur-size", type=float, default=0.5,
                   help="the anti-aliasing Gaussian's _BlurSize "
                        "(reference fixes 0.5)")
    p.add_argument("--compensate-window", action="store_true",
                   help="divide the Hann vignette back out (the reference "
                        "never does)")
    p.add_argument("--no-cache-prev-spectrum", action="store_true",
                   help="re-FFT the previous frame every frame, as the "
                        "reference literally does")
    p.add_argument("--apply-magnitude-scale", action="store_true",
                   help="apply the magnitude scale the reference computes "
                        "but drops (PhaseDifferenceComputeShader:169-178)")
    p.add_argument("--magnitude-scale", type=float, default=1.0)
    p.add_argument("--yiq-gains", type=float, nargs=3, default=None,
                   metavar=("Y", "I", "Q"),
                   help="per-channel YIQ gains (enables the reference's "
                        "inert _YIQADJUSTMENT_ON path)")
    p.add_argument("--trace", metavar="LOGDIR",
                   help="capture a profiler trace of the run into "
                        "LOGDIR (a Chrome trace, torch.profiler)")
    return p


def config_from_args(args):
    from pbmm_tpu_torch.config import MagnifyConfig, TemporalConfig

    backend_kw = {}
    if getattr(args, "fft_backend", None):
        backend_kw["fft_backend"] = args.fft_backend
        if args.fft_backend == "pallas":
            backend_kw["use_rfft"] = False
        elif args.fft_backend == "mxu":
            backend_kw["use_rfft"] = True
    if getattr(args, "full_spectrum", False):
        backend_kw["use_rfft"] = False
    return MagnifyConfig(
        apply_motion_magnification=not getattr(args, "no_magnify", False),
        blur_size=getattr(args, "blur_size", 0.5),
        compensate_window=getattr(args, "compensate_window", False),
        cache_prev_spectrum=not getattr(args, "no_cache_prev_spectrum",
                                        False),
        apply_magnitude_scale=getattr(args, "apply_magnitude_scale", False),
        magnitude_scale=getattr(args, "magnitude_scale", 1.0),
        yiq_gains=tuple(args.yiq_gains) if getattr(args, "yiq_gains", None)
        else (1.0, 1.0, 1.0),
        apply_yiq_gains=bool(getattr(args, "yiq_gains", None)),
        **backend_kw,
        mode=args.mode,
        phase_scale=args.phase_scale,
        pyramid_levels=args.levels,
        min_frequency=args.min_frequency,
        max_frequency=args.max_frequency,
        orientations=args.orientations,
        magnitude_threshold=args.magnitude_threshold,
        low_freq_cutoff=args.low_cutoff,
        high_freq_cutoff=args.high_cutoff,
        filter_steepness=args.steepness,
        motion_sensitivity=args.motion_sensitivity,
        enhance_edges=not args.no_edges,
        edge_enhancement=args.edge_enhancement,
        apply_bandpass=not args.no_bandpass,
        chroma=args.chroma,
        output_layout=getattr(args, "output_layout", "interleaved"),
        gm_precision=getattr(args, "gm_precision", ""),
        pad_mode=args.pad_mode,
        reconstruct=args.reconstruct,
        temporal=TemporalConfig(
            mode=args.temporal,
            low_hz=args.temporal_low_hz,
            high_hz=args.temporal_high_hz,
            fps=args.fps,
        ),
        # cfg.engine is the hashed config field; "auto"/"batched" keep
        # the chunk engine.
        engine="scan" if getattr(args, "engine", "auto") == "scan"
        else "batched",
    )


def main(argv=None, device=None) -> int:
    """Run the command line `argv`; `device` (default: the first CUDA
    card, which must exist) is where the frames are magnified."""
    args = build_parser().parse_args(argv)
    if bool(args.input) == bool(args.demo):
        print("error: exactly one of --input / --demo is required",
              file=sys.stderr)
        return 2
    if args.input == "-" and not args.stream:
        print("error: --input - (stdin pipe) requires --stream",
              file=sys.stderr)
        return 2
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA card: the port runs on an NVIDIA GPU",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    cfg = config_from_args(args)
    if args.fast:
        cfg = cfg.tuned_for_tpu()
    try:
        if args.trace:
            from pbmm_tpu_torch.utils.profiling import trace

            with trace(args.trace):
                return _run(args, cfg, torch.device(device))
        return _run(args, cfg, torch.device(device))
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _stats(args, **kw) -> None:
    if args.stats:
        print(json.dumps(kw), file=sys.stderr)


def _frames(args):
    """The whole input clip: the --demo clip or the --input file."""
    if args.demo:
        from pbmm_tpu_torch.oracle.synthetic import (
            oscillating_bar,
            oscillating_gaussian_blob,
        )

        return (oscillating_bar(bar_width=2) if args.demo == "bar"
                else oscillating_gaussian_blob())
    from pbmm_tpu_torch.io.video import load_video

    return load_video(args.input)


def _debug_view(args, frames, cfg, device) -> int:
    """Render the spectrum view of each frame instead of magnifying."""
    from pbmm_tpu_torch.engine.pipeline import on_device
    from pbmm_tpu_torch.io.video import save_video
    from pbmm_tpu_torch.utils.debug import debug_frame_view

    out = np.stack([debug_frame_view(
        on_device(f, device), cfg,
        show_magnitude=args.debug_view in ("magnitude", "split"),
        show_phase=args.debug_view in ("phase", "split")).cpu().numpy()
        for f in frames])
    save_video(args.output, out)
    return 0


def _run(args, cfg, device) -> int:
    from pbmm_tpu_torch.io.video import save_video

    t0 = time.perf_counter()
    if args.stream and (not args.input or args.debug_view):
        print("error: --stream requires --input and renders no "
              "--debug-view", file=sys.stderr)
        return 2
    if not args.stream:
        from pbmm_tpu_torch.engine.state import load_state, save_state
        from pbmm_tpu_torch.engine.video import magnify_video

        frames = _frames(args)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            print(f"error: expected (T, H, W, 3) input, got {frames.shape}",
                  file=sys.stderr)
            return 2
        if args.debug_view:
            return _debug_view(args, frames, cfg, device)
        from pbmm_tpu_torch.engine.video import _colspec_ok

        state = None
        if args.checkpoint and os.path.exists(args.checkpoint):
            state = load_state(args.checkpoint, device)
        out, state = magnify_video(frames, cfg, state=state, device=device)
        out = out.cpu().numpy()
        if args.checkpoint:
            save_state(state, args.checkpoint)
        dt = time.perf_counter() - t0
        save_video(args.output, out)
        # The engine that served the run, not just the config field.
        batched = cfg.engine == "batched" and _colspec_ok(cfg, frames.shape)
        _stats(args, frames=int(frames.shape[0]),
               shape=list(frames.shape[1:3]), seconds=round(dt, 3),
               fps=round(frames.shape[0] / dt, 2),
               engine="batched" if batched else "scan")
        return 0

    from pbmm_tpu_torch.io.stream import (
        stream_magnify,
        stream_magnify_resumable,
    )

    if args.checkpoint:
        # Resume loop: incremental output + atomic per-chunk state, so
        # re-running this exact command after a kill continues from the
        # last completed chunk.
        n = stream_magnify_resumable(
            args.input, args.output, cfg, chunk_frames=args.chunk_frames,
            checkpoint=args.checkpoint, ingest=args.ingest, device=device)
        _stats(args, frames=n, seconds=round(time.perf_counter() - t0, 3),
               engine="stream_resumable")
        return 0
    if args.output == "-":
        # Live pipe loop: magnified frames leave on stdout as y4m as each
        # chunk completes, with the source's frame rate in the header.
        from pbmm_tpu_torch.io.y4m import Y4MStreamWriter

        meta = {}
        writer = None
        n = 0
        tc = time.perf_counter()
        for chunk in stream_magnify(args.input, cfg,
                                    chunk_frames=args.chunk_frames,
                                    ingest=args.ingest, meta=meta,
                                    device=device):
            if writer is None:
                writer = Y4MStreamWriter(sys.stdout.buffer,
                                         fps=meta.get("fps", (30, 1)))
            writer.write_chunk(chunk)
            n += chunk.shape[0]
            now = time.perf_counter()
            _stats(args, chunk_frames=int(chunk.shape[0]),
                   chunk_ms=round((now - tc) * 1e3, 2))
            tc = now
        _stats(args, frames=n, seconds=round(time.perf_counter() - t0, 3),
               engine="stream_pipe")
        return 0
    out = np.concatenate(list(stream_magnify(
        args.input, cfg, chunk_frames=args.chunk_frames, ingest=args.ingest,
        device=device)))
    dt = time.perf_counter() - t0
    save_video(args.output, out)
    _stats(args, frames=int(out.shape[0]), seconds=round(dt, 3),
           engine="stream")
    return 0


if __name__ == "__main__":
    sys.exit(main())
