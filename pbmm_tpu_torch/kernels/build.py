"""Build and load the package's CUDA kernels.

The sources under `pbmm_tpu_torch/csrc/` have a plain C interface; `nvcc`
compiles them for Hopper (`sm_90a`), one process per source started
together, and links them into one shared library under
`build/pbmm_tpu_torch/` at the repository root (git-ignored), at first use
and again whenever a source is newer than the library.  The library is
loaded with `ctypes`; each kernel's wrapper passes `data_ptr()`s and the
current stream and raises on the `cudaError_t` the C function returns.

There is no fallback: a missing `nvcc` or a failed build raises with the
compiler's output.  No `--use_fast_math` / `-ftz=true`: the phase pass's
1e-38 guard is subnormal in f32 and must not flush to zero.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pbmm_tpu_torch"
LIB_NAME = "libpbmm_tpu_torch.so"
SOURCES = ("row_fft.cu", "colspec_chunk.cu", "rowifft_post.cu",
           "row_ifft.cu", "col_fft.cu", "post_rgb.cu", "phase_col_ifft.cu",
           "fft_axis.cu", "amplify_procedural.cu", "kdecomp.cu",
           "copy_probe.cu", "trig_probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Every pointer and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int).
SIGNATURES = {
    # y, wy, wx, tw_re, tw_im, out_re, out_im, kept_tiles(host), n_kept,
    # batch, hc, w, stream
    "pbmm_row_fft": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # frames_u8, wy, wx, tw_re, tw_im, out_re, out_im, kept_tiles(host),
    # n_kept, t, hc, h_in, w_in, w, off, x0, coeffs(host), scale, stream
    "pbmm_row_fft_u8": [_P] * 8 + [_I] * 8 + [_P, _F, _P],
    # rows_re, rows_im, prev_re, prev_im, lpf_in, lps_in, plane0, plane1,
    # fy, fx, fs_tw_re, fs_tw_im, comb_re, comb_im, tw_fwd_re, tw_fwd_im,
    # tw_inv_re, tw_inv_im, out_re, out_im, new_prev_re, new_prev_im,
    # new_lpf, new_lps, phase ints(host), phase floats(host),
    # t, planes, hc, h, wk, row0, r0, r1, stream
    "pbmm_colspec_chunk": [_P] * 26 + [_I] * 8 + [_P],
    # re, im, tw_re, tw_im, out_re, out_im, batch, hc, h, wk, row0, stream
    "pbmm_col_fft": [_P] * 6 + [_I] * 5 + [_P],
    # rre, rim, i_plane, q_plane, rgb_u8, win, tw_re, tw_im, out0, out1,
    # out2, plan_src(host), plan_rev(host), n_tiles, taps(host), radius,
    # yiq_to_rgb(host), iq_u8(host), layout, t, hr, wk, w, in_h, in_w,
    # yrow0, x0, scale, magnitude, comp, gain, g_y, g_i, g_q, stream
    "pbmm_rowifft_post": [_P] * 13 + [_I, _P, _I, _P, _P] + [_I] * 9
    + [_F, _I, _I, _I, _F, _F, _F, _P],
    # re, im, tw_re, tw_im, out, plan_src(host), plan_rev(host), n_tiles,
    # batch, hb, wk, w, scale, magnitude, stream
    "pbmm_row_ifft": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    # chans3, win, out0, out1, out2, taps(host), radius, yiq_to_rgb(host),
    # layout, t, hr, w, in_h, in_w, yrow0, x0, comp, gain, g_y, g_i, g_q,
    # stream
    "pbmm_post_rgb": [_P] * 6 + [_I, _P] + [_I] * 10 + [_F] * 3 + [_P],
    # chans, i_plane, q_plane, win, out0, out1, out2, taps(host), radius,
    # yiq_to_rgb(host), then as pbmm_post_rgb from layout on
    "pbmm_post_yonly": [_P] * 8 + [_I, _P] + [_I] * 10 + [_F] * 3 + [_P],
    # cur_re, cur_im, prev_re, prev_im, lpf_in, lps_in, plane0, plane1,
    # fy, fx, tw_re, tw_im, out_re, out_im, new_lpf, new_lps, phase
    # ints(host), phase floats(host), batch, h, w, r0, r1, stream
    "pbmm_phase_col_ifft": [_P] * 18 + [_I] * 5 + [_P],
    # re, im (null: real), tw_re, tw_im, out_re, out_im, batch, h, w,
    # axis, inverse, scale, stream
    "pbmm_fft_axis": [_P] * 6 + [_I] * 5 + [_F, _P],
    # cur_re, cur_im, prev_re, prev_im, fy, fx, out_re, out_im, ints(host),
    # floats(host), planes, h, w, stream
    "pbmm_amplify_procedural": [_P] * 10 + [_I] * 3 + [_P],
    # cur_re, cur_im, prev_re, prev_im, plane0, plane1, fy, fx, tw_re,
    # tw_im, out_re, out_im, phase ints(host), phase floats(host), pieces,
    # batch, h, w, r0, r1, stream
    "pbmm_kdecomp": [_P] * 14 + [_I] * 6 + [_P],
    # a, b, out_a, out_b, pattern, block, batch, h, w, stream
    "pbmm_copy_probe": [_P] * 4 + [_I] * 5 + [_P],
    # in0..in4, fy, fx, out0, out1, phase ints(host), phase floats(host),
    # op, iarg, lo, hi, span, n, w, stream
    "pbmm_trig_probe": [_P] * 11 + [_I] * 2 + [_F] * 3 + [_I] * 2 + [_P],
}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the toolkit's default
    location; raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of pbmm_tpu_torch cannot be built")


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.glob("*.cu*"))


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library is missing or older than a
    source; returns the library path.  Each source compiles in its own
    nvcc process, all at once, and one more links the objects.
    `verbose` adds `-Xptxas -v` (each kernel's registers, shared memory
    and spills) and prints nvcc's output."""
    lib = BUILD_DIR / LIB_NAME
    if not _stale(lib) and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = nvcc_path()
    flags = [nvcc, *NVCC_FLAGS, "-I", str(CSRC)]
    if verbose:
        flags += ["-Xptxas", "-v"]
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = list(pool.map(
            _run, [flags + ["-c", "-o", str(o), str(CSRC / s)]
                   for s, o in zip(SOURCES, objs)]))
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp)] + [
        str(o) for o in objs]
    logs.append(_run(link))
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)
    if verbose:
        print(f"nvcc build {time.perf_counter() - t0:.1f} s "
              f"({len(SOURCES)} sources in parallel, then the link)")
        print("".join(logs))
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes
    and restype set on every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise on a nonzero `cudaError_t` from a launch."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
