"""ctypes binding of the native streaming frame loader (host C++).

Counterpart of `pbmm_tpu/native/__init__.py`, with its own copy of the
source (`frameloader.cpp`).  `g++` builds it at first use, under a lock,
into the port's build directory (`kernels.build.BUILD_DIR`,
`build/pbmm_tpu_torch/`, git-ignored), never beside the source, and
again when the source is newer than the library.  `-march=native` ties
the code to the CPU that built it, so the library's name carries a
fingerprint of that CPU: a checkout copied to another machine builds its
own.  Without a compiler `native_available()` is False and the callers
keep their numpy routes (`io.stream` its memmap), which give the same
bits.

A loader opened with `raw=True` (`fl_open_raw`) reads the file's bytes
unconverted, uint8 or f32, straight into a ring of two tensors it
allocates (pinned with `pin_memory=True`) and lends them out one chunk
at a time (`next_view`): `io.stream` copies each to the card from there
and scales uint8 on the card, so an 8-bit file crosses at a quarter of
the f32 bytes, with no host copy besides the read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pbmm_tpu_torch.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "frameloader.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _cpu_tag() -> str:
    """A short fingerprint of the host CPU (model and feature flags)."""
    try:
        with open("/proc/cpuinfo") as f:
            keys = [ln for ln in f if ln.startswith(("model name", "flags"))]
        text = "".join(sorted(set(keys)))
    except OSError:
        text = ""
    text += platform.machine() + platform.processor()
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def library_path() -> Path:
    """Where this host's build of the loader lives."""
    return BUILD_DIR / f"libpbmm_native.{_cpu_tag()}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    # Atomic: another process may be loading the same path.
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() or path.stat().st_mtime < SRC.stat().st_mtime:
            if not _build(path):
                _build_failed = True
                return None
        lib = ctypes.CDLL(str(path))
        lib.fl_open.restype = ctypes.c_void_p
        lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.fl_info.restype = ctypes.c_int
        lib.fl_info.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_long)] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.fl_open_raw.restype = ctypes.c_void_p
        lib.fl_open_raw.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.fl_start_raw.restype = ctypes.c_int
        lib.fl_start_raw.argtypes = [ctypes.c_void_p] * 3
        lib.fl_next.restype = ctypes.c_long
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
        lib.fl_next_raw.restype = ctypes.c_long
        lib.fl_next_raw.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.fl_close.restype = None
        lib.fl_close.argtypes = [ctypes.c_void_p]
        lib.convert_u8_to_f32.restype = None
        lib.convert_u8_to_f32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_long]
        lib.rgb_to_yiq_f32.restype = None
        lib.rgb_to_yiq_f32.argtypes = [ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeFrameLoader:
    """Streaming .npy reader (THWC, uint8 or f32, C order) with a
    background prefetch thread and the u8 -> f32 conversion in native
    code.  Iterate for chunks of (n, H, W, 3) f32 arrays; with `raw=True`
    call `next_view` for the ring's tensors, in the file's dtype
    (`dtype`), no copy.  `close()` (or the context manager)
    stops the thread and closes the file.  `served` counts the chunks
    that loaders have handed out, for callers that check the route."""

    served = 0

    def __init__(self, path: str, chunk_frames: int = 8, raw: bool = False,
                 pin_memory: bool = False):
        if chunk_frames < 1:
            # fl_open would take 8 and overrun this binding's buffer.
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._h = (lib.fl_open_raw if raw else lib.fl_open)(
            os.fsencode(path), chunk_frames)
        if not self._h:
            raise ValueError(
                f"cannot open {path!r}: need .npy THWC u8/f32 C-order")
        t, hh, w, c = (ctypes.c_long() for _ in range(4))
        dt = ctypes.c_int()
        lib.fl_info(self._h, t, hh, w, c, dt)
        self.num_frames = t.value
        self.shape = (hh.value, w.value, c.value)
        self.chunk_frames = chunk_frames
        self.dtype = np.dtype(np.float32 if dt.value == 1 else np.uint8)
        self._ring = None
        if raw:
            # The reader writes into these until `close` joins it.
            self._ring = tuple(torch.empty(
                (chunk_frames,) + self.shape,
                dtype=torch.float32 if dt.value == 1 else torch.uint8,
                pin_memory=pin_memory) for _ in range(2))
            if lib.fl_start_raw(self._h, *(r.data_ptr() for r in self._ring)):
                self.close()
                raise RuntimeError(f"cannot start the reader of {path!r}")

    def __iter__(self):
        if self._ring is not None:
            raise ValueError("a raw loader serves chunks by next_view")
        buf = np.empty((self.chunk_frames,) + self.shape, np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while self._h:
            n = self._lib.fl_next(self._h, ptr)
            if n <= 0:
                return
            NativeFrameLoader.served += 1
            yield buf[:n].copy()

    def next_view(self) -> Optional[torch.Tensor]:
        """Raw mode: the next chunk, (n, H, W, 3) in the file's dtype, as a
        view of the ring, lent until the next call or `close`; None at the
        end."""
        if self._ring is None:
            raise ValueError("next_view needs a loader opened with raw=True")
        slot = ctypes.c_int()
        n = self._lib.fl_next_raw(self._h, slot) if self._h else 0
        if n <= 0:
            return None
        NativeFrameLoader.served += 1
        return self._ring[slot.value][:n]

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # A loader dropped unclosed still stops its prefetch thread.
        if getattr(self, "_h", None):
            self.close()


def convert_u8_frames(frames_u8: np.ndarray) -> np.ndarray:
    """u8 -> f32 / 255 through the native loop (numpy without it)."""
    lib = _load()
    frames_u8 = np.ascontiguousarray(frames_u8)
    if lib is None:
        return frames_u8.astype(np.float32) / 255.0
    out = np.empty(frames_u8.shape, np.float32)
    lib.convert_u8_to_f32(
        frames_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames_u8.size)
    return out
