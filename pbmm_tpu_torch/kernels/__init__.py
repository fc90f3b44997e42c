"""Helpers shared by the kernel wrappers: host constants on the device,
argument checks and the finiteness check of `utils.checks.debug_mode`.
The build itself lives in `kernels.build`."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pbmm_tpu_torch.utils.profiling import scope

# Set by `utils.checks.debug_mode(nan_checks=True)`: while it is on, every
# kernel wrapper checks its outputs (`checked`).
CHECK_FINITE = False


def checked(fn):
    """Decorate a kernel wrapper: while `CHECK_FINITE` is on, raise
    `FloatingPointError` naming the wrapper when an output (the kernel's
    or, on CPU tensors, its plain version's) holds a non-finite value."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if CHECK_FINITE:
            outs = (out,) if isinstance(out, torch.Tensor) else out
            for i, x in enumerate(outs):
                if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                    raise FloatingPointError(
                        f"{fn.__name__}: output {i} has "
                        f"{int((~torch.isfinite(x)).sum())} non-finite values")
        return out

    return wrapper


@functools.lru_cache(maxsize=32)
def device_arrays(fn, args: tuple, device: torch.device):
    """`fn(*args)`'s numpy arrays (a tuple) as f32 tensors on `device`.

    Memoised: the arrays are read-only constants derived from static
    arguments (twiddle tables, the per-bin phase planes), as the JAX
    package bakes them into its compiled kernels; copying them to the card
    on every call would cost more than the kernels they feed.  A build
    (a cache miss) runs inside the span `pbmm.table`."""
    with scope("pbmm.table"):
        return tuple(
            torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)
            for a in fn(*args))


@functools.lru_cache(maxsize=32)
def device_ints(fn, args: tuple, device: torch.device):
    """`fn(*args)`'s numpy arrays (a tuple) as int32 tensors on `device`
    (memoised like `device_arrays`, a build inside the span `pbmm.table`):
    the kernels' per-tile tables."""
    with scope("pbmm.table"):
        return tuple(
            torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)
            for a in fn(*args))


def c_ints(values) -> ctypes.Array:
    """A host int array for a C entry point that copies it by value."""
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)


def c_floats(values) -> ctypes.Array:
    values = [float(v) for v in values]
    return (ctypes.c_float * len(values))(*values)


def check_cuda(name: str, shape, *tensors: torch.Tensor,
               dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous `dtype` CUDA tensor of
    `shape` (None entries match any size) on one device."""
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if len(x.shape) != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of `device`, for a C launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
