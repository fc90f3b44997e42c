"""Debug-mode numerical checks (counterpart of `pbmm_tpu/utils/checks.py`).

What can go wrong here is numerical (NaN/Inf from bad configs, a kernel
that reads past its data).  `debug_mode()` is the analog of
`jax_debug_nans`: while it is on, every kernel wrapper of the port checks
its outputs with `torch.isfinite` and raises `FloatingPointError` naming
the kernel.  The JAX function's other half, forcing the Pallas kernels
through the interpreter, is not global state here: every wrapper takes its
plain PyTorch version when the tensors it is given lie on the CPU
(`MagnifyConfig.interpret_pallas` is ignored by the port), so a run on
CPU tensors is the interpreted run.
"""

from __future__ import annotations

import contextlib

import numpy as np

from pbmm_tpu_torch import kernels


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Check every kernel wrapper's outputs for non-finite values while
    the block runs; the previous setting comes back on exit."""
    prev = kernels.CHECK_FINITE
    kernels.CHECK_FINITE = bool(nan_checks)
    try:
        yield
    finally:
        kernels.CHECK_FINITE = prev


def assert_finite(name: str, *arrays) -> None:
    """Host-side sanity check for tests and streaming loops."""
    for i, a in enumerate(arrays):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values"
            )
