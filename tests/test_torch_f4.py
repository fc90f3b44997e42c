"""The plain versions of the kernels at padded sizes above 8192 (fault F4)
against the JAX package's kernels in interpret mode, on narrow shapes.

- Kernel 2 (`colspec_chunk_ref`) at T = 2, H = 16384 (square_pow2, 16K's
  padded height) and at tight m = 68 (8704 rows, 16K's tight height),
  128 lanes: spectra to max error / max magnitude < 1e-4, as
  tests/test_torch_blur.py holds it at 4320p's heights.
- Kernel 5 (`col_fft_zero_padded_ref`) at H = 16384.
- Kernels 1 (`windowed_row_fft_ref`, kept half and full) and 7
  (`row_ifft_magnitude_ref`, |z| and Re z) on a few rows of 16384 lanes.
The JAX kernels run their matmuls at gm_precision "highest" (full f32),
and the module drops those traces when it ends (ROADMAP: precision as
global state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu_torch import MagnifyConfig
from pbmm_tpu_torch.spectral import fused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_highest_traces():
    """Drop the JAX traces made at gm_precision "highest" when the module
    ends, so later tests of the process trace the default anew."""
    yield
    set_gm_precision("")
    jax.clear_caches()


def _rel(got, want):
    g = got[0] + 1j * got[1]
    w = want[0] + 1j * want[1]
    return np.abs(g - w).max() / np.abs(w).max()


def _highest(fn, *args, **kw):
    set_gm_precision("highest")
    try:
        return [np.asarray(x) for x in fn(*args, **kw)]
    finally:
        set_gm_precision("")


@pytest.mark.parametrize("pad_h,row0,hc", [(16384, 3872, 8640),
                                           (68 * 128, 3840, 1024)],
                         ids=["square_pow2_16384", "tight_m68"])
def test_colspec_chunk_ref_vs_jax_above_8192(pad_h, row0, hc):
    rng = np.random.default_rng(pad_h)
    rows_in = [rng.standard_normal((2, hc, 128)).astype(np.float32)
               for _ in range(2)]
    prev = [rng.standard_normal((1, pad_h, 128)).astype(np.float32)
            for _ in range(2)]
    tc = MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight")
    jc = JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True, gm_precision="highest")
    rows = (row0 - 4, row0 + hc + 4)
    want = _highest(jfused.colspec_chunk,
                    *[jnp.asarray(x) for x in rows_in + prev], jc,
                    pad_h=pad_h, row0=row0, out_rows=rows, interpret=True)
    got = fused.colspec_chunk_ref(*[torch.from_numpy(x)
                                    for x in rows_in + prev], tc, pad_h,
                                  row0, out_rows=rows)
    assert got[0].shape == (2, rows[1] - rows[0], 128)
    assert got[2].shape == (1, pad_h, 128)
    for k in (0, 2):
        assert _rel([x.numpy() for x in got[k:k + 2]],
                    want[k:k + 2]) < 1e-4, k


def test_col_fft_zero_padded_ref_vs_jax_16384():
    rng = np.random.default_rng(5)
    re, im = (rng.standard_normal((1, 8640, 128)).astype(np.float32)
              for _ in range(2))
    want = _highest(jfused.col_fft_zero_padded, jnp.asarray(re),
                    jnp.asarray(im), 16384, 3872, interpret=True)
    got = fused.col_fft_zero_padded_ref(torch.from_numpy(re),
                                        torch.from_numpy(im), 16384, 3872)
    assert got[0].shape == (1, 16384, 128)
    assert _rel([x.numpy() for x in got], want) < 1e-4


@pytest.mark.parametrize("keep_half", [True, False], ids=["kept", "full"])
def test_windowed_row_fft_ref_vs_jax_16384(keep_half):
    rng = np.random.default_rng(7)
    y = rng.random((2, 3, 16384)).astype(np.float32)
    want = _highest(jfused.windowed_row_fft, jnp.asarray(y), 8704, 40,
                    keep_half=keep_half, interpret=True)
    got = fused.windowed_row_fft_ref(torch.from_numpy(y), 8704, 40,
                                     keep_half)
    wk = hermitian_kept_width(16384) if keep_half else 16384
    assert got[0].shape == (2, 3, wk)
    assert _rel([x.numpy() for x in got], want) < 1e-4


@pytest.mark.parametrize("magnitude", [True, False], ids=["abs", "re"])
def test_row_ifft_magnitude_ref_vs_jax_16384(magnitude):
    rng = np.random.default_rng(9)
    wk = hermitian_kept_width(16384)
    re, im = (rng.standard_normal((2, 3, wk)).astype(np.float32)
              for _ in range(2))
    set_gm_precision("highest")
    try:
        want = np.asarray(jfused.row_ifft_magnitude(
            jnp.asarray(re), jnp.asarray(im), magnitude, pad_h=8704,
            full_w=16384, interpret=True))
    finally:
        set_gm_precision("")
    got = fused.row_ifft_magnitude_ref(torch.from_numpy(re),
                                       torch.from_numpy(im), magnitude,
                                       pad_h=8704, full_w=16384).numpy()
    assert got.shape == want.shape == (2, 3, 16384)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
