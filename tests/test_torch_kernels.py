"""Each kernel's plain PyTorch version against the JAX Pallas kernel (in
interpret mode), at the 320x384 clip geometry (H = 384 = 3*128, W = 512,
3 of 4 lane tiles kept) and at the 1080p column length
(H = 1152 = 9*128) on W = 512.  On the CPU every public wrapper takes its
plain version, so these hold the port's CPU path and fix the layout the
CUDA kernels must reproduce (checked on the card by chip_smoke.py).

Tolerances: spectra to max error / max magnitude < 1e-4 and images to
max abs < 1e-4, the bars of tests/test_tight.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.core.window import hann2d_region as jhann
from pbmm_tpu.engine.pipeline import blur_row_window as jrows
from pbmm_tpu.engine.post_pallas import rowifft_post_fused as jpost
from pbmm_tpu.spectral.fused import aligned_row_window
from pbmm_tpu.spectral.fused import colspec_chunk as jcolspec
from pbmm_tpu.spectral.fused import windowed_row_fft as jrowfft
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine.post_fused import (
    rowifft_post_fused,
    rowifft_post_fused_ref,
)
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.spectral import radix2
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

# (in_h, in_w): tight geometries of the two sizes
SIZES = {"clip384": (320, 384), "col1152": (1080, 384)}


def _cfgs():
    j = JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True)
    t = TCfg(phase_scale=10.0).tuned_for_tpu().replace(pad_mode="tight")
    return j, t


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.fixture(scope="module", params=sorted(SIZES))
def case(request):
    """Inputs made with numpy from a seed, and the JAX kernels' outputs on
    them (each JAX kernel compiles once per size)."""
    in_h, in_w = SIZES[request.param]
    g = geometry_for(in_h, in_w, "tight")
    r0, r1 = aligned_row_window(g.y0, g.y0 + in_h, g.pad_h)
    hc = r1 - r0
    wk = hermitian_kept_width(g.pad_w)
    jc, _ = _cfgs()
    rows = jrows(jgeom(in_h, in_w, "tight"), jc)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(7)
    t = 3
    d = dict(geom=g, r0=r0, hc=hc, wk=wk, rows=rows, t=t)
    d["slab"] = rng.random((2, hc, g.pad_w)).astype(np.float32)
    for keep in (True, False):
        d[f"k1_{keep}"] = jrowfft(jnp.asarray(d["slab"]), pad_h=g.pad_h,
                                  row0=r0, keep_half=keep, interpret=True)
    d["rows_re"] = rng.standard_normal((t, hc, wk)).astype(np.float32)
    d["rows_im"] = rng.standard_normal((t, hc, wk)).astype(np.float32)
    d["prev_re"] = rng.standard_normal((1, g.pad_h, wk)).astype(np.float32)
    d["prev_im"] = rng.standard_normal((1, g.pad_h, wk)).astype(np.float32)
    # Kernel 2 against the JAX kernel's full-f32 matmuls: on random
    # spectra the x10 phase rotation turns the default 3-pass bf16 error
    # (~6e-6 of the max) into ~3e-4 at bins just above the magnitude gate,
    # while the port computes in f32 throughout.  The config field keys
    # the JAX kernel's trace; the process default is restored after.
    set_gm_precision("highest")
    try:
        d["k2"] = jcolspec(
            jnp.asarray(d["rows_re"]), jnp.asarray(d["rows_im"]),
            jnp.asarray(d["prev_re"]), jnp.asarray(d["prev_im"]),
            jc.replace(gm_precision="highest"), pad_h=g.pad_h, row0=r0,
            out_rows=rows, full_w=g.pad_w, interpret=True)
    finally:
        set_gm_precision("")
    # Column-IFFT rows at the scale the pipeline gives them: |z| / (H W)
    # of order 0.3.
    scale = 0.3 * g.pad_h * g.pad_w / np.sqrt(g.pad_w)
    d["rre"] = (scale * rng.standard_normal((t, hr, wk))).astype(np.float32)
    d["rim"] = (scale * rng.standard_normal((t, hr, wk))).astype(np.float32)
    d["i"] = rng.uniform(-0.6, 0.6, (t, in_h, in_w)).astype(np.float32)
    d["q"] = rng.uniform(-0.5, 0.5, (t, in_h, in_w)).astype(np.float32)
    d["k3"] = jpost(
        jnp.asarray(d["rre"]), jnp.asarray(d["rim"]), jnp.asarray(d["i"]),
        jnp.asarray(d["q"]), jhann(jgeom(in_h, in_w, "tight")), jc,
        rows[0], in_h, in_w, "tight", full_w=g.pad_w, out_layout="tuple3",
        interpret=True)
    return d


@pytest.mark.parametrize("keep_half", [True, False])
def test_windowed_row_fft_ref_vs_jax(case, keep_half):
    g = case["geom"]
    got = tfused.windowed_row_fft_ref(_t(case["slab"]), pad_h=g.pad_h,
                                      row0=case["r0"], keep_half=keep_half)
    want = case[f"k1_{keep_half}"]
    wk = case["wk"] if keep_half else g.pad_w
    assert got[0].shape == (2, case["hc"], wk)
    spec = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), spec) < 1e-4
    # On CPU tensors the public wrapper is the plain version.
    pub = tfused.windowed_row_fft(_t(case["slab"]), pad_h=g.pad_h,
                                  row0=case["r0"], keep_half=keep_half)
    assert torch.equal(pub[0], got[0]) and torch.equal(pub[1], got[1])


def test_colspec_chunk_ref_vs_jax(case):
    g = case["geom"]
    _, tc = _cfgs()
    args = (_t(case["rows_re"]), _t(case["rows_im"]), _t(case["prev_re"]),
            _t(case["prev_im"]), tc)
    kw = dict(pad_h=g.pad_h, row0=case["r0"], out_rows=case["rows"],
              full_w=g.pad_w)
    got = tfused.colspec_chunk_ref(*args, **kw)
    want = [np.asarray(x) for x in case["k2"]]
    r0, r1 = case["rows"]
    assert got[0].shape == (case["t"], r1 - r0, case["wk"])
    assert got[2].shape == (1, g.pad_h, case["wk"])
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                want[0] + 1j * want[1]) < 1e-4
    assert _rel(got[2].numpy() + 1j * got[3].numpy(),
                want[2] + 1j * want[3]) < 1e-4
    pub = tfused.colspec_chunk(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(pub, got))


def test_rowifft_post_fused_ref_vs_jax(case):
    g = case["geom"]
    _, tc = _cfgs()
    in_h, in_w = g.in_h, g.in_w
    args = (_t(case["rre"]), _t(case["rim"]), _t(case["i"]), _t(case["q"]),
            hann2d_region(g), tc, case["rows"][0], in_h, in_w, "tight")
    got = rowifft_post_fused_ref(*args, full_w=g.pad_w)
    for gp, wp in zip(got, case["k3"]):
        wp = np.asarray(wp)
        assert gp.shape == wp.shape == (case["t"], in_h, in_w)
        assert 0.01 < float(gp.mean()) < 0.99  # not all clipped
        assert np.max(np.abs(gp.numpy() - wp)) < 1e-4
    pub = rowifft_post_fused(*args, full_w=g.pad_w)
    assert all(torch.equal(a, b) for a, b in zip(pub, got))


def test_zero_spectra_give_no_nan():
    """The 1e-38 guard of the unit rotation is subnormal in f32: exact
    zero cur and prev spectra (the bootstrap) must give zeros, not NaN."""
    _, tc = _cfgs()
    z = torch.zeros((2, 384, 384))
    zp = torch.zeros((1, 384, 384))
    out = tfused.colspec_chunk_ref(z, z, zp, zp, tc, pad_h=384, row0=0,
                                   full_w=512)
    for x in out:
        assert torch.isfinite(x).all() and not x.any()


def test_radix2_and_fourstep_guards():
    _, tc = _cfgs()
    for bad in (0, 1, 384, 1152):
        with pytest.raises(ValueError):
            radix2.check_pow2(bad)
    with pytest.raises(ValueError):
        radix2.bit_reverse_permutation(384)
    with pytest.raises(ValueError):
        radix2._dif_twiddles(1152, False)
    with pytest.raises(ValueError):
        tfused.windowed_row_fft_ref(torch.zeros((1, 8, 384)))
    for bad in (300, 100):
        with pytest.raises(ValueError):
            tfused.col_freq_axis(bad)
        with pytest.raises(ValueError):
            tfused._fourstep_twiddle(bad, False)
    z = torch.zeros((1, 64, 384))
    with pytest.raises(ValueError):
        tfused.colspec_chunk_ref(z, z, torch.zeros((1, 300, 384)),
                                 torch.zeros((1, 300, 384)), tc, pad_h=300,
                                 row0=0)
    # A pow-2 column height takes the radix-2 layout, as in the JAX
    # package (bit-reversed rows; tests/test_torch_branches.py holds it
    # against the JAX kernel).
    z = torch.zeros((1, 64, 512))
    out = tfused.colspec_chunk_ref(z, z, torch.zeros((1, 512, 512)),
                                   torch.zeros((1, 512, 512)), tc, pad_h=512,
                                   row0=0)
    assert out[0].shape == (1, 512, 512) and out[2].shape == (1, 512, 512)
    assert all(torch.isfinite(x).all() and not x.any() for x in out)


def test_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, never run
    on another device."""
    x = torch.zeros((1, 8, 128), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tfused.windowed_row_fft(x)
