"""The plain versions of the kernels of the 8-bit video contract against
the JAX Pallas kernels in interpret mode:

- kernel 4 (`windowed_row_fft_u8planar`) at 300x384 (content rows offset
  inside the row window), 320x384 and a 1080-row column on W = 384;
- kernel 3 (`rowifft_post_fused`) in all six variants, {f32 I/Q, uint8
  chroma} x {tuple3, planar, planar_u8}, at 320x384, where the merged tail
  serves;
- kernel 7 (`row_ifft_magnitude`) at 300x384 and 320x384 region shapes.

On the CPU every public wrapper takes its plain version, so these hold
the port's CPU path and fix the layouts the CUDA kernels must reproduce
(checked on the card by tests/test_torch_cuda.py).
Tolerances: spectra to max error / max magnitude < 1e-4, images to max
abs < 1e-4, uint8 images to 1 code."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.core.window import hann2d_region as jhann
from pbmm_tpu.engine.post_pallas import rowifft_post_fused as jpost
from pbmm_tpu.spectral.fused import row_ifft_magnitude as jrowifft
from pbmm_tpu.spectral.fused import windowed_row_fft_u8planar as ju8fft
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.core.color import RGB_TO_YIQ
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine.pipeline import blur_row_window, preprocess_cl
from pbmm_tpu_torch.engine.post_fused import (
    rowifft_post_fused,
    rowifft_post_fused_ref,
)
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

LUMA = tuple(float(c) for c in RGB_TO_YIQ[0])
LAYOUTS = ("tuple3", "planar", "planar_u8")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg():
    return TCfg(phase_scale=10.0).tuned_for_tpu().replace(pad_mode="tight")


def _jcfg():
    return JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module", params=[(300, 384), (320, 384), (1080, 384)],
                ids=["300x384", "320x384", "1080x384"])
def k4(request):
    """Kernel 4's inputs and the JAX kernel's output on them."""
    in_h, in_w = request.param
    g = geometry_for(in_h, in_w, "tight")
    r0, _ = tfused.aligned_row_window(g.y0, g.y0 + in_h, g.pad_h)
    frames = _u8(np.random.default_rng(in_h), (2, 3, in_h, in_w))
    want = ju8fft(jnp.asarray(frames), LUMA, pad_h=g.pad_h, pad_w=g.pad_w,
                  y0=g.y0, x0=g.x0, row0=r0, keep_half=True, interpret=True)
    return dict(g=g, r0=r0, frames=frames,
                want=np.asarray(want[0]) + 1j * np.asarray(want[1]))


def test_u8_row_fft_ref_vs_jax(k4):
    g = k4["g"]
    got = tfused.windowed_row_fft_u8planar_ref(
        torch.from_numpy(k4["frames"]), LUMA, g.pad_h, g.pad_w, g.y0, g.x0,
        k4["r0"], keep_half=True)
    assert got[0].shape == k4["want"].shape
    assert got[0].shape[-1] == hermitian_kept_width(g.pad_w)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), k4["want"]) < 1e-4
    pub = tfused.windowed_row_fft_u8planar(
        torch.from_numpy(k4["frames"]), LUMA, g.pad_h, g.pad_w, g.y0, g.x0,
        k4["r0"], keep_half=True)
    assert torch.equal(pub[0], got[0]) and torch.equal(pub[1], got[1])


def test_u8_row_fft_equals_pre_stage_and_kernel1(k4):
    """Kernel 4's contract: bit for bit the torch pre stage (unit_float +
    luma FMA + centre pad) followed by kernel 1."""
    frames = torch.from_numpy(k4["frames"])
    g = k4["g"]
    re_k, im_k = tfused.windowed_row_fft_u8planar_ref(
        frames, LUMA, g.pad_h, g.pad_w, g.y0, g.x0, k4["r0"], keep_half=True)
    re_p, im_p, i_pl, q_pl = preprocess_cl(frames, _tcfg(), want_iq=True)
    assert i_pl.shape == (2, g.in_h, g.in_w)
    assert torch.equal(re_k, re_p) and torch.equal(im_k, im_p)
    # Without I/Q the pre stage routes planar uint8 frames to kernel 4.
    re_4, im_4, none_i, none_q = preprocess_cl(frames, _tcfg(), want_iq=False)
    assert none_i is None and none_q is None
    assert torch.equal(re_4, re_k) and torch.equal(im_4, im_k)


def test_u8_row_fft_rejects_bad_geometry():
    frames = torch.zeros((1, 3, 300, 384), dtype=torch.uint8)
    with pytest.raises(ValueError):  # not uint8
        tfused.windowed_row_fft_u8planar_ref(frames.float(), LUMA, 384, 512,
                                             42, 64, 0)
    with pytest.raises(ValueError):  # offset past the 64-row block
        tfused.windowed_row_fft_u8planar_ref(frames, LUMA, 512, 512, 106, 64,
                                             0)


@pytest.fixture(scope="module")
def k3():
    """Kernel 3's inputs at 320x384 and the JAX kernel's six variants."""
    in_h, in_w = 320, 384
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _tcfg())
    hr, wk = rows[1] - rows[0], hermitian_kept_width(g.pad_w)
    rng = np.random.default_rng(11)
    t = 2
    scale = 0.3 * g.pad_h * g.pad_w / np.sqrt(g.pad_w)
    d = dict(g=g, rows=rows, t=t)
    d["rre"] = (scale * rng.standard_normal((t, hr, wk))).astype(np.float32)
    d["rim"] = (scale * rng.standard_normal((t, hr, wk))).astype(np.float32)
    d["i"] = rng.uniform(-0.6, 0.6, (t, in_h, in_w)).astype(np.float32)
    d["q"] = rng.uniform(-0.5, 0.5, (t, in_h, in_w)).astype(np.float32)
    d["u8"] = _u8(rng, (t, 3, in_h, in_w))
    win = jhann(jgeom(in_h, in_w, "tight"))
    for src in ("f32", "u8"):
        chroma = ((jnp.asarray(d["i"]), jnp.asarray(d["q"]), None)
                  if src == "f32" else (None, None, jnp.asarray(d["u8"])))
        for lay in LAYOUTS:
            res = jpost(jnp.asarray(d["rre"]), jnp.asarray(d["rim"]),
                        chroma[0], chroma[1], win, _jcfg(), rows[0], in_h,
                        in_w, "tight", full_w=g.pad_w, rgb_u8=chroma[2],
                        out_layout=lay, interpret=True)
            d[src, lay] = (tuple(np.asarray(x) for x in res)
                           if lay == "tuple3" else np.asarray(res))
    return d


@pytest.mark.parametrize("src", ["f32", "u8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_post_variants_ref_vs_jax(k3, src, layout):
    g, t = k3["g"], k3["t"]
    chroma = ((torch.from_numpy(k3["i"]), torch.from_numpy(k3["q"]), None)
              if src == "f32" else (None, None, torch.from_numpy(k3["u8"])))
    args = (torch.from_numpy(k3["rre"]), torch.from_numpy(k3["rim"]),
            chroma[0], chroma[1], hann2d_region(g), _tcfg(), k3["rows"][0],
            g.in_h, g.in_w, "tight")
    kw = dict(full_w=g.pad_w, src=chroma[2], out_layout=layout)
    got = rowifft_post_fused_ref(*args, **kw)
    want = k3[src, layout]
    if layout == "tuple3":
        for gp, wp in zip(got, want):
            assert gp.shape == wp.shape == (t, g.in_h, g.in_w)
            assert 0.01 < float(gp.mean()) < 0.99  # not all clipped
            assert np.max(np.abs(gp.numpy() - wp)) < 1e-4
    else:
        assert tuple(got.shape) == want.shape == (t, 3, g.in_h, g.in_w)
        if layout == "planar_u8":
            assert got.dtype == torch.uint8 and want.dtype == np.uint8
            diff = np.abs(got.numpy().astype(int) - want.astype(int))
            assert diff.max() <= 1
        else:
            assert got.dtype == torch.float32
            assert np.max(np.abs(got.numpy() - want)) < 1e-4
    pub = rowifft_post_fused(*args, **kw)
    pub = pub if layout == "tuple3" else (pub,)
    got = got if layout == "tuple3" else (got,)
    assert all(torch.equal(a, b) for a, b in zip(pub, got))


def test_post_layouts_agree(k3):
    """planar is the stacked tuple3, planar_u8 is round(255 planar)."""
    g = k3["g"]
    base = (torch.from_numpy(k3["rre"]), torch.from_numpy(k3["rim"]), None,
            None, hann2d_region(g), _tcfg(), k3["rows"][0], g.in_h, g.in_w,
            "tight")
    kw = dict(full_w=g.pad_w, src=torch.from_numpy(k3["u8"]))
    r, gr, b = rowifft_post_fused_ref(*base, out_layout="tuple3", **kw)
    planar = rowifft_post_fused_ref(*base, out_layout="planar", **kw)
    u8 = rowifft_post_fused_ref(*base, out_layout="planar_u8", **kw)
    assert torch.equal(planar, torch.stack([r, gr, b], dim=1))
    assert torch.equal(u8, torch.round(planar * 255.0).to(torch.uint8))
    with pytest.raises(ValueError):  # both chroma sources at once
        rowifft_post_fused_ref(*base[:2], torch.from_numpy(k3["i"]),
                               torch.from_numpy(k3["q"]), *base[4:], **kw)


@pytest.fixture(scope="module", params=[(300, 384), (320, 384)],
                ids=["300x384", "320x384"])
def k7(request):
    """Kernel 7's inputs at the region shape of a frame size, and the JAX
    kernel's output on them."""
    in_h, in_w = request.param
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _tcfg())
    hr, wk = rows[1] - rows[0], hermitian_kept_width(g.pad_w)
    rng = np.random.default_rng(in_h + 1)
    scale = 0.3 * g.pad_h * g.pad_w / np.sqrt(g.pad_w)
    re = (scale * rng.standard_normal((2, hr, wk))).astype(np.float32)
    im = (scale * rng.standard_normal((2, hr, wk))).astype(np.float32)
    want, want_real = (np.asarray(jrowifft(
        jnp.asarray(re), jnp.asarray(im), magnitude=mag, pad_h=g.pad_h,
        full_w=g.pad_w, interpret=True)) for mag in (True, False))
    return dict(g=g, re=re, im=im, want=want, want_real=want_real)


def test_row_ifft_magnitude_ref_vs_jax(k7):
    g = k7["g"]
    args = (torch.from_numpy(k7["re"]), torch.from_numpy(k7["im"]))
    got = tfused.row_ifft_magnitude_ref(*args, pad_h=g.pad_h,
                                        full_w=g.pad_w)
    assert got.shape == k7["want"].shape == k7["re"].shape[:2] + (g.pad_w,)
    assert _rel(got.numpy(), k7["want"]) < 1e-4
    pub = tfused.row_ifft_magnitude(*args, pad_h=g.pad_h, full_w=g.pad_w)
    assert torch.equal(pub, got)
    # Re z (reconstruct="real") against the JAX kernel's magnitude=False.
    real = tfused.row_ifft_magnitude(*args, magnitude=False, pad_h=g.pad_h,
                                     full_w=g.pad_w)
    assert _rel(real.numpy(), k7["want_real"]) < 1e-4
    assert float(real.min()) < 0  # signed, not |z|
