"""The batched chunk engine's front end on the CPU: `pipeline.preprocess_cl`
(the front end, `spectral/fused.py::windowed_row_fft_frames`, or kernel 4
for planar uint8 y_only frames; on the CPU their plain versions) against
the JAX package's `preprocess_cl(..., through_col=False)` with its Pallas
kernels in interpret mode, in every input form that function takes:
interleaved and planar, f32 and uint8, y_only (with and without the I/Q
planes) and rgb, on 256-lane rows at tight and square_pow2 padding.  Then
the plain version's own contract: the torch pre stage (`frames_slab`) +
kernel 1's plain version bit for bit, the rgb stack plane-minor
frame-major, the public wrapper equal to it on CPU tensors, and its
refusals.

Tolerances: spectra to max error / max magnitude < 1e-4 (the Pallas
kernel's products are not torch.fft's), the I/Q planes to max abs < 1e-6
(the same f32 products and sums, which XLA may fuse)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine.pipeline import preprocess_cl as jpre
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.core.color import RGB_TO_YIQ
from pbmm_tpu_torch.core.window import geometry_for
from pbmm_tpu_torch.engine.pipeline import hermitian_active, preprocess_cl
from pbmm_tpu_torch.spectral import fused

FORMS = ("f32 interleaved", "u8 interleaved", "f32 planar", "u8 planar")
SIZES = {"96x200 tight": (96, 200, "tight"),
         "96x200 square_pow2": (96, 200, "square_pow2")}
ROWS3 = tuple(tuple(float(c) for c in r) for r in RGB_TO_YIQ)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(form, h, w, t=2, seed=3):
    """Seeded frames in one input form (numpy)."""
    dtype, layout = form.split()
    u8 = np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), np.uint8)
    a = u8 if dtype == "u8" else u8 * np.float32(1.0 / 255.0)
    if layout == "planar":
        a = np.moveaxis(a, -1, 1)
    return np.ascontiguousarray(a)


def _cfgs(mode, chroma):
    return (TCfg(phase_scale=10.0).tuned_for_tpu().replace(
                pad_mode=mode, chroma=chroma),
            JCfg(phase_scale=10.0).tuned_for_tpu().replace(
                pad_mode=mode, chroma=chroma, interpret_pallas=True))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("chroma,want_iq", [("y_only", True),
                                            ("y_only", False),
                                            ("rgb", True)],
                         ids=["y_only+iq", "y_only", "rgb"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_preprocess_cl_vs_jax(size, form, chroma, want_iq):
    h, w, mode = SIZES[size]
    tcfg, jcfg = _cfgs(mode, chroma)
    frames = _frames(form, h, w)
    got = preprocess_cl(torch.from_numpy(frames), tcfg, want_iq=want_iq)
    want = jpre(jnp.asarray(frames), jcfg, through_col=False,
                want_iq=want_iq)
    planes = 3 if chroma == "rgb" else 1
    assert got[0].shape == np.asarray(want[0]).shape
    assert got[0].shape[0] == planes * frames.shape[0]
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                np.asarray(want[0]) + 1j * np.asarray(want[1])) < 1e-4
    for g, j in zip(got[2:], want[2:]):
        if chroma == "rgb" or not want_iq:
            assert g is None
            continue
        assert g.shape == (frames.shape[0], h, w)
        assert np.max(np.abs(g.numpy() - np.asarray(j))) < 1e-6


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
def test_front_end_is_pre_stage_and_kernel1(form, planes):
    """The plain version is the torch pre stage + kernel 1's plain version,
    bit for bit; the public wrapper takes it on CPU tensors; kernel 4's
    plain version is the one-row case on planar uint8 frames."""
    h, w, mode = SIZES["96x200 tight"]
    g = geometry_for(h, w, mode)
    frames = torch.from_numpy(_frames(form, h, w))
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + h, g.pad_h)
    rows = ROWS3[:planes]
    args = (frames, rows, g.pad_h, g.pad_w, g.y0, g.x0, r0, True)
    got = fused.windowed_row_fft_frames(*args)
    _, hc, off = fused._frames_args(frames, g.pad_h, g.pad_w, g.y0, g.x0,
                                    r0)
    slab = fused.frames_slab(frames, rows, g.pad_w, g.x0, off, hc)
    assert slab.shape == (planes * 2, hc, g.pad_w)
    want = fused.windowed_row_fft_ref(slab, g.pad_h, r0, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if form == "u8 planar" and planes == 1:
        k4 = fused.windowed_row_fft_u8planar(frames, rows[0], *args[2:])
        assert torch.equal(k4[0], got[0]) and torch.equal(k4[1], got[1])


@pytest.mark.parametrize("form", FORMS)
def test_front_end_rgb_rows_are_plane_minor(form):
    """Three planes come out plane-minor frame-major (row 3 t + d is frame
    t's plane d), each equal to the one-plane front end on its colour row,
    the order kernel 2 reads (`preprocess_cl`'s rgb stack)."""
    h, w, mode = SIZES["96x200 square_pow2"]
    g = geometry_for(h, w, mode)
    frames = torch.from_numpy(_frames(form, h, w, t=3))
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + h, g.pad_h)
    geo = (g.pad_h, g.pad_w, g.y0, g.x0, r0, False)
    re3, im3 = fused.windowed_row_fft_frames(frames, ROWS3, *geo)
    for d in range(3):
        re1, im1 = fused.windowed_row_fft_frames(frames, ROWS3[d:d + 1], *geo)
        assert torch.equal(re3[d::3], re1) and torch.equal(im3[d::3], im1)


def test_front_end_refusals():
    g = geometry_for(96, 200, "tight")
    r0, _ = fused.aligned_row_window(g.y0, g.y0 + 96, g.pad_h)
    geo = (g.pad_h, g.pad_w, g.y0, g.x0, r0)
    ok = torch.zeros((1, 96, 200, 3), dtype=torch.float32)
    fused.windowed_row_fft_frames(ok, ROWS3[:1], *geo)
    with pytest.raises(ValueError):  # not uint8 or f32
        fused.windowed_row_fft_frames(ok.double(), ROWS3[:1], *geo)
    with pytest.raises(ValueError):  # no channel axis of 3
        fused.windowed_row_fft_frames(ok[..., :2], ROWS3[:1], *geo)
    with pytest.raises(ValueError):  # the frame leaves the padded width
        fused.windowed_row_fft_frames(ok, ROWS3[:1], g.pad_h, g.pad_w, g.y0,
                                      g.pad_w - 100, r0)
    with pytest.raises(ValueError):  # kernel 4 takes planar uint8 only
        fused.windowed_row_fft_u8planar(ok.to(torch.uint8), ROWS3[0], *geo)


def test_hermitian_layout_at_256_lanes():
    """The front end's rows carry the kept Hermitian tiles wherever the
    engine keeps them (`hermitian_active`)."""
    tcfg, _ = _cfgs("tight", "y_only")
    g = geometry_for(96, 200, "tight")
    re, _, _, _ = preprocess_cl(torch.from_numpy(_frames(FORMS[0], 96, 200)),
                                tcfg, want_iq=False)
    assert re.shape[-1] == (fused.hermitian_kept_width(g.pad_w)
                            if hermitian_active(tcfg, g) else g.pad_w)
