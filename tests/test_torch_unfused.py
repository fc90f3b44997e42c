"""The unfused backends' kernels and the per-frame modules on the CPU,
against the JAX package on the same inputs (made with numpy from a seed):

- kernel 8 (`spectral/radix2.py::_fft_axis_ref`) against JAX `_fft_axis`
  in interpret mode, n in {8, 128, 512} on both axes, forward real,
  forward complex and inverse with a scale; `fft2_bitrev` / `ifft2_bitrev`;
- kernel 9 (`phase/fused_kernels.py`) against JAX
  `pyramid_phase_amplify_pallas_procedural` in interpret mode, in the
  "centered" and "bitrev2d" layouts, at an integer scale, 2.5 and with
  steerable sectors;
- `spectral/fft.py`, `pyramid/filters.py`, `phase/amplify.py`,
  `phase/standard.py`, `phase/temporal.py`, `core/complexop.py` and the
  scan engine's additions to `core/window.py` and `core/color.py`;
- the entry points' default device and the CLI's engine report.

Tolerances: spectra to max error / max magnitude < 1e-4 (kernels) or
< 1e-5 (plain torch against plain XLA), images and tables to max abs
< 1e-6.  The JAX radix-2 kernels run with full-f32 matmuls
(gm_precision "highest")."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.core import color as jcolor
from pbmm_tpu.core import complexop as jcomplex
from pbmm_tpu.core import window as jwin
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.phase import amplify as jamp
from pbmm_tpu.phase import standard as jstd
from pbmm_tpu.phase import temporal as jtemp
from pbmm_tpu.phase.pallas_kernels import (
    pyramid_phase_amplify_pallas_procedural as jk9,
)
from pbmm_tpu.pyramid import filters as jfilt
from pbmm_tpu.spectral import fft as jfft
from pbmm_tpu.spectral import pallas_fft as jpfft
from pbmm_tpu_torch import MagnifyConfig, TemporalConfig
from pbmm_tpu_torch.core import color as tcolor
from pbmm_tpu_torch.core import complexop as tcomplex
from pbmm_tpu_torch.core import window as twin
from pbmm_tpu_torch.phase import amplify as tamp
from pbmm_tpu_torch.phase import fused_kernels as tk9
from pbmm_tpu_torch.phase import standard as tstd
from pbmm_tpu_torch.phase import temporal as ttemp
from pbmm_tpu_torch.pyramid import filters as tfilt
from pbmm_tpu_torch.spectral import fft as tfft
from pbmm_tpu_torch.spectral import radix2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _np(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x


# ---------------------------------------------------------------------------
# Kernel 8: _fft_axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["forward_real", "forward_complex",
                                  "inverse_scaled"])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("n", [8, 128, 512])
def test_fft_axis_ref_vs_jax(n, axis, kind):
    rng = np.random.default_rng(41)
    shape = (2, n, 16) if axis == 1 else (2, 8, n)
    re, im = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    im = None if kind == "forward_real" else im
    inverse = kind == "inverse_scaled"
    scale = 1.0 / (shape[1] * shape[2]) if inverse else 1.0
    jpfft.set_gm_precision("highest")
    try:
        want = jpfft._fft_axis(jnp.asarray(re),
                               None if im is None else jnp.asarray(im),
                               axis, inverse, scale, True)
    finally:
        jpfft.set_gm_precision("")
    got = radix2._fft_axis(torch.from_numpy(re),
                           None if im is None else torch.from_numpy(im),
                           axis, inverse, scale)
    assert got[0].shape == shape and got[0].dtype == torch.float32
    assert _rel(_np(got[0]) + 1j * _np(got[1]),
                np.asarray(want[0]) + 1j * np.asarray(want[1])) < 1e-4


def test_fft2_bitrev_round_trip_and_guards():
    rng = np.random.default_rng(42)
    y = rng.random((2, 64, 128)).astype(np.float32)
    jpfft.set_gm_precision("highest")
    try:
        want = jpfft.fft2_bitrev(jnp.asarray(y), interpret=True)
        back = jpfft.ifft2_bitrev(*want, interpret=True)
    finally:
        jpfft.set_gm_precision("")
    got = radix2.fft2_bitrev(torch.from_numpy(y))
    assert _rel(_np(got[0]) + 1j * _np(got[1]),
                np.asarray(want[0]) + 1j * np.asarray(want[1])) < 1e-4
    rt = radix2.ifft2_bitrev(*got)
    assert np.max(np.abs(_np(rt[0]) - y)) < 1e-5
    assert np.max(np.abs(_np(rt[0]) - np.asarray(back[0]))) < 1e-5
    with pytest.raises(ValueError):  # pow-2 only
        radix2._fft_axis(torch.zeros((1, 96, 8)), None, 1, False)
    with pytest.raises(ValueError):  # a real input is forward only
        radix2._fft_axis(torch.zeros((1, 8, 8)), None, 2, True)


# ---------------------------------------------------------------------------
# Kernel 9: the use_pallas band/phase pass
# ---------------------------------------------------------------------------


def _bar_spectra(layout):
    """Two frames' windowed Y spectra of the oscillating bar (the motion
    the method targets; on random spectra bins at atan2's branch cut
    would rotate by opposite angles in two f32 evaluations) in `layout`,
    complex64."""
    frames = oscillating_bar(size=128, frames=4, bar_width=2)
    y = frames[..., 0] * 0.299 + frames[..., 1] * 0.587 \
        + frames[..., 2] * 0.114
    h = 0.5 * (1 - np.cos(2 * np.pi * (np.arange(128) + 0.5) / 128))
    spec = np.fft.fft2(y[1:3] * h[:, None] * h[None, :])
    if layout == "centered":
        spec = np.fft.fftshift(spec, axes=(-2, -1))
    else:
        rev = radix2.bit_reverse_permutation(128)
        spec = spec[:, rev][:, :, rev]
    return spec.astype(np.complex64)


@pytest.mark.parametrize("variant", ["integer", "scale_2_5", "steerable"])
@pytest.mark.parametrize("layout", ["centered", "bitrev2d"])
def test_amplify_procedural_vs_jax(layout, variant):
    change = {"integer": dict(), "scale_2_5": dict(phase_scale=2.5),
              "steerable": dict(orientations=4)}[variant]
    spec = _bar_spectra(layout)
    cur, prev = spec[1:2], spec[0:1]
    want = np.asarray(jk9(jnp.asarray(cur), jnp.asarray(prev),
                          JCfg(**change), layout, interpret=True))
    tcfg = MagnifyConfig(**change)
    got = tk9.pyramid_phase_amplify_pallas_procedural(
        torch.from_numpy(cur), torch.from_numpy(prev), tcfg, layout)
    assert got.shape == cur.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-4
    # The same pass as torch ops (the XLA-side procedural form).
    xla = tamp.pyramid_phase_amplify_procedural(
        torch.from_numpy(cur), torch.from_numpy(prev), tcfg, layout=layout)
    assert _rel(got.numpy(), xla.numpy()) < 1e-4


# ---------------------------------------------------------------------------
# The per-frame modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fft2_centered", "ifft2_centered",
                                  "rfft2_half", "irfft2_half"])
def test_fft_module_vs_jax(name):
    rng = np.random.default_rng(43)
    if name in ("fft2_centered", "rfft2_half"):
        x = rng.random((2, 32, 64)).astype(np.float32)
        args_j, args_t = (jnp.asarray(x),), (torch.from_numpy(x),)
    else:
        w = 64 if name == "ifft2_centered" else 33
        x = (rng.standard_normal((2, 32, w))
             + 1j * rng.standard_normal((2, 32, w))).astype(np.complex64)
        args_j, args_t = (jnp.asarray(x),), (torch.from_numpy(x),)
        if name == "irfft2_half":
            args_j, args_t = args_j + (64,), args_t + (64,)
    want = np.asarray(getattr(jfft, name)(*args_j))
    got = getattr(tfft, name)(*args_t).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("layout", ["centered", "rfft", "bitrev2d"])
def test_filters_vs_jax(layout):
    fy, fx = tfilt.freq_axes(64, 128, layout)
    jfy, jfx = jfilt.freq_axes_jnp(64, 128, layout)
    assert np.array_equal(fy.numpy(), np.asarray(jfy))
    assert np.array_equal(fx.numpy(), np.asarray(jfx))
    for cfg in (JCfg(), JCfg(orientations=4), JCfg(pyramid_levels=3)):
        got = list(tfilt.procedural_mask_planes(64, 128, cfg, layout))
        want = list(jfilt.procedural_mask_planes(64, 128, cfg, layout))
        assert len(got) == len(want)
        for (g, ga), (w, wa) in zip(got, want):
            assert ga == wa
            assert np.max(np.abs(g.numpy() - np.asarray(w))) < 1e-6
    for cfg in (JCfg(), JCfg(orientations=3)):
        assert np.array_equal(tfilt.filter_bank(32, 32, cfg).numpy(),
                              np.asarray(jfilt.filter_bank(32, 32, cfg)))
        assert np.array_equal(tfilt.amplified_level_flags(cfg),
                              jfilt.amplified_level_flags(cfg))


@pytest.fixture(scope="module")
def spectra():
    spec = _bar_spectra("centered")
    return spec[1], spec[0]


def test_phase_amplify_forms_vs_jax(spectra):
    cur, prev = spectra
    tc, jc = (torch.from_numpy(cur), torch.from_numpy(prev)), (
        jnp.asarray(cur), jnp.asarray(prev))
    cfg = JCfg(orientations=4)
    masks = jfilt.filter_bank(128, 128, cfg)
    flags = jfilt.amplified_level_flags(cfg)
    tmasks = tfilt.filter_bank(128, 128, cfg)
    for name, targs, jargs in (
            ("pyramid_phase_amplify", (tmasks, flags, 10.0, 0.01),
             (masks, flags, 10.0, 0.01)),
            ("pyramid_phase_amplify_naive", (tmasks, flags, 10.0, 0.01),
             (masks, flags, 10.0, 0.01))):
        got = getattr(tamp, name)(*tc, *targs).numpy()
        want = np.asarray(getattr(jamp, name)(*jc, *jargs))
        assert _rel(got, want) < 1e-5, name
    # The fused form equals the literal band loop.
    fused = tamp.pyramid_phase_amplify(*tc, tmasks, flags, 10.0, 0.01)
    naive = tamp.pyramid_phase_amplify_naive(*tc, tmasks, flags, 10.0, 0.01)
    assert _rel(fused.numpy(), naive.numpy()) < 1e-5
    for s in (10.0, 2.5):
        assert _rel(tamp.rotation_term(*tc, s).numpy(),
                    np.asarray(jamp.rotation_term(*jc, s))) < 1e-5
    assert np.max(np.abs(tamp.phase_delta(*tc).numpy()
                         - np.asarray(jamp.phase_delta(*jc)))) < 1e-5


@pytest.mark.parametrize("layout", ["centered", "rfft", "bitrev2d"])
def test_standard_mode_vs_jax(spectra, layout):
    cfg = JCfg(mode="standard", apply_magnitude_scale=True,
               magnitude_scale=0.7)
    w_t = tstd.bandpass_weight_map(128, 128, cfg, layout)
    w_j = jstd.bandpass_weight_map_jnp(128, 128, cfg, layout)
    assert np.max(np.abs(w_t.numpy() - np.asarray(w_j))) < 1e-6
    if layout != "centered":
        return
    cur, prev = spectra
    for apply in (False, True):
        got = tstd.standard_phase_amplify(
            torch.from_numpy(cur), torch.from_numpy(prev), w_t, 2.0, 0.01,
            0.7, apply).numpy()
        want = np.asarray(jstd.standard_phase_amplify(
            jnp.asarray(cur), jnp.asarray(prev), w_j, 2.0, 0.01, 0.7,
            apply))
        assert _rel(got, want) < 1e-5


def test_temporal_and_core_vs_jax():
    rng = np.random.default_rng(44)
    d = rng.uniform(-3, 3, (2, 16, 16)).astype(np.float32)
    lf, ls = (rng.standard_normal((2, 16, 16)).astype(np.float32)
              for _ in range(2))
    tcfg = TemporalConfig(mode="iir_bandpass")
    got = ttemp.temporal_apply(torch.from_numpy(d), ttemp.TemporalState(
        torch.from_numpy(lf), torch.from_numpy(ls)), tcfg)
    want = jtemp.temporal_apply(jnp.asarray(d), jtemp.TemporalState(
        jnp.asarray(lf), jnp.asarray(ls)), JTemporal(mode="iir_bandpass"))
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    x = rng.uniform(-7, 7, (64,)).astype(np.float32)
    assert np.max(np.abs(tcomplex.wrap_phase(torch.from_numpy(x)).numpy()
                         - np.asarray(jcomplex.wrap_phase(x)))) < 1e-6
    geom_t, geom_j = (twin.geometry_for(100, 120, "square_pow2"),
                      jwin.geometry_for(100, 120, "square_pow2"))
    img = rng.random((3, 100, 120)).astype(np.float32)
    pad = twin.pad_center(torch.from_numpy(img), geom_t)
    assert np.array_equal(pad.numpy(),
                          np.asarray(jwin.pad_center(img, geom_j)))
    assert np.array_equal(twin.crop_center(pad, geom_t).numpy(), img)
    assert np.max(np.abs(twin.hann2d(64, 128).numpy()
                         - np.asarray(jwin.hann2d(64, 128)))) < 1e-6
    rgb = rng.random((8, 8, 3)).astype(np.float32)
    assert np.array_equal(tcolor.rgb_to_yiq(torch.from_numpy(rgb)).numpy(),
                          np.asarray(jcolor.rgb_to_yiq(jnp.asarray(rgb))))


# ---------------------------------------------------------------------------
# The entry points' device, the CLI's engine report
# ---------------------------------------------------------------------------


def test_numpy_input_runs_on_the_card():
    """numpy input without a device runs on the first CUDA card: where
    there is none, every entry point raises (there is no fallback to the
    CPU); a torch tensor runs where it lies, and device="cpu" runs there."""
    from pbmm_tpu_torch import magnify_video
    from pbmm_tpu_torch.engine.pipeline import magnify_frame_pair
    from pbmm_tpu_torch.engine.state import state_from_numpy
    from pbmm_tpu_torch.engine.video import video_init

    frames = oscillating_bar(size=64, frames=2, bar_width=2)
    cfg = MagnifyConfig()
    out, st = magnify_video(torch.from_numpy(frames), cfg)
    assert out.device.type == "cpu"
    d = {k: v for k, v in zip(
        ("prev_spec_re", "prev_spec_im", "prev_frame", "lp_fast",
         "lp_slow"), (st.prev_spec_re.numpy(), st.prev_spec_im.numpy(),
                      st.prev_frame.numpy(), st.temporal.lp_fast.numpy(),
                      st.temporal.lp_slow.numpy()))}
    d["frame_idx"] = np.int32(2)
    calls = [lambda dev: magnify_video(frames, cfg, device=dev)[0],
             lambda dev: magnify_frame_pair(frames[0], frames[1], cfg,
                                            device=dev),
             lambda dev: video_init(frames[0], cfg, device=dev).prev_spec_re,
             lambda dev: state_from_numpy(d, device=dev).prev_spec_re]
    for call in calls:
        assert call("cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call(None).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call(None)


@pytest.mark.parametrize("flags,engine", [
    ([], "scan"),
    (["--fast", "--pad-mode", "tight"], "batched"),
    (["--fast", "--engine", "scan"], "scan"),
    (["--fft-backend", "pallas"], "scan"),
], ids=["default", "fast_tight", "fast_scan", "pallas_unfused"])
def test_cli_reports_the_engine(flags, engine, tmp_path, capsys):
    from pbmm_tpu_torch.cli import main

    inp, out = str(tmp_path / "in.npy"), str(tmp_path / "out.npy")
    np.save(inp, oscillating_bar(size=128, frames=3, bar_width=2))
    assert main(["--input", inp, "--output", out, "--stats"] + flags,
                device="cpu") == 0
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["engine"] == engine and stats["frames"] == 3
    assert np.load(out).shape == (3, 128, 128, 3)
