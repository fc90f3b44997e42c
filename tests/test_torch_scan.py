"""The per-frame scan engine and the stateless frame pair on the CPU, and
kernels 6 and 10's plain versions against the JAX kernels.

End to end, per served config, on the 128x128 oscillating bar of
tests/test_pipeline.py (4 frames) and at 256x256 for the fused scan path
(kernels 1, 5, 6, 7):
- the port's `magnify_video` against the JAX package's: > 70 dB;
- against the fp64 oracle: no worse than the JAX package's own PSNR on
  the clip, less 1 dB (the rule of tests/test_torch_matrix.py);
- two chunks (2 + the rest) equal one call bit for bit, state included;
- the carried spectrum (or, without the cache, the previous frame)
  against JAX's: max error / max magnitude < 1e-4.
Also: states of the scan engine cross the packages both ways, the port's
batched and scan engines agree (> 80 dB, the bar of
tests/test_pipeline.py), and `magnify_frame_pair`.

Kernel rows: `phase_col_ifft_ref` against JAX `phase_col_ifft` in every
branch at 256 rows, `post_fused_ref` against JAX `post_fused` at the
sizes of tests/test_post_pallas.py, spectra to max error / max magnitude
< 1e-4 and images to max abs < 1e-4.  The JAX package runs its Pallas
kernels in interpret mode with full-f32 matmuls (gm_precision
"highest")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.core.window import hann2d_region as jhann
from pbmm_tpu.engine.pipeline import blur_row_window as jrows
from pbmm_tpu.engine.pipeline import magnify_frame_pair as jpair
from pbmm_tpu.engine.post_pallas import post_fused as jpost_fused
from pbmm_tpu.engine.video import VideoState as JState
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.reference import (
    oracle_magnify_pair,
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.phase.temporal import TemporalState as JTemporalState
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, TemporalConfig, magnify_video
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.engine.pipeline import magnify_frame_pair
from pbmm_tpu_torch.engine.state import state_from_numpy, state_to_numpy
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

_IIR = "iir"
_TUNED = "tuned"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_highest_traces():
    """The JAX traces this module makes at gm_precision "highest" stay in
    JAX's caches, and a later test of the same process that traces the
    same inner kernels at the default would reuse some of them; drop them
    when the module ends."""
    yield
    set_gm_precision("")
    jax.clear_caches()


def _cfgs(change):
    """The same config in both packages: `temporal=_IIR` for the IIR
    band-pass, `base=_TUNED` on `tuned_for_tpu()`."""
    change = dict(change)
    iir = change.pop("temporal", None) == _IIR
    tuned = change.pop("base", None) == _TUNED
    t, j = MagnifyConfig(), JCfg(interpret_pallas=True,
                                 gm_precision="highest")
    if tuned:
        t, j = t.tuned_for_tpu(), j.tuned_for_tpu()
    t, j = t.replace(**change), j.replace(**change)
    if iir:
        t = t.replace(temporal=TemporalConfig(mode="iir_bandpass"))
        j = j.replace(temporal=JTemporal(mode="iir_bandpass"))
    return t, j


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _clip(size, rows=None):
    c = oscillating_bar(size=size, frames=4, bar_width=2)
    return np.ascontiguousarray(c if rows is None else c[:, rows])


# name -> (config changes, clip size, clip rows or None)
ROWS = {
    "default": (dict(), 128, None),
    "standard": (dict(mode="standard"), 128, None),
    "steerable": (dict(orientations=4), 128, None),
    "rgb": (dict(chroma="rgb"), 128, None),
    "iir": (dict(temporal=_IIR), 128, None),
    "full_spectrum": (dict(use_rfft=False), 128, None),
    "rect_pow2": (dict(pad_mode="rect_pow2"), 128, slice(32, 96)),
    "xla_tight": (dict(pad_mode="tight"), 128, slice(0, 100)),
    "reconstruct_real": (dict(reconstruct="real"), 128, None),
    "apply_magnitude_scale": (dict(mode="standard",
                                   apply_magnitude_scale=True,
                                   magnitude_scale=0.8), 128, None),
    "no_cache": (dict(cache_prev_spectrum=False), 128, None),
    "no_cache_iir": (dict(cache_prev_spectrum=False, temporal=_IIR), 128,
                     None),
    "tuned_scan": (dict(base=_TUNED, engine="scan"), 256, None),
    "tuned_scan_128": (dict(base=_TUNED, engine="scan"), 128, None),
    "tuned_no_cache_iir": (dict(base=_TUNED, cache_prev_spectrum=False,
                                temporal=_IIR), 256, None),
    "tuned_untiled": (dict(base=_TUNED, pad_mode="rect_pow2"), 128,
                      slice(32, 96)),
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_scan_row(name):
    change, size, rows = ROWS[name]
    clip = _clip(size, rows)
    tcfg, jcfg = _cfgs(change)
    iir = tcfg.temporal.mode == "iir_bandpass"
    out, state = magnify_video(torch.from_numpy(clip), tcfg)
    out = out.numpy()
    jout, jstate = jmagnify(clip, jcfg)
    jout = np.asarray(jout)
    assert out.shape == clip.shape and np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], clip[0])
    assert psnr(out, jout) > 70

    oracle = oracle_magnify_video_iir if iir else oracle_magnify_video
    want = oracle(clip, tcfg)
    assert psnr(out, want) >= psnr(jout, want) - 1.0

    if tcfg.cache_prev_spectrum:
        spec = state.prev_spec_re.numpy() + 1j * state.prev_spec_im.numpy()
        jspec = (np.asarray(jstate.prev_spec_re)
                 + 1j * np.asarray(jstate.prev_spec_im))
        assert spec.shape == jspec.shape
        assert _rel(spec, jspec) < 1e-4
    else:
        assert state.prev_spec_re.numel() == 0
        np.testing.assert_array_equal(state.prev_frame.numpy(),
                                      np.asarray(jstate.prev_frame))
    assert state.frame_idx == int(jstate.frame_idx) == len(clip)

    o1, s1 = magnify_video(torch.from_numpy(clip[:2]), tcfg)
    o2, s2 = magnify_video(torch.from_numpy(clip[2:]), tcfg, s1)
    np.testing.assert_array_equal(np.concatenate([o1.numpy(), o2.numpy()]),
                                  out)
    for a, b in zip(s2[:3] + tuple(s2.temporal),
                    state[:3] + tuple(state.temporal)):
        assert torch.equal(a, b)


def _jax_state(d):
    return JState(jnp.asarray(d["prev_spec_re"]),
                  jnp.asarray(d["prev_spec_im"]),
                  jnp.asarray(d["prev_frame"]),
                  JTemporalState(jnp.asarray(d["lp_fast"]),
                                 jnp.asarray(d["lp_slow"])),
                  jnp.int32(d["frame_idx"]))


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
@pytest.mark.parametrize("name", ["default", "no_cache", "iir",
                                  "tuned_scan_128"])
def test_scan_state_crosses_packages(name, direction):
    """A stream of the scan engine started by one package resumes in the
    other: both ways, with cached spectra, without (the previous frame
    carried) and with the IIR taps."""
    change, _, _ = ROWS[name]
    tcfg, jcfg = _cfgs(change)
    clip = _clip(128)
    jwhole, _ = jmagnify(clip, jcfg)
    if direction == "from_jax":
        _, js = jmagnify(clip[:2], jcfg)
        st = state_from_numpy(js, device="cpu")
        out, _ = magnify_video(torch.from_numpy(clip[2:]), tcfg, st)
        out = out.numpy()
    else:
        _, st = magnify_video(torch.from_numpy(clip[:2]), tcfg)
        d = state_to_numpy(st)
        assert int(d["frame_idx"]) == 2
        out, js2 = jmagnify(clip[2:], jcfg, _jax_state(d))
        out = np.asarray(out)
        assert int(js2.frame_idx) == 4
    assert psnr(out, np.asarray(jwhole)[2:]) > 70


def test_batched_and_scan_engines_agree():
    clip = _clip(128)
    tcfg, _ = _cfgs(dict(base=_TUNED))
    out_b, _ = magnify_video(torch.from_numpy(clip), tcfg)
    out_s, _ = magnify_video(torch.from_numpy(clip),
                             tcfg.replace(engine="scan"))
    assert psnr(out_b.numpy(), out_s.numpy()) > 80


@pytest.mark.parametrize("name", ["default", "tuned", "standard_iir",
                                  "bypass"])
def test_frame_pair(name):
    change = {"default": dict(), "tuned": dict(base=_TUNED),
              "standard_iir": dict(mode="standard", temporal=_IIR),
              "bypass": dict(apply_motion_magnification=False)}[name]
    tcfg, jcfg = _cfgs(change)
    frames = oscillating_bar(size=128, frames=6)
    got = magnify_frame_pair(frames[2], frames[3], tcfg, device="cpu")
    want = np.asarray(jpair(frames[2], frames[3], jcfg))
    assert got.shape == (128, 128, 3) and got.dtype == torch.float32
    if name == "bypass":
        np.testing.assert_array_equal(got.numpy(), frames[3])
        return
    assert psnr(got.numpy(), want) > 70
    if tcfg.temporal.mode == "two_frame":
        ref = oracle_magnify_pair(frames[2], frames[3], tcfg)
        assert psnr(got.numpy(), ref) >= psnr(want, ref) - 1.0


def test_frame_pair_equals_scan_step():
    """The pair re-runs the pre stage on the previous frame; the scan
    engine caches that spectrum: the same kernels give the same bits."""
    tcfg, _ = _cfgs(dict(base=_TUNED, engine="scan"))
    clip = _clip(128)
    out, _ = magnify_video(torch.from_numpy(clip), tcfg)
    got = magnify_frame_pair(torch.from_numpy(clip[1]),
                             torch.from_numpy(clip[2]), tcfg)
    assert torch.equal(got, out[2])


# ---------------------------------------------------------------------------
# Kernel 6: phase_col_ifft
# ---------------------------------------------------------------------------

# name -> (config changes, kept lanes)
_K6 = {
    "main": (dict(), True),
    "full_lanes": (dict(), False),
    "iir": (dict(temporal=_IIR), True),
    "standard": (dict(mode="standard"), True),
    "steerable": (dict(orientations=4), True),
    "overlapping": (dict(pyramid_levels=6), True),
    "non_integer": (dict(phase_scale=2.5), True),
    "standard_iir": (dict(mode="standard", temporal=_IIR), False),
}


def _spectra(rng, shape):
    """Normal spectra with a band of exact zeros and one of signed zeros
    (the zero-prev bootstrap and its atan2 sign trap)."""
    a = rng.standard_normal(shape).astype(np.float32)
    a[..., :8, :] = 0.0
    a[..., 8:16, :] = -0.0
    return a


@pytest.mark.parametrize("branch", sorted(_K6))
def test_phase_col_ifft_ref_vs_jax(branch):
    change, kept = _K6[branch]
    tcfg, jcfg = _cfgs(dict(base=_TUNED, **change))
    h, fw = 256, 512
    w = hermitian_kept_width(fw) if kept else fw
    rng = np.random.default_rng(31)
    spec = [_spectra(rng, (2, h, w)) for _ in range(4)]
    iir = tcfg.temporal.mode == "iir_bandpass"
    taps = ([0.3 * rng.standard_normal((2, h, w)).astype(np.float32)
             for _ in range(2)] if iir else [])
    kw = dict(out_rows=(64, 192), full_w=fw)
    set_gm_precision("highest")
    try:
        want = jfused.phase_col_ifft(
            *map(jnp.asarray, spec), jcfg, interpret=True,
            **kw, **dict(zip(("lp_fast", "lp_slow"),
                             map(jnp.asarray, taps))))
    finally:
        set_gm_precision("")
    want = [np.asarray(x) for x in want]
    got = tfused.phase_col_ifft(*map(_t, spec), tcfg, **kw,
                                **dict(zip(("lp_fast", "lp_slow"),
                                           map(_t, taps))))
    assert len(got) == len(want) == (4 if iir else 2)
    assert got[0].shape == want[0].shape == (2, 128, w)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                want[0] + 1j * want[1]) < 1e-4
    for g, wnt in zip(got[2:], want[2:]):
        assert g.shape == (2, h, w)
        assert _rel(g.numpy(), wnt) < 1e-4


def test_phase_col_ifft_equals_colspec_inverse_half():
    """Kernel 6's plain version on the spectra kernel 5's gives equals
    kernel 2's plain version frame by frame, bit for bit (the CUDA
    kernels share the same two halves; tests/test_torch_cuda.py checks
    them on the card)."""
    tcfg, _ = _cfgs(dict(base=_TUNED))
    rng = np.random.default_rng(32)
    wk = hermitian_kept_width(512)
    rows = [_t(rng.standard_normal((3, 192, wk))) for _ in range(2)]
    prev = [_t(rng.standard_normal((1, 512, wk))) for _ in range(2)]
    out_rows = (64, 448)
    k2 = tfused.colspec_chunk(*rows, *prev, tcfg, 512, 64,
                              out_rows=out_rows, full_w=512)
    cur = tfused.col_fft_zero_padded(*rows, 512, 64)
    prv = [torch.cat([p, c[:-1]]) for p, c in zip(prev, cur)]
    k6 = tfused.phase_col_ifft(*cur, *prv, tcfg, out_rows=out_rows,
                               full_w=512)
    assert torch.equal(k6[0], k2[0]) and torch.equal(k6[1], k2[1])


def test_phase_col_ifft_guards():
    tcfg, _ = _cfgs(dict(base=_TUNED))
    z = torch.zeros((1, 384, 256))
    with pytest.raises(ValueError):  # radix-2 only: a tight height
        tfused.phase_col_ifft(z, z, z, z, tcfg)
    z = torch.zeros((1, 256, 256))
    with pytest.raises(ValueError, match="fx_values"):  # one value a lane
        tfused.phase_col_ifft(z, z, z, z, tcfg, fx_values=torch.zeros(128))
    iir = tcfg.replace(temporal=TemporalConfig(mode="iir_bandpass"))
    with pytest.raises(ValueError, match="lp_fast"):
        tfused.phase_col_ifft(z, z, z, z, iir)
    out = tfused.phase_col_ifft(z, z, z, z, tcfg)  # zero spectra: no NaN
    assert all(torch.isfinite(x).all() and not x.any() for x in out)


def test_phase_col_ifft_fx_values_full_table():
    """fx_values holding the layout's own lane table (the sharded engines'
    branch: masks evaluated per bin, no host planes) gives the host-plane
    call's result, pyramid and standard, to 1e-5 of the maximum."""
    rng = np.random.default_rng(11)
    spec = [_t(rng.standard_normal((2, 256, 256))) for _ in range(4)]
    fx = torch.from_numpy(tfused.lane_freq_axis(256))
    for extra in ({}, {"mode": "standard", "phase_scale": 2.5}):
        tcfg, _ = _cfgs(dict(base=_TUNED, **extra))
        want = tfused.phase_col_ifft(*spec, tcfg)
        got = tfused.phase_col_ifft(*spec, tcfg, fx_values=fx)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ---------------------------------------------------------------------------
# Kernel 10: post_fused (the y_only post tail on reconstructed rows)
# ---------------------------------------------------------------------------

_K10 = {
    "plain": (dict(), 2, 0),
    "compensate": (dict(compensate_window=True), 1, 1),
    "gains": (dict(apply_yiq_gains=True, yiq_gains=(0.9, 1.2, 0.8)), 1, 2),
}


@pytest.mark.parametrize("case", sorted(_K10))
def test_post_fused_ref_vs_jax(case):
    change, t, seed = _K10[case]
    tcfg, jcfg = _cfgs(dict(base=_TUNED, **change))
    h, w = 1080, 1920
    g = geometry_for(h, w, tcfg.pad_mode)
    rows = jrows(jgeom(h, w, jcfg.pad_mode), jcfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(seed)
    rec = rng.random((t, hr, g.pad_w)).astype(np.float32)
    ip = rng.random((t, h, w)).astype(np.float32)
    qp = rng.random((t, h, w)).astype(np.float32)
    want = jpost_fused(jnp.asarray(rec), jnp.asarray(ip), jnp.asarray(qp),
                       jhann(jgeom(h, w, jcfg.pad_mode)), jcfg, rows[0], h,
                       w, jcfg.pad_mode, interpret=True)
    got = post_fused.post_fused(_t(rec), _t(ip), _t(qp), hann2d_region(g),
                                tcfg, rows[0], h, w, tcfg.pad_mode)
    for a, b in zip(got, want):
        assert a.shape == (t, h, w)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < 1e-4
    planar = post_fused.post_fused(_t(rec), _t(ip), _t(qp),
                                   hann2d_region(g), tcfg, rows[0], h, w,
                                   tcfg.pad_mode, out_layout="planar")
    assert torch.equal(planar, torch.stack(got, dim=1))
