"""The batched engine's config matrix end to end on the CPU: the port's
`magnify_video` against the JAX package's and the fp64 oracle, one case
per served switch, on the 320x384 clip of tests/test_torch_video.py (4
frames).  Tight padding takes it to 384x512 and the pow-2 modes to
512x512; both keep the merged kernel-3 tail and Hermitian kept lanes.

Per case:
- port against JAX `magnify_video`: > 70 dB;
- the carried spectra: max error / max magnitude < 1e-4;  the IIR taps:
  the same, weighted by the magnitude of the bin each tap rotates (a tap
  error reaches the output scaled by |S|; at bins whose spectrum lies at
  the transforms' rounding floor, ~1e-7 of the maximum, the delta's phase
  is noise in both packages and the unweighted taps differ there);
- against the oracle, where it covers the case (not the window
  compensation or the YIQ gains): no worse than the JAX package's own
  PSNR on the clip, less 1 dB;
- two chunks (2 + the rest) equal one call bit for bit, state included.

The JAX package runs with full-f32 matmuls (gm_precision "highest")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.reference import (
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, TemporalConfig, magnify_video

_IIR = "iir"


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


# name ->(config changes on the tight main-path config, oracle covers it)
ROWS = {
    "square_pow2": (dict(pad_mode="square_pow2"), True),
    "rect_pow2": (dict(pad_mode="rect_pow2"), True),
    "rgb": (dict(chroma="rgb"), True),
    "iir": (dict(temporal=_IIR), True),
    "standard": (dict(mode="standard"), True),
    "orientations": (dict(orientations=4), True),
    "non_integer_scale": (dict(phase_scale=2.5), True),
    "overlapping_bands": (dict(pyramid_levels=6), True),
    "reconstruct_real": (dict(reconstruct="real"), True),
    "compensate_gains": (dict(compensate_window=True, apply_yiq_gains=True,
                              yiq_gains=(1.0, 1.2, 0.8)), False),
}


def _cfgs(change):
    change = dict(change)
    iir = change.pop("temporal", None) == _IIR
    change.setdefault("pad_mode", "tight")
    t = MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(**change)
    j = JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        interpret_pallas=True, gm_precision="highest", **change)
    if iir:
        t = t.replace(temporal=TemporalConfig(mode="iir_bandpass"))
        j = j.replace(temporal=JTemporal(mode="iir_bandpass"))
    return t, j


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _spec(state):
    return np.asarray(state.prev_spec_re) + 1j * np.asarray(
        state.prev_spec_im)


@pytest.fixture(scope="module")
def clip():
    return oscillating_bar(size=384, frames=4, bar_width=2)[:, :320]


@pytest.mark.parametrize("name", sorted(ROWS))
def test_config_row(clip, name):
    change, oracle_covers = ROWS[name]
    tcfg, jcfg = _cfgs(change)
    iir = tcfg.temporal.mode == "iir_bandpass"
    out, state = magnify_video(torch.from_numpy(clip), tcfg)
    out = out.numpy()
    jout, jstate = jmagnify(clip, jcfg)
    jout = np.asarray(jout)
    assert out.shape == clip.shape and np.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 1
    np.testing.assert_array_equal(out[0], clip[0])
    assert psnr(out, jout) > 70

    spec = _spec(state)
    assert spec.shape == _spec(jstate).shape
    assert spec.shape[0] == (3 if tcfg.chroma == "rgb" else 1)
    assert _rel(spec, _spec(jstate)) < 1e-4
    assert state.frame_idx == int(jstate.frame_idx) == len(clip)
    if iir:
        mag = np.abs(spec)
        for got, want in zip(state.temporal, jstate.temporal):
            assert got.shape == spec.shape
            want = np.asarray(want)
            assert (np.max(np.abs(got.numpy() - want) * mag)
                    / np.max(np.abs(want) * mag)) < 1e-4
    else:
        assert state.temporal.lp_fast.numel() == 0

    if oracle_covers:
        oracle = oracle_magnify_video_iir if iir else oracle_magnify_video
        want = oracle(clip, tcfg)
        assert psnr(out, want) >= psnr(jout, want) - 1.0

    o1, s1 = magnify_video(torch.from_numpy(clip[:2]), tcfg)
    o2, s2 = magnify_video(torch.from_numpy(clip[2:]), tcfg, s1)
    np.testing.assert_array_equal(np.concatenate([o1.numpy(), o2.numpy()]),
                                  out)
    for a, b in zip(s2[:2] + tuple(s2.temporal), state[:2]
                    + tuple(state.temporal)):
        assert torch.equal(a, b)
