"""The port's utilities and the CLI's diagnostic modes on the CPU, against
the JAX package's: metrics (to 1e-12), every debug view (to 1e-5; the
phase views only where |spectrum| > 1e-3 of its max, since the angle of a
near-zero bin is rounding noise), `debug_frame_view` at 16 x 16 and at a
frame that is not a power of two, `assert_finite` and `debug_mode` (a NaN
out of a kernel wrapper's plain version raises), `stage_times`' keys,
`trace`, `run_parity` (> 55 dB, as tests/test_aux.py), and the CLI's
`--demo bar` (> 70 dB against the JAX CLI's), `--trace` and `--debug-view
split` through `main(argv, device="cpu")`."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.utils import debug as jdebug
from pbmm_tpu.utils import metrics as jmetrics
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.utils import checks, debug, metrics, profiling

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    return a, np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1)


@pytest.mark.parametrize("fn", ["psnr", "ssim", "ssim_global"])
@pytest.mark.parametrize("shape", [(3, 24, 20, 3), (8, 8), (2, 40, 36)])
def test_metrics_equal_jax(fn, shape):
    a, b = _pair(1, shape)
    got = getattr(metrics, fn)(a, b)
    want = getattr(jmetrics, fn)(a, b)
    assert abs(got - want) <= 1e-12


def _spectrum(seed, shape=(16, 24)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol=1e-5, where=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if where is not None:
        diff = diff[where]
    assert diff.max() <= tol


def test_magnitude_and_phase_views():
    z = _spectrum(2)
    z[0, :3] = [0, -0.0, 1e-9]
    _close(debug.magnitude_view(torch.from_numpy(z)),
           jdebug.magnitude_view(jnp.asarray(z)))
    sig = np.abs(z) > 1e-3 * np.abs(z).max()
    _close(debug.phase_view(torch.from_numpy(z)),
           jdebug.phase_view(jnp.asarray(z)), where=sig)


@pytest.mark.parametrize("out", [(1, 2), (16, 64), (7, 5), (40, 9)])
def test_bilinear_resize_and_split_screen(out):
    rng = np.random.default_rng(3)
    img = rng.random((2, 12, 32)).astype(np.float32)
    _close(debug.bilinear_resize(torch.from_numpy(img), *out),
           jdebug.bilinear_resize(jnp.asarray(img), *out))
    other = rng.random((2, 12, 32)).astype(np.float32)
    _close(debug.split_screen(torch.from_numpy(img), torch.from_numpy(other),
                              *out),
           jdebug.split_screen(jnp.asarray(img), jnp.asarray(other), *out))


@pytest.mark.parametrize("change", [dict(), dict(motion_sensitivity=0.3),
                                    dict(apply_bandpass=False),
                                    dict(enhance_edges=False)])
def test_weight_views(change):
    jc, tc = JCfg(**change), TCfg(**change)
    _close(debug.spatial_frequency_map(32, 48),
           jdebug.spatial_frequency_map(32, 48))
    _close(debug.bandpass_weights_view(32, 48, tc),
           jdebug.bandpass_weights_view(32, 48, jc))
    cur, prev = _spectrum(4, (32, 48)), _spectrum(5, (32, 48))
    cur[:2] *= 1e-3  # some bins under the magnitude gate
    sig = np.minimum(np.abs(cur), np.abs(prev)) > 1e-3 * np.abs(cur).max()
    got = debug.filtered_phase_delta_view(torch.from_numpy(cur),
                                          torch.from_numpy(prev), tc)
    want = jdebug.filtered_phase_delta_view(jnp.asarray(cur),
                                            jnp.asarray(prev), jc)
    _close(got, want, where=sig)
    assert np.array_equal(np.asarray(got)[:2] == 0, np.asarray(want)[:2] == 0)


@pytest.mark.parametrize("hw", [(16, 16), (20, 28)])
@pytest.mark.parametrize("view", ["magnitude", "phase", "split"])
def test_debug_frame_view_vs_jax(hw, view):
    from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob

    frame = oscillating_gaussian_blob(*hw, frames=2)[1]
    kw = dict(show_magnitude=view in ("magnitude", "split"),
              show_phase=view in ("phase", "split"))
    got = debug.debug_frame_view(torch.from_numpy(frame), TCfg(), **kw)
    want = np.asarray(jdebug.debug_frame_view(jnp.asarray(frame), JCfg(),
                                              **kw))
    assert tuple(got.shape) == want.shape == hw + (3,)
    if view == "magnitude":
        _close(got, want)
    else:
        # Compare the phase only where the spectrum it comes from is
        # well above its rounding noise (its magnitude view > 1e-3 of
        # the maximum, both packages agreeing on that view).
        mag = np.asarray(jdebug.debug_frame_view(
            jnp.asarray(frame), JCfg(), show_magnitude=True))
        sig = (10 ** (4 * mag) - 1) / 10 > 1e-3 * ((10 ** (4 * mag.max())
                                                     - 1) / 10)
        if view == "split":
            # The left half is the magnitude view; the right half
            # resamples the phase of every bin, noise included.
            sig = np.ones_like(sig, bool)
            sig[:, hw[1] // 2:] = False
        _close(got, want, where=sig)


def test_assert_finite():
    checks.assert_finite("ok", np.ones(3), torch.ones(2))
    with pytest.raises(FloatingPointError, match="non-finite"):
        checks.assert_finite("bad", np.array([1.0, np.nan]))
    with pytest.raises(FloatingPointError, match="array 1"):
        checks.assert_finite("bad", np.ones(2), torch.tensor([np.inf]))


def test_debug_mode_catches_nan_from_a_wrapper():
    """A NaN out of a kernel wrapper (here the plain version of kernel 7,
    on CPU tensors) raises under debug_mode, naming the kernel; outside
    it the same call returns the NaN; the flag comes back on exit."""
    from pbmm_tpu_torch import kernels
    from pbmm_tpu_torch.spectral import fused

    re = torch.zeros((1, 2, 128))
    im = torch.zeros((1, 2, 128))
    re[0, 1, 5] = float("nan")
    out = fused.row_ifft_magnitude(re, im, pad_h=2)
    assert torch.isnan(out).any()
    with checks.debug_mode():
        assert kernels.CHECK_FINITE
        with pytest.raises(FloatingPointError, match="row_ifft_magnitude"):
            fused.row_ifft_magnitude(re, im, pad_h=2)
        fused.row_ifft_magnitude(torch.zeros_like(re), im, pad_h=2)
        with checks.debug_mode(nan_checks=False):
            fused.row_ifft_magnitude(re, im, pad_h=2)
        assert kernels.CHECK_FINITE
    assert not kernels.CHECK_FINITE


def test_stage_times_keys_match_jax():
    from pbmm_tpu.oracle.synthetic import oscillating_bar
    from pbmm_tpu.utils.profiling import stage_times as jstage_times

    frames = oscillating_bar(size=32, frames=3)
    got = profiling.stage_times(frames, TCfg(), device="cpu", reps=1)
    want = jstage_times(frames, JCfg(), reps=1)
    assert list(got) == list(want)
    assert all(v > 0 for v in got.values())


def test_trace_and_timeit(tmp_path):
    x = torch.ones(64)
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.scope("pbmm.test_scope"):
            y = x * 2
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert len(files) == 1
    assert "pbmm.test_scope" in open(files[0]).read()
    assert float(y.sum()) == 128
    assert profiling.timeit(lambda a: a + 1, x, reps=2) > 0


def test_parity_tool_passes():
    from pbmm_tpu_torch.tools.parity import run_parity

    results = run_parity(size=64, frames=4, which="pyramid_defaults,standard",
                         device="cpu")
    assert [r["case"] for r in results] == ["pyramid_defaults", "standard"]
    assert all(r["pass_35db"] and r["psnr_db"] > 55 for r in results)


def test_cli_demo_bar_vs_jax(tmp_path):
    from pbmm_tpu.cli import main as jmain
    from pbmm_tpu_torch.cli import main
    from pbmm_tpu_torch.engine.video import magnify_video
    from pbmm_tpu_torch.oracle.synthetic import oscillating_bar

    out, jout = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    assert main(["--demo", "bar", "--output", out], device="cpu") == 0
    assert jmain(["--demo", "bar", "--output", jout]) == 0
    got = np.load(out)
    want, _ = magnify_video(oscillating_bar(bar_width=2), TCfg(), device=CPU)
    assert np.array_equal(got, want.numpy())
    assert metrics.psnr(got, np.load(jout)) > 70


def test_cli_trace_writes_a_trace(tmp_path):
    from pbmm_tpu_torch.cli import main

    clip = np.random.default_rng(0).random((3, 24, 32, 3)).astype(np.float32)
    np.save(str(tmp_path / "in.npy"), clip)
    logdir = str(tmp_path / "trace")
    assert main(["--input", str(tmp_path / "in.npy"), "--output",
                 str(tmp_path / "o.npy"), "--trace", logdir],
                device="cpu") == 0
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    text = open(os.path.join(logdir, files[0])).read()
    assert "pbmm.preprocess" in text and "pbmm.phase_amplify" in text


def test_cli_debug_view_split_vs_jax(tmp_path):
    from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob
    from pbmm_tpu_torch.cli import main

    clip = oscillating_gaussian_blob(20, 28, frames=2)
    np.save(str(tmp_path / "in.npy"), clip)
    out = str(tmp_path / "o.npy")
    assert main(["--input", str(tmp_path / "in.npy"), "--output", out,
                 "--debug-view", "split"], device="cpu") == 0
    got = np.load(out)
    want = np.stack([np.asarray(jdebug.debug_frame_view(
        jnp.asarray(f), JCfg(), show_magnitude=True, show_phase=True))
        for f in clip])
    assert got.shape == want.shape == (2, 20, 28, 3)
    # the magnitude half exactly to 1e-5; the phase half where the
    # spectrum is well above its noise, as test_debug_frame_view_vs_jax
    _close(got[:, :, :14], want[:, :, :14])
