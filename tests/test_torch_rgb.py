"""Streams across the config matrix on the CPU: chroma="rgb" and the
two-kernel tail at pow-2 heights, states that cross packages (rgb, IIR,
pow-2; in memory and through checkpoint files), the pow-2 stream start
(kernel 5 on interleaved frames, kernel 2 on planar ones, a one-frame
clip) and the bypass.

The 320x384 clip (4 frames) keeps the merged tails; 256x256 frames pad
to 256x256 at square_pow2, outside `post_pallas_ok` (no blur halo inside
the pad), so they take kernel 7 and the torch `posttail`.

Tolerances as in tests/test_torch_matrix.py: > 70 dB against JAX,
spectra to max error / max magnitude < 1e-4, IIR taps the same weighted
by the magnitude of the bin each rotates; against the oracle no worse
than the JAX package less 1 dB.  The JAX package runs with full-f32
matmuls (gm_precision "highest")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.engine import state as jstate_io
from pbmm_tpu.engine.video import VideoState as JState
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.reference import (
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.phase.temporal import TemporalState as JTemporalState
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, TemporalConfig, magnify_video
from pbmm_tpu_torch.engine import state as tstate_io
from pbmm_tpu_torch.engine.state import state_from_numpy, state_to_numpy
from pbmm_tpu_torch.spectral import fused

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


def _cfgs(**change):
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


def _leaves(state):
    """(spectrum, lp_fast, lp_slow, frame_idx) as numpy, either package."""
    return (np.asarray(state.prev_spec_re) + 1j * np.asarray(
        state.prev_spec_im), np.asarray(state.temporal.lp_fast),
        np.asarray(state.temporal.lp_slow), int(state.frame_idx))


def _assert_states_match(got, want):
    """Spectra to rel < 1e-4, taps to rel < 1e-4 weighted by |spectrum|;
    an all-zero leaf (the tight bypass, the taps after one frame) must
    come out exactly zero."""
    gs, gf, gl, gi = _leaves(got)
    ws, wf, wl, wi = _leaves(want)
    assert gs.shape == ws.shape and gi == wi
    mag = np.abs(ws)
    for g, w, weight in ((gs, ws, 1.0), (gf, wf, mag), (gl, wl, mag)):
        assert g.shape == w.shape
        if not w.any():
            assert not g.any()
        else:
            assert (np.max(np.abs(g - w) * weight)
                    / np.max(np.abs(w) * weight)) < 1e-4


def _jax_state(d):
    return JState(jnp.asarray(d["prev_spec_re"]),
                  jnp.asarray(d["prev_spec_im"]),
                  jnp.asarray(d["prev_frame"]),
                  JTemporalState(jnp.asarray(d["lp_fast"]),
                                 jnp.asarray(d["lp_slow"])),
                  jnp.int32(d["frame_idx"]))


@pytest.fixture(scope="module")
def clip():
    return oscillating_bar(size=384, frames=4, bar_width=2)[:, :320]


@pytest.fixture(scope="module")
def clip256():
    return oscillating_bar(size=256, frames=4, bar_width=2)


@pytest.mark.parametrize("change", [
    dict(chroma="rgb", reconstruct="real"),
    dict(chroma="rgb", temporal=_IIR),
    dict(compensate_window=True, apply_yiq_gains=True,
         yiq_gains=(1.1, 0.9, 1.2)),
], ids=["rgb_real", "rgb_iir", "compensate_gains"])
def test_pow2_two_kernel_tail(clip256, change):
    """256x256 at square_pow2: kernel 7 (|z| or Re z) and the torch
    posttail (rgb, compensation, gains), the stream started by kernel 5."""
    tcfg, jcfg = _cfgs(pad_mode="square_pow2", **change)
    n = fused.col_fft_zero_padded.launches
    out, state = magnify_video(torch.from_numpy(clip256), tcfg)
    assert fused.col_fft_zero_padded.launches == n  # CPU: plain version
    out = out.numpy()
    jout, jst = jmagnify(clip256, jcfg)
    jout = np.asarray(jout)
    assert psnr(out, jout) > 70
    _assert_states_match(state, jst)
    if not tcfg.compensate_window:
        iir = tcfg.temporal.mode == "iir_bandpass"
        want = (oracle_magnify_video_iir if iir else oracle_magnify_video)(
            clip256, tcfg)
        assert psnr(out, want) >= psnr(jout, want) - 1.0


_CROSS = {
    "rgb": dict(chroma="rgb"),
    "iir": dict(temporal=_IIR),
    "square_pow2": dict(pad_mode="square_pow2"),
}


@pytest.mark.parametrize("name", sorted(_CROSS))
def test_state_crosses_packages(clip, tmp_path, name):
    """A stream started in one package resumes in the other, both ways,
    in memory and through each package's checkpoint file."""
    tcfg, jcfg = _cfgs(**_CROSS[name])
    full, full_state = magnify_video(torch.from_numpy(clip), tcfg)
    jfull, jfull_state = jmagnify(clip, jcfg)
    # JAX starts, the port continues (from a JAX checkpoint file).
    _, jhead = jmagnify(clip[:2], jcfg)
    ck = str(tmp_path / "jax.npz")
    jstate_io.save_state(jhead, ck)
    st = tstate_io.load_state(ck, device="cpu")
    _assert_states_match(st, jhead)
    out, st2 = magnify_video(torch.from_numpy(clip[2:]), tcfg, st)
    assert psnr(out.numpy(), np.asarray(jfull)[2:]) > 70
    _assert_states_match(st2, jfull_state)
    # The port starts, JAX continues (from a port checkpoint file).
    _, head = magnify_video(torch.from_numpy(clip[:2]), tcfg)
    ck = str(tmp_path / "port.npz")
    tstate_io.save_state(head, ck)
    jst = jstate_io.load_state(ck)
    jout, jst2 = jmagnify(clip[2:], jcfg, _jax_state(
        {k: np.asarray(v) for k, v in zip(
            ("prev_spec_re", "prev_spec_im", "prev_frame"), jst[:3])}
        | {"lp_fast": jst.temporal.lp_fast, "lp_slow": jst.temporal.lp_slow,
           "frame_idx": jst.frame_idx}))
    assert psnr(np.asarray(jout), full.numpy()[2:]) > 70
    _assert_states_match(full_state, jst2)
    # In memory, both ways, leaf for leaf.
    d = state_to_numpy(head)
    assert set(d) == {"prev_spec_re", "prev_spec_im", "prev_frame",
                      "lp_fast", "lp_slow", "frame_idx"}
    back = state_from_numpy(_jax_state(d), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        back[:3] + tuple(back.temporal), head[:3] + tuple(head.temporal)))


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_pow2_stream_start(clip, layout):
    """At pow-2 heights interleaved frames start from `video_init`
    (kernel 5 on frame 0), planar frames through kernel 2 against a zero
    spectrum (as in the JAX package); both give the same state.  A
    one-frame clip returns the passthrough and frame 0's spectrum."""
    tcfg, jcfg = _cfgs(pad_mode="square_pow2", chroma="rgb",
                       temporal=_IIR)
    frames = clip if layout == "interleaved" else np.ascontiguousarray(
        np.moveaxis(clip, -1, 1))
    one, s1 = magnify_video(torch.from_numpy(frames[:1]), tcfg)
    np.testing.assert_array_equal(one.numpy(), clip[:1])
    j1 = jmagnify(frames[:1], jcfg)[1]
    _assert_states_match(s1, j1)
    assert s1.frame_idx == 1 and not s1.temporal.lp_fast.any()
    out, st = magnify_video(torch.from_numpy(frames), tcfg)
    jout, jst = jmagnify(frames, jcfg)
    assert psnr(out.numpy(), np.asarray(jout)) > 70
    _assert_states_match(st, jst)
    # The two starts carry the same spectrum bit for bit on the CPU (one
    # op sequence for kernels 5 and 2).
    other = (np.ascontiguousarray(np.moveaxis(clip[:1], -1, 1))
             if layout == "interleaved" else clip[:1])
    s1b = magnify_video(torch.from_numpy(other), tcfg)[1]
    assert torch.equal(s1.prev_spec_re, s1b.prev_spec_re)
    assert torch.equal(s1.prev_spec_im, s1b.prev_spec_im)


@pytest.mark.parametrize("pad_mode,layout", [("square_pow2", "interleaved"),
                                             ("tight", "planar"),
                                             ("rect_pow2", "planar")])
def test_bypass(clip, pad_mode, layout):
    """apply_motion_magnification=False: the frames pass through exactly
    and the state tracks them like JAX `_bypass_state` (frame_idx from a
    given state); magnifying resumes from it as in the JAX package."""
    tcfg, jcfg = _cfgs(pad_mode=pad_mode, chroma="rgb", temporal=_IIR,
                       apply_motion_magnification=False)
    frames = clip if layout == "interleaved" else np.ascontiguousarray(
        np.moveaxis(clip, -1, 1))
    out, st = magnify_video(torch.from_numpy(frames[:2]), tcfg)
    np.testing.assert_array_equal(out.numpy(), clip[:2])
    jout, jst = jmagnify(frames[:2], jcfg)
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    _assert_states_match(st, jst)
    _, st2 = magnify_video(torch.from_numpy(frames[2:3]), tcfg, st)
    assert st2.frame_idx == 3
    on_t = tcfg.replace(apply_motion_magnification=True)
    on_j = jcfg.replace(apply_motion_magnification=True)
    out, st3 = magnify_video(torch.from_numpy(frames[2:]), on_t, st)
    jout, jst3 = jmagnify(frames[2:], on_j, jst)
    assert psnr(out.numpy(), np.asarray(jout)) > 70
    _assert_states_match(st3, jst3)


def test_cli_serves_the_matrix(clip256, tmp_path, capsys):
    """`--fast` at the CLI's default `--pad-mode square_pow2` with the
    matrix's switches runs (it exited 2 before); so do the scan engine's
    switches, the bypass and the mxu backend, each equal to
    `magnify_video` on its config."""
    from pbmm_tpu_torch.cli import build_parser, config_from_args, main

    inp, out = str(tmp_path / "in.npy"), str(tmp_path / "out.npy")
    np.save(inp, clip256[:3])
    argv = ["--input", inp, "--output", out, "--fast", "--chroma", "rgb",
            "--temporal", "iir_bandpass", "--mode", "standard",
            "--phase-scale", "2.5", "--compensate-window",
            "--yiq-gains", "1.0", "1.2", "0.8"]
    assert main(argv, device="cpu") == 0
    cfg = config_from_args(build_parser().parse_args(argv)).tuned_for_tpu()
    assert cfg.pad_mode == "square_pow2" and cfg.apply_yiq_gains
    want, _ = magnify_video(torch.from_numpy(clip256[:3]), cfg)
    np.testing.assert_array_equal(np.load(out), want.numpy())
    for flags in (["--fast", "--engine", "scan"],
                  ["--fast", "--no-cache-prev-spectrum"],
                  ["--mode", "standard", "--apply-magnitude-scale"],
                  ["--no-magnify"], ["--fft-backend", "mxu"]):
        argv = ["--input", inp, "--output", out] + flags
        assert main(argv, device="cpu") == 0
        cfg = config_from_args(build_parser().parse_args(argv))
        if "--fast" in flags:
            cfg = cfg.tuned_for_tpu()
        want, _ = magnify_video(torch.from_numpy(clip256[:3]), cfg)
        np.testing.assert_array_equal(np.load(out), want.numpy())
