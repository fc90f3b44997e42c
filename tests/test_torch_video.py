"""The port's main path end to end on the CPU, against the fp64 oracle and
the JAX package, on a clip that takes all three kernel paths the way 1080p
does: 320x384 frames pad to 384x512 (four-step columns with m = 3, 3 of 4
lane tiles kept, the merged row-IFFT + post tail)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine.video import VideoState as JState
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.reference import oracle_magnify_video
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.phase.temporal import TemporalState as JTemporal
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, TemporalConfig, magnify_video
from pbmm_tpu_torch.engine.state import state_from_numpy, state_to_numpy


def _tcfg():
    return MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight")


def _jcfg():
    return JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True)


def _jax_state(d):
    return JState(jnp.asarray(d["prev_spec_re"]),
                  jnp.asarray(d["prev_spec_im"]),
                  jnp.asarray(d["prev_frame"]),
                  JTemporal(jnp.asarray(d["lp_fast"]),
                            jnp.asarray(d["lp_slow"])),
                  jnp.int32(d["frame_idx"]))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def clip():
    return oscillating_bar(size=384, frames=5, bar_width=2)[:, :320]


@pytest.fixture(scope="module")
def port(clip):
    out, state = magnify_video(torch.from_numpy(clip), _tcfg())
    return out.numpy(), state


@pytest.fixture(scope="module")
def jax_runs(clip):
    """JAX on the whole clip, and JAX on frames[:2] then frames[2:]."""
    out, state = jmagnify(clip, _jcfg())
    o1, s1 = jmagnify(clip[:2], _jcfg())
    o2, s2 = jmagnify(clip[2:], _jcfg(), s1)
    return dict(out=np.asarray(out), state=state, head_state=s1,
                tail_out=np.asarray(o2), tail_state=s2)


def test_vs_oracle(clip, port):
    out, _ = port
    assert out.shape == clip.shape and out.dtype == np.float32
    assert psnr(out, oracle_magnify_video(clip, _tcfg())) > 100


def test_vs_jax(port, jax_runs):
    out, state = port
    assert psnr(out, jax_runs["out"]) > 70
    js = state_to_numpy(state)
    assert js["prev_spec_re"].shape == (1, 384, 384)
    want = (np.asarray(jax_runs["state"].prev_spec_re)
            + 1j * np.asarray(jax_runs["state"].prev_spec_im))
    assert _rel(js["prev_spec_re"] + 1j * js["prev_spec_im"], want) < 1e-4
    assert int(js["frame_idx"]) == int(jax_runs["state"].frame_idx) == 5


def test_chunk_threading_bit_exact(clip, port):
    o1, s = magnify_video(torch.from_numpy(clip[:2]), _tcfg())
    o2, s2 = magnify_video(torch.from_numpy(clip[2:]), _tcfg(), s)
    np.testing.assert_array_equal(
        port[0], np.concatenate([o1.numpy(), o2.numpy()]))
    assert torch.equal(s2.prev_spec_re, port[1].prev_spec_re)
    assert s2.frame_idx == 5


def test_first_frame_passthrough(clip, port):
    np.testing.assert_array_equal(port[0][0], clip[0])
    # uint8 frames pass through as x / 255 like the JAX package.
    u8 = np.round(clip[:2] * 255).astype(np.uint8)
    out, _ = magnify_video(torch.from_numpy(u8), _tcfg())
    np.testing.assert_array_equal(
        out[0].numpy(), u8[0].astype(np.float32) * np.float32(1 / 255))


def test_zero_prev_bootstrap(clip, port, jax_runs):
    """Frame 0 runs against an exact-zero previous spectrum; the state it
    leaves is frame 0's spectrum and frame 1 matches JAX."""
    out, _ = port
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    assert psnr(out[1], jax_runs["out"][1]) > 70
    s0 = magnify_video(torch.from_numpy(clip[:1]), _tcfg())[1]
    s0_jax = jmagnify(clip[:1], _jcfg())[1]
    got = state_to_numpy(s0)
    want = np.asarray(s0_jax.prev_spec_re) + 1j * np.asarray(
        s0_jax.prev_spec_im)
    assert np.isfinite(got["prev_spec_re"]).all()
    assert _rel(got["prev_spec_re"] + 1j * got["prev_spec_im"], want) < 1e-4


def test_state_from_jax(clip, jax_runs):
    """JAX runs frames[:2]; the port continues from its state."""
    st = state_from_numpy(jax_runs["head_state"], device="cpu")
    assert st.frame_idx == 2
    out, st2 = magnify_video(torch.from_numpy(clip[2:]), _tcfg(), st)
    assert psnr(out.numpy(), jax_runs["tail_out"]) > 70
    want = (np.asarray(jax_runs["tail_state"].prev_spec_re)
            + 1j * np.asarray(jax_runs["tail_state"].prev_spec_im))
    got = state_to_numpy(st2)
    assert _rel(got["prev_spec_re"] + 1j * got["prev_spec_im"], want) < 1e-4
    assert st2.frame_idx == 5


def test_state_to_jax(clip, port):
    """The port runs frames[:2]; JAX continues from its state."""
    _, s = magnify_video(torch.from_numpy(clip[:2]), _tcfg())
    d = state_to_numpy(s)
    assert set(d) == {"prev_spec_re", "prev_spec_im", "prev_frame",
                      "lp_fast", "lp_slow", "frame_idx"}
    out, s2 = jmagnify(clip[2:], _jcfg(), _jax_state(d))
    assert psnr(np.asarray(out), port[0][2:]) > 70
    want = (port[1].prev_spec_re + 1j * port[1].prev_spec_im).numpy()
    got = np.asarray(s2.prev_spec_re) + 1j * np.asarray(s2.prev_spec_im)
    assert _rel(got, want) < 1e-4
    assert int(s2.frame_idx) == 5


@pytest.mark.parametrize("change", [
    dict(engine="scan"),
    dict(cache_prev_spectrum=False),
    dict(fft_backend="xla", use_rfft=True, use_fused_spectral=False),
    dict(fft_backend="mxu", use_rfft=True, use_fused_spectral=False,
         pad_mode="square_pow2"),
], ids=["scan_engine", "no_cache_prev_spectrum", "xla_backend",
        "mxu_backend"])
def test_unsupported_config_raises(clip, change):
    """On the tight pallas config, the scan engine and the no-cache mode
    raise the JAX package's ValueError (the per-frame kernels are radix-2
    down the columns), and their bypass passes the frames through as
    JAX's does; the xla backend at tight heights and the mxu backend at
    square_pow2 are served (the scan engine, against JAX: > 70 dB on
    the xla backend, > 100 dB on the mxu backend)."""
    cfg = _tcfg().replace(**change)
    frames = clip[:3]
    if cfg.fft_backend in ("xla", "mxu"):
        out, _ = magnify_video(torch.from_numpy(frames), cfg)
        jcfg = _jcfg().replace(**change)
        # The mxu case runs the same backend on both sides: the transforms'
        # parity bar (tests/test_torch_mxu_fft.py), not the 70 dB between
        # two backends.
        bar = 100 if cfg.fft_backend == "mxu" else 70
        assert psnr(out.numpy(), np.asarray(jmagnify(frames, jcfg)[0])) > bar
        return
    for pkg, jc in ((magnify_video, cfg),
                    (jmagnify, _jcfg().replace(**change))):
        with pytest.raises(ValueError, match="pad_mode='tight'"):
            pkg(torch.from_numpy(frames) if pkg is magnify_video else frames,
                jc)
    out, state = magnify_video(torch.from_numpy(frames),
                               cfg.replace(apply_motion_magnification=False))
    np.testing.assert_array_equal(out.numpy(), frames)
    assert state.frame_idx == 3 and not state.prev_spec_re.any()


def test_unsupported_frames_raise(clip):
    """Planar frames, frame sizes outside `post_pallas_ok` and pow-2
    column heights are served (tests/test_torch_planar.py,
    tests/test_torch_rgb.py); malformed frames still raise."""
    # Neither (T, H, W, 3) nor (T, 3, H, W): malformed, not unported.
    with pytest.raises(ValueError, match="frames"):
        magnify_video(torch.from_numpy(clip[:2, :, :, :2].copy()), _tcfg())
    # 256-row frames pad to a pow-2 height even at pad_mode="tight": the
    # radix-2 column layout, in either frame layout, as in the JAX package.
    small = oscillating_bar(size=256, frames=2, bar_width=2)
    want, want_state = jmagnify(small, _jcfg())
    for frames in (small, np.moveaxis(small, -1, 1).copy()):
        out, state = magnify_video(torch.from_numpy(frames), _tcfg())
        assert out.shape == small.shape and torch.isfinite(out).all()
        assert psnr(out.numpy(), np.asarray(want)) > 70
        assert _rel(state_to_numpy(state)["prev_spec_re"],
                    np.asarray(want_state.prev_spec_re)) < 1e-4
    # 300 rows have no 8-multiple divisor: the two-kernel tail serves
    # them, as in the JAX package (`post_pallas_ok` False).
    odd = np.ascontiguousarray(
        oscillating_bar(size=300, frames=2, bar_width=2)[:, :, :256])
    out, _ = magnify_video(torch.from_numpy(odd), _tcfg())
    assert out.shape == odd.shape and torch.isfinite(out).all()
