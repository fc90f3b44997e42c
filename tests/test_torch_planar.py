"""The 8-bit video contract end to end on the CPU: planar (T, 3, H, W)
uint8 or f32 frames in, each `output_layout` out, against the JAX
package's `magnify_video` (interpret mode) and the fp64 oracle.

Two frame sizes take the two tails of the chunk engine:
- 320x384 (pad 384x512): `post_pallas_ok` holds, so uint8 frames run
  kernel 4 and kernel 3 with its uint8 chroma, which writes the layout;
- 300x384 (pad 384x512, content rows offset inside the row window): 300
  rows have no 8-multiple block, so the tail is kernel 7 (row IFFT + |z|)
  and the torch `posttail`, with I/Q derived from the uint8 planes.

Bars: > 70 dB and max abs < 1e-4 against JAX (1 code for planar_u8),
> 100 dB against the oracle for f32 outputs (oracle input: frames / 255,
interleaved); planar f32 equals interleaved f32 bit for bit."""

import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.reference import oracle_magnify_video
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.spectral import fused

SIZES = {"320x384": (320, 384), "300x384": (300, 384)}
LAYOUTS = ("interleaved", "planar", "planar_u8")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(layout="interleaved"):
    return MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", output_layout=layout)


def _jcfg(layout):
    return JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True, output_layout=layout)


def _to_interleaved(out, layout):
    return out if layout == "interleaved" else np.moveaxis(out, 1, -1)


@pytest.fixture(scope="module", params=sorted(SIZES))
def clip(request):
    """A moving uint8 clip, planar and interleaved, and the JAX package's
    output on the planar clip in each layout."""
    h, w = SIZES[request.param]
    rng = np.random.default_rng(h)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    inter = np.stack([np.roll(base, i, axis=1) for i in range(4)])
    planar = np.moveaxis(inter, -1, 1).copy()
    jax_out = {lay: np.asarray(jmagnify(planar, _jcfg(lay))[0])
               for lay in LAYOUTS}
    return dict(name=request.param, inter=inter, planar=planar,
                jax=jax_out, oracle=oracle_magnify_video(
                    inter.astype(np.float32) / 255.0, _tcfg()))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_planar_u8_vs_jax_and_oracle(clip, layout):
    out, state = magnify_video(torch.from_numpy(clip["planar"]),
                               _tcfg(layout))
    out = out.numpy()
    want = clip["jax"][layout]
    assert out.shape == want.shape and out.dtype == want.dtype
    assert state.frame_idx == 4
    if layout == "planar_u8":
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        return
    assert out.shape[1 if layout == "planar" else -1] == 3
    assert psnr(out, want) > 70
    assert np.max(np.abs(out - want)) < 1e-4
    assert psnr(_to_interleaved(out, layout), clip["oracle"]) > 100


def test_kernel_routes(clip, monkeypatch):
    """uint8 planar frames take kernel 4, and the u8 chroma of kernel 3
    where the merged tail serves, else kernel 7 (the JAX package's gates
    for the tail; kernel 4 serves both, the front end's route for these
    frames).  (On the CPU each wrapper runs its plain version; the spies
    record which wrappers the engine called.)"""
    import pbmm_tpu_torch.engine.pipeline as pipe
    import pbmm_tpu_torch.engine.video as video

    calls = []

    def spy(mod, name, fn, tag):
        def wrapped(*a, **k):
            calls.append((tag, k.get("src") is not None))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(pipe, "windowed_row_fft_u8planar", fused.windowed_row_fft_u8planar,
        "k4")
    spy(pipe, "windowed_row_fft", fused.windowed_row_fft, "k1")
    spy(video, "row_ifft_magnitude", fused.row_ifft_magnitude, "k7")
    spy(video, "rowifft_post_fused", post_fused.rowifft_post_fused, "k3")
    magnify_video(torch.from_numpy(clip["planar"][:2]), _tcfg())
    want = ([("k4", False), ("k3", True)] if clip["name"] == "320x384"
            else [("k4", False), ("k7", False)])
    assert calls == want


def test_planar_f32_equals_interleaved_f32(clip):
    f32 = clip["inter"].astype(np.float32) / 255.0
    ref, s_ref = magnify_video(torch.from_numpy(f32), _tcfg())
    planar = np.ascontiguousarray(np.moveaxis(f32, -1, 1))
    for layout in LAYOUTS:
        out, s = magnify_video(torch.from_numpy(planar), _tcfg(layout))
        if layout == "planar_u8":
            want = torch.round(torch.movedim(ref, -1, 1) * 255.0).to(
                torch.uint8)
            assert torch.equal(out, want)
        else:
            assert torch.equal(torch.from_numpy(
                _to_interleaved(out.numpy(), layout)), ref)
        assert torch.equal(s.prev_spec_re, s_ref.prev_spec_re)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_planar_chunk_threading_bit_exact(clip, layout):
    planar = torch.from_numpy(clip["planar"])
    whole, s_whole = magnify_video(planar, _tcfg(layout))
    o1, s = magnify_video(planar[:2], _tcfg(layout))
    o2, s2 = magnify_video(planar[2:], _tcfg(layout), s)
    assert torch.equal(torch.cat([o1, o2]), whole)
    assert torch.equal(s2.prev_spec_re, s_whole.prev_spec_re)
    assert torch.equal(s2.prev_spec_im, s_whole.prev_spec_im)
    assert s2.frame_idx == 4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_first_frame_passthrough(clip, layout):
    out, _ = magnify_video(torch.from_numpy(clip["planar"][:2]),
                           _tcfg(layout))
    f0 = clip["planar"][0]
    if layout == "planar_u8":
        np.testing.assert_array_equal(out[0].numpy(), f0)
        return
    want = f0.astype(np.float32) * np.float32(1 / 255)
    got = out[0].numpy()
    np.testing.assert_array_equal(
        got if layout == "planar" else np.moveaxis(got, -1, 0), want)
