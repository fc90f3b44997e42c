"""The tail with its chroma from the source frames and the interleaved
layout, on the CPU (every kernel wrapper takes its plain version):

- the tail's plain versions (`engine/video.py::_tail_block`: kernel 3,
  or kernels 7 + 10) with the chroma from f32 or uint8, interleaved or
  planar frames and the output layout written by the kernel, against the
  JAX package's `_tail_block` (the kernel on the I/Q planes XLA forms,
  or on the planar uint8 frames, then `jnp.stack`), > 70 dB;
- `magnify_video` on f32 interleaved, f32 planar and uint8 interleaved
  frames against the JAX package's, > 70 dB, and > 100 dB against the
  fp64 oracle at tight geometry;
- that `_chunk_colspec` builds no I/Q plane for these inputs: the pre
  stage is asked for none, the tail gets the frames, and the engine
  returns the tail's own output (no stack after it);
- the plain versions' contracts: "interleaved" is the stack of "tuple3"
  for kernels 3, 10 and 11, and the source chroma equals the I/Q planes
  of the torch pre stage (`pipeline.chroma_planes`) times the window,
  bit for bit, except planar uint8, which keeps the JAX kernel's folded
  rows;
- a model of the kernels' interleaved stores (`csrc/post_tail.cuh`): a
  thread's three 16-byte words cover its four pixels' 12 values, and
  the threads cover the frames once, in bounds.

The geometry is 320x384 (pad 384x512), where `post_pallas_ok` holds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.core.color import RGB_TO_YIQ as JYIQ
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.engine.pipeline import blur_row_window as jrows
from pbmm_tpu.engine.video import _tail_block as jtail
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu_torch.oracle.reference import oracle_magnify_video
from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import pipeline, post_fused, video
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width
from pbmm_tpu_torch.utils.metrics import psnr

H, W = 320, 384
FORMS = ("f32 interleaved", "f32 planar", "u8 interleaved", "u8 planar")
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


def _tcfg(layout="interleaved", **kw):
    return MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", output_layout=layout, **kw)


def _jcfg(layout="interleaved", **kw):
    return JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", output_layout=layout, interpret_pallas=True, **kw)


def _frames(form, t=2, seed=5):
    """A moving clip in one input form (numpy)."""
    dtype, layout = form.split()
    base = np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)
    u8 = np.stack([np.roll(base, i, axis=1) for i in range(t)])
    a = u8 if dtype == "u8" else u8 * np.float32(1.0 / 255.0)
    if layout == "planar":
        a = np.moveaxis(a, -1, 1)
    return np.ascontiguousarray(a)


def _interleaved(out, layout):
    return out if layout == "interleaved" else np.moveaxis(out, 1, -1)


def _close(got, want, layout):
    assert got.shape == want.shape and got.dtype == want.dtype
    if layout == "planar_u8":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        assert psnr(got, want) > 70


@pytest.fixture(scope="module")
def rows_in():
    """Random column-IFFT output rows at the 320x384 geometry."""
    g = geometry_for(H, W, "tight")
    rows = pipeline.blur_row_window(g, _tcfg())
    hr, wk = rows[1] - rows[0], hermitian_kept_width(g.pad_w)
    rng = np.random.default_rng(9)
    scale = 0.3 * g.pad_h * g.pad_w / np.sqrt(g.pad_w)
    return dict(g=g, rows=rows, rre=(scale * rng.standard_normal(
        (2, hr, wk))).astype(np.float32), rim=(scale * rng.standard_normal(
            (2, hr, wk))).astype(np.float32))


def _jax_iq(frames):
    """The JAX pre stage's I/Q planes of (numpy) frames, in XLA."""
    f = jnp.asarray(frames).astype(jnp.float32)
    if frames.dtype == np.uint8:
        f = f * jnp.float32(1.0 / 255.0)
    rgb = ((f[:, 0], f[:, 1], f[:, 2]) if frames.shape[1] == 3
           else (f[..., 0], f[..., 1], f[..., 2]))
    return tuple(rgb[0] * float(JYIQ[d, 0]) + rgb[1] * float(JYIQ[d, 1])
                 + rgb[2] * float(JYIQ[d, 2]) for d in (1, 2))


@pytest.mark.parametrize("blur", [1.0, 4.0], ids=["r2", "r13"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", FORMS)
def test_tail_block_vs_jax(rows_in, form, layout, blur):
    g, rows = rows_in["g"], rows_in["rows"]
    frames = _frames(form)
    tcfg, jcfg = _tcfg(layout, blur_size=blur), _jcfg(layout, blur_size=blur)
    got = video._tail_block(torch.from_numpy(rows_in["rre"]),
                            torch.from_numpy(rows_in["rim"]), None, None,
                            tcfg, g, rows, src=torch.from_numpy(frames))
    planar_u8 = form == "u8 planar"
    iq = (None, None) if planar_u8 else _jax_iq(frames)
    want = jtail(jnp.asarray(rows_in["rre"]), jnp.asarray(rows_in["rim"]),
                 *iq, jcfg, jgeom(H, W, "tight"), jrows(jgeom(H, W, "tight"),
                                                        jcfg),
                 2, H, W, rgb_u8=jnp.asarray(frames) if planar_u8 else None)
    _close(got.numpy(), np.asarray(want), layout)


@pytest.fixture(scope="module")
def clips():
    """The JAX package's output and the oracle on a 4-frame moving clip."""
    inter = _frames("u8 interleaved", t=4, seed=7)
    f32 = inter * np.float32(1.0 / 255.0)
    return dict(inter=inter, f32=f32,
                jax={lay: np.asarray(jmagnify(f32, _jcfg(lay))[0])
                     for lay in LAYOUTS},
                oracle=oracle_magnify_video(f32, _tcfg()))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", ["f32 interleaved", "f32 planar",
                                  "u8 interleaved"])
def test_magnify_video_vs_jax_and_oracle(clips, form, layout):
    src = clips["inter"] if form.startswith("u8") else clips["f32"]
    if form.endswith("planar"):
        src = np.ascontiguousarray(np.moveaxis(src, -1, 1))
    out, state = magnify_video(torch.from_numpy(src), _tcfg(layout))
    out = out.numpy()
    assert state.frame_idx == 4
    _close(out, clips["jax"][layout], layout)
    if layout != "planar_u8":
        assert psnr(_interleaved(out, layout), clips["oracle"]) > 100


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", FORMS)
def test_chunk_builds_no_iq_plane(form, layout, monkeypatch):
    """On a steady chunk `_chunk_colspec` asks the pre stage for no I/Q
    plane (none is built: `chroma_planes` never runs), hands the source
    frames to the tail, and returns the tail's output as it is."""
    calls = {}

    def no_planes(*a, **k):
        raise AssertionError("chroma_planes ran")

    def pre(frames, cfg, want_iq=True):
        calls["want_iq"] = want_iq
        return real_pre(frames, cfg, want_iq)

    def tail(rre, rim, i_plane, q_plane, *a, src=None, **k):
        calls["tail"] = (i_plane, q_plane, src, k["out_layout"])
        calls["out"] = real_tail(rre, rim, i_plane, q_plane, *a, src=src,
                                 **k)
        return calls["out"]

    real_pre, real_tail = video.preprocess_cl, video.rowifft_post_fused
    cfg = _tcfg(layout)
    frames = torch.from_numpy(_frames(form, t=3))
    _, state = magnify_video(frames[:1], cfg)
    monkeypatch.setattr(pipeline, "chroma_planes", no_planes)
    monkeypatch.setattr(video, "preprocess_cl", pre)
    monkeypatch.setattr(video, "rowifft_post_fused", tail)
    out, _ = magnify_video(frames[1:], cfg, state)
    assert calls["want_iq"] is False
    i_plane, q_plane, src, out_layout = calls["tail"]
    assert i_plane is None and q_plane is None
    assert torch.equal(src, frames[1:]) and out_layout == layout
    assert out is calls["out"]


def _post_case(kind, layout, src=None):
    """One plain-version call of kernel 3, 10 or 11 at 320x384."""
    g = geometry_for(H, W, "tight")
    cfg = _tcfg()
    rows = pipeline.blur_row_window(g, cfg)
    hr, wk = rows[1] - rows[0], hermitian_kept_width(g.pad_w)
    rng = np.random.default_rng(13)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    win = hann2d_region(g)
    frames = torch.from_numpy(_frames("f32 interleaved"))
    iq = pipeline.chroma_planes(frames) if src is None else (None, None)
    if kind == 3:
        s = 0.3 * g.pad_h * np.sqrt(g.pad_w)
        return post_fused.rowifft_post_fused_ref(
            rnd(2, hr, wk, scale=s), rnd(2, hr, wk, scale=s), *iq, win, cfg,
            rows[0], H, W, "tight", full_w=g.pad_w, src=src,
            out_layout=layout)
    if kind == 10:
        return post_fused.post_fused_ref(rnd(2, hr, g.pad_w).abs(), *iq, win,
                                         cfg, rows[0], H, W, "tight", layout,
                                         src=src)
    return post_fused.post_fused_rgb_ref(
        rnd(6, hr, g.pad_w, scale=0.3), win, cfg.replace(chroma="rgb"),
        rows[0], H, W, "tight", out_layout=layout)


@pytest.mark.parametrize("kind", [3, 10, 11])
def test_interleaved_is_stacked_tuple3(kind):
    got = _post_case(kind, "interleaved")
    assert got.shape == (2, H, W, 3) and got.is_contiguous()
    assert torch.equal(got, torch.stack(_post_case(kind, "tuple3"), dim=-1))


@pytest.mark.parametrize("form", FORMS)
def test_source_chroma_equals_pre_stage_planes(form):
    """The plain versions' windowed chroma from source frames: the I/Q
    planes of the torch pre stage times the window, bit for bit; planar
    uint8 keeps the JAX kernel's rows with the 1/255 folded in."""
    src = torch.from_numpy(_frames(form))
    win = hann2d_region(geometry_for(H, W, "tight"))
    got = post_fused._windowed_chroma(None, None, src, win)
    if form == "u8 planar":
        c = post_fused._u8_chroma_coeffs()
        rgb = [src[:, k].to(torch.float32) for k in range(3)]
        want = tuple((rgb[0] * c[3 * d] + rgb[1] * c[3 * d + 1]
                      + rgb[2] * c[3 * d + 2]) * win for d in (0, 1))
    else:
        want = tuple(p * win for p in pipeline.chroma_planes(src))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if form != "u8 planar":
        kind, planar, rows, pre = post_fused._src_chroma(src)
        assert kind == (post_fused._CH_U8 if form.startswith("u8")
                        else post_fused._CH_F32)
        assert planar == form.endswith("planar")
        assert pre == (np.float32(1.0 / 255.0) if form.startswith("u8")
                       else 0.0)


@pytest.mark.parametrize("t,h,w", [(2, 8, 16), (1, 3, 12), (3, 5, 4)])
def test_interleaved_stores_cover_the_frames_once(t, h, w):
    """`pbmm_tail_epilogue`'s interleaved store: the thread of pixels (f,
    j, x .. x + 3) writes float4 words at ((f h + j) w + x) 3 + 4 k, k <
    3, holding R, G, B of each pixel in order; over every quad of every
    row and frame they cover (T, H, W, 3) once, 16-byte aligned."""
    seen = np.zeros(t * h * w * 3, int)
    for f in range(t):
        for j in range(h):
            for x in range(0, w, 4):
                base = ((f * h + j) * w + x) * 3
                assert base % 4 == 0  # float4 words
                words = [base + 4 * k + np.arange(4) for k in range(3)]
                flat = np.concatenate(words)
                # element 3 e + c of the 12 is pixel x + e's channel c
                want = np.array([((f * h + j) * w + x + e) * 3 + c
                                 for e in range(4) for c in range(3)])
                assert np.array_equal(flat, want)
                seen[flat] += 1
    assert (seen == 1).all()
