"""The port's streaming entry points on the CPU: the device-side YCbCr
decode against the JAX package's, y4m files, `stream_magnify` and the
resumable loop (checkpoints crossing between the two packages in both
directions), and the CLI's whole-file, `--checkpoint` and `--output -`
pipe modes through `main(argv, device="cpu")`.

The clip is 320x384 (pad 384x512), where uint8 ingest takes kernels 4
and 3 as at 1080p."""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine import state as jstate
from pbmm_tpu.io import device_decode as jdecode
from pbmm_tpu.io import stream as jstream
from pbmm_tpu.io import y4m as jy4m
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.cli import main
from pbmm_tpu_torch.engine import state as tstate
from pbmm_tpu_torch.io import device_decode as tdecode
from pbmm_tpu_torch.io import stream as tstream
from pbmm_tpu_torch.io import y4m as ty4m

H, W, T = 320, 384, 6
CPU = torch.device("cpu")
FAST = ["--fast", "--pad-mode", "tight"]


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


def _jcfg(layout="interleaved"):
    return JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True, output_layout=layout)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    base = rng.random((H, W, 3)).astype(np.float32)
    return np.stack([np.roll(base, i, axis=1) for i in range(T)])


@pytest.fixture(scope="module")
def y4m_files(frames, tmp_path_factory):
    d = tmp_path_factory.mktemp("y4m")
    paths = {}
    for cs in ("444", "420jpeg"):
        paths[cs] = str(d / f"clip_{cs}.y4m")
        ty4m.save_y4m(paths[cs], frames, fps=(60, 1), colorspace=cs)
    return paths


def _planes(path):
    with open(path, "rb") as f:
        planes = list(ty4m.read_y4m_planes(f, path))
    return [np.stack([p[k] for p in planes]) for k in range(3)]


@pytest.mark.parametrize("cs", ["444", "420jpeg"])
def test_device_decode_vs_jax(y4m_files, cs):
    """f32 within 1e-6 of the JAX package's decode.  The port computes
    the host reader's formulas (`io/y4m.py::_ycbcr_to_rgb`) to the bit,
    so its uint8 decode equals the host decode rounded; XLA on the CPU
    rounds 1-2 ulp away from those formulas at ~0.1 % of values, which
    moves a handful of pixels across a rounding boundary: 1 code at
    most, at fewer than 1e-5 of the pixels."""
    y, cb, cr = _planes(y4m_files[cs])
    t_args = [torch.from_numpy(a) for a in (y, cb, cr)] + [H, W]
    j_args = [jnp.asarray(a) for a in (y, cb, cr)] + [H, W]
    got = tdecode.ycbcr_planes_to_rgb(*t_args).numpy()
    want = np.asarray(jdecode.ycbcr_planes_to_rgb(*j_args))
    assert got.shape == want.shape == (T, H, W, 3)
    assert np.max(np.abs(got - want)) <= 1e-6
    host = np.stack([ty4m._ycbcr_to_rgb(y[i], ty4m._upsample(cb[i], W, H),
                                        ty4m._upsample(cr[i], W, H))
                     for i in range(T)])
    np.testing.assert_array_equal(got, host)
    got8 = tdecode.ycbcr_planes_to_rgb_planar_u8(*t_args).numpy()
    assert got8.dtype == np.uint8 and got8.shape == (T, 3, H, W)
    np.testing.assert_array_equal(
        got8, np.round(np.moveaxis(host, -1, 1) * 255.0).astype(np.uint8))
    want8 = np.asarray(jdecode.ycbcr_planes_to_rgb_planar_u8(*j_args))
    diff = np.abs(got8.astype(int) - want8.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-5


def test_y4m_roundtrip(frames, y4m_files, tmp_path):
    """The port's y4m writer gives the JAX package's bytes, and both
    readers decode them alike, to within the 8-bit coding."""
    jpath = str(tmp_path / "jax.y4m")
    jy4m.save_y4m(jpath, frames, fps=(60, 1), colorspace="444")
    with open(jpath, "rb") as a, open(y4m_files["444"], "rb") as b:
        assert a.read() == b.read()
    got = ty4m.load_y4m(y4m_files["444"])
    np.testing.assert_array_equal(got, jy4m.load_y4m(y4m_files["444"]))
    assert np.max(np.abs(got - frames)) < 3 / 255
    from pbmm_tpu_torch.io.video import video_shape

    assert video_shape(y4m_files["420jpeg"]) == (T, H, W, 3)


def _u8_chunks(path, n):
    y, cb, cr = (torch.from_numpy(a) for a in _planes(path))
    u8 = tdecode.ycbcr_planes_to_rgb_planar_u8(y, cb, cr, H, W)
    return [u8[i:i + n] for i in range(0, T, n)]


@pytest.fixture(scope="module")
def port_run(y4m_files):
    """magnify_video over the device-decoded u8 chunks of the 420jpeg
    clip, state threaded, in each layout."""
    runs = {}
    for layout in ("interleaved", "planar_u8"):
        outs, state = [], None
        for chunk in _u8_chunks(y4m_files["420jpeg"], 2):
            out, state = magnify_video(chunk, _tcfg(layout), state)
            outs.append(out.numpy())
        runs[layout] = outs
    return runs


def test_stream_magnify_u8_equals_chunked_magnify(y4m_files, port_run):
    got = list(tstream.stream_magnify(
        y4m_files["420jpeg"], _tcfg("planar_u8"), chunk_frames=2,
        ingest="u8", device=CPU))
    assert len(got) == len(port_run["planar_u8"]) == 3
    for g, w in zip(got, port_run["planar_u8"]):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_stream_sources(frames, y4m_files, tmp_path):
    """f32 ingest decodes on the device to the host reader's frames;
    .npy chunks come through the memmap, uint8 unscaled."""
    chunks = list(tstream._open_chunk_source(y4m_files["444"], 4,
                                             device=CPU))
    host = ty4m.load_y4m(y4m_files["444"])
    np.testing.assert_allclose(torch.cat(chunks).numpy(), host, atol=1e-5)
    u8 = (frames * 255).astype(np.uint8)
    p = str(tmp_path / "u8.npy")
    np.save(p, u8)
    got = list(tstream.frame_chunks(p, 4, device=CPU))
    assert [c.shape[0] for c in got] == [4, 2]
    assert got[0].dtype == torch.uint8
    np.testing.assert_array_equal(torch.cat(got).numpy(), u8)


def test_resumable_kill_and_resume_bit_identical(y4m_files, port_run,
                                                 tmp_path):
    out, ck = str(tmp_path / "o.npy"), str(tmp_path / "ck.npz")
    kw = dict(chunk_frames=2, checkpoint=ck, ingest="u8", device=CPU)
    args = (y4m_files["420jpeg"], out, _tcfg())
    assert tstream.stream_magnify_resumable(*args, max_chunks=1, **kw) == 2
    assert tstate.load_state(ck, device="cpu").frame_idx == 2
    with pytest.raises(ValueError, match="chunk"):
        tstream.stream_magnify_resumable(*args, chunk_frames=4,
                                         checkpoint=ck, device=CPU)
    assert tstream.stream_magnify_resumable(*args, **kw) == T
    np.testing.assert_array_equal(np.load(out),
                                  np.concatenate(port_run["interleaved"]))
    # A finished run resumes as a no-op.
    assert tstream.stream_magnify_resumable(*args, **kw) == T
    with pytest.raises(ValueError, match="re-readable"):
        tstream.stream_magnify_resumable("-", out, _tcfg(), device=CPU)


@pytest.mark.parametrize("first", ["port", "jax"])
def test_checkpoint_crosses_packages(y4m_files, tmp_path, first):
    """One package streams the first chunk and checkpoints; the other
    resumes from the file and finishes the same output.  (f32 ingest: the
    two packages' f32 decodes agree to 1e-6, where their uint8 decodes
    differ by a code at a few pixels.)"""
    out, ck = str(tmp_path / "o.npy"), str(tmp_path / "ck.npz")
    src = y4m_files["420jpeg"]
    runs = [(tstream, dict(cfg=_tcfg(), device=CPU)),
            (jstream, dict(cfg=_jcfg()))]
    if first == "jax":
        runs.reverse()
    for (mod, kw), max_chunks in zip(runs, (1, None)):
        n = mod.stream_magnify_resumable(src, out, chunk_frames=2,
                                         checkpoint=ck, max_chunks=max_chunks,
                                         **kw)
        assert n == (2 if max_chunks else T)
        if max_chunks:
            assert set(np.load(ck).files) == {
                "prev_spec_re", "prev_spec_im", "prev_frame", "lp_fast",
                "lp_slow", "frame_idx"}
            assert int(jstate.load_state(ck).frame_idx) == 2
            assert tstate.load_state(ck, device="cpu").frame_idx == 2
    want = np.concatenate(list(tstream.stream_magnify(
        src, _tcfg(), chunk_frames=2, device=CPU)))
    got = np.load(out)
    assert psnr(got, want) > 70
    assert np.max(np.abs(got - want)) < 1e-4


def test_cli_npy_and_checkpoint(frames, tmp_path):
    inp, out = str(tmp_path / "in.npy"), str(tmp_path / "out.npy")
    np.save(inp, frames)
    assert main(["--input", inp, "--output", out, *FAST], device="cpu") == 0
    want = magnify_video(torch.from_numpy(frames), _tcfg())[0].numpy()
    np.testing.assert_array_equal(np.load(out), want)
    # --stream: whole output, then the resumable --checkpoint loop.
    out2, ck = str(tmp_path / "out2.npy"), str(tmp_path / "ck.npz")
    assert main(["--input", inp, "--output", out2, "--stream",
                 "--chunk-frames", "2", *FAST], device="cpu") == 0
    np.testing.assert_array_equal(np.load(out2), want)
    out3 = str(tmp_path / "out3.npy")
    assert main(["--input", inp, "--output", out3, "--stream",
                 "--chunk-frames", "2", "--checkpoint", ck, *FAST],
                device="cpu") == 0
    np.testing.assert_array_equal(np.load(out3), want)
    assert tstate.load_state(ck, device="cpu").frame_idx == T


def test_cli_pipe_loop(y4m_files, port_run, monkeypatch):
    """`--input - --stream --output -`: y4m on stdin, y4m on stdout with
    the source's frame rate, one 8-bit coding away from the magnified
    frames."""
    sink = io.BytesIO()
    with open(y4m_files["420jpeg"], "rb") as f:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(sink))
        rc = main(["--input", "-", "--stream", "--ingest", "u8",
                   "--chunk-frames", "2", "--output", "-",
                   "--output-layout", "planar_u8", *FAST], device="cpu")
        assert rc == 0
        data = sink.getvalue()
    assert data.startswith(b"YUV4MPEG2") and b"F60:1" in data[:80]
    got = np.stack(list(ty4m.read_y4m_stream(io.BytesIO(data), "<pipe>")))
    want = np.moveaxis(np.concatenate(port_run["planar_u8"]), 1, -1) / 255.0
    assert got.shape == want.shape == (T, H, W, 3)
    assert np.max(np.abs(got - want)) <= 3 / 255


def test_cli_refusals(tmp_path, capsys):
    out = str(tmp_path / "o.npy")
    inp = str(tmp_path / "in.npy")
    np.save(inp, np.zeros((2, H, W, 3), np.float32))
    # --demo, --trace and --debug-view are served.
    assert main(["--demo", "bar", "--output", out], device="cpu") == 0
    assert np.load(out).shape == (64, 128, 128, 3)
    assert main(["--input", inp, "--trace", str(tmp_path / "d"), "--output",
                 out], device="cpu") == 0
    assert len(os.listdir(tmp_path / "d")) == 1
    assert main(["--input", inp, "--debug-view", "phase", "--output", out],
                device="cpu") == 0
    assert np.load(out).shape == (2, H, W, 3)
    # Exactly one of --input / --demo; a stdin pipe needs --stream.
    for argv in (["--demo", "bar", "--input", inp], [], ["--input", "-"]):
        assert main(argv + ["--output", out], device="cpu") == 2
    assert "exactly one of --input / --demo" in capsys.readouterr().err
    # Without a card and without an explicit device the CLI refuses.
    if not torch.cuda.is_available():
        assert main(["--input", "x.npy", "--output", out]) == 1
    # The default config is served (the scan engine), and so is the mxu
    # backend: each equal to `magnify_video` on its config.
    assert main(["--input", inp, "--output", out], device="cpu") == 0
    assert np.load(out).shape == (2, H, W, 3)
    from pbmm_tpu_torch.cli import build_parser, config_from_args

    rng = np.random.default_rng(11)
    np.save(inp, rng.random((2, H, W, 3)).astype(np.float32))
    argv = ["--input", inp, "--output", out, "--fft-backend", "mxu"]
    assert main(argv, device="cpu") == 0
    cfg = config_from_args(build_parser().parse_args(argv))
    assert cfg.fft_backend == "mxu" and cfg.use_rfft
    want, _ = magnify_video(torch.from_numpy(np.load(inp)), cfg)
    np.testing.assert_array_equal(np.load(out), want.numpy())
