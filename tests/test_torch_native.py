"""The port's native `.npy` frame loader (`pbmm_tpu_torch/native/`) on
the CPU: the cases of `tests/test_native.py` against the port's own
binding (f32 round trip, uint8 normalisation, a bad file rejected,
`convert_u8_frames`, the stream equal to `magnify_video`), the raw mode
(the file's bytes, unconverted), and the stream's native route:
`_open_chunk_source` on a `.npy` handing out the tensors `frame_chunks`
(the memmap) does, in uint8 and f32, and equal bit for bit for magnified
output on the batched and the scan engine; `stream_magnify_resumable`
stopped after one chunk and resumed, bit for bit; the loader closed when
the stream ends, stops early or fails; the library built under
`build/pbmm_tpu_torch/`, nothing written beside the source.  Skipped
only where `native_available()` is False (no `g++`), as the JAX tests
are, decided when the first test runs."""

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.core.color import unit_float
from pbmm_tpu_torch.io import stream as tstream
from pbmm_tpu_torch import native as tnative
from pbmm_tpu_torch.native import (
    NativeFrameLoader,
    convert_u8_frames,
    native_available,
)
from pbmm_tpu_torch.oracle.synthetic import oscillating_gaussian_blob

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _needs_native():
    """Builds the loader at the module's first test (never at import) and
    skips the module where it cannot be built."""
    if not native_available():
        pytest.skip("no native toolchain (g++)")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    """A 9-frame 64x96 clip of noise shifted a pixel a frame, as uint8
    and as its f32 twin (u8 / 255)."""
    base = np.random.default_rng(5).integers(0, 256, (64, 96, 3), np.uint8)
    u8 = np.stack([np.roll(base, i, axis=1) for i in range(9)])
    d = tmp_path_factory.mktemp("npy")
    paths = {"u8": str(d / "u8.npy"), "f32": str(d / "f32.npy")}
    np.save(paths["u8"], u8)
    np.save(paths["f32"], u8 * np.float32(1.0 / 255.0))
    return paths


def test_loader_f32_roundtrip(tmp_path, rng):
    frames = rng.random((10, 6, 8, 3)).astype(np.float32)
    p = tmp_path / "v.npy"
    np.save(p, frames)
    with NativeFrameLoader(str(p), chunk_frames=4) as ld:
        assert ld.num_frames == 10
        assert ld.shape == (6, 8, 3)
        chunks = list(ld)
    assert [c.shape[0] for c in chunks] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), frames)


def test_loader_u8_normalizes(tmp_path, rng):
    """uint8 frames come out as x * (1.0f / 255.0f): the bits
    `core.color.unit_float` gives on the device."""
    frames = (rng.random((5, 4, 4, 3)) * 255).astype(np.uint8)
    p = tmp_path / "v8.npy"
    np.save(p, frames)
    with NativeFrameLoader(str(p), chunk_frames=2) as ld:
        got = np.concatenate(list(ld))
    np.testing.assert_allclose(got, frames.astype(np.float32) / 255.0,
                               atol=1e-7)
    np.testing.assert_array_equal(
        got, unit_float(torch.from_numpy(frames)).numpy())


@pytest.mark.parametrize("bad", ["rank", "channels", "dtype", "fortran",
                                 "missing", "chunk_frames"])
def test_loader_rejects_bad_file(tmp_path, bad):
    p = str(tmp_path / "bad.npy")
    if bad == "chunk_frames":
        np.save(p, np.zeros((2, 4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="chunk_frames"):
            NativeFrameLoader(p, chunk_frames=0)
        return
    if bad == "rank":
        np.save(p, np.zeros((4, 4)))
    elif bad == "channels":
        np.save(p, np.zeros((2, 4, 4, 4), np.float32))
    elif bad == "dtype":
        np.save(p, np.zeros((2, 4, 4, 3), np.float64))
    elif bad == "fortran":
        np.save(p, np.asfortranarray(np.zeros((2, 4, 4, 3), np.float32)))
    with pytest.raises(ValueError):
        NativeFrameLoader(p)


def test_convert_u8(rng):
    x = (rng.random((3, 5, 5, 3)) * 255).astype(np.uint8)
    got = convert_u8_frames(x)
    np.testing.assert_allclose(got, x.astype(np.float32) / 255.0, atol=1e-7)
    np.testing.assert_array_equal(got, unit_float(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_loader_raw_mode(npy_files, dtype):
    """A loader opened with `raw=True` serves the file's bytes in its own
    dtype from `next_view`, as views of its two ring tensors in turn,
    each lent until the next call; a loader of either mode refuses the
    other's calls."""
    want = np.load(npy_files[dtype])
    with NativeFrameLoader(npy_files[dtype], chunk_frames=4, raw=True) as ld:
        assert ld.dtype == want.dtype
        views = []
        while (v := ld.next_view()) is not None:
            assert v.numpy().dtype == want.dtype
            np.testing.assert_array_equal(v.numpy(),
                                          want[4 * len(views):][:4])
            views.append(v)
        assert ld.next_view() is None  # still the end
        rings = [r.data_ptr() for r in ld._ring]
        assert [v.data_ptr() for v in views] == [rings[0], rings[1],
                                                 rings[0]]
        assert [v.shape[0] for v in views] == [4, 4, 1]
        assert ld._lib.fl_next(ld._h, None) < 0
        with pytest.raises(ValueError, match="next_view"):
            next(iter(ld))
    with NativeFrameLoader(npy_files[dtype], chunk_frames=4) as ld:
        with pytest.raises(ValueError, match="raw=True"):
            ld.next_view()
        slot = ctypes.c_int()
        assert ld._lib.fl_next_raw(ld._h, slot) < 0
        assert ld._lib.fl_start_raw(ld._h, 1, 1) < 0


def test_stream_magnify_equals_whole(tmp_path):
    clip = oscillating_gaussian_blob(height=32, width=32, frames=9)
    p = tmp_path / "clip.npy"
    np.save(p, clip)
    cfg = MagnifyConfig()
    streamed = np.concatenate(list(tstream.stream_magnify(
        str(p), cfg, chunk_frames=4, device=CPU)))
    whole, _ = magnify_video(torch.from_numpy(clip), cfg)
    np.testing.assert_allclose(streamed, whole.numpy(), atol=1e-5)


def _cfgs():
    return {"batched": MagnifyConfig(phase_scale=10.0).tuned_for_tpu(),
            "scan": MagnifyConfig(phase_scale=10.0),
            "mxu": MagnifyConfig(phase_scale=10.0, fft_backend="mxu")}


@pytest.mark.parametrize("engine", ["batched", "scan", "mxu"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_native_route_equals_memmap(npy_files, dtype, engine):
    """`_open_chunk_source` takes the native loader for a .npy (it serves
    every chunk) and hands out the memmap's tensors (`frame_chunks`:
    uint8 unscaled, scaled on the device); magnified with the state
    threaded they agree bit for bit, and `stream_magnify` equals both and
    `magnify_video` on the whole clip."""
    path, cfg = npy_files[dtype], _cfgs()[engine]
    NativeFrameLoader.served = 0
    outs, chunks = {}, {}
    for name, src in (("native", tstream._open_chunk_source(path, 4,
                                                            device=CPU)),
                      ("memmap", tstream.frame_chunks(path, 4, device=CPU))):
        got, st, chunks[name] = [], None, list(src)
        for c in chunks[name]:
            o, st = magnify_video(c, cfg, st)
            got.append(o.numpy())
        outs[name] = np.concatenate(got)
    assert NativeFrameLoader.served == 3
    for a, b in zip(chunks["native"], chunks["memmap"], strict=True):
        assert a.dtype == b.dtype == (torch.uint8 if dtype == "u8"
                                      else torch.float32)
        assert torch.equal(a, b)
    np.testing.assert_array_equal(outs["native"], outs["memmap"])
    NativeFrameLoader.served = 0
    streamed = np.concatenate(list(tstream.stream_magnify(
        path, cfg, chunk_frames=4, device=CPU)))
    assert NativeFrameLoader.served == 3
    np.testing.assert_array_equal(streamed, outs["memmap"])
    whole, _ = magnify_video(torch.from_numpy(np.load(path)), cfg)
    np.testing.assert_array_equal(streamed, whole.numpy())


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_resumable_stop_and_resume(npy_files, tmp_path, dtype, monkeypatch):
    """`stream_magnify_resumable` through the native loader, stopped after
    one chunk and resumed from its checkpoint (the completed chunk read
    and dropped: the loader has no seek), equals an uninterrupted run bit
    for bit, and so does the memmap route (no `g++`)."""
    path, cfg = npy_files[dtype], _cfgs()["batched"]
    kw = dict(chunk_frames=4, device=CPU)
    whole = str(tmp_path / "whole.npy")
    NativeFrameLoader.served = 0
    assert tstream.stream_magnify_resumable(path, whole, cfg, **kw) == 9
    assert NativeFrameLoader.served == 3
    out, ck = str(tmp_path / "o.npy"), str(tmp_path / "ck.npz")
    assert tstream.stream_magnify_resumable(path, out, cfg, checkpoint=ck,
                                            max_chunks=1, **kw) == 4
    assert tstream.stream_magnify_resumable(path, out, cfg, checkpoint=ck,
                                            **kw) == 9
    np.testing.assert_array_equal(np.load(out), np.load(whole))
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    NativeFrameLoader.served = 0
    mm = str(tmp_path / "mm.npy")
    assert tstream.stream_magnify_resumable(path, mm, cfg, **kw) == 9
    assert NativeFrameLoader.served == 0
    np.testing.assert_array_equal(np.load(mm), np.load(whole))


@pytest.mark.parametrize("how", ["end", "break", "error"])
def test_stream_closes_the_loader(npy_files, monkeypatch, how):
    """The loader is closed when the stream ends, when its consumer stops
    early and when magnification fails."""
    closed = []
    close = NativeFrameLoader.close

    def spy(self):
        closed.append(self._h is not None)
        close(self)

    monkeypatch.setattr(NativeFrameLoader, "close", spy)
    cfg = _cfgs()["batched"]
    gen = tstream.stream_magnify(npy_files["u8"], cfg, chunk_frames=4,
                                 device=CPU)
    if how == "end":
        assert len(list(gen)) == 3
    elif how == "break":
        next(gen)
        gen.close()
    else:
        def boom(*a, **k):
            raise RuntimeError("planted")

        monkeypatch.setattr(tstream, "magnify_video", boom)
        with pytest.raises(RuntimeError, match="planted"):
            next(gen)
    assert closed and closed[0]


def test_fallback_and_build_location(npy_files, monkeypatch):
    """Without `g++` the .npy goes through the memmap (uint8 unscaled),
    as do files the loader rejects; the library lives in the port's build
    directory, and nothing but the sources sits beside them."""
    NativeFrameLoader.served = 0
    src = tstream._open_chunk_source(npy_files["u8"], 4, device=CPU)
    next(src)
    src.close()
    assert NativeFrameLoader.served == 1
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    chunks = list(tstream._open_chunk_source(npy_files["u8"], 4, device=CPU))
    assert chunks[0].dtype == torch.uint8
    assert NativeFrameLoader.served == 1
    monkeypatch.undo()
    lib = tnative.library_path()
    repo = Path(tnative.__file__).resolve().parents[2]
    assert lib.exists() and lib.parent == repo / "build" / "pbmm_tpu_torch"
    here = sorted(f for f in os.listdir(os.path.dirname(tnative.__file__))
                  if f != "__pycache__")
    assert here == ["__init__.py", "frameloader.cpp"]
