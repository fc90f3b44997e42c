"""Streaming magnification: chunked sources, state threaded.

Counterpart of `pbmm_tpu/io/stream.py`.  Chunks of a file or a pipe go
through `magnify_video` one at a time with the `VideoState` threaded
across them, so device memory stays flat for arbitrarily long videos.
Every function takes an explicit `device`: chunks are moved there before
any arithmetic, and y4m sources cross as their raw uint8 planes, which
`io.device_decode` turns into RGB on the device.

`stream_magnify_resumable` adds the failure-recovery loop: output frames
land incrementally in a preallocated .npy and the `VideoState`
checkpoint is written atomically after every chunk, so a killed run
restarts with the same command line and resumes from the last completed
chunk, bit-identically to an uninterrupted run.  Checkpoints are the
JAX package's .npz files (`engine.state`).

`stream_magnify` and the resumable loop read .npy inputs through the
native prefetch loader (`pbmm_tpu_torch.native`: a host thread reads the
next chunk while the card magnifies this one), as the JAX package does,
and close it when they finish or fail; without `g++`, and for files the
loader rejects, through a memmap.  The loader runs in its raw mode: it
reads each chunk, in the file's dtype, into a pinned ring slot that
crosses from there, so uint8 crosses unscaled and `magnify_video` scales
it on the device, as on the memmap.  Both routes hand `magnify_video`
the same tensors.  `frame_chunks` stays on the memmap.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Optional

import numpy as np
import torch

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.engine.video import VideoState, magnify_video


def _batch_frames(frame_iter, chunk_frames: int) -> Iterator[np.ndarray]:
    """Group a frame iterator into (n, H, W, 3) f32 chunks; memory is
    bounded by one chunk."""
    batch = []
    for fr in frame_iter:
        batch.append(np.asarray(fr, np.float32))
        if len(batch) == chunk_frames:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def _chunks_memmap_npy(path: str, chunk_frames: int) -> Iterator[np.ndarray]:
    """Chunk a .npy file through a memmap: only one chunk of pixel data is
    resident at a time.  uint8 passes through unscaled: `magnify_video`
    scales it on the device, so 8-bit sources cross at a quarter of the
    f32 bytes."""
    mm = np.load(path, mmap_mode="r")
    for i in range(0, mm.shape[0], chunk_frames):
        chunk = np.array(mm[i:i + chunk_frames])  # a writable host copy
        yield chunk if chunk.dtype == np.uint8 else chunk.astype(np.float32)


def _chunks_whole(path: str, chunk_frames: int) -> Iterator[np.ndarray]:
    from pbmm_tpu_torch.io.video import load_video

    frames = load_video(path)
    for i in range(0, len(frames), chunk_frames):
        yield frames[i:i + chunk_frames]


def frame_chunks(path: str, chunk_frames: int, *,
                 device) -> Iterator[torch.Tensor]:
    """Bounded-memory chunk source on `device`, decoded on the host:

    - "-": y4m from stdin (a pipe, e.g. `ffmpeg ... -f yuv4mpegpipe - |`);
    - .y4m: frame-at-a-time iterator (`io.y4m.read_y4m_stream`);
    - .npy: memmap slices (uint8 or f32 on disk);
    - anything else: the whole file (the container requires it)."""
    lower = path.lower()
    if path == "-":
        from pbmm_tpu_torch.io.y4m import read_y4m_stream

        host = _batch_frames(read_y4m_stream(sys.stdin.buffer, "<stdin>"),
                             chunk_frames)
    elif lower.endswith(".y4m"):
        from pbmm_tpu_torch.io.y4m import read_y4m_frames

        host = _batch_frames(read_y4m_frames(path), chunk_frames)
    elif lower.endswith(".npy"):
        host = _chunks_memmap_npy(path, chunk_frames)
    else:
        host = _chunks_whole(path, chunk_frames)
    for chunk in host:
        yield torch.from_numpy(np.ascontiguousarray(chunk)).to(device)


def _y4m_device_chunks(plane_iter, chunk_frames: int, planar_u8: bool = False,
                       *, device) -> Iterator[torch.Tensor]:
    """Batch raw uint8 y4m planes, move them to `device` and decode there
    (`io.device_decode`): (T, H, W, 3) f32 RGB, or with `planar_u8`
    (`--ingest u8`) (T, 3, H, W) uint8 RGB, the layout kernels 4 and 3
    read (one 8-bit rounding of the f32 decode)."""
    from pbmm_tpu_torch.io.device_decode import (
        ycbcr_planes_to_rgb,
        ycbcr_planes_to_rgb_planar_u8,
    )

    fn = ycbcr_planes_to_rgb_planar_u8 if planar_u8 else ycbcr_planes_to_rgb

    def decode(batch):
        y, cb, cr = (torch.from_numpy(np.stack([b[k] for b in batch])).to(
            device) for k in range(3))
        h, w = y.shape[1:]
        return fn(y, cb, cr, h, w)

    batch = []
    for planes in plane_iter:
        batch.append(planes)
        if len(batch) == chunk_frames:
            yield decode(batch)
            batch = []
    if batch:
        yield decode(batch)


def _loader_chunks(loader, device) -> Iterator[torch.Tensor]:
    """A raw-mode native loader's chunks on `device`, in the file's dtype,
    each copied out of the ring slot the loader lends (pinned memory for
    a card: the copy is done when `to` returns).  The loader closes when
    the iterator ends, fails or is closed."""
    try:
        on_cpu = torch.device(device).type == "cpu"
        while (view := loader.next_view()) is not None:
            yield view.clone() if on_cpu else view.to(device)
    finally:
        loader.close()


def _open_chunk_source(path: str, chunk_frames: int, planar_u8: bool = False,
                       meta: dict = None, *, device):
    """The chunk iterator of `path` on `device`: the native prefetch
    loader for .npy files it accepts (while `g++` is there), device-side
    YCbCr decode for y4m sources (file or stdin pipe), else
    `frame_chunks`.  Close the iterator to release the loader early."""
    from pbmm_tpu_torch.io.y4m import read_y4m_planes

    if path != "-" and path.lower().endswith(".npy"):
        from pbmm_tpu_torch.native import NativeFrameLoader, native_available

        if native_available():
            try:
                loader = NativeFrameLoader(
                    path, chunk_frames, raw=True,
                    pin_memory=torch.device(device).type == "cuda")
            except ValueError:
                pass  # not THWC u8/f32 C-order: the memmap reads it
            else:
                return _loader_chunks(loader, device)
    if path == "-":
        return _y4m_device_chunks(
            read_y4m_planes(sys.stdin.buffer, "<stdin>", meta=meta),
            chunk_frames, planar_u8, device=device)
    if path.lower().endswith(".y4m"):
        def _file_planes():
            with open(path, "rb") as f:
                yield from read_y4m_planes(f, path, meta=meta)

        return _y4m_device_chunks(_file_planes(), chunk_frames, planar_u8,
                                  device=device)
    return frame_chunks(path, chunk_frames, device=device)


def stream_magnify(path: str, cfg: MagnifyConfig, chunk_frames: int = 8,
                   state: Optional[VideoState] = None, ingest: str = "f32",
                   meta: dict = None, *, device) -> Iterator[np.ndarray]:
    """Yield magnified chunks as host arrays (layout per
    `cfg.output_layout`), the frames magnified on `device`.

    Memory stays flat for long videos: .npy inputs stream through the
    native prefetch loader (or a memmap), .y4m inputs through the
    frame-at-a-time parser, and `path="-"` reads a y4m stream from
    stdin.  ingest="u8": y4m sources decode to planar uint8 RGB on the
    device, feeding kernels 4 and 3 (one 8-bit rounding against the f32
    decode)."""
    chunks = _open_chunk_source(path, chunk_frames,
                                planar_u8=(ingest == "u8"), meta=meta,
                                device=device)
    try:
        for chunk in chunks:
            out, state = magnify_video(chunk, cfg, state=state)
            yield out.cpu().numpy()
    finally:
        chunks.close()


def stream_magnify_resumable(input_path: str, output_path: str,
                             cfg: MagnifyConfig, chunk_frames: int = 8,
                             checkpoint: str = "",
                             max_chunks: Optional[int] = None,
                             ingest: str = "f32", *, device) -> int:
    """Stream `input_path` -> magnified `output_path` (.npy) on `device`,
    checkpointing after every chunk so a killed run resumes exactly where
    it stopped.

    Protocol per chunk: write the magnified frames into the preallocated
    output memmap, flush, then atomically replace the checkpoint (state +
    frame_idx).  A crash between those two steps only re-runs one chunk
    on resume — frames are rewritten with identical values, never skipped
    or duplicated.  Resume requires the same `chunk_frames` (checkpoints
    land on chunk boundaries).

    `max_chunks` is the fault-injection hook: stop (as a kill would)
    after that many chunks.  Returns the number of frames completed in
    total."""
    from pbmm_tpu_torch.engine.state import load_state, save_state
    from pbmm_tpu_torch.io.video import video_shape

    if input_path == "-":
        raise ValueError("resumable streaming needs a re-readable input "
                         "file (resume re-reads completed chunks); pipe "
                         "input works with the non-checkpointed --stream")
    if not output_path.endswith(".npy"):
        raise ValueError("resumable streaming writes incremental .npy "
                         f"output, got {output_path!r}")
    t, h, w, c = video_shape(input_path)
    if cfg.output_layout == "interleaved":
        out_shape, out_dtype = (t, h, w, c), np.float32
    else:
        out_shape = (t, c, h, w)
        out_dtype = (np.uint8 if cfg.output_layout == "planar_u8"
                     else np.float32)

    start = 0
    state: Optional[VideoState] = None
    if checkpoint and os.path.exists(checkpoint):
        state = load_state(checkpoint, device)
        start = state.frame_idx
        if start % chunk_frames != 0 and start < t:
            raise ValueError(
                f"checkpoint frame_idx={start} is not a multiple of "
                f"chunk_frames={chunk_frames}; resume with the original "
                "chunk size")

    if os.path.exists(output_path) and start > 0:
        out_mm = np.lib.format.open_memmap(output_path, mode="r+")
        if out_mm.shape != out_shape or out_mm.dtype != out_dtype:
            raise ValueError(
                f"existing output {output_path!r} has "
                f"{out_mm.dtype}{out_mm.shape}, expected "
                f"{np.dtype(out_dtype).name}{out_shape}")
    else:
        out_mm = np.lib.format.open_memmap(
            output_path, mode="w+", dtype=out_dtype, shape=out_shape)
        start = 0
        state = None

    pos = start
    done_chunks = 0
    for chunk_out, state in _resume_chunks(input_path, cfg, chunk_frames,
                                           start, state, ingest,
                                           device=device):
        n = chunk_out.shape[0]
        out_mm[pos:pos + n] = chunk_out
        out_mm.flush()
        pos += n
        if checkpoint:
            save_state(state, checkpoint)
        done_chunks += 1
        if max_chunks is not None and done_chunks >= max_chunks:
            break
    return pos


def _resume_chunks(input_path: str, cfg: MagnifyConfig, chunk_frames: int,
                   skip_frames: int, state: Optional[VideoState],
                   ingest: str = "f32", *, device) -> Iterator[tuple]:
    """Yield (magnified chunk as a host array, new state) starting at
    frame `skip_frames`.  The native loader has no seek, so completed
    chunks are read and discarded (decode only, no magnification), as on
    every other source."""
    seen = 0
    chunks = _open_chunk_source(input_path, chunk_frames,
                                planar_u8=(ingest == "u8"), device=device)
    try:
        for chunk in chunks:
            n = chunk.shape[0]
            seen += n
            if seen <= skip_frames:
                continue
            out, state = magnify_video(chunk, cfg, state=state)
            yield out.cpu().numpy(), state
    finally:
        chunks.close()
