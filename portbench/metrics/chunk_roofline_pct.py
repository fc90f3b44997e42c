"""chunk_roofline_pct: the whole chunk's share of its roofline, the
least time of the chunk's work from the cell's shapes (the frames read
once, the outputs written once, the carried spectrum and taps read and
written once, the transforms' f32 operations; the larger bound,
`harness/roofline.py::ChunkWork.chunk`) over the chunk's device time
(the CUDA-event pair around each call of `pbmm_tpu_torch.magnify_video`),
summed over the window's chunks.  It reads the same work whatever
implements it.  Layer: the whole chunk.  Moves frames_per_s."""


def read(run):
    ms = run.chunk_device_ms()
    if not ms:
        return None
    return 100.0 * run.chunk_bound_ms() * len(ms) / sum(ms)
