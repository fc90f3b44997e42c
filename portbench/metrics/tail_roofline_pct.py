"""tail_roofline_pct: the tail's share of its roofline, the least time
of its work at its boundary (the output rows read once, the source
frames' chroma read once where the y_only tail takes it, the output
written once in its layout; `harness/roofline.py` "tail") over its
device time, summed over the window's calls.  The device time is the
CUDA-event pair around each call of `_tail_block` as
`engine/video.py::_chunk_colspec` looks it up (kernel 3, or kernels 7
then 11 or 10, `engine/post_fused.py`).  Layer: tail.  Moves
frames_per_s."""

ENTRY = "pbmm_tpu_torch.engine.video:_tail_block"
STAGE = "tail"


def read(run):
    ms = run.entry_device_ms(ENTRY)
    if not ms:
        return None
    return 100.0 * run.stage_bound_ms(STAGE) * len(ms) / sum(ms)
