"""frontend_roofline_pct: the front end's share of its roofline, the
least time of its work at its boundary (the source frames read once, the
row spectra of the content rows written once; `harness/roofline.py`
"frontend") over its device time, summed over the window's calls.  The
device time is the CUDA-event pair around each call of `preprocess_cl`
as `engine/video.py::_chunk_colspec` looks it up (defined in
`engine/pipeline.py`; it launches `spectral/fused.py::
windowed_row_fft_frames`, kernel 4's kernel).  Layer: front end.  Moves
frames_per_s."""

ENTRY = "pbmm_tpu_torch.engine.video:preprocess_cl"
STAGE = "frontend"


def read(run):
    ms = run.entry_device_ms(ENTRY)
    if not ms:
        return None
    return 100.0 * run.stage_bound_ms(STAGE) * len(ms) / sum(ms)
