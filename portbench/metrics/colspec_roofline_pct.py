"""colspec_roofline_pct: kernel 2's share of its roofline, the least
time of its work at its boundary (the row spectra read once, the output
rows written once, the carried spectrum and IIR taps read and written
once a chunk; `harness/roofline.py` "colspec") over its device time,
summed over the window's calls.  The device time is the CUDA-event pair
around each call of `colspec_chunk` as `engine/video.py::_chunk_colspec`
looks it up (`spectral/fused.py::colspec_chunk`).  Layer: column
spectrum.  Moves frames_per_s."""

ENTRY = "pbmm_tpu_torch.engine.video:colspec_chunk"
STAGE = "colspec"


def read(run):
    ms = run.entry_device_ms(ENTRY)
    if not ms:
        return None
    return 100.0 * run.stage_bound_ms(STAGE) * len(ms) / sum(ms)
