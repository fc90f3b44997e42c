"""host_ms_per_chunk.clip: the host's milliseconds in one call of the
program's entry (`pbmm_tpu_torch.magnify_video`, which reaches
`engine/video.py::_chunk_colspec`), from call to return, the median over
the window's chunks.  Layer: entry and chunk engine.  Moves
frames_per_s where the host, not the card, paces the chunks."""

import statistics


def read(run):
    ms = run.host_ms()
    return statistics.median(ms) if ms else None
