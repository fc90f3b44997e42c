"""host_glue_ms_per_chunk.clip: the host's milliseconds in one call of
the program outside the kernel library's C calls: the span `pbmm.chunk`
(`engine/video.py::magnify_video`) less its `pbmm.launch.<entry>` spans
and less the recorder's own time inside it (`Span.overhead_ns`):
routing, device tables, allocations, argument packing; the median over
the window's recorded chunks (one in 16).  Layer: entry and chunk
engine.  Moves frames_per_s where the host, not the card, paces the
chunks."""

from portbench.harness import program_spans

program_spans.arm()


def read(run):
    return program_spans.median_per_chunk(run, "glue_ms")
