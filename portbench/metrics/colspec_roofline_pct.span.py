"""colspec_roofline_pct.span: the column spectrum's share of its roofline
(`harness/roofline.py` "colspec", the bound of `colspec_roofline_pct`) over
the device time of the program's own span `pbmm.colspec` (its CUDA-event
pair, `engine/video.py::_chunk_colspec`), summed over the window's
recorded calls (one chunk in 16).  The span brackets the same
launches on the same stream as the harness's event pair of
`colspec_roofline_pct`, and that pair too (two timing events on the card).
Layer: column spectrum.  Moves frames_per_s."""

from portbench.harness import program_spans

program_spans.arm()


def read(run):
    return program_spans.stage_roofline_pct(run, "pbmm.colspec", "colspec")
