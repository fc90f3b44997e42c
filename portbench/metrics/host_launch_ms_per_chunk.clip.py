"""host_launch_ms_per_chunk.clip: the host's milliseconds inside the
kernel library's C calls in one call of the program, the sum of the
chunk's `pbmm.launch.<entry>` spans (`kernels/build.py::library`), the
median over the window's recorded chunks (one in 16).  Layer: kernel
library calls.  Moves frames_per_s where the host, not the card, paces
the chunks."""

from portbench.harness import program_spans

program_spans.arm()


def read(run):
    return program_spans.median_per_chunk(run, "launch_ms")
