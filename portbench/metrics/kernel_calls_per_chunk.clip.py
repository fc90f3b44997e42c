"""kernel_calls_per_chunk.clip: the kernel wrappers' launch calls a
chunk: over the window's recorded chunks (one in 16), the change of the
`.launches` counters' sum (`utils/profiling.py::launch_counts`) inside
each chunk's root span `pbmm.chunk`, which the recorder notes at the
span's start and end; their sum over the number of chunks.  A wrapper
counts one call however many launches its C entry makes (kernel 2's is
one).  Layer: kernel library calls.  Moves frames_per_s."""

from portbench.harness import program_spans

program_spans.arm()


def read(run):
    got = program_spans.of(run)
    return got.calls_per_chunk() if got is not None else None
