"""Diagnostics of the port, counterparts of `pbmm_tpu/tools/` and of the
JAX package's `benchmarks/` scripts, one module per file of the same name:

    tools/parity.py          the port against the fp64 numpy oracle
    tools/kexp.py            per-kernel timing, warm and cold, and the copy
                             probe of each access pattern (kernel 13)
    tools/kdecomp.py         kernel 6's time split into its pieces (kernel 12)
    tools/trig_probe.py      the phase pass's transcendentals (kernel 14)
    tools/roofline.py        bytes and FLOPs per stage against the H100's peaks
    tools/profile_stages.py  per-stage time of the per-frame pipeline
    tools/post_times.py      the y_only tail's two routes: kernel 3, kernels 7 + 10
    tools/multihost.py       the sharded engines in worlds of several processes

Each `main()` measures the card and exits non-zero without one (but
multihost's, whose ranks run on the CPU with `--device cpu`); the byte
counts and the plain versions underneath run on CPU tensors too."""

from __future__ import annotations

import sys


def require_card(prog: str):
    """The first CUDA card; exits with a message when there is none (a
    diagnostic never falls back to the CPU)."""
    import torch

    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA card: this tool measures the GPU and does "
              "not run on the CPU", file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda", 0)
