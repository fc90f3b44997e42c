"""Carry the chunk-boundary state across the two packages.

The spectrum carried from one chunk to the next is this system's only
state (it has no weights).  The port keeps the JAX package's `VideoState`
leaves in the same layout and shapes — four-step rows x kept bit-reversed
lanes, `prev_spec_*` (1, 1152, 1152) at 1080p tight; the rfft or centred
layout of the xla backend; with `cache_prev_spectrum=False` the previous
frame (H, W, 3) and empty spectra — so a stream started by one package
resumes in the other, on either engine, and states compare element by
element.  The numpy side uses the keys of the JAX package's checkpoint
files, and `save_state` / `load_state` read and write those .npz files
(`pbmm_tpu/engine/state.py`), so a checkpoint written by either package
resumes in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pbmm_tpu_torch.engine.pipeline import default_device
from pbmm_tpu_torch.engine.video import VideoState
from pbmm_tpu_torch.phase.temporal import TemporalState


def state_to_numpy(state: VideoState) -> dict:
    """The state as numpy arrays under the checkpoint keys."""
    def arr(x):
        return x.detach().to("cpu").numpy().astype(np.float32, copy=True)

    return {
        "prev_spec_re": arr(state.prev_spec_re),
        "prev_spec_im": arr(state.prev_spec_im),
        "prev_frame": arr(state.prev_frame),
        "lp_fast": arr(state.temporal.lp_fast),
        "lp_slow": arr(state.temporal.lp_slow),
        "frame_idx": np.asarray(int(state.frame_idx), np.int32),
    }


def state_from_numpy(state, device=None) -> VideoState:
    """A port `VideoState` on `device` (default: the first CUDA card;
    pass "cpu" to keep it on the CPU) from either a dict under the
    checkpoint keys or a `VideoState` of the JAX package (any leaves
    numpy can read)."""
    device = device if device is not None else default_device()
    if isinstance(state, dict):
        leaves = dict(state)
    else:
        leaves = {
            "prev_spec_re": state.prev_spec_re,
            "prev_spec_im": state.prev_spec_im,
            "prev_frame": state.prev_frame,
            "lp_fast": state.temporal.lp_fast,
            "lp_slow": state.temporal.lp_slow,
            "frame_idx": state.frame_idx,
        }

    def ten(key):
        a = np.ascontiguousarray(np.asarray(leaves[key]), np.float32)
        return torch.from_numpy(a.copy()).to(device)

    return VideoState(
        ten("prev_spec_re"), ten("prev_spec_im"), ten("prev_frame"),
        TemporalState(ten("lp_fast"), ten("lp_slow")),
        int(np.asarray(leaves["frame_idx"])),
    )


def save_state(state: VideoState, path: str) -> None:
    """Write the state as a checkpoint .npz, atomically: a kill mid-save
    leaves the previous complete checkpoint in place (the resume loop
    depends on this)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state_to_numpy(state))
    os.replace(tmp, path)


def load_state(path: str, device=None) -> VideoState:
    """A checkpoint .npz (of either package) as a `VideoState` on
    `device` (default: the first CUDA card)."""
    with np.load(path) as z:
        return state_from_numpy({k: z[k] for k in z.files}, device)
