"""`correct` on whole runs driven on the CPU at a tiny size, past the
harness's look for a card: true for the program as it is; false for the
control (the reference in bfloat16 put in the program's place) and for
the program broken underneath in each way a cell can break.  A cell
runs on one card, so it has no exchange between cards to leave out.
The limits are the cells' own (`limits/<cell>.json`)."""

import pytest
import torch

from pbmm_tpu_torch import magnify_video
from tiny import CELLS, run_tiny


def stale_state(frames, cfg, state=None):
    """A step that returns its state unchanged."""
    out, new = magnify_video(frames, cfg, state)
    return out, new if state is None else state


def half_batch(frames, cfg, state=None):
    """Half of the chunk left out: its frames get the mean of the rest."""
    half = frames.shape[0] // 2
    out, new = magnify_video(frames[:half], cfg, state)
    mean = out.to(torch.float32).mean(0, keepdim=True)
    rest = mean.expand((frames.shape[0] - half,) + tuple(out.shape[1:]))
    return torch.cat([out, rest.to(out.dtype)]), new


def altered_answer(frames, cfg, state=None):
    """An answer altered where it is produced: the chunk's last frame one
    level off."""
    out, new = magnify_video(frames, cfg, state)
    out = out.clone()
    if out.dtype == torch.uint8:
        out[-1] ^= 1
    else:
        out[-1] += 1.0 / 255.0
    return out, new


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    res, lines = run_tiny(cell)
    assert res["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res, lines = run_tiny(cell, control=torch.bfloat16)
    assert res["correct"], lines
    assert not res["control"]["correct"], res["control"]


@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res, lines = run_tiny(cell, magnify=fault)
    assert not res["correct"], lines
