"""The cameras mix's schedule: the same due times for the same seed,
phases evenly staggered over the period, jitter within its bound."""

import numpy as np

from portbench.harness import spec
from portbench.kinds import cameras


def _traffic(n=12):
    return dict(spec.traffic("u8_cams8"), cameras=n)


def test_same_seed_same_schedule():
    a = cameras.schedule(_traffic(), 2**31 + 7, 3.0)
    b = cameras.schedule(_traffic(), 2**31 + 7, 3.0)
    c = cameras.schedule(_traffic(), 2**31 + 8, 3.0)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_stagger_and_jitter():
    tr = _traffic(12)
    period = tr["chunk_frames"] / tr["fps"]
    jit = tr["jitter_ms"] / 1e3
    due, cam, j = cameras.schedule(tr, 3, 5.0)
    assert np.all(np.diff(due) >= 0) and due.min() >= 0 and due.max() < 5.0
    nominal = jit + period * (cam / 12 + j)
    u = due - nominal
    assert np.all(np.abs(u) <= jit * (1 + 1e-9))
    assert np.abs(u).max() > 0.9 * jit


def test_every_seed_deals_the_same_jitters():
    """Every jitter is a point of one fixed grid, each used once: the
    seed changes only which chunk gets which."""
    tr = _traffic(12)
    jit = tr["jitter_ms"] / 1e3
    period = tr["chunk_frames"] / tr["fps"]
    seconds = 5.0
    per_cam = int(np.ceil(seconds / period)) + 1
    grid = np.linspace(-jit, jit, 12 * per_cam)
    step = grid[1] - grid[0]
    used = []
    for seed in (1, 2**31 + 5):
        due, cam, j = cameras.schedule(tr, seed, seconds)
        u = due - (jit + period * (cam / 12 + j))
        k = np.rint((u - grid[0]) / step).astype(int)
        assert np.allclose(grid[k], u, atol=1e-9)
        assert len(set(k.tolist())) == len(k)
        used.append(k)
    assert not np.array_equal(used[0], used[1])


def test_offsets_cover_the_ring_in_whole_chunks():
    tr = _traffic(40)
    offs = cameras.offsets(tr, tr["ring_frames"])
    assert all(o % tr["chunk_frames"] == 0 for o in offs)
    assert len(set(offs)) == tr["ring_frames"] // tr["chunk_frames"]
