"""The reference: the PyTorch float64 restatement equals the frozen
numpy oracle, and the program run on the CPU at a tiny size agrees with
it in both configurations, across chunk boundaries."""

import math

import numpy as np
import pytest
import torch

from portbench.harness import check, spec
from portbench.harness.stream import Kept
from portbench.reference import oracle_np
from portbench.reference.torch_ref import Reference


class _NS:
    def __init__(self, d):
        self.__dict__.update(d)


class _Temporal(_NS):
    def smoothing_factors(self):
        return (1 - math.exp(-2 * math.pi * self.high_hz / self.fps),
                1 - math.exp(-2 * math.pi * self.low_hz / self.fps))


def _oracle_cfg(cfg):
    ns = _NS(cfg)
    ns.temporal = _Temporal(cfg["temporal"])
    return ns


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (9, 3, 40, 70), dtype=np.uint8)


@pytest.mark.parametrize("name", ["ref1080", "evm1080_rgb_iir"])
def test_torch_reference_equals_the_oracle(name, frames):
    cfg = spec.config(name)["magnify"]
    f64 = frames.transpose(0, 2, 3, 1).astype(np.float64) / 255.0
    ref = Reference(cfg, 40, 70, "cpu")
    t = torch.from_numpy(frames)
    if cfg["temporal"]["mode"] == "iir_bandpass":
        got = ref.iir(t, keep=4).numpy()
        want = oracle_np.oracle_magnify_video_iir(f64, _oracle_cfg(cfg))[-4:]
    else:
        got = ref.two_frame(t[0], t[1:]).numpy()
        want = oracle_np.oracle_magnify_video(f64, _oracle_cfg(cfg))[1:]
    assert np.abs(got - want).max() < 1e-12


def test_iir_replay_bound():
    ref = Reference(spec.config("evm1080_rgb_iir")["magnify"], 40, 70, "cpu")
    n = ref.iir_replay_frames()
    assert 2 * math.pi * (1 - ref.r_lo) ** n <= 1e-12
    assert 2 * math.pi * (1 - ref.r_lo) ** (n - 1) > 1e-12


@pytest.mark.parametrize("name", ["ref1080", "evm1080_rgb_iir"])
def test_program_on_the_cpu_agrees_across_chunk_boundaries(name):
    from pbmm_tpu_torch import magnify_video
    from portbench.harness.cell import program_config
    from portbench.harness.inputs import make_ring

    cfg_file = spec.config(name)
    traffic = dict(spec.traffic("u8_clip16"), chunk_frames=4)
    content = dict(traffic["content"], bar_width=2.0, blob_sigma=6.0)
    ring = make_ring(11, 12, 72, 120, "u8_planar", content, "cpu")
    cfg = program_config(cfg_file, traffic)
    state = None
    kept = []
    for pos in range(0, 12, 4):
        out, state = magnify_video(ring[pos:pos + 4], cfg, state)
        if pos:
            kept.append(Kept(0, 0, pos, out))
    got = check.measure(kept, ring, cfg_file["magnify"], traffic, 72, 120,
                        "cpu")
    assert got["max_level_gap"] <= 1.0
    assert got["mismatch_pct"] < 0.5


def test_psnr_frames_is_psnr_per_frame():
    from portbench.reference.metrics import psnr, psnr_frames

    rng = np.random.default_rng(3)
    a = rng.random((3, 5, 7, 3))
    b = a + 1e-3 * rng.standard_normal(a.shape)
    b[1] = a[1]
    got = psnr_frames(torch.from_numpy(a), torch.from_numpy(b))
    assert got == [psnr(a[i], b[i]) for i in range(3)]
