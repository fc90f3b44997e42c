"""The port's copies of the fp64 numpy oracle and the synthetic clips
(`pbmm_tpu_torch/oracle/`) against the JAX package's modules: the same
inputs give equal arrays, bit for bit.  The card suite
(`tests/test_torch_cuda.py`) and the port hold their results against these
copies, so they must stay the JAX oracle."""

import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.oracle import reference as jref
from pbmm_tpu.oracle import synthetic as jsyn
from pbmm_tpu_torch.oracle import reference as tref
from pbmm_tpu_torch.oracle import synthetic as tsyn

# name -> config changes (the JAX config drives both copies)
CONFIGS = {
    "default": dict(),
    "standard": dict(mode="standard"),
    "steerable": dict(orientations=4),
    "rgb": dict(chroma="rgb"),
    "rect_pow2": dict(pad_mode="rect_pow2"),
}


@pytest.fixture(scope="module")
def clip():
    return jsyn.oscillating_bar(size=64, frames=3, bar_width=2)[:, :48]


@pytest.mark.parametrize("fn", ["oracle_magnify_pair",
                                "oracle_magnify_video",
                                "oracle_magnify_video_iir"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_oracle_copy_equals_jax(clip, name, fn):
    cfg = JCfg(**CONFIGS[name])
    if fn == "oracle_magnify_video_iir":
        cfg = cfg.replace(temporal=JTemporal(mode="iir_bandpass"))
    args = (clip[0], clip[1]) if fn == "oracle_magnify_pair" else (clip,)
    want = getattr(jref, fn)(*args, cfg)
    got = getattr(tref, fn)(*args, cfg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gen,kw", [
    ("oscillating_bar", dict()),
    ("oscillating_bar", dict(size=96, frames=5, bar_width=2)),
    ("single_tone_bar", dict()),
    ("oscillating_gaussian_blob", dict()),
], ids=["bar_default", "bar_small", "single_tone", "blob"])
def test_synthetic_copy_equals_jax(gen, kw):
    want = getattr(jsyn, gen)(**kw)
    got = getattr(tsyn, gen)(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
