"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes and branches `chip_smoke.py` does not reach.  Covered here:
- the 320x384 clip geometry (four-step m = 3, 3 of 4 lane tiles kept);
- 720p's column height (m = 6);
- the full-width lane layout (keep_half=False, no Hermitian rebuild);
- a content slab offset inside the padded column;
- the whole main path on the card against the CPU path.

Marked `cuda`; every test skips without a CUDA card.  This file imports
neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: spectra to max error / max magnitude < 1e-4, images to max
abs < 1e-4 (the bars of chip_smoke.py and tests/test_tight.py)."""

import numpy as np
import pytest
import torch

from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.engine.pipeline import blur_row_window
from pbmm_tpu_torch.spectral import fused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def _cfg():
    return MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight")


def _rand(rng, shape, dev, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _rel(got, want):
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return num / max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize("hc,pad_h,row0,w,keep", [
    (384, 384, 0, 512, True),
    (384, 384, 0, 512, False),
    (256, 384, 64, 256, False),
    (64, 1152, 1024, 2048, True),
])
def test_row_fft_kernel(dev, hc, pad_h, row0, w, keep):
    y = torch.rand((3, hc, w), generator=torch.Generator().manual_seed(0))
    y = y.to(dev)
    got = fused.windowed_row_fft(y, pad_h, row0, keep)
    want = fused.windowed_row_fft_ref(y, pad_h, row0, keep)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("pad_h,w,hc,row0,rows", [
    (384, 512, 384, 0, (0, 384)),
    (384, 512, 256, 64, (64, 320)),
    (768, 2048, 768, 0, (0, 768)),
    (384, 256, 384, 0, (128, 256)),
])
def test_colspec_kernel(dev, pad_h, w, hc, row0, rows):
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(3)
    args = [_rand(rng, (4, hc, wk), dev), _rand(rng, (4, hc, wk), dev),
            _rand(rng, (1, pad_h, wk), dev), _rand(rng, (1, pad_h, wk), dev)]
    kw = dict(out_rows=rows, full_w=w)
    got = fused.colspec_chunk(*args, _cfg(), pad_h, row0, **kw)
    want = fused.colspec_chunk_ref(*args, _cfg(), pad_h, row0, **kw)
    assert _rel(got[:2], want[:2]) < 1e-4
    assert _rel(got[2:], want[2:]) < 1e-4


@pytest.mark.parametrize("in_h,in_w,keep", [
    (320, 384, True), (320, 384, False), (1080, 1920, True)])
def test_post_kernel(dev, in_h, in_w, keep):
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, _cfg())
    wk = hermitian_kept_width(g.pad_w) if keep else g.pad_w
    rng = np.random.default_rng(5)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    hr = rows[1] - rows[0]
    args = (_rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, hr, wk), dev, scale),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            _rand(rng, (2, in_h, in_w), dev, 0.3),
            hann2d_region(g, device=dev), _cfg(), rows[0], in_h, in_w,
            "tight")
    got = post_fused.rowifft_post_fused(*args, full_w=g.pad_w)
    want = post_fused.rowifft_post_fused_ref(*args, full_w=g.pad_w)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-4


def test_main_path_on_card_matches_cpu(dev):
    rng = np.random.default_rng(9)
    base = rng.random((320, 384, 3)).astype(np.float32)
    clip = np.stack([np.roll(base, i, axis=1) * (0.95 + 0.01 * i)
                     for i in range(5)]).astype(np.float32)
    counts = {f: f.launches for f in (fused.windowed_row_fft,
                                      fused.colspec_chunk,
                                      post_fused.rowifft_post_fused)}
    out_d, st_d = magnify_video(torch.from_numpy(clip).to(dev), _cfg())
    assert all(f.launches > n for f, n in counts.items())
    out_c, st_c = magnify_video(torch.from_numpy(clip), _cfg())
    mse = float(((out_d.cpu().double() - out_c.double()) ** 2).mean())
    assert mse == 0 or 10 * np.log10(1 / mse) > 100
    assert _rel([st_d.prev_spec_re.cpu()], [st_c.prev_spec_re]) < 1e-4
    o1, s1 = magnify_video(torch.from_numpy(clip[:2]).to(dev), _cfg())
    o2, _ = magnify_video(torch.from_numpy(clip[2:]).to(dev), _cfg(), s1)
    assert torch.equal(torch.cat([o1, o2]), out_d)
