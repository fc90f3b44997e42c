"""Blur radii above the default, and padded heights above 2048, on the CPU.

- The port's `magnify_video` against the JAX package's (interpret mode)
  on the same numpy-seeded bar frames, at 96x384 (tight: 128x512, where
  `post_pallas_ok` holds for every radius below), in y_only f32, rgb and
  planar uint8 -> planar_u8, at `blur_size` 0.5, 0.75, 1.5 and 4.0 (blur
  radii 2, 3, 5 and 13): > 70 dB between the packages, the path bar of
  tests/test_fused.py.
- The predicate that routes the y_only tail on the card
  (`post_fused.kernel3_serves`): kernel 3 while its blocks keep 512
  threads on an SM (at the widest crops up to radius 11 at a padded
  width of 1024, 5 at 2048, 2 at 4096 and 8192), kernels 7 + 10 above;
  kernel 3's block still fits every pair it served before.
- Kernel 10's plain version with the uint8 chroma source against
  kernel 3's on the same rows.
- The port's plain `colspec_chunk_ref` against the JAX `colspec_chunk`
  (interpret) at the padded heights of 2160p: 4096 (square_pow2) and
  2176 = 17 x 128 (tight), and 4320p's tight 4352 = 34 x 128, 128 lanes,
  2 frames: spectra to max error / max magnitude < 1e-4, as
  tests/test_torch_kernels.py.  The JAX traces made at gm_precision
  "highest" are dropped when the module ends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine.post_pallas import post_pallas_ok as jpost_ok
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.spectral.fused import colspec_chunk as jcolspec
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu_torch import MagnifyConfig, magnify_video
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.engine.pipeline import blur_row_window
from pbmm_tpu_torch.spectral import fused


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_highest_traces():
    """Drop the JAX traces made at gm_precision "highest" when the module
    ends, so later tests of the process trace the default anew."""
    yield
    set_gm_precision("")
    jax.clear_caches()


BLUR = {0.5: 2, 0.75: 3, 1.5: 5, 4.0: 13}  # blur_size -> radius
MODES = {"y_only": dict(),
         "rgb": dict(chroma="rgb"),
         "planar_u8": dict(output_layout="planar_u8")}


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def clip():
    return oscillating_bar(size=384, frames=3, bar_width=2)[:, :96]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("blur_size", sorted(BLUR))
def test_blur_radius_vs_jax(clip, blur_size, mode):
    change = dict(pad_mode="tight", blur_size=blur_size, **MODES[mode])
    t = MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(**change)
    j = JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        interpret_pallas=True, **change)
    geom = geometry_for(96, 384, "tight")
    rows = blur_row_window(geom, t)
    assert post_fused._radius(t) == BLUR[blur_size]
    assert post_fused.post_pallas_ok(geom, t, rows[0], rows[1] - rows[0])
    assert jpost_ok(geom, j, rows[0], rows[1] - rows[0])
    frames = clip
    if mode == "planar_u8":
        frames = np.ascontiguousarray(np.moveaxis(
            np.round(clip * 255.0).astype(np.uint8), -1, 1))
    got, _ = magnify_video(torch.from_numpy(frames), t, device="cpu")
    want = np.asarray(jmagnify(frames, j)[0])
    assert got.shape == want.shape
    got = got.numpy()
    if mode == "planar_u8":
        assert got.dtype == want.dtype == np.uint8
        assert int(np.abs(got.astype(int) - want).max()) <= 1
        got, want = got / 255.0, want / 255.0
    assert _psnr(got, want) > 70


def _served_before(radius, pad_w):
    """The route's predicate before kernel 3 ran on the row engine: a
    block of (2 + 1 + 2 r) rows of `pad_w` f32 in 227 KB."""
    return 232448 // (4 * pad_w) - 2 - 2 * radius > 0


@pytest.mark.parametrize("pad_w,radius,kernel3", [
    (2048, 2, True), (2048, 3, True), (2048, 5, True), (2048, 12, False),
    (2048, 13, False), (2048, 14, False), (2048, 15, False), (4096, 2, True),
    (4096, 5, False), (4096, 6, False), (4096, 7, False), (4096, 13, False),
    (1024, 13, False), (8192, 2, True), (8192, 3, False),
])
def test_kernel3_route(pad_w, radius, kernel3):
    """Kernel 3 holds its region rows in flight (two planes of the row
    engine each) and the ring of 2 r blurred rows of the crop in 227 KB
    of shared memory, with up to 256 threads a block (one row of 512 at
    8192 lanes): at the widest crop `post_pallas_ok` admits it serves
    while its blocks keep 512 threads on an SM (from radius 6 at 1080p
    one block of 256 is left, and kernels 7 + 10 run faster); its block
    still fits every pair the route served before."""
    assert post_fused.kernel3_serves(radius, pad_w) is kernel3
    rows = post_fused.kernel3_rows(radius, pad_w)
    in_w = (pad_w - 2 * radius) // 128 * 128
    threads = rows * pad_w // 16
    blocks = min(2048 // max(threads, 1), 233472 // (
        post_fused.kernel3_smem(rows, radius, pad_w, in_w) + 1024))
    assert (rows > 0 and blocks * threads >= 512) is kernel3
    assert rows * pad_w // 16 <= max(256, pad_w // 16)
    if kernel3:
        assert post_fused.kernel3_smem(rows, radius, pad_w, in_w) <= 232448
        assert post_fused.kernel3_smem(rows, radius, pad_w, in_w) == 4 * (
            rows * 2 * (pad_w + pad_w // 16) + 2 * radius * in_w)
    if rows and rows < max(1, 256 // (pad_w // 16)):
        assert post_fused.kernel3_smem(rows + 1, radius, pad_w,
                                       in_w) > 232448
    if _served_before(radius, pad_w):
        assert rows > 0
    assert post_fused.kernel3_rows(2, 2048) == 2
    assert post_fused.kernel3_rows(12, 2048) == 2
    assert post_fused.kernel3_rows(13, 2048) == 1
    # The crop of 1080p (1920 of 2048 lanes) at radius 14 fills 227 KB to
    # the byte; a crop a tile narrower leaves room at 15.
    assert post_fused.kernel3_smem(1, 14, 2048, 1920) == 232448
    assert post_fused.kernel3_rows(15, 2048, in_w=1792) > 0
    assert post_fused.kernel3_rows(15, 2048, in_w=1920) == 0
    assert not post_fused.kernel3_serves(15, 2048, in_w=1792)


def test_kernel3_route_keeps_every_pair_served_before():
    """Every (radius, pad_w) the route's older predicate
    (`_served_before`) gave kernel 3, at every crop width
    `post_pallas_ok` admits, still has a kernel-3 block within 227 KB
    (the route takes it where its blocks keep 512 threads an SM)."""
    for pad_w in (128, 256, 512, 1024, 2048, 4096, 8192):
        for radius in range(0, 97):
            if not _served_before(radius, pad_w):
                continue
            for in_w in range(128, pad_w - 2 * radius + 1, 128):
                rows = post_fused.kernel3_rows(radius, pad_w, in_w)
                assert rows > 0, (radius, pad_w, in_w)
                assert post_fused.kernel3_smem(rows, radius, pad_w,
                                               in_w) <= 232448


@pytest.mark.parametrize("layout", ["tuple3", "planar_u8"])
def test_post_fused_u8_chroma_ref_matches_kernel3_ref(layout):
    """Kernel 10 takes over from kernel 3 where kernel 3's block does not
    fit: on kernel 7's rows with the uint8 frames as the chroma source it
    gives what kernel 3 gives."""
    in_h, in_w = 96, 384
    cfg = MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight",
                                                  blur_size=4.0)
    g = geometry_for(in_h, in_w, "tight")
    rows = blur_row_window(g, cfg)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(3)
    scale = 0.3 * g.pad_h * np.sqrt(g.pad_w)
    rre, rim = (torch.from_numpy((scale * rng.standard_normal(
        (2, hr, g.pad_w))).astype(np.float32)) for _ in range(2))
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 3, in_h, in_w),
                                       dtype=np.uint8))
    win = hann2d_region(g)
    want = post_fused.rowifft_post_fused(
        rre, rim, None, None, win, cfg, rows[0], in_h, in_w, "tight",
        full_w=g.pad_w, src=u8, out_layout=layout)
    rec = fused.row_ifft_magnitude(rre, rim, pad_h=g.pad_h, full_w=g.pad_w)
    got = post_fused.post_fused(rec, None, None, win, cfg, rows[0], in_h,
                                in_w, "tight", layout, src=u8)
    if layout == "tuple3":
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-6
    else:
        assert got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
    with pytest.raises(ValueError, match="src"):
        post_fused.post_fused(rec, None, None, win, cfg, rows[0], in_h, in_w,
                              "tight", layout)


@pytest.mark.parametrize("pad_h,row0", [(4096, 968), (2176, 8), (4352, 16)],
                         ids=["square_pow2_4096", "tight_2176", "tight_4352"])
def test_colspec_chunk_ref_vs_jax_tall(pad_h, row0):
    hc = 2160
    rng = np.random.default_rng(pad_h)
    rows_in = [rng.standard_normal((2, hc, 128)).astype(np.float32)
               for _ in range(2)]
    prev = [rng.standard_normal((1, pad_h, 128)).astype(np.float32)
            for _ in range(2)]
    tc = MagnifyConfig(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight")
    jc = JCfg(phase_scale=10.0).tuned_for_tpu().replace(
        pad_mode="tight", interpret_pallas=True, gm_precision="highest")
    # Full-f32 matmuls in the JAX kernel, as tests/test_torch_kernels.py.
    set_gm_precision("highest")
    try:
        want = [np.asarray(x) for x in jcolspec(
            *[jnp.asarray(x) for x in rows_in + prev], jc, pad_h=pad_h,
            row0=row0, out_rows=(0, pad_h), interpret=True)]
    finally:
        set_gm_precision("")
    got = fused.colspec_chunk_ref(*[torch.from_numpy(x)
                                    for x in rows_in + prev], tc, pad_h,
                                  row0, out_rows=(0, pad_h))
    assert got[0].shape == (2, pad_h, 128)
    assert got[2].shape == (1, pad_h, 128)
    for k in (0, 2):
        g = got[k].numpy() + 1j * got[k + 1].numpy()
        w = want[k] + 1j * want[k + 1]
        assert np.abs(g - w).max() / np.abs(w).max() < 1e-4
