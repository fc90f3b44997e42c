"""The config matrix's kernel branches on the CPU: each plain PyTorch
version against its JAX kernel (Pallas in interpret mode, or the plain JAX
function the kernel runs), on inputs made with numpy from a seed.

- `_phase_block_ref` against JAX `_phase_block`, every branch, on random
  spectra with rows of exact and signed zeros;
- `colspec_chunk_ref` at a pow-2 height (one plane; three planes with the
  IIR taps) and at a four-step height with IIR and steerable bands;
- `col_fft_zero_padded_ref` (kernel 5), also bit for bit against the
  spectrum `colspec_chunk_ref` carries out of a zero-prev bootstrap;
- `rowifft_post_fused_ref` with reconstruct="real", compensate_window and
  the YIQ gains;
- `post_fused_rgb_ref` (kernel 11).

Tolerances: spectra and taps to max error / max magnitude < 1e-4, images
to max abs < 1e-4 (kernel 3) and < 1e-5 (kernel 11, no transform inside).
The JAX column kernels run with full-f32 matmuls (gm_precision
"highest"), as in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.config import TemporalConfig as JTemporal
from pbmm_tpu.core.window import geometry_for as jgeom
from pbmm_tpu.core.window import hann2d_region as jhann
from pbmm_tpu.engine.pipeline import blur_row_window as jrows
from pbmm_tpu.engine.post_pallas import post_fused_rgb as jpost_rgb
from pbmm_tpu.engine.post_pallas import rowifft_post_fused as jpost
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral.pallas_fft import set_gm_precision
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.config import TemporalConfig as TTemporal
from pbmm_tpu_torch.core.window import geometry_for, hann2d_region
from pbmm_tpu_torch.engine import post_fused
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.spectral.hermitian import hermitian_kept_width

_IIR = "iir"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The same config in both packages (`temporal=_IIR` for the IIR
    band-pass)."""
    iir = kw.pop("temporal", None) == _IIR
    j = JCfg(phase_scale=10.0).tuned_for_tpu().replace(**kw)
    t = TCfg(phase_scale=10.0).tuned_for_tpu().replace(**kw)
    if iir:
        j = j.replace(temporal=JTemporal(mode="iir_bandpass"))
        t = t.replace(temporal=TTemporal(mode="iir_bandpass"))
    return j, t


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _spectra(rng, shape):
    """Normal spectra with a band of exact zeros and one of signed zeros
    (the zero-prev bootstrap and its atan2 sign trap)."""
    a = rng.standard_normal(shape).astype(np.float32)
    a[..., :8, :] = 0.0
    a[..., 8:16, :] = -0.0
    return a


# name -> (config changes, host planes given)
_BRANCHES = {
    "host_planes_integer": (dict(), True),
    "disjoint_in_kernel": (dict(), False),
    "overlapping": (dict(pyramid_levels=6), False),
    "steerable_planes": (dict(orientations=4), True),
    "steerable_overlapping": (dict(orientations=3, pyramid_levels=6), False),
    "non_integer": (dict(phase_scale=2.5), True),
    "standard": (dict(mode="standard"), True),
    "iir": (dict(temporal=_IIR), True),
    "iir_overlapping": (dict(temporal=_IIR, pyramid_levels=7), False),
    "standard_iir": (dict(mode="standard", temporal=_IIR), True),
}


@pytest.fixture(scope="module")
def phase_inputs():
    rng = np.random.default_rng(21)
    h, w = 512, 512
    wk = hermitian_kept_width(w)
    d = {k: _spectra(rng, (h, wk)) for k in ("cr", "ci", "pr", "pi")}
    # Rows 16-24: prev exact/signed zero against a live cur, taps zero:
    # the bootstrap frame of an IIR stream.
    d["pr"][16:24] = d["pi"][16:24] = 0.0
    d["pi"][16:24:2] = -0.0
    d["lpf"] = 0.3 * rng.standard_normal((h, wk)).astype(np.float32)
    d["lps"] = 0.3 * rng.standard_normal((h, wk)).astype(np.float32)
    d["lpf"][16:24] = d["lps"][16:24] = 0.0
    d["geom"] = (h, wk, w)
    return d


@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_phase_block_ref_vs_jax(phase_inputs, branch):
    change, host = _BRANCHES[branch]
    jc, tc = _cfgs(**change)
    d = phase_inputs
    h, wk, w = d["geom"]
    iir = tc.temporal.mode == "iir_bandpass"
    fy, fx = tfused._freq_tables(h, wk, w)
    jplanes = jfused._static_phase_planes(jc, h, wk, w) if host else None
    tplanes = tfused._static_phase_planes(tc, h, wk, w) if host else None
    if host:
        assert all(np.array_equal(a, b) for a, b in zip(jplanes, tplanes))
    spec = [d[k] for k in ("cr", "ci", "pr", "pi")]
    jtaps = dict(lpf=jnp.asarray(d["lpf"]), lps=jnp.asarray(d["lps"])) \
        if iir else {}
    want = jfused._phase_block(
        *map(jnp.asarray, spec), jnp.asarray(fy), jnp.asarray(fx), jc,
        static_planes=(tuple(map(jnp.asarray, jplanes)) if host else None),
        **jtaps)
    ttaps = dict(lpf=_t(d["lpf"]), lps=_t(d["lps"])) if iir else {}
    got = tfused._phase_block_ref(
        *map(_t, spec), _t(fy), _t(fx), tc,
        static_planes=(tuple(map(_t, tplanes)) if host else None), **ttaps)
    assert len(got) == len(want) == (4 if iir else 2)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                np.asarray(want[0]) + 1j * np.asarray(want[1])) < 1e-4
    for g, wnt in zip(got[2:], want[2:]):
        assert _rel(g.numpy(), wnt) < 1e-4
        # The bootstrap rows: atan2(+-0, +-0) = 0 keeps the taps zero.
        z = g.numpy()[16:24]
        assert np.isfinite(g.numpy()).all() and not z.any()
        assert not np.signbit(z).any()


@pytest.fixture(scope="module", params=["pow2", "pow2_rgb_iir",
                                        "tight_iir_steerable"])
def colspec_case(request):
    """Kernel 2's inputs at a pow-2 and a four-step height, and the JAX
    kernel's outputs on them."""
    change = {"pow2": dict(),
              "pow2_rgb_iir": dict(chroma="rgb", temporal=_IIR),
              "tight_iir_steerable": dict(temporal=_IIR, orientations=4,
                                          phase_scale=2.5)}[request.param]
    jc, tc = _cfgs(**change)
    planes = 3 if tc.chroma == "rgb" else 1
    pad_h = 384 if request.param.startswith("tight") else 512
    w, hc, row0, rows, t = 512, 256, 64, (64, 320), 2
    wk = hermitian_kept_width(w)
    rng = np.random.default_rng(22)
    args = [_spectra(rng, (t * planes, hc, wk)) for _ in range(2)]
    args += [_spectra(rng, (planes, pad_h, wk)) for _ in range(2)]
    taps = []
    if tc.temporal.mode == "iir_bandpass":
        taps = [0.3 * rng.standard_normal((planes, pad_h, wk)).astype(
            np.float32) for _ in range(2)]
    set_gm_precision("highest")
    try:
        want = jfused.colspec_chunk(
            *map(jnp.asarray, args), jc.replace(gm_precision="highest"),
            pad_h=pad_h, row0=row0, out_rows=rows, full_w=w, planes=planes,
            interpret=True, **dict(zip(("lp_fast", "lp_slow"),
                                       map(jnp.asarray, taps))))
    finally:
        set_gm_precision("")
    return dict(tc=tc, args=args, taps=taps, want=[np.asarray(x)
                                                   for x in want],
                kw=dict(pad_h=pad_h, row0=row0, out_rows=rows, full_w=w,
                        planes=planes))


def test_colspec_chunk_ref_vs_jax(colspec_case):
    c = colspec_case
    got = tfused.colspec_chunk_ref(*map(_t, c["args"]), c["tc"],
                                   lp_fast=_t(c["taps"][0]) if c["taps"]
                                   else None,
                                   lp_slow=_t(c["taps"][1]) if c["taps"]
                                   else None, **c["kw"])
    want = c["want"]
    assert len(got) == len(want)
    for k in range(0, 4, 2):
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy() + 1j * got[k + 1].numpy(),
                    want[k] + 1j * want[k + 1]) < 1e-4
    for g, wnt in zip(got[4:], want[4:]):
        assert g.shape == wnt.shape
        assert _rel(g.numpy(), wnt) < 1e-4
    # On CPU tensors the public wrapper is the plain version.
    pub = tfused.colspec_chunk(
        *map(_t, c["args"]), c["tc"], c["kw"]["pad_h"], c["kw"]["row0"],
        *map(_t, c["taps"]), **{k: v for k, v in c["kw"].items()
                                if k not in ("pad_h", "row0")})
    assert all(torch.equal(a, b) for a, b in zip(pub, got))


def test_col_fft_zero_padded_ref_vs_jax():
    rng = np.random.default_rng(23)
    wk = hermitian_kept_width(512)
    re, im = (rng.standard_normal((2, 256, wk)).astype(np.float32)
              for _ in range(2))
    set_gm_precision("highest")
    try:
        want = jfused.col_fft_zero_padded(jnp.asarray(re), jnp.asarray(im),
                                          pad_h=512, row0=64, interpret=True)
    finally:
        set_gm_precision("")
    got = tfused.col_fft_zero_padded(_t(re), _t(im), 512, row0=64)
    assert got[0].shape == (2, 512, wk)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                np.asarray(want[0]) + 1j * np.asarray(want[1])) < 1e-4
    # Kernel 2's forward half is the same op sequence: the spectrum it
    # carries out of a zero-prev bootstrap equals kernel 5's bit for bit.
    _, tc = _cfgs()
    zero = torch.zeros((1, 512, wk))
    for b in range(2):
        res = tfused.colspec_chunk_ref(_t(re[b:b + 1]), _t(im[b:b + 1]),
                                       zero, zero, tc, 512, 64, full_w=512)
        assert torch.equal(res[2][0], got[0][b])
        assert torch.equal(res[3][0], got[1][b])
    with pytest.raises(ValueError):
        tfused.col_fft_zero_padded(_t(re), _t(im), 384)


_QUIRKS = {
    "real": dict(reconstruct="real"),
    "compensate": dict(compensate_window=True),
    "gains": dict(apply_yiq_gains=True, yiq_gains=(1.0, 1.2, 0.8)),
    "all": dict(reconstruct="real", compensate_window=True,
                apply_yiq_gains=True, yiq_gains=(0.9, 1.3, 0.7)),
}


def _post_inputs(in_h, in_w, jc, seed, planes):
    g = geometry_for(in_h, in_w, "tight")
    rows = jrows(jgeom(in_h, in_w, "tight"), jc)
    hr = rows[1] - rows[0]
    rng = np.random.default_rng(seed)
    return g, rows, hr, rng


@pytest.mark.parametrize("quirk", sorted(_QUIRKS))
def test_rowifft_post_fused_quirks_vs_jax(quirk):
    in_h, in_w = 320, 384
    jc, tc = _cfgs(pad_mode="tight", **_QUIRKS[quirk])
    g, rows, hr, rng = _post_inputs(in_h, in_w, jc, 24, 1)
    wk = hermitian_kept_width(g.pad_w)
    scale = 0.3 * g.pad_h * g.pad_w / np.sqrt(g.pad_w)
    rre, rim = ((scale * rng.standard_normal((2, hr, wk))).astype(
        np.float32) for _ in range(2))
    i_pl = rng.uniform(-0.6, 0.6, (2, in_h, in_w)).astype(np.float32)
    q_pl = rng.uniform(-0.5, 0.5, (2, in_h, in_w)).astype(np.float32)
    want = jpost(jnp.asarray(rre), jnp.asarray(rim), jnp.asarray(i_pl),
                 jnp.asarray(q_pl), jhann(jgeom(in_h, in_w, "tight")), jc,
                 rows[0], in_h, in_w, "tight", full_w=g.pad_w,
                 out_layout="planar", interpret=True)
    got = post_fused.rowifft_post_fused(
        _t(rre), _t(rim), _t(i_pl), _t(q_pl), hann2d_region(g), tc, rows[0],
        in_h, in_w, "tight", full_w=g.pad_w, out_layout="planar")
    assert got.shape == (2, 3, in_h, in_w)
    assert 0.01 < float(got.mean()) < 0.99  # not all clipped
    assert float((got - _t(want)).abs().max()) < 1e-4


@pytest.mark.parametrize("quirk", ["none", "all"])
@pytest.mark.parametrize("layout", ["tuple3", "planar_u8"])
def test_post_fused_rgb_ref_vs_jax(quirk, layout):
    in_h, in_w = 320, 384
    jc, tc = _cfgs(pad_mode="tight", chroma="rgb",
                   **_QUIRKS.get(quirk, {}))
    g, rows, hr, rng = _post_inputs(in_h, in_w, jc, 25, 3)
    chans3 = rng.uniform(-0.2, 0.9, (6, hr, g.pad_w)).astype(np.float32)
    want = jpost_rgb(jnp.asarray(chans3), jhann(jgeom(in_h, in_w, "tight")),
                     jc, rows[0], in_h, in_w, "tight", interpret=True)
    want = np.stack([np.asarray(x) for x in want], axis=1)
    got = post_fused.post_fused_rgb(_t(chans3), hann2d_region(g), tc,
                                    rows[0], in_h, in_w, "tight",
                                    out_layout=layout)
    if layout == "tuple3":
        got = torch.stack(got, dim=1)
        assert 0.01 < float(got.mean()) < 0.99
        assert float((got - torch.from_numpy(want)).abs().max()) < 1e-5
    else:
        # The JAX package emits uint8 as round(255 x) of these planes.
        want_u8 = np.round(want * 255.0).astype(np.uint8)
        assert got.dtype == torch.uint8
        assert int(np.abs(got.numpy().astype(int) - want_u8).max()) <= 1
