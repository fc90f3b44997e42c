"""The port's rows-sharded engine (`pbmm_tpu_torch.parallel.spatial`) in
real gloo worlds of 2, 4 and 8 CPU processes against the JAX spatial
engine on the same mesh shapes (8 virtual CPU devices, the Pallas kernels
in interpret mode), the cases of `tests/test_spatial.py`, each > 70 dB;
and kernel 6's `fx_values` branch (the shard's lane frequencies) against
the JAX kernel.

The port runs in processes spawned by `pbmm_tpu_torch.tools.multihost`
(worker mode: they import the port only), one world a mesh size, each
running all of its cases; the JAX side runs here."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.parallel import spatial as jspatial
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral.pallas_fft import bitrev_freq_axis
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch.core.window import geometry_for as tgeometry_for
from pbmm_tpu_torch.parallel import spatial as tspatial
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.tools import multihost
from pbmm_tpu_torch.tools.multihost import make_config

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

IIR = {"temporal": {"mode": "iir_bandpass"}}
PALLAS = {"fft_backend": "pallas", "use_rfft": False,
          "interpret_pallas": True}


def _bar(size, frames):
    return oscillating_bar(size=size, frames=frames, bar_width=2)


def _tight_frames():
    frames = _bar(256, 4)
    return np.concatenate([frames, frames[:, :44]], axis=1)  # 300 rows


# name -> (world, mesh shape, axes, engine, config fields, clip name); a
# pair takes frames 1 and 2 of its clip.
CLIPS = {"bar64x6": (64, 6), "bar64x8": (64, 8), "bar64x4": (64, 4),
         "bar64x5": (64, 5), "bar128x4": (128, 4), "bar128x6": (128, 6),
         "bar128x3": (128, 3), "bar64x3": (64, 3)}
ROWS = ("rows",)
FR = ("frame", "rows")
CASES = {
    # rows-only worlds of 2 and 8
    "pair_rows8": (8, (8,), ROWS, "pair_spatial", {"use_rfft": False},
                   "bar128x3"),
    "video_rows8": (8, (8,), ROWS, "video_spatial", {"use_rfft": False},
                    "bar64x6"),
    "video_frame2_rows4": (8, (2, 4), FR, "video_spatial",
                           {"use_rfft": False}, "bar64x8"),
    "reject_pad_rows8": (8, (8,), ROWS, "video_spatial",
                         {"use_rfft": False}, "tiny"),
    "pair_rows2": (2, (2,), ROWS, "pair_spatial", {"use_rfft": False},
                   "bar64x3"),
    "video_rows2_kernels": (2, (2,), ROWS, "video_spatial", PALLAS,
                            "bar128x4"),
    # a (2, 2) frame x rows world, and rows-only 4
    "video_frame2_rows2": (4, (2, 2), FR, "video_spatial",
                           {"use_rfft": False}, "bar64x8"),
    "passthrough_rows4": (4, (4,), ROWS, "video_spatial",
                          {"use_rfft": False}, "bar64x4"),
    "kernels_pyramid": (4, (4,), ROWS, "video_spatial", PALLAS,
                        "bar128x4"),
    "kernels_steerable": (4, (4,), ROWS, "video_spatial",
                          {**PALLAS, "orientations": 4}, "bar128x4"),
    "kernels_standard": (4, (4,), ROWS, "video_spatial",
                         {**PALLAS, "mode": "standard"}, "bar128x4"),
    "kernels_iir": (4, (4,), ROWS, "video_spatial", {**PALLAS, **IIR},
                    "bar128x6"),
    "kernels_frame2_rows2": (4, (2, 2), FR, "video_spatial", PALLAS,
                             "bar128x4"),
    "xla_standard": (4, (4,), ROWS, "video_spatial",
                     {"use_rfft": False, "mode": "standard"}, "bar64x4"),
    "xla_iir": (4, (4,), ROWS, "video_spatial", {"use_rfft": False, **IIR},
                "bar64x6"),
    "xla_rgb": (4, (4,), ROWS, "video_spatial",
                {"use_rfft": False, "chroma": "rgb"}, "bar64x4"),
    "xla_rgb_frame2_rows2": (4, (2, 2), FR, "video_spatial",
                             {"use_rfft": False, "chroma": "rgb"},
                             "bar64x4"),
    "tight_takes_xla": (4, (4,), ROWS, "video_spatial",
                        {**PALLAS, "pad_mode": "tight"}, "tight"),
    "reject_iir_frame_mesh": (4, (2, 2), FR, "video_spatial",
                              {"use_rfft": False, **IIR}, "zeros"),
    "reject_unsplittable": (4, (2, 2), FR, "video_spatial",
                            {"use_rfft": False}, "bar64x5"),
    "pair_frame2_rows2": (4, (2, 2), FR, "pair_spatial",
                          {"use_rfft": False}, "bar64x3"),
}
ERRORS = {"reject_iir_frame_mesh": "sequential",
          "reject_unsplittable": "must divide",
          "reject_pad_rows8": "must divide the rows-mesh"}
# The port's own rejection: a pair's rank blocks need a rows-only mesh.
PORT_ERRORS = {"pair_frame2_rows2": "('rows',) mesh"}


def _clip(name):
    if name == "tight":
        return _tight_frames()
    if name == "zeros":
        return np.zeros((4, 64, 64, 3), np.float32)
    if name == "tiny":
        return _bar(64, 3)[:, :3, :3]
    return _bar(*CLIPS[name])


def _inputs(engine, clip):
    if engine == "pair_spatial":
        return [clip + ":1", clip + ":2"]
    return [clip]


def _array(key):
    name, _, idx = key.partition(":")
    clip = _clip(name)
    return clip[int(idx)] if idx else clip


@pytest.fixture(scope="module")
def port_runs():
    """{case name: (port output or error text, rank 0's report)}: one
    spawned world a mesh size, every case of that size in it."""
    got = {}
    for world in sorted({c[0] for c in CASES.values()}):
        cases, arrays = [], {}
        for name, (w, shape, axes, engine, fields, clip) in CASES.items():
            if w != world:
                continue
            ins = _inputs(engine, clip)
            for k in ins:
                arrays[k] = np.ascontiguousarray(_array(k), np.float32)
            cases.append({"name": name, "engine": engine,
                          "mesh": list(shape), "axes": list(axes),
                          "config": {"fields": fields}, "inputs": ins})
        outs, report = multihost.run_cases(cases, arrays, world, "cpu",
                                           timeout=300)
        for name, info in report["cases"].items():
            got[name] = (info["error"] if "error" in info else outs[name],
                          info)
    yield got
    jax.clear_caches()


def _jax_cfg(fields):
    fields = dict(fields)
    if "temporal" in fields:
        fields["temporal"] = TemporalConfig(**fields["temporal"])
    return MagnifyConfig(**fields)


def _jax_run(name):
    _, shape, axes, engine, fields, clip = CASES[name]
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, axes)
    cfg = _jax_cfg(fields)
    if engine == "pair_spatial":
        return jspatial.magnify_frame_pair_spatial(
            *(_array(k) for k in _inputs(engine, clip)), cfg, mesh)
    return jspatial.magnify_video_spatial(_array(clip), cfg, mesh)


@pytest.mark.parametrize(
    "name", [n for n in CASES if n not in ERRORS and n not in PORT_ERRORS])
def test_spatial_matches_jax(port_runs, name):
    got = port_runs[name][0]
    assert isinstance(got, np.ndarray), got
    want = np.asarray(_jax_run(name))
    assert got.shape == want.shape
    assert psnr(got, want) > 70.0
    if name == "passthrough_rows4":
        np.testing.assert_allclose(got[0], _array("bar64x4")[0], atol=1e-6)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_spatial_rejections_match_jax(port_runs, name):
    got = port_runs[name][0]
    assert isinstance(got, str)
    assert ERRORS[name] in got
    with pytest.raises(ValueError, match=ERRORS[name]):
        _jax_run(name)


def test_pair_on_a_frame_mesh_raises(port_runs):
    got = port_runs["pair_frame2_rows2"][0]
    assert isinstance(got, str) and PORT_ERRORS["pair_frame2_rows2"] in got


@pytest.mark.parametrize("name,want", [
    # tight 300 rows pad to 384, 42 above: rank 0's 96 padded rows hold
    # frame rows 0-53
    ("tight_takes_xla", [4, 54, 256, 3]),
    # 64 rows over 4 row ranks, 8 frames over 2 frame ranks
    ("video_frame2_rows4", [4, 16, 64, 3]),
    ("pair_rows8", [16, 128, 3]),
])
def test_spatial_returns_the_rank_block(port_runs, name, want):
    """Each rank gets back its own block, cropped to the frame (the
    whole clip only after `gather_spatial`)."""
    assert port_runs[name][1]["block_shape"] == want


@pytest.mark.parametrize("name,n_rows", [
    ("kernels_pyramid", 4), ("kernels_iir", 4), ("tight_takes_xla", 4),
    ("xla_rgb", 4), ("video_rows2_kernels", 2)])
def test_route_predicate_matches_jax(name, n_rows):
    """One config takes the same spectral route in both packages."""
    from pbmm_tpu.core.window import geometry_for

    fields = CASES[name][4]
    h, w = _clip(CASES[name][5]).shape[1:3]
    pad = fields.get("pad_mode", "square_pow2")
    assert (tspatial._spatial_pallas_ok(
        make_config({"fields": fields}), tgeometry_for(h, w, pad), n_rows)
        == jspatial._spatial_pallas_ok(_jax_cfg(fields),
                                       geometry_for(h, w, pad), n_rows))


# ---------------------------------------------------------------------------
# Kernel 6 with fx_values: the plain version against the JAX kernel
# ---------------------------------------------------------------------------

K6_BRANCHES = {
    "pyramid": {},
    "standard": {"mode": "standard", "phase_scale": 2.5},
    "steerable": {"orientations": 4, "pyramid_levels": 6},
    "iir": IIR,
}


@pytest.mark.parametrize("branch", sorted(K6_BRANCHES))
@pytest.mark.parametrize("p,idx", [(2, 1), (8, 5)])
def test_phase_col_ifft_fx_values_matches_jax(branch, p, idx):
    """Kernel 6 on a rows-shard's column slice: (B, H, W / p) spectra with
    the shard's slice of `bitrev_freq_axis(W)`, every branch, to 1e-4 of
    the maximum magnitude (outputs and IIR taps)."""
    rng = np.random.default_rng(100 * p + idx)
    h, w = 128, 256
    wc = w // p
    fx = bitrev_freq_axis(w)[idx * wc:(idx + 1) * wc]
    cur = [rng.standard_normal((2, h, wc)).astype(np.float32)
           for _ in range(2)]
    prev = [(c + 0.1 * rng.standard_normal(c.shape)).astype(np.float32)
            for c in cur]
    fields = K6_BRANCHES[branch]
    jcfg = _jax_cfg(fields).replace(interpret_pallas=True).tuned_for_tpu()
    tcfg = make_config({"fields": fields, "tuned": True})
    taps = ([0.1 * rng.standard_normal((2, h, wc)).astype(np.float32)
             for _ in range(2)] if branch == "iir" else [])
    jkw = dict(lp_fast=taps[0], lp_slow=taps[1]) if taps else {}
    tkw = ({k: torch.from_numpy(v) for k, v in jkw.items()})
    want = jfused.phase_col_ifft(*cur, *prev, jcfg, fx_values=fx,
                                 interpret=True, **jkw)
    got = tfused.phase_col_ifft(*map(torch.from_numpy, cur + prev), tcfg,
                                fx_values=torch.from_numpy(fx), **tkw)
    assert len(got) == len(want) == (4 if taps else 2)
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert np.abs(g.numpy() - wnt).max() <= 1e-4 * np.abs(wnt).max()


def test_standard_fx_values_rotates_open_bins():
    """Standard mode with fx_values and no host plane rotates: the phase
    pass's output differs from the input spectrum where the magnitude gate
    is open and the weight is nonzero, and equals it elsewhere."""
    rng = np.random.default_rng(7)
    h, wc = 64, 32
    fy = torch.from_numpy(tfused.col_freq_axis(h))[:, None]
    fx = torch.from_numpy(bitrev_freq_axis(128)[wc:2 * wc].copy())[None, :]
    cr, ci, pr, pi_ = (torch.from_numpy(
        rng.standard_normal((h, wc)).astype(np.float32)) for _ in range(4))
    cfg = make_config({"fields": {"mode": "standard", "phase_scale": 2.5},
                       "tuned": True})
    out_r, out_i = tfused._phase_block_ref(cr, ci, pr, pi_, fy, fx, cfg)
    tau2 = cfg.magnitude_threshold ** 2
    w = tfused.standard_weight_block(torch.sqrt(fy * fy + fx * fx), cfg)
    open_ = ((cr * cr + ci * ci) >= tau2) & ((pr * pr + pi_ * pi_) >= tau2)
    moved = (out_r != cr) | (out_i != ci)
    assert bool(moved[open_ & (w > 0.01)].all())
    assert not bool(moved[~open_].any())
