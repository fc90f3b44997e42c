"""The port's diagnostics on the CPU: the plain versions of kernels 12-14
against the JAX scripts' Pallas kernels (in interpret mode, or as the
JAX script runs them on the CPU), the roofline model against the JAX
model, the copy probe's arguments, and the tools' refusal to measure
without a card.

- kernel 12 (`tools/kdecomp.py`): `kdecomp_variant_ref` against
  `benchmarks.kdecomp.make_variant` at H = 256, 1152 kept lanes, rows
  (32, 224), every piece set: "stream only" exactly, the others to max
  error / max magnitude < 1e-5 (the JAX group matmul at gm_precision
  "highest", as tests/test_torch_branches.py runs it; its bf16 "b3"
  split alone is 2e-5 off the exact transform on these inputs); the full
  variant equals `phase_col_ifft_ref` bit for bit;
- kernel 13 (`tools/kexp.py`): `copy_probe_ref` returns its input in both
  patterns, odd heights included; a strip that does not divide the width
  raises;
- kernel 14 (`tools/trig_probe.py`): `trig_probe_ref` against
  `benchmarks.trig_probe.run_kernel` on `_atan2_poly`, `_cos_pi`,
  `_sin_pi`, `_sincos_any` and `_phase_block_standard`, each side against
  fp64 with the JAX probe's tolerances (1e-5, 3e-5, 1e-3), signed zeros
  included.

`benchmarks.*` are imported inside the tests: `kdecomp.py` and `kexp.py`
set a JAX cache directory when imported."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu_torch.config import MagnifyConfig as TCfg
from pbmm_tpu_torch.config import TemporalConfig as TTemporal
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.tools import kdecomp, kexp, roofline, trig_probe

sys.path.insert(0, ".")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_KD_H, _KD_WK, _KD_ROWS = 256, 1152, (32, 224)


@pytest.fixture(scope="module")
def kd_inputs():
    rng = np.random.default_rng(0)
    return [rng.random((1, _KD_H, _KD_WK), np.float32) for _ in range(4)]


@pytest.mark.parametrize("name,pieces", kdecomp.VARIANTS,
                         ids=[n for n, _ in kdecomp.VARIANTS])
def test_kdecomp_variant_vs_jax(kd_inputs, name, pieces):
    from jax.experimental.pallas import tpu as pltpu

    from benchmarks import kdecomp as jkd
    from pbmm_tpu.spectral.pallas_fft import set_gm_precision

    jc = JCfg().tuned_for_tpu().replace(gm_precision="highest")
    set_gm_precision("highest")
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jkd.make_variant(_KD_H, _KD_WK, _KD_ROWS, jc, pieces)(
                *map(jnp.asarray, kd_inputs))
        want = [np.asarray(x) for x in want]
    finally:
        set_gm_precision("")
    got = kdecomp.kdecomp_variant(*map(torch.from_numpy, kd_inputs),
                                  TCfg().tuned_for_tpu(), pieces, _KD_ROWS,
                                  full_w=2048)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (1, _KD_ROWS[1] - _KD_ROWS[0], _KD_WK)] * 2
    err = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))
    if not pieces:
        assert err == 0.0
    else:
        assert err / max(float(np.abs(w).max()) for w in want) < 1e-5


def test_kdecomp_full_variant_is_phase_col_ifft(kd_inputs):
    cfg = TCfg().tuned_for_tpu()
    ts = list(map(torch.from_numpy, kd_inputs))
    got = kdecomp.kdecomp_variant_ref(*ts, cfg, kdecomp.VARIANTS[-1][1],
                                      _KD_ROWS, full_w=2048)
    want = tfused.phase_col_ifft_ref(*ts, cfg, out_rows=_KD_ROWS,
                                     full_w=2048)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kdecomp_stages_compose(kd_inputs):
    """The two stage groups one after the other are the whole inverse:
    gm's output through the late stages equals "+gm+rolls" (its
    `torch.fft` form) to rounding."""
    ts = list(map(torch.from_numpy, kd_inputs))
    re, im = ts[0] + ts[2], ts[1] + ts[3]
    re, im = kdecomp._inverse_stages_ref(re, im, range(8))
    want = kdecomp.kdecomp_variant_ref(*ts, TCfg().tuned_for_tpu(),
                                       frozenset({"gm", "rolls"}), (0, _KD_H))
    rel = float((torch.complex(re, im) - torch.complex(*want)).abs().max()
                / torch.complex(*want).abs().max())
    assert rel < 1e-6


@pytest.mark.parametrize("bad", ["pieces", "iir", "rows", "height"])
def test_kdecomp_refusals(kd_inputs, bad):
    ts = list(map(torch.from_numpy, kd_inputs))
    cfg, pieces, rows = TCfg().tuned_for_tpu(), frozenset({"phase"}), (0, 8)
    if bad == "pieces":
        pieces = frozenset({"phase", "fft"})
    elif bad == "iir":
        cfg = cfg.replace(temporal=TTemporal(mode="iir_bandpass"))
    elif bad == "rows":
        rows = (8, _KD_H + 1)
    else:
        ts = [t[:, :200] for t in ts]
    with pytest.raises(ValueError):
        kdecomp.kdecomp_variant(*ts, cfg, pieces, rows, full_w=2048)


@pytest.mark.parametrize("pattern,block", [("rows", 1), ("rows", 64),
                                           ("rows", 5), ("lanes", 4),
                                           ("lanes", 8), ("lanes", 32)])
@pytest.mark.parametrize("h", [1152, 37])
def test_copy_probe_ref_copies(pattern, block, h):
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal((2, h, 128)).astype(
        np.float32)) for _ in range(2))
    oa, ob = kexp.copy_probe(a, b, pattern, block)
    assert torch.equal(oa, a) and torch.equal(ob, b)
    assert oa.data_ptr() != a.data_ptr()


@pytest.mark.parametrize("pattern,block,shape", [
    ("lanes", 12, (1, 64, 128)),  # 12 does not divide 128
    ("lanes", 32, (1, 2048, 128)),  # 256 KB: more than a block's smem
    ("rows", 0, (1, 64, 128)),
    ("diag", 4, (1, 64, 128)),
])
def test_copy_probe_refusals(pattern, block, shape):
    a = torch.zeros(shape)
    with pytest.raises(ValueError):
        kexp.copy_probe(a, a, pattern, block)


def test_copy_shape_is_kexp_slab():
    assert kexp.copy_shape() == (1, 1152, 2048)
    assert kexp.copy_shape(16) == (16, 1152, 2048)


def _jax_probe(name, ins):
    from benchmarks import trig_probe as jtp
    from pbmm_tpu.spectral import fused as jf

    fns = {
        "atan2": jf._atan2_poly,
        "cos": jf._cos_pi,
        "sin": jf._sin_pi,
        "sincos.cos": lambda t: jf._sincos_any(t)[0],
        "sincos.sin": lambda t: jf._sincos_any(t)[1],
    }
    return np.asarray(jtp.run_kernel(fns[name], *map(jnp.asarray, ins)))


@pytest.mark.parametrize("name", ["atan2", "cos", "sin", "sincos.cos",
                                  "sincos.sin"])
def test_trig_probe_vs_jax(name):
    inp = trig_probe.probe_inputs(0)
    if name == "atan2":
        ins, tol = (inp["atan2"]["y"], inp["atan2"]["x"]), 1e-5
        exact = np.arctan2(ins[0].astype(np.float64) + 0.0, ins[1] + 0.0)
        got = trig_probe.trig_probe("atan2", *map(torch.from_numpy, ins))[0]
    elif name in ("cos", "sin"):
        ins, tol = (inp["trig"]["u"],), 1e-5
        exact = getattr(np, name)(ins[0].astype(np.float64))
        got = trig_probe.trig_probe(name, torch.from_numpy(ins[0]))[0]
    else:
        ins, tol = (inp["sincos"]["t"],), 3e-5
        part = name.split(".")[1]
        exact = getattr(np, part)(ins[0].astype(np.float64))
        got = trig_probe.trig_probe("sincos", torch.from_numpy(ins[0]))[
            part == "sin"]
    want = _jax_probe(name, ins)
    got = got.numpy()
    assert np.abs(got - exact).max() <= tol
    assert np.abs(want - exact).max() <= tol
    assert np.abs(got - want).max() <= tol


def test_trig_probe_signed_zeros_both_sides():
    """atan2 gives 0 at (+-0, +-0) and +pi at (-0, -1) in both packages:
    -0 counts as +0 (the TPU polynomial's convention)."""
    y = np.array([[0.0, -0.0, 0.0, -0.0, -0.0]], np.float32)
    x = np.array([[0.0, 0.0, -0.0, -0.0, -1.0]], np.float32)
    want = np.array([[0, 0, 0, 0, np.pi]], np.float32)
    port = trig_probe.trig_probe("atan2", torch.from_numpy(y),
                                 torch.from_numpy(x))[0].numpy()
    assert np.array_equal(port, want)
    assert np.array_equal(_jax_probe("atan2", (y, x)), want)


def test_trig_probe_standard_bin_vs_jax():
    """One standard-mode bin: the port's (host w plane) against JAX
    `_phase_block_standard` (in-kernel weight) and both against fp64,
    within 1e-3 (`trig_probe.py:130`)."""
    from pbmm_tpu.spectral import fused as jf

    from benchmarks import trig_probe as jtp

    name, op, ins, kw, exact, tol = trig_probe.probe_cases(0)[-1]
    assert name == "phase_std"
    fy, fx = kw["fy"], kw["fx"]
    fy_b = np.broadcast_to(fy[:, None], ins[0].shape).astype(np.float32)
    fx_b = np.broadcast_to(fx[None, :], ins[0].shape).astype(np.float32)
    jcfg = JCfg(mode="standard")
    want = [np.asarray(jtp.run_kernel(
        lambda a, b, c, d, e, f, k=k: jf._phase_block_standard(
            a, b, c, d, e, f, jcfg)[k],
        *map(jnp.asarray, (*ins[:4], fy_b, fx_b)))) for k in (0, 1)]
    got = trig_probe.trig_probe(
        op, *map(torch.from_numpy, ins), cfg=kw["cfg"],
        fy=torch.from_numpy(fy), fx=torch.from_numpy(fx))
    for g, w, e in zip(got, want, exact):
        g = g.numpy()
        assert np.abs(g - e).max() <= tol and np.abs(w - e).max() <= tol
        assert np.abs(g - w).max() <= tol
        assert np.isfinite(g).all()


def test_trig_probe_every_case_on_cpu():
    rows = trig_probe.run_probe("cpu")
    assert len(rows) == 16  # 15 ops and branches, the host w plane
    assert all(r["ok"] and r["finite"] for r in rows), [
        r for r in rows if not r["ok"]]
    assert trig_probe.standard_weight_error() < 1e-4


@pytest.mark.parametrize("op,ins,kw", [
    ("atan2", 1, {}), ("mask", 1, dict(arg=4)), ("pow_int", 1, dict(arg=65)),
    ("phase_std", 5, {}), ("tan", 1, {}),
])
def test_trig_probe_refusals(op, ins, kw):
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        trig_probe.trig_probe(op, *([x] * ins), **kw)


def _roofline_cfgs():
    def both(**kw):
        return (JCfg().tuned_for_tpu().replace(**kw),
                TCfg().tuned_for_tpu().replace(**kw))
    return {"tuned": both(), "tight": both(pad_mode="tight"),
            "full_lanes": both(use_hermitian_spectral=False)}


@pytest.mark.parametrize("name", sorted(_roofline_cfgs()))
def test_roofline_stages_equal_jax(name):
    from benchmarks import roofline as jr

    jc, tc = _roofline_cfgs()[name]
    assert roofline.hot_path_stages(1080, 1920, tc) == jr.hot_path_stages(
        1080, 1920, jc)
    assert roofline.hot_path_stages_u8(1080, 1920, tc) == (
        jr.hot_path_stages_u8(1080, 1920, jc))


def test_roofline_u8_default_equals_jax():
    from benchmarks import roofline as jr

    assert roofline.hot_path_stages_u8() == jr.hot_path_stages_u8()
    assert roofline.hot_path_stages() == jr.hot_path_stages()


def test_roofline_table_arithmetic():
    """The table's columns from given stage times (the arithmetic only;
    the times of a real table come from the card)."""
    stages = roofline.hot_path_stages()
    measured = [(n, 1e-4 * (i + 1)) for i, (n, *_) in enumerate(stages)]
    rows, summary = roofline.roofline_table(measured=measured,
                                            copy_gbps=2500.0)
    for r, (_, bi, bo, fl), (_, sec) in zip(rows, stages, measured):
        assert r["roofline_ms"] == round((bi + bo) / 3.35e12 * 1e3, 4)
        assert r["copy_ceiling_ms"] == round((bi + bo) / 2.5e12 * 1e3, 4)
        assert r["pct_of_f32_peak"] == round(100 * fl / sec / 67e12, 2)
    assert summary["bottleneck_stage"] == stages[-1][0]
    rows, summary = roofline.roofline_table(measured=measured)
    assert "copy_ceiling_ms" not in rows[0]
    assert summary["copy_ceiling_gbps"] is None


def test_profile_stages_run_on_cpu():
    """Every stage of `profile_stages` runs on CPU tensors at a small
    frame (128 x 128 padded), with the shapes the stages hand on."""
    from pbmm_tpu_torch.tools import profile_stages

    stages = profile_stages.stages("cpu", h=96, w=120, t=2)
    assert [s[0] for s in stages][:4] == [
        "preprocess (pad+hann+yiq)", "amplify (bands+phase)",
        "postprocess (ifft+blur+crop)", "full pair (per frame)"]
    for name, fn, args in stages:
        out = fn(*args)
        first = out[0] if isinstance(out, (tuple, list)) else out
        assert torch.isfinite(torch.as_tensor(first).abs()).all(), name


@pytest.mark.parametrize("tool", ["kexp", "kdecomp", "trig_probe",
                                  "roofline", "profile_stages", "parity"])
def test_tools_need_a_card(tool, monkeypatch, capsys):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"pbmm_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert exc.value.code != 0
    assert "no CUDA card" in capsys.readouterr().err


def test_timed_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        kexp.timed(lambda x: x + 1, (torch.zeros(4),), reps=1, warmup=0)
