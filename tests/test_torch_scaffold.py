"""The PyTorch port's scaffold against the JAX package: config fields,
import isolation, and every host table the kernels and their plain
versions are built from."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbmm_tpu_torch
from pbmm_tpu import config as jcfg
from pbmm_tpu.core import window as jwin
from pbmm_tpu.spectral import fused as jfused
from pbmm_tpu.spectral import hermitian as jherm
from pbmm_tpu.spectral import pallas_fft as jfft
from pbmm_tpu_torch import config as tcfg
from pbmm_tpu_torch.core import window as twin
from pbmm_tpu_torch.spectral import fused as tfused
from pbmm_tpu_torch.spectral import hermitian as therm
from pbmm_tpu_torch.spectral import radix2 as tfft


def _main_cfg(mod):
    return mod.MagnifyConfig().tuned_for_tpu().replace(pad_mode="tight")


@pytest.mark.parametrize("cls", ["MagnifyConfig", "TemporalConfig"])
def test_config_fields_match(cls):
    jf = dataclasses.fields(getattr(jcfg, cls))
    tf = dataclasses.fields(getattr(tcfg, cls))
    assert [f.name for f in jf] == [f.name for f in tf]
    j_obj, t_obj = getattr(jcfg, cls)(), getattr(tcfg, cls)()
    for f in jf:
        jv, tv = getattr(j_obj, f.name), getattr(t_obj, f.name)
        if dataclasses.is_dataclass(jv):
            jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
        assert jv == tv, f.name


def test_config_presets_and_validation_match():
    assert (dataclasses.asdict(_main_cfg(jcfg))
            == dataclasses.asdict(_main_cfg(tcfg)))
    for bad in (dict(mode="x"), dict(pad_mode="tight", fft_backend="mxu"),
                dict(gm_precision="fast"), dict(pyramid_levels=0)):
        with pytest.raises(ValueError):
            jcfg.MagnifyConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.MagnifyConfig(**bad)


def _jax_package_refs(path):
    """Every import of jax or pbmm_tpu in a source file, and every path
    string under pbmm_tpu/ handed to a `load_by_path` call."""
    import ast

    tree = ast.parse(path.read_text(), filename=str(path))

    def bad(mod):
        return mod.split(".")[0] in ("jax", "pbmm_tpu")

    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if bad(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.module and bad(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if name in ("load_by_path", "spec_from_file_location"):
                for arg in node.args:
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and "pbmm_tpu/" in arg.value):
                        found.append(arg.value)
    return found


def test_import_leaves_jax_out():
    """Importing the port loads neither jax nor the JAX package, and
    chip_smoke.py (which runs where there is no JAX) imports neither and
    loads no file of the JAX package by path."""
    from pathlib import Path

    code = (
        "import sys, pbmm_tpu_torch, pbmm_tpu_torch.engine.state, "
        "pbmm_tpu_torch.kernels.build, pbmm_tpu_torch.io.stream, "
        "pbmm_tpu_torch.cli, pbmm_tpu_torch.oracle, "
        "pbmm_tpu_torch.engine.pipeline, pbmm_tpu_torch.phase.amplify, "
        "pbmm_tpu_torch.phase.standard, pbmm_tpu_torch.phase.fused_kernels, "
        "pbmm_tpu_torch.spectral.fft, pbmm_tpu_torch.core.complexop, "
        "pbmm_tpu_torch.pyramid.filters, pbmm_tpu_torch.utils.metrics, "
        "pbmm_tpu_torch.utils.checks, pbmm_tpu_torch.utils.profiling, "
        "pbmm_tpu_torch.utils.debug, pbmm_tpu_torch.tools.parity, "
        "pbmm_tpu_torch.tools.kexp, pbmm_tpu_torch.tools.kdecomp, "
        "pbmm_tpu_torch.tools.trig_probe, pbmm_tpu_torch.tools.roofline, "
        "pbmm_tpu_torch.tools.profile_stages\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pbmm_tpu' or m.startswith('pbmm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    root = Path(__file__).resolve().parents[1]
    assert _jax_package_refs(root / "chip_smoke.py") == []
    for src in sorted((root / "pbmm_tpu_torch").rglob("*.py")):
        assert _jax_package_refs(src) == [], src


def test_exports():
    assert pbmm_tpu_torch.magnify_video is not None
    assert pbmm_tpu_torch.MagnifyConfig is tcfg.MagnifyConfig
    assert pbmm_tpu_torch.TemporalConfig is tcfg.TemporalConfig


def _jax_planes(h, wk, fw):
    return jfused._static_phase_planes(_main_cfg(jcfg), h, wk, fw)


def _torch_planes(h, wk, fw):
    return tfused._static_phase_planes(_main_cfg(tcfg), h, wk, fw)


_WIDTHS = (128, 256, 512, 1024, 2048, 4096)
_GEOMS = ((1080, 1920, "tight"), (320, 384, "tight"), (720, 1280, "tight"),
          (300, 256, "square_pow2"), (720, 1280, "rect_pow2"))

# name -> (jax callable, port callable, argument tuples)
_TABLES = {
    "kept_tiles": (jherm.kept_tiles, therm.kept_tiles,
                   [(w,) for w in _WIDTHS]),
    "reconstruction_plan": (jherm.reconstruction_plan,
                            therm.reconstruction_plan,
                            [(w,) for w in _WIDTHS]),
    "_dif_twiddles": (jfft._dif_twiddles, tfft._dif_twiddles,
                      [(n, inv) for n in (128, 512, 2048)
                       for inv in (False, True)]),
    "bitrev_freq_axis": (jfft.bitrev_freq_axis, tfft.bitrev_freq_axis,
                         [(n,) for n in (8, 128, 2048)]),
    "col_freq_axis": (jfused.col_freq_axis, tfused.col_freq_axis,
                      [(n,) for n in (384, 1152, 512)]),
    "_fourstep_twiddle": (jfused._fourstep_twiddle, tfused._fourstep_twiddle,
                          [(h, inv) for h in (384, 1152)
                           for inv in (False, True)]),
    "_static_phase_planes": (_jax_planes, _torch_planes,
                             [(384, 384, 512), (1152, 384, 512),
                              (1152, 1152, 2048)]),
    "geometry_for": (jwin.geometry_for, twin.geometry_for, _GEOMS),
    "blur_taps": (jwin.blur_taps, twin.blur_taps, [(0.5,), (1.0,)]),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(_TABLES) + ["hann2d_region"])
def test_host_tables_match_jax(name):
    if name == "hann2d_region":
        for g in _GEOMS:
            want = np.asarray(jwin.hann2d_region(jwin.geometry_for(*g)))
            got = twin.hann2d_region(twin.geometry_for(*g)).numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            # Both evaluate cos in f32; the two libraries' cos differ by
            # an ulp or so.
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    jfn, tfn, cases = _TABLES[name]
    for args in cases:
        want, got = _flat(jfn(*args)), _flat(tfn(*args))
        assert len(want) == len(got), args
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape, args
            np.testing.assert_array_equal(a, b, err_msg=str(args))


def test_main_path_working_shapes():
    """At 1080p the carried spectrum is (1, 1152, 1152): nine of sixteen
    lane tiles kept, four-step rows of height 9 * 128."""
    from pbmm_tpu.engine.pipeline import hermitian_active as jha
    from pbmm_tpu_torch.engine.pipeline import hermitian_active as tha
    from pbmm_tpu_torch.engine.video import _working_width

    g = twin.geometry_for(1080, 1920, "tight")
    assert (g.pad_h, g.pad_w, g.y0, g.x0) == (1152, 2048, 36, 64)
    assert tha(_main_cfg(tcfg), g)
    assert jha(_main_cfg(jcfg), jwin.geometry_for(1080, 1920, "tight"))
    assert _working_width(_main_cfg(tcfg), g) == 1152
    assert therm.kept_segments(2048) == ((0, 3), (4, 6), (8, 12))


def test_fused_predicates_match():
    from pbmm_tpu.engine import post_pallas as jpost
    from pbmm_tpu.engine import pipeline as jpipe
    from pbmm_tpu_torch.engine import pipeline as tpipe
    from pbmm_tpu_torch.engine import post_fused as tpost

    for g in _GEOMS:
        jg, tg = jwin.geometry_for(*g), twin.geometry_for(*g)
        for jc, tc in ((_main_cfg(jcfg), _main_cfg(tcfg)),
                       (jcfg.MagnifyConfig(), tcfg.MagnifyConfig())):
            jr = jpipe.blur_row_window(jg, jc)
            assert tpipe.blur_row_window(tg, tc) == jr
            assert (tpost.post_pallas_ok(tg, tc, jr[0], jr[1] - jr[0])
                    == jpost.post_pallas_ok(jg, jc, jr[0], jr[1] - jr[0]))
            assert tpipe.hermitian_active(tc, tg) == jpipe.hermitian_active(
                jc, jg)
            assert tfused.fused_eligible(tc) == jfused.fused_eligible(jc)


def test_unit_float_matches():
    from pbmm_tpu.core.color import unit_float as jit_unit
    from pbmm_tpu_torch.core.color import unit_float as t_unit

    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(t_unit(torch.from_numpy(x)).numpy(),
                                  np.asarray(jit_unit(jnp.asarray(x))))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_the_card(where, tmp_path):
    """Without a CUDA card, or copied away from the repository, the chip
    smoke script exits non-zero and prints no result line."""
    import shutil
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
