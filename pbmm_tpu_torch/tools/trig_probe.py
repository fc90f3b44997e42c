"""Probe of the phase pass's transcendentals on the card (kernel 14).

    python -m pbmm_tpu_torch.tools.trig_probe

Counterpart of `benchmarks/trig_probe.py`.  The TPU phase pass evaluates
atan2, sin and cos as polynomials; the port's (`csrc/phase_pass.cuh`,
inlined by kernels 2 and 6) uses IEEE `atan2f`, `sincosf` and `cosf`
(built without fast math) and small helpers.  `trig_probe` runs each of
them elementwise in one launch of `csrc/trig_probe.cu`, which includes
that header, and `run_probe` holds every result against fp64 numpy with
the JAX probe's tolerances (1e-5; 3e-5 for the rotation at |theta| <= 90;
1e-3 for a whole standard-mode bin) and against the op's plain PyTorch
version, on the JAX probe's inputs plus signed and exact zeros.  The
standard mode's w plane comes from the host function kernels 2 and 6
read it from (`spectral.fused.standard_weight`); it is held against the
fp64 formula here too (1e-4).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
    stream_handle,
)
from pbmm_tpu_torch.spectral import fused

# op name -> (op code of csrc/trig_probe.cu, inputs, outputs)
OPS = {
    "atan2": (0, 2, 1),
    "cos": (1, 1, 1),
    "sin": (2, 1, 1),
    "sincos": (3, 1, 2),
    "mask": (4, 1, 1),
    "pow_int": (5, 1, 1),
    "unit_pow": (6, 2, 2),
    "phase_std": (7, 5, 2),
}


def _probe_args(op, ins, arg, cfg, fy, fx):
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")
    _, n_in, _ = OPS[op]
    if len(ins) != n_in:
        raise ValueError(f"{op} takes {n_in} input planes, got {len(ins)}")
    if ins[0].ndim != 2:
        raise ValueError(f"expected (rows, w) planes, got "
                         f"{tuple(ins[0].shape)}")
    if op == "mask" and not 0 <= arg < len(fused._MASK_KINDS):
        raise ValueError(f"mask kind index {arg} outside 0..3")
    if op in ("pow_int", "unit_pow") and not 0 <= arg <= 64:
        raise ValueError(f"power {arg} outside 0..64")
    if op == "phase_std":
        if cfg is None or cfg.mode != "standard" or (
                cfg.temporal.mode != "two_frame"):
            raise ValueError("phase_std takes a two-frame standard-mode cfg")
        rows, w = ins[0].shape
        if fy is None or fx is None or fy.shape != (rows,) or (
                fx.shape != (w,)):
            raise ValueError("phase_std takes fy (rows,) and fx (w,)")


def trig_probe_ref(op: str, *ins, arg: int = 0, consts=(0.0, 0.0),
                   cfg=None, fy=None, fx=None):
    """Plain PyTorch version of `trig_probe`: the same functions as the
    port's plain phase pass computes them (`spectral/fused.py`)."""
    _probe_args(op, ins, arg, cfg, fy, fx)
    if op == "atan2":
        return (fused._atan2z(ins[0], ins[1]),)
    if op == "cos":
        return (torch.cos(ins[0]),)
    if op == "sin":
        return (torch.sin(ins[0]),)
    if op == "sincos":
        return torch.cos(ins[0]), torch.sin(ins[0])
    if op == "mask":
        return (fused._eval_mask(fused._MASK_KINDS[arg], consts[0],
                                 consts[1], ins[0]),)
    if op == "pow_int":
        return (fused._pow_int(ins[0], arg),)
    if op == "unit_pow":
        return fused._unit_pow(ins[0], ins[1], arg)
    cr, ci, pr, pi_, w_plane = ins
    return fused._phase_block_ref(cr, ci, pr, pi_, fy[:, None], fx[None, :],
                                  cfg, static_planes=(w_plane,))[:2]


@checked
def trig_probe(op: str, *ins, arg: int = 0, consts=(0.0, 0.0), cfg=None,
               fy=None, fx=None):
    """One of the phase pass's functions elementwise on (rows, w) f32
    planes; returns a tuple of one or two planes.

      atan2(y, x)     -0 counted as +0, 0 at (0, 0)   (cs_atan2)
      cos(u), sin(u)                                  (cosf, sinf)
      sincos(t)       (cos t, sin t)                  (sincosf)
      mask(f)         radial mask of kind `arg` (0 zero, 1 high, 2 low,
                      3 band) on [lo, hi] = `consts`  (cs_mask)
      pow_int(x)      x ** `arg`                       (cs_pow_int)
      unit_pow(re, im)  unit(re + i im) ** `arg`       (cs_unit_pow)
      phase_std(cr, ci, pr, pi, w)  one standard-mode bin of `cfg`, cur
                      against prev, w the host weight plane, fy (rows,)
                      and fx (w,) the frequencies      (pbmm_phase_bin)

    CPU tensors take `trig_probe_ref`; CUDA tensors launch
    `csrc/trig_probe.cu`."""
    if ins[0].device.type == "cpu":
        return trig_probe_ref(op, *ins, arg=arg, consts=consts, cfg=cfg,
                              fy=fy, fx=fx)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    _probe_args(op, ins, arg, cfg, fy, fx)
    code, _, n_out = OPS[op]
    rows, w = ins[0].shape
    check_cuda("trig_probe", (rows, w), *ins)
    dev = ins[0].device
    ints, floats = [0], [0.0]
    freqs = (None, None)
    if op == "phase_std":
        ints, floats = fused._phase_args(fused._phase_plan(cfg), True)
        check_cuda("trig_probe", (rows,), fy)
        check_cuda("trig_probe", (w,), fx)
        freqs = (fy, fx)
    lo, hi = (float(c) for c in consts)
    outs = tuple(torch.empty((rows, w), dtype=torch.float32, device=dev)
                 for _ in range(n_out))
    ptrs = [x.data_ptr() for x in ins] + [None] * (5 - len(ins))
    ptrs += [None if x is None else x.data_ptr() for x in freqs]
    ptrs += [outs[0].data_ptr(), outs[1].data_ptr() if n_out > 1 else None]
    err = library().pbmm_trig_probe(
        *ptrs, c_ints(ints), c_floats(floats), code, int(arg), lo, hi,
        hi - lo, rows * w, w, stream_handle(dev))
    check_launch(err, "trig_probe")
    trig_probe.launches += 1
    return outs


trig_probe.launches = 0


def probe_inputs(seed: int = 0):
    """The JAX probe's inputs (`trig_probe.py:51-130`, (8, 128) planes
    from numpy with `seed`), each extended by 8 rows of edge values:
    signed zeros, the branch cut and exact-zero bins.  name -> dict of
    float32 arrays."""
    rng = np.random.default_rng(seed)
    n = 8 * 128

    def plane(v):
        return np.asarray(v, np.float32).reshape(8, 128)

    def extend(a, edge):
        e = np.resize(np.asarray(edge, np.float32), 8 * 128).reshape(8, 128)
        return np.concatenate([a, e]).astype(np.float32)

    y = plane(rng.standard_normal(n))
    x = plane(rng.standard_normal(n))
    u = plane(rng.random(n) * 2 * np.pi - np.pi)
    th = plane(rng.standard_normal(n) * 30)
    f = plane(rng.random(n) * 0.75)
    cr = plane(rng.standard_normal(n))
    ci = plane(rng.standard_normal(n))
    pr = plane(cr + 0.05 * rng.standard_normal(n).reshape(8, 128))
    pi_ = plane(ci + 0.05 * rng.standard_normal(n).reshape(8, 128))
    fy = (rng.random(8) - 0.5).astype(np.float32)
    fx = (rng.random(128) - 0.5).astype(np.float32)
    zeros = [0.0, -0.0]
    return {
        # (y, x) over all quadrants, then (+-0, +-0), (-0, -1), (+0, -1)
        "atan2": dict(y=extend(y, [0.0, -0.0, 0.0, -0.0, -0.0, 0.0]),
                      x=extend(x, [0.0, 0.0, -0.0, -0.0, -1.0, -1.0])),
        "trig": dict(u=extend(u, [0.0, -0.0, np.pi, -np.pi])),
        "sincos": dict(t=extend(th, [0.0, -0.0, 90.0, -90.0])),
        "mask": dict(f=extend(f, [0.0, 0.75, 0.05, 0.45])),
        "pow": dict(x=extend(np.abs(x) / 4, zeros)),
        "unit": dict(re=extend(x, zeros), im=extend(y, zeros)),
        # the standard bin; its edge rows hold exact zeros in cur and prev
        "phase": dict(cr=extend(cr, zeros), ci=extend(ci, zeros),
                      pr=extend(pr, zeros), pi=extend(pi_, zeros),
                      fy=np.concatenate([fy, fy]), fx=fx),
    }


def _fp64_mask(kind, lo, hi, f):
    t = np.clip((f - lo) / (hi - lo), 0.0, 1.0)
    if kind == "zero":
        return np.zeros_like(f)
    if kind == "high":
        return np.where(f > hi, 1.0, np.where(f > lo, t * t * (3 - 2 * t),
                                              0.0))
    if kind == "low":
        return np.where(f < lo, 1.0, np.where(
            f < hi, 1.0 - t * t * (3 - 2 * t), 0.0))
    return np.where((f >= lo) & (f <= hi),
                    0.5 * (1.0 + np.cos(2 * np.pi * (t - 0.5))), 0.0)


def fp64_standard_weight(freq, cfg):
    """The standard weight in fp64, written out as `trig_probe.py:82-95`
    writes it (the oracle's formula pointwise)."""
    ff = np.minimum(np.asarray(freq, np.float64) / 0.707, 1.0)
    w = np.ones_like(ff)
    w = np.where(ff < cfg.low_freq_cutoff,
                 (ff / max(cfg.low_freq_cutoff, 1e-3))
                 ** cfg.filter_steepness, w)
    w = np.where(ff > cfg.high_freq_cutoff,
                 ((1 - ff) / max(1 - cfg.high_freq_cutoff, 1e-3))
                 ** cfg.filter_steepness, w)
    w *= cfg.motion_sensitivity
    mid = (ff > cfg.low_freq_cutoff) & (ff < cfg.high_freq_cutoff)
    w = np.where(mid, w * (1 + cfg.edge_enhancement * np.sin(
        np.pi * (ff - cfg.low_freq_cutoff)
        / (cfg.high_freq_cutoff - cfg.low_freq_cutoff))), w)
    return np.maximum(w, 0.0)


def probe_cases(seed: int = 0):
    """[(name, op, numpy inputs, kwargs, fp64 results, tolerance)]: every
    op of `OPS` on `probe_inputs(seed)`."""
    from pbmm_tpu_torch.config import MagnifyConfig

    inp = probe_inputs(seed)
    d = {k: {n: v.astype(np.float64) for n, v in a.items()}
         for k, a in inp.items()}
    cases = [
        ("atan2", "atan2", (inp["atan2"]["y"], inp["atan2"]["x"]), {},
         # the +0 convention: -0 + 0 is +0 in fp64 as in the kernel
         (np.arctan2(d["atan2"]["y"] + 0.0, d["atan2"]["x"] + 0.0),), 1e-5),
        ("cos", "cos", (inp["trig"]["u"],), {}, (np.cos(d["trig"]["u"]),),
         1e-5),
        ("sin", "sin", (inp["trig"]["u"],), {}, (np.sin(d["trig"]["u"]),),
         1e-5),
        ("sincos", "sincos", (inp["sincos"]["t"],), {},
         (np.cos(d["sincos"]["t"]), np.sin(d["sincos"]["t"])), 3e-5),
    ]
    lo, hi = 0.05, 0.45
    for kind in range(4):
        name = fused._MASK_KINDS[kind]
        cases.append((f"mask[{name}]", "mask", (inp["mask"]["f"],),
                      dict(arg=kind, consts=(lo, hi)),
                      (_fp64_mask(name, lo, hi, d["mask"]["f"]),), 1e-5))
    for n in (0, 3, 10):
        cases.append((f"pow_int[{n}]", "pow_int", (inp["pow"]["x"],),
                      dict(arg=n), (d["pow"]["x"] ** n,), 1e-5))
        z = d["unit"]["re"] + 1j * d["unit"]["im"]
        mag = np.abs(z)
        q = np.where(mag > 0, z / np.where(mag > 0, mag, 1.0), 0.0) ** n
        if n == 0:
            q = np.ones_like(z)
        cases.append((f"unit_pow[{n}]", "unit_pow",
                      (inp["unit"]["re"], inp["unit"]["im"]), dict(arg=n),
                      (q.real, q.imag), 1e-5))
    cfg = MagnifyConfig(mode="standard")
    ph = inp["phase"]
    freq = np.hypot(ph["fy"].astype(np.float64)[:, None],
                    ph["fx"].astype(np.float64)[None, :])
    w_plane = fused.standard_weight(freq, cfg).astype(np.float32)
    c = d["phase"]["cr"] + 1j * d["phase"]["ci"]
    p = d["phase"]["pr"] + 1j * d["phase"]["pi"]
    gate = ((np.abs(c) ** 2 < cfg.magnitude_threshold ** 2)
            | (np.abs(p) ** 2 < cfg.magnitude_threshold ** 2))
    delta = np.angle(p * np.conj(c))
    out = np.where(gate, c, c * np.exp(
        1j * delta * fp64_standard_weight(freq, cfg) * cfg.phase_scale))
    cases.append(("phase_std", "phase_std",
                  (ph["cr"], ph["ci"], ph["pr"], ph["pi"], w_plane),
                  dict(cfg=cfg, fy=ph["fy"], fx=ph["fx"]),
                  (out.real, out.imag), 1e-3))
    return cases


def run_probe(device, seed: int = 0):
    """Every case of `probe_cases` through `trig_probe` on `device`, held
    against fp64 and against `trig_probe_ref` on the same tensors.
    Returns one dict a case: name, max error against fp64 and its
    tolerance, max abs difference from the plain version, whether every
    output is finite, ok."""
    rows = []
    for name, op, ins, kw, want, tol in probe_cases(seed):
        kw = dict(kw)
        for k in ("fy", "fx"):
            if k in kw:
                kw[k] = torch.from_numpy(kw[k]).to(device)
        ts = [torch.from_numpy(a).to(device) for a in ins]
        got = trig_probe(op, *ts, **kw)
        plain = trig_probe_ref(op, *ts, **kw)
        err = max(float(np.abs(g.double().cpu().numpy() - w).max())
                  for g, w in zip(got, want))
        vs_plain = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        rows.append(dict(name=name, max_err=err, tol=tol,
                         max_abs_vs_plain=vs_plain, finite=finite,
                         ok=finite and err <= tol))
    w_err = standard_weight_error(seed)
    rows.append(dict(name="standard_weight (host plane)", max_err=w_err,
                     tol=1e-4, max_abs_vs_plain=0.0, finite=True,
                     ok=w_err <= 1e-4))
    return rows


def standard_weight_error(seed: int = 0) -> float:
    """Max abs error of the f32 host w plane kernels 2 and 6 read against
    the fp64 formula, at the JAX probe's frequencies (`trig_probe.py:
    74-96` checks its in-kernel weight the same way, to 1e-4)."""
    from pbmm_tpu_torch.config import MagnifyConfig

    cfg = MagnifyConfig(mode="standard")
    rng = np.random.default_rng(seed)
    f = (rng.random(8 * 128) * 0.75).astype(np.float32).astype(np.float64)
    return float(np.abs(fused.standard_weight(f, cfg).astype(np.float32)
                        - fp64_standard_weight(f, cfg)).max())


def main(argv=None) -> int:
    from pbmm_tpu_torch.tools import require_card

    dev = require_card("trig_probe")
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    rows = run_probe(dev)
    for r in rows:
        print(f"{r['name']:28s} max_err={r['max_err']:.3e} (tol "
              f"{r['tol']:g}) vs plain {r['max_abs_vs_plain']:.3e}"
              f"{'' if r['ok'] else '  <-- BAD'}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
