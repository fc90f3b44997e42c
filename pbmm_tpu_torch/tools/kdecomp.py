"""Kernel 6's device time split into its pieces (kernel 12).

    python -m pbmm_tpu_torch.tools.kdecomp [--reps 20]

Counterpart of `benchmarks/kdecomp.py`.  `kdecomp_variant` is kernel 6
(`csrc/phase_col_ifft.cu`: one frame's phase pass + radix-2 column IFFT,
rows [r0, r1) out) with its pieces toggled, on kernel 6's own launch,
strips and in-block passes throughout (`csrc/kdecomp.cu`; kernel 6's body
is kernel 2's launch 2), so that the difference between two variants is
the cost of one piece:

    "stream only"   the strip of cur + prev in and rows out, no work:
                    on strips of 4 and more the phase strip's
                    asynchronous copies of cur and prev through its ring
                    (`fused.phase_strip_smem`), element loads on 2 and 1
    "gm"            the inverse stages of span 1 .. 64 (the seven the TPU
                    runs as one 128 x 128 group matmul)
    "rolls"         the stages of span 128 and more
    "phase"         the band/phase pass

`main()` times the six variants of `kdecomp.py:140-147` and kernel 6 at
H = 2048, 1152 kept lanes and rows (384, 1600) with `tuned_for_tpu()` on
the card, warm and cold (`tools.kexp.timed`), on one frame or a stack
(`--frames 16`: kernel 2's launch-2 frame count on a chunk of 16), and
prints each piece's share.
"""

from __future__ import annotations

import sys

import torch

from pbmm_tpu_torch.kernels import (
    c_floats,
    c_ints,
    check_cuda,
    checked,
    device_arrays,
    stream_handle,
)
from pbmm_tpu_torch.spectral import fused
from pbmm_tpu_torch.spectral.radix2 import (
    _dif_twiddles,
    check_pow2,
    compact_twiddles,
)
from pbmm_tpu_torch.utils.profiling import counted

VARIANTS = (
    ("stream only", frozenset()),
    ("+gm matmul", frozenset({"gm"})),
    ("+rolls", frozenset({"rolls"})),
    ("+gm+rolls", frozenset({"gm", "rolls"})),
    ("+phase", frozenset({"phase"})),
    ("+phase+gm+rolls (full)", frozenset({"phase", "gm", "rolls"})),
)
_BITS = {"phase": 1, "gm": 2, "rolls": 4}
_GROUP_STAGES = 7  # spans 1 .. 64 lie inside one 128-row group


def _kdecomp_args(cur_re, cfg, pieces, rows):
    """Validate a call; returns the pieces as the kernel's bit set."""
    if not set(pieces) <= set(_BITS):
        raise ValueError(f"pieces {sorted(pieces)} not a subset of "
                         f"{sorted(_BITS)}")
    _, h, _ = cur_re.shape
    check_pow2(h, "radix-2 column height")
    if not 0 <= rows[0] < rows[1] <= h:
        raise ValueError(f"bad rows {rows} for H={h}")
    if "phase" in pieces and cfg.temporal.mode != "two_frame":
        raise ValueError("kdecomp times the two-frame phase pass")
    return sum(_BITS[p] for p in pieces)


def _inverse_stages_ref(re, im, stages):
    """The DIT inverse stages `stages` (stage s has span 2**s) down the
    rows of (B, H, W) planes, each product and sum in f32 as
    `common.cuh::pbmm_radix2_stage`."""
    b, h, w = re.shape
    twr, twi = device_arrays(_dif_twiddles, (h, True), re.device)
    for s in stages:
        d = 1 << s
        shape = (b, h // (2 * d), 2, d, w)
        x_re, x_im = re.reshape(shape), im.reshape(shape)
        tr = twr[s].reshape(h // (2 * d), 2, d)[:, 1, :, None]
        ti = twi[s].reshape(h // (2 * d), 2, d)[:, 1, :, None]
        ur, ui = x_re[:, :, 1], x_im[:, :, 1]
        zr = ur * tr - ui * ti
        zi = ur * ti + ui * tr
        xr, xi = x_re[:, :, 0], x_im[:, :, 0]
        re = torch.stack([xr + zr, xr - zr], dim=2).reshape(b, h, w)
        im = torch.stack([xi + zi, xi - zi], dim=2).reshape(b, h, w)
    return re, im


def kdecomp_variant_ref(cur_re, cur_im, prev_re, prev_im, cfg, pieces,
                        rows, full_w=None):
    """Plain PyTorch version of `kdecomp_variant`, in kernel 6's order:
    the phase pass (`_phase_block_ref` on the host planes) or cur + prev,
    then the chosen inverse stages, rows [r0, r1).  Both stage groups
    together are the whole inverse, taken as `phase_col_ifft_ref` takes
    it (`torch.fft`), so the full variant is `phase_col_ifft_ref`."""
    _kdecomp_args(cur_re, cfg, pieces, rows)
    r0, r1 = rows
    if {"gm", "rolls"} <= set(pieces) and "phase" in pieces:
        return fused.phase_col_ifft_ref(cur_re, cur_im, prev_re, prev_im, cfg,
                                        out_rows=rows, full_w=full_w)
    b, h, w = cur_re.shape
    if "phase" in pieces:
        dev = cur_re.device
        host = fused._static_phase_planes(cfg, h, w, full_w)
        if host is not None:
            host = device_arrays(fused._static_phase_planes,
                                 (cfg, h, w, full_w), dev)
        fy, fx = device_arrays(fused._freq_tables, (h, w, full_w), dev)
        res = [fused._phase_block_ref(cur_re[f], cur_im[f], prev_re[f],
                                      prev_im[f], fy, fx, cfg,
                                      static_planes=host)
               for f in range(b)]
        re = torch.stack([r[0] for r in res])
        im = torch.stack([r[1] for r in res])
    else:
        re, im = cur_re + prev_re, cur_im + prev_im
    if {"gm", "rolls"} <= set(pieces):
        order = torch.as_tensor(fused._col_order(h), device=re.device)
        nat = torch.empty((b, h, w), dtype=torch.complex64, device=re.device)
        nat[:, order] = torch.complex(re, im)
        z = torch.fft.ifft(nat, dim=1, norm="forward")[:, r0:r1]
        return z.real.contiguous(), z.imag.contiguous()
    n = h.bit_length() - 1
    stages = [s for s in range(n) if (s < _GROUP_STAGES and "gm" in pieces)
              or (s >= _GROUP_STAGES and "rolls" in pieces)]
    re, im = _inverse_stages_ref(re, im, stages)
    return re[:, r0:r1].contiguous(), im[:, r0:r1].contiguous()


@checked
def kdecomp_variant(cur_re, cur_im, prev_re, prev_im, cfg, pieces, rows,
                    full_w=None):
    """(B, H, W) spectra pair in kernel 6's working layout -> the variant
    `pieces` (a subset of {"phase", "gm", "rolls"}) of kernel 6: (re, im)
    each (B, r1 - r0, W) f32.  With all three pieces it computes kernel 6
    (`fused.phase_col_ifft`) bit for bit.

    CPU tensors take `kdecomp_variant_ref`; CUDA tensors launch
    `csrc/kdecomp.cu`."""
    if cur_re.device.type == "cpu":
        return kdecomp_variant_ref(cur_re, cur_im, prev_re, prev_im, cfg,
                                   pieces, rows, full_w)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    bits = _kdecomp_args(cur_re, cfg, pieces, rows)
    b, h, w = cur_re.shape
    if w % fused.col_strip(h):
        raise ValueError(f"the CUDA kernel takes widths that are multiples "
                         f"of {fused.col_strip(h)} at H = {h}, got {w}")
    check_cuda("kdecomp_variant", (b, h, w), cur_re, cur_im, prev_re,
               prev_im)
    cur_re, cur_im, prev_re, prev_im = fused.aligned16(cur_re, cur_im,
                                                       prev_re, prev_im)
    dev = cur_re.device
    host = fused._static_phase_planes(cfg, h, w, full_w)
    planes_d = (device_arrays(fused._static_phase_planes, (cfg, h, w, full_w),
                              dev) if host is not None else ())
    planes_d = planes_d + (None,) * (2 - len(planes_d))
    fy, fx = device_arrays(fused._freq_tables, (h, w, full_w), dev)
    twr, twi = device_arrays(compact_twiddles, (h, True), dev)
    r0, r1 = rows
    outs = [torch.empty((b, r1 - r0, w), dtype=torch.float32, device=dev)
            for _ in range(2)]
    sc = fused._scratch((b, h, w), h > fused.BLOCK_N and "rolls" in pieces,
                        dev)
    ints, floats = fused._phase_args(fused._phase_plan(cfg),
                                     host is not None)
    ins = (cur_re, cur_im, prev_re, prev_im) + planes_d + (fy, fx, twr, twi)
    err = library().pbmm_kdecomp(
        *fused._ptrs(*(ins + tuple(outs) + sc)),
        c_ints(ints), c_floats(floats), bits, b, h, w, r0, r1,
        fused.phase_col_strip(h, w), stream_handle(dev))
    check_launch(err, "kdecomp_variant")
    kdecomp_variant.launches += 1
    return tuple(outs)


counted(kdecomp_variant)


def kdecomp_inputs(device, h: int = 2048, wk: int = 1152, seed: int = 0,
                   frames: int = 1):
    """kdecomp.py's four (frames, h, wk) planes: uniform [0, 1) from
    numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((frames, h, wk), np.float32)).to(
        device) for _ in range(4)]


KERNEL6 = "kernel 6 (phase_col_ifft)"


def run_kdecomp(device, h: int = 2048, wk: int = 1152, rows=(384, 1600),
                cfg=None, reps: int = 20, frames: int = 1):
    """Each variant of `VARIANTS`, then kernel 6 (`KERNEL6`) on the same
    planes and rows, timed on the card: [(name, warm ms, cold ms)],
    kdecomp.py's shapes by default."""
    from pbmm_tpu_torch.config import MagnifyConfig
    from pbmm_tpu_torch.tools.kexp import timed

    cfg = cfg or MagnifyConfig().tuned_for_tpu()
    arrs = kdecomp_inputs(device, h, wk, frames=frames)
    full_w = 2048 if wk != 2048 else None  # kdecomp.py's lanes: W = 2048
    fns = [(name, lambda *a, p=pieces: kdecomp_variant(
        *a, cfg, p, rows, full_w=full_w)) for name, pieces in VARIANTS]
    fns.append((KERNEL6, lambda *a: fused.phase_col_ifft(
        *a, cfg, out_rows=rows, full_w=full_w)))
    for _ in range(5):  # the card's clocks up before the first variant
        for _, fn in fns:
            fn(*arrs)
    return [(name, *timed(fn, arrs, reps=reps)) for name, fn in fns]


def split(times):
    """Each piece's share from `run_kdecomp`'s (name, warm, cold) rows:
    name -> (warm ms, cold ms) of the stream, the span < 128 stages, the
    span >= 128 stages, the phase pass and the whole kernel (and kernel 6,
    where timed)."""
    t = {name: (w, c) for name, w, c in times}
    base = t["stream only"]

    def minus(name):
        return tuple(a - b for a, b in zip(t[name], base))

    out = {"stream": base, "early stages (span < 128)": minus("+gm matmul"),
           "late stages (span >= 128)": minus("+rolls"),
           "phase": minus("+phase"), "full": t["+phase+gm+rolls (full)"]}
    if KERNEL6 in t:
        out["kernel 6"] = t[KERNEL6]
    return out


def main(argv=None) -> int:
    import argparse

    from pbmm_tpu_torch.tools import require_card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=1)
    args = ap.parse_args(argv)
    dev = require_card("kdecomp")
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    times = run_kdecomp(dev, reps=args.reps, frames=args.frames)
    for name, warm, cold in times:
        print(f"{name:24s} {warm:7.3f} ms warm {cold:7.3f} ms cold",
              flush=True)
    for name, (warm, cold) in split(times).items():
        print(f"  {name:28s} {warm:7.3f} ms warm {cold:7.3f} ms cold")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
