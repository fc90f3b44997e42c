"""`correct`: the kept chunks' outputs against the reference.

For each kept chunk the reference (`reference/torch_ref.py`, float64)
works out the chunk's frames again from the source frames alone: the
stream's previous frame (two-frame), or with the IIR band-pass the taps
from the stream's start or from far enough back that what came before is
below 1e-12 rad (`Reference.iir_replay_frames`).  The program's output
is then compared at the precision it delivers:

- uint8 layouts: against round(255 x) of the reference; `mismatch_pct`
  is the share of values that differ, `max_level_gap` the largest
  difference in levels;
- float32 layouts: `min_psnr_db`, the lowest PSNR of a frame against the
  reference (peak 1), and `max_err_levels`, 255 times the largest
  absolute error.

`limits/<cell>.json` says which numbers are compared and their limits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.metrics import psnr_frames
from portbench.reference.torch_ref import Reference


def reference_chunk(ref: Reference, ring, kept, t: int, iir: bool):
    """The reference's output for a kept chunk, (T, H, W, 3)."""
    r = ring.shape[0]

    def frames(first, last):  # stream positions [first, last)
        return [ring[(kept.offset + q) % r] for q in range(first, last)]

    if iir:
        start = max(0, kept.pos - ref.iir_replay_frames())
        return ref.iir(frames(start, kept.pos + t), keep=t)
    return ref.two_frame(frames(kept.pos - 1, kept.pos)[0],
                         frames(kept.pos, kept.pos + t))


def compare(prog: torch.Tensor, ref: torch.Tensor, layout: str) -> dict:
    """One chunk's program output (in its layout) against the reference
    (T, H, W, 3) in [0, 1]."""
    out = prog.to(ref.device)
    if layout in ("planar_u8", "planar"):
        out = out.permute(0, 2, 3, 1)
    if layout == "planar_u8":
        d = (out.to(torch.float64) - torch.round(ref * 255.0)).abs()
        return {"values": d.numel(), "mismatches": int((d > 0).sum()),
                "max_gap": float(d.max())}
    err = (out.to(torch.float64) - ref).abs()
    return {"max_err": float(err.max()),
            "min_psnr": min(psnr_frames(out, ref))}


def numbers(parts: List[dict], layout: str) -> Dict[str, float]:
    if layout == "planar_u8":
        return {"mismatch_pct": 100.0 * sum(p["mismatches"] for p in parts)
                / sum(p["values"] for p in parts),
                "max_level_gap": max(p["max_gap"] for p in parts)}
    return {"min_psnr_db": min(p["min_psnr"] for p in parts),
            "max_err_levels": 255.0 * max(p["max_err"] for p in parts)}


def measure(kept, ring, cfg: dict, traffic: dict, h: int, w: int, device,
            store=None) -> Dict[str, float]:
    """The compared numbers over the kept chunks; with `store` the
    reference in that precision takes the program's place (the
    control)."""
    ref = Reference(cfg, h, w, device)
    low = Reference(cfg, h, w, device, store=store) if store else None
    iir = cfg["temporal"]["mode"] == "iir_bandpass"
    t = traffic["chunk_frames"]
    layout = traffic["output_layout"]
    parts = []
    with torch.no_grad():
        for k in kept:
            want = reference_chunk(ref, ring, k, t, iir)
            if low is None:
                got = k.output
            else:
                got = _as_layout(reference_chunk(low, ring, k, t, iir),
                                 layout)
            parts.append(compare(got, want, layout))
    return numbers(parts, layout)


def _as_layout(rgb: torch.Tensor, layout: str) -> torch.Tensor:
    """A (T, H, W, 3) result in [0, 1] in a program output layout."""
    if layout == "planar_u8":
        return torch.round(rgb.permute(0, 3, 1, 2) * 255.0).to(torch.uint8)
    if layout == "planar":
        return rgb.permute(0, 3, 1, 2).to(torch.float32)
    return rgb.to(torch.float32)


def judge(values: Dict[str, float], limits: dict):
    """-> (correct, [(name, value, rule, limit, ok)]) for the compared
    numbers; `limits["compared"]` maps a name to {"max": x} or
    {"min": x}."""
    rows = []
    for name, rule in limits["compared"].items():
        v = values[name]
        if "max" in rule:
            rows.append((name, v, "<=", rule["max"], bool(v <= rule["max"])))
        else:
            rows.append((name, v, ">=", rule["min"], bool(v >= rule["min"])))
    return all(r[-1] for r in rows) and bool(rows), rows


def finite(x: float) -> float:
    """PSNR of identical frames is +inf; JSON has no infinity."""
    return x if np.isfinite(x) else 1e9
