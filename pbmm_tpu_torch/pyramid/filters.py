"""Radial filter-bank parameters.

Counterpart of `pbmm_tpu/pyramid/filters.py::radial_level_params`, the
single source of truth for the per-level ramps of the radial bank.
"""

from __future__ import annotations


def radial_level_params(levels: int, min_f: float, max_f: float):
    """(kind, lo, hi, amplified) per level, kind in {"high", "low", "band",
    "zero"}, exactly as `GeneratePyramidFilters` derives them
    (`PyramidOperations.compute:25-87`): level 0 high-pass ramps over
    [0.8*maxF, maxF]; level L-1 low-pass over [minF, 1.2*minF]; mid bands
    raised-cosine over [c/2, 3c/2] with geometric centre spacing; L=3
    hits the reference's NaN-ratio quirk -> all-zero mid mask."""
    lo_f, hi_f = float(min_f), float(max_f)
    out = []
    for i in range(levels):
        amp = 0 < i < levels - 1
        if i == 0:
            out.append(("high", 0.8 * hi_f, hi_f, False))
        elif i == levels - 1:
            out.append(("low", lo_f, 1.2 * lo_f, False))
        elif levels == 3:
            out.append(("zero", 0.0, 0.0, False))
        else:
            r = (i - 1) / (levels - 3)
            c = lo_f * (hi_f / lo_f) ** (1.0 - r)
            out.append(("band", 0.5 * c, 1.5 * c, amp))
    return tuple(out)
