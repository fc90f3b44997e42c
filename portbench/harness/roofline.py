"""The least work of a chunk and of its stages, from the cell's shapes,
against the H100's published peaks.

The arithmetic is a frozen copy of `pbmm_tpu_torch/tools/roofline.py`
(`hot_path_stages`, `hot_path_stages_u8`) at commit 46ab5a86602a, with
the geometry helpers it imported from the program restated here
(`core/window.py::geometry_for`, `blur_taps`; `spectral/fused.py::
aligned_row_window` with its 64-row quantum; `spectral/hermitian.py::
kept_tiles`), and generalised over the cell's planes, chunk length and
frame formats:

- bytes: each operand read once and each result written once at the
  stage's boundary (constants ignored); the carried state (the previous
  spectrum, and with the IIR band-pass the two taps, each (C, Hp, Wk)
  f32) read and written once a chunk, as the kernel table's bounds count
  it;
- operations: 5 N log2 N per complex transform of N points, and the
  per-element counts of the JAX model.

A bound is the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s
(f32 outside the tensor cores: no stage uses them).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

_F = 4  # f32 bytes
_ROW_BLOCK = 64
_LANE = 128
_IN_BYTES = {"u8_planar": 1, "f32_interleaved": 4}
_OUT_BYTES = {"planar_u8": 1, "planar": 4, "interleaved": 4}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _kept_width(w: int) -> int:
    t = w // _LANE
    if w % _LANE or t < 4:
        return w
    kept = 2
    b = 2
    while b < t:
        kept += b // 2
        b *= 2
    return kept * _LANE


def _row_window(lo: int, hi: int, pad_h: int) -> Tuple[int, int]:
    return (max(0, (lo // _ROW_BLOCK) * _ROW_BLOCK),
            min(pad_h, -(-hi // _ROW_BLOCK) * _ROW_BLOCK))


def _blur_taps(blur_size: float) -> int:
    offs = np.array([1.3846153846, 3.2307692308]) * blur_size
    return 2 * int(np.ceil(offs.max())) + 1


def geometry(cfg: dict, h: int, w: int) -> Dict[str, int]:
    """Padded sizes and row windows of the tuned fused path (the tight
    pad or a power of two) with the Hermitian-half kept lanes."""
    if cfg["pad_mode"] == "tight":
        hp, wp = max(-(-h // 128) * 128, 128), _next_pow2(w)
    elif cfg["pad_mode"] == "rect_pow2":
        hp, wp = _next_pow2(h), _next_pow2(w)
    else:
        hp = wp = _next_pow2(max(h, w))
    y0 = (hp - h) // 2
    taps = _blur_taps(cfg["blur_size"])
    radius = (taps - 1) // 2
    r0, r1 = _row_window(y0, y0 + h, hp)
    b0, b1 = _row_window(y0 - radius, y0 + h + radius, hp)
    return {"h": h, "w": w, "hp": hp, "wp": wp, "wk": _kept_width(wp),
            "hc": r1 - r0, "hr": b1 - b0, "taps": taps}


class ChunkWork:
    """(bytes, f32 operations) of one chunk of `t` frames and of its
    stages, for a configuration's "magnify" dict and the traffic's frame
    format and output layout."""

    def __init__(self, cfg: dict, h: int, w: int, t: int, fmt: str,
                 out_layout: str):
        self.g = geometry(cfg, h, w)
        self.t = t
        self.c = 3 if cfg["chroma"] == "rgb" else 1
        self.iir = cfg["temporal"]["mode"] == "iir_bandpass"
        self.e_in = _IN_BYTES[fmt]
        self.e_out = _OUT_BYTES[out_layout]

    def _frames_in(self) -> int:
        g = self.g
        return self.t * g["h"] * g["w"] * 3 * self.e_in

    def _frames_out(self) -> int:
        g = self.g
        return self.t * g["h"] * g["w"] * 3 * self.e_out

    def _state(self) -> int:
        """Bytes of the carried state, read or written once."""
        g = self.g
        arrays = 4 if self.iir else 2
        return self.c * arrays * g["hp"] * g["wk"] * _F

    def _row_fft_ops(self, rows: int) -> float:
        g = self.g
        return rows * 5 * g["wp"] * math.log2(g["wp"])

    def _col_fft_ops(self) -> float:
        g = self.g
        return 2 * g["wk"] * 5 * g["hp"] * math.log2(g["hp"])

    def stage(self, name: str) -> Tuple[int, float]:
        g, t, c = self.g, self.t, self.c
        rows_c = 2 * c * t * g["hc"] * g["wk"] * _F
        rows_r = 2 * c * t * g["hr"] * g["wk"] * _F
        hw = g["h"] * g["w"]
        if name == "frontend":
            ops = c * t * (self._row_fft_ops(g["hc"]) + 2 * g["hc"] * g["wp"]
                           + 5 * hw)
            return self._frames_in() + rows_c, ops
        if name == "colspec":
            ops = c * t * (self._col_fft_ops() + g["hp"] * g["wk"] * 80)
            return rows_c + rows_r + 2 * self._state(), ops
        if name == "tail":
            chroma_in = self._frames_in() if c == 1 else 0
            ops = (c * t * (self._row_fft_ops(g["hr"]) + 4 * g["hr"] * g["wp"])
                   + t * (4 * c * g["taps"] + 19) * hw)
            return rows_r + chroma_in + self._frames_out(), ops
        raise KeyError(f"unknown stage {name!r}")

    def chunk(self) -> Tuple[int, float]:
        """The whole chunk's least work: frames read once, outputs
        written once, the carried state read and written once; the
        transforms' operations (the row FFT of the content rows, the
        column FFT and inverse over the kept lanes, the row inverse of
        the output rows)."""
        g = self.g
        ops = self.c * self.t * (self._row_fft_ops(g["hc"])
                                 + self._col_fft_ops()
                                 + self._row_fft_ops(g["hr"]))
        return (self._frames_in() + self._frames_out() + 2 * self._state(),
                ops)


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time of (bytes, operations) on the card, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
