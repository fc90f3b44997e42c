"""Device-side YCbCr -> RGB decode for the streaming ingestion path.

Counterpart of `pbmm_tpu/io/device_decode.py`, as torch ops on the
device the planes lie on: the raw uint8 y4m planes cross host -> device
(~1.5 bytes/px for C420) and the nearest-neighbour chroma upsample and
limited-range BT.601 conversion run there, with the formulas of
`io/y4m.py::_ycbcr_to_rgb` / `_upsample` in the same order.  Divisions
are by one-element tensors, not Python scalars: PyTorch turns a
division by a scalar on the card into a multiply by its reciprocal,
which would round differently from the JAX package's f32 division.
"""

from __future__ import annotations

import torch

_KR, _KG, _KB = 0.299, 0.587, 0.114


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d in f32, rounded as one IEEE division."""
    return x / torch.full((1,), d, dtype=torch.float32, device=x.device)


def ycbcr_planes_to_rgb(y_u8: torch.Tensor, cb_u8: torch.Tensor,
                        cr_u8: torch.Tensor, h: int, w: int
                        ) -> torch.Tensor:
    """(T, H, W) u8 luma + (T, ch, cw) u8 chroma planes, on one device ->
    (T, H, W, 3) f32 RGB in [0, 1] there.

    Chroma is nearest-neighbour upsampled by the integer factors the host
    reader uses (repeat by h // ch, w // cw, then crop); the colour math
    is the limited-range BT.601 of `io/y4m.py::_ycbcr_to_rgb`."""
    _, ch, cw = cb_u8.shape

    def up(p):
        ry = max(h // ch, 1)
        rx = max(w // cw, 1)
        if ry > 1:
            p = torch.repeat_interleave(p, ry, dim=1)
        if rx > 1:
            p = torch.repeat_interleave(p, rx, dim=2)
        return p[:, :h, :w]

    yf = _div(y_u8.to(torch.float32) - 16.0, 219.0)
    pb = _div(up(cb_u8).to(torch.float32) - 128.0, 224.0)
    pr = _div(up(cr_u8).to(torch.float32) - 128.0, 224.0)
    r = yf + 2.0 * (1.0 - _KR) * pr
    b = yf + 2.0 * (1.0 - _KB) * pb
    g = _div(yf - _KR * r - _KB * b, _KG)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def ycbcr_planes_to_rgb_planar_u8(y_u8: torch.Tensor, cb_u8: torch.Tensor,
                                  cr_u8: torch.Tensor, h: int, w: int
                                  ) -> torch.Tensor:
    """The same decode as (T, 3, H, W) uint8 planar RGB, the layout and
    type kernels 4 and 3 read: the f32 decode rounded once to 8 bits
    (half to even, as `jnp.round`), what every rgb24 decoder emits."""
    rgb = ycbcr_planes_to_rgb(y_u8, cb_u8, cr_u8, h, w)
    planar = torch.movedim(rgb, -1, 1)
    return torch.round(planar * 255.0).to(torch.uint8).contiguous()
