"""Analytic multi-device traffic model.

Counterpart of `pbmm_tpu/parallel/model.py`: the exact per-frame
collective bytes of each sharding axis at a geometry, and the no-overlap
scaling-efficiency bound they imply over a link of a given bandwidth.  The
byte counts hold on any interconnect; the bandwidth is an argument
(`link_gbps`, GB/s a device), which the caller measures on its machine
(NVLink through NCCL, say): no figure is assumed here.

The collectives per axis (see `parallel/sharding.py`, `parallel/
spatial.py`):

  frame axis: the two-frame pairing sends each shard's LAST spectrum to
    the next frame rank: one (Hp, Wk) re/im plane pair per shard per
    chunk, amortised over the shard's frames.  (IIR is sequential across
    frames and never frame-sharded.)
  rows axis: the distributed FFT's two all-to-alls per frame (forward and
    inverse transpose of the shard axis, each moving (p-1)/p of the full
    complex spectrum) plus the blur's 2r-row halo exchange.
  data axis: no steady-state collective (videos are independent).

These are the engines' own collectives: each returns its rank's block,
and a caller's gather of the blocks (`gather_blocks`, `gather_spatial`)
is outside the count.
"""

from __future__ import annotations

from dataclasses import dataclass

_F = 4  # f32 bytes


@dataclass
class AxisTraffic:
    axis: str
    bytes_per_frame: float  # collective bytes crossing the link per frame
    note: str


def frame_axis_traffic(pad_h: int, kept_w: int,
                       frames_per_shard: int) -> AxisTraffic:
    """One (Hp, Wk) f32 re/im spectrum-plane pair sent per shard per
    chunk (the 1-frame temporal halo), amortized per frame."""
    per_chunk = 2 * pad_h * kept_w * _F
    return AxisTraffic(
        "frame", per_chunk / max(frames_per_shard, 1),
        f"1 spectrum plane pair ({per_chunk / 1e6:.1f} MB) per shard per "
        f"{frames_per_shard}-frame chunk",
    )


def rows_axis_traffic(pad_h: int, pad_w: int, n_dev: int,
                      blur_radius: int = 2) -> AxisTraffic:
    """Two all-to-alls of the full complex spectrum (each moves
    (p-1)/p of it across the link) + the blur halo (2r rows in each
    direction), per frame."""
    p = max(n_dev, 1)
    a2a = 2 * (pad_h * pad_w * 2 * _F) * (p - 1) / p
    halo = 2 * (2 * blur_radius) * pad_w * _F
    return AxisTraffic(
        "rows", a2a + halo,
        f"2 all-to-alls x {(pad_h * pad_w * 2 * _F) / 1e6:.1f} MB x "
        f"(p-1)/p + {halo / 1e6:.2f} MB blur halo",
    )


def efficiency_bound(compute_ms_per_frame: float, traffic: AxisTraffic,
                     link_gbps: float) -> dict:
    """No-overlap scaling-efficiency bound: each device keeps its full
    per-frame compute and additionally serialises its collective bytes
    through a link of `link_gbps` GB/s.  eff = t_compute / (t_compute +
    t_comm)."""
    if not link_gbps > 0:
        raise ValueError(f"link_gbps must be positive, got {link_gbps}")
    t_comm_ms = traffic.bytes_per_frame / (link_gbps * 1e9) * 1e3
    eff = compute_ms_per_frame / (compute_ms_per_frame + t_comm_ms)
    return {
        "axis": traffic.axis,
        "collective_mb_per_frame": round(traffic.bytes_per_frame / 1e6, 3),
        "t_comm_ms_per_frame": round(t_comm_ms, 4),
        "compute_ms_per_frame": round(compute_ms_per_frame, 3),
        "efficiency_bound_no_overlap": round(eff, 3),
        "note": traffic.note,
        "link_gbps_assumed": link_gbps,
    }


def scaling_table(h: int, w: int, pad_mode: str,
                  compute_ms_per_frame: float, link_gbps: float,
                  frames_per_shard: int = 16,
                  devices=(2, 4, 8)) -> list:
    """Per-axis efficiency bounds at the given geometry for a range of
    device counts, over a link of `link_gbps` GB/s."""
    from pbmm_tpu_torch.core.window import geometry_for
    from pbmm_tpu_torch.spectral.hermitian import (
        hermitian_kept_width,
        hermitian_saves,
    )

    geom = geometry_for(h, w, pad_mode)
    wk = (hermitian_kept_width(geom.pad_w)
          if hermitian_saves(geom.pad_w) else geom.pad_w)
    rows = []
    ft = frame_axis_traffic(geom.pad_h, wk, frames_per_shard)
    rows.append({"devices": "any", **efficiency_bound(
        compute_ms_per_frame, ft, link_gbps)})
    for n in devices:
        rt = rows_axis_traffic(geom.pad_h, geom.pad_w, n)
        rows.append({"devices": n, **efficiency_bound(
            compute_ms_per_frame, rt, link_gbps)})
    return rows
