"""Spatially sharded magnification: frame ROWS sharded across devices.

Counterpart of `pbmm_tpu/parallel/spatial.py`, on `torch.distributed`.
The 2D FFT of a frame whose rows are split over p ranks is

    local row FFT  ->  all-to-all (rows -> columns)  ->  local column FFT

so each rank transforms whole lines; the only communication is one
all-to-all a transform (`all_to_all_single` over the mesh's "rows" group;
`lax.all_to_all` in the JAX package).  The phase pass is elementwise on
each rank's columns at their global frequencies; the inverse mirrors the
forward; the blur's vertical pass takes `radius` rows from each row
neighbour (point-to-point sends in place of `ppermute`), the global edges
clamped.  Frames may shard too, over a "frame" axis: the previous-frame
spectrum of a frame rank's first frame arrives from the frame rank before
it (the 1-frame halo, in the spectral domain, so no forward FFT repeats).

Two spectral routes, chosen by the JAX package's formula
(`_spatial_pallas_ok`), so a config takes the same route in both:

- the kernel route: kernel 8 along the rows (real input), the all-to-all,
  kernel 8 down the columns, kernel 6 with the shard's lane frequencies
  (`fx_values`, a slice of `bitrev_freq_axis(W)`; with the IIR taps frame
  by frame), the all-to-all back and kernel 7 (`_spectral_kernels_local`);
- `torch.fft` (natural layout) with the pyramid or standard pass at the
  shard's global frequencies, the IIR band-pass stepped over local frames.

Every mode of the single-device engine is served but IIR on a
frame-sharded mesh (the taps recur across frames), which raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import rgb_to_yiq, yiq_to_rgb
from pbmm_tpu_torch.core.window import blur_taps, geometry_for
from pbmm_tpu_torch.parallel.mesh import (
    axis_coord,
    exchange,
    gather_grid,
    mesh_dims,
    neighbour,
    on_rank,
)

AXIS = "rows"
FRAME_AXIS = "frame"


class _Place(NamedTuple):
    """A rank's place on the spatial mesh."""

    mesh: object  # DeviceMesh
    p: int  # ranks along "rows"
    idx: int  # this rank's row shard
    group: object  # the "rows" process group
    pf: int  # ranks along "frame" (1 without the axis)
    fidx: int


def _place(mesh) -> _Place:
    dims = mesh_dims(mesh)
    frame = FRAME_AXIS in dims
    return _Place(mesh, dims[AXIS], axis_coord(mesh, AXIS),
                  mesh.get_group(AXIS), dims.get(FRAME_AXIS, 1),
                  axis_coord(mesh, FRAME_AXIS) if frame else 0)


def _a2a(v: torch.Tensor, pl: _Place, forward: bool) -> torch.Tensor:
    """The distributed transpose of the shard axis on (..., a, b, 2) f32
    re/im pairs: forward an (..., hl, w, 2) row shard -> (..., hl p,
    w / p, 2) column shard; inverse an (..., h, wc, 2) column shard ->
    (..., h / p, wc p, 2) row shard."""
    p = pl.p
    *lead, a, b, e = v.shape
    v = v.reshape(-1, a, b, e)
    if forward:  # split the columns into p blocks, one a rank
        send = v.reshape(-1, a, p, b // p, e).permute(2, 0, 1, 3, 4)
    else:  # split the rows
        send = v.reshape(-1, p, a // p, b, e).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=pl.group)
    # recv[j]: rank j's block of this rank's columns (forward) or rows.
    if forward:
        out = recv.permute(1, 0, 2, 3, 4).reshape(-1, a * p, b // p, e)
    else:
        out = recv.permute(1, 2, 0, 3, 4).reshape(-1, a // p, b * p, e)
    return out.reshape(*lead, *out.shape[1:])


def _a2a_complex(x: torch.Tensor, pl: _Place, forward: bool):
    return torch.view_as_complex(_a2a(torch.view_as_real(x), pl, forward))


def _a2a_pair(re, im, pl: _Place, forward: bool):
    """`_a2a` of split re/im planes, as contiguous planes."""
    out = _a2a(torch.stack([re, im], -1), pl, forward)
    return out[..., 0].contiguous(), out[..., 1].contiguous()


def _fft2_local(y_local: torch.Tensor, pl: _Place) -> torch.Tensor:
    """(..., Hl, W) real row shard -> (..., H, Wc) natural-layout column
    shard of the 2D spectrum."""
    s = torch.fft.fft(y_local.to(torch.complex64), dim=-1)  # whole rows
    return torch.fft.fft(_a2a_complex(s, pl, True), dim=-2)  # columns


def _ifft2_local(spec: torch.Tensor, pl: _Place) -> torch.Tensor:
    """(..., H, Wc) column-shard spectrum -> (..., Hl, W) row shard of
    the complex inverse."""
    s = torch.fft.ifft(spec, dim=-2)
    return torch.fft.ifft(_a2a_complex(s, pl, False), dim=-1)


def _freqs_local(pad_h: int, pad_w: int, pl: _Place, device):
    """Global natural-layout frequencies of this shard's block: fy (H, 1)
    whole, fx (1, Wc) for the local column slice."""
    wc = pad_w // pl.p
    ky = torch.arange(pad_h, dtype=torch.float32, device=device) / pad_h
    fy = torch.where(ky < 0.5, ky, ky - 1.0)[:, None]
    kx = (pl.idx * wc + torch.arange(wc, device=device)).to(
        torch.float32) / pad_w
    fx = torch.where(kx < 0.5, kx, kx - 1.0)[None, :]
    return fy, fx


def _amplify_local(cur, prev, cfg: MagnifyConfig, pad_h: int, pad_w: int,
                   pl: _Place, delta_override=None):
    """The pyramid pass on (..., H, Wc) column shards at their global
    frequencies (radial bands, split into steerable sectors when
    `orientations` > 1); `delta_override` is the IIR-filtered delta."""
    from pbmm_tpu_torch.phase.amplify import rotation_term
    from pbmm_tpu_torch.pyramid.filters import radial_profile

    fy, fx = _freqs_local(pad_h, pad_w, pl, cur.device)
    freq = torch.sqrt(fy * fy + fx * fx)
    cur_mag, prev_mag = torch.abs(cur), torch.abs(prev)
    tau = cfg.magnitude_threshold
    levels = cfg.pyramid_levels
    sect = None
    if cfg.orientations > 1 and levels >= 3:
        # The steerable sector windows at this shard's frequencies (a
        # partition of unity over k; `pyramid.filters.angular_profiles`).
        theta = torch.atan2(*torch.broadcast_tensors(fy, fx))
        p_ang = 2 * (cfg.orientations - 1)
        raw = [torch.abs(torch.cos(theta - np.pi * k / cfg.orientations))
               ** p_ang for k in range(cfg.orientations)]
        denom = sum(raw)
        sect = [a / torch.where(denom == 0.0, 1.0, denom) for a in raw]
    total = torch.zeros_like(freq)
    amped = torch.zeros_like(cur_mag)
    for i in range(levels):
        m = radial_profile(freq, i, levels, cfg.min_frequency,
                           cfg.max_frequency)
        total = total + m
        if 0 < i < levels - 1:
            for mk in ([m * a for a in sect] if sect else [m]):
                gate = (cur_mag * mk >= tau) & (prev_mag * mk >= tau)
                amped = amped + torch.where(gate, mk, 0.0)
    rot = rotation_term(cur, prev, cfg.phase_scale,
                        delta_override=delta_override)
    return cur * ((total - amped) + amped * rot)


def _amplify_local_any(cur, prev, cfg: MagnifyConfig, pad_h: int,
                       pad_w: int, pl: _Place, delta_override=None):
    """The pyramid pass, or standard mode's whole-spectrum weighted
    rotation with w(f) at this shard's global frequencies."""
    if cfg.mode == "standard":
        from pbmm_tpu_torch.phase.standard import standard_phase_amplify
        from pbmm_tpu_torch.spectral.fused import standard_weight_block

        fy, fx = _freqs_local(pad_h, pad_w, pl, cur.device)
        weight = standard_weight_block(torch.sqrt(fy * fy + fx * fx), cfg)
        return standard_phase_amplify(
            cur, prev, weight, cfg.phase_scale, cfg.magnitude_threshold,
            cfg.magnitude_scale, cfg.apply_magnitude_scale,
            delta_override=delta_override)
    return _amplify_local(cur, prev, cfg, pad_h, pad_w, pl,
                          delta_override=delta_override)


def _spatial_pallas_ok(cfg: MagnifyConfig, geom, n_rows: int) -> bool:
    """Whether the per-shard kernels serve this config: the JAX package's
    formula (`spatial.py:175-195`), so a config takes one route in both
    (`interpret_pallas` waives the 128-lane tiling there, and so here;
    on the card a kernel refuses a width it cannot take).  The kernels are
    radix-2: tight heights take the `torch.fft` route."""
    shapes_ok = (
        geom.pad_h % 128 == 0 and (geom.pad_w // n_rows) % 128 == 0
    ) or cfg.interpret_pallas
    pow2 = geom.pad_h & (geom.pad_h - 1) == 0 \
        and geom.pad_w & (geom.pad_w - 1) == 0
    return (
        cfg.fft_backend == "pallas"
        and not cfg.apply_magnitude_scale
        and shapes_ok
        and pow2
    )


def _spectral_kernels_local(y_win, cfg: MagnifyConfig, pad_h: int,
                            pad_w: int, tl: int, c: int,
                            pl: _Place) -> torch.Tensor:
    """The per-shard kernel chain: kernel 8 along the rows (real input),
    the all-to-all, kernel 8 down the columns, kernel 6 against the
    previous frames' spectra (`_prev_shift`) with this shard's lane
    frequencies, the all-to-all back, kernel 7 (|z| or Re z, scaled by
    1 / (H W)); `tl` local frames of `c` planes.  With the IIR band-pass
    the taps ride this shard's columns through the local frames in order.
    (Tl c, Hl, W) f32 out."""
    from pbmm_tpu_torch.spectral.fused import (
        phase_col_ifft,
        row_ifft_magnitude,
    )
    from pbmm_tpu_torch.spectral.radix2 import _fft_axis, bitrev_freq_axis

    wc = pad_w // pl.p
    re, im = _fft_axis(y_win.contiguous(), None, 2, False, 1.0)
    re, im = _fft_axis(*_a2a_pair(re, im, pl, True), 1, False, 1.0)
    pre, pim = _prev_shift((re, im), pl, c)
    # This shard's lanes hold bit-reversed positions [idx wc, (idx + 1)
    # wc) of the whole row spectrum.
    fx_local = torch.from_numpy(
        bitrev_freq_axis(pad_w)[pl.idx * wc:(pl.idx + 1) * wc].copy()).to(
            re.device)
    if cfg.temporal.mode == "iir_bandpass":
        lpf = torch.zeros((c,) + tuple(re.shape[1:]), device=re.device)
        lps = torch.zeros_like(lpf)
        outs = []
        for f in range(tl):
            sl = slice(f * c, (f + 1) * c)
            rr, ri, lpf, lps = phase_col_ifft(
                re[sl], im[sl], pre[sl], pim[sl], cfg, fx_values=fx_local,
                lp_fast=lpf, lp_slow=lps)
            outs.append((rr, ri))
        rre, rim = (torch.cat(x) for x in zip(*outs))
    else:
        rre, rim = phase_col_ifft(re, im, pre, pim, cfg, fx_values=fx_local)
    return row_ifft_magnitude(*_a2a_pair(rre, rim, pl, False),
                              magnitude=(cfg.reconstruct == "magnitude"),
                              pad_h=pad_h)


def _blur_rowsharded(y: torch.Tensor, blur_size: float,
                     pl: _Place) -> torch.Tensor:
    """The separable blur on (..., Hl, W) row shards: horizontal along
    whole local rows (edge clamp), vertical with `radius` rows from each
    row neighbour; the global top and bottom edges replicate their rows
    (the texture clamp)."""
    taps = blur_taps(blur_size)
    radius = (len(taps) - 1) // 2
    *lead, hl, w = y.shape
    if hl < radius:
        raise ValueError(f"{hl} rows a shard are fewer than the blur's "
                         f"radius {radius}")
    yh = F.pad(y.reshape(-1, hl, w), (radius, radius), mode="replicate")
    yh = yh.reshape(*lead, hl, w + 2 * radius)
    out = sum(taps[k] * yh[..., :, k:k + w] for k in range(len(taps)))
    down = neighbour(pl.mesh, AXIS, 1)
    up = neighbour(pl.mesh, AXIS, -1)
    # Bottom rows travel to the next shard, top rows to the previous one.
    from_above, from_below = exchange(
        [(out[..., -radius:, :], down, up), (out[..., :radius, :], up, down)])
    above = (out[..., 0:1, :].expand(*lead, radius, w) if from_above is None
             else from_above)
    below = (out[..., -1:, :].expand(*lead, radius, w) if from_below is None
             else from_below)
    stacked = torch.cat([above, out, below], dim=-2)
    return sum(taps[k] * stacked[..., k:k + hl, :] for k in range(len(taps)))


def _prev_shift(arrs, pl: _Place, c: int = 1):
    """Previous-frame spectra: the local shift along the frame axis (`c`
    planes a frame), the first local frame's from the frame rank before
    (sent as this rank's last frame to the next); the global first frame
    pairs with itself (its pass-through is the caller's)."""
    nxt = neighbour(pl.mesh, FRAME_AXIS, 1) if pl.pf > 1 else None
    prv = neighbour(pl.mesh, FRAME_AXIS, -1) if pl.pf > 1 else None
    got = exchange([(a[-c:], nxt, prv) for a in arrs])
    return [torch.cat([a[:c] if g is None else g, a[:-c]], dim=0)
            for a, g in zip(arrs, got)]


def _video_kernel(frames_padded, cfg: MagnifyConfig, geom, use_kernels,
                  pl: _Place) -> torch.Tensor:
    """One rank's block: (Tl, Hl, Wp, 3) padded rows (of its local frames)
    -> the magnified rows at padded resolution.  Each local frame is
    transformed once; the previous frame's spectrum is the shifted slice,
    the frame rank's first frame's arriving from the frame rank before."""
    pad_h, pad_w = geom.pad_h, geom.pad_w
    hl = pad_h // pl.p
    dev = frames_padded.device
    yiq = rgb_to_yiq(frames_padded)  # (Tl, Hl, Wp, 3), channels last
    gy = (pl.idx * hl + torch.arange(hl, device=dev)).to(torch.float32)
    wy = 0.5 * (1.0 - torch.cos(2.0 * np.pi * (gy + 0.5) / pad_h))[:, None]
    ix = (torch.arange(pad_w, dtype=torch.float32, device=dev) + 0.5) / pad_w
    wx = (0.5 * (1.0 - torch.cos(2.0 * np.pi * ix)))[None, :]
    win = wy * wx  # (Hl, Wp)
    rgb = cfg.chroma == "rgb"
    c = 3 if rgb else 1
    tl = frames_padded.shape[0]
    if rgb:
        # All three planes, plane-batched [Y0 I0 Q0 Y1 ...]: the frame
        # shift is a shift of c planes.
        fft_in = (torch.movedim(yiq, -1, 1) * win).reshape(tl * 3, hl,
                                                           pad_w)
    else:
        fft_in = yiq[..., 0] * win
    if use_kernels:
        out = _spectral_kernels_local(fft_in, cfg, pad_h, pad_w, tl, c, pl)
    else:
        spec = _fft2_local(fft_in, pl)  # (Tl c, H, Wc)
        (prev,) = _prev_shift((spec,), pl, c)
        delta_override = None
        if cfg.temporal.mode == "iir_bandpass":
            # The band-pass over each bin's deltas, stepped over the local
            # frames (a frame-sharded mesh is refused: the frames are
            # whole on each rank).
            from pbmm_tpu_torch.phase.amplify import phase_delta
            from pbmm_tpu_torch.phase.temporal import (
                temporal_apply,
                temporal_init,
            )

            delta = phase_delta(spec, prev).reshape(
                (tl, c) + tuple(spec.shape[1:]))
            state = temporal_init((c,) + tuple(spec.shape[1:]),
                                  cfg.temporal, device=dev)
            filt = []
            for dt in delta:
                f, state = temporal_apply(dt, state, cfg.temporal)
                filt.append(f)
            delta_override = torch.stack(filt).reshape(spec.shape)
        mod = _amplify_local_any(spec, prev, cfg, pad_h, pad_w, pl,
                                 delta_override=delta_override)
        rec = _ifft2_local(mod, pl)  # (Tl c, Hl, Wp) complex
        out = torch.abs(rec) if cfg.reconstruct == "magnitude" else rec.real
    out = _blur_rowsharded(out, cfg.blur_size, pl)
    if rgb:
        out_yiq = torch.movedim(out.reshape(tl, 3, hl, pad_w), 1, -1)
    else:
        out_yiq = torch.stack([out, yiq[..., 1] * win, yiq[..., 2] * win],
                              dim=-1)
    return yiq_to_rgb(out_yiq, saturate=True)


def _validate(cfg: MagnifyConfig, mesh=None) -> None:
    """The one combination the engine refuses: IIR on a frame-sharded
    mesh (the taps recur across frames; shard rows instead)."""
    if mesh is not None and mesh_dims(mesh).get(FRAME_AXIS, 1) > 1 \
            and cfg.temporal.mode == "iir_bandpass":
        raise ValueError(
            "iir_bandpass is sequential across frames and cannot ride a "
            "frame-sharded mesh; use a ('rows',)-only mesh (the lp taps "
            "then ride each shard's column slice)")


def magnify_video_spatial(frames, cfg: MagnifyConfig,
                          mesh) -> torch.Tensor:
    """(T, H, W, 3) -> this rank's block of the (T, H, W, 3) f32 result,
    with frame rows sharded over the mesh's "rows" axis, SPMD: every rank
    of the mesh calls it at once.

    mesh: ("rows",), or ("frame", "rows") to shard frames too (T must
    divide by the frame axis; IIR modes then raise: use a rows-only
    mesh).  Every rank passes the same whole clip (a torch tensor runs
    where it lies; numpy on the rank's device: the current CUDA card, or
    the CPU on a gloo world); each pads it and computes its block of the
    padded clip: frames [fidx T / pf, (fidx + 1) T / pf) and padded rows
    [idx Hp / p, (idx + 1) Hp / p).  It gets back that block cropped to
    the frame, (T / pf, rows, W, 3), where `rows` counts the frame's rows
    in its padded rows (0 for a shard wholly in the pad), as the JAX
    engine returns a rows-sharded array.  `gather_spatial` assembles the
    clip; on a mesh of one the block is the whole clip.  The global first
    frame passes through unmodified.  Two-frame and IIR modes; each
    frame's FFT computed once."""
    _validate(cfg, mesh)
    frames = on_rank(frames, mesh).to(torch.float32)
    pl = _place(mesh)
    t, h, w = frames.shape[:3]
    if t % pl.pf:
        raise ValueError(
            f"T={t} must divide the frame-mesh size {pl.pf}")
    geom = geometry_for(h, w, cfg.pad_mode)
    if geom.pad_h % pl.p or geom.pad_w % pl.p:
        raise ValueError("padded dims must divide the rows-mesh size")
    tl, hl = t // pl.pf, geom.pad_h // pl.p
    # This rank's padded rows [r0, r0 + Hl) hold the frame's rows
    # [lo, hi) (padded indices; lo == hi for a shard wholly in the pad).
    r0 = pl.idx * hl
    lo = max(r0, geom.y0)
    hi = max(min(r0 + hl, geom.y0 + h), lo)
    mine = frames[pl.fidx * tl:(pl.fidx + 1) * tl, lo - geom.y0:hi - geom.y0]
    if not cfg.apply_motion_magnification:
        return mine
    block = torch.zeros((tl, hl, geom.pad_w, 3), dtype=torch.float32,
                        device=frames.device)
    block[:, lo - r0:hi - r0, geom.x0:geom.x0 + w] = mine
    out = _video_kernel(block, cfg, geom, _spatial_pallas_ok(
        cfg, geom, pl.p), pl)[:, lo - r0:hi - r0, geom.x0:geom.x0 + w]
    if pl.fidx == 0:
        # The global first frame passes through unmodified
        # (`MotionMagnificationProcessor.cs:111-117`).
        out[0] = mine[0]
    return out.contiguous()


def gather_spatial(block: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `magnify_video_spatial` block gathered into the whole
    (T, H, W, 3) clip, on every rank (an all-gather over the world, each
    block padded to the most rows a rank holds).  Not part of the engine:
    its bytes are the caller's, outside `parallel.model`'s count."""
    dims = mesh_dims(mesh)
    return gather_grid(block, mesh.mesh.reshape(
        dims.get(FRAME_AXIS, 1), dims[AXIS]).tolist())


def magnify_frame_pair_spatial(prev_rgb, cur_rgb, cfg: MagnifyConfig,
                               mesh) -> torch.Tensor:
    """Two-frame magnification of ONE (H, W, 3) pair with rows sharded
    over a ("rows",) mesh: a T = 2 run of `magnify_video_spatial`.  Each
    rank gets back its rows of `cur` magnified against `prev`, (rows, W,
    3); `gather_spatial(out[None], mesh)[0]` assembles the frame."""
    _validate(cfg, mesh)
    if mesh_dims(mesh).get(FRAME_AXIS, 1) > 1:
        raise ValueError("a frame pair takes a ('rows',) mesh: a "
                         "frame-sharded one splits the pair's two frames "
                         "over its frame ranks")
    cur = on_rank(cur_rgb, mesh)
    frames = torch.stack([on_rank(prev_rgb, mesh).to(cur.device), cur])
    return magnify_video_spatial(frames, cfg, mesh)[1]
