"""Batched and multi-device two-frame magnification of whole clips.

Counterpart of `pbmm_tpu/parallel/sharding.py`:

- `magnify_clip_batched`: all frames of one clip as one batch; the
  previous-frame spectrum is a shifted slice of the batch, so each frame's
  spectrum is computed once.  Where the fused path serves the config
  (`fused_eligible`) it runs kernels 1, 8, 6 and 7 (`_magnify_clip_fused`),
  else the batched `preprocess` / `amplify_spectrum` / `postprocess`.
- `magnify_batch_sharded`: the same per rank over a ("data", "frame")
  mesh: videos shard over "data", frames over "frame", and the shifted
  slice crosses frame-rank boundaries as a 1-frame spectrum halo sent to
  the next frame rank (`batch_isend_irecv`; XLA's collective-permute in the
  JAX package).

The streaming IIR temporal mode is sequential across frames; it runs on
`engine.video.magnify_video` and is refused here.
"""

from __future__ import annotations

import torch

from pbmm_tpu_torch.config import MagnifyConfig
from pbmm_tpu_torch.core.color import rgb_to_yiq, yiq_to_rgb
from pbmm_tpu_torch.core.window import (
    blur_then_crop,
    geometry_for,
    hann2d_region,
    pad_center,
)
from pbmm_tpu_torch.engine.pipeline import (
    amplify_spectrum,
    hermitian_active,
    on_device,
    postprocess,
    preprocess,
)
from pbmm_tpu_torch.parallel.mesh import (
    axis_coord,
    exchange,
    gather_grid,
    mesh_dims,
    neighbour,
    on_rank,
)
from pbmm_tpu_torch.spectral.fused import (
    fused_eligible,
    phase_col_ifft,
    row_ifft_magnitude,
    windowed_row_fft,
)
from pbmm_tpu_torch.spectral.radix2 import _fft_axis


def _fused_forward(frames: torch.Tensor, cfg: MagnifyConfig):
    """Kernel 1 (Hann window + row FFT, kept Hermitian tiles) and kernel 8
    down the columns: ((re, im) (T * c, Hp, Wk), YIQ (T, 3, H, W)), c = 1
    plane a frame (3 with chroma="rgb")."""
    geom = geometry_for(frames.shape[1], frames.shape[2], cfg.pad_mode)
    yiq = rgb_to_yiq(torch.movedim(frames.to(torch.float32), -1, -3),
                     axis=-3)
    chans = yiq if cfg.chroma == "rgb" else yiq[:, 0:1]
    y_pad = pad_center(chans, geom).reshape(-1, geom.pad_h, geom.pad_w)
    re, im = windowed_row_fft(y_pad.contiguous(),
                              keep_half=hermitian_active(cfg, geom))
    re, im = _fft_axis(re, im, 1, False, 1.0)
    return (re, im), yiq


def _fused_inverse(spec, prev, yiq: torch.Tensor, cfg: MagnifyConfig):
    """Kernel 6 (phase pass against `prev` + column IFFT) and kernel 7 (row
    IFFT + |z|), then the blur, crop, chroma and YIQ -> RGB: (T, H, W, 3)."""
    t, _, h, w = yiq.shape
    geom = geometry_for(h, w, cfg.pad_mode)
    rre, rim = phase_col_ifft(*spec, *prev, cfg, full_w=geom.pad_w)
    rec = row_ifft_magnitude(rre, rim,
                             magnitude=(cfg.reconstruct == "magnitude"),
                             full_w=geom.pad_w)
    # Bit-identical to blur-at-padded-res + crop, on the crop's halo only.
    rec = blur_then_crop(rec, geom, cfg.blur_size).reshape(t, -1, h, w)
    win_c = hann2d_region(geom, device=rec.device)
    if cfg.chroma == "rgb":
        out_yiq = rec
    else:
        out_yiq = torch.cat([rec, yiq[:, 1:] * win_c], dim=1)
    if cfg.compensate_window:
        out_yiq = out_yiq / torch.clamp_min(win_c, 1e-3)
    return torch.movedim(yiq_to_rgb(out_yiq, saturate=True, axis=-3), -3, -1)


def _shift(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The previous frame of each of x's frames: `first` for frame 0, then
    x shifted by one frame (`first`'s leading length: planes a frame)."""
    return torch.cat([first, x[:-first.shape[0]]], dim=0)


class _Clip:
    """One clip's forward half: the spectra every frame's phase pass reads
    as `cur`, and the `finish` that pairs them with the previous frames'.
    `halo` is the last frame's spectrum, which the next frame rank pairs
    its first frame with."""

    def __init__(self, frames: torch.Tensor, cfg: MagnifyConfig):
        self.cfg = cfg
        self.fused = fused_eligible(cfg)
        if self.fused:
            self.spec, self.yiq = _fused_forward(frames, cfg)
            self.planes = self.spec[0].shape[0] // frames.shape[0]
            self.halo = tuple(a[-self.planes:] for a in self.spec)
        else:
            self.spec, self.yiq = preprocess(frames, self.cfg)
            self.halo = (torch.view_as_real(self.spec[-1:]),)

    def finish(self, halo=None) -> torch.Tensor:
        """(T, H, W, 3): every frame amplified against the one before it;
        frame 0 against `halo` (the previous frame rank's last spectrum),
        or against itself where `halo` is None."""
        if self.fused:
            first = halo or tuple(a[:self.planes] for a in self.spec)
            prev = tuple(_shift(a, f) for a, f in zip(self.spec, first))
            return _fused_inverse(self.spec, prev, self.yiq, self.cfg)
        first = (torch.view_as_complex(halo[0]) if halo is not None
                 else self.spec[:1])
        mod, _ = amplify_spectrum(self.spec, _shift(self.spec, first),
                                  self.cfg)
        return torch.movedim(postprocess(mod, self.yiq, self.cfg), -3, -1)


def _check_two_frame(cfg: MagnifyConfig) -> None:
    if cfg.temporal.mode != "two_frame":
        raise ValueError("batched path requires the two-frame temporal "
                         "mode; use engine.video.magnify_video for IIR "
                         "modes")


def magnify_clip_batched(frames, cfg: MagnifyConfig,
                         device=None) -> torch.Tensor:
    """Single-device batched two-frame magnification of one (T, H, W, 3)
    clip, f32 RGB out.  A torch tensor runs where it lies; numpy input on
    `device`, by default the first CUDA card.  The fused path (kernels 1,
    8, 6, 7) where `fused_eligible(cfg)`; IIR modes raise."""
    _check_two_frame(cfg)
    frames = on_device(frames, device)
    if not cfg.apply_motion_magnification:
        # Reference bypass (`MotionMagnificationProcessor.cs:126-139`).
        return frames.to(torch.float32)
    out = _Clip(frames, cfg).finish()
    # Frame 0 passes through unmodified
    # (`MotionMagnificationProcessor.cs:111-117`).
    return torch.cat([frames[:1].to(torch.float32), out[1:]], dim=0)


def _batch_axes(mesh):
    dims = mesh_dims(mesh)
    if tuple(dims) != ("data", "frame"):
        raise ValueError(f"expected a ('data', 'frame') mesh, got axes "
                         f"{tuple(dims)}")
    return dims["data"], dims["frame"]


def local_block(batch, mesh) -> torch.Tensor:
    """This rank's block of a global (B, T, H, W, 3) batch on a ("data",
    "frame") mesh: videos [d B / D, (d + 1) B / D) and frames [f T / F,
    (f + 1) T / F) for the rank's coordinates (d, f) on axes of sizes
    (D, F).  A view of a tensor; a numpy batch stays numpy."""
    n_data, n_frame = _batch_axes(mesh)
    b, t = batch.shape[:2]
    if b % n_data or t % n_frame:
        raise ValueError(f"B={b} and T={t} must divide the mesh's "
                         f"(data, frame) = ({n_data}, {n_frame})")
    d, f = axis_coord(mesh, "data"), axis_coord(mesh, "frame")
    bl, tl = b // n_data, t // n_frame
    return batch[d * bl:(d + 1) * bl, f * tl:(f + 1) * tl]


def gather_blocks(block: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's block (`local_block`'s layout) gathered into the global
    (B, T, ...) batch, on every rank (an all-gather over the world)."""
    _batch_axes(mesh)
    return gather_grid(block, mesh.mesh.tolist())


def magnify_batch_sharded(frames, cfg: MagnifyConfig, mesh) -> torch.Tensor:
    """Two-frame magnification of a (B, T, H, W, 3) batch over a ("data",
    "frame") mesh (`parallel.mesh.make_mesh`), SPMD: every rank of the
    mesh calls it at once.

    Each rank passes its block, `local_block(batch, mesh)`, of shape
    (B / D, T / F, H, W, 3) (a torch tensor runs where it lies; numpy on
    the rank's device: the current CUDA card, or the CPU on a gloo
    world), and gets back the magnified block of the same shape; the
    blocks together equal `magnify_clip_batched` of each video
    (`gather_blocks` assembles them).  Each frame rank sends its videos'
    last-frame spectra (the kept-lane (c, Hp, Wk) re/im planes on the
    fused path) to the next frame rank, and frame rank 0 pairs its first
    frame with itself and passes it through.  B and T must divide the
    mesh's axes; IIR modes raise."""
    _check_two_frame(cfg)
    _batch_axes(mesh)
    frames = on_rank(frames, mesh)
    if not cfg.apply_motion_magnification:
        return frames.to(torch.float32)
    clips = [_Clip(v, cfg) for v in frames]
    # Each video's last-frame spectrum to the next frame rank; frame rank
    # 0 receives none (its first frame pairs with itself).
    nxt, prv = neighbour(mesh, "frame", 1), neighbour(mesh, "frame", -1)
    got = exchange([(h, nxt, prv) for c in clips for h in c.halo])
    k = len(clips[0].halo)
    outs = [c.finish(None if prv is None else tuple(got[i * k:(i + 1) * k]))
            for i, c in enumerate(clips)]
    out = torch.stack(outs)
    if axis_coord(mesh, "frame") == 0:
        out[:, 0] = frames[:, 0].to(torch.float32)
    return out
