"""The post kernels: kernels 3, 11 and 10.

Counterpart of `pbmm_tpu/engine/post_pallas.py` (renamed: the port holds
no Pallas): `_radius`, `_out_block`, `post_pallas_ok` (the geometry
predicate, kept under its JAX name so the two packages route alike),
`rowifft_post_fused` (kernel 3, the y_only tail; CUDA:
`csrc/rowifft_post.cu`), `post_fused_rgb` (kernel 11, the chroma="rgb"
tail after kernel 7; CUDA: `csrc/post_rgb.cu`) and `post_fused` (kernel
10, the y_only tail after kernel 7; CUDA: `csrc/post_rgb.cu`), all in the
JAX kernels' three output layouts and the interleaved (T, H, W, 3) f32
one the JAX engine stacks after them, at every blur radius
`post_pallas_ok` admits.
Like the JAX package's, the engines reach `post_fused` through
`engine.video._post_block`, where kernel 3 serves first; on the card
`rowifft_post_fused` also runs kernel 7 + kernel 10 in place of kernel 3
where kernel 3's ring would leave an SM too few threads, or does not fit
shared memory (`kernel3_serves`).

Kernel 3's chain per frame: rebuild the missing Hermitian tiles, row
IFFT (bit-reversed lanes in, natural out), |z| (or Re z) / (pad_h *
pad_w), the reference's 5-tap blur horizontally then vertically, the
crop, the windowed original I/Q, the optional window compensation and
YIQ gains, YIQ -> RGB and the [0, 1] clip
(`MotionMagnificationProcessor.cs:196-205`).  The reconstruction never
leaves the kernel.  Kernel 11 runs the same blur, crop and epilogue on
the three reconstructed YIQ planes.  The three CUDA kernels share the
blur's sums, its ring of horizontally blurred rows and the epilogue
(`csrc/post_tail.cuh`); kernels 10 and 11 stage their region rows by
column strips and runs of rows, a tile `post_tile` plans.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pbmm_tpu_torch.core.color import (
    RGB_TO_YIQ,
    YIQ_TO_RGB,
    channel_mix,
    is_planar,
    unit_float,
)
from pbmm_tpu_torch.core.window import Geometry, blur_taps, geometry_for
from pbmm_tpu_torch.kernels import (
    c_floats,
    check_cuda,
    checked,
    device_arrays,
    device_ints,
    stream_handle,
)
from pbmm_tpu_torch.spectral.fused import (
    BLOCK_N,
    lane_plan_tables,
    rebuilt_row_ifft,
    row_ifft_magnitude,
)
from pbmm_tpu_torch.spectral.radix2 import check_pow2, compact_twiddles
from pbmm_tpu_torch.utils.profiling import counted

_LANE = 128


def _radius(cfg) -> int:
    return (len(blur_taps(cfg.blur_size)) - 1) // 2


def _out_block(h: int) -> int:
    """Largest 8-multiple divisor of h that is <= 192; 0 if none exists."""
    best = 0
    for ob in range(8, 193, 8):
        if h % ob == 0:
            best = ob
    return best


def post_pallas_ok(geom: Geometry, cfg, rows0: int, region_h: int) -> bool:
    """Whether the merged row-IFFT + post kernel serves this geometry —
    the JAX package's predicate, verbatim, so both packages take the
    same tail (its block constraints are the TPU kernel's; the CUDA
    kernel needs only the halo conditions, which this implies)."""
    r = _radius(cfg)
    if not (geom.y0 >= r and geom.x0 >= r
            and geom.pad_h - geom.y0 - geom.in_h >= r
            and geom.pad_w - geom.x0 - geom.in_w >= r):
        return False
    if geom.in_w % 128 != 0 or geom.pad_w % 128 != 0:
        return False
    ob = _out_block(geom.in_h)
    if not ob:
        return False
    yoff = geom.y0 - rows0 - r  # region row of the first V-tap
    if yoff < 0:
        return False
    e = yoff % 8
    s = yoff - e
    wve = -(-(ob + 2 * r + e) // 8) * 8
    if s + wve > 2 * ob:
        return False
    last_need = ob * (geom.in_h // ob - 1) + s + wve
    return last_need <= region_h


# csrc/post_tail.cuh's PBMM_OUT_* order; "interleaved" is (T, H, W, 3) f32,
# the torch.stack of "tuple3" (the JAX engine's, pbmm_tpu/engine/video.py:
# 168-169) written by the kernels themselves.
_LAYOUTS = ("tuple3", "planar", "planar_u8", "interleaved")
# The epilogue's chroma (post_tail.cuh's PBMM_CH_*): f32 I/Q planes, uint8
# source frames, three blurred planes, f32 source frames.
_CH_IQ, _CH_U8, _CH_RGB, _CH_F32 = 0, 1, 2, 3
# Largest blur radius of the CUDA post kernels (PBMM_MAX_BLUR_R):
# `post_pallas_ok` admits 2 r <= ob with the output block ob <= 192.
_MAX_BLUR_R = 96
_SMEM_BYTES = 232448  # shared memory a block may use on an H100
_SM_BLOCK_BYTES = 233472  # shared memory of an SM: 227 KB + 1 KB a block
_SM_THREADS = 2048  # threads an H100 SM holds
_KERNEL3_THREADS = 256  # the most threads a kernel-3 block runs
# Kernel 3 serves while its blocks keep this many threads on an SM: at
# 1080p (2048 lanes, 1920 columns) two blocks of 256 fit to radius 5, one
# from 6, and there kernels 7 + 10 run faster (tools/post_times.py).
_KERNEL3_MIN_THREADS = 512
_RP_POINTS = 16  # points a thread of the row engine holds (PBMM_RP_P)


def _widest_crop(radius: int, pad_w: int) -> int:
    """The widest crop `post_pallas_ok` admits in a padded width at a
    blur radius: a multiple of 128 with the radius free on each side."""
    return max(0, (pad_w - 2 * radius) // _LANE * _LANE)


def kernel3_smem(rows: int, radius: int, pad_w: int, in_w: int) -> int:
    """Bytes of shared memory a kernel-3 block takes
    (`csrc/rowifft_post.cu`): the row engine's two planes of
    pad_w + pad_w / 16 f32 for each of `rows` region rows in flight, and
    the ring of the 2 r previous horizontally blurred rows of `in_w` f32."""
    row_floats = 2 * (pad_w + pad_w // 16)  # pbmm_rp_row_floats
    return 4 * (rows * row_floats + 2 * radius * in_w)


def kernel3_rows(radius: int, pad_w: int, in_w=None) -> int:
    """Region rows a block of kernel 3 transforms at once at this blur
    radius, padded width and crop width (default: the widest crop
    `post_pallas_ok` admits): the most, up to `_KERNEL3_THREADS` threads
    (pad_w / 16 a row, at least one row), whose block fits 227 KB of
    shared memory (`kernel3_smem`); 0 where not even one row fits, or
    where the row is longer than one block of the row engine holds
    (`fused.BLOCK_N`: kernel 3 keeps its whole row in one block, so
    `rowifft_post_fused` takes kernels 7 + 10 there)."""
    in_w = _widest_crop(radius, pad_w) if in_w is None else in_w
    if pad_w > BLOCK_N:
        return 0
    rows = max(1, _KERNEL3_THREADS // (pad_w // _RP_POINTS))
    while rows and kernel3_smem(rows, radius, pad_w, in_w) > _SMEM_BYTES:
        rows -= 1
    return rows


def kernel3_serves(radius: int, pad_w: int, in_w=None) -> bool:
    """Which kernels take the y_only tail on the card: kernel 3 where its
    blocks (`kernel3_rows`, `kernel3_smem`) keep `_KERNEL3_MIN_THREADS`
    threads on an SM, else kernel 7 (row IFFT + |z|) then kernel 10 (blur,
    crop, chroma, RGB) on its rows, the same arithmetic in two launches.
    The ring grows with the radius and the crop, so at the widest crops
    kernel 3 serves r <= 11 at `pad_w` 1024, r <= 5 at 2048, r <= 2 at
    4096 and 8192 (there one block of 512 threads)."""
    in_w = _widest_crop(radius, pad_w) if in_w is None else in_w
    rows = kernel3_rows(radius, pad_w, in_w)
    if not rows:
        return False
    threads = rows * (pad_w // _RP_POINTS)
    blocks = min(_SM_THREADS // threads, _SM_BLOCK_BYTES // (
        kernel3_smem(rows, radius, pad_w, in_w) + 1024))
    return blocks * threads >= _KERNEL3_MIN_THREADS


_TILE_WIDTHS = (256, 128, 64, 32)  # kernels 10, 11: strips, 4 columns a thread
# Region rows a staged group, the most that fit first; kernel 11's
# epilogue spreads a group of 3 rows evenly over its 3 threads a quad.
_TILE_ROWS = {1: (4, 2, 1), 3: (3, 2, 1)}


def post_tile_smem(sw: int, rows: int, radius: int, planes: int) -> int:
    """Bytes of shared memory a block of kernel 10 (1 plane) or 11 (3
    planes) takes: the ring of the 2 r previous horizontally blurred rows
    of its `sw` columns, two groups of `rows` staged region rows, each a
    segment of sw + 2 r4 f32 (r4: the radius rounded up to 4), and for
    three planes a group's blurred rows.  The wrappers pass it to the
    launch, which refuses any size but that of the kernel's own carve-up
    (`csrc/post_rgb.cu::tile_smem`)."""
    r4 = -(-radius // 4) * 4
    sums = rows * sw if planes > 1 else 0
    return 4 * planes * (2 * radius * sw + 2 * rows * (sw + 2 * r4) + sums)


def _tile_blocks_per_sm(smem: int, threads: int, regs: int) -> int:
    """Blocks of kernel 10 or 11 an H100 SM holds: by shared memory, warps,
    registers (`regs` a thread, allocated 8 at a time; 65,536 an SM) and
    the 32-block limit."""
    warps = -(-threads // 32)
    regs = -(-regs // 8) * 8
    return min(32, 64 // warps, _SM_BLOCK_BYTES // (smem + 1024),
               65536 // (regs * 32 * warps))


def post_tile(radius: int, in_w: int, in_h: int, t: int, planes: int,
              regs: int, sms: int = 132):
    """The tile of kernels 10 and 11: (sw, rows, run), a block's strip of
    output columns (planes x sw / 4 threads), its region rows a staged
    group and its run of output rows.  For each strip width up to 256
    (narrower where the crop is), the most rows a group (`_TILE_ROWS`) whose
    ring and staged rows fit 227 KB (`post_tile_smem`); of those, the
    strip whose blocks give an SM the most threads (`regs` registers a
    thread, the kernel's own count on the card), the widest on a tie.
    Then runs that give about two blocks for each the `sms` SMs hold at
    once, but no shorter than 8 r rows (8 at radius 0), so the halo rows
    redone at the runs' ends cost at most ~25 % of the horizontal work,
    and one run a frame where the height is short."""
    best = None
    for sw in _TILE_WIDTHS:
        if sw > max(in_w, _TILE_WIDTHS[-1]):
            continue
        rows = next((n for n in _TILE_ROWS[planes]
                     if post_tile_smem(sw, n, radius, planes) <= _SMEM_BYTES),
                    0)
        if not rows:
            continue
        threads = planes * sw // 4
        per_sm = _tile_blocks_per_sm(post_tile_smem(sw, rows, radius, planes),
                                     threads, regs)
        if best is None or per_sm * threads > best[0]:
            best = per_sm * threads, sw, rows, per_sm
    if best is None:
        raise ValueError(f"no tile of the post kernels fits blur radius "
                         f"{radius} with {planes} planes")
    _, sw, rows, per_sm = best
    strips = -(-in_w // sw)
    runs = -(-2 * sms * per_sm // (strips * t))
    runs = max(1, min(runs, in_h // max(8 * radius, 8)))
    return sw, rows, -(-in_h // runs)


def _check_radius(r: int) -> None:
    if r > _MAX_BLUR_R:
        raise ValueError(f"the CUDA post kernels take blur radii up to "
                         f"{_MAX_BLUR_R}, got {r}")


def _check_quads(geom, name: str) -> None:
    """The CUDA post kernels blur and write four neighbouring columns a
    thread from 16-byte words: the crop's width and left edge must be
    multiples of 4 (always so where `post_pallas_ok` holds: both are
    multiples of 64)."""
    if geom.in_w % 4 or geom.x0 % 4:
        raise ValueError(f"the CUDA {name} takes crops whose width and left "
                         f"edge are multiples of 4, got {geom.in_w} at "
                         f"{geom.x0}")


def _folded_u8(src) -> bool:
    """Whether the chroma of source frames `src` takes the I and Q rows
    with the 1/255 folded in, as the JAX kernel forms them from planar
    uint8 frames (`post_pallas.py:326-331`): planar uint8 frames do (the
    route the JAX package has); f32 frames and interleaved uint8 frames
    form the I/Q planes of the torch pre stage (`unit_float`, then the
    rows), whose bits the f32 I/Q route gives."""
    return src.dtype == torch.uint8 and is_planar(src)


def _u8_chroma_coeffs():
    """The I and Q rows of RGB -> YIQ with the 1/255 scale folded in, as
    the JAX kernel forms them (`post_pallas.py:326-331`): the planar u8
    chroma path multiplies the raw 0-255 values by these."""
    s = 1.0 / 255.0
    my = RGB_TO_YIQ
    return tuple(float(my[d, c] * s) for d in (1, 2) for c in range(3))


def _src_chroma(src):
    """(chroma, planar, rows, pre) of the CUDA epilogue for source frames:
    PBMM_CH_U8 or _F32, the layout, the six I and Q rows and the factor
    on each value first (0: none)."""
    if _folded_u8(src):
        return _CH_U8, 1, _u8_chroma_coeffs(), 0.0
    my = RGB_TO_YIQ
    rows = tuple(float(my[d, c]) for d in (1, 2) for c in range(3))
    if src.dtype == torch.uint8:
        return _CH_U8, 0, rows, float(np.float32(1.0 / 255.0))
    return _CH_F32, int(is_planar(src)), rows, 0.0


def _halo_check(geom, r: int, rows0: int, hr: int, wp: int) -> None:
    yrow0 = geom.y0 - rows0
    if (yrow0 - r < 0 or yrow0 + geom.in_h + r > hr or geom.x0 < r
            or geom.x0 + geom.in_w + r > wp):
        raise ValueError("the blur halo of the crop leaves the region rows "
                         f"(rows0={rows0}, region height {hr})")


def _check_src(src, t: int, in_h: int, in_w: int) -> None:
    """Source frames of the chroma: (T, 3, H, W) or (T, H, W, 3), uint8
    or f32."""
    want = (t, 3, in_h, in_w) if is_planar(src) else (t, in_h, in_w, 3)
    if (tuple(src.shape) != want
            or src.dtype not in (torch.uint8, torch.float32)):
        raise ValueError(f"chroma source {tuple(src.shape)} {src.dtype} "
                         f"for {t} frames of {in_h} x {in_w}")


def _check_post(rre, i_plane, q_plane, src, cfg, in_h, in_w, pad_mode,
                rows0, full_w, out_layout):
    """Validate a call; returns (geometry, full width)."""
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    if (src is None) == (i_plane is None or q_plane is None):
        raise ValueError("pass either the f32 I/Q planes or src")
    if src is not None:
        _check_src(src, rre.shape[0], in_h, in_w)
    t, hr, wk = rre.shape
    wp = full_w if full_w is not None else wk
    check_pow2(wp, "row IFFT length")
    if wp % _LANE or wk % _LANE:
        raise ValueError(f"widths must be multiples of 128: {wk}, {wp}")
    geom = geometry_for(in_h, in_w, pad_mode)
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom, wp


def _blur_crop(rec, cfg, geom, rows0: int):
    """(T, Hr, W) region rows -> (T, H, W_in): the reference's blur,
    horizontal taps first (wrapping around the padded width, as
    `pltpu.roll` does; the crop never reaches the wrap), then vertical,
    and the crop, in the JAX kernels' order of products and sums."""
    taps = blur_taps(cfg.blur_size)
    r = _radius(cfg)
    hb = rec * taps[r]
    for k in range(1, r + 1):
        hb = hb + (torch.roll(rec, k, -1) * taps[r - k]
                   + torch.roll(rec, -k, -1) * taps[r + k])
    top = geom.y0 - rows0 - r
    vb = hb[:, top:top + geom.in_h] * taps[0]
    for k in range(1, 2 * r + 1):
        vb = vb + hb[:, top + k:top + k + geom.in_h] * taps[k]
    return vb[..., geom.x0:geom.x0 + geom.in_w]


def _finish(y, iw, qw, win, cfg, out_layout: str):
    """The kernels' epilogue: ÷ max(win, 1e-3) (as a multiply by its
    reciprocal) when `compensate_window`, the YIQ gains when
    `apply_yiq_gains`, YIQ -> RGB with the [0, 1] clip, then the output
    layout (`post_pallas.py:167-178,335-359,476-487`)."""
    if cfg.compensate_window:
        inv = 1.0 / torch.clamp_min(win, 1e-3)
        y, iw, qw = y * inv, iw * inv, qw * inv
    if cfg.apply_yiq_gains:
        g = [np.float32(v) for v in cfg.yiq_gains]
        y, iw, qw = y * g[0], iw * g[1], qw * g[2]
    chans = tuple(torch.clamp(channel_mix(y, iw, qw, YIQ_TO_RGB[d]), 0.0, 1.0)
                  for d in range(3))
    if out_layout == "tuple3":
        return chans
    if out_layout == "interleaved":
        return torch.stack(chans, dim=-1)
    planar = torch.stack(chans, dim=1)
    if out_layout == "planar":
        return planar
    return torch.round(planar * 255.0).to(torch.uint8)


def _epilogue_args(cfg):
    """(compensate, gains, g_y, g_i, g_q) of the CUDA epilogues."""
    return (int(cfg.compensate_window), int(cfg.apply_yiq_gains),
            *(float(g) for g in cfg.yiq_gains))


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=16)
def _tile_regs(chroma: int, layout: int, dev) -> int:
    """Registers a thread of kernels 10 and 11's instantiation for a
    chroma source (`csrc/post_tail.cuh`: 0 f32 I/Q, 1 uint8 frames, 2
    three blurred planes, 3 f32 frames) and layout, as the card's runtime
    reports them."""
    from pbmm_tpu_torch.kernels.build import library

    with torch.cuda.device(dev):
        regs = library().pbmm_post_tile_regs(chroma, layout)
    if regs <= 0:
        raise RuntimeError(f"pbmm_post_tile_regs: cudaError {-regs}")
    return regs


def _chroma_args(name, i_plane, q_plane, src, t, in_h, in_w):
    """The chroma of a CUDA launch of kernel 3 or 10, checked: the
    (i_plane, q_plane, src) pointers, the epilogue's chroma, whether the
    source is planar, its six I and Q rows and the factor on each value
    first."""
    if src is None:
        check_cuda(name, (t, in_h, in_w), i_plane, q_plane)
        return ((i_plane.data_ptr(), q_plane.data_ptr(), None), _CH_IQ, 1,
                (0.0,) * 6, 0.0)
    _check_src(src, t, in_h, in_w)
    check_cuda(name, tuple(src.shape), src, dtype=src.dtype)
    return ((None, None, src.data_ptr()), *_src_chroma(src))


def _tile_args(r, in_w, in_h, t, planes, chroma, layout, dev):
    """The tile (sw, rows, run) and its shared-memory bytes, as the C
    entry points of kernels 10 and 11 take them."""
    sw, rows, run = post_tile(r, in_w, in_h, t, planes,
                              _tile_regs(chroma, layout, dev), _sm_count(dev))
    return sw, rows, run, post_tile_smem(sw, rows, r, planes)


def _outputs(t, in_h, in_w, out_layout, dev):
    """The output tensors of a layout and their three pointers."""
    if out_layout == "tuple3":
        outs = [torch.empty((t, in_h, in_w), dtype=torch.float32,
                            device=dev) for _ in range(3)]
    elif out_layout == "interleaved":
        outs = [torch.empty((t, in_h, in_w, 3), dtype=torch.float32,
                            device=dev)]
    else:
        dt = torch.uint8 if out_layout == "planar_u8" else torch.float32
        outs = [torch.empty((t, 3, in_h, in_w), dtype=dt, device=dev)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    return outs, ptrs


def rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                           in_h: int, in_w: int, pad_mode: str, full_w=None,
                           src=None, out_layout: str = "tuple3"):
    """Plain PyTorch version of `rowifft_post_fused`: the rebuild and row
    IFFT of `rebuilt_row_ifft`, `_blur_crop`, the windowed chroma and
    `_finish`, as f32 multiplies and adds in the JAX kernel's order."""
    geom, wp = _check_post(rre, i_plane, q_plane, src, cfg, in_h, in_w,
                           pad_mode, rows0, full_w, out_layout)
    rec = rebuilt_row_ifft(rre, rim, wp, 1.0 / (geom.pad_h * wp),
                           cfg.reconstruct == "magnitude")
    y = _blur_crop(rec, cfg, geom, rows0)
    iw, qw = _windowed_chroma(i_plane, q_plane, src, win)
    return _finish(y, iw, qw, win, cfg, out_layout)


@checked
def rowifft_post_fused(rre, rim, i_plane, q_plane, win, cfg, rows0: int,
                       in_h: int, in_w: int, pad_mode: str, full_w=None,
                       src=None, out_layout: str = "tuple3",
                       route: bool = True):
    """(T, Hr, Wk) column-IFFT output rows (region rows from `rows0`,
    bit-reversed kept lanes) + the original chroma + (H, W) crop-region
    Hann -> RGB in [0, 1].

    The chroma is either the (T, H, W) f32 I/Q planes or, with `src`,
    the source frames ((T, 3, H, W) or (T, H, W, 3), uint8 or f32), from
    which the kernel derives I/Q itself (i_plane/q_plane None; planar
    uint8 as the JAX kernel does, with the 1/255 folded into the rows,
    the others bit for bit as on the torch pre stage's I/Q planes).
    `out_layout`: "tuple3" (three (T, H, W) f32 planes), "planar" (one
    (T, 3, H, W) f32 array), "planar_u8" (the same as round(255 x) in
    uint8) or "interleaved" (one (T, H, W, 3) f32 array: the stack of
    "tuple3").
    `full_w`: the padded width when the lanes are the kept Hermitian
    half.  `cfg.reconstruct`, `compensate_window` and the YIQ gains are
    served as in the JAX kernel.

    CPU tensors take `rowifft_post_fused_ref`; CUDA tensors launch
    `csrc/rowifft_post.cu` (crop widths that are multiples of 4), or,
    where `kernel3_serves` is False, `row_ifft_magnitude` (kernel 7) and
    `post_fused` (kernel 10), which compute the same bits.  With
    `route=False` kernel 3 runs wherever one of its blocks fits
    (`kernel3_rows`), to time or check the two routes against each
    other."""
    if rre.device.type == "cpu":
        return rowifft_post_fused_ref(rre, rim, i_plane, q_plane, win, cfg,
                                      rows0, in_h, in_w, pad_mode, full_w,
                                      src, out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom, wp = _check_post(rre, i_plane, q_plane, src, cfg, in_h, in_w,
                           pad_mode, rows0, full_w, out_layout)
    t, hr, wk = rre.shape
    r = _radius(cfg)
    _check_radius(r)
    if not (kernel3_serves(r, wp, in_w) if route
            else kernel3_rows(r, wp, in_w) > 0):
        rec = row_ifft_magnitude(rre, rim,
                                 magnitude=(cfg.reconstruct == "magnitude"),
                                 pad_h=geom.pad_h, full_w=wp)
        return post_fused(rec, i_plane, q_plane, win, cfg, rows0, in_h, in_w,
                          pad_mode, out_layout, src=src)
    _check_quads(geom, "rowifft_post_fused")
    check_cuda("rowifft_post_fused", (t, hr, wk), rre, rim)
    check_cuda("rowifft_post_fused", (in_h, in_w), win)
    ptrs_c, chroma, planar, rows_c, pre = _chroma_args(
        "rowifft_post_fused", i_plane, q_plane, src, t, in_h, in_w)
    dev = rre.device
    outs, ptrs = _outputs(t, in_h, in_w, out_layout, dev)
    twr, twi = device_arrays(compact_twiddles, (wp, True), dev)
    plan_src, plan_rev = device_ints(lane_plan_tables, (wk, wp), dev)
    err = library().pbmm_rowifft_post(
        rre.data_ptr(), rim.data_ptr(), *ptrs_c, win.data_ptr(),
        twr.data_ptr(), twi.data_ptr(), *ptrs, plan_src.data_ptr(),
        plan_rev.data_ptr(), wp // _LANE, c_floats(blur_taps(cfg.blur_size)),
        r, kernel3_rows(r, wp, in_w), c_floats(YIQ_TO_RGB.reshape(-1)),
        c_floats(rows_c), pre, chroma, planar,
        _LAYOUTS.index(out_layout), t, hr, wk, wp, in_h, in_w,
        geom.y0 - rows0, geom.x0, float(1.0 / (geom.pad_h * wp)),
        int(cfg.reconstruct == "magnitude"), *_epilogue_args(cfg),
        stream_handle(dev))
    check_launch(err, "rowifft_post_fused")
    rowifft_post_fused.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


counted(rowifft_post_fused)


# ---------------------------------------------------------------------------
# Kernel 11: the chroma="rgb" post tail
# ---------------------------------------------------------------------------


def _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode, out_layout):
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    t3, hr, wp = chans3.shape
    if t3 % 3:
        raise ValueError(f"{t3} rows are not whole frames of 3 planes")
    geom = geometry_for(in_h, in_w, pad_mode)
    if wp != geom.pad_w:
        raise ValueError(f"region rows of {wp} lanes for a pad width of "
                         f"{geom.pad_w}")
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom


def post_fused_rgb_ref(chans3, win, cfg, rows0: int, in_h: int, in_w: int,
                       pad_mode: str, out_layout: str = "tuple3"):
    """Plain PyTorch version of `post_fused_rgb`: `_blur_crop` of each
    plane, then `_finish`."""
    geom = _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode,
                           out_layout)
    y, iw, qw = (_blur_crop(chans3[c::3], cfg, geom, rows0)
                 for c in range(3))
    return _finish(y, iw, qw, win, cfg, out_layout)


@checked
def post_fused_rgb(chans3, win, cfg, rows0: int, in_h: int, in_w: int,
                   pad_mode: str, out_layout: str = "tuple3"):
    """(3T, Hr, Wp) reconstruction rows (plane-minor frame-major: frame
    t's Y/I/Q at rows 3t..3t+2, region rows from `rows0`) + (H, W)
    crop-region Hann -> RGB in [0, 1]: the chroma="rgb" tail, where all
    three planes are processed reconstructions.  Each plane is blurred
    and cropped; then the window compensation, the YIQ gains, YIQ -> RGB
    and the clip, written in `out_layout` as `rowifft_post_fused` does.
    Callers have checked `post_pallas_ok`.

    CPU tensors take `post_fused_rgb_ref`; CUDA tensors launch
    `csrc/post_rgb.cu`."""
    if chans3.device.type == "cpu":
        return post_fused_rgb_ref(chans3, win, cfg, rows0, in_h, in_w,
                                  pad_mode, out_layout)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom = _check_post_rgb(chans3, cfg, rows0, in_h, in_w, pad_mode,
                           out_layout)
    t3, hr, wp = chans3.shape
    r = _radius(cfg)
    _check_radius(r)
    _check_quads(geom, "post_fused_rgb")
    check_cuda("post_fused_rgb", (t3, hr, wp), chans3)
    check_cuda("post_fused_rgb", (in_h, in_w), win)
    dev = chans3.device
    outs, ptrs = _outputs(t3 // 3, in_h, in_w, out_layout, dev)
    err = library().pbmm_post_rgb(
        chans3.data_ptr(), win.data_ptr(), *ptrs,
        c_floats(blur_taps(cfg.blur_size)), r,
        c_floats(YIQ_TO_RGB.reshape(-1)), _LAYOUTS.index(out_layout),
        t3 // 3, hr, wp, in_h, in_w, geom.y0 - rows0, geom.x0,
        *_tile_args(r, in_w, in_h, t3 // 3, 3, _CH_RGB,
                    _LAYOUTS.index(out_layout), dev),
        *_epilogue_args(cfg), stream_handle(dev))
    check_launch(err, "post_fused_rgb")
    post_fused_rgb.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


counted(post_fused_rgb)


# ---------------------------------------------------------------------------
# Kernel 10: the y_only post tail on reconstructed rows
# ---------------------------------------------------------------------------


def _check_post_yonly(chans, i_plane, q_plane, src, cfg, rows0, in_h,
                      in_w, pad_mode, out_layout):
    if out_layout not in _LAYOUTS:
        raise ValueError(f"unknown out_layout {out_layout!r}")
    if (src is None) == (i_plane is None or q_plane is None):
        raise ValueError("pass either the f32 I/Q planes or src")
    t, hr, wp = chans.shape
    geom = geometry_for(in_h, in_w, pad_mode)
    if wp != geom.pad_w:
        raise ValueError(f"region rows of {wp} lanes for a pad width of "
                         f"{geom.pad_w}")
    if src is not None:
        _check_src(src, t, in_h, in_w)
    else:
        for pl in (i_plane, q_plane):
            if tuple(pl.shape) != (t, in_h, in_w):
                raise ValueError(f"chroma source {tuple(pl.shape)} for {t} "
                                 f"frames of {in_h} x {in_w}")
    _halo_check(geom, _radius(cfg), rows0, hr, wp)
    return geom


def _windowed_chroma(i_plane, q_plane, src, win):
    """(I, Q) times the crop-region window: from the f32 planes, or formed
    from the source frames as the kernels form them (`_folded_u8`)."""
    if src is None:
        return i_plane * win, q_plane * win
    if _folded_u8(src):
        rows = _u8_chroma_coeffs()
        rgb = [src[:, k].to(torch.float32) for k in range(3)]
        return (channel_mix(*rgb, rows[:3]) * win,
                channel_mix(*rgb, rows[3:]) * win)
    f = unit_float(src)
    rgb = ((f[:, 0], f[:, 1], f[:, 2]) if is_planar(src)
           else (f[..., 0], f[..., 1], f[..., 2]))
    return tuple(channel_mix(*rgb, RGB_TO_YIQ[d]) * win for d in (1, 2))


def post_fused_ref(chans, i_plane, q_plane, win, cfg, rows0: int, in_h: int,
                   in_w: int, pad_mode: str, out_layout: str = "tuple3",
                   src=None):
    """Plain PyTorch version of `post_fused`: `_blur_crop` of the Y rows,
    the windowed chroma, then `_finish`."""
    geom = _check_post_yonly(chans, i_plane, q_plane, src, cfg, rows0,
                             in_h, in_w, pad_mode, out_layout)
    y = _blur_crop(chans, cfg, geom, rows0)
    iw, qw = _windowed_chroma(i_plane, q_plane, src, win)
    return _finish(y, iw, qw, win, cfg, out_layout)


@checked
def post_fused(chans, i_plane, q_plane, win, cfg, rows0: int, in_h: int,
               in_w: int, pad_mode: str, out_layout: str = "tuple3",
               src=None):
    """(T, Hr, Wp) reconstruction rows of Y (region rows from `rows0`) +
    the original chroma + (H, W) crop-region Hann -> RGB in [0, 1]: the
    blur, the crop, the windowed chroma, the window compensation and YIQ
    gains, YIQ -> RGB and the clip (`posttail`'s math), written in
    `out_layout` as `post_fused_rgb` does.  The chroma is either the
    (T, H, W) f32 I/Q planes or, with `src`, the source frames
    (i_plane/q_plane None), as for `rowifft_post_fused`.  Callers have
    checked `post_pallas_ok`.

    CPU tensors take `post_fused_ref`; CUDA tensors launch
    `csrc/post_rgb.cu::pbmm_post_yonly`."""
    if chans.device.type == "cpu":
        return post_fused_ref(chans, i_plane, q_plane, win, cfg, rows0,
                              in_h, in_w, pad_mode, out_layout, src)
    from pbmm_tpu_torch.kernels.build import check_launch, library

    geom = _check_post_yonly(chans, i_plane, q_plane, src, cfg, rows0,
                             in_h, in_w, pad_mode, out_layout)
    t, hr, wp = chans.shape
    r = _radius(cfg)
    _check_radius(r)
    _check_quads(geom, "post_fused")
    check_cuda("post_fused", (t, hr, wp), chans)
    ptrs_c, chroma, planar, rows_c, pre = _chroma_args(
        "post_fused", i_plane, q_plane, src, t, in_h, in_w)
    check_cuda("post_fused", (in_h, in_w), win)
    dev = chans.device
    outs, ptrs = _outputs(t, in_h, in_w, out_layout, dev)
    err = library().pbmm_post_yonly(
        chans.data_ptr(), *ptrs_c, chroma, planar, c_floats(rows_c), pre,
        win.data_ptr(), *ptrs, c_floats(blur_taps(cfg.blur_size)), r,
        c_floats(YIQ_TO_RGB.reshape(-1)), _LAYOUTS.index(out_layout), t, hr,
        wp, in_h, in_w, geom.y0 - rows0, geom.x0,
        *_tile_args(r, in_w, in_h, t, 1, chroma, _LAYOUTS.index(out_layout),
                    dev),
        *_epilogue_args(cfg), stream_handle(dev))
    check_launch(err, "post_fused")
    post_fused.launches += 1
    return tuple(outs) if out_layout == "tuple3" else outs[0]


counted(post_fused)
