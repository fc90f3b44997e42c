// Kernels 11 and 10: the post tail from reconstructed planes: blur +
// crop, window compensation, YIQ gains, YIQ->RGB and the [0, 1] clip,
// straight to the output layout.
//
// Kernel 11 (pbmm_post_rgb) replaces pbmm_tpu/engine/post_pallas.py:398
// post_fused_rgb (the Pallas kernel launched at :490), the chroma="rgb"
// tail.  Kernel 10 (pbmm_post_yonly) replaces post_pallas.py:91
// post_fused (launched at :181), the y_only tail of the JAX package's
// _post_block: Y is the one reconstructed plane of each frame, blurred
// and cropped the same way, and I, Q are the original chroma planes
// times the crop-region Hann window (post_pallas.py:164-178).  The port
// also reaches it after kernel 7 where kernel 3's block does not fit
// shared memory (engine/post_fused.py::kernel3_serves), so it takes
// kernel 3's chroma sources too: the f32 I/Q planes, or the uint8 or f32
// source frames, planar or interleaved, from which it forms I and Q as
// kernel 3 does (post_tail.cuh).
// Kernel 11's input is kernel 7's output: (3T, Hr, W) region rows of |z|
// (or Re z), plane-minor frame-major (frame t's Y, I, Q at rows 3t,
// 3t + 1, 3t + 2), from padded row rows0; with all three planes
// processed there is no original-chroma combine (posttail's rgb branch,
// engine/pipeline.py:507-508).  LAYOUT, as in kernel 3: 0 "tuple3" (three
// (T, H, W) f32 planes), 1 "planar" ((T, 3, H, W) f32), 2 "planar_u8"
// ((T, 3, H, W) uint8), 3 "interleaved" ((T, H, W, 3) f32: kernel 11's
// three planes meet in its sums buffer, so the thread that finishes four
// pixels stores their 12 values as three 16-byte words).
//
// Design.  The blur is separable, as the reference's: each region row is
// blurred horizontally once, and the 2 r previous horizontally blurred
// rows wait in a ring in shared memory for their vertical taps, as in
// kernel 3; the sums, the ring and the epilogue are post_tail.cuh's, the
// functions kernel 3 calls, so kernel 3 equals kernel 7 + kernel 10 bit
// for bit.  A block owns one frame, one strip of sw output columns (sw <=
// 256) and a run of output rows; a thread owns four columns of one plane
// (kernel 11: three threads a column quad).  The block walks the run's
// region rows (the run plus r rows of halo at each end), `rows` at a time:
//   1. asynchronous 16-byte copies (cp.async) stage the rows' segments
//      [x0 + xs - r4, x0 + xs + sw + r4) of every plane in shared memory
//      (r4 = r rounded up to 4; x0 is a multiple of 4, so the segment is
//      16-byte aligned and stays inside the padded row), one group of rows
//      while the block computes on the group before it (one barrier a
//      group: kernel 11 adds one before its epilogue);
//   2. each thread sums the horizontal taps of its four columns from the
//      staged segment (16-byte reads that slide through registers);
//   3. once a row's window of 2 r + 1 rows is complete, the thread reads
//      the vertical taps of its own four columns from the ring (2 r rows x
//      planes x sw f32; no barrier) and puts the new row's sums in;
//   4. the epilogue: kernel 10's thread runs it at once, its 16-byte I/Q
//      and window loads (uchar4 for the uint8 frames) issued ahead of the
//      sums; kernel 11's threads put the group's blurred Y, I, Q in shared
//      memory, and after a barrier each thread finishes four pixels of
//      the group.  Stores are 16 bytes (planar_u8: 4).
// The host (engine/post_fused.py::post_tile) chooses sw and the rows a
// group for the most threads an SM holds (the ring and two groups of
// staged rows in 227 KB, the registers the card reports for the
// instantiation: pbmm_post_tile_regs; sw 64 at radius 96 for three
// planes), then the run length: the grid fills the SMs about twice, and a
// run is at least 8 r rows where the height allows, so redoing the halo
// rows costs at most ~25 % of the horizontal work.  It passes the shared
// memory it planned (post_tile_smem); the launch refuses any size but
// tile_smem's.
//
// What bounds it on an H100: it reads the region rows the crop needs once
// (the halo rows of the runs' ends twice) and the chroma, and writes 12
// (f32) or 3 (u8) bytes a pixel: bytes bound at small radii (1080p tight,
// T = 16, kernel 11: 400 MB of the (1080 + 2 r) x (1920 + 2 r) rows in,
// 100 MB out as planar_u8, 0.149 ms at 3.35 TB/s); the blur costs
// 2 (4 r + 1) f32 operations a pixel and plane, which outweighs the bytes
// from a radius of about 12 for three planes.  On an NVIDIA H100 80GB
// HBM3 at its 700 W limit (chip_smoke.py, warm) kernel 11 takes 0.421 ms
// at that shape (radius 2), 0.631 at radius 5 and 1.289 at 13, and
// kernel 10 0.319 ms (f32 I/Q to tuple3, radius 2), 0.522 at radius 15
// and 0.598 with the uint8 chroma to planar_u8 at 13 (the
// one-thread-a-pixel design before it: 1.610, 4.714, 22.289; 0.585,
// 9.578, 7.429).  Three threads a column quad (one a plane) and index
// math stepped without integer division were the two steps that paid.

#include <cuda_pipeline.h>

#include "common.cuh"
#include "post_tail.cuh"

// A block's threads: four columns of the strip (up to 256) and one plane
// each, so 64 for kernel 10 and 192 for kernel 11.
#define PT_MAX_THREADS(PLANES) (64 * (PLANES))

struct TileIO {
  PbmmTailIO tail;     // chroma, window, outputs, in_h, in_w
  const float* chans;  // (T P, hr, w) region rows, plane-minor
  int hr, w, yrow0, x0, radius;
  int sw;    // output columns a block
  int rows;  // region rows a staged group
  int run;   // output rows a block
};

template <int CHROMA, int LAYOUT>
__global__ void __launch_bounds__(
    PT_MAX_THREADS(CHROMA == PBMM_CH_RGB ? 3 : 1))
    post_tile_kernel(const __grid_constant__ TileIO io,
                     const __grid_constant__ PbmmTailParams prm) {
  constexpr int P = CHROMA == PBMM_CH_RGB ? 3 : 1;  // planes blurred
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = io.radius, r2 = 2 * r, r4 = (r + 3) & ~3;
  const int sw = io.sw, g_rows = io.rows;
  const int xs = blockIdx.x * sw;                  // the strip's first column
  const int sws = min(sw, io.tail.in_w - xs);      // its width
  const int j0 = blockIdx.y * io.run;              // the run's first output row
  const int f = blockIdx.z;
  const int nreg = min(io.run, io.tail.in_h - j0) + r2;  // its region rows
  const int seg = sw + 2 * r4;         // floats of a staged row segment
  const int nch = (sws + 2 * r4) / 4;  // its 16-byte chunks in this strip
  float* ring = smem;                  // [2 r][P][sw]
  float* stage = smem + (size_t)r2 * P * sw;  // [2][rows][P][seg]
  // Three planes: the blurred Y, I, Q of a group's rows, [rows][P][sw].
  float* vbuf = stage + (size_t)2 * g_rows * P * seg;
  // Plane p's local region row y (region row yrow0 + j0 - r + y) starts at
  // src + (p hr + y) w.
  const float* src = io.chans + (size_t)f * P * io.hr * io.w +
                     (size_t)(io.yrow0 + j0 - r) * io.w + io.x0 + xs - r4;

  // 1. Group g's rows into stage buffer g mod 2, one commit a group: the
  //    thread's chunks c of row-plane rp = i P + p step by blockDim.x
  //    through the group's rows P nch chunks, division-free.
  const int c0 = threadIdx.x % nch, rp0 = threadIdx.x / nch;
  const int dc = blockDim.x % nch, drp = blockDim.x / nch;
  auto stage_rows = [&](int g) {
    float* dst = stage + (size_t)(g & 1) * g_rows * P * seg;
    for (int c = c0, rp = rp0; rp < g_rows * P;) {
      const int y = g * g_rows + rp / P;
      if (y < nreg)
        __pipeline_memcpy_async(
            dst + (size_t)rp * seg + 4 * c,
            src + ((size_t)(rp % P) * io.hr + y) * io.w + 4 * c, 16);
      c += dc;
      rp += drp;
      if (c >= nch) {
        c -= nch;
        ++rp;
      }
    }
    __pipeline_commit();
  };
  const int ngroups = (nreg + g_rows - 1) / g_rows;
  const int nq = sw / 4;
  const int p = P == 1 ? 0 : threadIdx.x / nq;  // the thread's plane
  const int x = 4 * (P == 1 ? threadIdx.x : threadIdx.x % nq);  // columns
  // Kernel 11's epilogue: the thread's first (row, quad) of a group's
  // rows x nqa quads, and its step of blockDim.x, division-free.
  const int nqa = sws / 4;
  const int eq0 = threadIdx.x % nqa, ei0 = threadIdx.x / nqa;
  const int deq = blockDim.x % nqa, dei = blockDim.x / nqa;
  int slot = 0;  // ring slot of the thread's next region row
  stage_rows(0);
  for (int g = 0; g < ngroups; ++g) {
    // Group g is in; every thread is done with group g - 1, so its stage
    // buffer takes group g + 1 while the block works on g.
    __pipeline_wait_prior(0);
    __syncthreads();
    if (g + 1 < ngroups) stage_rows(g + 1);
    if (x < sws) {
      const float* rows_g = stage + (size_t)(g & 1) * g_rows * P * seg;
      for (int i = 0; i < g_rows; ++i) {
        const int yy = g * g_rows + i;  // local region row
        if (yy >= nreg) break;
        const bool out = yy >= r2;  // completes output row j0 + yy - 2 r
        PbmmTailIn in;
        if (P == 1 && out)  // loaded ahead of the sums
          in = pbmm_tail_load<CHROMA>(io.tail, prm, f, j0 + yy - r2, xs + x);
        // 2-3. The horizontal sums, the vertical taps, the ring.
        const float* z = rows_g + (size_t)(i * P + p) * seg;
        float hb[4], v[3][4];
        pbmm_tail_hsum4(
            [&](int q) { return *reinterpret_cast<const float4*>(z + q); },
            r4 + x, r, prm, hb);
        float* col = ring + (size_t)p * sw + x;
        if (out) pbmm_tail_vsum4(col, P * sw, slot, r2, prm, hb, v[0]);
        pbmm_tail_ring_put(col, P * sw, slot, r2, hb);
        slot = pbmm_tail_next_slot(slot, r2);
        if (P == 1 && out)
          pbmm_tail_epilogue<CHROMA, LAYOUT>(io.tail, prm, in, f,
                                             j0 + yy - r2, xs + x, v);
        if (P > 1 && out)
          *reinterpret_cast<float4*>(vbuf + (size_t)(i * P + p) * sw + x) =
              make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      }
    }
    if (P > 1) {
      // The epilogue of the group's output rows, four pixels a thread,
      // once every plane's sums are in (the sums buffer is free again
      // after the next group's first barrier).
      __syncthreads();
      for (int q = eq0, i = ei0; i < g_rows;) {
        const int xq = 4 * q, ir = i, yy = g * g_rows + i;  // this item
        q += deq;  // the next
        i += dei;
        if (q >= nqa) {
          q -= nqa;
          ++i;
        }
        if (yy < r2 || yy >= nreg) continue;
        const PbmmTailIn in = pbmm_tail_load<CHROMA>(io.tail, prm, f,
                                                     j0 + yy - r2, xs + xq);
        float v[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 b = *reinterpret_cast<const float4*>(
              vbuf + (size_t)(ir * P + c) * sw + xq);
          v[c][0] = b.x; v[c][1] = b.y; v[c][2] = b.z; v[c][3] = b.w;
        }
        pbmm_tail_epilogue<CHROMA, LAYOUT>(io.tail, prm, in, f, j0 + yy - r2,
                                           xs + xq, v);
      }
    }
  }
}

// Bytes of shared memory of a block, as the kernel carves it up: the
// ring, two staged groups and, for three planes, a group's sums.  The host's
// planner (engine/post_fused.py::post_tile_smem) passes the bytes it
// planned, and the launch refuses any other size.
static size_t tile_smem(int planes, int radius, int sw, int rows) {
  const int seg = sw + 2 * ((radius + 3) & ~3);
  return ((size_t)2 * radius * planes * sw + (size_t)2 * rows * planes * seg +
          (planes > 1 ? (size_t)rows * planes * sw : 0)) *
         sizeof(float);
}

template <int CHROMA, int LAYOUT>
static cudaError_t launch_tile(const TileIO& io, const PbmmTailParams& prm,
                               int t, size_t smem, cudaStream_t s) {
  const auto kernel = post_tile_kernel<CHROMA, LAYOUT>;
  cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((io.tail.in_w + io.sw - 1) / io.sw,
                  (io.tail.in_h + io.run - 1) / io.run, t);
  kernel<<<grid, (CHROMA == PBMM_CH_RGB ? 3 : 1) * io.sw / 4, smem, s>>>(io,
                                                                      prm);
  return cudaGetLastError();
}

template <int CHROMA>
static cudaError_t tile_layout(const TileIO& io, const PbmmTailParams& prm,
                               int layout, int t, size_t smem,
                               cudaStream_t s) {
  switch (layout) {
    case 0: return launch_tile<CHROMA, 0>(io, prm, t, smem, s);
    case 1: return launch_tile<CHROMA, 1>(io, prm, t, smem, s);
    case 2: return launch_tile<CHROMA, 2>(io, prm, t, smem, s);
    default: return launch_tile<CHROMA, 3>(io, prm, t, smem, s);
  }
}

template <int CHROMA>
static cudaError_t tile_regs(int layout, int* regs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(
      &a, layout == 0   ? (const void*)post_tile_kernel<CHROMA, 0>
          : layout == 1 ? (const void*)post_tile_kernel<CHROMA, 1>
          : layout == 2 ? (const void*)post_tile_kernel<CHROMA, 2>
                        : (const void*)post_tile_kernel<CHROMA, 3>);
  *regs = a.numRegs;
  return err;
}

static int pr_run(int chroma, const float* chans, const float* i_pl,
                  const float* q_pl, const void* src, int planar,
                  const float* iq, float pre, const float* win, void* out0,
                  void* out1, void* out2, const float* taps, int radius,
                  const float* yiq_to_rgb, int layout, int t, int hr, int w,
                  int in_h, int in_w, int yrow0, int x0, int sw, int rows,
                  int run, int smem, int comp, int gain, float g_y,
                  float g_i, float g_q, void* stream) {
  const int r4 = (radius + 3) & ~3;
  if (t < 1 || t > 65535 || in_h < 1 || in_w < 4 || in_w % 4 != 0 ||
      radius < 0 || radius > PBMM_MAX_BLUR_R || w % 4 != 0 || x0 % 4 != 0 ||
      yrow0 - radius < 0 || yrow0 + in_h + radius > hr || x0 < r4 ||
      x0 + in_w + r4 > w || layout < 0 || layout > 3 || sw < 4 ||
      sw % 4 != 0 || sw > 256 || rows < 1 || run < 1 || smem < 0 ||
      (in_h + run - 1) / run > 65535 || out0 == nullptr ||
      (chroma == PBMM_CH_IQ && (i_pl == nullptr || q_pl == nullptr)) ||
      ((chroma == PBMM_CH_U8 || chroma == PBMM_CH_F32) &&
       (src == nullptr || iq == nullptr)) ||
      (layout == 0 && (out1 == nullptr || out2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies, loads and stores (4-byte for the uint8 frames and
  // planes).
  const void* vec16[] = {chans, win, layout == 2 ? nullptr : out0,
                         chroma == PBMM_CH_IQ ? i_pl : nullptr,
                         chroma == PBMM_CH_IQ ? q_pl : nullptr,
                         chroma == PBMM_CH_F32 ? src : nullptr,
                         layout == 0 ? out1 : nullptr,
                         layout == 0 ? out2 : nullptr};
  for (const void* p : vec16)
    if ((size_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if ((layout == 2 && (size_t)out0 % 4 != 0) ||
      (chroma == PBMM_CH_U8 && (size_t)src % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  PbmmTailParams prm;
  for (int i = 0; i <= 2 * radius; ++i) prm.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.m[i] = yiq_to_rgb[i];
  const bool from_src = chroma == PBMM_CH_U8 || chroma == PBMM_CH_F32;
  for (int i = 0; i < 6; ++i) prm.iq[i] = from_src ? iq[i] : 0.0f;
  prm.pre = from_src ? pre : 0.0f;
  prm.gains[0] = g_y;
  prm.gains[1] = g_i;
  prm.gains[2] = g_q;
  prm.comp = comp;
  prm.gain = gain;
  const int planes = chroma == PBMM_CH_RGB ? 3 : 1;
  if ((size_t)smem != tile_smem(planes, radius, sw, rows))
    return (int)cudaErrorInvalidValue;
  const TileIO io = {{i_pl, q_pl, src, planar ? 1 : 3,
                      planar ? in_h * in_w : 1, win, out0, out1, out2, in_h,
                      in_w},
                     chans, hr, w, yrow0, x0, radius, sw, rows, run};
  cudaStream_t s = (cudaStream_t)stream;
  switch (chroma) {
    case PBMM_CH_RGB:
      return (int)tile_layout<PBMM_CH_RGB>(io, prm, layout, t, smem, s);
    case PBMM_CH_IQ:
      return (int)tile_layout<PBMM_CH_IQ>(io, prm, layout, t, smem, s);
    case PBMM_CH_U8:
      return (int)tile_layout<PBMM_CH_U8>(io, prm, layout, t, smem, s);
    case PBMM_CH_F32:
      return (int)tile_layout<PBMM_CH_F32>(io, prm, layout, t, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 11.  layout: 0 tuple3 (out0..2 = R, G, B planes), 1 planar f32,
// 2 planar uint8, 3 interleaved f32 (out0 only).  taps and yiq_to_rgb are host arrays.
// sw, rows, run: the tile (engine/post_fused.py::post_tile); smem: its
// shared-memory bytes (post_tile_smem), which must equal tile_smem's.
extern "C" int pbmm_post_rgb(const float* chans3, const float* win,
                             void* out0, void* out1, void* out2,
                             const float* taps, int radius,
                             const float* yiq_to_rgb, int layout, int t,
                             int hr, int w, int in_h, int in_w, int yrow0,
                             int x0, int sw, int rows, int run, int smem,
                             int comp, int gain, float g_y, float g_i,
                             float g_q, void* stream) {
  return pr_run(PBMM_CH_RGB, chans3, nullptr, nullptr, nullptr, 1, nullptr,
                0.0f, win, out0, out1, out2, taps, radius, yiq_to_rgb, layout,
                t, hr, w, in_h, in_w, yrow0, x0, sw, rows, run, smem, comp,
                gain, g_y, g_i, g_q, stream);
}

// Kernel 10: chans (T, Hr, W) Y rows; the chroma (post_tail.cuh's
// PBMM_CH_IQ, _U8 or _F32) either i_pl/q_pl (T, H, W) f32 planes or src,
// the source frames ((T, 3, H, W) where planar, else (T, H, W, 3)), with
// iq (host, the I and Q rows of RGB -> YIQ) and pre (a factor on each
// value first, or 0); the rest as pbmm_post_rgb.
extern "C" int pbmm_post_yonly(const float* chans, const float* i_pl,
                               const float* q_pl, const void* src,
                               int chroma, int planar, const float* iq,
                               float pre, const float* win,
                               void* out0, void* out1, void* out2,
                               const float* taps, int radius,
                               const float* yiq_to_rgb, int layout, int t,
                               int hr, int w, int in_h, int in_w, int yrow0,
                               int x0, int sw, int rows, int run, int smem,
                               int comp, int gain, float g_y, float g_i,
                               float g_q, void* stream) {
  if (chroma == PBMM_CH_RGB) return (int)cudaErrorInvalidValue;
  return pr_run(chroma, chans, i_pl, q_pl, src, planar, iq, pre, win, out0,
                out1, out2, taps, radius, yiq_to_rgb, layout, t, hr, w, in_h,
                in_w, yrow0, x0, sw, rows, run, smem, comp, gain, g_y, g_i,
                g_q, stream);
}

// Registers a thread of the instantiation for a chroma source (PBMM_CH_*)
// and layout, for the host's tile planner; a negative cudaError_t on a
// failure.
extern "C" int pbmm_post_tile_regs(int chroma, int layout) {
  int regs = 0;
  cudaError_t err;
  switch (chroma) {
    case PBMM_CH_RGB: err = tile_regs<PBMM_CH_RGB>(layout, &regs); break;
    case PBMM_CH_IQ: err = tile_regs<PBMM_CH_IQ>(layout, &regs); break;
    case PBMM_CH_U8: err = tile_regs<PBMM_CH_U8>(layout, &regs); break;
    default: err = tile_regs<PBMM_CH_F32>(layout, &regs); break;
  }
  return err != cudaSuccess ? -(int)err : regs;
}
