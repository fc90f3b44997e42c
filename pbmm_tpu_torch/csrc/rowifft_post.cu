// Kernel 3: Hermitian rebuild + row IFFT + |z| + blur + crop + chroma
// combine + YIQ->RGB, straight to the output layout.
//
// Replaces pbmm_tpu/engine/post_pallas.py:198 rowifft_post_fused (the
// Pallas kernel launched at :382, with the row transform of
// spectral/fused.py:1532 make_row_ifft_block and the rebuild of :1182
// _rebuild_kept_lanes).  Both chroma sources and all three output
// layouts of the JAX kernel are template parameters, with a chroma source
// and a layout the JAX package leaves to XLA:
//   CH PBMM_CH_IQ:  the original I/Q come as (T, H, W) f32 planes;
//   CH PBMM_CH_U8:  they are formed here from the uint8 source frames:
//                   (T, 3, H, W), (r c0 + g c1 + b c2) * window with the
//                   1/255 folded into c (post_pallas.py:319-331), or
//                   (T, H, W, 3), each value times 1/255 first, as the
//                   torch pre stage forms the planes;
//   CH PBMM_CH_F32: the same from f32 source frames, planar or
//                   interleaved, as the I/Q planes of the torch pre stage
//                   (pbmm_tpu/engine/pipeline.py:171 preprocess_cl), bit
//                   for bit the f32 I/Q route on those planes;
//   LAYOUT 0 "tuple3":    three (T, H, W) f32 planes;
//   LAYOUT 1 "planar":    one (T, 3, H, W) f32 array;
//   LAYOUT 2 "planar_u8": one (T, 3, H, W) uint8 array, rint(255 x)
//                         (round half to even, as jnp.round and
//                         torch.round; the value is clipped to [0, 1]);
//   LAYOUT 3 "interleaved": one (T, H, W, 3) f32 array, a thread's four
//                         pixels three 16-byte stores: the jnp.stack of
//                         "tuple3" the JAX engine runs after the kernel
//                         (pbmm_tpu/engine/video.py:168-169).
// The reference's quirk switches are runtime flags: Re z in place of |z|
// (reconstruct="real"), the window compensation (multiply by
// 1 / max(win, 1e-3)) and the YIQ gains, in the JAX kernel's order
// (post_pallas.py:335-342).
//
// Design.  A block owns a run of `run` output rows of one frame and
// streams the run's region rows (the run plus the r-row blur halo on each
// side) through three steps, `rows` region rows at a time:
//   1. the row transform on row_pass.cuh's engine (N / 16 threads a row,
//      up to four radix-2 stages a pass in registers), kernel 7's: its
//      first pass gathers the bit-reversed kept lanes with 16-byte loads,
//      rebuilding the missing tiles by the static plan, and its last pass
//      stores |z| * scale (or Re z * scale) into the row's own exchange
//      plane, rounded as kernel 7 rounds it, so the |z| rows are kernel
//      7's bit for bit;
//   2. the horizontal blur of each row, once, at the crop's columns only:
//      a thread owns four neighbouring columns and keeps their taps' sum
//      hb in registers (no modulo: the halo check puts x0 - r and
//      x0 + in_w + r inside the row; x0 is a multiple of 4);
//   3. the vertical taps: a ring of the 2 r previous hb rows in shared
//      memory (2 r x in_w f32), to which the thread's own four columns
//      alone are read and written, so the ring needs no barrier; once a
//      row's window is complete the epilogue runs on the four pixels:
//      16-byte loads of I/Q and the window (or 4-byte uchar4 loads of the
//      uint8 frames), the windowed chroma, compensation, gains, YIQ->RGB
//      and the clip, and 16-byte (planar_u8: 4-byte) stores.
// Steps 2 and 3 and the epilogue are post_tail.cuh's, which kernels 10 and
// 11 (post_rgb.cu) run on the rows they stage from device memory.
// So each region row is transformed once a run (the halo twice at the
// runs' ends), each blur product is taken once, and the blur sums in
// kernel 3's order of products and sums, every product and sum rounded on
// its own (__fmul_rn / __fadd_rn): the output equals kernel 7 followed by
// kernel 10 bit for bit, and "planar_u8" is exactly rint(255 * "planar").
// Shared memory: rows x pbmm_rp_row_floats(N) + 2 r x in_w floats, at
// most 227 KB; the caller chooses rows (engine/post_fused.py::
// kernel3_rows: up to 256 threads, fewer where the ring leaves less room)
// and runs kernel 7 + kernel 10 where not even one row fits.  The run
// length spreads the frames' rows over the blocks the SMs hold at once.
//
// What bounds it on an H100: it reads each region row's 2 x Wk f32 once
// and the chroma (8 bytes of f32 I/Q or 3 bytes of u8 a pixel, and the
// window), and writes 12 (f32) or 3 (u8) bytes a pixel: ~50 KB an output
// row at 1080p with f32 I/Q in and out; the transform costs 5 W log2(W)
// flops a region row: bytes bound.  On an NVIDIA H100 80GB HBM3 at its
// 700 W limit (tools/post_times.py) it takes 0.411 ms warm at the 1080p
// shape (16 x 1080 x 1920 out of 1152 x 1152 -> 2048 lanes, radius 2;
// chip_smoke.py's bound for the 1084 rows the crop needs: 832 MB, 0.248
// ms), 0.432 with the uint8 chroma to planar_u8 and 0.480 at radius 5
// (the stage-by-stage design before it: 2.176, 2.179 and 7.118; the
// horizontal sums' sliding 16-byte reads of post_tail.cuh took 0.468 to
// 0.411).  From radius 6 one block fills an SM (256 threads) and kernels
// 7 + 10 run faster (0.494 against 0.670 ms at 6; at 4096 lanes from
// radius 3, 1.907 against 2.530), so the route takes them wherever a
// block leaves an SM fewer than 512 threads
// (engine/post_fused.py::kernel3_serves).

#include "common.cuh"
#include "post_tail.cuh"
#include "row_pass.cuh"

struct PostParams {
  PbmmTailParams tail;  // taps, RGB matrix, u8 chroma rows, gains, flags
  int magnitude;        // |z| (1) or Re z (0)
};

struct PostIO {
  PbmmTailIO tail;   // chroma, window, outputs, in_h, in_w
  const float* rre;  // (T, hr, wk) bit-reversed kept lanes
  const float* rim;
  const float* tw_re;  // compact_twiddles(W, inverse)
  const float* tw_im;
  const int* plan_src;  // the rebuild plan (device tables, a tile each)
  const int* plan_rev;
  int radius, run, hr, wk, yrow0, x0;
  float scale;
};

// Word of natural lane c in a row's |z| plane: one word of padding every
// 32, so the four-column taps of a warp (stride 4) fall on distinct banks.
__device__ __forceinline__ int pp_zpad(int c) { return c + (c >> 5); }

#define PP_MAX_THREADS 512  // a block: one row of 8192 lanes

template <int N, int CH, int LAYOUT>
__global__ void __launch_bounds__(PP_MAX_THREADS)
    rowifft_post_kernel(PostIO io, PostParams prm) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  constexpr int RF = pbmm_rp_row_floats(N);
  const int rows = blockDim.x / NT;  // region rows in flight
  const int rr = threadIdx.x / NT, t = threadIdx.x % NT;
  float* sre = smem + rr * RF;
  float* sim = sre + pbmm_rp_pad(N);
  float* ring = smem + rows * RF;  // 2 r hb rows of in_w
  const int r = io.radius, r2 = 2 * r, in_w = io.tail.in_w;
  const int f = blockIdx.y;
  const int j0 = blockIdx.x * io.run;  // the run's first output row
  const int nreg = min(io.run, io.tail.in_h - j0) + r2;  // its region rows
  // Region row of the run's local row 0.
  const size_t reg0 = (size_t)f * io.hr + io.yrow0 + j0 - r;

  for (int y0 = 0; y0 < nreg; y0 += rows) {
    // 1. The transform of local rows y0 .. y0 + rows - 1, |z| into each
    //    row's re plane at pp_zpad(lane).
    const bool valid = y0 + rr < nreg;
    const float* src_re = io.rre + (reg0 + (valid ? y0 + rr : 0)) * io.wk;
    const float* src_im = io.rim + (reg0 + (valid ? y0 + rr : 0)) * io.wk;
    // First DIT pass (st = 1): kernel 7's rebuild load.
    auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                    float (&xi)[PBMM_RP_P]) {
      pbmm_rp_rebuild_load(gr, xr, xi, src_re, src_im, io.plan_src,
                           io.plan_rev, 0, valid);
    };
    // Last DIT pass: point q of group j is natural lane g + q st.  Every
    // thread of the block calls it: the barrier lets the row's last-pass
    // reads of its planes finish before |z| overwrites them.
    auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                     const float (&xi)[PBMM_RP_P]) {
      using G = PbmmRpOf<decltype(gr)>;
      __syncthreads();
      if (!valid) return;
#pragma unroll
      for (int j = 0; j < G::J; ++j) {
#pragma unroll
        for (int q = 0; q < G::L; ++q) {
          const float a = xr[j * G::L + q], b = xi[j * G::L + q];
          sre[pp_zpad(gr.pos(j, q))] =
              prm.magnitude
                  ? __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(a, a),
                                              __fmul_rn(b, b))),
                              io.scale)
                  : __fmul_rn(a, io.scale);
        }
      }
    };
    pbmm_row_transform<N, true, false>(t, sre, sim, io.tw_re, io.tw_im, ~0ull,
                                       load, store);
    __syncthreads();

    // 2-3. Per four columns: each new row's hb (post_tail.cuh), the
    //      vertical taps of the output row it completes, the epilogue, and
    //      hb into the ring.  The epilogue's loads run one output row ahead
    //      of its arithmetic (the next row of the quad, or the next quad's
    //      first).
    const int nrow = min(rows, nreg - y0);
    const int i0 = max(0, r2 - y0);  // the first row completing an output
    const int xstep = 4 * blockDim.x;
    PbmmTailIn next;
    if (i0 < nrow && 4 * (int)threadIdx.x < in_w)
      next = pbmm_tail_load<CH>(io.tail, prm.tail, f, j0 + y0 + i0 - r2,
                                4 * threadIdx.x);
    for (int x = 4 * threadIdx.x; x < in_w; x += xstep) {
      int slot = r2 ? y0 % r2 : 0;  // ring slot of local row y0 + i
      for (int i = 0; i < nrow; ++i) {
        const int yy = y0 + i;  // local region row
        const float* z = smem + i * RF;
        float hb[4];
        // Words q .. q + 3 (q a multiple of 4) share one padding offset.
        pbmm_tail_hsum4(
            [&](int q) {
              const float* p = z + pp_zpad(q);
              return make_float4(p[0], p[1], p[2], p[3]);
            },
            io.x0 + x, r, prm.tail, hb);
        if (i >= i0) {  // output row j0 + yy - 2 r: rows yy - 2 r .. yy
          const PbmmTailIn in = next;
          if (i + 1 < nrow)
            next = pbmm_tail_load<CH>(io.tail, prm.tail, f, j0 + yy + 1 - r2,
                                      x);
          else if (x + xstep < in_w)
            next = pbmm_tail_load<CH>(io.tail, prm.tail, f,
                                      j0 + y0 + i0 - r2, x + xstep);
          float v[3][4];
          pbmm_tail_vsum4(ring + x, in_w, slot, r2, prm.tail, hb, v[0]);
          pbmm_tail_epilogue<CH, LAYOUT>(io.tail, prm.tail, in, f,
                                         j0 + yy - r2, x, v);
        }
        pbmm_tail_ring_put(ring + x, in_w, slot, r2, hb);
        slot = pbmm_tail_next_slot(slot, r2);
      }
    }
    __syncthreads();  // the |z| planes are read; the next rows may come
  }
}

// Launch of kernel<N, CH, LAYOUT>: the run length from the blocks the SMs
// hold at once, then the grid.
template <int N, int CH, int LAYOUT>
static cudaError_t launch_post(PostIO io, const PostParams& prm, int rows,
                               int t, cudaStream_t stream) {
  const auto kernel = rowifft_post_kernel<N, CH, LAYOUT>;
  const int threads = rows * (N / PBMM_RP_P);
  const size_t smem = ((size_t)rows * pbmm_rp_row_floats(N) +
                       2 * (size_t)io.radius * io.tail.in_w) *
                      sizeof(float);
  if (threads > PP_MAX_THREADS) return cudaErrorInvalidValue;
  cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const int slots = sms * (per_sm > 1 ? per_sm : 1);
  const int runs = slots > t ? slots / t : 1;  // runs a frame
  io.run = (io.tail.in_h + runs - 1) / runs;
  const dim3 grid((io.tail.in_h + io.run - 1) / io.run, t);
  rowifft_post_kernel<N, CH, LAYOUT><<<grid, threads, smem, stream>>>(io,
                                                                       prm);
  return cudaGetLastError();
}

template <int N, int CH>
static cudaError_t post_layout(const PostIO& io, const PostParams& prm,
                               int rows, int t, int layout, cudaStream_t s) {
  switch (layout) {
    case PBMM_OUT_TUPLE3:
      return launch_post<N, CH, PBMM_OUT_TUPLE3>(io, prm, rows, t, s);
    case PBMM_OUT_PLANAR:
      return launch_post<N, CH, PBMM_OUT_PLANAR>(io, prm, rows, t, s);
    case PBMM_OUT_PLANAR_U8:
      return launch_post<N, CH, PBMM_OUT_PLANAR_U8>(io, prm, rows, t, s);
    default:
      return launch_post<N, CH, PBMM_OUT_INTERLEAVED>(io, prm, rows, t, s);
  }
}

template <int N>
static cudaError_t post_variant(const PostIO& io, const PostParams& prm,
                                int rows, int t, int layout, int chroma,
                                cudaStream_t s) {
  switch (chroma) {
    case PBMM_CH_IQ: return post_layout<N, PBMM_CH_IQ>(io, prm, rows, t,
                                                       layout, s);
    case PBMM_CH_U8: return post_layout<N, PBMM_CH_U8>(io, prm, rows, t,
                                                       layout, s);
    default: return post_layout<N, PBMM_CH_F32>(io, prm, rows, t, layout, s);
  }
}

// layout: 0 tuple3 (out0..2 = R, G, B planes), 1 planar f32, 2 planar
// uint8, 3 interleaved f32 (out0 only).  chroma: PBMM_CH_IQ (i_plane,
// q_plane), PBMM_CH_U8 or PBMM_CH_F32 (src: the source frames, planar or
// not; iq: host, the I and Q rows; pre: a factor on each value first, or
// 0).  tw_re / tw_im: compact_twiddles(w, inverse=True).  rows: region
// rows a block transforms at once (engine/post_fused.py::kernel3_rows).
extern "C" int pbmm_rowifft_post(
    const float* rre, const float* rim, const float* i_plane,
    const float* q_plane, const void* src, const float* win,
    const float* tw_re, const float* tw_im, void* out0, void* out1,
    void* out2, const int* plan_src, const int* plan_rev, int n_tiles,
    const float* taps, int radius, int rows, const float* yiq_to_rgb,
    const float* iq, float pre, int chroma, int planar, int layout, int t,
    int hr, int wk, int w, int in_h, int in_w, int yrow0, int x0,
    float scale, int magnitude, int comp, int gain, float g_y, float g_i,
    float g_q, void* stream) {
  const bool from_src = chroma == PBMM_CH_U8 || chroma == PBMM_CH_F32;
  if (t < 1 || t > 65535 || n_tiles < 1 || plan_src == nullptr ||
      plan_rev == nullptr || n_tiles * PBMM_LANE != w ||
      !pbmm_rp_length_ok(w) ||
      wk < PBMM_LANE || wk > w || radius < 0 ||
      radius > PBMM_MAX_BLUR_R || rows < 1 || in_h < 1 ||
      in_w < 4 || in_w % 4 != 0 || x0 % 4 != 0 || yrow0 - radius < 0 ||
      yrow0 + in_h + radius > hr || x0 < radius || x0 + in_w + radius > w ||
      layout < 0 || layout > 3 ||
      (chroma != PBMM_CH_IQ && !from_src) ||
      (chroma == PBMM_CH_IQ && (i_plane == nullptr || q_plane == nullptr)) ||
      (from_src && (src == nullptr || iq == nullptr)) ||
      out0 == nullptr || (layout == 0 && (out1 == nullptr || out2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores (4-byte for the uint8 frames and planes).
  const void* vec16[] = {rre, rim, win, layout == 2 ? nullptr : out0,
                         chroma == PBMM_CH_IQ ? i_plane : nullptr,
                         chroma == PBMM_CH_IQ ? q_plane : nullptr,
                         chroma == PBMM_CH_F32 ? src : nullptr,
                         layout == 0 ? out1 : nullptr,
                         layout == 0 ? out2 : nullptr};
  for (const void* p : vec16)
    if ((size_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if ((layout == 2 && (size_t)out0 % 4 != 0) ||
      (chroma == PBMM_CH_U8 && (size_t)src % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  PostParams prm;
  for (int i = 0; i <= 2 * radius; ++i) prm.tail.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.tail.m[i] = yiq_to_rgb[i];
  for (int i = 0; i < 6; ++i) prm.tail.iq[i] = from_src ? iq[i] : 0.0f;
  prm.tail.pre = from_src ? pre : 0.0f;
  prm.tail.gains[0] = g_y;
  prm.tail.gains[1] = g_i;
  prm.tail.gains[2] = g_q;
  prm.tail.comp = comp;
  prm.tail.gain = gain;
  prm.magnitude = magnitude;
  const PostIO io = {
      {i_plane, q_plane, src, planar ? 1 : 3, planar ? in_h * in_w : 1, win,
       out0, out1, out2, in_h, in_w},
      rre, rim, tw_re, tw_im, plan_src, plan_rev, radius, 0, hr, wk, yrow0,
      x0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define PP_LAUNCH(N) \
  err = post_variant<N>(io, prm, rows, t, layout, chroma, s)
  PBMM_RP_SWITCH(w, PP_LAUNCH)
#undef PP_LAUNCH
  return (int)err;
}
