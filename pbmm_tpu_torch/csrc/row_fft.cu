// Kernels 1 and 4: Hann-windowed row FFT, Hermitian kept tiles.
//
// Kernel 1 replaces pbmm_tpu/spectral/fused.py:79 windowed_row_fft (the
// Pallas kernel launched at :149).  Each padded content row y[b, r, :] (W
// real values) is multiplied by hann_row[r] * hann_col[:], transformed by
// a radix-2 decimation-in-frequency FFT (natural order in, bit-reversed
// order out, the JAX kernel's layout), and only the kept 128-lane tiles
// of the Hermitian half are written (9 of 16 at W = 2048).
//
// Kernel 4 replaces pbmm_tpu/spectral/fused.py:168
// windowed_row_fft_u8planar (launched at :285): the same transform fed
// straight from (T, 3, H, W) uint8 frames.  Per output row it reads the
// three u8 source rows (source row r - off, zero outside [0, H)), forms
// Y = r c_r + g c_g + b c_b with r = u8 * f32(1/255) at column x0 + c of
// the padded row (zero elsewhere), applies the window, and runs the same
// FFT and store as kernel 1.  The luma and window arithmetic is written
// with __fmul_rn / __fadd_rn in the pre stage's op order, so nvcc cannot
// contract it into FMAs, and the FFT runs kernel 1's butterflies in
// kernel 1's order: kernel 4 then equals the torch pre stage + kernel 1
// bit for bit, the contract the JAX kernel states (fused.py:249-253).
//
// The front end (spectral/fused.py::windowed_row_fft_frames) is kernel 4's
// kernel on every input form the batched chunk engine takes: uint8 or f32
// frames (the element type is a template parameter; f32 values are used
// as they are, as unit_float leaves them), planar or interleaved (runtime
// pixel and channel strides), and one plane (Y) or three (Y, I, Q for
// chroma="rgb", plane-minor frame-major).  It replaces the pre stage the
// JAX package leaves to XLA (pbmm_tpu/engine/pipeline.py:171
// preprocess_cl: the RGB -> YIQ rows, the centre pad and the window before
// kernel 1), so no YIQ plane or padded slab is written: it equals the torch
// pre stage + kernel 1 bit for bit, as kernel 4 does.

// What bounds them on an H100: kernel 1 reads the row once (4W bytes),
// kernel 4 three u8 rows (3w bytes), the front end three rows of its
// element type (three times over for three planes, from L2 after the
// first); all write 2 x Wk x 4 bytes, about
// 9 KB per 2048-lane row.  The 11 stages cost 5 W log2(W) flops, ~1.1e5
// per row, so the kernels are bound by device memory only if the
// butterflies keep up.  The JAX kernel's 128x128 "intra-group" matmul is
// just the product of the last 7 stages, so it runs as ordinary stages
// here.
//
// Design (both kernels): the row engine of row_pass.cuh.  W / 16 threads
// hold a row, 16 points each.  Each thread first forms the windowed row
// of 16 consecutive lanes and stages it in shared memory: kernel 1 from
// four 16-byte loads of its f32 row, kernel 4 and the front end from
// 16-byte loads of the three channels (element loads where the frame's
// width or placement breaks the 16-byte alignment); the first DIF pass
// reads it from there.  The passes
// exchange through shared memory (three barriers at W = 2048, against 11
// for the stage-by-stage design kernel 1 had before); the last 7 stages
// run as passes of 4 and 3 inside 128-lane tiles, skipped for the tiles
// that are not kept (7 of 16 at W = 2048, as the JAX kernel applies its
// intra-group matmul to the kept tiles only); in the last pass a thread
// holds 16 consecutive bit-reversed lanes of one tile and stores them
// with 16-byte stores.  Twiddles: the compact table (W - 1 words) in L1.
// Rows under 2048 lanes are packed several to a block.  Every butterfly
// is pbmm_radix2's, so kernel 1 equals the stage-by-stage DIF (and kernel
// 8's row pass on the windowed rows, on this engine too) bit for bit.  On an NVIDIA H100 80GB
// HBM3 at its 700 W limit (chip_smoke.py) kernel 4 takes 0.191 ms warm at
// 1080p ((16, 3, 1080, 1920) u8 -> 16 x 1152 rows of 1152 kept lanes:
// 269 MB), against 0.417 for torch.fft.fft on the f32 rows, and kernel 1
// 0.186 ms at (16, 1152, 2048) f32 (321 MB) against 0.417 for
// torch.fft.fft and 0.520 for its stage-by-stage design.
//
// A row of 16384 lanes (16K) still fits one block (1024 threads, 139 KB;
// measured faster than the bracket below on kernel 8's row pass, PERF.md):
// there every tile's last passes run and the store skips the tiles not
// kept.  Longer rows run col_pass.cuh's bracket: rf_bracket_kernel forms the
// windowed row (kernel 1's product or the frames' plane, element loads,
// the same rounded ops) in its first pass, runs the outer DIF stages and
// writes the complex row to a scratch the wrapper allocates;
// rf_inner_kernel then runs the row engine on each 8192-lane block of the
// scratch and stores the block's kept tiles by their global tile numbers.
// The kept tiles' positions are a device table of one int a tile (-1: not
// kept; 65 of 128 tiles kept at 16384 lanes); a block up to 8192 lanes
// derives its 64-bit keep mask by two warp ballots.

#include "col_pass.cuh"
#include "common.cuh"
#include "row_pass.cuh"

// The keep bits of the 64 tiles from pos[0] (ntiles of them in the row):
// tile i is kept where pos[i] >= 0.  Every thread of a warp calls it.
__device__ __forceinline__ unsigned long long rf_keep_mask(
    const int* __restrict__ pos, int ntiles) {
  const int l = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(~0u, l < ntiles && __ldg(pos + l) >= 0);
  const unsigned hi =
      __ballot_sync(~0u, l + 32 < ntiles && __ldg(pos + 32 + l) >= 0);
  return ((unsigned long long)hi << 32) | lo;
}

// The shared part of kernels 1 and 4: load(gr, xr, xi) fills the first
// DIF pass's groups (the windowed row staged in shared memory, or a
// bracketed block from the scratch), the passes run and the kept tiles go
// to row rowid of out_re / out_im (n_kept * 128 lanes a row).  pos: the
// kept position of each tile of this block's N lanes, keep: their bits.
template <int N, class Load>
__device__ __forceinline__ void rf_transform_store(
    int t, float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, const int* __restrict__ pos,
    unsigned long long keep, int n_kept, long long rowid, bool valid,
    float* __restrict__ out_re, float* __restrict__ out_im, Load&& load) {
  // Last DIF pass (st = 1), its groups adjacent: a thread holds 2^K J
  // consecutive bit-reversed lanes of one tile, stored only where the
  // tile is kept (its groups elsewhere were skipped).
  const size_t wk = (size_t)n_kept * PBMM_LANE;
  float* dre = out_re + (size_t)rowid * wk;
  float* dim = out_im + (size_t)rowid * wk;
  auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                   const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
    static_assert(G::L % 4 == 0, "the last DIF pass runs 2 stages or more");
    if (!valid) return;
#pragma unroll
    for (int j = 0; j < G::J; ++j) {
      if (!gr.on[j]) continue;
      const int p0 = gr.base[j];
      const int kp = __ldg(pos + p0 / PBMM_LANE);
      if (N > PBMM_RP_MAXN && kp < 0) continue;  // a tile not kept
      const size_t o = (size_t)kp * PBMM_LANE + p0 % PBMM_LANE;
#pragma unroll
      for (int c = 0; c < G::L / 4; ++c) {
        const int e = j * G::L + 4 * c;
        reinterpret_cast<float4*>(dre + o)[c] =
            make_float4(xr[e], xr[e + 1], xr[e + 2], xr[e + 3]);
        reinterpret_cast<float4*>(dim + o)[c] =
            make_float4(xi[e], xi[e + 1], xi[e + 2], xi[e + 3]);
      }
    }
  };
  pbmm_row_transform<N, false, true>(t, sre, sim, tw_re, tw_im, keep, load,
                                     store);
}

// The first DIF pass's load from a row staged in the re plane: base = g <
// st, so point q of group j is lane g + q st, its imaginary part 0.
template <class G>
__device__ __forceinline__ void rf_staged_load(const G& gr,
                                               float (&xr)[PBMM_RP_P],
                                               float (&xi)[PBMM_RP_P],
                                               const float* sre) {
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    const float* a = sre + pbmm_rp_pad(gr.base[j]);
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      xr[j * G::L + q] = a[pbmm_rp_pad(q * G::ST)];
      xi[j * G::L + q] = 0.0f;
    }
  }
}

// The source frames of kernel 4 and the front end: (T, 3, H, W) planar or
// (T, H, W, 3) interleaved, uint8 or f32 (the element type is the
// kernels' template parameter), and the RGB -> YIQ rows of the planes they
// form: one (Y) or three (Y, I, Q, stored plane-minor frame-major: the
// stack chroma="rgb" feeds kernel 2).  Source row r of frame f starts at
// element f 3 h_in w_in + r w_in px; channel c of its pixel x lies at
// x px + c ch (planar: px 1, ch h_in w_in; interleaved: px 3, ch 1).
struct RfFrames {
  const void* src;
  float co[3][3];  // the rows of the planes formed
  float s;         // f32(1/255): uint8 values are scaled first (unit_float)
  int planes;      // 1 or 3
  int hc, h_in, w_in, off, x0;  // content rows; the frame and its place
  int px, ch;      // element strides of a pixel and of a channel
};

// Row d of the planes' colour rows, by selects (no dynamic index into the
// kernel's parameters).
__device__ __forceinline__ void rf_rows(const RfFrames& fr, int d,
                                        float (&c)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = d == 0 ? fr.co[0][k] : d == 1 ? fr.co[1][k] : fr.co[2][k];
}

// The pre stage's value of a source element (unit_float): uint8 v as
// f32(v) * s (the cast is exact), f32 as it is.
template <typename T>
__device__ __forceinline__ float rf_unit(float raw, float s) {
  return sizeof(T) == 1 ? __fmul_rn(raw, s) : raw;
}

// c[0] r + c[1] g + c[2] b in channel_mix's order, each product and sum
// rounded on its own.
__device__ __forceinline__ float rf_mix(float r, float g, float b,
                                        const float (&c)[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, c[0]), __fmul_rn(g, c[1])),
                   __fmul_rn(b, c[2]));
}

// Element k of a 16-byte word of T values, as the exact float of its value
// (uint8 by the exponent trick, exact as the cast is).
template <typename T>
__device__ __forceinline__ float rf_elem(const uint4& w, int k) {
  constexpr int E = 4 / sizeof(T);  // elements a 32-bit word
  const int m = k / E;
  const unsigned u = m == 0 ? w.x : m == 1 ? w.y : m == 2 ? w.z : w.w;
  if (sizeof(T) == 4) return __uint_as_float(u);
  const unsigned b = (u >> (8 * (k % E))) & 0xffu;
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// Where a row of the output lies in the frames: frame f, plane d, content
// row `row`, and whether its source row (row - off) lies in the frame.
struct RfRowAt {
  int f, d, row;
  bool content;
};

// Output row n_row = (f planes + d) hc + row.
__device__ __forceinline__ RfRowAt rf_row_at(const RfFrames& fr,
                                             long long n_row) {
  RfRowAt a;
  const long long q = n_row / fr.hc;  // f planes + d
  a.row = (int)(n_row - q * fr.hc);
  a.f = (int)(q / fr.planes);
  a.d = (int)(q - (long long)a.f * fr.planes);
  const int sr = a.row - fr.off;
  a.content = sr >= 0 && sr < fr.h_in;
  return a;
}

// The first element of the source row of `a` (row 0 of the frame where
// the row lies outside it).
template <typename T>
__device__ __forceinline__ const T* rf_src_row(const RfFrames& fr,
                                               const RfRowAt& a) {
  return static_cast<const T*>(fr.src) +
         (size_t)a.f * 3 * fr.h_in * fr.w_in +
         (size_t)(a.content ? a.row - fr.off : 0) * fr.w_in * fr.px;
}

// The plane value (before the window) at column xs of source row rp, zero
// outside the frame (the centre pad), element by element.
template <typename T>
__device__ __forceinline__ float rf_frame_value(const RfFrames& fr,
                                                const T* rp, long long xs,
                                                const float (&c)[3]) {
  if (xs < 0 || xs >= fr.w_in) return 0.0f;
  const T* p = rp + (size_t)xs * fr.px;
  return rf_mix(rf_unit<T>((float)__ldg(p), fr.s),
                rf_unit<T>((float)__ldg(p + fr.ch), fr.s),
                rf_unit<T>((float)__ldg(p + 2 * fr.ch), fr.s), c);
}
// Kernel 1: rows of (batch x hc) padded f32 content rows of N lanes.
template <int N>
__global__ void __launch_bounds__(PBMM_RP_BOUND(N))
    row_fft_f32_kernel(const float* __restrict__ y,
                       const float* __restrict__ wy,
                       const float* __restrict__ wx,
                       const float* __restrict__ tw_re,
                       const float* __restrict__ tw_im,
                       float* __restrict__ out_re, float* __restrict__ out_im,
                       const int* __restrict__ pos, int n_kept,
                       long long rows, int hc) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  const int r = threadIdx.x / NT, t = threadIdx.x % NT;
  const long long rowid =
      (long long)blockIdx.x * pbmm_rp_rows_per_block(N) + r;
  const bool valid = rowid < rows;
  float* sre = smem + (size_t)r * pbmm_rp_row_floats(N);
  float* sim = sre + pbmm_rp_pad(N);
  const long long src = valid ? rowid : 0;  // a past-the-end row reads row 0
  const float wr = wy[src % hc];
  const unsigned long long keep = rf_keep_mask(pos, N / PBMM_LANE);

  // Thread t windows lanes [16 t, 16 t + 16): y * wy[row] * wx in the op
  // order of the pre stage's product, from 16-byte loads.
  {
    constexpr int C = PBMM_RP_P;
    const int i0 = t * C;
    const float4* y4 = reinterpret_cast<const float4*>(y + src * N + i0);
    const float4* w4 = reinterpret_cast<const float4*>(wx + i0);
    float4 v[C / 4];
#pragma unroll
    for (int c = 0; c < C / 4; ++c) v[c] = __ldg(y4 + c);
#pragma unroll
    for (int c = 0; c < C / 4; ++c) {
      const float4 u = __ldg(w4 + c);
      const float yv[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
      const float wv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sre[pbmm_rp_pad(i0 + 4 * c + e)] =
            __fmul_rn(__fmul_rn(yv[e], wr), wv[e]);
    }
  }
  __syncthreads();
  rf_transform_store<N>(
      t, sre, sim, tw_re, tw_im, pos, keep, n_kept, rowid, valid, out_re,
      out_im, [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) { rf_staged_load(gr, xr, xi, sre); });
}

// Kernel 4 and the front end: rows of (t x planes x hc) content rows of N
// lanes formed from the frames.  A block's row vid is plane d = vid mod
// planes of content row q = vid / planes (frame q / hc), so the planes of
// one source row are neighbours and meet in L2; it is stored as row
// (f planes + d) hc + row of the output.
template <int N, typename T>
__global__ void __launch_bounds__(PBMM_RP_BOUND(N))
    row_fft_frames_kernel(RfFrames fr, const float* __restrict__ wy,
                          const float* __restrict__ wx,
                          const float* __restrict__ tw_re,
                          const float* __restrict__ tw_im,
                          float* __restrict__ out_re,
                          float* __restrict__ out_im,
                          const int* __restrict__ pos, int n_kept,
                          long long rows, int vec) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  const int r = threadIdx.x / NT, t = threadIdx.x % NT;
  const long long vid =
      (long long)blockIdx.x * pbmm_rp_rows_per_block(N) + r;
  const bool valid = vid < rows;
  float* sre = smem + (size_t)r * pbmm_rp_row_floats(N);
  float* sim = sre + pbmm_rp_pad(N);
  const long long vr = valid ? vid : 0;
  const long long q = vr / fr.planes;
  const int d = (int)(vr - q * fr.planes);
  const int f = (int)(q / fr.hc);
  const long long rowid =
      ((long long)f * fr.planes + d) * fr.hc + (q - (long long)f * fr.hc);
  RfRowAt at = rf_row_at(fr, rowid);
  at.content = at.content && valid;
  const T* rp = rf_src_row<T>(fr, at);
  float c[3];
  rf_rows(fr, d, c);
  const float wr = wy[at.row];
  const unsigned long long keep = rf_keep_mask(pos, N / PBMM_LANE);

  // The row's windowed plane, staged in the re plane: thread t forms lanes
  // [16 t, 16 t + 16) from 16-byte loads, a word a channel for each group
  // of G pixels (planar: one word of each channel's row; interleaved: the
  // three consecutive words of the G pixels), where the run lies inside
  // the frame row and vec allows it (the frames, a row and x0 16-byte
  // aligned); element by element where it straddles the frame's edge;
  // zero where it lies outside.
  {
    constexpr int C = PBMM_RP_P;
    constexpr int G = 16 / sizeof(T);  // pixels a group
    static_assert(C % G == 0, "a thread stages whole groups");
    const int i0 = t * C, xs = i0 - fr.x0;
    float v[C];
    if (!at.content || xs + C <= 0 || xs >= fr.w_in) {
#pragma unroll
      for (int e = 0; e < C; ++e) v[e] = 0.0f;
    } else if (vec && xs >= 0 && xs + C <= fr.w_in) {
#pragma unroll
      for (int g = 0; g < C / G; ++g) {
        const int x = xs + g * G;
        uint4 w[3];
        if (fr.px == 1) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            w[k] = __ldg(reinterpret_cast<const uint4*>(
                rp + (size_t)k * fr.ch + x));
#pragma unroll
          for (int e = 0; e < G; ++e)
            v[g * G + e] = rf_mix(rf_unit<T>(rf_elem<T>(w[0], e), fr.s),
                                  rf_unit<T>(rf_elem<T>(w[1], e), fr.s),
                                  rf_unit<T>(rf_elem<T>(w[2], e), fr.s), c);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            w[k] = __ldg(reinterpret_cast<const uint4*>(rp + 3 * (size_t)x) +
                         k);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            float ch[3];
#pragma unroll
            for (int k = 0; k < 3; ++k)
              ch[k] = rf_unit<T>(
                  rf_elem<T>(w[(3 * e + k) / G], (3 * e + k) % G), fr.s);
            v[g * G + e] = rf_mix(ch[0], ch[1], ch[2], c);
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < C; ++e) v[e] = rf_frame_value<T>(fr, rp, xs + e, c);
    }
    const float4* w4 = reinterpret_cast<const float4*>(wx + i0);
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 u = __ldg(w4 + k);
      const float wv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sre[pbmm_rp_pad(i0 + 4 * k + e)] =
            __fmul_rn(__fmul_rn(v[4 * k + e], wr), wv[e]);
    }
  }
  __syncthreads();
  rf_transform_store<N>(
      t, sre, sim, tw_re, tw_im, pos, keep, n_kept, rowid, valid, out_re,
      out_im, [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) { rf_staged_load(gr, xr, xi, sre); });
}

// The front end of a bracketed row (longer than PBMM_BK_N): the windowed
// value at lane x of output row rowid, kernel 1's (f32 rows) or the
// frames' (kernel 4 and the front end; u8: uint8 frames, else f32).
struct RfFront {
  const float* y;  // kernel 1: (rows, n) f32; null for the frames
  RfFrames fr;
  int u8;
  const float* wy;  // the content rows' window
  const float* wx;
  int hc;
  __device__ __forceinline__ float operator()(long long rowid, long long n,
                                              long long x) const {
    if (y != nullptr)
      return __fmul_rn(__fmul_rn(__ldcs(y + rowid * n + x),
                                 __ldg(wy + rowid % hc)),
                       __ldg(wx + x));
    const RfRowAt a = rf_row_at(fr, rowid);
    float c[3];
    rf_rows(fr, a.d, c);
    const long long xs = x - fr.x0;
    const float v =
        !a.content ? 0.0f
        : u8 ? rf_frame_value(fr, rf_src_row<unsigned char>(fr, a), xs, c)
             : rf_frame_value(fr, rf_src_row<float>(fr, a), xs, c);
    return __fmul_rn(__fmul_rn(v, __ldg(wy + a.row)), __ldg(wx + x));
  }
};

// One bracket pass of kernel 1 or 4's rows of n lanes: thread (row,
// group); FIRST forms the windowed points (imaginary part 0, the complex
// butterflies of kernel 1), the later passes run in place on the (rows,
// n) scratch.
template <int L, bool FIRST>
__global__ void __launch_bounds__(PBMM_BK_THREADS)
    rf_bracket_kernel(RfFront front, float* sc_re, float* sc_im,
                      const float* __restrict__ tw_re,
                      const float* __restrict__ tw_im, long long n, int lst) {
  constexpr int K = pbmm_log2(L);
  const long long g = (long long)blockIdx.y * PBMM_BK_THREADS + threadIdx.x;
  if (g >= (n >> K)) return;
  const long long st = 1ll << lst;
  const int base = pbmm_cp_base<K>((int)g, lst);
  const long long rowid = blockIdx.x;
  float* dr = sc_re + rowid * n + base;
  float* di = sc_im + rowid * n + base;
  float xr[L], xi[L];
#pragma unroll
  for (int q = 0; q < L; ++q) {
    xr[q] = FIRST ? front(rowid, n, base + q * st) : __ldcs(dr + q * st);
    xi[q] = FIRST ? 0.0f : __ldcs(di + q * st);
  }
  pbmm_cp_stages<L, false, false, true>(base, lst, 0, 0, xr, xi, tw_re, tw_im);
#pragma unroll
  for (int q = 0; q < L; ++q) {
    dr[q * st] = xr[q];
    di[q * st] = xi[q];
  }
}

// The inner stages of a bracketed row: the row engine on block blk of row
// rowid (block vid = rowid (n / PBMM_BK_N) + blk of the scratch, in
// place of its first pass's loads), the block's kept tiles stored by
// their global tile numbers.
__global__ void __launch_bounds__(PBMM_BK_N / PBMM_RP_P)
    rf_inner_kernel(const float* __restrict__ sc_re,
                    const float* __restrict__ sc_im,
                    const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im,
                    float* __restrict__ out_re, float* __restrict__ out_im,
                    const int* __restrict__ pos, int n_kept, int blks) {
  extern __shared__ float smem[];
  constexpr int N = PBMM_BK_N;
  const long long vid = blockIdx.x;
  const long long rowid = vid / blks;
  const int blk = (int)(vid - rowid * blks);
  const int* bpos = pos + (size_t)blk * (N / PBMM_LANE);
  const unsigned long long keep = rf_keep_mask(bpos, N / PBMM_LANE);
  float* sre = smem;
  float* sim = smem + pbmm_rp_pad(N);
  const float* src_re = sc_re + vid * N;
  const float* src_im = sc_im + vid * N;
  rf_transform_store<N>(
      threadIdx.x, sre, sim, tw_re, tw_im, bpos, keep, n_kept, rowid, true,
      out_re, out_im,
      [&](const auto& gr, float (&xr)[PBMM_RP_P], float (&xi)[PBMM_RP_P]) {
        using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
        for (int j = 0; j < G::J; ++j)
#pragma unroll
          for (int q = 0; q < G::L; ++q) {
            xr[j * G::L + q] = __ldcs(src_re + gr.pos(j, q));
            xi[j * G::L + q] = __ldcs(src_im + gr.pos(j, q));
          }
      });
}

// Every launch of a bracketed row FFT: the bracket passes into the
// scratch (rows, w), then the inner kernel.
static int rf_bracketed(const RfFront& front, const float* tw_re,
                        const float* tw_im, float* sc_re, float* sc_im,
                        float* out_re, float* out_im, const int* pos,
                        int n_kept, long long rows, int w,
                        cudaStream_t stream) {
  if (sc_re == nullptr || sc_im == nullptr || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = pbmm_bracket_launch(
      w, false, [&](const PbmmCpPass& p, bool first, bool) -> cudaError_t {
        const dim3 grid((unsigned)rows,
                        (unsigned)(((w >> p.k) + PBMM_BK_THREADS - 1) /
                                   PBMM_BK_THREADS));
#define RF_BK(L)                                                           \
  if (first)                                                               \
    rf_bracket_kernel<L, true><<<grid, PBMM_BK_THREADS, 0, stream>>>(      \
        front, sc_re, sc_im, tw_re, tw_im, w, p.lst);                      \
  else                                                                     \
    rf_bracket_kernel<L, false><<<grid, PBMM_BK_THREADS, 0, stream>>>(     \
        front, sc_re, sc_im, tw_re, tw_im, w, p.lst)
        PBMM_CP_SWITCH(p.k, RF_BK)
#undef RF_BK
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  const int blks = w / PBMM_BK_N;
  const long long vblocks = rows * blks;
  if (vblocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)pbmm_rp_row_floats(PBMM_BK_N) * sizeof(float);
  err = pbmm_smem_opt_in(rf_inner_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rf_inner_kernel<<<(unsigned)vblocks, PBMM_BK_N / PBMM_RP_P, smem,
                    stream>>>(sc_re, sc_im, tw_re, tw_im, out_re, out_im, pos,
                              n_kept, blks);
  return (int)cudaGetLastError();
}

// The checks both entry points share: w a power-of-two row of 128 lanes
// or more, 16-byte aligned wx and outputs (n_kept * 128 floats keep every
// row aligned), the kept tiles distinct and inside the row (host table
// kept_tiles; pos: the same as a device table of w / 128 positions, -1
// where a tile is not kept).
static int rf_setup(const int* kept_tiles, int n_kept, int w, const float* wx,
                    const float* out_re, const float* out_im,
                    const int* pos) {
  if (w < PBMM_RP_MINN || (w & (w - 1)) != 0 || n_kept < 1 ||
      n_kept > w / PBMM_LANE || pos == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((size_t)wx % 16 != 0 || (size_t)out_re % 16 != 0 ||
      (size_t)out_im % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < n_kept; ++i) {
    const int tile = kept_tiles[i];
    if (tile < 0 || (tile + 1) * PBMM_LANE > w)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < i; ++j)
      if (kept_tiles[j] == tile) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Blocks of pbmm_rp_rows_per_block(w) rows, and their shared memory.
static bool rf_grid(long long rows, int w, unsigned* blocks, size_t* smem) {
  const int rpb = pbmm_rp_rows_per_block(w);
  const long long b = (rows + rpb - 1) / rpb;
  *blocks = (unsigned)b;
  *smem = (size_t)rpb * pbmm_rp_row_floats(w) * sizeof(float);
  return b <= 2147483647LL;
}

// tw_re / tw_im: compact_twiddles(w, inverse=False), w - 1 words each;
// sc_re / sc_im: a (batch hc, w) scratch above 16384 lanes (else null).
extern "C" int pbmm_row_fft(const float* y, const float* wy, const float* wx,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im,
                            const int* kept_tiles, const int* pos,
                            int n_kept, int batch, int hc, int w,
                            float* sc_re, float* sc_im, void* stream) {
  if (batch < 1 || hc < 1) return (int)cudaErrorInvalidValue;
  const int bad = rf_setup(kept_tiles, n_kept, w, wx, out_re, out_im, pos);
  if (bad) return bad;
  if ((size_t)y % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const long long rows = (long long)batch * hc;
  cudaStream_t s = (cudaStream_t)stream;
  if (w > PBMM_RP_BLOCKN) {
    const RfFront front = {y, RfFrames{}, 0, wy, wx, hc};
    return rf_bracketed(front, tw_re, tw_im, sc_re, sc_im, out_re, out_im,
                        pos, n_kept, rows, w, s);
  }
  unsigned blocks;
  size_t smem;
  if (!rf_grid(rows, w, &blocks, &smem)) return (int)cudaErrorInvalidValue;
  const int rpb = pbmm_rp_rows_per_block(w);
#define RF1_LAUNCH(N)                                                       \
  {                                                                         \
    cudaError_t err = pbmm_smem_opt_in(row_fft_f32_kernel<N>, smem);        \
    if (err != cudaSuccess) return (int)err;                                \
    row_fft_f32_kernel<N><<<blocks, rpb * (N / PBMM_RP_P), smem, s>>>(      \
        y, wy, wx, tw_re, tw_im, out_re, out_im, pos, n_kept, rows, hc);    \
  }
  PBMM_RP_SWITCH_BLOCK(w, RF1_LAUNCH)
#undef RF1_LAUNCH
  return (int)cudaGetLastError();
}

// The frames' launches: the block engine (rows to 16384 lanes), else the
// bracket.
template <typename T>
static int rf_frames_run(const RfFrames& fr, const float* wy, const float* wx,
                         const float* tw_re, const float* tw_im,
                         float* out_re, float* out_im, const int* pos,
                         int n_kept, long long rows, int w, float* sc_re,
                         float* sc_im, cudaStream_t s) {
  if (w > PBMM_RP_BLOCKN) {
    const RfFront front = {nullptr, fr, sizeof(T) == 1, wy, wx, fr.hc};
    return rf_bracketed(front, tw_re, tw_im, sc_re, sc_im, out_re, out_im,
                        pos, n_kept, rows, w, s);
  }
  unsigned blocks;
  size_t smem;
  if (!rf_grid(rows, w, &blocks, &smem)) return (int)cudaErrorInvalidValue;
  const int rpb = pbmm_rp_rows_per_block(w);
  // 16-byte loads where the frames, w_in and x0 keep every 16-byte group of
  // a row aligned; element loads otherwise.
  constexpr int G = 16 / sizeof(T);
  const int vec = (size_t)fr.src % 16 == 0 && fr.w_in % G == 0 &&
                  fr.x0 % G == 0;
#define RFF_LAUNCH(N)                                                        \
  {                                                                          \
    cudaError_t err = pbmm_smem_opt_in(row_fft_frames_kernel<N, T>, smem);   \
    if (err != cudaSuccess) return (int)err;                                 \
    row_fft_frames_kernel<N, T><<<blocks, rpb * (N / PBMM_RP_P), smem, s>>>( \
        fr, wy, wx, tw_re, tw_im, out_re, out_im, pos, n_kept, rows, vec);   \
  }
  PBMM_RP_SWITCH_BLOCK(w, RFF_LAUNCH)
#undef RFF_LAUNCH
  return (int)cudaGetLastError();
}

// Kernel 4 and the front end.  frames: (t, 3, h_in, w_in) (planar) or (t,
// h_in, w_in, 3), uint8 (u8) or f32; coeffs: host, planes rows of 3 (the
// RGB -> YIQ rows of the planes formed: 1, Y, or 3, Y, I, Q); scale:
// f32(1/255), by which uint8 values are multiplied first.  Output rows
// (t planes hc, n_kept 128), plane-minor frame-major.  tw_re / tw_im:
// compact_twiddles(w, inverse=False), w - 1 words each; sc_re / sc_im: a
// (t planes hc, w) scratch above 16384 lanes (else null).
extern "C" int pbmm_row_fft_frames(
    const void* frames, const float* coeffs, const float* wy,
    const float* wx, const float* tw_re, const float* tw_im, float* out_re,
    float* out_im, const int* kept_tiles, const int* pos, int u8, int planar,
    int planes, int n_kept, int t, int hc, int h_in, int w_in, int w,
    int off, int x0, float scale, float* sc_re, float* sc_im, void* stream) {
  if (t < 1 || hc < 1 || h_in < 1 || w_in < 1 || x0 < 0 || x0 + w_in > w ||
      (planes != 1 && planes != 3) || frames == nullptr)
    return (int)cudaErrorInvalidValue;
  const int bad = rf_setup(kept_tiles, n_kept, w, wx, out_re, out_im, pos);
  if (bad) return bad;
  RfFrames fr;
  fr.src = frames;
  for (int d = 0; d < 3; ++d)
    for (int k = 0; k < 3; ++k) fr.co[d][k] = d < planes ? coeffs[3 * d + k]
                                                         : 0.0f;
  fr.s = scale;
  fr.planes = planes;
  fr.hc = hc;
  fr.h_in = h_in;
  fr.w_in = w_in;
  fr.off = off;
  fr.x0 = x0;
  fr.px = planar ? 1 : 3;
  fr.ch = planar ? h_in * w_in : 1;
  const long long rows = (long long)t * planes * hc;
  cudaStream_t s = (cudaStream_t)stream;
  return u8 ? rf_frames_run<unsigned char>(fr, wy, wx, tw_re, tw_im, out_re,
                                           out_im, pos, n_kept, rows, w,
                                           sc_re, sc_im, s)
            : rf_frames_run<float>(fr, wy, wx, tw_re, tw_im, out_re, out_im,
                                   pos, n_kept, rows, w, sc_re, sc_im, s);
}
