// The column engine of kernels 5 and 8: a radix-2 transform of length n
// down the columns of (B, n, W) f32 planes, as a few passes over device
// memory, each running up to six stages in registers.
//
// A pass runs log2(L) consecutive stages s0 .. s0 + log2(L) - 1 of the
// stage sequence of common.cuh's pbmm_radix2 (forward DIF: spans n/2 .. 1;
// inverse DIT: spans 1 .. n/2).  The stages of one pass couple only the
// L rows {base + q st : q < L} of a column, st the pass's smallest span
// (DIF) or its first (DIT), base = (g / st) st L + g % st for the group
// g < n / L.  So one thread holds those L points of one column in
// registers, runs the pass's stages on them with no exchange, and writes
// them back in place; the next pass is the next launch.  Every butterfly
// is pbmm_radix2_stage's, on the same elements, with the same twiddle
// (row s of the _dif_twiddles table at the bottom element's row) and each
// product and sum rounded on its own, so the result is bit for bit the
// one pbmm_radix2 computes in shared memory.
//
// Traffic: a warp holds 32 neighbouring columns, so every load and store
// is one 128-byte row segment of a plane (the row-copy pattern), and a
// thread keeps 2 L loads in flight.  Up to 2^6 = 64 points a pass, a
// transform of n <= 4096 takes two passes over the planes, 8192 three.

#pragma once

#include <cuda_runtime.h>

#define PBMM_CP_LANES 32   // columns a warp holds
#define PBMM_CP_GROUPS 4   // row groups a block holds (4 warps)
#define PBMM_CP_MAXLOG 6   // stages a pass runs in registers (L <= 64)
#define PBMM_CP_MAXPASS 4  // passes of the longest transform (2^13)

// One pass: src (B, hs, w) rows placed at rows [row0, row0 + hs) of the
// length-n column (the rest zero: the zero-embed of kernel 5), dst (B, n,
// w).  src_im null: a real input, whose first stage reads no imaginary
// plane.  Later passes run in place (src == dst, hs == n, row0 == 0).
struct PbmmColPass {
  const float* src_re;
  const float* src_im;
  float* dst_re;
  float* dst_im;
  const float* tw_re;  // (log2 n, n) twiddle rows in execution order
  const float* tw_im;
  int n, w, hs, row0;
  int lst;      // log2 of the pass's stride st
  int s0;       // first stage of the pass
  float scale;  // multiplies the output (1: none)
};

__host__ __device__ constexpr int pbmm_log2(int v) {
  return v <= 1 ? 0 : 1 + pbmm_log2(v >> 1);
}

// STREAM: loads marked evict-first (__ldcs): each element is read once.
template <int L, bool INVERSE, bool REAL, bool EMBED, bool STREAM>
__device__ __forceinline__ void pbmm_col_pass(const PbmmColPass& a) {
  constexpr int K = pbmm_log2(L);
  const int col = blockIdx.x * PBMM_CP_LANES + threadIdx.x;
  const int g = blockIdx.y * PBMM_CP_GROUPS + threadIdx.y;
  if (col >= a.w || g >= (a.n >> K)) return;
  const int st = 1 << a.lst;
  const int base = ((g >> a.lst) << (a.lst + K)) | (g & (st - 1));
  const size_t b = blockIdx.z;
  const float* sr = a.src_re + b * a.hs * a.w + col;
  const float* si = REAL ? nullptr : a.src_im + b * a.hs * a.w + col;
  float xr[L], xi[L];
#pragma unroll
  for (int q = 0; q < L; ++q) {
    const int r = base + q * st - (EMBED ? a.row0 : 0);
    const bool in = !EMBED || (unsigned)r < (unsigned)a.hs;
    xr[q] = in ? (STREAM ? __ldcs(sr + (size_t)r * a.w)
                         : sr[(size_t)r * a.w])
               : 0.0f;
    xi[q] = (REAL || !in) ? 0.0f
                          : (STREAM ? __ldcs(si + (size_t)r * a.w)
                                    : si[(size_t)r * a.w]);
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int dl = INVERSE ? (1 << t) : (L >> (t + 1));  // span / st
    const float* tr_row = a.tw_re + (size_t)(a.s0 + t) * a.n;
    const float* ti_row = a.tw_im + (size_t)(a.s0 + t) * a.n;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (q & dl) continue;
      const int i1 = base + (q + dl) * st;  // the bottom element's row
      const float tr = __ldg(tr_row + i1), ti = __ldg(ti_row + i1);
      const float x_r = xr[q], x_i = xi[q];
      const float u_r = xr[q + dl], u_i = xi[q + dl];
      if (REAL && t == 0) {
        // fft_axis.cu's real first stage: the imaginary plane is zero.
        const float br = __fsub_rn(x_r, u_r);
        xr[q] = __fadd_rn(x_r, u_r);
        xi[q] = 0.0f;
        xr[q + dl] = __fmul_rn(br, tr);
        xi[q + dl] = __fmul_rn(br, ti);
      } else if (!INVERSE) {
        const float br = __fsub_rn(x_r, u_r), bi = __fsub_rn(x_i, u_i);
        xr[q] = __fadd_rn(x_r, u_r);
        xi[q] = __fadd_rn(x_i, u_i);
        xr[q + dl] = __fsub_rn(__fmul_rn(br, tr), __fmul_rn(bi, ti));
        xi[q + dl] = __fadd_rn(__fmul_rn(br, ti), __fmul_rn(bi, tr));
      } else {
        const float zr = __fsub_rn(__fmul_rn(u_r, tr), __fmul_rn(u_i, ti));
        const float zi = __fadd_rn(__fmul_rn(u_r, ti), __fmul_rn(u_i, tr));
        xr[q] = __fadd_rn(x_r, zr);
        xi[q] = __fadd_rn(x_i, zi);
        xr[q + dl] = __fsub_rn(x_r, zr);
        xi[q + dl] = __fsub_rn(x_i, zi);
      }
    }
  }
  float* dr = a.dst_re + b * a.n * a.w + col;
  float* di = a.dst_im + b * a.n * a.w + col;
  const bool scaled = a.scale != 1.0f;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    const size_t o = (size_t)(base + q * st) * a.w;
    dr[o] = scaled ? __fmul_rn(xr[q], a.scale) : xr[q];
    di[o] = scaled ? __fmul_rn(xi[q], a.scale) : xi[q];
  }
}

// The split of log2(n) stages into passes of at most PBMM_CP_MAXLOG, the
// longer passes first (or last, short_first); returns the pass count (0
// if n is not a power of two in [2, 2^(PBMM_CP_MAXLOG * PBMM_CP_MAXPASS)]).
static inline int pbmm_col_plan(int n, bool short_first, int* logs) {
  if (n < 2 || (n & (n - 1)) != 0) return 0;
  const int stages = pbmm_log2(n);
  const int passes = (stages + PBMM_CP_MAXLOG - 1) / PBMM_CP_MAXLOG;
  if (passes > PBMM_CP_MAXPASS) return 0;
  for (int p = 0; p < passes; ++p) {
    const int q = short_first ? passes - 1 - p : p;
    logs[p] = stages / passes + (q < stages % passes ? 1 : 0);
  }
  return passes;
}

// Launches every pass of one transform: first(k, grid, block, a, stream)
// launches pass 0 (which may read a real or embedded input) for the pass
// size 2^k, rest(...) the in-place passes after it (the callers' wrappers
// of pbmm_col_pass with their flags, through PBMM_CP_SWITCH).
template <typename FirstK, typename RestK>
static cudaError_t pbmm_col_launch(PbmmColPass a, int batch, FirstK first,
                                   RestK rest, bool inverse, bool short_first,
                                   float scale, cudaStream_t stream) {
  int logs[PBMM_CP_MAXPASS];
  const int passes = pbmm_col_plan(a.n, short_first, logs);
  if (passes == 0 || batch < 1 || batch > 65535 || a.w < 1)
    return cudaErrorInvalidValue;
  const int stages = pbmm_log2(a.n);
  int s0 = 0;
  for (int p = 0; p < passes; ++p) {
    const int k = logs[p];
    // DIF: the pass's smallest span is n >> (s0 + k); DIT: 1 << s0.
    a.lst = inverse ? s0 : stages - s0 - k;
    a.s0 = s0;
    a.scale = p == passes - 1 ? scale : 1.0f;
    const dim3 grid((a.w + PBMM_CP_LANES - 1) / PBMM_CP_LANES,
                    ((a.n >> k) + PBMM_CP_GROUPS - 1) / PBMM_CP_GROUPS,
                    batch);
    const dim3 block(PBMM_CP_LANES, PBMM_CP_GROUPS);
    cudaError_t err = p == 0 ? first(k, grid, block, a, stream)
                             : rest(k, grid, block, a, stream);
    if (err != cudaSuccess) return err;
    if (p == 0) {
      a.src_re = a.dst_re;
      a.src_im = a.dst_im;
      a.hs = a.n;
      a.row0 = 0;
    }
    s0 += k;
  }
  return cudaSuccess;
}

// Launch of kernel KERNEL<L, flags...> for the pass size 2^k: a switch
// over the six sizes, for the wrappers' first/rest launchers.
#define PBMM_CP_SWITCH(KERNEL, ...)                                       \
  switch (k) {                                                            \
    case 1: KERNEL<2, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
    case 2: KERNEL<4, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
    case 3: KERNEL<8, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
    case 4: KERNEL<16, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
    case 5: KERNEL<32, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
    default: KERNEL<64, __VA_ARGS__><<<grid, block, 0, stream>>>(a); break; \
  }                                                                       \
  return cudaGetLastError();

// ---------------------------------------------------------------------------
// The in-block form (kernel 2): a strip of S neighbouring columns of one
// frame held in shared memory, the column transform run as register passes
// of up to PBMM_RP_KMAX stages that exchange through it, one barrier a
// pass boundary.  A pass couples the L = 2^K points {base + q st} of a
// group (the formula above), and the block's threads take (group, column)
// tasks e = g S + c: a warp spans S columns (S = 4, 8 or 16: 16- to
// 64-byte row segments) and 32 / S neighbouring groups.  The stage sequence, the elements, the
// butterflies (row_pass.cuh's pbmm_rp_stages) and the twiddle words (the
// compact table of radix2.compact_twiddles) are pbmm_radix2's, so the
// result is bit for bit the stage-by-stage one.  A transform may run on
// nseq sequences of 2^NLOG rows stacked down the column (the four-step's
// 128-point factor): sequence k sits at rows k 2^NLOG.
//
// Shared memory holds element (row p, column c) of a plane at
// (pbmm_cb_swz<S>(p) << log2 S) | c.  The swizzle XORs the low B =
// log2(32 / S) bits of p with the XOR of p's higher B-bit digits: linear
// over XOR and a permutation inside each aligned run of 2^B rows, so
// point q of a group lies at the group's word XOR a constant of the code,
// and the 32 / S rows a warp reaches at once (bits 0 .. B - 1 of p where
// st >= 2^B; bits K .. K + B - 1 where st = 1) fall on distinct banks.
// The plans keep every other stride at 2^B or more.
// tests/test_torch_colpass.py checks the plans, the banks and a numpy
// model of the passes bit for bit against the stage-by-stage radix-2.

#include "row_pass.cuh"

#define PBMM_CB_THREADS 512  // a block of the in-block kernels

__host__ __device__ constexpr int pbmm_cb_passes(int nlog) {
  return (nlog + PBMM_RP_KMAX - 1) / PBMM_RP_KMAX;
}

// Stages of pass i of a 2^nlog transform: an even split, the longer first
// (forward and inverse alike).
__host__ __device__ constexpr int pbmm_cb_k(int nlog, int i) {
  return nlog / pbmm_cb_passes(nlog) +
         (i < nlog % pbmm_cb_passes(nlog) ? 1 : 0);
}

__host__ __device__ constexpr int pbmm_cb_s0(int nlog, int i) {
  return i == 0 ? 0 : pbmm_cb_s0(nlog, i - 1) + pbmm_cb_k(nlog, i - 1);
}

template <int S>
__device__ __forceinline__ int pbmm_cb_swz(int p) {
  constexpr int B = 5 - pbmm_log2(S);
  int f = 0;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    unsigned digits = 0;  // bit j of every B-bit digit of p >> B
#pragma unroll
    for (int b = j; b < 16; b += B) digits |= 1u << b;
    f |= (__popc((unsigned)(p >> B) & digits) & 1) << j;
  }
  return p ^ f;
}

template <int S>
__device__ __forceinline__ int pbmm_cb_idx(int p, int c) {
  return (pbmm_cb_swz<S>(p) << pbmm_log2(S)) | c;
}

// Task e of pass PASS of a 2^NLOG transform on strips of S columns.  Reads
// like row_pass.cuh's PbmmRpGroups with one group (J = 1), so
// pbmm_rp_stages runs its butterflies.
template <int NLOG, int S, bool INVERSE, int PASS>
struct PbmmCbGroup {
  static constexpr int K = pbmm_cb_k(NLOG, PASS);
  static constexpr int LST = INVERSE ? pbmm_cb_s0(NLOG, PASS)
                                     : NLOG - pbmm_cb_s0(NLOG, PASS) - K;
  static constexpr int L = 1 << K;
  static constexpr int J = 1;
  static constexpr int ST = 1 << LST;
  static constexpr int LS = pbmm_log2(S);
  int lo[1];
  bool on[1];
  int c;     // column in the strip
  int base;  // row of point 0
  int idx;   // shared-memory word of point 0
  __device__ __forceinline__ explicit PbmmCbGroup(int e) {
    c = e & (S - 1);
    const int g = e >> LS;
    const int gl = g & ((1 << (NLOG - K)) - 1);
    lo[0] = gl & (ST - 1);
    base = ((g >> (NLOG - K)) << NLOG) | ((gl >> LST) << (LST + K)) | lo[0];
    on[0] = true;
    idx = pbmm_cb_idx<S>(base, c);
  }
  __device__ __forceinline__ int pos(int q) const { return base + q * ST; }
  __device__ __forceinline__ int at(int q) const {
    return idx ^ (pbmm_cb_swz<S>(q << LST) << LS);
  }
};

template <class G>
__device__ __forceinline__ void pbmm_cb_read(const G& gr,
                                             float (&xr)[PBMM_RP_P],
                                             float (&xi)[PBMM_RP_P],
                                             const float* sre,
                                             const float* sim) {
#pragma unroll
  for (int q = 0; q < G::L; ++q) {
    xr[q] = sre[gr.at(q)];
    xi[q] = sim[gr.at(q)];
  }
}

template <class G>
__device__ __forceinline__ void pbmm_cb_write(const G& gr,
                                              const float (&xr)[PBMM_RP_P],
                                              const float (&xi)[PBMM_RP_P],
                                              float* sre, float* sim) {
#pragma unroll
  for (int q = 0; q < G::L; ++q) {
    sre[gr.at(q)] = xr[q];
    sim[gr.at(q)] = xi[q];
  }
}

// Passes PASS .. of a 2^NLOG transform of nseq sequences on the block's
// strip.  Pass 0 takes its points from first(gr, xr, xi) and the last
// pass hands them to last(gr, xr, xi); the passes between read and write
// the strip (sre, sim) in place, after a barrier.  Every thread of the
// block calls it; it ends without a barrier.
template <int NLOG, int S, bool INVERSE, int PASS = 0, class First,
          class Last>
__device__ __forceinline__ void pbmm_cb_transform(
    int nseq, float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, First&& first, Last&& last) {
  constexpr int NP = pbmm_cb_passes(NLOG);
  using G = PbmmCbGroup<NLOG, S, INVERSE, PASS>;
  const int tasks = (nseq << (NLOG - G::K)) * S;
  for (int e = threadIdx.x; e < tasks; e += blockDim.x) {
    const G gr(e);
    float xr[PBMM_RP_P], xi[PBMM_RP_P];
    if constexpr (PASS == 0)
      first(gr, xr, xi);
    else
      pbmm_cb_read(gr, xr, xi, sre, sim);
    pbmm_rp_stages<G, INVERSE>(gr, xr, xi, tw_re, tw_im);
    if constexpr (PASS == NP - 1)
      last(gr, xr, xi);
    else
      pbmm_cb_write(gr, xr, xi, sre, sim);
  }
  if constexpr (PASS + 1 < NP) {
    __syncthreads();
    pbmm_cb_transform<NLOG, S, INVERSE, PASS + 1>(nseq, sre, sim, tw_re,
                                                  tw_im, first, last);
  }
}
