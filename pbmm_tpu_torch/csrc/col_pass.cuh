// The column engine of kernels 5 and 8, and the bracket of every engine:
// a radix-2 transform of length n as a few passes over device memory,
// each running up to six stages in registers.
//
// A pass runs log2(L) consecutive stages s0 .. s0 + log2(L) - 1 of the
// stage sequence of common.cuh's pbmm_radix2 (forward DIF: spans n/2 .. 1;
// inverse DIT: spans 1 .. n/2).  The stages of one pass couple only the
// L points {base + q st : q < L} of a sequence, st the pass's smallest
// span (DIF) or its first (DIT), base = (g / st) st L + g % st for the
// group g < n / L (pbmm_cp_base).  So one thread holds those L points in
// registers, runs the pass's stages on them with no exchange
// (pbmm_cp_stages), and writes them back in place; the next pass is the
// next launch.  Every butterfly is pbmm_radix2_stage's, on the same
// elements, with the same twiddle and each product and sum rounded on its
// own, so the result is bit for bit the one pbmm_radix2 computes in shared
// memory.  The twiddle of a butterfly whose bottom element sits at i1 is
// row s of the _dif_twiddles table at column i1 (kernels 5 and 8), or
// word d - 1 + (i1 mod d) of the compact table
// (spectral/radix2.py::compact_twiddles; COMPACT), d the span: it depends
// on the span and on i1 mod d only.
//
// Columns of (B, n, W) f32 planes (pbmm_col_pass): a warp holds 32
// neighbouring columns, so every load and store is one 128-byte row
// segment of a plane (the row-copy pattern), and a thread keeps 2 L loads
// in flight.  Up to 2^6 = 64 points a pass, a transform of n <= 4096
// takes two passes over the planes, 8192 three, 16384 to 2^18 three or
// more; the groups past the grid's 65535 row tiles go in further
// launches (pbmm_col_tiles).
//
// The bracket.  The block engines (row_pass.cuh's rows, the in-block
// column strips below) hold at most PBMM_BK_N = 8192 points of one
// sequence (a row of 16384 lanes fits one 1024-thread block of the row
// engine; longer rows take the bracket).  The stages of span d <
// PBMM_BK_N couple only points inside one contiguous block of PBMM_BK_N,
// and their compact twiddle words are the first PBMM_BK_N - 1 words of
// n's table, the table of PBMM_BK_N.  So a transform of n > PBMM_BK_N runs
// as its log2(n / PBMM_BK_N) outer stages (spans PBMM_BK_N and up) as
// passes of this engine through device memory (pbmm_bracket_plan), and
// each contiguous block of PBMM_BK_N points as an independent transform
// of that length in the existing engine.  The forward (DIF) runs the
// bracket first, the inverse (DIT) last.  After the forward bracket,
// block h of the sequence holds the points whose bit-reversed index ends
// in h's bits: output position p = h PBMM_BK_N + p' is the block's own
// bit-reversed output p' placed at the block, so the kernels'
// per-position tables (kept tiles, frequencies, the Hermitian plan) carry
// over by global position.  Rows (kernels 1, 4, 7, 8) run the passes in
// kernels of their own, thread (row, group): neighbouring threads take
// neighbouring groups, the next point of a row.  Columns (kernels 2, 6,
// 12) run pbmm_bracket_cols.  tests/test_torch_bracket.py holds a numpy
// model of the split bit for bit against the stage-by-stage transform.

#pragma once

#include <cuda_runtime.h>

#include "row_pass.cuh"

#define PBMM_CP_LANES 32   // columns a warp holds
#define PBMM_CP_GROUPS 4   // row groups a block holds (4 warps)
#define PBMM_CP_MAXLOG 6   // stages a pass runs in registers (L <= 64)
#define PBMM_CP_MAXPASS 6  // passes of the longest transform (2^36)
#define PBMM_BK_LOG 13
#define PBMM_BK_N PBMM_RP_MAXN  // the longest sequence an engine holds
#define PBMM_BK_THREADS 256     // a block of the row bracket kernels
static_assert(PBMM_BK_N == 1 << PBMM_BK_LOG, "the bracket's block");

// One pass over (B, n, w) column planes: src rows [0, hs) at rows [row0,
// row0 + hs) of the length-n column (EMBED: the rest zero, the zero-embed
// of kernel 5), or (WINDOW) dst rows [0, hs) from rows [row0, row0 + hs)
// of the column; else src and dst both (B, n, w).  src_im null: a real
// input, whose first stage reads no imaginary plane.  Frame strides ss
// and ds (floats).
struct PbmmColPass {
  const float* src_re;
  const float* src_im;
  float* dst_re;
  float* dst_im;
  const float* tw_re;  // (log2 n, n) twiddle rows in execution order, or
  const float* tw_im;  // compact_twiddles(n, inverse) (COMPACT)
  int n, w, hs, row0;
  int lst;      // log2 of the pass's stride st
  int s0;       // first stage of the pass
  float scale;  // multiplies the output (1: none)
  int g0;       // the launch's first group (groups past 65535 row tiles)
  size_t ss, ds;
};

__host__ __device__ constexpr int pbmm_log2(int v) {
  return v <= 1 ? 0 : 1 + pbmm_log2(v >> 1);
}

// Group g of a pass of 2^K points at stride 2^lst: its point 0.
template <int K>
__device__ __forceinline__ int pbmm_cp_base(int g, int lst) {
  return ((g >> lst) << (lst + K)) | (g & ((1 << lst) - 1));
}

// The pass's K = log2(L) stages (s0 ..) on the group's L points in
// registers, point 0 at base.  REAL: the input's imaginary part is zero
// and the first stage reads none of it (fft_axis.cu's real first stage).
template <int L, bool INVERSE, bool REAL, bool COMPACT>
__device__ __forceinline__ void pbmm_cp_stages(
    int base, int lst, int s0, int n, float (&xr)[L], float (&xi)[L],
    const float* __restrict__ tw_re, const float* __restrict__ tw_im) {
  constexpr int K = pbmm_log2(L);
  const int st = 1 << lst;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int dl = INVERSE ? (1 << t) : (L >> (t + 1));  // span / st
    const int d = dl * st;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (q & dl) continue;
      const int i1 = base + (q + dl) * st;  // the bottom element
      const size_t wd = COMPACT ? (size_t)(d - 1 + (i1 & (d - 1)))
                                : (size_t)(s0 + t) * n + i1;
      const float tr = __ldg(tw_re + wd), ti = __ldg(tw_im + wd);
      const float x_r = xr[q], x_i = xi[q];
      const float u_r = xr[q + dl], u_i = xi[q + dl];
      if (REAL && t == 0) {
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
}

// STREAM: loads marked evict-first (__ldcs): each element is read once.
template <int L, bool INVERSE, bool REAL, bool EMBED, bool STREAM,
          bool COMPACT = false, bool WINDOW = false>
__device__ __forceinline__ void pbmm_col_pass(const PbmmColPass& a) {
  constexpr int K = pbmm_log2(L);
  const int col = blockIdx.x * PBMM_CP_LANES + threadIdx.x;
  const int g = a.g0 + blockIdx.y * PBMM_CP_GROUPS + threadIdx.y;
  if (col >= a.w || g >= (a.n >> K)) return;
  const int st = 1 << a.lst;
  const int base = pbmm_cp_base<K>(g, a.lst);
  const size_t b = blockIdx.z;
  const float* sr = a.src_re + b * a.ss + col;
  const float* si = REAL ? nullptr : a.src_im + b * a.ss + col;
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
  pbmm_cp_stages<L, INVERSE, REAL, COMPACT>(base, a.lst, a.s0, a.n, xr, xi,
                                            a.tw_re, a.tw_im);
  float* dr = a.dst_re + b * a.ds + col;
  float* di = a.dst_im + b * a.ds + col;
  const bool scaled = a.scale != 1.0f;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    const int r = base + q * st - (WINDOW ? a.row0 : 0);
    if (WINDOW && (unsigned)r >= (unsigned)a.hs) continue;
    const size_t o = (size_t)r * a.w;
    dr[o] = scaled ? __fmul_rn(xr[q], a.scale) : xr[q];
    di[o] = scaled ? __fmul_rn(xi[q], a.scale) : xi[q];
  }
}

// One pass of a plan: k stages from s0, stride 2^lst.
struct PbmmCpPass {
  int k, lst, s0;
};

// The passes of stages [sb, se) of a radix-2 transform of length n: an
// even split into passes of at most PBMM_CP_MAXLOG, the longer first (or
// last, short_first); DIF: a pass's stride is its smallest span, n >> (s0
// + k); DIT: its first, 1 << s0.  Returns the pass count (0 if n is not a
// power of two from 2, or the range is empty).
static inline int pbmm_col_plan(int n, int sb, int se, bool inverse,
                                bool short_first, PbmmCpPass* p) {
  if (n < 2 || (n & (n - 1)) != 0 || se <= sb) return 0;
  const int stages = pbmm_log2(n), count = se - sb;
  const int passes = (count + PBMM_CP_MAXLOG - 1) / PBMM_CP_MAXLOG;
  if (passes > PBMM_CP_MAXPASS) return 0;
  int s0 = sb;
  for (int i = 0; i < passes; ++i) {
    const int q = short_first ? passes - 1 - i : i;
    const int k = count / passes + (q < count % passes ? 1 : 0);
    p[i] = {k, inverse ? s0 : stages - s0 - k, s0};
    s0 += k;
  }
  return passes;
}

// The bracket of a transform of length n (spectral/fused.py::bracket_plan
// models it): its outer stages, the first log2(n) - 13 of the forward, the
// last of the inverse; 0 where n needs none (n <= PBMM_BK_N).
static inline int pbmm_bracket_plan(int n, bool inverse, PbmmCpPass* p) {
  if (n <= PBMM_BK_N) return 0;
  const int stages = pbmm_log2(n);
  return inverse ? pbmm_col_plan(n, PBMM_BK_LOG, stages, true, false, p)
                 : pbmm_col_plan(n, 0, stages - PBMM_BK_LOG, false, false, p);
}

// Launches every pass of a bracket: launch(pass, first, last), first /
// last marking the passes that read the kernel's input and write its
// output (the callers' switch over the pass size, PBMM_CP_SWITCH).
template <class Launch>
static cudaError_t pbmm_bracket_launch(int n, bool inverse,
                                       Launch&& launch) {
  PbmmCpPass p[PBMM_CP_MAXPASS];
  const int np = pbmm_bracket_plan(n, inverse, p);
  if (np <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < np; ++i) {
    const cudaError_t err = launch(p[i], i == 0, i == np - 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One column pass of 2^k points on `batch` frames: launch(grid, block, a)
// starts it on up to 65535 row tiles of PBMM_CP_GROUPS groups, the tiles
// past them in further launches (a.g0).
template <class Launch>
static cudaError_t pbmm_col_tiles(PbmmColPass a, int batch, int k,
                                  Launch&& launch) {
  const int tiles = ((a.n >> k) + PBMM_CP_GROUPS - 1) / PBMM_CP_GROUPS;
  for (int t0 = 0; t0 < tiles; t0 += 65535) {
    a.g0 = t0 * PBMM_CP_GROUPS;
    const dim3 grid((a.w + PBMM_CP_LANES - 1) / PBMM_CP_LANES,
                    tiles - t0 < 65535 ? tiles - t0 : 65535, batch);
    const dim3 block(PBMM_CP_LANES, PBMM_CP_GROUPS);
    const cudaError_t err = launch(grid, block, a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches every pass of one column transform: first(k, grid, block, a,
// stream) launches pass 0 (which may read a real or embedded input) for
// the pass size 2^k, rest(...) the in-place passes after it (the callers'
// wrappers of pbmm_col_pass with their flags, through PBMM_CP_SWITCH).
template <typename FirstK, typename RestK>
static cudaError_t pbmm_col_launch(PbmmColPass a, int batch, FirstK first,
                                   RestK rest, bool inverse, bool short_first,
                                   float scale, cudaStream_t stream) {
  PbmmCpPass p[PBMM_CP_MAXPASS];
  const int passes =
      pbmm_col_plan(a.n, 0, pbmm_log2(a.n), inverse, short_first, p);
  if (passes == 0 || batch < 1 || batch > 65535 || a.w < 1)
    return cudaErrorInvalidValue;
  a.ss = (size_t)a.hs * a.w;
  a.ds = (size_t)a.n * a.w;
  for (int i = 0; i < passes; ++i) {
    const int k = p[i].k;
    a.lst = p[i].lst;
    a.s0 = p[i].s0;
    a.scale = i == passes - 1 ? scale : 1.0f;
    const cudaError_t err = pbmm_col_tiles(
        a, batch, k,
        [&](dim3 grid, dim3 block, const PbmmColPass& x) -> cudaError_t {
          return i == 0 ? first(k, grid, block, x, stream)
                        : rest(k, grid, block, x, stream);
        });
    if (err != cudaSuccess) return err;
    if (i == 0) {
      a.src_re = a.dst_re;
      a.src_im = a.dst_im;
      a.hs = a.n;
      a.row0 = 0;
      a.ss = a.ds;
    }
  }
  return cudaSuccess;
}

// LAUNCH(L) for the pass size 2^k (k in 1 .. PBMM_CP_MAXLOG): the switch
// of the callers' launchers, each with its own LAUNCH macro.
#define PBMM_CP_SWITCH(k, LAUNCH) \
  switch (k) {                    \
    case 1: LAUNCH(2); break;     \
    case 2: LAUNCH(4); break;     \
    case 3: LAUNCH(8); break;     \
    case 4: LAUNCH(16); break;    \
    case 5: LAUNCH(32); break;    \
    default: LAUNCH(64); break;   \
  }

// A pass of a column bracket (pbmm_bracket_cols).
template <int L, bool INVERSE, bool EMBED, bool WINDOW>
static __global__ void __launch_bounds__(PBMM_CP_LANES * PBMM_CP_GROUPS)
    pbmm_bracket_cols_kernel(PbmmColPass a) {
  pbmm_col_pass<L, INVERSE, false, EMBED, true, true, WINDOW>(a);
}

// Every pass of the bracket of a length-n column transform down `batch`
// (n, w) frames (kernels 2, 6 and 12 around their in-block strips; a.tw:
// compact_twiddles(n, inverse)).  Forward: src (batch, hs, w) at frame
// stride ss, embedded at row0 -> dst (batch, n, w) at frame stride ds, in
// the bracket's order.  Inverse: src (batch, n, w), which the passes
// before the last overwrite in place, -> rows [row0, row0 + hs) into dst.
static cudaError_t pbmm_bracket_cols(const PbmmColPass& a, int batch,
                                     bool inverse, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || a.w < 1) return cudaErrorInvalidValue;
  return pbmm_bracket_launch(
      a.n, inverse,
      [&](const PbmmCpPass& p, bool first, bool last) -> cudaError_t {
        PbmmColPass x = a;
        x.lst = p.lst;
        x.s0 = p.s0;
        x.scale = 1.0f;
        // Forward: the first pass embeds, the later ones run in place on
        // dst.  Inverse: every pass but the last runs in place on src.
        if (!inverse && !first) {
          x.src_re = a.dst_re;
          x.src_im = a.dst_im;
          x.ss = a.ds;
        }
        if (inverse && !last) {
          x.dst_re = const_cast<float*>(a.src_re);
          x.dst_im = const_cast<float*>(a.src_im);
          x.ds = a.ss;
        }
        const bool embed = !inverse && first, window = inverse && last;
        return pbmm_col_tiles(
            x, batch, p.k,
            [&](dim3 grid, dim3 block, const PbmmColPass& y) -> cudaError_t {
#define BKC_LAUNCH(L) \
  pbmm_bracket_cols_kernel<L, INV, EMB, WIN><<<grid, block, 0, stream>>>(y)
#define BKC_CASE(INV_, EMB_, WIN_)                                 \
  if (inverse == INV_ && embed == EMB_ && window == WIN_) {        \
    constexpr bool INV = INV_, EMB = EMB_, WIN = WIN_;             \
    PBMM_CP_SWITCH(p.k, BKC_LAUNCH)                                \
    return cudaGetLastError();                                     \
  }
              BKC_CASE(false, true, false)
              BKC_CASE(false, false, false)
              BKC_CASE(true, false, true)
              BKC_CASE(true, false, false)
#undef BKC_CASE
#undef BKC_LAUNCH
              return cudaErrorInvalidValue;
            });
      });
}

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
// The plans keep every other stride at 2^B or more; so do the range plans
// of kernel 12 ([0, 7), [7, log2 n): their later passes start at stage 4
// or more, strides of 16 and up, and B <= 4 on strips of 2 and more).
// tests/test_torch_colpass.py checks the plans, the banks and a numpy
// model of the passes bit for bit against the stage-by-stage radix-2.

#define PBMM_CB_THREADS 512  // a block of the in-block kernels

// The passes of stages [sb, se) of a transform (the whole 2^nlog one: [0,
// nlog)).
__host__ __device__ constexpr int pbmm_cb_passes(int sb, int se) {
  return (se - sb + PBMM_RP_KMAX - 1) / PBMM_RP_KMAX;
}

// Stages of pass i of the range [sb, se): an even split, the longer first
// (forward and inverse alike).
__host__ __device__ constexpr int pbmm_cb_k(int sb, int se, int i) {
  return (se - sb) / pbmm_cb_passes(sb, se) +
         (i < (se - sb) % pbmm_cb_passes(sb, se) ? 1 : 0);
}

__host__ __device__ constexpr int pbmm_cb_s0(int sb, int se, int i) {
  return i == 0 ? sb : pbmm_cb_s0(sb, se, i - 1) + pbmm_cb_k(sb, se, i - 1);
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

// Task e of pass PASS of the stages [SB, SE) of a 2^NLOG transform on
// strips of S columns.  Reads like row_pass.cuh's PbmmRpGroups with one
// group (J = 1), so pbmm_rp_stages runs its butterflies.
template <int NLOG, int S, bool INVERSE, int PASS, int SB = 0, int SE = NLOG>
struct PbmmCbGroup {
  static constexpr int K = pbmm_cb_k(SB, SE, PASS);
  static constexpr int LST = INVERSE ? pbmm_cb_s0(SB, SE, PASS)
                                     : NLOG - pbmm_cb_s0(SB, SE, PASS) - K;
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

// Passes PASS .. of the stages [SB, SE) of a 2^NLOG transform (all of
// them by default) of nseq sequences on the block's strip.  Pass 0 takes
// its points from first(gr, xr, xi) and the last pass hands them to
// last(gr, xr, xi); the passes between read and write the strip (sre, sim)
// in place, after a barrier.  Every thread of the block calls it; it ends
// without a barrier.  A range is a partial transform: stage s is the
// stage-by-stage transform's stage s, so kernel 12 runs pieces of the
// inverse on the same passes.
template <int NLOG, int S, bool INVERSE, int SB = 0, int SE = NLOG,
          int PASS = 0, class First, class Last>
__device__ __forceinline__ void pbmm_cb_transform(
    int nseq, float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, First&& first, Last&& last) {
  static_assert(0 <= SB && SB < SE && SE <= NLOG, "a stage range");
  constexpr int NP = pbmm_cb_passes(SB, SE);
  using G = PbmmCbGroup<NLOG, S, INVERSE, PASS, SB, SE>;
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
    pbmm_cb_transform<NLOG, S, INVERSE, SB, SE, PASS + 1>(
        nseq, sre, sim, tw_re, tw_im, first, last);
  }
}
