// Kernel 2: column FFT + band/phase pass + column IFFT for a whole chunk.
//
// Replaces pbmm_tpu/spectral/fused.py:1310 colspec_chunk (the Pallas
// kernel launched at :1518), every branch of it:
//   POW2     column heights that are powers of two (square_pow2 and
//            rect_pow2 padding): a radix-2 DIF over the whole column
//            (bit-reversed rows out, fused.py:1454-1457) and the DIT
//            inverse back to natural rows, unnormalised (:1482-1484);
//            else tight heights H = m * 128 through the four-step split
//            (fused.py:471 _fourstep_col);
//   GENERAL  every phase branch of fused.py:865 _phase_block: the
//            standard mode's host w plane and gate (:651, :899-914),
//            steerable sector windows (:725 _sector_weights), per-bin
//            masks where the bands overlap (:707 _eval_mask), and the
//            atan2 + sin/cos rotation of a non-integer scale
//            (:1003-1007); else the main path's branch: host
//            (total, m_amp) planes and the integer power by
//            square-and-multiply (:986-1002), compiled on its own;
//   IIR      the streaming band-pass taps lp_fast/lp_slow, two more
//            carried planes (fused.py:766 _iir_filter_delta).
// The planes of chroma="rgb" are separate frame series, each with its own
// prev spectrum and taps; the rows of the chunk are plane-minor,
// frame-major ([Y0 I0 Q0 Y1 ...]).
//
// Layout contract (identical to the JAX kernel so spectra and carried
// state compare element by element): at pow-2 heights row p holds
// frequency rev(p); at tight heights the forward transform takes natural
// rows to the "fourstep" layout, where row p = 128 k1 + k2 holds
// frequency k1 + m k2.  Inside the block the four-step's 128-point
// factor runs as radix-2 DIF, so the block's own row order is
// 128 k1 + q <-> frequency k1 + m rev7(q); the state, the planes and the
// frequency axis are read and written through that permutation
// (cs_row), and the DIT inverse undoes it.
//
// Design.  A frame's phase pass reads the unmodified forward spectrum of
// the frame before it (fused.py:1314-1324 carries it in VMEM only because
// the TPU grid runs in order), so once the forward spectra exist the
// frames are independent but for the IIR taps, whose recurrence is per
// bin.  Outside the IIR branch, two launches:
//   1. the forward column transform of every frame of every plane into a
//      scratch tensor the wrapper allocates, in the state's layout
//      (cs_fwd_*: one block a strip of S columns of one frame);
//   2. the phase pass of every frame against the scratch spectrum of the
//      frame before it (the carried state for the first), then the column
//      IFFT, rows [r0, r1) out (cs_inv_kernel: one block a strip and a
//      frame).
// The last frame's spectrum leaves as new_prev (a device copy).  With the
// IIR taps, three:
//   1. launch 1 as above;
//   2. the tap scan (cs_iir_scan_kernel): one thread a bin of one plane
//      walks the T frames in order with the previous frame's spectrum and
//      the two taps in registers, runs pbmm_phase_bin<true, true> (the
//      bin's whole phase pass) once a frame and writes the rotated bin
//      over its scratch slot; the unmodified value stays in registers as
//      the next frame's prev, and new_prev and the taps leave at the end.
//      Neighbouring threads take neighbouring kept columns, so every load
//      and store is a row segment of a plane;
//   3. launch 2's inverse on the rotated spectra, the phase pass compiled
//      out (CS_PH_NONE).
// Each block of launches 1 and 2 holds its strip in shared memory (512
// threads, one block an SM; 256 above m = 32) and runs the transform as
// col_pass.cuh's in-block register passes (up to four stages a pass, one
// barrier a pass boundary, addresses constant offsets of one base a
// group).  The strip is the widest power of two up to 16 columns whose
// 2 H S floats fit the 227 KB a block may have (cs_strip): 16 to H = 1024
// (pow-2) or m = 14 (144 KB at 1080p's 1152 rows), 8 to 2048 or m = 28, 4
// to 4096 or m = 32, 2 above (to 8192, 128 KB; row segments of 8 bytes).
// Launch 1 brings the zero-embedded strip in by asynchronous copies of up
// to 16 bytes, all in flight at once, then transforms it; launch 3 brings
// the rotated spectrum's strip in by the same loader (cs_load_strip, the
// state's row map); launch 2's phase pass brings cur and prev (and the
// main branch's host planes) in by asynchronous 16-byte copies a few words
// ahead of its arithmetic on strips of 4 and more (phase_inv.cuh), prev
// and the planes through a ring past the strip where the block has room
// (pbmm_ps_smem), element by element on strips of 2 and on the general
// pass.  At tight heights a thread holds its column's m points
// {n2 + 128 n1} for the m-point DFT, applies the four-step twiddle, and
// the 128-point factor runs as passes of 4 + 3 stages; the inverse
// mirrors it.  The combine matrix is a kernel parameter up to m = 32
// (CsCombine: with both loops unrolled each weight is an FMA operand);
// above, its 2 m^2 floats pass the 32 764-byte parameter limit, so the
// kernel reads it from device memory (CsCombineDev: every thread of a warp
// reads the same word), runs
// the outer loop of the m-point DFT rolled and 256 threads a block, so a
// thread may keep its 2 m points in up to 255 registers.  The pow-2
// passes run kernel 5's butterflies (the forward, kernel 5 bit for bit),
// and launch 2's pow-2 phase pass and inverse are phase_inv.cuh's device
// functions, which kernel 6 runs too (kernel 6 bit for bit on kernel 5's
// spectra).  A frame's forward transform is one code path whichever chunk
// it falls in, and the tap scan walks a chunk's frames in the order the
// state threads them, so two chunks equal one.
// The four-step combine sums in plain C++ (nvcc may contract it to FMA),
// held to the plain version at 1e-4 of the spectrum's magnitude.  On an
// NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py) a 1080p tight
// chunk (16 frames, 1152 x 1152 kept) takes 0.847 ms against 2.674 for
// the frame-serial design (strips of 4 columns, a barrier a stage); the
// IIR branch's times, against the frame-serial kernel it replaced (6.006
// ms for (b)'s rgb chunk), are in PERF.md.
//
// Above 8192 rows (16384 at 16K square_pow2, 8704 = 68 x 128 at 16K
// tight) a column no longer fits a block's strip, so:
//   pow-2 heights run col_pass.cuh's bracket around the two launches: the
//     forward bracket (the zero embed of the content rows and the stages of
//     span >= 8192) into the scratch, launch 1 on every 8192-row block of
//     it in place, launch 2 (or the tap scan and launch 3) on every block
//     with its rows' planes and frequencies (one launch a block, the
//     spectra at the column's frame stride) into a second scratch, and the
//     inverse bracket writing rows [r0, r1);
//   tight heights above m = 64 run the m-point combine as a pass of its own
//     through device memory (cs_combine_kernel: per column and n2 the m
//     points staged in shared memory, the combine matrix from device
//     memory, the four-step twiddle applied on the spectrum's side), and
//     the 128-point factor on chunks of up to 32 blocks of 128 rows
//     (cs_fwd_blocks_kernel, cs_inv_blocks_kernel: strips of 4); any m,
//     prime or not.
// The state, the scratch and the planes keep the whole column's layout,
// so the carried spectrum is the one the in-block heights give.
//
// What bounds it on an H100: per frame it reads the Hc content rows and
// writes r1 - r0 output rows (re and im), and the state in and out; the
// scratch spectra add one write and two reads (IIR: one write, two reads
// and one more write) of H x Wk x 8 bytes a frame, against ~H (m + 7)
// complex FMAs a column (tight) or 5 H log2(H) flops (pow-2) plus the
// phase chain: bytes.  Times at each branch, on an NVIDIA H100 80GB HBM3
// at its 700 W limit, are in PERF.md (chip_smoke.py).

#include <cuda_pipeline.h>

#include <type_traits>

#include "col_pass.cuh"
#include "common.cuh"
#include "phase_inv.cuh"

#define CS_MAXM_PARAM 32    // largest m whose combine is a kernel parameter
#define CS_MAXM 64          // m of the in-register tiers (m = 64 is 8192 rows)
#define CS_SCAN_THREADS 256  // a block of the IIR tap scan
#define CS_CHUNK_M 32       // 128-row blocks a chunk kernel holds (m > 64)
#define CS_CHUNK_S 4        // its strip

// Pointers and sizes of one launch (device pointers; null where a branch
// does not read them).
struct ColspecIO {
  const float* rows_re;
  const float* rows_im;
  const float* prev_re;
  const float* prev_im;
  const float* lpf_in;
  const float* lps_in;
  const float* plane0;  // total (pyramid) or w (standard), (H, Wk)
  const float* plane1;  // m_amp (pyramid)
  const float* fy;      // column frequency per JAX row, (H,)
  const float* fx;      // lane frequency, (Wk,)
  const float* fs_re;   // four-step twiddle, (H,)
  const float* fs_im;
  const float* cwd_re;  // the m x m combine matrix on the device (m > 32)
  const float* cwd_im;
  const float* tw_fre;  // compact_twiddles(n), n = 128 (tight) or H
  const float* tw_fim;
  const float* tw_ire;
  const float* tw_iim;
  float* spec_re;  // scratch: every frame's forward spectrum, (T C, H, Wk)
  float* spec_im;
  float* out_re;
  float* out_im;
  float* np_re;
  float* np_im;
  float* lpf_out;
  float* lps_out;
  int t, c, hc, h, wk, row0, r0, r1;
  size_t fs;  // frame stride of the spectra and prev (floats; H Wk)
  size_t os;  // frame stride of the output ((r1 - r0) Wk)
};

// The four-step combine matrix W_m^{-k1 n1} (fused.py:_combine_matrix).
// Up to m = CS_MAXM_PARAM by value, row k1 at k1 * M: kernel parameters
// live in the constant bank, and with both loops of the m-point DFT
// unrolled every weight is an operand of the FMAs it feeds, not a load.
template <int M>
struct CsCombine {
  float re[M * M];
  float im[M * M];
  __device__ __forceinline__ float wr(int k, int n) const {
    return re[k * M + n];
  }
  __device__ __forceinline__ float wi(int k, int n) const {
    return im[k * M + n];
  }
};

// Above, the matrix in device memory, row k1 at k1 * m: the weight a loop
// step reads is the same word for every thread (one L1 broadcast).
struct CsCombineDev {
  const float* re;
  const float* im;
  int m;
  __device__ __forceinline__ float wr(int k, int n) const {
    return __ldg(re + k * m + n);
  }
  __device__ __forceinline__ float wi(int k, int n) const {
    return __ldg(im + k * m + n);
  }
};

template <int MAXM>
using CsCombineOf =
    std::conditional_t<(MAXM > CS_MAXM_PARAM), CsCombineDev,
                       CsCombine<(MAXM > 0 ? MAXM : 1)>>;

// The combine of a launch at m <= MAXM: the host matrices (re, im) copied
// into the by-value form, or the device matrices (dre, dim).
template <int MAXM>
static CsCombineOf<MAXM> cs_combine(const float* re, const float* im,
                                    const float* dre, const float* dim,
                                    int m) {
  if constexpr (MAXM > CS_MAXM_PARAM) {
    return CsCombineDev{dre, dim, m};
  } else {
    constexpr int M = MAXM > 0 ? MAXM : 1;
    CsCombine<M> w = {};
    if (re != nullptr && m <= M) {
      for (int k1 = 0; k1 < m; ++k1)
        for (int n1 = 0; n1 < m; ++n1) {
          w.re[k1 * M + n1] = re[k1 * m + n1];
          w.im[k1 * M + n1] = im[k1 * m + n1];
        }
    }
    return w;
  }
}

// Threads a block of the in-block kernels: 512, or 256 where a thread
// holds more than 2 CS_MAXM_PARAM points of its column (up to 255
// registers a thread).
__host__ __device__ constexpr int cs_threads(int maxm) {
  return maxm > CS_MAXM_PARAM ? 256 : PBMM_CB_THREADS;
}

// The m-point loop over k (< m) that writes an output a step: unrolled
// with every weight a parameter operand up to CS_MAXM_PARAM, rolled above
// (the weights are loads then, and 64 unrolled steps of 64 points would
// only grow the code).
template <int MAXM, class Step>
__device__ __forceinline__ void cs_mpoint_loop(int m, Step&& step) {
  if constexpr (MAXM > CS_MAXM_PARAM) {
    for (int k = 0; k < m; ++k) step(k);
  } else {
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      if (k >= m) break;
      step(k);
    }
  }
}

// One frame's strip into the strip's shared memory: strip row p of the S
// columns from the source row r that row(p, r) sets (a segment of S floats
// at src + r wk), zero where row(p, r) is false, by asynchronous copies of
// min(S, 4) floats (16 bytes, 8 on strips of 2), every copy of the block in
// flight at once.  Launch 1 maps the content window [row0, row0 + hc)
// (CsWindow), launch 3 the state's row layout (cs_row).  The map returns
// whether the row is in, not a sentinel row: launch 1 then compiles to the
// code of the window written inline (with a sentinel's select, launch 1 at
// m = 17 ran 2 % slower on an NVIDIA H100).  Ends synchronised.
template <int S, class RowOf>
__device__ __forceinline__ void cs_load_strip(
    const float* __restrict__ src_re, const float* __restrict__ src_im,
    size_t wk, int h, float* sre, float* sim, RowOf row) {
  constexpr int R = S < 4 ? S : 4;  // floats a copy moves
  constexpr int Q = S / R;          // copies a row
  for (int i = threadIdx.x; i < h * Q; i += blockDim.x) {
    const int p = i / Q, j = i % Q;
    const int w = pbmm_cb_idx<S>(p, R * j);
    int r;
    if (row(p, r)) {
      const size_t o = (size_t)r * wk + R * j;
      __pipeline_memcpy_async(sre + w, src_re + o, 4 * R);
      __pipeline_memcpy_async(sim + w, src_im + o, 4 * R);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        sre[w + k] = 0.0f;
        sim[w + k] = 0.0f;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Launch 1's row map: the zero-embedded content rows [row0, row0 + hc).
struct CsWindow {
  int row0, hc;
  __device__ __forceinline__ bool operator()(int p, int& r) const {
    r = p - row0;
    return (unsigned)r < (unsigned)hc;
  }
};

// Launch 1 at a pow-2 height 2^NLOG: the zero-embedded strip, then the
// radix-2 DIF passes (kernel 5's butterflies), bit-reversed rows out to
// the scratch.
template <int NLOG, int S>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    cs_fwd_pow2_kernel(ColspecIO io) {
  extern __shared__ float smem[];
  constexpr int N = 1 << NLOG;
  float* sre = smem;
  float* sim = smem + N * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  const size_t n = blockIdx.y;
  cs_load_strip<S>(io.rows_re + n * io.hc * wk + col0,
                   io.rows_im + n * io.hc * wk + col0, wk, N, sre, sim,
                   CsWindow{io.row0, io.hc});
  float* dre = io.spec_re + n * N * wk + col0;
  float* dim = io.spec_im + n * N * wk + col0;
  auto first = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                   float (&xi)[PBMM_RP_P]) {
    pbmm_cb_read(gr, xr, xi, sre, sim);
  };
  auto last = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                  const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      const size_t o = (size_t)gr.pos(q) * wk + gr.c;
      dre[o] = xr[q];
      dim[o] = xi[q];
    }
  };
  pbmm_cb_transform<NLOG, S, false>(1, sre, sim, io.tw_fre, io.tw_fim, first,
                                    last);
}

// Launch 1 at a tight height H = m * 128: the zero-embedded strip, then
// per (n2, column) the m-point DFT of the points {n2 + 128 n1} (in place)
// against the combine matrix and the four-step twiddle, then the
// 128-point DIF of each of the m blocks; rows out in the fourstep layout
// (cs_row) to the scratch.
template <int S, int MAXM>
__global__ void __launch_bounds__(cs_threads(MAXM), 1)
    cs_fwd_tight_kernel(ColspecIO io,
                        const __grid_constant__ CsCombineOf<MAXM> cw) {
  extern __shared__ float smem[];
  const int h = io.h, m = h / PBMM_LANE;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  const size_t n = blockIdx.y;
  cs_load_strip<S>(io.rows_re + n * io.hc * wk + col0,
                   io.rows_im + n * io.hc * wk + col0, wk, h, sre, sim,
                   CsWindow{io.row0, io.hc});
  for (int e = threadIdx.x; e < PBMM_LANE * S; e += blockDim.x) {
    const int c = e & (S - 1), n2 = e >> pbmm_log2(S);
    float xr[MAXM], xi[MAXM];
#pragma unroll
    for (int n1 = 0; n1 < MAXM; ++n1) {
      if (n1 < m) {
        const int i = pbmm_cb_idx<S>(n1 * PBMM_LANE + n2, c);
        xr[n1] = sre[i];
        xi[n1] = sim[i];
      }
    }
    cs_mpoint_loop<MAXM>(m, [&](int k1) {
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int n1 = 0; n1 < MAXM; ++n1) {
        if (n1 < m) {
          const float wr = cw.wr(k1, n1), wi = cw.wi(k1, n1);
          sr += xr[n1] * wr - xi[n1] * wi;
          si += xr[n1] * wi + xi[n1] * wr;
        }
      }
      const int p = k1 * PBMM_LANE + n2;
      const float tr = __ldg(io.fs_re + p), ti = __ldg(io.fs_im + p);
      const int i = pbmm_cb_idx<S>(p, c);
      sre[i] = sr * tr - si * ti;
      sim[i] = sr * ti + si * tr;
    });
  }
  __syncthreads();
  float* dre = io.spec_re + n * h * wk + col0;
  float* dim = io.spec_im + n * h * wk + col0;
  auto first = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                   float (&xi)[PBMM_RP_P]) {
    pbmm_cb_read(gr, xr, xi, sre, sim);
  };
  auto last = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                  const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      const size_t o = (size_t)cs_row<false>(gr.pos(q)) * wk + gr.c;
      dre[o] = xr[q];
      dim[o] = xi[q];
    }
  };
  pbmm_cb_transform<7, S, false>(m, sre, sim, io.tw_fre, io.tw_fim, first,
                                 last);
}

// The phase pass launch 2 runs before its inverse: the main path's branch
// (host planes, integer power), every other branch, or none (the IIR
// branch: the tap scan has rotated the scratch spectra already).
enum CsPhase { CS_PH_MAIN = 0, CS_PH_GENERAL = 1, CS_PH_NONE = 2 };

// One frame's rotated scratch spectrum (src, the state's row layout) into
// the strip: strip row p from the state's row cs_row(p), by launch 1's
// asynchronous copies (cs_load_strip).  Ends synchronised.
template <int S, bool POW2>
__device__ __forceinline__ void cs_copy_strip(const float* __restrict__ src_re,
                                              const float* __restrict__ src_im,
                                              int h, size_t wk, int col0,
                                              float* sre, float* sim) {
  cs_load_strip<S>(src_re + col0, src_im + col0, wk, h, sre, sim,
                   [](int p, int& r) {
                     r = cs_row<POW2>(p);
                     return true;
                   });
}

// Launch 2: frame n's phase pass against frame n - C's scratch spectrum
// (the carried state for the first frame of each plane) into the strip
// (phase_inv.cuh; or, CS_PH_NONE, its rotated spectrum as it is),
// then the inverse: at pow-2 heights (MAXM = 0) the radix-2 DIT of 2^NLOG
// rows (phase_inv.cuh, the body kernel 6 runs), at tight heights the
// 128-point DIT of each block, the conjugate twiddle and the conjugate
// m-point combine; rows [r0, r1) out.
template <int NLOG, int S, int MAXM, int PH>
__global__ void __launch_bounds__(cs_threads(MAXM), 1)
    cs_inv_kernel(ColspecIO io, PhaseArgs pa,
                  const __grid_constant__ CsCombineOf<MAXM> cw) {
  extern __shared__ float smem[];
  constexpr bool POW2 = MAXM == 0;
  constexpr int LS = pbmm_log2(S);
  const int h = io.h, m = h / PBMM_LANE;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  const int n = blockIdx.y;
  const size_t hw = io.fs;
  if constexpr (PH == CS_PH_NONE) {
    cs_copy_strip<S, POW2>(io.spec_re + n * hw, io.spec_im + n * hw, h, wk,
                           col0, sre, sim);
  } else {
    const bool first = n < io.c;
    pbmm_phase_strip<S, POW2, PH == CS_PH_GENERAL, false>(
        io.spec_re + n * hw, io.spec_im + n * hw,
        first ? io.prev_re + n * hw : io.spec_re + (n - io.c) * hw,
        first ? io.prev_im + n * hw : io.spec_im + (n - io.c) * hw, nullptr,
        nullptr, nullptr, nullptr, io.plane0, io.plane1, io.fy, io.fx, pa, h,
        wk, col0, sre, sim);
  }

  const int r0 = io.r0, hr = io.r1 - io.r0;
  float* dre = io.out_re + (size_t)n * io.os + col0;
  float* dim = io.out_im + (size_t)n * io.os + col0;
  if constexpr (POW2) {
    pbmm_inv_rows_pow2<NLOG, S>(sre, sim, io.tw_ire, io.tw_iim, dre, dim, wk,
                                r0, hr);
  } else {
    auto read = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                    float (&xi)[PBMM_RP_P]) {
      pbmm_cb_read(gr, xr, xi, sre, sim);
    };
    auto write = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                     const float (&xi)[PBMM_RP_P]) {
      pbmm_cb_write(gr, xr, xi, sre, sim);
    };
    pbmm_cb_transform<7, S, true>(m, sre, sim, io.tw_ire, io.tw_iim, read,
                                  write);
    __syncthreads();
    constexpr int M = POW2 ? 1 : MAXM;
    for (int e = threadIdx.x; e < PBMM_LANE * S; e += blockDim.x) {
      const int c = e & (S - 1), n2 = e >> LS;
      float xr[M], xi[M];
#pragma unroll
      for (int k1 = 0; k1 < M; ++k1) {
        if (k1 < m) {
          const int p = k1 * PBMM_LANE + n2;
          const int i = pbmm_cb_idx<S>(p, c);
          const float zr = sre[i], zi = sim[i];
          const float tr = __ldg(io.fs_re + p), ti = -__ldg(io.fs_im + p);
          xr[k1] = zr * tr - zi * ti;
          xi[k1] = zr * ti + zi * tr;
        }
      }
      cs_mpoint_loop<M>(m, [&](int n1) {
        const int r = n1 * PBMM_LANE + n2 - r0;
        if ((unsigned)r >= (unsigned)hr) return;
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int k1 = 0; k1 < M; ++k1) {
          if (k1 < m) {
            const float wr = cw.wr(n1, k1), wi = -cw.wi(n1, k1);
            sr += xr[k1] * wr - xi[k1] * wi;
            si += xr[k1] * wi + xi[k1] * wr;
          }
        }
        const size_t o = (size_t)r * wk + c;
        dre[o] = sr;
        dim[o] = si;
      });
    }
  }
}

// Tight heights above m = 64: the 128-point DIF of each of a chunk's
// h / 128 blocks in place on the scratch (frame stride io.fs, the chunk's
// first row at io.spec_*), rows out in the fourstep layout (cs_row).
template <int S>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    cs_fwd_blocks_kernel(ColspecIO io) {
  extern __shared__ float smem[];
  const int h = io.h;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  float* dre = io.spec_re + blockIdx.y * io.fs + col0;
  float* dim = io.spec_im + blockIdx.y * io.fs + col0;
  cs_load_strip<S>(dre, dim, wk, h, sre, sim, CsWindow{0, h});
  auto first = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                   float (&xi)[PBMM_RP_P]) {
    pbmm_cb_read(gr, xr, xi, sre, sim);
  };
  auto last = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                  const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      const size_t o = (size_t)cs_row<false>(gr.pos(q)) * wk + gr.c;
      dre[o] = xr[q];
      dim[o] = xi[q];
    }
  };
  pbmm_cb_transform<7, S, false>(h / PBMM_LANE, sre, sim, io.tw_fre,
                                 io.tw_fim, first, last);
}

// Tight heights above m = 64: a chunk's phase pass (its rows' planes and
// frequencies at io.plane* / io.fy) or its rotated spectrum, then the
// 128-point DIT of each block, natural block rows out to io.out_* (frame
// stride io.os) for the inverse combine.
template <int S, int PH>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    cs_inv_blocks_kernel(ColspecIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  const int h = io.h;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk, hw = io.fs;
  const int col0 = blockIdx.x * S;
  const int n = blockIdx.y;
  if constexpr (PH == CS_PH_NONE) {
    cs_copy_strip<S, false>(io.spec_re + n * hw, io.spec_im + n * hw, h, wk,
                            col0, sre, sim);
  } else {
    const bool first = n < io.c;
    pbmm_phase_strip<S, false, PH == CS_PH_GENERAL, false>(
        io.spec_re + n * hw, io.spec_im + n * hw,
        first ? io.prev_re + n * hw : io.spec_re + (n - io.c) * hw,
        first ? io.prev_im + n * hw : io.spec_im + (n - io.c) * hw, nullptr,
        nullptr, nullptr, nullptr, io.plane0, io.plane1, io.fy, io.fx, pa, h,
        wk, col0, sre, sim);
  }
  float* dre = io.out_re + (size_t)n * io.os + col0;
  float* dim = io.out_im + (size_t)n * io.os + col0;
  auto read = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    pbmm_cb_read(gr, xr, xi, sre, sim);
  };
  auto last = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                  const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      const size_t o = (size_t)gr.pos(q) * wk + gr.c;
      dre[o] = xr[q];
      dim[o] = xi[q];
    }
  };
  pbmm_cb_transform<7, S, true>(h / PBMM_LANE, sre, sim, io.tw_ire, io.tw_iim,
                                read, last);
}

// The m-point combine of the four-step above m = 64, through device
// memory.  Forward: per column c and n2 < 128, the m points {n2 + 128 n1}
// of the zero-embedded column (src rows [row0, row0 + hs), frame stride
// ss), X[k1] = sum_n1 x[n1] W_m^{-k1 n1}, times the four-step twiddle
// fs[128 k1 + n2], to row 128 k1 + n2 of dst.  Inverse: the points times
// the conjugate twiddle, x[n1] = sum_k1 X[k1] conj(W_m^{-n1 k1}), rows
// [row0, row0 + hs) of the column out.  A block takes 32 columns and one
// n2 of one frame: the m points of each column staged in shared memory
// (2 m 32 floats; a row segment of 128 bytes a load), then each of its 8
// warps the outputs k = warp, warp + 8, ...: every thread of a warp reads
// the same matrix word (one broadcast), its column's points without bank
// conflicts.  The sums run in plain C++ (nvcc may contract them to FMA),
// as the in-register tiers' do.
struct CsCombIO {
  const float* src_re;
  const float* src_im;
  float* dst_re;
  float* dst_im;
  const float* fs_re;  // the four-step twiddle, (H,)
  const float* fs_im;
  const float* cw_re;  // the m x m combine, row k1 at k1 m
  const float* cw_im;
  int m, wk, hs, row0;
  size_t ss, ds;  // frame strides of src and dst
};

#define CS_CB_LANES 32
#define CS_CB_WARPS 8

template <bool INVERSE>
__global__ void __launch_bounds__(CS_CB_LANES * CS_CB_WARPS)
    cs_combine_kernel(CsCombIO a) {
  extern __shared__ float smem[];
  const int m = a.m, tx = threadIdx.x;
  float* xr = smem;
  float* xi = smem + m * CS_CB_LANES;
  const int c = blockIdx.x * CS_CB_LANES + tx;
  const int n2 = blockIdx.y;
  const bool on = c < a.wk;
  const float* sr = a.src_re + blockIdx.z * a.ss + c;
  const float* si = a.src_im + blockIdx.z * a.ss + c;
  for (int i = threadIdx.y; i < m; i += CS_CB_WARPS) {
    float vr = 0.0f, vi = 0.0f;
    if (!INVERSE) {
      const int r = i * PBMM_LANE + n2 - a.row0;
      if (on && (unsigned)r < (unsigned)a.hs) {
        vr = __ldcs(sr + (size_t)r * a.wk);
        vi = __ldcs(si + (size_t)r * a.wk);
      }
    } else if (on) {
      const int p = i * PBMM_LANE + n2;
      const float zr = __ldcs(sr + (size_t)p * a.wk);
      const float zi = __ldcs(si + (size_t)p * a.wk);
      const float tr = __ldg(a.fs_re + p), ti = -__ldg(a.fs_im + p);
      vr = zr * tr - zi * ti;
      vi = zr * ti + zi * tr;
    }
    xr[i * CS_CB_LANES + tx] = vr;
    xi[i * CS_CB_LANES + tx] = vi;
  }
  __syncthreads();
  if (!on) return;
  float* dr = a.dst_re + blockIdx.z * a.ds + c;
  float* di = a.dst_im + blockIdx.z * a.ds + c;
  for (int k = threadIdx.y; k < m; k += CS_CB_WARPS) {
    const float* wr = a.cw_re + (size_t)k * m;
    const float* wi = a.cw_im + (size_t)k * m;
    float sr_ = 0.0f, si_ = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float w_r = __ldg(wr + j);
      const float w_i = INVERSE ? -__ldg(wi + j) : __ldg(wi + j);
      const float x_r = xr[j * CS_CB_LANES + tx];
      const float x_i = xi[j * CS_CB_LANES + tx];
      sr_ += x_r * w_r - x_i * w_i;
      si_ += x_r * w_i + x_i * w_r;
    }
    if (!INVERSE) {
      const int p = k * PBMM_LANE + n2;
      const float tr = __ldg(a.fs_re + p), ti = __ldg(a.fs_im + p);
      dr[(size_t)p * a.wk] = sr_ * tr - si_ * ti;
      di[(size_t)p * a.wk] = sr_ * ti + si_ * tr;
    } else {
      const int r = k * PBMM_LANE + n2 - a.row0;
      if ((unsigned)r < (unsigned)a.hs) {
        dr[(size_t)r * a.wk] = sr_;
        di[(size_t)r * a.wk] = si_;
      }
    }
  }
}

// The IIR branch's launch 2, the tap scan: thread i owns bin i of the
// planes' (C, H, Wk) state, (row, lane) of plane i / (H Wk).  It walks the
// T frames of its plane in order with the previous frame's unmodified
// spectrum and the two taps in registers, runs the bin's phase pass
// (pbmm_phase_bin<true, true>, the general branch with the taps) once a
// frame against the scratch spectrum of that frame, and writes the rotated
// bin over it for launch 2's inverse; the frame's unmodified value becomes
// the next frame's prev.  new_prev and the taps leave at the end.
__global__ void __launch_bounds__(CS_SCAN_THREADS)
    cs_iir_scan_kernel(ColspecIO io, PhaseArgs pa) {
  const size_t hw = (size_t)io.h * io.wk;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw * io.c) return;
  const int plane = (int)(i / hw);
  const size_t g = i - (size_t)plane * hw;  // element of the shared planes
  const int row = (int)(g / io.wk), lane = (int)(g % io.wk);
  float pr = io.prev_re[i], pi = io.prev_im[i];
  float lf = io.lpf_in[i], ls = io.lps_in[i];
  for (int f = 0; f < io.t; ++f) {
    const size_t o = ((size_t)f * io.c + plane) * hw + g;
    const float cr = io.spec_re[o], ci = io.spec_im[o];
    float o_r, o_i;
    pbmm_phase_bin<true, true>(cr, ci, pr, pi, io.plane0, io.plane1, g,
                               io.fy, row, io.fx, lane, &lf, &ls, pa, o_r,
                               o_i);
    io.spec_re[o] = o_r;
    io.spec_im[o] = o_i;
    pr = cr;
    pi = ci;
  }
  io.np_re[i] = pr;
  io.np_im[i] = pi;
  io.lpf_out[i] = lf;
  io.lps_out[i] = ls;
}

// Columns a block of the in-block kernels holds: the widest power of two
// up to 16 (64-byte row segments) whose strip (2 H S floats) fits the
// 227 KB a block may have, 2 at least: 16 to H = 1024 (pow-2) or m = 14
// (tight), 8 to 2048 or m = 28, 4 to 4096 or m = 32, 2 above (to 8192,
// and the bracketed pow-2 heights' 8192-row blocks; the tight heights at
// m = 33-63 take 2 for their 256-thread blocks, above m = 64 the chunk
// kernels' CS_CHUNK_S).
static int cs_strip(int h) {
  const bool pow2 = (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  return pow2 ? (h <= 1024 ? 16 : h <= 2048 ? 8 : h <= 4096 ? 4 : 2)
              : (m <= 14 ? 16 : m <= 28 ? 8 : m <= CS_MAXM_PARAM ? 4
                 : m < CS_MAXM ? 2 : CS_CHUNK_S);
}

template <class K, class... Args>
static cudaError_t cs_run(K kernel, dim3 grid, dim3 threads, size_t smem,
                          cudaStream_t stream, const Args&... args) {
  const cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launch 2 (after the tap scan with the IIR taps) on strips of S columns:
// the strip's shared memory, and on the main branch the phase pass's ring.
template <int NLOG, int S, int MAXM>
static cudaError_t cs_second(const ColspecIO& io, const PhaseArgs& pa,
                             const CsCombineOf<MAXM>& cw, int ph, dim3 grid,
                             cudaStream_t st) {
  const int nt = cs_threads(MAXM);
  const size_t smem =
      pbmm_ps_smem(io.h, S, nt, pbmm_ps_words(true, ph != CS_PH_MAIN));
  if (ph == CS_PH_MAIN)
    return cs_run(cs_inv_kernel<NLOG, S, MAXM, CS_PH_MAIN>, grid, nt, smem,
                  st, io, pa, cw);
  if (ph == CS_PH_GENERAL)
    return cs_run(cs_inv_kernel<NLOG, S, MAXM, CS_PH_GENERAL>, grid, nt,
                  smem, st, io, pa, cw);
  const size_t bins = (size_t)io.c * io.h * io.wk;
  const dim3 scan((unsigned)((bins + CS_SCAN_THREADS - 1) / CS_SCAN_THREADS));
  const cudaError_t err =
      cs_run(cs_iir_scan_kernel, scan, CS_SCAN_THREADS, 0, st, io, pa);
  if (err != cudaSuccess) return err;
  return cs_run(cs_inv_kernel<NLOG, S, MAXM, CS_PH_NONE>, grid, nt, smem, st,
                io, pa, cw);
}

// Every launch at a pow-2 height 2^NLOG on strips of S columns.
template <int NLOG, int S>
static cudaError_t cs_pow2(const ColspecIO& io, const PhaseArgs& pa, int ph,
                           cudaStream_t st) {
  const dim3 grid(io.wk / S, io.t * io.c);
  const size_t smem = 2 * ((size_t)S << NLOG) * sizeof(float);
  const cudaError_t err = cs_run(cs_fwd_pow2_kernel<NLOG, S>, grid,
                                 PBMM_CB_THREADS, smem, st, io);
  if (err != cudaSuccess) return err;
  return cs_second<NLOG, S, 0>(io, pa, CsCombine<1>{}, ph, grid, st);
}

// Every launch at a tight height, m <= MAXM.
template <int S, int MAXM>
static cudaError_t cs_tight(const ColspecIO& io, const PhaseArgs& pa, int ph,
                            const float* cw_re, const float* cw_im,
                            cudaStream_t st) {
  const dim3 grid(io.wk / S, io.t * io.c);
  const size_t smem = 2 * (size_t)io.h * S * sizeof(float);
  const CsCombineOf<MAXM> cw = cs_combine<MAXM>(
      cw_re, cw_im, io.cwd_re, io.cwd_im, io.h / PBMM_LANE);
  const cudaError_t err = cs_run(cs_fwd_tight_kernel<S, MAXM>, grid,
                                 cs_threads(MAXM), smem, st, io, cw);
  if (err != cudaSuccess) return err;
  return cs_second<7, S, MAXM>(io, pa, cw, ph, grid, st);
}

// Pow-2 heights above 8192 (col_pass.cuh): the forward bracket into the
// scratch, launch 1 on every 8192-row block in place, launch 2 (or the
// tap scan and launch 3) on every block into the second scratch (sp2),
// the inverse bracket out.
static cudaError_t cs_pow2_bracket(const ColspecIO& io, const PhaseArgs& pa,
                                   int ph, float* sp2_re, float* sp2_im,
                                   cudaStream_t st) {
  constexpr int NB = PBMM_BK_LOG, S = 2;
  const int blks = io.h / PBMM_BK_N, frames = io.t * io.c;
  const size_t hw = (size_t)io.h * io.wk, bw = (size_t)PBMM_BK_N * io.wk;
  const size_t smem = 2 * ((size_t)S << NB) * sizeof(float);
  if ((long long)frames * blks > 65535) return cudaErrorInvalidValue;
  const PbmmColPass fwd = {io.rows_re, io.rows_im, io.spec_re, io.spec_im,
                           io.tw_fre,  io.tw_fim,  io.h,       io.wk,
                           io.hc,      io.row0,    0,          0,
                           1.0f,       0,          (size_t)io.hc * io.wk,
                           hw};
  cudaError_t err = pbmm_bracket_cols(fwd, frames, false, st);
  if (err != cudaSuccess) return err;
  ColspecIO v = io;  // every block as a frame of 8192 rows
  v.rows_re = io.spec_re;
  v.rows_im = io.spec_im;
  v.hc = v.h = PBMM_BK_N;
  v.row0 = v.r0 = 0;
  v.r1 = PBMM_BK_N;
  v.fs = v.os = bw;
  v.out_re = sp2_re;
  v.out_im = sp2_im;
  const dim3 all(io.wk / S, frames * blks);
  err = cs_run(cs_fwd_pow2_kernel<NB, S>, all, PBMM_CB_THREADS, smem, st, v);
  if (err != cudaSuccess) return err;
  const CsCombine<1> none = {};
  if (ph == CS_PH_NONE) {
    const size_t bins = (size_t)io.c * hw;
    err = cs_run(cs_iir_scan_kernel,
                 dim3((unsigned)((bins + CS_SCAN_THREADS - 1) /
                                 CS_SCAN_THREADS)),
                 CS_SCAN_THREADS, 0, st, io, pa);
    if (err == cudaSuccess)
      err = cs_run(cs_inv_kernel<NB, S, 0, CS_PH_NONE>, all, PBMM_CB_THREADS,
                   smem, st, v, pa, none);
  } else {
    for (int b = 0; b < blks && err == cudaSuccess; ++b) {
      ColspecIO w = v;  // block b of every frame, at the column's stride
      const size_t o = b * bw;
      w.spec_re = io.spec_re + o;
      w.spec_im = io.spec_im + o;
      w.prev_re = io.prev_re + o;
      w.prev_im = io.prev_im + o;
      w.plane0 = io.plane0 ? io.plane0 + o : nullptr;
      w.plane1 = io.plane1 ? io.plane1 + o : nullptr;
      w.fy = io.fy ? io.fy + (size_t)b * PBMM_BK_N : nullptr;
      w.out_re = sp2_re + o;
      w.out_im = sp2_im + o;
      w.fs = w.os = hw;
      const dim3 grid(io.wk / S, frames);
      err = ph == CS_PH_MAIN
                ? cs_run(cs_inv_kernel<NB, S, 0, CS_PH_MAIN>, grid,
                         PBMM_CB_THREADS, smem, st, w, pa, none)
                : cs_run(cs_inv_kernel<NB, S, 0, CS_PH_GENERAL>, grid,
                         PBMM_CB_THREADS, smem, st, w, pa, none);
    }
  }
  if (err != cudaSuccess) return err;
  const PbmmColPass inv = {sp2_re,    sp2_im, io.out_re,     io.out_im,
                           io.tw_ire, io.tw_iim, io.h,       io.wk,
                           io.r1 - io.r0, io.r0, 0, 0, 1.0f, 0, hw, io.os};
  return pbmm_bracket_cols(inv, frames, true, st);
}

template <bool INVERSE>
static cudaError_t cs_combine_run(const CsCombIO& a, int frames,
                                  cudaStream_t st) {
  const size_t smem = 2 * (size_t)a.m * CS_CB_LANES * sizeof(float);
  return cs_run(cs_combine_kernel<INVERSE>,
                dim3((a.wk + CS_CB_LANES - 1) / CS_CB_LANES, PBMM_LANE,
                     frames),
                dim3(CS_CB_LANES, CS_CB_WARPS), smem, st, a);
}

// Tight heights above m = 64: the forward combine into the scratch, the
// 128-point DIF chunk by chunk in place, the tap scan (IIR), the phase
// pass and 128-point DIT chunk by chunk into the second scratch, the
// inverse combine out.
static cudaError_t cs_tight_big(const ColspecIO& io, const PhaseArgs& pa,
                                int ph, float* sp2_re, float* sp2_im,
                                cudaStream_t st) {
  constexpr int S = CS_CHUNK_S;
  const int m = io.h / PBMM_LANE, frames = io.t * io.c;
  const size_t hw = (size_t)io.h * io.wk;
  const CsCombIO fwd = {io.rows_re, io.rows_im, io.spec_re, io.spec_im,
                        io.fs_re,   io.fs_im,   io.cwd_re,  io.cwd_im,
                        m,          io.wk,      io.hc,      io.row0,
                        (size_t)io.hc * io.wk, hw};
  cudaError_t err = cs_combine_run<false>(fwd, frames, st);
  const dim3 grid(io.wk / S, frames);
  for (int k0 = 0; k0 < m && err == cudaSuccess; k0 += CS_CHUNK_M) {
    const int mc = m - k0 < CS_CHUNK_M ? m - k0 : CS_CHUNK_M;
    ColspecIO v = io;
    const size_t o = (size_t)k0 * PBMM_LANE * io.wk;
    v.spec_re = io.spec_re + o;
    v.spec_im = io.spec_im + o;
    v.h = mc * PBMM_LANE;
    v.fs = hw;
    err = cs_run(cs_fwd_blocks_kernel<S>, grid, PBMM_CB_THREADS,
                 2 * (size_t)v.h * S * sizeof(float), st, v);
  }
  if (err == cudaSuccess && ph == CS_PH_NONE) {
    const size_t bins = (size_t)io.c * hw;
    err = cs_run(cs_iir_scan_kernel,
                 dim3((unsigned)((bins + CS_SCAN_THREADS - 1) /
                                 CS_SCAN_THREADS)),
                 CS_SCAN_THREADS, 0, st, io, pa);
  }
  for (int k0 = 0; k0 < m && err == cudaSuccess; k0 += CS_CHUNK_M) {
    const int mc = m - k0 < CS_CHUNK_M ? m - k0 : CS_CHUNK_M;
    ColspecIO w = io;
    const size_t o = (size_t)k0 * PBMM_LANE * io.wk;
    w.spec_re = io.spec_re + o;
    w.spec_im = io.spec_im + o;
    w.prev_re = io.prev_re + o;
    w.prev_im = io.prev_im + o;
    w.plane0 = io.plane0 ? io.plane0 + o : nullptr;
    w.plane1 = io.plane1 ? io.plane1 + o : nullptr;
    w.fy = io.fy ? io.fy + (size_t)k0 * PBMM_LANE : nullptr;
    w.out_re = sp2_re + o;
    w.out_im = sp2_im + o;
    w.h = mc * PBMM_LANE;
    w.fs = w.os = hw;
    const size_t smem = pbmm_ps_smem(w.h, S, PBMM_CB_THREADS,
                                     pbmm_ps_words(true, ph != CS_PH_MAIN));
    err = ph == CS_PH_MAIN
              ? cs_run(cs_inv_blocks_kernel<S, CS_PH_MAIN>, grid,
                       PBMM_CB_THREADS, smem, st, w, pa)
          : ph == CS_PH_GENERAL
              ? cs_run(cs_inv_blocks_kernel<S, CS_PH_GENERAL>, grid,
                       PBMM_CB_THREADS, smem, st, w, pa)
              : cs_run(cs_inv_blocks_kernel<S, CS_PH_NONE>, grid,
                       PBMM_CB_THREADS, smem, st, w, pa);
  }
  if (err != cudaSuccess) return err;
  const CsCombIO inv = {sp2_re,   sp2_im,   io.out_re, io.out_im, io.fs_re,
                        io.fs_im, io.cwd_re, io.cwd_im, m,        io.wk,
                        io.r1 - io.r0, io.r0, hw,      io.os};
  return cs_combine_run<true>(inv, frames, st);
}

// iargs, fargs: the phase pass's branch and constants (host arrays, copied
// by value; phase_pass.cuh::pbmm_phase_unpack); cw_re / cw_im: the m x m
// combine (host arrays; null at pow-2 heights) and cwd_re / cwd_im the
// same on the device (read above m = 32); tw_*: compact_twiddles(n) with
// n = 128 at tight heights, else H.  spec_re / spec_im: the scratch, (T
// C, H, Wk) each; sp2_re / sp2_im a second one of that size, read only
// above 8192 rows (pow-2) or m = 64 (tight), else null.  staged (a host
// int, or null): set to 1 where launch 2 runs the phase pass on the
// asynchronous strip (phase_inv.cuh::pbmm_ps_async on its strip and
// branch), else 0, on the host and before any launch; copied (a host int,
// or null) likewise 1 where launch 3 brings the rotated spectra in by
// asynchronous copies (cs_copy_strip: every call with the IIR taps), else
// 0.  Any height.
extern "C" int pbmm_colspec_chunk(
    const float* rows_re, const float* rows_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* fs_re, const float* fs_im,
    const float* cw_re, const float* cw_im, const float* cwd_re,
    const float* cwd_im, const float* tw_fre, const float* tw_fim,
    const float* tw_ire, const float* tw_iim, float* spec_re,
    float* spec_im, float* out_re, float* out_im, float* np_re,
    float* np_im, float* lpf_out, float* lps_out, float* sp2_re,
    float* sp2_im, const int* iargs, const float* fargs, int t, int c,
    int hc, int h, int wk, int row0, int r0, int r1, int* staged,
    int* copied, void* stream) {
  PhaseArgs pa;
  const bool args_ok = pbmm_phase_unpack(iargs, fargs, pa);
  const bool pow2 = h >= 2 && (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  const bool general = pbmm_phase_general(pa);
  const int s = cs_strip(h);
  const bool big = pow2 ? h > PBMM_BK_N : m >= CS_MAXM;
  if (!args_ok || t < 1 || c < 1 || (long long)t * c > 65535 ||
      (!pow2 && (h != m * PBMM_LANE || m < 1)) ||
      (big && (sp2_re == nullptr || sp2_im == nullptr)) ||
      wk % s != 0 || hc < 1 || row0 < 0 || row0 + hc > h || r0 < 0 ||
      r1 <= r0 || r1 > h || (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      spec_re == nullptr || spec_im == nullptr ||
      // the asynchronous strip copies
      (size_t)rows_re % 16 || (size_t)rows_im % 16 ||
      (size_t)prev_re % 16 || (size_t)prev_im % 16 ||
      (size_t)spec_re % 16 || (size_t)spec_im % 16 ||
      (!general && ((size_t)plane0 % 16 || (size_t)plane1 % 16)) ||
      (general && (fy == nullptr || fx == nullptr)) ||
      (!pow2 && (fs_re == nullptr || cw_re == nullptr)) ||
      (!pow2 && m > CS_MAXM_PARAM && (cwd_re == nullptr || cwd_im == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ColspecIO io = {rows_re, rows_im, prev_re, prev_im, lpf_in,  lps_in,
                        plane0,  plane1,  fy,      fx,      fs_re,   fs_im,
                        cwd_re,  cwd_im,  tw_fre,  tw_fim,  tw_ire,  tw_iim,
                        spec_re, spec_im, out_re,  out_im,  np_re,   np_im,
                        lpf_out, lps_out, t,       c,       hc,      h,
                        wk,      row0,    r0,      r1,
                        (size_t)h * wk,   (size_t)(r1 - r0) * wk};
  const int ph = pa.iir ? CS_PH_NONE : general ? CS_PH_GENERAL : CS_PH_MAIN;
  // s = cs_strip(h) is launch 2's strip at every height (the dispatch
  // below, the bracket's 8192-row blocks: 2, the combine pass's chunks:
  // CS_CHUNK_S), and these its ring words (cs_second, cs_tight_big); after
  // the tap scan, launch 3 brings its strip in by asynchronous copies at
  // every height (cs_copy_strip).
  if (staged != nullptr)
    *staged = pbmm_ps_async(s, pbmm_ps_words(true, ph != CS_PH_MAIN));
  if (copied != nullptr) *copied = ph == CS_PH_NONE;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (big) {
    err = pow2 ? cs_pow2_bracket(io, pa, ph, sp2_re, sp2_im, st)
               : cs_tight_big(io, pa, ph, sp2_re, sp2_im, st);
  } else if (!pow2) {
    err = m <= 14   ? cs_tight<16, 14>(io, pa, ph, cw_re, cw_im, st)
          : m <= 28 ? cs_tight<8, 28>(io, pa, ph, cw_re, cw_im, st)
          : m <= CS_MAXM_PARAM
              ? cs_tight<4, CS_MAXM_PARAM>(io, pa, ph, cw_re, cw_im, st)
              : cs_tight<2, CS_MAXM>(io, pa, ph, cw_re, cw_im, st);
  } else {
    switch (h) {
#define CS_POW2(NLOG, S) \
  case 1 << NLOG: err = cs_pow2<NLOG, S>(io, pa, ph, st); break;
      CS_POW2(1, 16) CS_POW2(2, 16) CS_POW2(3, 16) CS_POW2(4, 16)
      CS_POW2(5, 16) CS_POW2(6, 16) CS_POW2(7, 16) CS_POW2(8, 16)
      CS_POW2(9, 16) CS_POW2(10, 16) CS_POW2(11, 8) CS_POW2(12, 4)
      CS_POW2(13, 2)
#undef CS_POW2
      default: return (int)cudaErrorInvalidValue;
    }
  }
  // With the IIR taps the scan wrote new_prev; else the last frame's
  // spectrum of each plane is the next chunk's prev.
  if (err != cudaSuccess || pa.iir) return (int)err;
  const size_t plane = (size_t)h * wk, bytes = c * plane * sizeof(float);
  const size_t last = (size_t)(t - 1) * c * plane;
  err = cudaMemcpyAsync(np_re, spec_re + last, bytes,
                        cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(np_im, spec_im + last, bytes,
                          cudaMemcpyDeviceToDevice, st);
  return (int)err;
}

// The dynamic shared memory the phase strip's launches take at height h on
// strips of s columns, `threads` a block, `words` 16-byte words a thread a
// ring slot (phase_inv.cuh::pbmm_ps_smem), for the host's mirror
// (spectral/fused.py::phase_strip_smem).
extern "C" int pbmm_phase_strip_smem(int h, int s, int threads, int words) {
  if (h < 1 || s < 1 || threads < 32 || threads > 1024 || words < 0)
    return -1;
  return pbmm_ps_smem(h, s, threads, words);
}
