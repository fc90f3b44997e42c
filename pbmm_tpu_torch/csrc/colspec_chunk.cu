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
// Design.  Outside the IIR branch a frame's phase pass reads the
// unmodified forward spectrum of the frame before it (fused.py:1314-1324
// carries it in VMEM only because the TPU grid runs in order), so once the
// forward spectra exist the frames are independent.  Two launches:
//   1. the forward column transform of every frame of every plane into a
//      scratch tensor the wrapper allocates, in the state's layout
//      (cs_fwd_*: one block a strip of S columns of one frame);
//   2. the phase pass of every frame against the scratch spectrum of the
//      frame before it (the carried state for the first), then the column
//      IFFT, rows [r0, r1) out (cs_inv_kernel: one block a strip and a
//      frame).
// The last frame's spectrum leaves as new_prev (a device copy).  Each
// block holds its strip in shared memory (512 threads, one block an SM)
// and runs the transform as col_pass.cuh's in-block register passes (up
// to four stages a pass, one barrier a pass boundary, addresses constant
// offsets of one base a group).  The strip is as wide as 227 KB allows,
// up to 16 columns (64-byte row segments; cs_strip): 16 to H = 1024
// (pow-2) or m = 14 (144 KB at 1080p's 1152 rows), 8 to 2048 or m = 28, 4
// above (to 4096, 128 KB).  Launch 1 brings the zero-embedded strip in by
// 16-byte asynchronous copies, all in flight at once, then transforms it.
// At tight heights a thread holds its column's m points {n2 + 128 n1}
// for the m-point DFT, whose combine matrix is a kernel parameter
// (CsCombine: with both loops unrolled each weight is an FMA operand),
// applies the four-step twiddle, and the 128-point factor runs as passes
// of 4 + 3 stages; the inverse mirrors it.  The pow-2 passes run kernel
// 5's butterflies (the forward, kernel 5 bit for bit), and launch 2's
// pow-2 phase pass and inverse are phase_inv.cuh's device functions,
// which kernel 6 runs too (kernel 6 bit for bit on kernel 5's spectra).
// A frame's forward transform is one code path whichever chunk it falls
// in, so two chunks equal one.
// The four-step combine sums in plain C++ (nvcc may contract it to FMA),
// held to the plain version at 1e-4 of the spectrum's magnitude.  On an
// NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py) a 1080p tight
// chunk (16 frames, 1152 x 1152 kept) takes 0.847 ms against 2.674 for
// the frame-serial design (strips of 4 columns, a barrier a stage).
//
// The IIR branch carries the taps from frame to frame, so it keeps the
// frame-serial schedule (colspec_iir_kernel): a block owns a strip of 4
// columns (2 above H = 2048) of one plane and loops over the frames, cur,
// prev and the taps in shared memory (192 KB), every stage between
// barriers.
//
// What bounds it on an H100: per frame it reads the Hc content rows and
// writes r1 - r0 output rows (re and im), plus the scratch spectra (one
// write, two reads) outside the IIR branch; against ~H (m + 7) complex
// FMAs a column (tight) or 5 H log2(H) flops (pow-2) plus the phase chain:
// bytes.  Times at each branch, on an NVIDIA H100 80GB HBM3 at its 700 W
// limit, are in PERF.md (chip_smoke.py).

#include <cuda_pipeline.h>

#include "col_pass.cuh"
#include "common.cuh"
#include "phase_inv.cuh"


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
  const float* tw_fre;  // radix-2 tables: the IIR branch's (log2 n, n)
  const float* tw_fim;  // _dif_twiddles, else compact_twiddles (n - 1),
  const float* tw_ire;  // n = 128 (tight) or H
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
};

// The four-step combine matrix W_m^{-k1 n1} (fused.py:_combine_matrix),
// by value: row k1 at k1 * M.  Kernel parameters live in the constant
// bank, and with both loops of the m-point DFT unrolled every weight is an
// operand of the FMAs it feeds, not a load.
template <int M>
struct CsCombine {
  float re[M * M];
  float im[M * M];
};

// The m x m host matrices (re, im) into CsCombine<M> (null: pow-2, unused).
template <int M>
static CsCombine<M> cs_combine(const float* re, const float* im, int m) {
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

// The IIR branch, frame-serial: a block owns a strip of CS_S kept columns
// of one plane and loops over the T frames itself; cur and prev (4 x H x
// CS_S f32) and the taps (2 more planes) stay in shared memory for the
// whole chunk, and the two spectrum buffers swap roles each frame (the
// phase pass overwrites prev with the modified spectrum in place).  CS_S =
// 4, CS_MAXM = 16 up to H = 2048 (192 KB); CS_S = 2, CS_MAXM = 32 above,
// up to H = 4096.  Twiddles: the (log2 n, n) _dif_twiddles tables.
template <bool POW2, int CS_S, int CS_MAXM>
__global__ void __launch_bounds__(256)
    colspec_iir_kernel(ColspecIO io, PhaseArgs pa,
                       const CsCombine<POW2 ? 1 : CS_MAXM> cw) {
  extern __shared__ float smem[];
  const int h = io.h, wk = io.wk;
  const int hs = h * CS_S;
  float* a_re = smem;  // current frame
  float* a_im = smem + hs;
  float* b_re = smem + 2 * hs;  // previous frame, then the modified one
  float* b_im = smem + 3 * hs;
  float* l_f = smem + 4 * hs;  // IIR taps
  float* l_s = smem + 5 * hs;
  const int m = h / PBMM_LANE;
  const int col0 = blockIdx.x * CS_S;
  const int nt = blockDim.x;
  const int plane = blockIdx.y;
  const size_t soff = (size_t)plane * h * wk;  // this plane's state
  const int hr = io.r1 - io.r0;

  // Carried state in, through the JAX row order.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const size_t g = soff + (size_t)cs_row<POW2>(p) * wk + col0 + c;
    b_re[e] = io.prev_re[g];
    b_im[e] = io.prev_im[g];
    l_f[e] = io.lpf_in[g];
    l_s[e] = io.lps_in[g];
  }

  for (int f = 0; f < io.t; ++f) {
    const size_t n = (size_t)f * io.c + plane;  // this plane's row of f
    const size_t fbase = n * io.hc * wk;
    if (POW2) {
      // 1-3. Zero-embed and the radix-2 DIF (kernel 5's arithmetic).
      pbmm_col_fft_pow2<CS_S>(io.rows_re + fbase, io.rows_im + fbase,
                              io.hc, wk, col0, io.row0, h, io.tw_fre,
                              io.tw_fim, a_re, a_im);
    } else {
      // 1. Zero-embed the content rows at row0.
      pbmm_col_embed<CS_S>(io.rows_re + fbase, io.rows_im + fbase, io.hc,
                           wk, col0, io.row0, h, a_re, a_im);

      // 2. Cross-block m-point DFT, then the four-step twiddle.
      for (int it = threadIdx.x; it < PBMM_LANE * CS_S; it += nt) {
        const int n2 = it / CS_S, c = it % CS_S;
        float xr[CS_MAXM], xi[CS_MAXM];
#pragma unroll
        for (int n1 = 0; n1 < CS_MAXM; ++n1) {
          if (n1 < m) {
            const int e = (n1 * PBMM_LANE + n2) * CS_S + c;
            xr[n1] = a_re[e];
            xi[n1] = a_im[e];
          }
        }
        for (int k1 = 0; k1 < m; ++k1) {
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int n1 = 0; n1 < CS_MAXM; ++n1) {
            if (n1 < m) {
              const float wr = cw.re[k1 * CS_MAXM + n1];
              const float wi = cw.im[k1 * CS_MAXM + n1];
              sr += xr[n1] * wr - xi[n1] * wi;
              si += xr[n1] * wi + xi[n1] * wr;
            }
          }
          const int p = k1 * PBMM_LANE + n2;
          const float tr = __ldg(io.fs_re + p), ti = __ldg(io.fs_im + p);
          a_re[p * CS_S + c] = sr * tr - si * ti;
          a_im[p * CS_S + c] = sr * ti + si * tr;
        }
      }
      __syncthreads();

      // 3. 128-point DIF per block: m * S sequences, sequence (k1, c) at
      //    row 128 k1, column c, element stride S.
      pbmm_radix2(a_re, a_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S,
                  1, CS_S, io.tw_fre, io.tw_fim, false);
    }

    // 4. Phase pass against prev; the result replaces prev in place.
    for (int e = threadIdx.x; e < hs; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const int P = cs_row<POW2>(p);
      const size_t g = (size_t)P * wk + col0 + c;  // shared by the planes
      const float cr = a_re[e], ci = a_im[e];
      const float pr = b_re[e], pi = b_im[e];
      float o_r, o_i;
      // The IIR taps take the general branch (pbmm_phase_general).
      pbmm_phase_bin<true, true>(cr, ci, pr, pi, io.plane0, io.plane1, g,
                                 io.fy, P, io.fx, col0 + c, l_f + e, l_s + e,
                                 pa, o_r, o_i);
      b_re[e] = o_r;
      b_im[e] = o_i;
    }
    __syncthreads();

    // 5. Inverse, natural rows out, unnormalised.
    if (POW2) {
      pbmm_radix2(b_re, b_im, h, CS_S, CS_S, 0, 1, CS_S, io.tw_ire,
                  io.tw_iim, true);
    } else {
      // 128-point DIT per block, conj twiddle, conj combine.
      pbmm_radix2(b_re, b_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S,
                  1, CS_S, io.tw_ire, io.tw_iim, true);
      for (int it = threadIdx.x; it < PBMM_LANE * CS_S; it += nt) {
        const int n2 = it / CS_S, c = it % CS_S;
        float xr[CS_MAXM], xi[CS_MAXM];
#pragma unroll
        for (int k1 = 0; k1 < CS_MAXM; ++k1) {
          if (k1 < m) {
            const int p = k1 * PBMM_LANE + n2;
            const float zr = b_re[p * CS_S + c], zi = b_im[p * CS_S + c];
            const float tr = __ldg(io.fs_re + p), ti = -__ldg(io.fs_im + p);
            xr[k1] = zr * tr - zi * ti;
            xi[k1] = zr * ti + zi * tr;
          }
        }
        for (int n1 = 0; n1 < m; ++n1) {
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int k1 = 0; k1 < CS_MAXM; ++k1) {
            if (k1 < m) {
              const float wr = cw.re[n1 * CS_MAXM + k1];
              const float wi = -cw.im[n1 * CS_MAXM + k1];
              sr += xr[k1] * wr - xi[k1] * wi;
              si += xr[k1] * wi + xi[k1] * wr;
            }
          }
          const int e = (n1 * PBMM_LANE + n2) * CS_S + c;
          b_re[e] = sr;
          b_im[e] = si;
        }
      }
      __syncthreads();
    }

    // 6. Rows [r0, r1) of the inverse out.
    const size_t obase = n * hr * wk;
    for (int e = threadIdx.x; e < hr * CS_S; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const size_t g = obase + (size_t)p * wk + col0 + c;
      io.out_re[g] = b_re[(p + io.r0) * CS_S + c];
      io.out_im[g] = b_im[(p + io.r0) * CS_S + c];
    }
    __syncthreads();

    // This frame's spectrum is the next frame's prev.
    float* sw;
    sw = a_re; a_re = b_re; b_re = sw;
    sw = a_im; a_im = b_im; b_im = sw;
  }

  // The last frame's spectrum leaves as new_prev (now in b after the
  // swap), with the taps.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const size_t g = soff + (size_t)cs_row<POW2>(p) * wk + col0 + c;
    io.np_re[g] = b_re[e];
    io.np_im[g] = b_im[e];
    io.lpf_out[g] = l_f[e];
    io.lps_out[g] = l_s[e];
  }
}

// The zero-embedded content strip of one frame into the strip's shared
// memory: rows [row0, row0 + hc) of the S columns by 16-byte asynchronous
// copies, every copy of the block in flight at once, the other rows zero.
// Ends synchronised.
template <int S>
__device__ __forceinline__ void cs_load_strip(
    const float* __restrict__ src_re, const float* __restrict__ src_im,
    size_t wk, int hc, int row0, int h, float* sre, float* sim) {
  constexpr int Q = S / 4;  // 16-byte runs of a row
  for (int i = threadIdx.x; i < h * Q; i += blockDim.x) {
    const int p = i / Q, j = i % Q;
    const int w = pbmm_cb_idx<S>(p, 4 * j);
    const int r = p - row0;
    if ((unsigned)r < (unsigned)hc) {
      const size_t o = (size_t)r * wk + 4 * j;
      __pipeline_memcpy_async(sre + w, src_re + o, 16);
      __pipeline_memcpy_async(sim + w, src_im + o, 16);
    } else {
      *reinterpret_cast<float4*>(sre + w) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sim + w) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

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
                   io.rows_im + n * io.hc * wk + col0, wk, io.hc, io.row0, N,
                   sre, sim);
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
// against the combine matrix (a kernel parameter) and the four-step twiddle,
// then the 128-point DIF of each of the m blocks; rows out in the
// fourstep layout (cs_row) to the scratch.
template <int S, int MAXM>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    cs_fwd_tight_kernel(ColspecIO io, const CsCombine<MAXM> cw) {
  extern __shared__ float smem[];
  const int h = io.h, m = h / PBMM_LANE;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  const size_t n = blockIdx.y;
  cs_load_strip<S>(io.rows_re + n * io.hc * wk + col0,
                   io.rows_im + n * io.hc * wk + col0, wk, io.hc, io.row0, h,
                   sre, sim);
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
#pragma unroll
    for (int k1 = 0; k1 < MAXM; ++k1) {
      if (k1 >= m) break;
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int n1 = 0; n1 < MAXM; ++n1) {
        if (n1 < m) {
          const float wr = cw.re[k1 * MAXM + n1], wi = cw.im[k1 * MAXM + n1];
          sr += xr[n1] * wr - xi[n1] * wi;
          si += xr[n1] * wi + xi[n1] * wr;
        }
      }
      const int p = k1 * PBMM_LANE + n2;
      const float tr = __ldg(io.fs_re + p), ti = __ldg(io.fs_im + p);
      const int i = pbmm_cb_idx<S>(p, c);
      sre[i] = sr * tr - si * ti;
      sim[i] = sr * ti + si * tr;
    }
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

// Launch 2: frame n's phase pass against frame n - C's scratch spectrum
// (the carried state for the first frame of each plane), element by
// element into the strip, then the inverse: at pow-2 heights (MAXM = 0)
// the radix-2 DIT of 2^NLOG rows (phase_inv.cuh, the body kernel 6 runs),
// at tight heights the 128-point DIT of each block, the conjugate twiddle
// and the conjugate m-point combine; rows [r0, r1) out.
template <int NLOG, int S, int MAXM, bool GENERAL>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    cs_inv_kernel(ColspecIO io, PhaseArgs pa,
                  const CsCombine<MAXM ? MAXM : 1> cw) {
  extern __shared__ float smem[];
  constexpr bool POW2 = MAXM == 0;
  constexpr int LS = pbmm_log2(S);
  const int h = io.h, m = h / PBMM_LANE;
  float* sre = smem;
  float* sim = smem + h * S;
  const size_t wk = io.wk;
  const int col0 = blockIdx.x * S;
  const int n = blockIdx.y;
  const size_t hw = (size_t)h * wk;
  const bool first = n < io.c;
  pbmm_phase_strip<S, POW2, GENERAL, false>(
      io.spec_re + n * hw, io.spec_im + n * hw,
      first ? io.prev_re + n * hw : io.spec_re + (n - io.c) * hw,
      first ? io.prev_im + n * hw : io.spec_im + (n - io.c) * hw, nullptr,
      nullptr, nullptr, nullptr, io.plane0, io.plane1, io.fy, io.fx, pa, h,
      wk, col0, sre, sim);

  const int r0 = io.r0, hr = io.r1 - io.r0;
  float* dre = io.out_re + (size_t)n * hr * wk + col0;
  float* dim = io.out_im + (size_t)n * hr * wk + col0;
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
#pragma unroll
      for (int n1 = 0; n1 < M; ++n1) {
        if (n1 >= m) break;
        const int r = n1 * PBMM_LANE + n2 - r0;
        if ((unsigned)r >= (unsigned)hr) continue;
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int k1 = 0; k1 < M; ++k1) {
          if (k1 < m) {
            const float wr = cw.re[n1 * M + k1], wi = -cw.im[n1 * M + k1];
            sr += xr[k1] * wr - xi[k1] * wi;
            si += xr[k1] * wi + xi[k1] * wr;
          }
        }
        const size_t o = (size_t)r * wk + c;
        dre[o] = sr;
        dim[o] = si;
      }
    }
  }
}

// Columns a block of the frame-parallel kernels holds: the most, up to 16
// (64-byte row segments), whose strip (2 H S floats) fits the 227 KB a
// block may have: 16 to H = 1024 (pow-2) or m = 14 (tight), 8 to 2048 or
// m = 28, 4 above.
static int cs_strip(int h) {
  const bool pow2 = (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  return pow2 ? (h <= 1024 ? 16 : h <= 2048 ? 8 : 4)
              : (m <= 14 ? 16 : m <= 28 ? 8 : 4);
}

template <class K, class... Args>
static cudaError_t cs_run(K kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const Args&... args) {
  const cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The two launches at a pow-2 height 2^NLOG on strips of S columns.
template <int NLOG, int S>
static cudaError_t cs_pow2(const ColspecIO& io, const PhaseArgs& pa,
                           bool general, cudaStream_t st) {
  const dim3 grid(io.wk / S, io.t * io.c);
  const size_t smem = 2 * ((size_t)S << NLOG) * sizeof(float);
  const int nt = PBMM_CB_THREADS;
  const CsCombine<1> none = {};
  cudaError_t err =
      cs_run(cs_fwd_pow2_kernel<NLOG, S>, grid, nt, smem, st, io);
  if (err != cudaSuccess) return err;
  return general ? cs_run(cs_inv_kernel<NLOG, S, 0, true>, grid, nt, smem,
                          st, io, pa, none)
                 : cs_run(cs_inv_kernel<NLOG, S, 0, false>, grid, nt, smem,
                          st, io, pa, none);
}

// The two launches at a tight height, m <= MAXM.
template <int S, int MAXM>
static cudaError_t cs_tight(const ColspecIO& io, const PhaseArgs& pa,
                            bool general, const float* cw_re,
                            const float* cw_im, cudaStream_t st) {
  const dim3 grid(io.wk / S, io.t * io.c);
  const size_t smem = 2 * (size_t)io.h * S * sizeof(float);
  const int nt = PBMM_CB_THREADS;
  const CsCombine<MAXM> cw =
      cs_combine<MAXM>(cw_re, cw_im, io.h / PBMM_LANE);
  cudaError_t err =
      cs_run(cs_fwd_tight_kernel<S, MAXM>, grid, nt, smem, st, io, cw);
  if (err != cudaSuccess) return err;
  return general ? cs_run(cs_inv_kernel<7, S, MAXM, true>, grid, nt, smem,
                          st, io, pa, cw)
                 : cs_run(cs_inv_kernel<7, S, MAXM, false>, grid, nt, smem,
                          st, io, pa, cw);
}

template <bool POW2, int S, int MAXM>
static cudaError_t cs_iir(const ColspecIO& io, const PhaseArgs& pa,
                          const float* cw_re, const float* cw_im,
                          cudaStream_t stream) {
  const size_t smem = 6 * (size_t)io.h * S * sizeof(float);
  const CsCombine<POW2 ? 1 : MAXM> cw =
      cs_combine<POW2 ? 1 : MAXM>(cw_re, cw_im, io.h / PBMM_LANE);
  return cs_run(colspec_iir_kernel<POW2, S, MAXM>, dim3(io.wk / S, io.c),
                256, smem, stream, io, pa, cw);
}

// iargs, fargs: the phase pass's branch and constants (host arrays,
// copied by value; phase_pass.cuh::pbmm_phase_unpack); cw_re / cw_im: the
// m x m combine (host arrays; null at pow-2 heights).  spec_re /
// spec_im: the scratch of the frame-parallel branches, (T C, H, Wk) each
// (null with the IIR taps).
extern "C" int pbmm_colspec_chunk(
    const float* rows_re, const float* rows_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* fs_re, const float* fs_im,
    const float* cw_re, const float* cw_im, const float* tw_fre,
    const float* tw_fim, const float* tw_ire, const float* tw_iim,
    float* spec_re, float* spec_im, float* out_re, float* out_im,
    float* np_re, float* np_im, float* lpf_out, float* lps_out,
    const int* iargs, const float* fargs, int t, int c, int hc, int h,
    int wk, int row0, int r0, int r1, void* stream) {
  PhaseArgs pa;
  const bool args_ok = pbmm_phase_unpack(iargs, fargs, pa);
  const bool pow2 = h >= 2 && (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  const bool general = pbmm_phase_general(pa);
  const bool tall = h > PBMM_COL_MAXH;
  // Strip widths of the frame-parallel kernels (cs_strip), multiples of
  // the IIR kernel's (4, 2 when tall).
  const int s = cs_strip(h);
  if (!args_ok || t < 1 || c < 1 || (long long)t * c > 65535 ||
      h > PBMM_COL_MAXH_TALL ||
      (!pow2 && (h != m * PBMM_LANE || m < 1)) || wk % s != 0 || hc < 1 ||
      row0 < 0 || row0 + hc > h || r0 < 0 || r1 <= r0 || r1 > h ||
      (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      (!pa.iir && (spec_re == nullptr || spec_im == nullptr)) ||
      // 16-byte copies of the frame-parallel kernels
      (!pa.iir && ((size_t)rows_re % 16 || (size_t)rows_im % 16 ||
                   (size_t)prev_re % 16 || (size_t)prev_im % 16 ||
                   (size_t)spec_re % 16 || (size_t)spec_im % 16)) ||
      (general && (fy == nullptr || fx == nullptr)) ||
      (!pow2 && (fs_re == nullptr || cw_re == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ColspecIO io = {rows_re, rows_im, prev_re, prev_im, lpf_in, lps_in,
                        plane0,  plane1,  fy,      fx,      fs_re,  fs_im,
                        tw_fre,  tw_fim,  tw_ire,  tw_iim,  spec_re, spec_im,
                        out_re,  out_im,  np_re,   np_im,   lpf_out, lps_out,
                        t,       c,       hc,      h,       wk,      row0,
                        r0,      r1};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (pa.iir) {
    // Four-step heights: m <= 16 at h <= 2048, m <= 32 at h <= 4096.
    err = pow2 ? (tall ? cs_iir<true, PBMM_COL_S_TALL, 16>(io, pa, cw_re,
                                                          cw_im, st)
                       : cs_iir<true, PBMM_COL_S, 16>(io, pa, cw_re, cw_im,
                                                      st))
               : (tall ? cs_iir<false, PBMM_COL_S_TALL, 32>(io, pa, cw_re,
                                                           cw_im, st)
                       : cs_iir<false, PBMM_COL_S, 16>(io, pa, cw_re, cw_im,
                                                       st));
    return (int)err;
  }
  if (!pow2) {
    err = m <= 14   ? cs_tight<16, 14>(io, pa, general, cw_re, cw_im, st)
          : m <= 28 ? cs_tight<8, 28>(io, pa, general, cw_re, cw_im, st)
                    : cs_tight<4, 32>(io, pa, general, cw_re, cw_im, st);
  } else {
    switch (h) {
#define CS_POW2(NLOG, S) \
  case 1 << NLOG: err = cs_pow2<NLOG, S>(io, pa, general, st); break;
      CS_POW2(1, 16) CS_POW2(2, 16) CS_POW2(3, 16) CS_POW2(4, 16)
      CS_POW2(5, 16) CS_POW2(6, 16) CS_POW2(7, 16) CS_POW2(8, 16)
      CS_POW2(9, 16) CS_POW2(10, 16) CS_POW2(11, 8) CS_POW2(12, 4)
#undef CS_POW2
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  // The last frame's spectrum of each plane is the next chunk's prev.
  const size_t plane = (size_t)h * wk, bytes = c * plane * sizeof(float);
  const size_t last = (size_t)(t - 1) * c * plane;
  err = cudaMemcpyAsync(np_re, spec_re + last, bytes,
                        cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(np_im, spec_im + last, bytes,
                          cudaMemcpyDeviceToDevice, st);
  return (int)err;
}
