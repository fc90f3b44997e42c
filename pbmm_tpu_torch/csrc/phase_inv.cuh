// The phase pass and pow-2 inverse of one frame's strip of columns, the
// body kernel 2's launch 2 (csrc/colspec_chunk.cu::cs_inv_kernel) and
// kernel 6 (csrc/phase_col_ifft.cu) both run, so that on the same spectra
// kernel 6's rows are kernel 2's bit for bit by construction.
//
// A block owns a strip of S neighbouring columns of one frame in shared
// memory (col_pass.cuh's swizzled layout, 2 x H x S floats).  The phase
// pass reads cur and prev element by element from device memory (the
// frame's planes, 16- to 64-byte row segments a warp) and writes the
// modified spectrum into the strip; the inverse runs as col_pass.cuh's
// in-block register passes (up to four radix-2 stages a pass, one barrier
// a pass boundary, the compact twiddle table), and the last pass writes
// rows [r0, r0 + hr) straight to device memory.
#pragma once

#include "col_pass.cuh"
#include "phase_pass.cuh"

// JAX row of block row p: identity at pow-2 heights, the in-block
// bit reversal of the four-step's 128-point factor otherwise.
template <bool POW2>
__device__ __forceinline__ int cs_row(int p) {
  return POW2 ? p : ((p & ~127) | pbmm_rev7(p & 127));
}

// The phase pass of one frame into the strip (sre, sim): cur (cur_re,
// cur_im) against prev at every bin of the h x S strip from column col0,
// planes of row stride wk; the host planes, fy and fx are shared by the
// frames (element P wk + col0 + c).  With IIR the taps of each bin are read
// from lpf_in / lps_in, updated in registers and written to lpf_out /
// lps_out (the frame's planes, same layout).  The loop stays one
// pbmm_phase_bin an iteration: staging cur and prev through shared memory,
// or loading a few elements ahead of their arithmetic, measured slower in
// kernel 2, and the latter also changed how nvcc contracts the main
// branch's products.  Without PHASE (kernel 12's probe) the strip takes
// cur + prev instead, at the same words.  Ends synchronised.
template <int S, bool POW2, bool GENERAL, bool IIR, bool PHASE = true>
__device__ __forceinline__ void pbmm_phase_strip(
    const float* cur_re, const float* cur_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    float* lpf_out, float* lps_out,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const PhaseArgs& pa, int h, size_t wk, int col0,
    float* sre, float* sim) {
  constexpr int LS = pbmm_log2(S);
  for (int e = threadIdx.x; e < h * S; e += blockDim.x) {
    const int p = e >> LS, c = e & (S - 1);
    const int P = cs_row<POW2>(p);
    const size_t g = (size_t)P * wk + col0 + c;
    float lf = 0.0f, ls = 0.0f;
    if (IIR) {
      lf = __ldg(lpf_in + g);
      ls = __ldg(lps_in + g);
    }
    float o_r, o_i;
    if constexpr (PHASE) {
      pbmm_phase_bin<GENERAL, IIR>(__ldg(cur_re + g), __ldg(cur_im + g),
                                   __ldg(prev_re + g), __ldg(prev_im + g),
                                   plane0, plane1, g, fy, P, fx, col0 + c,
                                   IIR ? &lf : nullptr, IIR ? &ls : nullptr,
                                   pa, o_r, o_i);
    } else {
      o_r = __fadd_rn(__ldg(cur_re + g), __ldg(prev_re + g));
      o_i = __fadd_rn(__ldg(cur_im + g), __ldg(prev_im + g));
    }
    if (IIR) {
      lpf_out[g] = lf;
      lps_out[g] = ls;
    }
    const int i = pbmm_cb_idx<S>(p, c);
    sre[i] = o_r;
    sim[i] = o_i;
  }
  __syncthreads();
}

// The radix-2 DIT inverse of the strip at a pow-2 height 2^NLOG
// (bit-reversed rows in, natural rows out, unnormalised; tw: the compact
// table compact_twiddles(2^NLOG, inverse)), rows [r0, r0 + hr) of the
// strip's columns to dre / dim (row stride wk, the strip's first column).
// Stages [SB, SE) only, for kernel 12: the whole inverse by default.
// Every thread of the block calls it.
template <int NLOG, int S, int SB = 0, int SE = NLOG>
__device__ __forceinline__ void pbmm_inv_rows_pow2(
    float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, float* __restrict__ dre,
    float* __restrict__ dim, size_t wk, int r0, int hr) {
  auto read = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    pbmm_cb_read(gr, xr, xi, sre, sim);
  };
  auto last = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                  const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      const int r = gr.pos(q) - r0;
      if ((unsigned)r < (unsigned)hr) {
        const size_t o = (size_t)r * wk + gr.c;
        dre[o] = xr[q];
        dim[o] = xi[q];
      }
    }
  };
  pbmm_cb_transform<NLOG, S, true, SB, SE>(1, sre, sim, tw_re, tw_im, read,
                                          last);
}
