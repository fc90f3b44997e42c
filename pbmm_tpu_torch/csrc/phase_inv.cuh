// The phase pass and pow-2 inverse of one frame's strip of columns, the
// body kernel 2's launch 2 (csrc/colspec_chunk.cu::cs_inv_kernel and, above
// m = 64, cs_inv_blocks_kernel), kernel 6 (csrc/phase_col_ifft.cu) and
// kernel 12 (csrc/kdecomp.cu) run, so that on the same spectra kernel 6's
// rows are kernel 2's bit for bit by construction.
//
// A block owns a strip of S neighbouring columns of one frame in shared
// memory (col_pass.cuh's swizzled layout, 2 x H x S floats).  The phase
// pass brings cur and prev in and writes the modified spectrum into the
// strip; the inverse runs as col_pass.cuh's in-block register passes (up
// to four radix-2 stages a pass, one barrier a pass boundary, the compact
// twiddle table), and the last pass writes rows [r0, r0 + hr) straight to
// device memory.
//
// The main branch's phase pass (and kernel 12's stream) on strips of 4
// columns and more (16-byte row words): a thread owns words t, t + T, ...
// of the strip (T threads; word w is row w / (S / 4), columns
// 4 (w mod S / 4) ..).  It copies each word of cur straight into its strip
// slot, and the same word of prev and of the two host planes into a ring
// of its own past the strip, by asynchronous 16-byte copies, one cp.async
// group a word, `a` words ahead of the one it computes.  So the loads of
// later words overlap the phase arithmetic of this one, which reads its
// four bins' operands from shared memory a word at a time, runs the main
// branch once a bin (the four bins unrolled), writes the result over
// cur's slot and then sends the copies of word k + a into the ring slot it
// freed.  No barrier until the end: each thread reads only what it
// copied.  The ring's depth comes from the dynamic shared memory the
// launch was given past the strip (pbmm_ps_smem: up to PBMM_PS_MAXD slots
// of 64 bytes a thread, 32 for the stream's prev alone, in what the strip
// leaves a block without lowering the blocks an SM holds).  With no room
// for a slot (tight m = 13-14 on 16 columns and 25-28 on 8, pow-2 H =
// 256-512) cur alone takes the asynchronous copies, PBMM_PS_MAXD words
// ahead, and prev and the planes come from device memory a word and a bin
// at a time.
// Why, on an NVIDIA H100 80GB HBM3 at its 700 W limit: the element loads
// (four scalar planes a bin, one 512-thread block an SM) kept too few
// bytes in flight, and kernel 12's stream took 63 % of launch 2 at 1.55
// TB/s.  Staging through shared memory by scalar copies measured slower;
// asynchronous 16-byte copies of cur and prev alone moved the stream to
// 2.3 TB/s but not the launch, each bin then waiting on its own
// host-plane loads from L2, a round trip a bin.  With the planes in the
// ring too, kernel 6 on 16 frames at H = 2048 takes 0.563 ms against
// 0.823, kernel 2's 1080p tight chunk 0.702 against 0.835
// (tools/kdecomp.py and kexp.timed).
// The general pass keeps the element loads: each thread reads its bin's
// cur and prev (and the planes, frequencies and IIR taps the branch reads)
// from device memory.  Its per-bin loads serialise in a word's rolled loop
// of four bins: on the asynchronous strip kernel 6 with the IIR taps took
// 1.649 ms against 1.016 and kernel 2's steerable chunk 1.052 against
// 1.021.  So do strips of 2 and 1 columns (H = 8192, tight m = 33-63,
// kernel 6's narrow strips), whose row words are 8 bytes or less.
#pragma once

#include <cuda_pipeline.h>

#include "col_pass.cuh"
#include "phase_pass.cuh"

#define PBMM_PS_MAXD 4       // words a thread's ring (or cur alone) runs ahead
#define PBMM_SM_SMEM 233472  // an SM's shared memory (228 KB)
#define PBMM_SMEM_BLOCK 232448  // the most one block may have (227 KB)
#define PBMM_SMEM_RESERVE 1024  // the card reserves per block

// JAX row of block row p: identity at pow-2 heights, the in-block
// bit reversal of the four-step's 128-point factor otherwise.
template <bool POW2>
__device__ __forceinline__ int cs_row(int p) {
  return POW2 ? p : ((p & ~127) | pbmm_rev7(p & 127));
}

// Whether the phase strip on strips of s columns, `words` ring words a
// thread (pbmm_ps_words), brings its operands in by asynchronous copies;
// else it keeps the element loads.  Kernel 2's C entry reports it for
// launch 2 (spectral/fused.py::colspec_staged mirrors it).
__host__ __device__ constexpr bool pbmm_ps_async(int s, int words) {
  return s >= 4 && words > 0;
}

// Dynamic shared memory of a launch of the phase strip at height h on
// strips of s columns, `threads` a block: the strip (2 h s floats) and, on
// strips of 4 and more, the ring: up to PBMM_PS_MAXD slots of a thread's
// `words` 16-byte words (4 on the main branch: prev and the two host
// planes; 2 for kernel 12's stream: prev; 0 for the general pass, which
// keeps the element loads), in the room the strip leaves one block without
// lowering the blocks an SM the strip's shared memory allows (at most
// 2048 threads an SM).  spectral/fused.py::phase_strip_smem mirrors it.
__host__ __device__ constexpr int pbmm_ps_smem(int h, int s, int threads,
                                               int words) {
  const int strip = 8 * h * s, slot = 16 * words * threads;
  const int by_threads = 2048 / threads;
  const int by_smem = PBMM_SM_SMEM / (strip + PBMM_SMEM_RESERVE);
  const int nb = by_smem < by_threads ? by_smem : by_threads;
  const int share = PBMM_SM_SMEM / (nb > 0 ? nb : 1) - PBMM_SMEM_RESERVE;
  const int top = share < PBMM_SMEM_BLOCK ? share : PBMM_SMEM_BLOCK;
  const int room = top > strip ? top - strip : 0;
  if (!pbmm_ps_async(s, words)) return strip;
  const int d = room / slot < PBMM_PS_MAXD ? room / slot : PBMM_PS_MAXD;
  return strip + d * slot;
}

// A thread's words a ring slot of the phase strip: the main branch's
// prev and host planes, the stream's prev, none on the general pass.
__host__ __device__ constexpr int pbmm_ps_words(bool phase, bool general) {
  return general ? 0 : phase ? 4 : 2;
}

// The launch's dynamic shared memory in bytes.
__device__ __forceinline__ int pbmm_dyn_smem() {
  unsigned b;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(b));
  return (int)b;
}

// Wait until at most n (< PBMM_PS_MAXD) of the thread's newest cp.async
// groups are pending: wait_group takes its count as an immediate.
__device__ __forceinline__ void pbmm_ps_wait(int n) {
  static_assert(PBMM_PS_MAXD == 4, "one case a count below PBMM_PS_MAXD");
  switch (n) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    default: __pipeline_wait_prior(3); break;
  }
}

// Element q (< 4) of a word, and the word with element q set.
__device__ __forceinline__ float pbmm_ps_get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void pbmm_ps_set(float4& v, int q, float x) {
  v.x = q == 0 ? x : v.x;
  v.y = q == 1 ? x : v.y;
  v.z = q == 2 ? x : v.z;
  v.w = q == 3 ? x : v.w;
}

// The phase pass of one frame into the strip (sre, sim; sim = sre + h S,
// the ring after it): cur (cur_re, cur_im) against prev at every bin of
// the h x S strip from column col0, planes of row stride wk; the host
// planes, fy and fx are shared by the frames (element P wk + col0 + c).
// With IIR the taps of each bin are read from lpf_in / lps_in, updated in
// registers and written to lpf_out / lps_out (the frame's planes, same
// layout).  Without PHASE (kernel 12's probe) the strip takes cur + prev
// instead, at the same words.  On the main branch and the stream, on
// strips of 4 and more, cur and prev (and the host planes) start on 16
// bytes, wk is a multiple of 4, and the launch's dynamic shared memory is
// pbmm_ps_smem's with pbmm_ps_words(PHASE, GENERAL).  Ends synchronised.
template <int S, bool POW2, bool GENERAL, bool IIR, bool PHASE = true>
__device__ __forceinline__ void pbmm_phase_strip(
    const float* cur_re, const float* cur_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    float* lpf_out, float* lps_out,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const PhaseArgs& pa, int h, size_t wk, int col0,
    float* sre, float* sim) {
  constexpr int NW = pbmm_ps_words(PHASE, GENERAL);
  if constexpr (pbmm_ps_async(S, NW)) {
    static_assert(!IIR, "the IIR taps run the general pass");
    constexpr int LV = pbmm_log2(S / 4);  // 16-byte words a row: 2^LV
    const int nt = blockDim.x, t = threadIdx.x;
    const int nw = h << LV;  // words of a plane's strip
    const int kw = t < nw ? (nw - t + nt - 1) / nt : 0;  // this thread's
    const int room = pbmm_dyn_smem() - 8 * h * S;
    const int d = room > 0 ? min(room / (16 * NW * nt), PBMM_PS_MAXD) : 0;
    const int a = d > 0 ? d : PBMM_PS_MAXD;  // words in flight ahead
    // Slot j of the ring: word u (prev re, prev im, plane0, plane1) of
    // thread t at 4 (NW j + u) nt + 4 t.
    float* ring = sim + h * S;
    auto slot = [&](int k) { return ring + 4 * (NW * (k % d) * nt + t); };
    auto word = [&](int k, int& p, int& c, size_t& g) {
      const int w = t + k * nt;
      p = w >> LV;
      c = (w & ((1 << LV) - 1)) * 4;
      g = (size_t)cs_row<POW2>(p) * wk + col0 + c;
    };
    auto fetch = [&](int k) {  // word k's copies, one group (maybe empty)
      if (k < kw) {
        int p, c;
        size_t g;
        word(k, p, c, g);
        const int i = pbmm_cb_idx<S>(p, c);
        pbmm_cp_async<16>(sre + i, cur_re + g);
        pbmm_cp_async<16>(sim + i, cur_im + g);
        if (d > 0) {
          float* r = slot(k);
          pbmm_cp_async<16>(r, prev_re + g);
          pbmm_cp_async<16>(r + 4 * nt, prev_im + g);
          if (PHASE) {
            pbmm_cp_async<16>(r + 8 * nt, plane0 + g);
            pbmm_cp_async<16>(r + 12 * nt, plane1 + g);
          }
        }
      }
      __pipeline_commit();
    };
    for (int k = 0; k < a; ++k) fetch(k);
    for (int k = 0; k < kw; ++k) {
      pbmm_ps_wait(a - 1);  // word k's group has landed
      int p, c;
      size_t g;
      word(k, p, c, g);
      const int i = pbmm_cb_idx<S>(p, c);
      const float4 c_r = *reinterpret_cast<const float4*>(sre + i);
      const float4 c_i = *reinterpret_cast<const float4*>(sim + i);
      float4 p_r, p_i, tot = {}, mk = {};
      if (d > 0) {
        const float* r = slot(k);
        p_r = *reinterpret_cast<const float4*>(r);
        p_i = *reinterpret_cast<const float4*>(r + 4 * nt);
        if (PHASE) {
          tot = *reinterpret_cast<const float4*>(r + 8 * nt);
          mk = *reinterpret_cast<const float4*>(r + 12 * nt);
        }
      } else {
        p_r = __ldg(reinterpret_cast<const float4*>(prev_re + g));
        p_i = __ldg(reinterpret_cast<const float4*>(prev_im + g));
      }
      float4 o_r4 = c_r, o_i4 = c_i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float cr = pbmm_ps_get(c_r, q), ci = pbmm_ps_get(c_i, q);
        const float pr = pbmm_ps_get(p_r, q), pi = pbmm_ps_get(p_i, q);
        float o_r, o_i;
        if constexpr (!PHASE) {
          o_r = __fadd_rn(cr, pr);
          o_i = __fadd_rn(ci, pi);
        } else if (d > 0) {
          cs_phase_main(
              cr, ci, pr, pi, [&] { return pbmm_ps_get(mk, q); },
              [&] { return pbmm_ps_get(tot, q); }, pa, o_r, o_i);
        } else {
          cs_phase_main(
              cr, ci, pr, pi, [&] { return __ldg(plane1 + g + q); },
              [&] { return __ldg(plane0 + g + q); }, pa, o_r, o_i);
        }
        pbmm_ps_set(o_r4, q, o_r);
        pbmm_ps_set(o_i4, q, o_i);
      }
      *reinterpret_cast<float4*>(sre + i) = o_r4;
      *reinterpret_cast<float4*>(sim + i) = o_i4;
      fetch(k + a);  // into the ring slot word k has freed
    }
  } else {
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
