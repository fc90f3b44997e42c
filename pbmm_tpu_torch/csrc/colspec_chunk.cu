// Kernel 2: column FFT + band/phase pass + column IFFT for a whole chunk,
// the previous frame's spectrum (and the IIR taps) carried on chip.
//
// Replaces pbmm_tpu/spectral/fused.py:1310 colspec_chunk (the Pallas
// kernel launched at :1518), every branch of it, as template parameters:
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
//            square-and-multiply (:986-1002), compiled as before;
//   IIR      the streaming band-pass taps lp_fast/lp_slow, two more
//            carried planes (fused.py:766 _iir_filter_delta).
// The planes of chroma="rgb" are the grid's y dimension: each plane's
// frame series carries its own prev spectrum and taps; the rows of the
// chunk are plane-minor, frame-major ([Y0 I0 Q0 Y1 ...]).
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
// The TPU grid (planes, lane strips, frames) runs frames in order and
// carries prev in VMEM scratch.  CUDA blocks run in no order, so each
// block owns a strip of S kept columns of one plane and loops over the T
// frames itself; cur and prev (4 x H x S f32) and the IIR taps (2 more
// planes) stay in shared memory for the whole chunk, and the two spectrum
// buffers swap roles each frame (the phase pass overwrites prev with the
// modified spectrum in place).  The strip width S and the four-step block
// bound MAXM are template parameters, two instantiations of each branch:
//   S = 4, MAXM = 16 up to H = 2048 (72 KB at H = 1152, 128 KB at 2048,
//     192 KB with the IIR taps): the 1080p paths;
//   S = 2, MAXM = 32 above, up to H = 4096 (128 KB at 4096, 192 KB with
//     the taps; tight heights to m = 32, 2160p's 2176 rows are m = 17).
// The strip width changes which thread holds a column, not the
// arithmetic of a column.
//
// The phase pass (every branch, and its transcendentals) lives in
// phase_pass.cuh, shared with kernel 6 (csrc/phase_col_ifft.cu).
//
// What bounds it on an H100: per frame and column it reads Hc content
// rows and writes r1 - r0 output rows (re+im), ~18 KB per column at
// 1080p, and computes ~H (m + 7) complex FMAs (tight) or 5 H log2(H)
// flops (pow-2) plus the phase chain; the chunk's HBM traffic is the
// kernel-1 output once plus the tail's input once.  Simple and right
// first.

#include "common.cuh"
#include "phase_pass.cuh"


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
  const float* cw_re;   // four-step combine, (m, m)
  const float* cw_im;
  const float* tw_fre;  // radix-2 tables: 128-point (tight) or H-point
  const float* tw_fim;
  const float* tw_ire;
  const float* tw_iim;
  float* out_re;
  float* out_im;
  float* np_re;
  float* np_im;
  float* lpf_out;
  float* lps_out;
  int t, c, hc, h, wk, row0, r0, r1;
};

// JAX row of block row p: identity at pow-2 heights, the in-block
// bit reversal of the four-step's 128-point factor otherwise.
template <bool POW2>
__device__ __forceinline__ int cs_row(int p) {
  return POW2 ? p : ((p & ~127) | pbmm_rev7(p & 127));
}

template <bool POW2, bool GENERAL, bool IIR, int CS_S, int CS_MAXM>
__global__ void __launch_bounds__(256)
    colspec_chunk_kernel(ColspecIO io, PhaseArgs pa) {
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
    if (IIR) {
      l_f[e] = io.lpf_in[g];
      l_s[e] = io.lps_in[g];
    }
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
              const float wr = __ldg(io.cw_re + k1 * m + n1);
              const float wi = __ldg(io.cw_im + k1 * m + n1);
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
      pbmm_phase_bin<GENERAL, IIR>(cr, ci, pr, pi, io.plane0, io.plane1, g,
                                   io.fy, P, io.fx, col0 + c, l_f + e,
                                   l_s + e, pa, o_r, o_i);
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
              const float wr = __ldg(io.cw_re + n1 * m + k1);
              const float wi = -__ldg(io.cw_im + n1 * m + k1);
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
    if (IIR) {
      io.lpf_out[g] = l_f[e];
      io.lps_out[g] = l_s[e];
    }
  }
}

template <bool POW2, bool GENERAL, bool IIR, int S, int MAXM>
static cudaError_t cs_launch(const ColspecIO& io, const PhaseArgs& pa,
                             cudaStream_t stream) {
  const size_t smem = (IIR ? 6 : 4) * (size_t)io.h * S * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(
      colspec_chunk_kernel<POW2, GENERAL, IIR, S, MAXM>, smem);
  if (err != cudaSuccess) return err;
  colspec_chunk_kernel<POW2, GENERAL, IIR, S, MAXM>
      <<<dim3(io.wk / S, io.c), 256, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

// The phase branch of one (height class, strip) instantiation.
template <bool POW2, int S, int MAXM>
static cudaError_t cs_branch(const ColspecIO& io, const PhaseArgs& pa,
                             bool general, cudaStream_t stream) {
  return pa.iir   ? cs_launch<POW2, true, true, S, MAXM>(io, pa, stream)
         : general ? cs_launch<POW2, true, false, S, MAXM>(io, pa, stream)
                   : cs_launch<POW2, false, false, S, MAXM>(io, pa, stream);
}

// iargs, fargs: the phase pass's branch and constants (host arrays,
// copied by value; phase_pass.cuh::pbmm_phase_unpack).
extern "C" int pbmm_colspec_chunk(
    const float* rows_re, const float* rows_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* fs_re, const float* fs_im,
    const float* cw_re, const float* cw_im, const float* tw_fre,
    const float* tw_fim, const float* tw_ire, const float* tw_iim,
    float* out_re, float* out_im, float* np_re, float* np_im,
    float* lpf_out, float* lps_out, const int* iargs, const float* fargs,
    int t, int c, int hc, int h, int wk, int row0, int r0, int r1,
    void* stream) {
  PhaseArgs pa;
  const bool args_ok = pbmm_phase_unpack(iargs, fargs, pa);
  const bool pow2 = h >= 2 && (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  const bool general = pbmm_phase_general(pa);
  const bool tall = h > PBMM_COL_MAXH;  // the S = 2 instantiations
  const int s = tall ? PBMM_COL_S_TALL : PBMM_COL_S;
  if (!args_ok || t < 1 || c < 1 || h > PBMM_COL_MAXH_TALL ||
      (!pow2 && (h != m * PBMM_LANE || m < 1)) || wk % s != 0 || hc < 1 ||
      row0 < 0 || row0 + hc > h || r0 < 0 || r1 <= r0 || r1 > h ||
      (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      (general && (fy == nullptr || fx == nullptr)) ||
      (!pow2 && (fs_re == nullptr || cw_re == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ColspecIO io = {rows_re, rows_im, prev_re, prev_im, lpf_in, lps_in,
                        plane0, plane1, fy, fx, fs_re, fs_im, cw_re, cw_im,
                        tw_fre, tw_fim, tw_ire, tw_iim, out_re, out_im,
                        np_re, np_im, lpf_out, lps_out, t, c, hc, h, wk,
                        row0, r0, r1};
  cudaStream_t st = (cudaStream_t)stream;
  // Four-step heights: m <= 16 at h <= 2048, m <= 32 at h <= 4096.
  const cudaError_t err =
      pow2 ? (tall ? cs_branch<true, PBMM_COL_S_TALL, 16>(io, pa, general, st)
                   : cs_branch<true, PBMM_COL_S, 16>(io, pa, general, st))
           : (tall ? cs_branch<false, PBMM_COL_S_TALL, 32>(io, pa, general, st)
                   : cs_branch<false, PBMM_COL_S, 16>(io, pa, general, st));
  return (int)err;
}
