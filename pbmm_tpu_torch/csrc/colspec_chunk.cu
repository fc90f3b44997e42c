// Kernel 2 of the main path: column FFT + band/phase pass + column IFFT
// for a whole chunk, the previous frame's spectrum carried on chip.
//
// Replaces pbmm_tpu/spectral/fused.py:1310 colspec_chunk (the Pallas
// kernel launched at :1518) on the branch the main path takes: tight
// height H = m * 128 (four-step column transform, fused.py:471
// _fourstep_col), host-precomputed (total, m_amp) planes, integer phase
// scale (square-and-multiply rotation, fused.py:986-1002), two-frame
// temporal mode, one plane (y_only).
//
// Layout contract (identical to the JAX kernel so spectra and carried
// state compare element by element): the forward transform takes natural
// rows to the "fourstep" layout, where row p = 128 k1 + k2 holds
// frequency k1 + m k2; the inverse takes fourstep back to natural rows,
// unnormalised.  Inside the block the 128-point factor runs as radix-2
// DIF, so the block's own row order is 128 k1 + q <-> frequency
// k1 + m rev7(q); the prev spectrum, the planes and new_prev are read and
// written through that permutation, and the DIT inverse undoes it.
//
// The TPU grid (planes, lane strips, frames) runs frames in order and
// carries prev in VMEM scratch.  CUDA blocks run in no order, so each
// block owns a strip of S = 4 kept columns and loops over the T frames
// itself; cur and prev (4 x H x S f32 = 72 KB at H = 1152) stay in shared
// memory for the whole chunk, and the two buffers swap roles each frame
// (the phase pass overwrites prev with the modified spectrum in place).
//
// What bounds it on an H100: per frame and column it reads Hc content
// rows and writes r1 - r0 output rows (re+im), ~18 KB per column at
// 1080p, and computes ~H (m + 7) complex FMAs plus the phase chain; the
// chunk's HBM traffic is the k1 output once plus the k3 input once.
// Narrow strips give 288 blocks at Wk = 1152; at 96 registers x 256
// threads two fit on an SM, so the chunk takes slightly more than one
// wave, and each load moves 16-byte row segments.  Simple and right
// first.

#include "common.cuh"

#define CS_S 4       // kept columns per block
#define CS_MAXM 16   // largest four-step block count (H <= 2048)

__global__ void colspec_chunk_kernel(
    const float* __restrict__ rows_re, const float* __restrict__ rows_im,
    const float* __restrict__ prev_re, const float* __restrict__ prev_im,
    const float* __restrict__ total, const float* __restrict__ m_amp,
    const float* __restrict__ fs_re, const float* __restrict__ fs_im,
    const float* __restrict__ cw_re, const float* __restrict__ cw_im,
    const float* __restrict__ dft_fre, const float* __restrict__ dft_fim,
    const float* __restrict__ dft_ire, const float* __restrict__ dft_iim,
    float* __restrict__ out_re, float* __restrict__ out_im,
    float* __restrict__ np_re, float* __restrict__ np_im, int t, int hc,
    int h, int wk, int row0, int r0, int r1, float tau2, int power) {
  extern __shared__ float smem[];
  const int hs = h * CS_S;
  float* a_re = smem;          // current frame
  float* a_im = smem + hs;
  float* b_re = smem + 2 * hs;  // previous frame, then the modified one
  float* b_im = smem + 3 * hs;
  const int m = h / PBMM_LANE;
  const int col0 = blockIdx.x * CS_S;
  const int nt = blockDim.x;

  // Carried spectrum in: JAX fourstep row P -> block row 128 k1 + q.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const int P = (p & ~127) | pbmm_rev7(p & 127);
    const size_t g = (size_t)P * wk + col0 + c;
    b_re[e] = prev_re[g];
    b_im[e] = prev_im[g];
  }

  for (int f = 0; f < t; ++f) {
    // 1. Zero-embed the content rows at row0.
    const size_t fbase = (size_t)f * hc * wk;
    for (int e = threadIdx.x; e < hs; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const int r = p - row0;
      float vr = 0.0f, vi = 0.0f;
      if (r >= 0 && r < hc) {
        const size_t g = fbase + (size_t)r * wk + col0 + c;
        vr = rows_re[g];
        vi = rows_im[g];
      }
      a_re[e] = vr;
      a_im[e] = vi;
    }
    __syncthreads();

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
            const float wr = __ldg(cw_re + k1 * m + n1);
            const float wi = __ldg(cw_im + k1 * m + n1);
            sr += xr[n1] * wr - xi[n1] * wi;
            si += xr[n1] * wi + xi[n1] * wr;
          }
        }
        const int p = k1 * PBMM_LANE + n2;
        const float tr = __ldg(fs_re + p), ti = __ldg(fs_im + p);
        a_re[p * CS_S + c] = sr * tr - si * ti;
        a_im[p * CS_S + c] = sr * ti + si * tr;
      }
    }
    __syncthreads();

    // 3. 128-point DIF per block: m * S sequences, sequence (k1, c) at
    //    row 128 k1, column c, element stride S.
    pbmm_radix2(a_re, a_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S, 1,
                CS_S, dft_fre, dft_fim, false);

    // 4. Phase pass against prev; the result replaces prev in place.
    for (int e = threadIdx.x; e < hs; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const int P = (p & ~127) | pbmm_rev7(p & 127);
      const size_t g = (size_t)P * wk + col0 + c;
      const float cr = a_re[e], ci = a_im[e];
      const float pr = b_re[e], pi = b_im[e];
      const float rr = pr * cr + pi * ci;  // prev * conj(cur)
      const float ri = pi * cr - pr * ci;
      const float min_mag2 = fminf(cr * cr + ci * ci, pr * pr + pi * pi);
      const float mk = __ldg(m_amp + g);
      const float tot = __ldg(total + g);
      const float amped = (min_mag2 * (mk * mk) >= tau2) ? mk : 0.0f;
      const float m2 = rr * rr + ri * ri;
      // 1e-38 is subnormal: built without -ftz so it survives.
      const float inv = m2 > 0.0f ? 1.0f / sqrtf(fmaxf(m2, 1e-38f)) : 0.0f;
      float br = rr * inv, bi = ri * inv;
      float qr = 1.0f, qi = 0.0f;
      for (int n = power; n > 0; n >>= 1) {
        if (n & 1) {
          const float tr = qr * br - qi * bi;
          qi = qr * bi + qi * br;
          qr = tr;
        }
        const float sr = br * br - bi * bi;
        bi = 2.0f * br * bi;
        br = sr;
      }
      const float gr = (tot - amped) + amped * qr;
      const float gi = amped * qi;
      b_re[e] = cr * gr - ci * gi;
      b_im[e] = cr * gi + ci * gr;
    }
    __syncthreads();

    // 5. Inverse: 128-point DIT per block, conj twiddle, conj combine.
    pbmm_radix2(b_re, b_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S, 1,
                CS_S, dft_ire, dft_iim, true);
    for (int it = threadIdx.x; it < PBMM_LANE * CS_S; it += nt) {
      const int n2 = it / CS_S, c = it % CS_S;
      float xr[CS_MAXM], xi[CS_MAXM];
#pragma unroll
      for (int k1 = 0; k1 < CS_MAXM; ++k1) {
        if (k1 < m) {
          const int p = k1 * PBMM_LANE + n2;
          const float zr = b_re[p * CS_S + c], zi = b_im[p * CS_S + c];
          const float tr = __ldg(fs_re + p), ti = -__ldg(fs_im + p);
          xr[k1] = zr * tr - zi * ti;
          xi[k1] = zr * ti + zi * tr;
        }
      }
      for (int n1 = 0; n1 < m; ++n1) {
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int k1 = 0; k1 < CS_MAXM; ++k1) {
          if (k1 < m) {
            const float wr = __ldg(cw_re + n1 * m + k1);
            const float wi = -__ldg(cw_im + n1 * m + k1);
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

    // 6. Rows [r0, r1) of the inverse out.
    const int hr = r1 - r0;
    const size_t obase = (size_t)f * hr * wk;
    for (int e = threadIdx.x; e < hr * CS_S; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const size_t g = obase + (size_t)p * wk + col0 + c;
      out_re[g] = b_re[(p + r0) * CS_S + c];
      out_im[g] = b_im[(p + r0) * CS_S + c];
    }
    __syncthreads();

    // This frame's spectrum is the next frame's prev.
    float* sw;
    sw = a_re; a_re = b_re; b_re = sw;
    sw = a_im; a_im = b_im; b_im = sw;
  }

  // The last frame's spectrum leaves as new_prev (now in b after the swap).
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const int P = (p & ~127) | pbmm_rev7(p & 127);
    const size_t g = (size_t)P * wk + col0 + c;
    np_re[g] = b_re[e];
    np_im[g] = b_im[e];
  }
}

extern "C" int pbmm_colspec_chunk(
    const float* rows_re, const float* rows_im, const float* prev_re,
    const float* prev_im, const float* total, const float* m_amp,
    const float* fs_re, const float* fs_im, const float* cw_re,
    const float* cw_im, const float* dft_fre, const float* dft_fim,
    const float* dft_ire, const float* dft_iim, float* out_re, float* out_im,
    float* np_re, float* np_im, int t, int hc, int h, int wk, int row0,
    int r0, int r1, float tau2, int power, void* stream) {
  const int m = h / PBMM_LANE;
  if (t < 1 || h != m * PBMM_LANE || m < 1 || m > CS_MAXM ||
      wk % CS_S != 0 || hc < 1 || row0 < 0 || row0 + hc > h || r0 < 0 ||
      r1 <= r0 || r1 > h || power < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)h * CS_S * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(colspec_chunk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  colspec_chunk_kernel<<<wk / CS_S, 256, smem, (cudaStream_t)stream>>>(
      rows_re, rows_im, prev_re, prev_im, total, m_amp, fs_re, fs_im, cw_re,
      cw_im, dft_fre, dft_fim, dft_ire, dft_iim, out_re, out_im, np_re,
      np_im, t, hc, h, wk, row0, r0, r1, tau2, power);
  return (int)cudaGetLastError();
}
