// Shared helpers of the pbmm_tpu_torch kernels (plain C interface, built by
// kernels/build.py with nvcc for sm_90a; loaded with ctypes).
#pragma once

#include <cuda_runtime.h>

// Widest padded row the kernels take: 64 tiles of 128 lanes (W = 8192).
#define PBMM_MAX_TILES 64
#define PBMM_LANE 128
// Columns a block of the strip kernels (12 and kernel 2's IIR branch)
// holds in shared memory:
// 4 up to H = 2048, 2 above (PBMM_COL_S_TALL), up to H = 4096.
#define PBMM_COL_S 4
#define PBMM_COL_S_TALL 2
#define PBMM_COL_MAXH 2048       // tallest column at PBMM_COL_S
#define PBMM_COL_MAXH_TALL 4096  // tallest column at PBMM_COL_S_TALL
// Largest blur radius of the post kernels (3, 10, 11): post_pallas_ok
// admits 2 r <= ob - e with the output block ob <= 192, so r <= 96.
#define PBMM_MAX_BLUR_R 96

// Dynamic shared memory above 48 KB must be opted into per kernel; the
// H100 allows at most 227 KB (232,448 bytes) per block.
template <typename K>
static cudaError_t pbmm_smem_opt_in(K kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Bit reversal of a 7-bit index (position inside a 128-lane group).
__device__ __forceinline__ int pbmm_rev7(int q) {
  return (int)(__brev((unsigned)q) >> 25);
}

// One radix-2 butterfly stage over `groups` independent length-n
// sequences held in shared memory; element i of sequence g lies at
// (g / gdiv) * ghi + (g % gdiv) * glo + i * estride.
// Forward = decimation in frequency (natural in, bit-reversed out), with
// the twiddle of bottom position i1 from row `row` of the (log2 n, n)
// tables; inverse = decimation in time (bit-reversed in, natural out).
// Both match pbmm_tpu/spectral/pallas_fft.py::_fft_stages.
__device__ __forceinline__ void pbmm_radix2_stage(
    float* re, float* im, int n, int d, int groups, int gdiv, int ghi,
    int glo, int estride, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, bool inverse) {
  const int per = n >> 1;
  for (int b = threadIdx.x; b < per * groups; b += blockDim.x) {
    const int g = b / per;
    const int k = b - g * per;
    const int j = k & (d - 1);
    const int i0 = ((k - j) << 1) + j;
    const int i1 = i0 + d;
    const int gb = (g / gdiv) * ghi + (g % gdiv) * glo;
    const int a0 = gb + i0 * estride;
    const int a1 = gb + i1 * estride;
    const float tr = __ldg(tw_re + i1);
    const float ti = __ldg(tw_im + i1);
    const float xr = re[a0], xi = im[a0];
    const float ur = re[a1], ui = im[a1];
    // Products and sums round separately (no contraction into FMA), so
    // every kernel that inlines this stage computes the same bits.
    if (!inverse) {
      const float br = __fsub_rn(xr, ur), bi = __fsub_rn(xi, ui);
      re[a0] = __fadd_rn(xr, ur);
      im[a0] = __fadd_rn(xi, ui);
      re[a1] = __fsub_rn(__fmul_rn(br, tr), __fmul_rn(bi, ti));
      im[a1] = __fadd_rn(__fmul_rn(br, ti), __fmul_rn(bi, tr));
    } else {
      const float zr = __fsub_rn(__fmul_rn(ur, tr), __fmul_rn(ui, ti));
      const float zi = __fadd_rn(__fmul_rn(ur, ti), __fmul_rn(ui, tr));
      re[a0] = __fadd_rn(xr, zr);
      im[a0] = __fadd_rn(xi, zi);
      re[a1] = __fsub_rn(xr, zr);
      im[a1] = __fsub_rn(xi, zi);
    }
  }
}

// All log2(n) stages of a transform: the twiddle tables hold one row of n
// values per stage, in execution order (forward: d = n/2 .. 1; inverse:
// d = 1 .. n/2), as pbmm_tpu_torch/spectral/radix2.py::_dif_twiddles.
__device__ __forceinline__ void pbmm_radix2(
    float* re, float* im, int n, int groups, int gdiv, int ghi, int glo,
    int estride, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, bool inverse) {
  int stages = 0;
  while ((1 << stages) < n) ++stages;
  for (int s = 0; s < stages; ++s) {
    const int d = inverse ? (1 << s) : (n >> (s + 1));
    pbmm_radix2_stage(re, im, n, d, groups, gdiv, ghi, glo, estride,
                      tw_re + s * n, tw_im + s * n, inverse);
    __syncthreads();
  }
}

// Static Hermitian rebuild plan, per full 128-lane tile: the kept tile
// position feeding it, and 1 where it is conj(lane reversal) of that
// tile (spectral/hermitian.py::reconstruction_plan; identity when the
// lanes are not the kept half).  Passed by value.
struct PbmmLanePlan {
  int src[PBMM_MAX_TILES];
  int rev[PBMM_MAX_TILES];
};

// Zero-embed of a strip of S columns from col0 of an h-row column: rows
// [row0, row0 + hc) take the content rows' spectra (src, row stride wk),
// the others zeros; element (row p, column c) lands at p * S + c.  Ends
// synchronised.
template <int S>
__device__ __forceinline__ void pbmm_col_embed(
    const float* __restrict__ src_re, const float* __restrict__ src_im,
    int hc, int wk, int col0, int row0, int h, float* re, float* im) {
  for (int e = threadIdx.x; e < h * S; e += blockDim.x) {
    const int p = e / S, c = e % S;
    const int r = p - row0;
    float vr = 0.0f, vi = 0.0f;
    if (r >= 0 && r < hc) {
      const size_t g = (size_t)r * wk + col0 + c;
      vr = src_re[g];
      vi = src_im[g];
    }
    re[e] = vr;
    im[e] = vi;
  }
  __syncthreads();
}

// Kernel 2's forward column FFT at pow-2 heights h on a strip of S
// columns: the zero-embed, then a radix-2 DIF over the whole column
// (natural rows in, bit-reversed rows out: JAX's layout), every product
// and sum rounded separately.  Kernel 5 (col_pass.cuh's engine) runs the
// same butterflies in the same order and computes the same bits.
// tw_re/tw_im: _dif_twiddles(h, forward).  Ends synchronised.
template <int S>
__device__ __forceinline__ void pbmm_col_fft_pow2(
    const float* __restrict__ src_re, const float* __restrict__ src_im,
    int hc, int wk, int col0, int row0, int h, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, float* re, float* im) {
  pbmm_col_embed<S>(src_re, src_im, hc, wk, col0, row0, h, re, im);
  pbmm_radix2(re, im, h, S, S, 0, 1, S, tw_re, tw_im, false);
}
