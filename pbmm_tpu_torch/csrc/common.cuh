// Shared helpers of the pbmm_tpu_torch kernels (plain C interface, built by
// kernels/build.py with nvcc for sm_90a; loaded with ctypes).
#pragma once

#include <cuda_runtime.h>

// Widest padded row the kernels take: 64 tiles of 128 lanes (W = 8192).
#define PBMM_MAX_TILES 64
#define PBMM_LANE 128

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
    if (!inverse) {
      const float br = xr - ur, bi = xi - ui;
      re[a0] = xr + ur;
      im[a0] = xi + ui;
      re[a1] = br * tr - bi * ti;
      im[a1] = br * ti + bi * tr;
    } else {
      const float zr = ur * tr - ui * ti;
      const float zi = ur * ti + ui * tr;
      re[a0] = xr + zr;
      im[a0] = xi + zi;
      re[a1] = xr - zr;
      im[a1] = xi - zi;
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
