// Shared helpers of the pbmm_tpu_torch kernels (plain C interface, built by
// kernels/build.py with nvcc for sm_90a; loaded with ctypes).
#pragma once

#include <cuda_runtime.h>

// Tiles of 128 lanes in the longest row one block of the row engine holds
// (W = 8192; longer rows are bracketed, col_pass.cuh; kernel 3 keeps its
// whole row and ring in one block, so rowifft_post_fused routes longer
// rows to kernels 7 + 10).
#define PBMM_MAX_TILES 64
#define PBMM_LANE 128

// The narrowest strip of kernels 6 and 12: 4 up to H = 2048, 2 up to
// 4096, 1 up to 8192 (spectral/fused.py::col_strip; taller columns are
// bracketed, each 8192-row block on strips of 1).
__host__ __device__ constexpr int pbmm_col_strip(int h) {
  return h <= 2048 ? 4 : h <= 4096 ? 2 : 1;
}
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

// One asynchronous copy of BYTES (4, 8 or 16) from device memory into
// shared memory, both addresses aligned to BYTES: 16 bytes bypass L1
// (cp.async.cg), narrower copies go through it (only .ca takes them).
// Completes under cp.async.commit_group / wait_group (cuda_pipeline.h's
// __pipeline_commit / __pipeline_wait_prior).
template <int BYTES>
__device__ __forceinline__ void pbmm_cp_async(float* smem,
                                              const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
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

