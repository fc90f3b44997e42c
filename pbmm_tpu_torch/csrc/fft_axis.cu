// Kernel 8: a radix-2 FFT along one axis of (B, H, W) f32 planes, every
// stage in one pass over shared memory.
//
// Replaces pbmm_tpu/spectral/pallas_fft.py:405 _fft_axis (the Pallas
// kernel launched at :464), reached through fft2_bitrev / ifft2_bitrev
// (:486, :495): the unfused fft_backend="pallas" path's inverse
// (engine/pipeline.py::reconstruct).  The layout contract is the JAX
// one: the forward transform is decimation in frequency (natural order
// in, bit-reversed out), with a first stage that reads no imaginary plane
// when the input is real; the inverse is decimation in time (bit-reversed
// in, natural out), unnormalised but for `scale`, which multiplies the
// output.  The TPU kernel runs the 7 innermost stages as one 128 x 128
// MXU group matmul with a 3-pass bf16 split, a way around the TPU's
// matmul precision; here every stage is common.cuh's f32 butterfly, as in
// kernels 2, 5 and 7, each product and sum rounded on its own.
//
// Design: axis 2 (rows of W): one block per row holds the row (2 W f32,
// 16 KB at W = 2048).  Axis 1 (columns of H): a block holds a strip of S
// columns, S = 8 up to H = 2048 (128 KB; 32 bytes of each row, one
// sector), fewer above; a ragged last strip is masked.
//
// What bounds it on an H100: it reads 1 (real) or 2 planes and writes 2,
// once each, against 5 n log2(n) flops per length-n transform: ~3.4
// flops per byte at n = 2048, far under the card's ~20, so bytes bound.

#include "common.cuh"

#define FA_MAXN 8192  // longest transform held in shared memory

// The forward DIF's first stage (d = n / 2) on real input: im is written,
// never read (pallas_fft.py:331-347).
__device__ __forceinline__ void fa_real_first_stage(
    float* re, float* im, int n, int groups, int gdiv, int ghi, int glo,
    int estride, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im) {
  const int d = n >> 1;
  for (int b = threadIdx.x; b < d * groups; b += blockDim.x) {
    const int g = b / d;
    const int k = b - g * d;
    const int gb = (g / gdiv) * ghi + (g % gdiv) * glo;
    const int a0 = gb + k * estride;
    const int a1 = gb + (k + d) * estride;
    const float xr = re[a0], ur = re[a1];
    const float br = __fsub_rn(xr, ur);
    re[a0] = __fadd_rn(xr, ur);
    im[a0] = 0.0f;
    re[a1] = __fmul_rn(br, __ldg(tw_re + k + d));
    im[a1] = __fmul_rn(br, __ldg(tw_im + k + d));
  }
}

// All stages over `groups` sequences (layout as pbmm_radix2_stage).
template <bool INVERSE, bool REAL>
__device__ __forceinline__ void fa_stages(float* re, float* im, int n,
                                          int groups, int gdiv, int ghi,
                                          int glo, int estride,
                                          const float* tw_re,
                                          const float* tw_im) {
  int stages = 0;
  while ((1 << stages) < n) ++stages;
  for (int s = 0; s < stages; ++s) {
    const int d = INVERSE ? (1 << s) : (n >> (s + 1));
    if (REAL && s == 0)
      fa_real_first_stage(re, im, n, groups, gdiv, ghi, glo, estride, tw_re,
                          tw_im);
    else
      pbmm_radix2_stage(re, im, n, d, groups, gdiv, ghi, glo, estride,
                        tw_re + s * n, tw_im + s * n, INVERSE);
    __syncthreads();
  }
}

template <bool INVERSE, bool REAL>
__global__ void __launch_bounds__(256)
    fft_rows_kernel(const float* __restrict__ re,
                    const float* __restrict__ im, const float* tw_re,
                    const float* tw_im, float* __restrict__ out_re,
                    float* __restrict__ out_im, int w, float scale) {
  extern __shared__ float smem[];
  float* xr = smem;
  float* xi = smem + w;
  const size_t base = (size_t)blockIdx.x * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    xr[i] = re[base + i];
    if (!REAL) xi[i] = im[base + i];
  }
  __syncthreads();
  fa_stages<INVERSE, REAL>(xr, xi, w, 1, 1, 0, 0, 1, tw_re, tw_im);
  const bool scaled = scale != 1.0f;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    out_re[base + i] = scaled ? __fmul_rn(xr[i], scale) : xr[i];
    out_im[base + i] = scaled ? __fmul_rn(xi[i], scale) : xi[i];
  }
}

template <bool INVERSE, bool REAL>
__global__ void __launch_bounds__(256)
    fft_cols_kernel(const float* __restrict__ re,
                    const float* __restrict__ im, const float* tw_re,
                    const float* tw_im, float* __restrict__ out_re,
                    float* __restrict__ out_im, int h, int w, int s,
                    float scale) {
  extern __shared__ float smem[];
  const int hs = h * s;
  float* xr = smem;
  float* xi = smem + hs;
  const int col0 = blockIdx.x * s;
  const size_t base = (size_t)blockIdx.y * h * w;
  for (int e = threadIdx.x; e < hs; e += blockDim.x) {
    const int p = e / s, c = e % s;
    const bool in = col0 + c < w;
    const size_t g = base + (size_t)p * w + col0 + c;
    xr[e] = in ? re[g] : 0.0f;
    if (!REAL) xi[e] = in ? im[g] : 0.0f;
  }
  __syncthreads();
  fa_stages<INVERSE, REAL>(xr, xi, h, s, s, 0, 1, s, tw_re, tw_im);
  const bool scaled = scale != 1.0f;
  for (int e = threadIdx.x; e < hs; e += blockDim.x) {
    const int p = e / s, c = e % s;
    if (col0 + c >= w) continue;
    const size_t g = base + (size_t)p * w + col0 + c;
    out_re[g] = scaled ? __fmul_rn(xr[e], scale) : xr[e];
    out_im[g] = scaled ? __fmul_rn(xi[e], scale) : xi[e];
  }
}

template <bool INVERSE, bool REAL>
static cudaError_t fa_launch(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out_re, float* out_im, int b, int h,
                             int w, int axis, float scale,
                             cudaStream_t stream) {
  if (axis == 2) {
    const size_t smem = 2 * (size_t)w * sizeof(float);
    cudaError_t err = pbmm_smem_opt_in(fft_rows_kernel<INVERSE, REAL>, smem);
    if (err != cudaSuccess) return err;
    fft_rows_kernel<INVERSE, REAL><<<(unsigned)((size_t)b * h), 256, smem,
                                     stream>>>(re, im, tw_re, tw_im, out_re,
                                               out_im, w, scale);
  } else {
    int s = 16384 / h;  // columns a block: 128 KB of shared memory
    if (s > 8) s = 8;
    const size_t smem = 2 * (size_t)h * s * sizeof(float);
    cudaError_t err = pbmm_smem_opt_in(fft_cols_kernel<INVERSE, REAL>, smem);
    if (err != cudaSuccess) return err;
    fft_cols_kernel<INVERSE, REAL>
        <<<dim3((w + s - 1) / s, b), 256, smem, stream>>>(
            re, im, tw_re, tw_im, out_re, out_im, h, w, s, scale);
  }
  return cudaGetLastError();
}

// im null: real input (forward only).  axis 1 = H, 2 = W.
extern "C" int pbmm_fft_axis(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out_re, float* out_im, int b, int h,
                             int w, int axis, int inverse, float scale,
                             void* stream) {
  const int n = axis == 1 ? h : w;
  if (b < 1 || h < 1 || w < 1 || (axis != 1 && axis != 2) || n < 2 ||
      (n & (n - 1)) != 0 || n > FA_MAXN || (inverse && im == nullptr) ||
      (axis == 1 && b > 65535) || (axis == 2 && (size_t)b * h > 2147483647u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (inverse)
    err = fa_launch<true, false>(re, im, tw_re, tw_im, out_re, out_im, b, h,
                                 w, axis, scale, s);
  else if (im == nullptr)
    err = fa_launch<false, true>(re, im, tw_re, tw_im, out_re, out_im, b, h,
                                 w, axis, scale, s);
  else
    err = fa_launch<false, false>(re, im, tw_re, tw_im, out_re, out_im, b,
                                  h, w, axis, scale, s);
  return (int)err;
}
