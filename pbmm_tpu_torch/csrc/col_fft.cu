// Kernel 5: the zero-embedded radix-2 column FFT at pow-2 heights.
//
// Replaces pbmm_tpu/spectral/fused.py:303 col_fft_zero_padded (the Pallas
// kernel launched at :345): (B, Hc, Wk) row spectra of the content rows
// -> (B, H, Wk) forward column FFT, the content slab embedded at row0
// among zero rows on chip (the zero rows are never read), rows
// bit-reversed.  The chunk engine runs it once per stream, on frame 0
// through video_init when a pow-2 stream starts from interleaved frames
// (pbmm_tpu/engine/video.py:382 -> :83 -> pipeline.py:150), and on the
// last frame of a bypassed clip (video.py:466).
//
// The zero-embed and the DIF are pbmm_col_fft_pow2 (common.cuh), the
// same __device__ function kernel 2 runs at pow-2 heights, so the
// spectrum this kernel gives a frame is bit for bit the one kernel 2
// carries for it: a stream started here continues exactly as one started
// through kernel 2 against a zero previous spectrum.
//
// What bounds it on an H100: it reads Hc x Wk x 8 bytes and writes
// H x Wk x 8 bytes per frame (28 MB at 1080p square_pow2) and computes
// 5 H log2(H) flops per column.  Design: one block per (strip of S = 4
// columns, frame), the strip in shared memory (2 x H x S f32, 64 KB at
// H = 2048), every stage in place between __syncthreads().  Simple and
// right first.

#include "common.cuh"

__global__ void __launch_bounds__(256)
    col_fft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im, float* __restrict__ out_re,
                   float* __restrict__ out_im, int hc, int h, int wk,
                   int row0) {
  extern __shared__ float smem[];
  float* a_re = smem;
  float* a_im = smem + h * PBMM_COL_S;
  const int col0 = blockIdx.x * PBMM_COL_S;
  const size_t b = blockIdx.y;
  pbmm_col_fft_pow2(re + b * hc * wk, im + b * hc * wk, hc, wk, col0, row0,
                    h, tw_re, tw_im, a_re, a_im);
  for (int e = threadIdx.x; e < h * PBMM_COL_S; e += blockDim.x) {
    const int p = e / PBMM_COL_S, c = e % PBMM_COL_S;
    const size_t g = (b * h + p) * wk + col0 + c;
    out_re[g] = a_re[e];
    out_im[g] = a_im[e];
  }
}

extern "C" int pbmm_col_fft(const float* re, const float* im,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im, int batch, int hc,
                            int h, int wk, int row0, void* stream) {
  if (batch < 1 || h < 2 || (h & (h - 1)) != 0 || hc < 1 || row0 < 0 ||
      row0 + hc > h || wk < PBMM_COL_S || wk % PBMM_COL_S != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)h * PBMM_COL_S * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(col_fft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  col_fft_kernel<<<dim3(wk / PBMM_COL_S, batch), 256, smem,
                   (cudaStream_t)stream>>>(re, im, tw_re, tw_im, out_re,
                                           out_im, hc, h, wk, row0);
  return (int)cudaGetLastError();
}
