// Kernel 1 of the main path: Hann-windowed row FFT, Hermitian kept tiles.
//
// Replaces pbmm_tpu/spectral/fused.py:79 windowed_row_fft (the Pallas
// kernel launched at :149).  Each padded content row y[b, r, :] (W real
// values) is multiplied by hann_row[r] * hann_col[:], transformed by a
// radix-2 decimation-in-frequency FFT (natural order in, bit-reversed
// order out, the JAX kernel's layout), and only the kept 128-lane tiles
// of the Hermitian half are written (9 of 16 at W = 2048).
//
// What bounds it on an H100: the row is read once (4W bytes) and 2 x Wk x
// 4 bytes are written, about 17 KB per 2048-lane row; the 11 stages cost
// 5 W log2(W) flops, ~1.1e5 per row, so the kernel is bound by device
// memory only if the butterflies keep up.  Design: one block per row, the
// whole complex row in shared memory (16 KB at W = 2048), every stage in
// place between __syncthreads(); twiddles come from the host-built f32
// tables (L1/L2 resident, 180 KB for both directions at W = 2048).  The
// JAX kernel's 128x128 "intra-group" matmul is just the product of the
// last 7 stages, so it runs as ordinary stages here.  Simple and right
// first: no register blocking, no multi-row batching yet.

#include "common.cuh"

struct KeptTiles {
  int tile[PBMM_MAX_TILES];  // full-layout tile index of each kept tile
};

__global__ void row_fft_kernel(const float* __restrict__ y,
                               const float* __restrict__ wy,
                               const float* __restrict__ wx,
                               const float* __restrict__ tw_re,
                               const float* __restrict__ tw_im,
                               float* __restrict__ out_re,
                               float* __restrict__ out_im, KeptTiles kept,
                               int n_kept, int hc, int w) {
  extern __shared__ float smem[];
  float* re = smem;
  float* im = smem + w;
  const int row = blockIdx.x;
  const size_t rowid = (size_t)blockIdx.y * hc + row;
  const float* src = y + rowid * w;
  const float wr = wy[row];
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    re[i] = src[i] * wr * wx[i];
    im[i] = 0.0f;
  }
  __syncthreads();
  pbmm_radix2(re, im, w, 1, 1, 0, 0, 1, tw_re, tw_im, false);
  const int wk = n_kept * PBMM_LANE;
  float* dst_re = out_re + rowid * wk;
  float* dst_im = out_im + rowid * wk;
  for (int k = threadIdx.x; k < wk; k += blockDim.x) {
    const int p = kept.tile[k / PBMM_LANE] * PBMM_LANE + (k % PBMM_LANE);
    dst_re[k] = re[p];
    dst_im[k] = im[p];
  }
}

extern "C" int pbmm_row_fft(const float* y, const float* wy, const float* wx,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im,
                            const int* kept_tiles, int n_kept, int batch,
                            int hc, int w, void* stream) {
  if (n_kept < 1 || n_kept > PBMM_MAX_TILES || batch < 1 || hc < 1 ||
      w < PBMM_LANE)
    return (int)cudaErrorInvalidValue;
  KeptTiles kept;
  for (int i = 0; i < n_kept; ++i) kept.tile[i] = kept_tiles[i];
  const size_t smem = 2 * (size_t)w * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(row_fft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hc, batch);
  row_fft_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      y, wy, wx, tw_re, tw_im, out_re, out_im, kept, n_kept, hc, w);
  return (int)cudaGetLastError();
}
