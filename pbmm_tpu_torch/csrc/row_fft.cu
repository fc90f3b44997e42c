// Kernels 1 and 4: Hann-windowed row FFT, Hermitian kept tiles.
//
// Kernel 1 replaces pbmm_tpu/spectral/fused.py:79 windowed_row_fft (the
// Pallas kernel launched at :149).  Each padded content row y[b, r, :] (W
// real values) is multiplied by hann_row[r] * hann_col[:], transformed by
// a radix-2 decimation-in-frequency FFT (natural order in, bit-reversed
// order out, the JAX kernel's layout), and only the kept 128-lane tiles
// of the Hermitian half are written (9 of 16 at W = 2048).
//
// Kernel 4 replaces pbmm_tpu/spectral/fused.py:168
// windowed_row_fft_u8planar (launched at :285): the same transform fed
// straight from (T, 3, H, W) uint8 frames.  Per output row it reads the
// three u8 source rows (source row r - off, zero outside [0, H)), forms
// Y = r c_r + g c_g + b c_b with r = u8 * f32(1/255) at column x0 + c of
// the padded row (zero elsewhere), applies the window, and runs the same
// FFT and store as kernel 1 (pbmm_row_fft_store in common.cuh).  The luma
// and window arithmetic is written with __fmul_rn / __fadd_rn in the pre
// stage's op order, so nvcc cannot contract it into FMAs: kernel 4 then
// equals the torch pre stage + kernel 1 bit for bit, the contract the JAX
// kernel states (fused.py:249-253).
//
// What bounds them on an H100: kernel 1 reads the row once (4W bytes),
// kernel 4 three u8 rows (3w bytes); both write 2 x Wk x 4 bytes, about
// 9 KB per 2048-lane row.  The 11 stages cost 5 W log2(W) flops, ~1.1e5
// per row, so the kernels are bound by device memory only if the
// butterflies keep up.  Design: one block per row, the whole complex row
// in shared memory (16 KB at W = 2048), every stage in place between
// __syncthreads(); twiddles come from the host-built f32 tables (L1/L2
// resident).  The JAX kernel's 128x128 "intra-group" matmul is just the
// product of the last 7 stages, so it runs as ordinary stages here.
// Simple and right first: no register blocking, no multi-row batching.

#include "common.cuh"

__global__ void row_fft_kernel(const float* __restrict__ y,
                               const float* __restrict__ wy,
                               const float* __restrict__ wx,
                               const float* __restrict__ tw_re,
                               const float* __restrict__ tw_im,
                               float* __restrict__ out_re,
                               float* __restrict__ out_im, PbmmKeptTiles kept,
                               int n_kept, int hc, int w) {
  extern __shared__ float smem[];
  float* re = smem;
  float* im = smem + w;
  const int row = blockIdx.x;
  const size_t rowid = (size_t)blockIdx.y * hc + row;
  const float* src = y + rowid * w;
  const float wr = wy[row];
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    re[i] = __fmul_rn(__fmul_rn(src[i], wr), wx[i]);
    im[i] = 0.0f;
  }
  const size_t wk = (size_t)n_kept * PBMM_LANE;
  pbmm_row_fft_store(re, im, w, tw_re, tw_im, kept, n_kept,
                     out_re + rowid * wk, out_im + rowid * wk);
}

struct LumaRow {
  float c[3];  // the Y row of RGB -> YIQ
  float s;     // f32(1/255)
};

__global__ void row_fft_u8_kernel(const unsigned char* __restrict__ frames,
                                  const float* __restrict__ wy,
                                  const float* __restrict__ wx,
                                  const float* __restrict__ tw_re,
                                  const float* __restrict__ tw_im,
                                  float* __restrict__ out_re,
                                  float* __restrict__ out_im,
                                  PbmmKeptTiles kept, int n_kept, int hc,
                                  int h_in, int w_in, int w, int off, int x0,
                                  LumaRow luma) {
  extern __shared__ float smem[];
  float* re = smem;
  float* im = smem + w;
  const int row = blockIdx.x;
  const int f = blockIdx.y;
  const int src_row = row - off;
  const bool content = src_row >= 0 && src_row < h_in;
  const size_t plane = (size_t)h_in * w_in;
  const unsigned char* r8 =
      frames + (size_t)f * 3 * plane + (size_t)(content ? src_row : 0) * w_in;
  const float wr = wy[row];
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int x = i - x0;
    float v = 0.0f;
    if (content && x >= 0 && x < w_in) {
      const float r = __fmul_rn((float)r8[x], luma.s);
      const float g = __fmul_rn((float)r8[plane + x], luma.s);
      const float b = __fmul_rn((float)r8[2 * plane + x], luma.s);
      v = __fadd_rn(__fadd_rn(__fmul_rn(r, luma.c[0]),
                              __fmul_rn(g, luma.c[1])),
                    __fmul_rn(b, luma.c[2]));
    }
    re[i] = __fmul_rn(__fmul_rn(v, wr), wx[i]);
    im[i] = 0.0f;
  }
  const size_t rowid = (size_t)f * hc + row;
  const size_t wk = (size_t)n_kept * PBMM_LANE;
  pbmm_row_fft_store(re, im, w, tw_re, tw_im, kept, n_kept,
                     out_re + rowid * wk, out_im + rowid * wk);
}

static bool fill_kept(const int* kept_tiles, int n_kept, PbmmKeptTiles* k) {
  if (n_kept < 1 || n_kept > PBMM_MAX_TILES) return false;
  for (int i = 0; i < n_kept; ++i) k->tile[i] = kept_tiles[i];
  return true;
}

extern "C" int pbmm_row_fft(const float* y, const float* wy, const float* wx,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im,
                            const int* kept_tiles, int n_kept, int batch,
                            int hc, int w, void* stream) {
  PbmmKeptTiles kept;
  if (!fill_kept(kept_tiles, n_kept, &kept) || batch < 1 || hc < 1 ||
      w < PBMM_LANE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)w * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(row_fft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hc, batch);
  row_fft_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      y, wy, wx, tw_re, tw_im, out_re, out_im, kept, n_kept, hc, w);
  return (int)cudaGetLastError();
}

extern "C" int pbmm_row_fft_u8(const unsigned char* frames, const float* wy,
                               const float* wx, const float* tw_re,
                               const float* tw_im, float* out_re,
                               float* out_im, const int* kept_tiles,
                               int n_kept, int t, int hc, int h_in, int w_in,
                               int w, int off, int x0, const float* coeffs,
                               float scale, void* stream) {
  PbmmKeptTiles kept;
  if (!fill_kept(kept_tiles, n_kept, &kept) || t < 1 || hc < 1 ||
      h_in < 1 || w_in < 1 || w < PBMM_LANE || x0 < 0 || x0 + w_in > w)
    return (int)cudaErrorInvalidValue;
  LumaRow luma;
  for (int i = 0; i < 3; ++i) luma.c[i] = coeffs[i];
  luma.s = scale;
  const size_t smem = 2 * (size_t)w * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(row_fft_u8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hc, t);
  row_fft_u8_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      frames, wy, wx, tw_re, tw_im, out_re, out_im, kept, n_kept, hc, h_in,
      w_in, w, off, x0, luma);
  return (int)cudaGetLastError();
}
