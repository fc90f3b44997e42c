// Kernel 3 of the main path: Hermitian rebuild + row IFFT + |z| + blur +
// crop + chroma combine + YIQ->RGB, straight to three RGB planes.
//
// Replaces pbmm_tpu/engine/post_pallas.py:198 rowifft_post_fused (the
// Pallas kernel launched at :382, with the row transform of
// spectral/fused.py:1532 make_row_ifft_block and the rebuild of :1182
// _rebuild_kept_lanes), out_layout "tuple3", f32 I/Q planes, magnitude
// reconstruction, no window compensation or YIQ gains.
//
// Per region row: the missing 128-lane tiles are rebuilt from the kept
// ones (tile t = conj(lane reversal of its source tile), the static plan
// of spectral/hermitian.py::reconstruction_plan), a radix-2 DIT inverse
// takes the bit-reversed lanes to natural order, and |z| / (pad_h * W) is
// kept.  The blur is the reference's 5-tap kernel, horizontal taps first
// (wrapping around the padded width exactly as pltpu.roll does; the crop
// offset x0 exceeds the radius, so the wrap never reaches the output),
// then vertical; the crop, the windowed original I/Q and the RGB matrix
// with its [0, 1] clip follow.
//
// The TPU kernel's two-block halo and rolling scratch exist for Mosaic's
// (8, 128) tiling.  Here one block owns 8 output rows of one frame and
// recomputes the 2-row halo on each side: 12 transformed |z| rows of W
// f32 (96 KB at W = 2048) plus one complex row (16 KB) in shared memory.
//
// What bounds it on an H100: each output row reads ~1.5 region rows of
// 2 x Wk f32 (the halo is read and transformed again by the neighbouring
// block) and I/Q/window rows, and writes 3 RGB rows: ~28 KB per output
// row at 1080p; the transform costs 5 W log2(W) flops per region row.
// Simple and right first: rows are transformed one at a time.

#include "common.cuh"

#define PP_OB 8        // output rows per block
#define PP_MAXR 4      // largest blur radius (9 taps)

struct PostParams {
  int src[PBMM_MAX_TILES];  // kept tile position feeding each full tile
  int rev[PBMM_MAX_TILES];  // 1: conj(lane reversal) of that tile
  float taps[2 * PP_MAXR + 1];
  float m[9];  // YIQ -> RGB, row-major
};

__global__ void rowifft_post_kernel(
    const float* __restrict__ rre, const float* __restrict__ rim,
    const float* __restrict__ i_plane, const float* __restrict__ q_plane,
    const float* __restrict__ win, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, float* __restrict__ out_r,
    float* __restrict__ out_g, float* __restrict__ out_b, PostParams prm,
    int radius, int hr, int wk, int w, int in_h, int in_w, int yrow0,
    int x0, float scale) {
  extern __shared__ float smem[];
  float* xre = smem;
  float* xim = smem + w;
  float* mag = smem + 2 * w;  // (rows, w)
  const int f = blockIdx.y;
  const int y_first = blockIdx.x * PP_OB;
  const int ny = min(PP_OB, in_h - y_first);
  const int nrows = ny + 2 * radius;
  const int reg0 = yrow0 + y_first - radius;  // first region row used

  for (int lr = 0; lr < nrows; ++lr) {
    const size_t rbase = ((size_t)f * hr + reg0 + lr) * wk;
    for (int p = threadIdx.x; p < w; p += blockDim.x) {
      const int tile = p / PBMM_LANE, l = p % PBMM_LANE;
      const int kp = prm.src[tile];
      if (prm.rev[tile]) {
        const size_t g = rbase + kp * PBMM_LANE + (PBMM_LANE - 1 - l);
        xre[p] = rre[g];
        xim[p] = -rim[g];
      } else {
        const size_t g = rbase + kp * PBMM_LANE + l;
        xre[p] = rre[g];
        xim[p] = rim[g];
      }
    }
    __syncthreads();
    pbmm_radix2(xre, xim, w, 1, 1, 0, 0, 1, tw_re, tw_im, true);
    for (int p = threadIdx.x; p < w; p += blockDim.x) {
      const float a = xre[p], b = xim[p];
      mag[lr * w + p] = sqrtf(a * a + b * b) * scale;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < ny * in_w; e += blockDim.x) {
    const int yl = e / in_w, x = e % in_w;
    const int c = x0 + x;
    float vb = 0.0f;
    for (int ky = 0; ky <= 2 * radius; ++ky) {
      const float* row = mag + (yl + ky) * w;
      float hb = row[c] * prm.taps[radius];
      for (int k = 1; k <= radius; ++k) {
        hb = hb + (row[(c - k + w) % w] * prm.taps[radius - k] +
                   row[(c + k) % w] * prm.taps[radius + k]);
      }
      vb = ky == 0 ? hb * prm.taps[0] : vb + hb * prm.taps[ky];
    }
    const size_t o = ((size_t)f * in_h + y_first + yl) * in_w + x;
    const float wn = win[(size_t)(y_first + yl) * in_w + x];
    const float iw = i_plane[o] * wn;
    const float qw = q_plane[o] * wn;
    float* outs[3] = {out_r, out_g, out_b};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = vb * prm.m[3 * d] + iw * prm.m[3 * d + 1] +
                      qw * prm.m[3 * d + 2];
      outs[d][o] = fminf(fmaxf(v, 0.0f), 1.0f);
    }
  }
}

extern "C" int pbmm_rowifft_post(
    const float* rre, const float* rim, const float* i_plane,
    const float* q_plane, const float* win, const float* tw_re,
    const float* tw_im, float* out_r, float* out_g, float* out_b,
    const int* plan_src, const int* plan_rev, int n_tiles, const float* taps,
    int radius, const float* yiq_to_rgb, int t, int hr, int wk, int w,
    int in_h, int in_w, int yrow0, int x0, float scale, void* stream) {
  if (t < 1 || n_tiles < 1 || n_tiles > PBMM_MAX_TILES ||
      n_tiles * PBMM_LANE != w || radius < 0 || radius > PP_MAXR ||
      yrow0 - radius < 0 || yrow0 + in_h + radius > hr || x0 < radius ||
      x0 + in_w + radius > w)
    return (int)cudaErrorInvalidValue;
  PostParams prm;
  for (int i = 0; i < n_tiles; ++i) {
    prm.src[i] = plan_src[i];
    prm.rev[i] = plan_rev[i];
  }
  for (int i = 0; i <= 2 * radius; ++i) prm.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.m[i] = yiq_to_rgb[i];
  const size_t smem =
      (2 + PP_OB + 2 * (size_t)radius) * (size_t)w * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(rowifft_post_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((in_h + PP_OB - 1) / PP_OB, t);
  rowifft_post_kernel<<<grid, 512, smem, (cudaStream_t)stream>>>(
      rre, rim, i_plane, q_plane, win, tw_re, tw_im, out_r, out_g, out_b,
      prm, radius, hr, wk, w, in_h, in_w, yrow0, x0, scale);
  return (int)cudaGetLastError();
}
