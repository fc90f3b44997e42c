// Kernel 3: Hermitian rebuild + row IFFT + |z| + blur + crop + chroma
// combine + YIQ->RGB, straight to the output layout.
//
// Replaces pbmm_tpu/engine/post_pallas.py:198 rowifft_post_fused (the
// Pallas kernel launched at :382, with the row transform of
// spectral/fused.py:1532 make_row_ifft_block and the rebuild of :1182
// _rebuild_kept_lanes).  Both chroma sources and all three output
// layouts of the JAX kernel are template parameters:
//   U8 = false: the original I/Q come as (T, H, W) f32 planes;
//   U8 = true:  they are formed here from the (T, 3, H, W) uint8 source
//               frames, (r c0 + g c1 + b c2) * window with the 1/255
//               folded into c (post_pallas.py:319-331);
//   LAYOUT 0 "tuple3":    three (T, H, W) f32 planes;
//   LAYOUT 1 "planar":    one (T, 3, H, W) f32 array;
//   LAYOUT 2 "planar_u8": one (T, 3, H, W) uint8 array, rint(255 x)
//                         (round half to even, as jnp.round and
//                         torch.round; the value is clipped to [0, 1]).
//
// The reference's quirk switches are runtime flags: Re z in place of |z|
// (reconstruct="real"), the window compensation (multiply by
// 1 / max(win, 1e-3)) and the YIQ gains, in the JAX kernel's order
// (post_pallas.py:335-342).
//
// Per region row: pbmm_row_ifft_mag (common.cuh, shared with kernel 7)
// rebuilds the missing 128-lane tiles by the static plan, takes the
// bit-reversed lanes to natural order with a radix-2 DIT inverse, and
// keeps |z| / (pad_h * W) (or Re z / (pad_h * W)).  The blur is the
// reference's kernel of 2 r + 1 taps (r = ceil(3.23 blur_size), up to
// PBMM_MAX_BLUR_R = 96, every radius post_pallas_ok admits), horizontal
// taps first (wrapping around the padded width exactly as
// pltpu.roll does; the crop offset x0 exceeds the radius, so the wrap
// never reaches the output), then vertical; the crop, the windowed
// original I/Q and the RGB matrix with its [0, 1] clip follow.  The
// epilogue rounds every product and sum separately (__fmul_rn /
// __fadd_rn) in the plain version's order, so each layout computes the
// same value: "planar_u8" is exactly rint(255 * "planar").
//
// The TPU kernel's two-block halo and rolling scratch exist for Mosaic's
// (8, 128) tiling.  Here one block owns ob output rows of one frame and
// recomputes the r-row halo on each side: ob + 2 r transformed |z| rows
// of W f32 plus one complex row (2 W f32) in shared memory, at most
// 227 KB.  The caller chooses ob (engine/post_fused.py::kernel3_rows):
// 8, or fewer where the blur halo leaves less room (r = 12 at W = 2048
// leaves 2); where not even one row fits (r >= 13 at W = 2048, r >= 6 at
// 4096) the caller runs kernel 7 and kernel 10 in its place.
//
// What bounds it on an H100: each output row reads ~1.5 region rows of
// 2 x Wk f32 (the halo is read and transformed again by the neighbouring
// block) and the chroma (8 bytes of f32 I/Q or 3 bytes of u8 per pixel),
// and writes 12 (f32) or 3 (u8) bytes per pixel: ~28 KB per output row
// at 1080p with f32 I/Q in and out; the transform costs 5 W log2(W)
// flops per region row.  Simple and right first: rows are transformed one
// at a time.

#include "common.cuh"

struct PostParams {
  PbmmLanePlan plan;
  float taps[2 * PBMM_MAX_BLUR_R + 1];
  float m[9];    // YIQ -> RGB, row-major
  float iq[6];   // I and Q rows of RGB -> YIQ times 1/255 (u8 chroma)
  float gains[3];  // YIQ gains
  int magnitude;   // |z| (1) or Re z (0)
  int comp;        // divide the Hann window back out
  int gain;        // apply the gains
};

template <bool U8, int LAYOUT>
__global__ void rowifft_post_kernel(
    const float* __restrict__ rre, const float* __restrict__ rim,
    const float* __restrict__ i_plane, const float* __restrict__ q_plane,
    const unsigned char* __restrict__ rgb_u8, const float* __restrict__ win,
    const float* __restrict__ tw_re, const float* __restrict__ tw_im,
    void* __restrict__ out0, void* __restrict__ out1,
    void* __restrict__ out2, PostParams prm, int radius, int ob, int hr,
    int wk, int w, int in_h, int in_w, int yrow0, int x0, float scale) {
  extern __shared__ float smem[];
  float* xre = smem;
  float* xim = smem + w;
  float* mag = smem + 2 * w;  // (rows, w)
  const int f = blockIdx.y;
  const int y_first = blockIdx.x * ob;
  const int ny = min(ob, in_h - y_first);
  const int nrows = ny + 2 * radius;
  const int reg0 = yrow0 + y_first - radius;  // first region row used

  for (int lr = 0; lr < nrows; ++lr) {
    const size_t rbase = ((size_t)f * hr + reg0 + lr) * wk;
    pbmm_row_ifft_mag(rre + rbase, rim + rbase, prm.plan, w, tw_re, tw_im,
                      xre, xim, mag + lr * w, scale, prm.magnitude != 0);
  }

  const size_t plane = (size_t)in_h * in_w;
  for (int e = threadIdx.x; e < ny * in_w; e += blockDim.x) {
    const int yl = e / in_w, x = e % in_w;
    const int c = x0 + x;
    float vb = 0.0f;
    for (int ky = 0; ky <= 2 * radius; ++ky) {
      const float* row = mag + (yl + ky) * w;
      float hb = __fmul_rn(row[c], prm.taps[radius]);
      for (int k = 1; k <= radius; ++k) {
        hb = __fadd_rn(hb, __fadd_rn(
                               __fmul_rn(row[(c - k + w) % w],
                                         prm.taps[radius - k]),
                               __fmul_rn(row[(c + k) % w],
                                         prm.taps[radius + k])));
      }
      const float t = __fmul_rn(hb, prm.taps[ky]);
      vb = ky == 0 ? t : __fadd_rn(vb, t);
    }
    const size_t pix = (size_t)(y_first + yl) * in_w + x;
    const size_t o = (size_t)f * plane + pix;
    const float wn = win[pix];
    float iw, qw;
    if (U8) {
      const unsigned char* src = rgb_u8 + (size_t)f * 3 * plane + pix;
      const float ru = (float)src[0];
      const float gu = (float)src[plane];
      const float bu = (float)src[2 * plane];
      iw = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[0]),
                                         __fmul_rn(gu, prm.iq[1])),
                               __fmul_rn(bu, prm.iq[2])),
                     wn);
      qw = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[3]),
                                         __fmul_rn(gu, prm.iq[4])),
                               __fmul_rn(bu, prm.iq[5])),
                     wn);
    } else {
      iw = __fmul_rn(i_plane[o], wn);
      qw = __fmul_rn(q_plane[o], wn);
    }
    if (prm.comp) {
      const float inv = __fdiv_rn(1.0f, fmaxf(wn, 1e-3f));
      vb = __fmul_rn(vb, inv);
      iw = __fmul_rn(iw, inv);
      qw = __fmul_rn(qw, inv);
    }
    if (prm.gain) {
      vb = __fmul_rn(vb, prm.gains[0]);
      iw = __fmul_rn(iw, prm.gains[1]);
      qw = __fmul_rn(qw, prm.gains[2]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(vb, prm.m[3 * d]),
                                          __fmul_rn(iw, prm.m[3 * d + 1])),
                                __fmul_rn(qw, prm.m[3 * d + 2]));
      const float cl = fminf(fmaxf(v, 0.0f), 1.0f);
      if (LAYOUT == 0) {
        float* outs[3] = {(float*)out0, (float*)out1, (float*)out2};
        outs[d][o] = cl;
      } else {
        const size_t po = ((size_t)f * 3 + d) * plane + pix;
        if (LAYOUT == 1)
          ((float*)out0)[po] = cl;
        else
          ((unsigned char*)out0)[po] =
              (unsigned char)rintf(__fmul_rn(cl, 255.0f));
      }
    }
  }
}

template <bool U8, int LAYOUT>
static cudaError_t launch_post(dim3 grid, size_t smem, cudaStream_t stream,
                               const float* rre, const float* rim,
                               const float* i_plane, const float* q_plane,
                               const unsigned char* rgb_u8, const float* win,
                               const float* tw_re, const float* tw_im,
                               void* out0, void* out1, void* out2,
                               const PostParams& prm, int radius, int ob,
                               int hr, int wk, int w, int in_h, int in_w,
                               int yrow0, int x0, float scale) {
  cudaError_t err = pbmm_smem_opt_in(rowifft_post_kernel<U8, LAYOUT>, smem);
  if (err != cudaSuccess) return err;
  rowifft_post_kernel<U8, LAYOUT><<<grid, 512, smem, stream>>>(
      rre, rim, i_plane, q_plane, rgb_u8, win, tw_re, tw_im, out0, out1,
      out2, prm, radius, ob, hr, wk, w, in_h, in_w, yrow0, x0, scale);
  return cudaGetLastError();
}

// layout: 0 tuple3 (out0..2 = R, G, B planes), 1 planar f32, 2 planar
// uint8 (out0 only).  rgb_u8 non-null selects the u8 chroma source
// (i_plane/q_plane are then unused).  ob: output rows a block.
extern "C" int pbmm_rowifft_post(
    const float* rre, const float* rim, const float* i_plane,
    const float* q_plane, const unsigned char* rgb_u8, const float* win,
    const float* tw_re, const float* tw_im, void* out0, void* out1,
    void* out2, const int* plan_src, const int* plan_rev, int n_tiles,
    const float* taps, int radius, int ob, const float* yiq_to_rgb,
    const float* iq_u8, int layout, int t, int hr, int wk, int w, int in_h,
    int in_w, int yrow0, int x0, float scale, int magnitude, int comp,
    int gain, float g_y, float g_i, float g_q, void* stream) {
  const bool u8 = rgb_u8 != nullptr;
  if (t < 1 || n_tiles < 1 || n_tiles > PBMM_MAX_TILES ||
      n_tiles * PBMM_LANE != w || radius < 0 || radius > PBMM_MAX_BLUR_R ||
      ob < 1 ||
      yrow0 - radius < 0 || yrow0 + in_h + radius > hr || x0 < radius ||
      x0 + in_w + radius > w || layout < 0 || layout > 2 ||
      (!u8 && (i_plane == nullptr || q_plane == nullptr)) ||
      out0 == nullptr || (layout == 0 && (out1 == nullptr || out2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  PostParams prm;
  for (int i = 0; i < n_tiles; ++i) {
    prm.plan.src[i] = plan_src[i];
    prm.plan.rev[i] = plan_rev[i];
  }
  for (int i = 0; i <= 2 * radius; ++i) prm.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.m[i] = yiq_to_rgb[i];
  for (int i = 0; i < 6; ++i) prm.iq[i] = iq_u8[i];
  prm.gains[0] = g_y;
  prm.gains[1] = g_i;
  prm.gains[2] = g_q;
  prm.magnitude = magnitude;
  prm.comp = comp;
  prm.gain = gain;
  const size_t smem =
      (2 + (size_t)ob + 2 * (size_t)radius) * (size_t)w * sizeof(float);
  dim3 grid((in_h + ob - 1) / ob, t);
  cudaStream_t s = (cudaStream_t)stream;
#define PP_LAUNCH(U, L)                                                     \
  launch_post<U, L>(grid, smem, s, rre, rim, i_plane, q_plane, rgb_u8, win, \
                    tw_re, tw_im, out0, out1, out2, prm, radius, ob, hr,    \
                    wk, w, in_h, in_w, yrow0, x0, scale)
  cudaError_t err;
  switch (layout + 3 * (int)u8) {
    case 0: err = PP_LAUNCH(false, 0); break;
    case 1: err = PP_LAUNCH(false, 1); break;
    case 2: err = PP_LAUNCH(false, 2); break;
    case 3: err = PP_LAUNCH(true, 0); break;
    case 4: err = PP_LAUNCH(true, 1); break;
    default: err = PP_LAUNCH(true, 2); break;
  }
#undef PP_LAUNCH
  return (int)err;
}
