// Kernels 11 and 10: the post tail from reconstructed planes: blur +
// crop, window compensation, YIQ gains, YIQ->RGB and the [0, 1] clip,
// straight to the output layout.
//
// Kernel 11 (pbmm_post_rgb) replaces pbmm_tpu/engine/post_pallas.py:398
// post_fused_rgb (the Pallas kernel launched at :490), the chroma="rgb"
// tail.  Kernel 10 (pbmm_post_yonly) replaces post_pallas.py:91
// post_fused (launched at :181), the y_only tail of the JAX package's
// _post_block: Y is the one reconstructed plane of each frame, blurred
// and cropped the same way, and I, Q are the original chroma planes
// times the crop-region Hann window (post_pallas.py:164-178).  The port
// also reaches it after kernel 7 where kernel 3's block does not fit
// shared memory (a blur radius of 15 or more at W = 2048, 7 or more at
// 4096: engine/post_fused.py::kernel3_serves), so it takes kernel 3's
// chroma sources too: the f32 I/Q planes, or the (T, 3, H, W) uint8
// source frames, from which it forms I and Q as kernel 3 does,
// ((r c0 + g c1) + b c2) * window with the 1/255 folded into c.
// Kernel 11's input is kernel 7's output: (3T, Hr, W)
// region rows of |z| (or Re z), plane-minor frame-major (frame t's Y, I,
// Q at rows 3t, 3t + 1, 3t + 2), from padded row rows0.  With all three
// planes processed there is no original-chroma combine (posttail's rgb
// branch, engine/pipeline.py:507-508).  Per output pixel and plane: the
// reference's blur, horizontal taps first, then vertical, in the JAX
// kernel's order of products and sums; the crop; then
// y, i, q *= 1 / max(win, 1e-3) with compensate_window and *= the gains
// with apply_yiq_gains (post_pallas.py:476-483), and the RGB matrix and
// clip.  Every operation rounds on its own (__fmul_rn / __fadd_rn), as
// in kernel 3, so "planar_u8" is exactly rint(255 * "planar") and each
// layout equals the plain version's.  LAYOUT, as in kernel 3: 0 "tuple3"
// (three (T, H, W) f32 planes), 1 "planar" ((T, 3, H, W) f32), 2
// "planar_u8" ((T, 3, H, W) uint8).
//
// The TPU kernel walks 8-aligned row blocks with a two-block window and
// a rolling scratch per plane, for Mosaic's (8, 128) tiling.  Here one
// thread owns one output pixel of one frame and reads its (2r + 1)^2
// taps of each plane straight from device memory (r up to
// PBMM_MAX_BLUR_R = 96, every radius post_pallas_ok admits; the taps go
// by value): neighbouring threads
// read neighbouring columns, so the loads coalesce, and the overlapping
// taps of a block's pixels are served by L1/L2.  No shared memory, no
// halo bookkeeping.
//
// What bounds it on an H100: per 1080p tight frame it reads the three
// region planes once from DRAM (3 x 1152 x 2048 f32, 28 MB; the halo
// rows again from L2) and writes 25 MB (f32) or 6 MB (u8); the 75 tap
// loads per pixel go to L1.  Kernel 10 reads one region plane and the
// two chroma planes (9 + 17 MB at 1080p tight) and writes 25 MB.  Simple
// and right first.

#include "common.cuh"

struct RgbParams {
  float taps[2 * PBMM_MAX_BLUR_R + 1];
  float m[9];      // YIQ -> RGB, row-major
  float iq[6];     // I and Q rows of RGB -> YIQ times 1/255 (u8 chroma)
  float gains[3];  // YIQ gains
  int comp;        // divide the Hann window back out
  int gain;        // apply the gains
};

// Chroma sources.  PR_RGB: chans holds three planes a frame (Y, I, Q).
// Else chans holds one plane a frame (Y), and I/Q come from i_pl, q_pl
// (T, H, W) (PR_IQ) or from the uint8 frames rgb_u8 (PR_U8), times win.
enum { PR_RGB = 0, PR_IQ = 1, PR_U8 = 2 };

template <int LAYOUT, int CHROMA>
__global__ void __launch_bounds__(128)
    post_rgb_kernel(const float* __restrict__ chans3,
                    const float* __restrict__ i_pl,
                    const float* __restrict__ q_pl,
                    const unsigned char* __restrict__ rgb_u8,
                    const float* __restrict__ win, void* __restrict__ out0,
                    void* __restrict__ out1, void* __restrict__ out2,
                    RgbParams prm, int radius, int hr, int w, int in_h,
                    int in_w, int yrow0, int x0) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= in_w) return;
  const int y = blockIdx.y;
  const int f = blockIdx.z;
  const int col = x0 + x;
  const size_t pix = (size_t)y * in_w + x;
  const size_t plane = (size_t)in_h * in_w;
  constexpr bool YONLY = CHROMA != PR_RGB;
  float v[3];
#pragma unroll
  for (int c = 0; c < (YONLY ? 1 : 3); ++c) {
    const size_t src = YONLY ? (size_t)f : (size_t)(3 * f + c);
    const float* base = chans3 + (src * hr + (yrow0 + y - radius)) * w;
    float vb = 0.0f;
    for (int ky = 0; ky <= 2 * radius; ++ky) {
      const float* row = base + (size_t)ky * w;
      float hb = __fmul_rn(__ldg(row + col), prm.taps[radius]);
      for (int k = 1; k <= radius; ++k) {
        hb = __fadd_rn(hb, __fadd_rn(
                               __fmul_rn(__ldg(row + col - k),
                                         prm.taps[radius - k]),
                               __fmul_rn(__ldg(row + col + k),
                                         prm.taps[radius + k])));
      }
      const float t = __fmul_rn(hb, prm.taps[ky]);
      vb = ky == 0 ? t : __fadd_rn(vb, t);
    }
    v[c] = vb;
  }
  if (CHROMA == PR_IQ) {
    const float wn = __ldg(win + pix);
    v[1] = __fmul_rn(__ldg(i_pl + (size_t)f * plane + pix), wn);
    v[2] = __fmul_rn(__ldg(q_pl + (size_t)f * plane + pix), wn);
  } else if (CHROMA == PR_U8) {
    // rowifft_post.cu's u8 chroma, in its order of products and sums.
    const float wn = __ldg(win + pix);
    const unsigned char* px = rgb_u8 + (size_t)f * 3 * plane + pix;
    const float ru = (float)px[0];
    const float gu = (float)px[plane];
    const float bu = (float)px[2 * plane];
#pragma unroll
    for (int d = 0; d < 2; ++d)
      v[1 + d] = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[3 * d]),
                              __fmul_rn(gu, prm.iq[3 * d + 1])),
                    __fmul_rn(bu, prm.iq[3 * d + 2])),
          wn);
  }
  if (prm.comp) {
    const float inv = __fdiv_rn(1.0f, fmaxf(__ldg(win + pix), 1e-3f));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], inv);
  }
  if (prm.gain) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], prm.gains[c]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(v[0], prm.m[3 * d]),
                                        __fmul_rn(v[1], prm.m[3 * d + 1])),
                              __fmul_rn(v[2], prm.m[3 * d + 2]));
    const float cl = fminf(fmaxf(s, 0.0f), 1.0f);
    if (LAYOUT == 0) {
      float* outs[3] = {(float*)out0, (float*)out1, (float*)out2};
      outs[d][(size_t)f * plane + pix] = cl;
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

static int pr_run(int chroma, const float* chans, const float* i_pl,
                  const float* q_pl, const unsigned char* rgb_u8,
                  const float* iq_u8, const float* win, void* out0,
                  void* out1, void* out2, const float* taps, int radius,
                  const float* yiq_to_rgb, int layout, int t, int hr, int w,
                  int in_h, int in_w, int yrow0, int x0, int comp, int gain,
                  float g_y, float g_i, float g_q, void* stream) {
  if (t < 1 || in_h < 1 || in_w < 1 || radius < 0 ||
      radius > PBMM_MAX_BLUR_R ||
      yrow0 - radius < 0 || yrow0 + in_h + radius > hr || x0 < radius ||
      x0 + in_w + radius > w || layout < 0 || layout > 2 ||
      in_h > 65535 || t > 65535 || out0 == nullptr ||
      (chroma == PR_IQ && (i_pl == nullptr || q_pl == nullptr)) ||
      (chroma == PR_U8 && (rgb_u8 == nullptr || iq_u8 == nullptr)) ||
      (layout == 0 && (out1 == nullptr || out2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  RgbParams prm;
  for (int i = 0; i <= 2 * radius; ++i) prm.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.m[i] = yiq_to_rgb[i];
  for (int i = 0; i < 6; ++i) prm.iq[i] = chroma == PR_U8 ? iq_u8[i] : 0.0f;
  prm.gains[0] = g_y;
  prm.gains[1] = g_i;
  prm.gains[2] = g_q;
  prm.comp = comp;
  prm.gain = gain;
  const dim3 grid((in_w + 127) / 128, in_h, t);
  cudaStream_t s = (cudaStream_t)stream;
#define PR_LAUNCH(L, C)                                                  \
  post_rgb_kernel<L, C><<<grid, 128, 0, s>>>(chans, i_pl, q_pl, rgb_u8,  \
                                             win, out0, out1, out2, prm, \
                                             radius, hr, w, in_h, in_w,  \
                                             yrow0, x0)
#define PR_CHROMA(L)                          \
  switch (chroma) {                           \
    case PR_RGB: PR_LAUNCH(L, PR_RGB); break; \
    case PR_IQ: PR_LAUNCH(L, PR_IQ); break;   \
    default: PR_LAUNCH(L, PR_U8); break;      \
  }
  if (layout == 0) {
    PR_CHROMA(0)
  } else if (layout == 1) {
    PR_CHROMA(1)
  } else {
    PR_CHROMA(2)
  }
#undef PR_CHROMA
#undef PR_LAUNCH
  return (int)cudaGetLastError();
}

// Kernel 11.  layout: 0 tuple3 (out0..2 = R, G, B planes), 1 planar f32,
// 2 planar uint8 (out0 only).  taps and yiq_to_rgb are host arrays.
extern "C" int pbmm_post_rgb(const float* chans3, const float* win,
                             void* out0, void* out1, void* out2,
                             const float* taps, int radius,
                             const float* yiq_to_rgb, int layout, int t,
                             int hr, int w, int in_h, int in_w, int yrow0,
                             int x0, int comp, int gain, float g_y,
                             float g_i, float g_q, void* stream) {
  return pr_run(PR_RGB, chans3, nullptr, nullptr, nullptr, nullptr, win,
                out0, out1, out2, taps, radius, yiq_to_rgb, layout, t, hr, w,
                in_h, in_w, yrow0, x0, comp, gain, g_y, g_i, g_q, stream);
}

// Kernel 10: chans (T, Hr, W) Y rows; the chroma either i_pl/q_pl (T, H,
// W) f32 planes or, with rgb_u8 non-null, the (T, 3, H, W) uint8 frames
// and iq_u8 (host, the I and Q rows of RGB -> YIQ times 1/255); the rest
// as pbmm_post_rgb.
extern "C" int pbmm_post_yonly(const float* chans, const float* i_pl,
                               const float* q_pl,
                               const unsigned char* rgb_u8,
                               const float* iq_u8, const float* win,
                               void* out0, void* out1, void* out2,
                               const float* taps, int radius,
                               const float* yiq_to_rgb, int layout, int t,
                               int hr, int w, int in_h, int in_w, int yrow0,
                               int x0, int comp, int gain, float g_y,
                               float g_i, float g_q, void* stream) {
  const int chroma = rgb_u8 != nullptr ? PR_U8 : PR_IQ;
  return pr_run(chroma, chans, i_pl, q_pl, rgb_u8, iq_u8, win, out0, out1,
                out2, taps, radius, yiq_to_rgb, layout, t, hr, w, in_h,
                in_w, yrow0, x0, comp, gain, g_y, g_i, g_q, stream);
}
