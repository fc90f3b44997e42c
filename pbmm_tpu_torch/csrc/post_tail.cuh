// The post tail shared by kernels 3, 10 and 11: the separable blur of four
// neighbouring columns (horizontal taps, then vertical taps over a ring of
// the 2 r previous horizontally blurred rows) and the epilogue (windowed
// chroma, window compensation, YIQ gains, YIQ -> RGB, the [0, 1] clip and
// the output layout).
//
// Kernel 3 (rowifft_post.cu) runs these functions on the |z| rows of its
// row transform, kernels 10 and 11 (post_rgb.cu) on region rows staged
// from device memory.  The blur sums in the order of the JAX kernel
// (pbmm_tpu/engine/post_pallas.py:451-460): hb = c t[r], then
// hb += (l t[r - k] + r t[r + k]) for k = 1 .. r; vb = hb_0 t[0], then
// vb += hb_ky t[ky] in ky order.  Every product and sum rounds on its own
// (__fmul_rn / __fadd_rn; nvcc contracts plain products into FMAs by
// context), so kernel 3 equals kernel 7 + kernel 10 bit for bit, and
// "planar_u8" is exactly rint(255 * "planar").  Change these functions
// only for all three kernels at once.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// The epilogue's chroma: PBMM_CH_IQ the original (T, H, W) f32 I/Q planes,
// PBMM_CH_U8 I/Q formed from the (T, 3, H, W) uint8 source frames, both
// times the crop-region window; PBMM_CH_RGB the blurred I/Q planes of a
// chroma="rgb" reconstruction (kernel 11), not windowed.
enum { PBMM_CH_IQ = 0, PBMM_CH_U8 = 1, PBMM_CH_RGB = 2 };

struct PbmmTailParams {
  float taps[2 * PBMM_MAX_BLUR_R + 1];
  float m[9];      // YIQ -> RGB, row-major
  float iq[6];     // I and Q rows of RGB -> YIQ times 1/255 (u8 chroma)
  float gains[3];  // YIQ gains
  int comp;        // divide the Hann window back out
  int gain;        // apply the gains
};

struct PbmmTailIO {
  const float* i_plane;         // (T, in_h, in_w) f32 chroma, or null
  const float* q_plane;
  const unsigned char* rgb_u8;  // (T, 3, in_h, in_w), or null
  const float* win;             // (in_h, in_w) crop-region window
  void* out0;                   // tuple3: R, G, B planes; else out0 only
  void* out1;
  void* out2;
  int in_h, in_w;
};

// The epilogue's inputs of four pixels: the window and the f32 I/Q (or
// the uint8 R, G, B).
struct PbmmTailIn {
  float4 w, a, b;
  uchar4 r, g, bl;
};

// 16-byte loads of the window and the f32 I/Q, 4-byte loads of the uint8
// frames, at pixels (f, j, x .. x + 3).  Kernel 11 reads the window only
// to compensate it.
template <int CHROMA>
__device__ __forceinline__ PbmmTailIn pbmm_tail_load(const PbmmTailIO& io,
                                                     const PbmmTailParams& prm,
                                                     int f, int j, int x) {
  const size_t plane = (size_t)io.in_h * io.in_w;
  const size_t pix = (size_t)j * io.in_w + x;
  PbmmTailIn in;
  in.w = CHROMA != PBMM_CH_RGB || prm.comp
             ? __ldg(reinterpret_cast<const float4*>(io.win + pix))
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (CHROMA == PBMM_CH_U8) {
    const unsigned char* px = io.rgb_u8 + (size_t)f * 3 * plane + pix;
    in.r = *reinterpret_cast<const uchar4*>(px);
    in.g = *reinterpret_cast<const uchar4*>(px + plane);
    in.bl = *reinterpret_cast<const uchar4*>(px + 2 * plane);
  } else if (CHROMA == PBMM_CH_IQ) {
    const size_t o = (size_t)f * plane + pix;
    in.a = __ldg(reinterpret_cast<const float4*>(io.i_plane + o));
    in.b = __ldg(reinterpret_cast<const float4*>(io.q_plane + o));
  }
  return in;
}

// The epilogue on the four pixels (f, j, x .. x + 3).  v[0] holds the
// blurred Y; v[1], v[2] the blurred I and Q (PBMM_CH_RGB), or are set here
// to the windowed chroma.
template <int CHROMA, int LAYOUT>
__device__ __forceinline__ void pbmm_tail_epilogue(const PbmmTailIO& io,
                                                   const PbmmTailParams& prm,
                                                   const PbmmTailIn& in,
                                                   int f, int j, int x,
                                                   float (&v)[3][4]) {
  const size_t plane = (size_t)io.in_h * io.in_w;
  const size_t pix = (size_t)j * io.in_w + x;
  const float wn[4] = {in.w.x, in.w.y, in.w.z, in.w.w};
  if (CHROMA == PBMM_CH_U8) {
    const unsigned char rc[4] = {in.r.x, in.r.y, in.r.z, in.r.w};
    const unsigned char gc[4] = {in.g.x, in.g.y, in.g.z, in.g.w};
    const unsigned char bc[4] = {in.bl.x, in.bl.y, in.bl.z, in.bl.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ru = (float)rc[e], gu = (float)gc[e], bu = (float)bc[e];
#pragma unroll
      for (int d = 0; d < 2; ++d)
        v[1 + d][e] = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[3 * d]),
                                __fmul_rn(gu, prm.iq[3 * d + 1])),
                      __fmul_rn(bu, prm.iq[3 * d + 2])),
            wn[e]);
    }
  } else if (CHROMA == PBMM_CH_IQ) {
    const float iv[4] = {in.a.x, in.a.y, in.a.z, in.a.w};
    const float qv[4] = {in.b.x, in.b.y, in.b.z, in.b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[1][e] = __fmul_rn(iv[e], wn[e]);
      v[2][e] = __fmul_rn(qv[e], wn[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (prm.comp) {
      const float inv = __fdiv_rn(1.0f, fmaxf(wn[e], 1e-3f));
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c][e] = __fmul_rn(v[c][e], inv);
    }
    if (prm.gain) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c][e] = __fmul_rn(v[c][e], prm.gains[c]);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float cl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s =
          __fadd_rn(__fadd_rn(__fmul_rn(v[0][e], prm.m[3 * d]),
                              __fmul_rn(v[1][e], prm.m[3 * d + 1])),
                    __fmul_rn(v[2][e], prm.m[3 * d + 2]));
      cl[e] = fminf(fmaxf(s, 0.0f), 1.0f);
    }
    if (LAYOUT == 2) {
      uchar4 u;
      u.x = (unsigned char)rintf(__fmul_rn(cl[0], 255.0f));
      u.y = (unsigned char)rintf(__fmul_rn(cl[1], 255.0f));
      u.z = (unsigned char)rintf(__fmul_rn(cl[2], 255.0f));
      u.w = (unsigned char)rintf(__fmul_rn(cl[3], 255.0f));
      *reinterpret_cast<uchar4*>((unsigned char*)io.out0 +
                                 ((size_t)f * 3 + d) * plane + pix) = u;
    } else {
      float* dst = LAYOUT == 0
                       ? (d == 0 ? (float*)io.out0
                                 : d == 1 ? (float*)io.out1 : (float*)io.out2) +
                             (size_t)f * plane + pix
                       : (float*)io.out0 + ((size_t)f * 3 + d) * plane + pix;
      *reinterpret_cast<float4*>(dst) = make_float4(cl[0], cl[1], cl[2], cl[3]);
    }
  }
}

// The horizontal taps of the four columns base .. base + 3 of one row
// (base a multiple of 4).  chunk(q) gives the row's words q .. q + 3; it
// is called once for each q = base + 4 i, |i| <= ceil(r / 4), so each word
// in reach is read once and slides through registers: 2 ceil(r / 4) + 1
// chunk reads for 4 (2 r + 1) taps.
template <typename Chunk>
__device__ __forceinline__ void pbmm_tail_hsum4(const Chunk& chunk, int base,
                                                int r,
                                                const PbmmTailParams& prm,
                                                float (&hb)[4]) {
  // lo[i]: word base - 4 m - 4 + i; hi[i]: word base + 4 m + i.
  float lo[8], hi[8];
  const float4 c = chunk(base);
  lo[4] = hi[0] = c.x;
  lo[5] = hi[1] = c.y;
  lo[6] = hi[2] = c.z;
  lo[7] = hi[3] = c.w;
  const float tc = prm.taps[r];
#pragma unroll
  for (int e = 0; e < 4; ++e) hb[e] = __fmul_rn(lo[4 + e], tc);
  for (int m = 0; 4 * m < r; ++m) {
    const float4 a = chunk(base - 4 * m - 4), b = chunk(base + 4 * m + 4);
    lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w;
    hi[4] = b.x; hi[5] = b.y; hi[6] = b.z; hi[7] = b.w;
#pragma unroll
    for (int s = 1; s <= 4; ++s) {
      const int k = 4 * m + s;
      if (k > r) break;
      const float tl = prm.taps[r - k], tr = prm.taps[r + k];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hb[e] = __fadd_rn(hb[e], __fadd_rn(__fmul_rn(lo[4 + e - s], tl),
                                           __fmul_rn(hi[e + s], tr)));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[4 + e] = lo[e];
      hi[e] = hi[4 + e];
    }
  }
}

// The ring holds region row y in slot y mod 2 r; slot 0 at radius 0.
// The slot after `slot`, for the caller's next region row.
__device__ __forceinline__ int pbmm_tail_next_slot(int slot, int r2) {
  return slot + 1 >= r2 ? 0 : slot + 1;
}

// The vertical taps of four columns of the output row that region row yy
// completes (yy >= 2 r): slot is yy's ring slot, which holds row
// yy - 2 r (col: the four columns in slot 0, stride floats a slot); the
// ring is read oldest first, then the new row's hb.
__device__ __forceinline__ void pbmm_tail_vsum4(const float* col, int stride,
                                                int slot, int r2,
                                                const PbmmTailParams& prm,
                                                const float (&hb)[4],
                                                float (&vb)[4]) {
  for (int ky = 0; ky < r2; ++ky) {
    const float4 v =
        *reinterpret_cast<const float4*>(col + (size_t)slot * stride);
    const float tk = prm.taps[ky];
    const float tv[4] = {__fmul_rn(v.x, tk), __fmul_rn(v.y, tk),
                         __fmul_rn(v.z, tk), __fmul_rn(v.w, tk)};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      vb[e] = ky == 0 ? tv[e] : __fadd_rn(vb[e], tv[e]);
    slot = slot + 1 == r2 ? 0 : slot + 1;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float tv = __fmul_rn(hb[e], prm.taps[r2]);
    vb[e] = r2 == 0 ? tv : __fadd_rn(vb[e], tv);
  }
}

// A region row's hb into its ring slot (the slot of the row 2 r above,
// whose last reader was pbmm_tail_vsum4 on the same thread).
__device__ __forceinline__ void pbmm_tail_ring_put(float* col, int stride,
                                                   int slot, int r2,
                                                   const float (&hb)[4]) {
  if (r2)
    *reinterpret_cast<float4*>(col + (size_t)slot * stride) =
        make_float4(hb[0], hb[1], hb[2], hb[3]);
}
