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

// The epilogue's chroma: PBMM_CH_IQ the original (T, H, W) f32 I/Q planes;
// PBMM_CH_U8 and PBMM_CH_F32 I/Q formed from the uint8 or f32 source
// frames, (T, 3, H, W) planar or (T, H, W, 3) interleaved (runtime
// strides); each times the crop-region window; PBMM_CH_RGB the blurred I/Q
// planes of a chroma="rgb" reconstruction (kernel 11), not windowed.
enum { PBMM_CH_IQ = 0, PBMM_CH_U8 = 1, PBMM_CH_RGB = 2, PBMM_CH_F32 = 3 };

// The output layouts: three (T, H, W) f32 planes, one (T, 3, H, W) f32 or
// uint8 array, or (T, H, W, 3) f32 interleaved.
enum {
  PBMM_OUT_TUPLE3 = 0,
  PBMM_OUT_PLANAR = 1,
  PBMM_OUT_PLANAR_U8 = 2,
  PBMM_OUT_INTERLEAVED = 3
};

struct PbmmTailParams {
  float taps[2 * PBMM_MAX_BLUR_R + 1];
  float m[9];      // YIQ -> RGB, row-major
  float iq[6];     // I and Q rows of RGB -> YIQ (source chroma)
  float pre;       // source chroma: each value times pre first, unless 0
  float gains[3];  // YIQ gains
  int comp;        // divide the Hann window back out
  int gain;        // apply the gains
};

struct PbmmTailIO {
  const float* i_plane;  // (T, in_h, in_w) f32 chroma, or null
  const float* q_plane;
  const void* src;       // source frames (PBMM_CH_U8, PBMM_CH_F32), or null
  int src_px, src_ch;    // element strides of a pixel and of a channel
  const float* win;      // (in_h, in_w) crop-region window
  void* out0;            // tuple3: R, G, B planes; else out0 only
  void* out1;
  void* out2;
  int in_h, in_w;
};

// The epilogue's inputs of four pixels: the window and the f32 I/Q (a, b),
// or three words of four f32 (a, b, c) or uint8 (r, g, bl) source
// elements.
struct PbmmTailIn {
  float4 w, a, b, c;
  uchar4 r, g, bl;
};

// 16-byte loads of the window and the f32 I/Q or f32 source words, 4-byte
// loads of the uint8 source words, at pixels (f, j, x .. x + 3): planar,
// a word of each channel; interleaved, the 12 consecutive elements of the
// four pixels.  Kernel 11 reads the window only to compensate it.
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
  // The three words' element offsets: a channel apart (planar) or four
  // elements apart (interleaved).
  const size_t o = (size_t)f * 3 * plane + pix * io.src_px;
  const size_t step = io.src_px == 1 ? (size_t)io.src_ch : 4;
  if (CHROMA == PBMM_CH_U8) {
    const unsigned char* px = static_cast<const unsigned char*>(io.src) + o;
    in.r = *reinterpret_cast<const uchar4*>(px);
    in.g = *reinterpret_cast<const uchar4*>(px + step);
    in.bl = *reinterpret_cast<const uchar4*>(px + 2 * step);
  } else if (CHROMA == PBMM_CH_F32) {
    const float* px = static_cast<const float*>(io.src) + o;
    in.a = __ldg(reinterpret_cast<const float4*>(px));
    in.b = __ldg(reinterpret_cast<const float4*>(px + step));
    in.c = __ldg(reinterpret_cast<const float4*>(px + 2 * step));
  } else if (CHROMA == PBMM_CH_IQ) {
    const size_t q = (size_t)f * plane + pix;
    in.a = __ldg(reinterpret_cast<const float4*>(io.i_plane + q));
    in.b = __ldg(reinterpret_cast<const float4*>(io.q_plane + q));
  }
  return in;
}

// The epilogue on the four pixels (f, j, x .. x + 3).  v[0] holds the
// blurred Y; v[1], v[2] the blurred I and Q (PBMM_CH_RGB), or are set here
// to the windowed chroma.  From source frames, I and Q are ((v0 c0 + v1
// c1) + v2 c2) w for the I and Q rows c, each value v first times pre
// where pre is not 0: the planar uint8 route folds the 1/255 into the
// rows as the JAX kernel does (pre 0); f32 frames (pre 0) and interleaved
// uint8 frames (pre 1/255) give the bits of kernel 3 on the I/Q planes
// the torch pre stage forms.
template <int CHROMA, int LAYOUT>
__device__ __forceinline__ void pbmm_tail_epilogue(const PbmmTailIO& io,
                                                   const PbmmTailParams& prm,
                                                   const PbmmTailIn& in,
                                                   int f, int j, int x,
                                                   float (&v)[3][4]) {
  const size_t plane = (size_t)io.in_h * io.in_w;
  const size_t pix = (size_t)j * io.in_w + x;
  const float wn[4] = {in.w.x, in.w.y, in.w.z, in.w.w};
  if (CHROMA == PBMM_CH_U8 || CHROMA == PBMM_CH_F32) {
    float el[12];  // the three words' elements, in order
    if (CHROMA == PBMM_CH_U8) {
      const unsigned char u[12] = {in.r.x,  in.r.y,  in.r.z,  in.r.w,
                                   in.g.x,  in.g.y,  in.g.z,  in.g.w,
                                   in.bl.x, in.bl.y, in.bl.z, in.bl.w};
#pragma unroll
      for (int k = 0; k < 12; ++k) el[k] = (float)u[k];
    } else {
      const float4 w3[3] = {in.a, in.b, in.c};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        el[4 * k] = w3[k].x;
        el[4 * k + 1] = w3[k].y;
        el[4 * k + 2] = w3[k].z;
        el[4 * k + 3] = w3[k].w;
      }
    }
    float rgb[3][4];
    if (io.src_px == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) rgb[c][e] = el[4 * c + e];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) rgb[c][e] = el[3 * e + c];
    }
    if (prm.pre != 0.0f) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) rgb[c][e] = __fmul_rn(rgb[c][e], prm.pre);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int d = 0; d < 2; ++d)
        v[1 + d][e] = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(rgb[0][e], prm.iq[3 * d]),
                                __fmul_rn(rgb[1][e], prm.iq[3 * d + 1])),
                      __fmul_rn(rgb[2][e], prm.iq[3 * d + 2])),
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
  float cl[3][4];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s =
          __fadd_rn(__fadd_rn(__fmul_rn(v[0][e], prm.m[3 * d]),
                              __fmul_rn(v[1][e], prm.m[3 * d + 1])),
                    __fmul_rn(v[2][e], prm.m[3 * d + 2]));
      cl[d][e] = fminf(fmaxf(s, 0.0f), 1.0f);
    }
    if (LAYOUT == PBMM_OUT_PLANAR_U8) {
      uchar4 u;
      u.x = (unsigned char)rintf(__fmul_rn(cl[d][0], 255.0f));
      u.y = (unsigned char)rintf(__fmul_rn(cl[d][1], 255.0f));
      u.z = (unsigned char)rintf(__fmul_rn(cl[d][2], 255.0f));
      u.w = (unsigned char)rintf(__fmul_rn(cl[d][3], 255.0f));
      *reinterpret_cast<uchar4*>((unsigned char*)io.out0 +
                                 ((size_t)f * 3 + d) * plane + pix) = u;
    } else if (LAYOUT != PBMM_OUT_INTERLEAVED) {
      float* dst = LAYOUT == PBMM_OUT_TUPLE3
                       ? (d == 0 ? (float*)io.out0
                                 : d == 1 ? (float*)io.out1 : (float*)io.out2) +
                             (size_t)f * plane + pix
                       : (float*)io.out0 + ((size_t)f * 3 + d) * plane + pix;
      *reinterpret_cast<float4*>(dst) =
          make_float4(cl[d][0], cl[d][1], cl[d][2], cl[d][3]);
    }
  }
  if (LAYOUT == PBMM_OUT_INTERLEAVED) {
    // The four pixels' R, G, B: 48 bytes, three 16-byte stores (x a
    // multiple of 4).
    float4* dst = reinterpret_cast<float4*>((float*)io.out0 +
                                            ((size_t)f * plane + pix) * 3);
    dst[0] = make_float4(cl[0][0], cl[1][0], cl[2][0], cl[0][1]);
    dst[1] = make_float4(cl[1][1], cl[2][1], cl[0][2], cl[1][2]);
    dst[2] = make_float4(cl[2][2], cl[0][3], cl[1][3], cl[2][3]);
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
