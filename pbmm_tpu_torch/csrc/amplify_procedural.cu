// Kernel 9: the pyramid band/phase pass on whole spectra, every mask
// evaluated in the kernel.
//
// Replaces pbmm_tpu/phase/pallas_kernels.py:136 _amplify_pallas_procedural
// (the Pallas kernel launched at :156, body :53-128): the use_pallas=True
// pass of engine/pipeline.py::_amplify_spectrum_impl, on (C, H, W) cur
// and prev spectra in the "centered" or "bitrev2d" layout (the frequency
// of each row and lane comes in as fy (H,) and fx (W,)).  Per bin:
//   f = sqrt(fy^2 + fx^2); g = min(|cur|, |prev|);
//   total = sum of every level's radial mask m_i(f); amped = sum over the
//   mid levels of m_i where g m_i >= tau, or, steerable (K > 1, L >= 3),
//   of each sector mask m_i a_k where g m_i a_k >= tau;
//   rot = (prev conj(cur) / |.|)^s for an integer s in [0, 64] (square
//   and multiply), else e^{i s atan2(.)} with IEEE atan2f and cosf/sinf,
//   as jnp.arctan2 and jnp.cos give it (this is not kernel 2's
//   host-plane or atan2-with-signed-zero branch: the two are not expected
//   to agree bit for bit);
//   out = cur ((total - amped) + amped rot).
// The masks are radial_level_params' ramps (smoothstep and raised cosine,
// pallas_kernels.py:38-50); the sectors are fused.py:725
// _sector_weights' trig-free cos^(2(K-1)) windows.
//
// Design (redesigned for the H100; the first design was one thread a bin on
// a grid-stride loop, a 64-bit division and modulo a bin, a runtime loop
// over the levels with an IEEE division and a cosf at every level, three
// square roots a bin and the sector windows recomputed at every level):
// - a 3D grid, no integer division: blockIdx.z the plane, blockIdx.y the
//   row (fy one load a block), blockIdx.x a run of 4 x AP_THREADS lanes;
// - four neighbouring bins a thread, 16-byte loads of the four input
//   planes and of fx and 16-byte stores, where W % 4 == 0 and the planes
//   start on 16 bytes (else the same code on scalar loads and stores);
// - one rolled loop over the levels (unrolled for 5 and 6 levels it
//   measured 3 % faster at one config, 4 % slower steerable: PERF.md),
//   each level's mask
//   evaluated only where it is nonzero: the division and the ramp inside
//   (lo, hi], the raised cosine (and its cosf) inside [lo, hi].  A level
//   whose mask is 0 adds +0 to the total and, since its sector masks are
//   0 too, +0 to amped, so skipping it changes no bit;
// - the steerable sector windows a_k = pow(c2_k, K - 1) inv_norm once a
//   bin (the plain version's product m (pow(c2, K - 1) inv_norm) takes the
//   same a_k at every level), the gates then level by level and sector by
//   sector in the plain version's order;
// - one square root for the gate: min(|cur|, |prev|) = sqrt(min(|cur|^2,
//   |prev|^2)), IEEE sqrt being correctly rounded and so monotonic.
// The magnitude gates keep their IEEE division and product order, and
// every product and sum rounds on its own (__fmul_rn / __fadd_rn) in the
// plain version's order, so the kernel and
// phase/fused_kernels.py::amplify_procedural_ref compute the same atan2
// arguments and magnitude gates on the card.
//
// What bounds it on an H100: 4 planes read and 2 written once, 24 bytes
// a bin, against ~15 flops per level and bin plus the rotation (~100 at
// L = 5): ~4 flops per byte, bytes bound.  Its times, old and new, are in
// PERF.md (chip_smoke.py).

#include "common.cuh"

#define AP_MAXB 16  // most radial levels
#define AP_MAXK 16  // most sectors

struct ProcArgs {
  int levels, steer, power;  // power: integer scale, or -1 for atan2
  int kind[AP_MAXB];         // 0 zero, 1 high, 2 low, 3 band
  float lo[AP_MAXB], hi[AP_MAXB], span[AP_MAXB];
  float tau, scale, inv_norm;
  float cphi[AP_MAXK], sphi[AP_MAXK];  // cos, sin of 2 pi k / K
};

__device__ __forceinline__ float ap_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float ap_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float ap_sub(float a, float b) {
  return __fsub_rn(a, b);
}

// smoothstep of clip(t, 0, 1): t t (3 - 2 t).
__device__ __forceinline__ float ap_smooth(float t) {
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return ap_mul(ap_mul(t, t), ap_sub(3.0f, ap_mul(2.0f, t)));
}

// x ** n, integer n >= 1, square and multiply (fused.py _pow_static).
__device__ __forceinline__ float ap_pow(float x, int n) {
  float acc = 1.0f, base = x;
  bool any = false;
  for (; n > 0; n >>= 1) {
    if (n & 1) {
      acc = any ? ap_mul(acc, base) : base;
      any = true;
    }
    base = ap_mul(base, base);
  }
  return acc;
}

#define AP_THREADS 128  // a block: 512 lanes of one row

// One level's radial mask at f (pyramid/filters.py
// radial_profile_from_params: kind 0 zero, 1 high, 2 low, 3 band, t = (f -
// lo) / span), its division and cosf evaluated only where it is nonzero.
__device__ __forceinline__ float ap_mask_nz(int kind, float lo, float hi,
                                            float span, float f) {
  if (kind == 1) {
    if (f > hi) return 1.0f;
    return f > lo ? ap_smooth(__fdiv_rn(ap_sub(f, lo), span)) : 0.0f;
  }
  if (kind == 2) {
    if (f < lo) return 1.0f;
    return f < hi ? ap_sub(1.0f, ap_smooth(__fdiv_rn(ap_sub(f, lo), span)))
                  : 0.0f;
  }
  if (kind == 3 && f >= lo && f <= hi) {
    const float t = __fdiv_rn(ap_sub(f, lo), span);
    return ap_mul(0.5f,
                  ap_add(1.0f, cosf(ap_mul(6.2831855f, ap_sub(t, 0.5f)))));
  }
  return 0.0f;
}

// Level l's contribution to total and amped (sectors: a[k], K of them).
template <bool STEER>
__device__ __forceinline__ void ap_level(int l, const ProcArgs& pa, float f,
                                         float g, const float (&a)[AP_MAXK],
                                         float& total, float& amped) {
  const float m = ap_mask_nz(pa.kind[l], pa.lo[l], pa.hi[l], pa.span[l], f);
  if (m == 0.0f) return;
  total = ap_add(total, m);
  if (l == 0 || l == pa.levels - 1) return;
  if (STEER) {
#pragma unroll
    for (int k = 0; k < AP_MAXK; ++k) {
      if (k >= pa.steer) break;
      const float mk = ap_mul(m, a[k]);
      amped = ap_add(amped, ap_mul(g, mk) >= pa.tau ? mk : 0.0f);
    }
  } else {
    amped = ap_add(amped, ap_mul(g, m) >= pa.tau ? m : 0.0f);
  }
}

// One bin: cur, prev and its frequencies in, the amplified bin out.
template <bool INT_POW, bool STEER>
__device__ __forceinline__ void ap_bin(float fy, float fx, float cr,
                                       float ci, float pr, float pi,
                                       const ProcArgs& pa, float& o_r,
                                       float& o_i) {
  const float f = sqrtf(ap_add(ap_mul(fy, fy), ap_mul(fx, fx)));
  const float g = sqrtf(fminf(ap_add(ap_mul(cr, cr), ap_mul(ci, ci)),
                              ap_add(ap_mul(pr, pr), ap_mul(pi, pi))));
  float a[AP_MAXK];
  if (STEER) {  // the double angle of (fx, fy); theta = 0 at DC
    const float r2 = ap_add(ap_mul(fx, fx), ap_mul(fy, fy));
    const float inv_r2 = r2 > 0.0f ? __fdiv_rn(1.0f, fmaxf(r2, 1e-38f))
                                   : 0.0f;
    const float cos2t =
        r2 > 0.0f ? ap_mul(ap_sub(ap_mul(fx, fx), ap_mul(fy, fy)), inv_r2)
                  : 1.0f;
    const float sin2t = ap_mul(ap_mul(ap_mul(2.0f, fx), fy), inv_r2);
#pragma unroll
    for (int k = 0; k < AP_MAXK; ++k) {
      if (k >= pa.steer) break;
      const float c2 = fmaxf(
          ap_mul(0.5f, ap_add(ap_add(1.0f, ap_mul(cos2t, pa.cphi[k])),
                              ap_mul(sin2t, pa.sphi[k]))),
          0.0f);
      a[k] = ap_mul(ap_pow(c2, pa.steer - 1), pa.inv_norm);
    }
  }
  float total = 0.0f, amped = 0.0f;
#pragma unroll 1
  for (int l = 0; l < pa.levels; ++l)
    ap_level<STEER>(l, pa, f, g, a, total, amped);
  // prev * conj(cur)
  const float rr = ap_add(ap_mul(pr, cr), ap_mul(pi, ci));
  const float ri = ap_sub(ap_mul(pi, cr), ap_mul(pr, ci));
  float wr = 1.0f, wi = 0.0f;
  if (INT_POW) {
    const float m2 = ap_add(ap_mul(rr, rr), ap_mul(ri, ri));
    // 1e-38 is subnormal: built without -ftz so it survives.
    const float inv = m2 > 0.0f ? rsqrtf(fmaxf(m2, 1e-38f)) : 0.0f;
    float br = ap_mul(rr, inv), bi = ap_mul(ri, inv);
    bool first = true;
    for (int p = pa.power; p > 0;) {
      if (p & 1) {
        if (first) {
          wr = br;
          wi = bi;
          first = false;
        } else {
          const float tr = ap_sub(ap_mul(wr, br), ap_mul(wi, bi));
          wi = ap_add(ap_mul(wr, bi), ap_mul(wi, br));
          wr = tr;
        }
      }
      p >>= 1;
      if (p) {
        const float sr = ap_sub(ap_mul(br, br), ap_mul(bi, bi));
        bi = ap_mul(ap_mul(2.0f, br), bi);
        br = sr;
      }
    }
  } else {
    const float ang = ap_mul(pa.scale, atan2f(ri, rr));
    wr = cosf(ang);
    wi = sinf(ang);
  }
  const float er = ap_add(ap_sub(total, amped), ap_mul(amped, wr));
  const float ei = ap_mul(amped, wi);
  o_r = ap_sub(ap_mul(cr, er), ap_mul(ci, ei));
  o_i = ap_add(ap_mul(cr, ei), ap_mul(ci, er));
}

// Block (x run, row, plane): thread t takes lanes x0 .. x0 + 3, x0 = 4
// (blockIdx.x AP_THREADS + t); VEC: 16-byte loads and stores (W % 4 == 0,
// the planes 16-byte aligned), else scalar ones, lanes past W masked.
template <bool INT_POW, bool STEER, bool VEC>
__global__ void __launch_bounds__(AP_THREADS)
    amplify_procedural_kernel(const float* __restrict__ cur_re,
                              const float* __restrict__ cur_im,
                              const float* __restrict__ prev_re,
                              const float* __restrict__ prev_im,
                              const float* __restrict__ fyv,
                              const float* __restrict__ fxv,
                              float* __restrict__ out_re,
                              float* __restrict__ out_im, int h, int w,
                              ProcArgs pa) {
  const int x0 = 4 * (blockIdx.x * AP_THREADS + threadIdx.x);
  if (x0 >= w) return;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t o = ((size_t)blockIdx.z * h + y) * w + x0;
    const float fy = __ldg(fyv + y);
    float cr[4], ci[4], pr[4], pi[4], fx[4];
    if (VEC) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(cur_re + o));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(cur_im + o));
      const float4 c = __ldcs(reinterpret_cast<const float4*>(prev_re + o));
      const float4 d = __ldcs(reinterpret_cast<const float4*>(prev_im + o));
      const float4 e = __ldg(reinterpret_cast<const float4*>(fxv + x0));
      cr[0] = a.x; cr[1] = a.y; cr[2] = a.z; cr[3] = a.w;
      ci[0] = b.x; ci[1] = b.y; ci[2] = b.z; ci[3] = b.w;
      pr[0] = c.x; pr[1] = c.y; pr[2] = c.z; pr[3] = c.w;
      pi[0] = d.x; pi[1] = d.y; pi[2] = d.z; pi[3] = d.w;
      fx[0] = e.x; fx[1] = e.y; fx[2] = e.z; fx[3] = e.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = x0 + k < w;
        cr[k] = in ? __ldcs(cur_re + o + k) : 0.0f;
        ci[k] = in ? __ldcs(cur_im + o + k) : 0.0f;
        pr[k] = in ? __ldcs(prev_re + o + k) : 0.0f;
        pi[k] = in ? __ldcs(prev_im + o + k) : 0.0f;
        fx[k] = in ? __ldg(fxv + x0 + k) : 0.0f;
      }
    }
    float orr[4], oi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ap_bin<INT_POW, STEER>(fy, fx[k], cr[k], ci[k], pr[k], pi[k], pa,
                             orr[k], oi[k]);
    if (VEC) {
      __stcs(reinterpret_cast<float4*>(out_re + o),
             make_float4(orr[0], orr[1], orr[2], orr[3]));
      __stcs(reinterpret_cast<float4*>(out_im + o),
             make_float4(oi[0], oi[1], oi[2], oi[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x0 + k < w) {
          out_re[o + k] = orr[k];
          out_im[o + k] = oi[k];
        }
      }
    }
  }
}

template <bool INT_POW, bool STEER>
static cudaError_t ap_launch(const float* cur_re, const float* cur_im,
                             const float* prev_re, const float* prev_im,
                             const float* fy, const float* fx, float* out_re,
                             float* out_im, int c, int h, int w,
                             const ProcArgs& pa, bool vec, cudaStream_t s) {
  const dim3 grid((w + 4 * AP_THREADS - 1) / (4 * AP_THREADS),
                  h < 65535 ? h : 65535, c);
  if (vec)
    amplify_procedural_kernel<INT_POW, STEER, true>
        <<<grid, AP_THREADS, 0, s>>>(cur_re, cur_im, prev_re, prev_im, fy,
                                     fx, out_re, out_im, h, w, pa);
  else
    amplify_procedural_kernel<INT_POW, STEER, false>
        <<<grid, AP_THREADS, 0, s>>>(cur_re, cur_im, prev_re, prev_im, fy,
                                     fx, out_re, out_im, h, w, pa);
  return cudaGetLastError();
}

// iargs: levels, steer, power, kind[16]; fargs: tau, scale, inv_norm,
// cphi[16], sphi[16], lo[16], hi[16], span[16] (host arrays, copied by
// value; phase/fused_kernels.py::_proc_args packs them).
extern "C" int pbmm_amplify_procedural(
    const float* cur_re, const float* cur_im, const float* prev_re,
    const float* prev_im, const float* fy, const float* fx, float* out_re,
    float* out_im, const int* iargs, const float* fargs, int c, int h,
    int w, void* stream) {
  ProcArgs pa;
  pa.levels = iargs[0];
  pa.steer = iargs[1];
  pa.power = iargs[2];
  if (c < 1 || h < 1 || w < 1 || pa.levels < 1 || pa.levels > AP_MAXB ||
      pa.steer < 0 || pa.steer > AP_MAXK || pa.power > 64)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < AP_MAXB; ++b) pa.kind[b] = iargs[3 + b];
  pa.tau = fargs[0];
  pa.scale = fargs[1];
  pa.inv_norm = fargs[2];
  for (int k = 0; k < AP_MAXK; ++k) {
    pa.cphi[k] = fargs[3 + k];
    pa.sphi[k] = fargs[3 + AP_MAXK + k];
  }
  for (int b = 0; b < AP_MAXB; ++b) {
    pa.lo[b] = fargs[3 + 2 * AP_MAXK + b];
    pa.hi[b] = fargs[3 + 2 * AP_MAXK + AP_MAXB + b];
    pa.span[b] = fargs[3 + 2 * AP_MAXK + 2 * AP_MAXB + b];
  }
  if (c > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores where every row starts on 16 bytes.
  const bool vec = w % 4 == 0 && (size_t)cur_re % 16 == 0 &&
                   (size_t)cur_im % 16 == 0 && (size_t)prev_re % 16 == 0 &&
                   (size_t)prev_im % 16 == 0 && (size_t)out_re % 16 == 0 &&
                   (size_t)out_im % 16 == 0 && (size_t)fx % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define AP_ARGS \
  cur_re, cur_im, prev_re, prev_im, fy, fx, out_re, out_im, c, h, w, pa, vec, s
  if (pa.power >= 0)
    return (int)(pa.steer ? ap_launch<true, true>(AP_ARGS)
                          : ap_launch<true, false>(AP_ARGS));
  return (int)(pa.steer ? ap_launch<false, true>(AP_ARGS)
                        : ap_launch<false, false>(AP_ARGS));
#undef AP_ARGS
}
