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
// Design: one thread per bin, elementwise; every product and sum rounds
// on its own (__fmul_rn / __fadd_rn) in the plain version's order, so the
// kernel and phase/fused_kernels.py::amplify_procedural_ref compute the
// same atan2 arguments and magnitude gates on the card.
//
// What bounds it on an H100: 4 planes read and 2 written once, 24 bytes
// a bin, against ~15 flops per level and bin plus the rotation (~100 at
// L = 5): ~4 flops per byte, bytes bound.

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

// One level's radial mask (pyramid/filters.py radial_profile_from_params).
__device__ __forceinline__ float ap_mask(int kind, float lo, float hi,
                                         float span, float f) {
  if (kind == 0) return 0.0f;
  const float t = __fdiv_rn(ap_sub(f, lo), span);
  if (kind == 1) return f > hi ? 1.0f : (f > lo ? ap_smooth(t) : 0.0f);
  if (kind == 2)
    return f < lo ? 1.0f : (f < hi ? ap_sub(1.0f, ap_smooth(t)) : 0.0f);
  const float band =
      ap_mul(0.5f, ap_add(1.0f, cosf(ap_mul(6.2831855f, ap_sub(t, 0.5f)))));
  return (f >= lo && f <= hi) ? band : 0.0f;
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

template <bool INT_POW, bool STEER>
__global__ void __launch_bounds__(256)
    amplify_procedural_kernel(const float* __restrict__ cur_re,
                              const float* __restrict__ cur_im,
                              const float* __restrict__ prev_re,
                              const float* __restrict__ prev_im,
                              const float* __restrict__ fyv,
                              const float* __restrict__ fxv,
                              float* __restrict__ out_re,
                              float* __restrict__ out_im, size_t n, int h,
                              int w, ProcArgs pa) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int x = (int)(i % w);
    const int y = (int)((i / w) % h);
    const float fy = __ldg(fyv + y), fx = __ldg(fxv + x);
    const float cr = cur_re[i], ci = cur_im[i];
    const float pr = prev_re[i], pi = prev_im[i];
    const float f = sqrtf(ap_add(ap_mul(fy, fy), ap_mul(fx, fx)));
    const float g = fminf(sqrtf(ap_add(ap_mul(cr, cr), ap_mul(ci, ci))),
                          sqrtf(ap_add(ap_mul(pr, pr), ap_mul(pi, pi))));
    float cos2t = 1.0f, sin2t = 0.0f;
    if (STEER) {  // the double angle of (fx, fy); theta = 0 at DC
      const float r2 = ap_add(ap_mul(fx, fx), ap_mul(fy, fy));
      const float inv_r2 = r2 > 0.0f ? __fdiv_rn(1.0f, fmaxf(r2, 1e-38f))
                                     : 0.0f;
      cos2t = r2 > 0.0f
                  ? ap_mul(ap_sub(ap_mul(fx, fx), ap_mul(fy, fy)), inv_r2)
                  : 1.0f;
      sin2t = ap_mul(ap_mul(ap_mul(2.0f, fx), fy), inv_r2);
    }
    float total = 0.0f, amped = 0.0f;
    for (int l = 0; l < pa.levels; ++l) {
      const float m = ap_mask(pa.kind[l], pa.lo[l], pa.hi[l], pa.span[l], f);
      total = ap_add(total, m);
      if (l == 0 || l == pa.levels - 1) continue;
      if (STEER) {
        for (int k = 0; k < pa.steer; ++k) {
          const float c2 = fmaxf(
              ap_mul(0.5f, ap_add(ap_add(1.0f, ap_mul(cos2t, pa.cphi[k])),
                                  ap_mul(sin2t, pa.sphi[k]))),
              0.0f);
          const float mk =
              ap_mul(m, ap_mul(ap_pow(c2, pa.steer - 1), pa.inv_norm));
          amped = ap_add(amped, ap_mul(g, mk) >= pa.tau ? mk : 0.0f);
        }
      } else {
        amped = ap_add(amped, ap_mul(g, m) >= pa.tau ? m : 0.0f);
      }
    }
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
    out_re[i] = ap_sub(ap_mul(cr, er), ap_mul(ci, ei));
    out_im[i] = ap_add(ap_mul(cr, ei), ap_mul(ci, er));
  }
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
  const size_t n = (size_t)c * h * w;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 65535 * 32
                                         ? (n + 255) / 256
                                         : 65535 * 32);
  cudaStream_t s = (cudaStream_t)stream;
#define AP_LAUNCH(P, S)                                                     \
  amplify_procedural_kernel<P, S><<<blocks, 256, 0, s>>>(                   \
      cur_re, cur_im, prev_re, prev_im, fy, fx, out_re, out_im, n, h, w, pa)
  if (pa.power >= 0) {
    if (pa.steer) AP_LAUNCH(true, true); else AP_LAUNCH(true, false);
  } else {
    if (pa.steer) AP_LAUNCH(false, true); else AP_LAUNCH(false, false);
  }
#undef AP_LAUNCH
  return (int)cudaGetLastError();
}
