// The band/phase pass of kernels 2 and 6: every branch of
// pbmm_tpu/spectral/fused.py:865 _phase_block on one bin, as __device__
// code both kernels inline, so the same spectra give the same bits in
// both (kernel 6's output rows equal kernel 2's bit for bit).
//
// The transcendentals: the TPU kernel evaluates atan2, sin/cos and the
// band's cosine as polynomials (Mosaic has no lowering for them); here
// atan2f, sincosf and cosf (no fast math) compute the same functions to
// within the polynomials' ~1e-8.  atan2f follows IEEE on signed zeros
// (atan2(+0, -0) = pi, atan2(-0, -1) = -pi); the JAX kernel counts -0 as
// +0 and gives 0 at (0, 0), which keeps the IIR taps exactly zero after
// the zero-prev bootstrap, so cs_atan2 adds +0 to both arguments first.
#pragma once

#include "common.cuh"

#define CS_MAXK 16  // most steerable sectors
#define CS_MAXB 16  // most radial levels

// The phase pass's branch and constants (spectral/fused.py::_phase_args
// packs them in this order).  std_weight: standard mode without a host
// plane (the sharded engines' per-shard frequencies, fx_values) evaluates
// its weight w(f) per bin from the terms after span (fused.py:619
// _standard_weight_block).
struct PhaseArgs {
  int iir, standard, host_planes, steer, power, n_bands;
  int kind[CS_MAXB];  // 0 zero, 1 high, 2 low, 3 band
  int amp[CS_MAXB];
  int std_weight, bandpass, steep_pow;  // steep_pow: -1 for exp / log
  float tau2, scale, r_hi, r_lo, inv_norm;
  float cphi[CS_MAXK], sphi[CS_MAXK];  // cos, sin of 2 pi k / K
  float lo[CS_MAXB], hi[CS_MAXB], span[CS_MAXB];
  // 1 / 0.707, the cutoffs, 1 / max(lc, 1e-3), 1 / max(1 - hc, 1e-3),
  // the steepness, sensitivity, edge gain (0: off) and hc - lc.
  float f_scale, lc, hc, inv_lo, inv_hi, steep, sens, edge, mid_span;
};

// unit(prev * conj(cur)) ** power by square-and-multiply.
__device__ __forceinline__ void cs_unit_pow(float rr, float ri, int power,
                                            float& qr, float& qi) {
  const float m2 = rr * rr + ri * ri;
  // 1e-38 is subnormal: built without -ftz so it survives.
  const float inv = m2 > 0.0f ? 1.0f / sqrtf(fmaxf(m2, 1e-38f)) : 0.0f;
  float br = rr * inv, bi = ri * inv;
  qr = 1.0f;
  qi = 0.0f;
  for (int n = power; n > 0; n >>= 1) {
    if (n & 1) {
      const float tr = qr * br - qi * bi;
      qi = qr * bi + qi * br;
      qr = tr;
    }
    const float sr = br * br - bi * bi;
    bi = 2.0f * br * bi;
    br = sr;
  }
}

// atan2 with the JAX kernel's zero convention (see the header).
__device__ __forceinline__ float cs_atan2(float y, float x) {
  return atan2f(__fadd_rn(y, 0.0f), __fadd_rn(x, 0.0f));
}

// x ** n, integer n >= 0, in the product order of fused.py:602
// _pow_static.
__device__ __forceinline__ float cs_pow_int(float x, int n) {
  float acc = 1.0f, base = x;
  bool any = false;
  for (; n > 0; n >>= 1) {
    if (n & 1) {
      acc = any ? acc * base : base;
      any = true;
    }
    base = base * base;
  }
  return acc;
}

// One radial level's mask at frequency f (fused.py:707 _eval_mask).
__device__ __forceinline__ float cs_mask(int kind, float lo, float hi,
                                         float span, float f) {
  if (kind == 0) return 0.0f;
  const float t = fminf(fmaxf((f - lo) / span, 0.0f), 1.0f);
  if (kind == 1)
    return f > hi ? 1.0f : (f > lo ? t * t * (3.0f - 2.0f * t) : 0.0f);
  if (kind == 2)
    return f < lo ? 1.0f
                  : (f < hi ? 1.0f - t * t * (3.0f - 2.0f * t) : 0.0f);
  const float band = 0.5f * (1.0f + cosf(6.2831855f * (t - 0.5f)));
  return (f >= lo && f <= hi) ? band : 0.0f;
}

// The gated amplified part of mask m: m itself where it passes the
// magnitude gate, or, steerable, the sum over the K sector windows
// m * a_k that pass theirs (fused.py:928-936, :972-981).
__device__ __forceinline__ float cs_gated(float m, float min_mag2,
                                          float cos2t, float sin2t,
                                          const PhaseArgs& pa) {
  if (!pa.steer) return (min_mag2 * (m * m) >= pa.tau2) ? m : 0.0f;
  float amped = 0.0f;
  for (int k = 0; k < pa.steer; ++k) {
    const float c2 = fmaxf(
        0.5f * (1.0f + cos2t * pa.cphi[k] + sin2t * pa.sphi[k]), 0.0f);
    const float mk = m * (cs_pow_int(c2, pa.steer - 1) * pa.inv_norm);
    amped += (min_mag2 * (mk * mk) >= pa.tau2) ? mk : 0.0f;
  }
  return amped;
}

// The standard mode's weight w(f) at frequency (fy, fx), in the JAX
// kernel's order (fused.py:619 _standard_weight_block: pow by squaring for
// an integer steepness to 16, else exp / log; sin(pi t) as cos(pi (t -
// 1/2))), each product and sum rounded on its own: these bins are kernel
// 6's alone, and the rounding must not follow nvcc's contraction.
__device__ __forceinline__ float cs_standard_weight(float fy, float fx,
                                                    const PhaseArgs& pa) {
  const float freq = sqrtf(__fadd_rn(__fmul_rn(fy, fy), __fmul_rn(fx, fx)));
  const float f = fminf(__fmul_rn(freq, pa.f_scale), 1.0f);
  if (!pa.bandpass) return 1.0f;
  float w = 1.0f;
  if (f < pa.lc || f > pa.hc) {
    const float x = f < pa.lc ? __fmul_rn(f, pa.inv_lo)
                              : __fmul_rn(__fsub_rn(1.0f, f), pa.inv_hi);
    w = pa.steep_pow >= 0
            ? cs_pow_int(x, pa.steep_pow)
            : expf(__fmul_rn(pa.steep, logf(fmaxf(x, 1e-38f))));
  }
  w = __fmul_rn(w, pa.sens);
  if (pa.edge != 0.0f && f > pa.lc && f < pa.hc) {
    const float t =
        fminf(fmaxf(__fdiv_rn(__fsub_rn(f, pa.lc), pa.mid_span), 0.0f), 1.0f);
    const float s = cosf(__fmul_rn(3.14159265f, __fsub_rn(t, 0.5f)));
    w = __fmul_rn(w, __fadd_rn(1.0f, __fmul_rn(pa.edge, s)));
  }
  return fmaxf(w, 0.0f);
}

// Every branch of fused.py:865 _phase_block on one bin: cur (cr, ci)
// against prev (pr, pi) at frequency (fy, fx), host planes pl0/pl1,
// IIR taps updated in place.
template <bool IIR>
__device__ __forceinline__ void cs_phase_general(
    float cr, float ci, float pr, float pi, float fy, float fx, float pl0,
    float pl1, float* lpf, float* lps, const PhaseArgs& pa, float& out_r,
    float& out_i) {
  // prev * conj(cur), and the taps, rounded op by op as the plain
  // version computes them: near the branch cut (Re < 0, Im ~ 0) a
  // contracted FMA could flip the sign of Im, and the angle by 2 pi.
  const float rr = __fadd_rn(__fmul_rn(pr, cr), __fmul_rn(pi, ci));
  const float ri = __fsub_rn(__fmul_rn(pi, cr), __fmul_rn(pr, ci));
  float d_iir = 0.0f;
  if (IIR) {
    const float d = cs_atan2(ri, rr);
    *lpf = __fadd_rn(*lpf, __fmul_rn(pa.r_hi, __fsub_rn(d, *lpf)));
    *lps = __fadd_rn(*lps, __fmul_rn(pa.r_lo, __fsub_rn(d, *lps)));
    d_iir = __fsub_rn(*lpf, *lps);
  }
  if (pa.standard) {
    const float d = IIR ? d_iir : cs_atan2(ri, rr);
    const float w = pa.host_planes ? pl0 : cs_standard_weight(fy, fx, pa);
    float s, c;
    sincosf(d * w * pa.scale, &s, &c);
    const bool pass =
        (cr * cr + ci * ci) < pa.tau2 || (pr * pr + pi * pi) < pa.tau2;
    out_r = pass ? cr : cr * c - ci * s;
    out_i = pass ? ci : cr * s + ci * c;
    return;
  }
  const float min_mag2 = fminf(cr * cr + ci * ci, pr * pr + pi * pi);
  float cos2t = 1.0f, sin2t = 0.0f;
  if (pa.steer) {  // the double angle of (fx, fy); theta = 0 at DC
    const float r2 = fx * fx + fy * fy;
    const float inv_r2 = r2 > 0.0f ? 1.0f / fmaxf(r2, 1e-38f) : 0.0f;
    cos2t = r2 > 0.0f ? (fx * fx - fy * fy) * inv_r2 : 1.0f;
    sin2t = 2.0f * fx * fy * inv_r2;
  }
  float total, amped;
  if (pa.host_planes) {
    total = pl0;
    amped = cs_gated(pl1, min_mag2, cos2t, sin2t, pa);
  } else {
    const float f = sqrtf(fy * fy + fx * fx);
    total = 0.0f;
    amped = 0.0f;
    for (int b = 0; b < pa.n_bands; ++b) {
      const float m = cs_mask(pa.kind[b], pa.lo[b], pa.hi[b], pa.span[b], f);
      total += m;
      if (pa.amp[b]) amped += cs_gated(m, min_mag2, cos2t, sin2t, pa);
    }
  }
  float qr, qi;
  if (pa.power >= 0) {
    cs_unit_pow(rr, ri, pa.power, qr, qi);
  } else {
    sincosf(pa.scale * (IIR ? d_iir : cs_atan2(ri, rr)), &qi, &qr);
  }
  const float gr = (total - amped) + amped * qr;
  const float gi = amped * qi;
  out_r = cr * gr - ci * gi;
  out_i = cr * gi + ci * gr;
}

// The main path's branch on one bin (host planes, integer power): cur
// (cr, ci) against prev (pr, pi), the host planes' m_amp and total values
// from mk_of() and tot_of(), called where the products need them (from
// device memory in kernel 2's original order: loading them ahead of the
// products cost kernel 2's four-step main branch 16 % on an H100, 3.22-3.25
// against 2.78 ms a 1080p chunk; or from the phase strip's ring).
template <class Mk, class Tot>
__device__ __forceinline__ void cs_phase_main(float cr, float ci, float pr,
                                              float pi, Mk&& mk_of,
                                              Tot&& tot_of,
                                              const PhaseArgs& pa,
                                              float& o_r, float& o_i) {
  const float rr = pr * cr + pi * ci;  // prev * conj(cur)
  const float ri = pi * cr - pr * ci;
  const float min_mag2 = fminf(cr * cr + ci * ci, pr * pr + pi * pi);
  const float mk = mk_of();
  const float tot = tot_of();
  const float amped = (min_mag2 * (mk * mk) >= pa.tau2) ? mk : 0.0f;
  float qr, qi;
  cs_unit_pow(rr, ri, pa.power, qr, qi);
  const float gr = (tot - amped) + amped * qr;
  const float gi = amped * qi;
  o_r = cr * gr - ci * gi;
  o_i = cr * gi + ci * gr;
}

// One bin of the phase pass: cur (cr, ci) against prev (pr, pi); host
// planes plane0/plane1 (total and m_amp, or the standard mode's w; null
// where absent) at element g; frequency fy[row], fx[lane]; IIR taps
// updated in place.  GENERAL false is the main path's branch
// (cs_phase_main), compiled on its own.  Each branch keeps kernel 2's
// original order of loads and arithmetic.
template <bool GENERAL, bool IIR>
__device__ __forceinline__ void pbmm_phase_bin(
    float cr, float ci, float pr, float pi, const float* plane0,
    const float* plane1, size_t g, const float* fy, int row,
    const float* fx, int lane, float* lpf, float* lps, const PhaseArgs& pa,
    float& o_r, float& o_i) {
  if (GENERAL) {
    const float pl0 = plane0 ? __ldg(plane0 + g) : 0.0f;
    const float pl1 = plane1 ? __ldg(plane1 + g) : 0.0f;
    cs_phase_general<IIR>(cr, ci, pr, pi, __ldg(fy + row), __ldg(fx + lane),
                          pl0, pl1, lpf, lps, pa, o_r, o_i);
    return;
  }
  cs_phase_main(
      cr, ci, pr, pi, [&] { return __ldg(plane1 + g); },
      [&] { return __ldg(plane0 + g); }, pa, o_r, o_i);
}

// Whether a PhaseArgs needs the general pass.
static inline bool pbmm_phase_general(const PhaseArgs& pa) {
  return pa.iir || pa.standard || !pa.host_planes || pa.steer ||
         pa.power < 0;
}

// PhaseArgs from the host arrays spectral/fused.py::_phase_args packs:
// iargs: iir, standard, host_planes, steer, power, n_bands, kind[16],
// amp[16], std_weight, bandpass, steep_pow; fargs: tau2, scale, r_hi,
// r_lo, inv_norm, cphi[16], sphi[16], lo[16], hi[16], span[16], f_scale,
// lc, hc, inv_lo, inv_hi, steep, sens, edge, mid_span.  False when a
// count is out of range, or for standard mode with neither its host
// plane nor the weight's terms (it would rotate by nothing).
static inline bool pbmm_phase_unpack(const int* iargs, const float* fargs,
                                     PhaseArgs& pa) {
  pa.iir = iargs[0];
  pa.standard = iargs[1];
  pa.host_planes = iargs[2];
  pa.steer = iargs[3];
  pa.power = iargs[4];
  pa.n_bands = iargs[5];
  for (int b = 0; b < CS_MAXB; ++b) {
    pa.kind[b] = iargs[6 + b];
    pa.amp[b] = iargs[6 + CS_MAXB + b];
  }
  pa.std_weight = iargs[6 + 2 * CS_MAXB];
  pa.bandpass = iargs[7 + 2 * CS_MAXB];
  pa.steep_pow = iargs[8 + 2 * CS_MAXB];
  pa.tau2 = fargs[0];
  pa.scale = fargs[1];
  pa.r_hi = fargs[2];
  pa.r_lo = fargs[3];
  pa.inv_norm = fargs[4];
  for (int k = 0; k < CS_MAXK; ++k) {
    pa.cphi[k] = fargs[5 + k];
    pa.sphi[k] = fargs[5 + CS_MAXK + k];
  }
  for (int b = 0; b < CS_MAXB; ++b) {
    pa.lo[b] = fargs[5 + 2 * CS_MAXK + b];
    pa.hi[b] = fargs[5 + 2 * CS_MAXK + CS_MAXB + b];
    pa.span[b] = fargs[5 + 2 * CS_MAXK + 2 * CS_MAXB + b];
  }
  const float* wt = fargs + 5 + 2 * CS_MAXK + 3 * CS_MAXB;
  pa.f_scale = wt[0];
  pa.lc = wt[1];
  pa.hc = wt[2];
  pa.inv_lo = wt[3];
  pa.inv_hi = wt[4];
  pa.steep = wt[5];
  pa.sens = wt[6];
  pa.edge = wt[7];
  pa.mid_span = wt[8];
  return pa.steer >= 0 && pa.steer <= CS_MAXK && pa.n_bands >= 0 &&
         pa.n_bands <= CS_MAXB && pa.power <= 64 && pa.steep_pow <= 16 &&
         (!pa.standard || pa.host_planes || pa.std_weight);
}
