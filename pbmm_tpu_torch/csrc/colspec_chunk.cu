// Kernel 2: column FFT + band/phase pass + column IFFT for a whole chunk,
// the previous frame's spectrum (and the IIR taps) carried on chip.
//
// Replaces pbmm_tpu/spectral/fused.py:1310 colspec_chunk (the Pallas
// kernel launched at :1518), every branch of it, as template parameters:
//   POW2     column heights that are powers of two (square_pow2 and
//            rect_pow2 padding): a radix-2 DIF over the whole column
//            (bit-reversed rows out, fused.py:1454-1457) and the DIT
//            inverse back to natural rows, unnormalised (:1482-1484);
//            else tight heights H = m * 128 through the four-step split
//            (fused.py:471 _fourstep_col);
//   GENERAL  every phase branch of fused.py:865 _phase_block: the
//            standard mode's host w plane and gate (:651, :899-914),
//            steerable sector windows (:725 _sector_weights), per-bin
//            masks where the bands overlap (:707 _eval_mask), and the
//            atan2 + sin/cos rotation of a non-integer scale
//            (:1003-1007); else the main path's branch: host
//            (total, m_amp) planes and the integer power by
//            square-and-multiply (:986-1002), compiled as before;
//   IIR      the streaming band-pass taps lp_fast/lp_slow, two more
//            carried planes (fused.py:766 _iir_filter_delta).
// The planes of chroma="rgb" are the grid's y dimension: each plane's
// frame series carries its own prev spectrum and taps; the rows of the
// chunk are plane-minor, frame-major ([Y0 I0 Q0 Y1 ...]).
//
// Layout contract (identical to the JAX kernel so spectra and carried
// state compare element by element): at pow-2 heights row p holds
// frequency rev(p); at tight heights the forward transform takes natural
// rows to the "fourstep" layout, where row p = 128 k1 + k2 holds
// frequency k1 + m k2.  Inside the block the four-step's 128-point
// factor runs as radix-2 DIF, so the block's own row order is
// 128 k1 + q <-> frequency k1 + m rev7(q); the state, the planes and the
// frequency axis are read and written through that permutation
// (cs_row), and the DIT inverse undoes it.
//
// The TPU grid (planes, lane strips, frames) runs frames in order and
// carries prev in VMEM scratch.  CUDA blocks run in no order, so each
// block owns a strip of S = 4 kept columns of one plane and loops over
// the T frames itself; cur and prev (4 x H x S f32: 72 KB at H = 1152,
// 128 KB at H = 2048) and the IIR taps (2 more planes, 192 KB at 2048)
// stay in shared memory for the whole chunk, and the two spectrum buffers
// swap roles each frame (the phase pass overwrites prev with the modified
// spectrum in place).  H = 4096 would need 256 KB at S = 4 and is refused.
//
// The transcendentals: the TPU kernel evaluates atan2, sin/cos and the
// band's cosine as polynomials (Mosaic has no lowering for them); here
// atan2f, sincosf and cosf (no fast math) compute the same functions to
// within the polynomials' ~1e-8.  atan2f follows IEEE on signed zeros
// (atan2(+0, -0) = pi, atan2(-0, -1) = -pi); the JAX kernel counts -0 as
// +0 and gives 0 at (0, 0), which keeps the IIR taps exactly zero after
// the zero-prev bootstrap, so cs_atan2 adds +0 to both arguments first.
//
// What bounds it on an H100: per frame and column it reads Hc content
// rows and writes r1 - r0 output rows (re+im), ~18 KB per column at
// 1080p, and computes ~H (m + 7) complex FMAs (tight) or 5 H log2(H)
// flops (pow-2) plus the phase chain; the chunk's HBM traffic is the
// kernel-1 output once plus the tail's input once.  Simple and right
// first.

#include "common.cuh"

#define CS_S PBMM_COL_S  // kept columns per block
#define CS_MAXM 16       // largest four-step block count (H <= 2048)
#define CS_MAXH 2048     // tallest column held in shared memory
#define CS_MAXK 16       // most steerable sectors
#define CS_MAXB 16       // most radial levels

// Pointers and sizes of one launch (device pointers; null where a branch
// does not read them).
struct ColspecIO {
  const float* rows_re;
  const float* rows_im;
  const float* prev_re;
  const float* prev_im;
  const float* lpf_in;
  const float* lps_in;
  const float* plane0;  // total (pyramid) or w (standard), (H, Wk)
  const float* plane1;  // m_amp (pyramid)
  const float* fy;      // column frequency per JAX row, (H,)
  const float* fx;      // lane frequency, (Wk,)
  const float* fs_re;   // four-step twiddle, (H,)
  const float* fs_im;
  const float* cw_re;   // four-step combine, (m, m)
  const float* cw_im;
  const float* tw_fre;  // radix-2 tables: 128-point (tight) or H-point
  const float* tw_fim;
  const float* tw_ire;
  const float* tw_iim;
  float* out_re;
  float* out_im;
  float* np_re;
  float* np_im;
  float* lpf_out;
  float* lps_out;
  int t, c, hc, h, wk, row0, r0, r1;
};

// The phase pass's branch and constants (spectral/fused.py::_phase_args
// packs them in this order).
struct PhaseArgs {
  int iir, standard, host_planes, steer, power, n_bands;
  int kind[CS_MAXB];  // 0 zero, 1 high, 2 low, 3 band
  int amp[CS_MAXB];
  float tau2, scale, r_hi, r_lo, inv_norm;
  float cphi[CS_MAXK], sphi[CS_MAXK];  // cos, sin of 2 pi k / K
  float lo[CS_MAXB], hi[CS_MAXB], span[CS_MAXB];
};

// JAX row of block row p: identity at pow-2 heights, the in-block
// bit reversal of the four-step's 128-point factor otherwise.
template <bool POW2>
__device__ __forceinline__ int cs_row(int p) {
  return POW2 ? p : ((p & ~127) | pbmm_rev7(p & 127));
}

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
    float s, c;
    sincosf(d * pl0 * pa.scale, &s, &c);
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

template <bool POW2, bool GENERAL, bool IIR>
__global__ void __launch_bounds__(256)
    colspec_chunk_kernel(ColspecIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  const int h = io.h, wk = io.wk;
  const int hs = h * CS_S;
  float* a_re = smem;  // current frame
  float* a_im = smem + hs;
  float* b_re = smem + 2 * hs;  // previous frame, then the modified one
  float* b_im = smem + 3 * hs;
  float* l_f = smem + 4 * hs;  // IIR taps
  float* l_s = smem + 5 * hs;
  const int m = h / PBMM_LANE;
  const int col0 = blockIdx.x * CS_S;
  const int nt = blockDim.x;
  const int plane = blockIdx.y;
  const size_t soff = (size_t)plane * h * wk;  // this plane's state
  const int hr = io.r1 - io.r0;

  // Carried state in, through the JAX row order.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const size_t g = soff + (size_t)cs_row<POW2>(p) * wk + col0 + c;
    b_re[e] = io.prev_re[g];
    b_im[e] = io.prev_im[g];
    if (IIR) {
      l_f[e] = io.lpf_in[g];
      l_s[e] = io.lps_in[g];
    }
  }

  for (int f = 0; f < io.t; ++f) {
    const size_t n = (size_t)f * io.c + plane;  // this plane's row of f
    const size_t fbase = n * io.hc * wk;
    if (POW2) {
      // 1-3. Zero-embed and the radix-2 DIF (shared with kernel 5).
      pbmm_col_fft_pow2(io.rows_re + fbase, io.rows_im + fbase, io.hc, wk,
                        col0, io.row0, h, io.tw_fre, io.tw_fim, a_re, a_im);
    } else {
      // 1. Zero-embed the content rows at row0.
      pbmm_col_embed(io.rows_re + fbase, io.rows_im + fbase, io.hc, wk,
                     col0, io.row0, h, a_re, a_im);

      // 2. Cross-block m-point DFT, then the four-step twiddle.
      for (int it = threadIdx.x; it < PBMM_LANE * CS_S; it += nt) {
        const int n2 = it / CS_S, c = it % CS_S;
        float xr[CS_MAXM], xi[CS_MAXM];
#pragma unroll
        for (int n1 = 0; n1 < CS_MAXM; ++n1) {
          if (n1 < m) {
            const int e = (n1 * PBMM_LANE + n2) * CS_S + c;
            xr[n1] = a_re[e];
            xi[n1] = a_im[e];
          }
        }
        for (int k1 = 0; k1 < m; ++k1) {
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int n1 = 0; n1 < CS_MAXM; ++n1) {
            if (n1 < m) {
              const float wr = __ldg(io.cw_re + k1 * m + n1);
              const float wi = __ldg(io.cw_im + k1 * m + n1);
              sr += xr[n1] * wr - xi[n1] * wi;
              si += xr[n1] * wi + xi[n1] * wr;
            }
          }
          const int p = k1 * PBMM_LANE + n2;
          const float tr = __ldg(io.fs_re + p), ti = __ldg(io.fs_im + p);
          a_re[p * CS_S + c] = sr * tr - si * ti;
          a_im[p * CS_S + c] = sr * ti + si * tr;
        }
      }
      __syncthreads();

      // 3. 128-point DIF per block: m * S sequences, sequence (k1, c) at
      //    row 128 k1, column c, element stride S.
      pbmm_radix2(a_re, a_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S,
                  1, CS_S, io.tw_fre, io.tw_fim, false);
    }

    // 4. Phase pass against prev; the result replaces prev in place.
    for (int e = threadIdx.x; e < hs; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const int P = cs_row<POW2>(p);
      const size_t g = (size_t)P * wk + col0 + c;  // shared by the planes
      const float cr = a_re[e], ci = a_im[e];
      const float pr = b_re[e], pi = b_im[e];
      float o_r, o_i;
      if (GENERAL) {
        const float pl0 = io.plane0 ? __ldg(io.plane0 + g) : 0.0f;
        const float pl1 = io.plane1 ? __ldg(io.plane1 + g) : 0.0f;
        cs_phase_general<IIR>(cr, ci, pr, pi, __ldg(io.fy + P),
                              __ldg(io.fx + col0 + c), pl0, pl1, l_f + e,
                              l_s + e, pa, o_r, o_i);
      } else {
        const float rr = pr * cr + pi * ci;  // prev * conj(cur)
        const float ri = pi * cr - pr * ci;
        const float min_mag2 = fminf(cr * cr + ci * ci, pr * pr + pi * pi);
        const float mk = __ldg(io.plane1 + g);
        const float tot = __ldg(io.plane0 + g);
        const float amped = (min_mag2 * (mk * mk) >= pa.tau2) ? mk : 0.0f;
        float qr, qi;
        cs_unit_pow(rr, ri, pa.power, qr, qi);
        const float gr = (tot - amped) + amped * qr;
        const float gi = amped * qi;
        o_r = cr * gr - ci * gi;
        o_i = cr * gi + ci * gr;
      }
      b_re[e] = o_r;
      b_im[e] = o_i;
    }
    __syncthreads();

    // 5. Inverse, natural rows out, unnormalised.
    if (POW2) {
      pbmm_radix2(b_re, b_im, h, CS_S, CS_S, 0, 1, CS_S, io.tw_ire,
                  io.tw_iim, true);
    } else {
      // 128-point DIT per block, conj twiddle, conj combine.
      pbmm_radix2(b_re, b_im, PBMM_LANE, m * CS_S, CS_S, PBMM_LANE * CS_S,
                  1, CS_S, io.tw_ire, io.tw_iim, true);
      for (int it = threadIdx.x; it < PBMM_LANE * CS_S; it += nt) {
        const int n2 = it / CS_S, c = it % CS_S;
        float xr[CS_MAXM], xi[CS_MAXM];
#pragma unroll
        for (int k1 = 0; k1 < CS_MAXM; ++k1) {
          if (k1 < m) {
            const int p = k1 * PBMM_LANE + n2;
            const float zr = b_re[p * CS_S + c], zi = b_im[p * CS_S + c];
            const float tr = __ldg(io.fs_re + p), ti = -__ldg(io.fs_im + p);
            xr[k1] = zr * tr - zi * ti;
            xi[k1] = zr * ti + zi * tr;
          }
        }
        for (int n1 = 0; n1 < m; ++n1) {
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int k1 = 0; k1 < CS_MAXM; ++k1) {
            if (k1 < m) {
              const float wr = __ldg(io.cw_re + n1 * m + k1);
              const float wi = -__ldg(io.cw_im + n1 * m + k1);
              sr += xr[k1] * wr - xi[k1] * wi;
              si += xr[k1] * wi + xi[k1] * wr;
            }
          }
          const int e = (n1 * PBMM_LANE + n2) * CS_S + c;
          b_re[e] = sr;
          b_im[e] = si;
        }
      }
      __syncthreads();
    }

    // 6. Rows [r0, r1) of the inverse out.
    const size_t obase = n * hr * wk;
    for (int e = threadIdx.x; e < hr * CS_S; e += nt) {
      const int p = e / CS_S, c = e % CS_S;
      const size_t g = obase + (size_t)p * wk + col0 + c;
      io.out_re[g] = b_re[(p + io.r0) * CS_S + c];
      io.out_im[g] = b_im[(p + io.r0) * CS_S + c];
    }
    __syncthreads();

    // This frame's spectrum is the next frame's prev.
    float* sw;
    sw = a_re; a_re = b_re; b_re = sw;
    sw = a_im; a_im = b_im; b_im = sw;
  }

  // The last frame's spectrum leaves as new_prev (now in b after the
  // swap), with the taps.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / CS_S, c = e % CS_S;
    const size_t g = soff + (size_t)cs_row<POW2>(p) * wk + col0 + c;
    io.np_re[g] = b_re[e];
    io.np_im[g] = b_im[e];
    if (IIR) {
      io.lpf_out[g] = l_f[e];
      io.lps_out[g] = l_s[e];
    }
  }
}

template <bool POW2, bool GENERAL, bool IIR>
static cudaError_t cs_launch(const ColspecIO& io, const PhaseArgs& pa,
                             cudaStream_t stream) {
  const size_t smem = (IIR ? 6 : 4) * (size_t)io.h * CS_S * sizeof(float);
  cudaError_t err =
      pbmm_smem_opt_in(colspec_chunk_kernel<POW2, GENERAL, IIR>, smem);
  if (err != cudaSuccess) return err;
  colspec_chunk_kernel<POW2, GENERAL, IIR>
      <<<dim3(io.wk / CS_S, io.c), 256, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

// iargs: iir, standard, host_planes, steer, power, n_bands, kind[16],
// amp[16]; fargs: tau2, scale, r_hi, r_lo, inv_norm, cphi[16], sphi[16],
// lo[16], hi[16], span[16] (host arrays, copied by value).
extern "C" int pbmm_colspec_chunk(
    const float* rows_re, const float* rows_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* fs_re, const float* fs_im,
    const float* cw_re, const float* cw_im, const float* tw_fre,
    const float* tw_fim, const float* tw_ire, const float* tw_iim,
    float* out_re, float* out_im, float* np_re, float* np_im,
    float* lpf_out, float* lps_out, const int* iargs, const float* fargs,
    int t, int c, int hc, int h, int wk, int row0, int r0, int r1,
    void* stream) {
  PhaseArgs pa;
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
  const bool pow2 = h >= 2 && (h & (h - 1)) == 0;
  const int m = h / PBMM_LANE;
  const bool general = pa.iir || pa.standard || !pa.host_planes ||
                       pa.steer || pa.power < 0;
  if (t < 1 || c < 1 || h > CS_MAXH ||
      (!pow2 && (h != m * PBMM_LANE || m < 1 || m > CS_MAXM)) ||
      wk % CS_S != 0 || hc < 1 || row0 < 0 || row0 + hc > h || r0 < 0 ||
      r1 <= r0 || r1 > h || pa.steer < 0 || pa.steer > CS_MAXK ||
      pa.n_bands < 0 || pa.n_bands > CS_MAXB || pa.power > 64 ||
      (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      (general && (fy == nullptr || fx == nullptr)) ||
      (!pow2 && (fs_re == nullptr || cw_re == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ColspecIO io = {rows_re, rows_im, prev_re, prev_im, lpf_in, lps_in,
                        plane0, plane1, fy, fx, fs_re, fs_im, cw_re, cw_im,
                        tw_fre, tw_fim, tw_ire, tw_iim, out_re, out_im,
                        np_re, np_im, lpf_out, lps_out, t, c, hc, h, wk,
                        row0, r0, r1};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (pow2) {
    err = pa.iir ? cs_launch<true, true, true>(io, pa, s)
          : general ? cs_launch<true, true, false>(io, pa, s)
                    : cs_launch<true, false, false>(io, pa, s);
  } else {
    err = pa.iir ? cs_launch<false, true, true>(io, pa, s)
          : general ? cs_launch<false, true, false>(io, pa, s)
                    : cs_launch<false, false, false>(io, pa, s);
  }
  return (int)err;
}
