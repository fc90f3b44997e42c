// Kernel 12: kernel 6 with its pieces toggled, to split its time.
//
// Replaces benchmarks/kdecomp.py:42 make_variant (the Pallas kernel
// launched at :113): one frame's phase pass + column IFFT with pieces
// switched on and off, so that the difference between two variants is the
// cost of one piece.  The pieces, as template flags:
//   PHASE  phase_pass.cuh's pbmm_phase_bin (off: the strip holds
//          cur + prev, kdecomp.py:74-76);
//   LO     the inverse stages of span 1 .. 64, the seven the TPU runs as
//          its 128 x 128 group matmul (_apply_intra_group, :77-78);
//   HI     the stages of span 128 and more (_run_roll_stages, :88-110).
// Rows [r0, r1) of the result go out.
//
// Design: kernel 6's layout exactly (csrc/phase_col_ifft.cu:57-122): a
// strip of PBMM_COL_S = 4 columns of one frame a block, cur and prev in
// shared memory (128 KB at H = 2048), the same loads, the same phase call
// and the same pbmm_radix2_stage calls on the twiddle rows pbmm_radix2
// uses.  So the full variant (PHASE, LO, HI) computes kernel 6's bits,
// and the other variants differ from it only by the pieces they leave
// out.  IIR taps are not taken (kdecomp times the two-frame pass).
//
// What bounds it on an H100: the same bytes as kernel 6: 4 planes of
// H x W f32 in, 2 x (r1 - r0) x W out; at H = 2048, W = 1152, rows
// (384, 1600): 37.7 MB in, 11.2 MB out, 0.0146 ms at 3.35 TB/s.  The
// design does nothing about that bound: it measures kernel 6's pieces as
// kernel 6 runs them.

#include "common.cuh"
#include "phase_pass.cuh"

#define KD_S PBMM_COL_S
#define KD_MAXH 2048
#define KD_GROUP_STAGES 7  // spans 1 .. 64: inside one 128-row group

struct KdecompIO {
  const float* cur_re;
  const float* cur_im;
  const float* prev_re;
  const float* prev_im;
  const float* plane0;
  const float* plane1;
  const float* fy;
  const float* fx;
  const float* tw_re;  // _dif_twiddles(H, inverse)
  const float* tw_im;
  float* out_re;
  float* out_im;
  int h, w, r0, r1;
};

template <bool PHASE, bool GENERAL, bool LO, bool HI>
__global__ void __launch_bounds__(256)
    kdecomp_kernel(KdecompIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  const int h = io.h, w = io.w;
  const int hs = h * KD_S;
  float* a_re = smem;
  float* a_im = smem + hs;
  float* b_re = smem + 2 * hs;
  float* b_im = smem + 3 * hs;
  const int col0 = blockIdx.x * KD_S;
  const size_t fo = (size_t)blockIdx.y * h * w;
  const int nt = blockDim.x;

  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / KD_S, c = e % KD_S;
    const size_t g = fo + (size_t)p * w + col0 + c;
    a_re[e] = io.cur_re[g];
    a_im[e] = io.cur_im[g];
    b_re[e] = io.prev_re[g];
    b_im[e] = io.prev_im[g];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / KD_S, c = e % KD_S;
    const float cr = a_re[e], ci = a_im[e];
    const float pr = b_re[e], pi = b_im[e];
    float o_r, o_i;
    if (PHASE) {
      const size_t g = (size_t)p * w + col0 + c;
      pbmm_phase_bin<GENERAL, false>(cr, ci, pr, pi, io.plane0, io.plane1, g,
                                     io.fy, p, io.fx, col0 + c, nullptr,
                                     nullptr, pa, o_r, o_i);
    } else {
      o_r = __fadd_rn(cr, pr);
      o_i = __fadd_rn(ci, pi);
    }
    b_re[e] = o_r;
    b_im[e] = o_i;
  }
  __syncthreads();

  // pbmm_radix2's inverse, stage by stage: stage s has span 1 << s and
  // twiddle row s.
  int stages = 0;
  while ((1 << stages) < h) ++stages;
  for (int s = 0; s < stages; ++s) {
    if (s < KD_GROUP_STAGES ? !LO : !HI) continue;
    pbmm_radix2_stage(b_re, b_im, h, 1 << s, KD_S, KD_S, 0, 1, KD_S,
                      io.tw_re + s * h, io.tw_im + s * h, true);
    __syncthreads();
  }

  const int hr = io.r1 - io.r0;
  const size_t obase = (size_t)blockIdx.y * hr * w;
  for (int e = threadIdx.x; e < hr * KD_S; e += nt) {
    const int p = e / KD_S, c = e % KD_S;
    const size_t g = obase + (size_t)p * w + col0 + c;
    io.out_re[g] = b_re[(p + io.r0) * KD_S + c];
    io.out_im[g] = b_im[(p + io.r0) * KD_S + c];
  }
}

template <bool PHASE, bool GENERAL, bool LO, bool HI>
static cudaError_t kd_launch(const KdecompIO& io, const PhaseArgs& pa, int b,
                             cudaStream_t stream) {
  const size_t smem = 4 * (size_t)io.h * KD_S * sizeof(float);
  cudaError_t err =
      pbmm_smem_opt_in(kdecomp_kernel<PHASE, GENERAL, LO, HI>, smem);
  if (err != cudaSuccess) return err;
  kdecomp_kernel<PHASE, GENERAL, LO, HI>
      <<<dim3(io.w / KD_S, b), 256, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

template <bool PHASE, bool GENERAL>
static cudaError_t kd_stages(const KdecompIO& io, const PhaseArgs& pa,
                             int b, bool lo, bool hi, cudaStream_t s) {
  return lo ? (hi ? kd_launch<PHASE, GENERAL, true, true>(io, pa, b, s)
                  : kd_launch<PHASE, GENERAL, true, false>(io, pa, b, s))
            : (hi ? kd_launch<PHASE, GENERAL, false, true>(io, pa, b, s)
                  : kd_launch<PHASE, GENERAL, false, false>(io, pa, b, s));
}

// pieces: bit 0 phase, bit 1 the span < 128 stages ("gm"), bit 2 the span
// >= 128 stages ("rolls").  iargs/fargs as for pbmm_phase_col_ifft (read
// only with the phase piece); the IIR branch is refused.
extern "C" int pbmm_kdecomp(const float* cur_re, const float* cur_im,
                            const float* prev_re, const float* prev_im,
                            const float* plane0, const float* plane1,
                            const float* fy, const float* fx,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im, const int* iargs,
                            const float* fargs, int pieces, int b, int h,
                            int w, int r0, int r1, void* stream) {
  const bool phase = pieces & 1, lo = pieces & 2, hi = pieces & 4;
  PhaseArgs pa = {};
  bool general = false;
  if (phase) {
    if (!pbmm_phase_unpack(iargs, fargs, pa) || pa.iir)
      return (int)cudaErrorInvalidValue;
    general = pbmm_phase_general(pa);
    if ((pa.host_planes && plane0 == nullptr) ||
        (pa.host_planes && !pa.standard && plane1 == nullptr) ||
        (!general && (plane0 == nullptr || plane1 == nullptr)) ||
        (general && (fy == nullptr || fx == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  if (pieces < 0 || pieces > 7 || b < 1 || b > 65535 || h < 2 ||
      (h & (h - 1)) != 0 || h > KD_MAXH || w < KD_S || w % KD_S != 0 ||
      r0 < 0 || r1 <= r0 || r1 > h)
    return (int)cudaErrorInvalidValue;
  const KdecompIO io = {cur_re, cur_im, prev_re, prev_im, plane0, plane1,
                        fy,     fx,     tw_re,   tw_im,   out_re, out_im,
                        h,      w,      r0,      r1};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      !phase    ? kd_stages<false, false>(io, pa, b, lo, hi, s)
      : general ? kd_stages<true, true>(io, pa, b, lo, hi, s)
                : kd_stages<true, false>(io, pa, b, lo, hi, s);
  return (int)err;
}
