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
// Design: kernel 6's first layout (a probe keeps the design it measures):
// a strip of S columns of one frame a block (4 up to H = 2048, 2 up to
// 4096, 1 up to 8192: common.cuh's pbmm_col_strip), cur and prev in
// shared memory (128 KB at H = 2048, 4096 and 8192), the phase pass's
// pbmm_phase_bin and the stage-by-stage pbmm_radix2_stage calls on the twiddle rows pbmm_radix2 uses.  Kernel 6
// now runs kernel 2's in-block register passes (csrc/phase_inv.cuh), which
// compute pbmm_radix2's bits, so the full variant (PHASE, LO, HI) still
// equals kernel 6 bit for bit (chip_smoke.py), and the other variants
// differ from it only by the pieces they leave out.  IIR taps are not
// taken (kdecomp times the two-frame pass).
//
// Above 8192 rows the kernel runs on every 8192-row block of the column
// (one launch a block, strips of 1, the block's planes and frequencies at
// the column's frame stride) into a scratch, then col_pass.cuh's inverse
// bracket (its stages of span >= 8192 are HI's): kernel 6's split, so the
// full variant still equals kernel 6.  Without HI the blocks write their
// rows of [r0, r1) straight out.
//
// What bounds it on an H100: the same bytes as kernel 6: 4 planes of
// H x W f32 in, 2 x (r1 - r0) x W out; at H = 2048, W = 1152, rows
// (384, 1600): 37.7 MB in, 11.2 MB out, 0.0146 ms at 3.35 TB/s.  The
// design does nothing about that bound: it measures kernel 6's pieces as
// kernel 6 runs them.

#include "col_pass.cuh"
#include "common.cuh"
#include "phase_pass.cuh"

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
  size_t fs;  // frame stride of the spectra (floats; H W)
  size_t os;  // frame stride of the output ((r1 - r0) W)
};

template <bool PHASE, bool GENERAL, bool LO, bool HI, int KD_S>
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
  const size_t fo = (size_t)blockIdx.y * io.fs;
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
  const size_t obase = (size_t)blockIdx.y * io.os;
  for (int e = threadIdx.x; e < hr * KD_S; e += nt) {
    const int p = e / KD_S, c = e % KD_S;
    const size_t g = obase + (size_t)p * w + col0 + c;
    io.out_re[g] = b_re[(p + io.r0) * KD_S + c];
    io.out_im[g] = b_im[(p + io.r0) * KD_S + c];
  }
}

template <bool PHASE, bool GENERAL, bool LO, bool HI, int KD_S>
static cudaError_t kd_run(const KdecompIO& io, const PhaseArgs& pa, int b,
                          cudaStream_t stream) {
  const size_t smem = 4 * (size_t)io.h * KD_S * sizeof(float);
  const cudaError_t err =
      pbmm_smem_opt_in(kdecomp_kernel<PHASE, GENERAL, LO, HI, KD_S>, smem);
  if (err != cudaSuccess) return err;
  kdecomp_kernel<PHASE, GENERAL, LO, HI, KD_S>
      <<<dim3(io.w / KD_S, b), 256, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

// The strip of pbmm_col_strip(h): 4, 2 or 1 columns.
template <bool PHASE, bool GENERAL, bool LO, bool HI>
static cudaError_t kd_launch(const KdecompIO& io, const PhaseArgs& pa, int b,
                             cudaStream_t stream) {
  switch (pbmm_col_strip(io.h)) {
    case 4: return kd_run<PHASE, GENERAL, LO, HI, 4>(io, pa, b, stream);
    case 2: return kd_run<PHASE, GENERAL, LO, HI, 2>(io, pa, b, stream);
    default: return kd_run<PHASE, GENERAL, LO, HI, 1>(io, pa, b, stream);
  }
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
// only with the phase piece); the IIR branch is refused.  tw_re / tw_im:
// _dif_twiddles(min(h, 8192), inverse=True); above 8192 rows with the
// "rolls" piece, tb_re / tb_im: compact_twiddles(h, inverse=True) and sp_re
// / sp_im a (b, h, w) scratch (else unread).
extern "C" int pbmm_kdecomp(const float* cur_re, const float* cur_im,
                            const float* prev_re, const float* prev_im,
                            const float* plane0, const float* plane1,
                            const float* fy, const float* fx,
                            const float* tw_re, const float* tw_im,
                            const float* tb_re, const float* tb_im,
                            float* out_re, float* out_im, float* sp_re,
                            float* sp_im, const int* iargs,
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
  const int sw = pbmm_col_strip(h);
  const bool bracket = h > PBMM_BK_N;
  if (pieces < 0 || pieces > 7 || b < 1 || b > 65535 || h < 2 ||
      (h & (h - 1)) != 0 || w < sw || w % sw != 0 || r0 < 0 || r1 <= r0 ||
      r1 > h || (bracket && hi && (tb_re == nullptr || tb_im == nullptr ||
                                   sp_re == nullptr || sp_im == nullptr)))
    return (int)cudaErrorInvalidValue;
  const KdecompIO io = {cur_re, cur_im, prev_re, prev_im, plane0, plane1,
                        fy,     fx,     tw_re,   tw_im,   out_re, out_im,
                        h,      w,      r0,      r1,      (size_t)h * w,
                        (size_t)(r1 - r0) * w};
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](const KdecompIO& v) {
    return !phase    ? kd_stages<false, false>(v, pa, b, lo, hi, s)
           : general ? kd_stages<true, true>(v, pa, b, lo, hi, s)
                     : kd_stages<true, false>(v, pa, b, lo, hi, s);
  };
  if (!bracket) return (int)run(io);
  // Every 8192-row block of every frame, then the inverse bracket (or,
  // without it, each block's rows of [r0, r1) out).
  const size_t bw = (size_t)PBMM_BK_N * w;
  for (int k = 0; k < h / PBMM_BK_N; ++k) {
    const int y0 = k * PBMM_BK_N;
    const int b0 = hi ? 0 : (r0 > y0 ? r0 - y0 : 0);
    const int b1 = hi ? PBMM_BK_N
                      : (r1 - y0 < PBMM_BK_N ? r1 - y0 : PBMM_BK_N);
    if (b1 <= b0) continue;
    const size_t o = k * bw;
    KdecompIO v = io;
    v.cur_re += o;
    v.cur_im += o;
    v.prev_re += o;
    v.prev_im += o;
    if (plane0) v.plane0 += o;
    if (plane1) v.plane1 += o;
    if (fy) v.fy += (size_t)y0;
    if (hi) {
      v.out_re = sp_re + o;
      v.out_im = sp_im + o;
      v.os = io.fs;
    } else {
      v.out_re = out_re + (size_t)(y0 + b0 - r0) * w;
      v.out_im = out_im + (size_t)(y0 + b0 - r0) * w;
    }
    v.h = PBMM_BK_N;
    v.r0 = b0;
    v.r1 = b1;
    const cudaError_t err = run(v);
    if (err != cudaSuccess) return (int)err;
  }
  if (!hi) return (int)cudaSuccess;
  const PbmmColPass inv = {sp_re, sp_im, out_re, out_im, tb_re, tb_im,
                           h,     w,     r1 - r0, r0,   0,     0,
                           1.0f,  0,     io.fs,  io.os};
  return (int)pbmm_bracket_cols(inv, b, true, s);
}
