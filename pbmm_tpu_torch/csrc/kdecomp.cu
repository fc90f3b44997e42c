// Kernel 12: kernel 6 with its pieces toggled, to split its time.
//
// Replaces benchmarks/kdecomp.py:42 make_variant (the Pallas kernel
// launched at :113): one frame's phase pass + column IFFT with pieces
// switched on and off, so that the difference between two variants is the
// cost of one piece.  The pieces:
//   phase  phase_pass.cuh's phase bin (off: the strip holds cur + prev,
//          kdecomp.py:74-76, so that with no other piece the variant
//          times the stream: the phase strip's loads, on strips of 4 and
//          more its asynchronous copies of cur and prev through the ring,
//          and the rows out; the phase piece adds the host planes' copies
//          and the arithmetic on the main branch, and on the general pass
//          runs the element loads);
//   gm     the inverse stages of span 1 .. 64, the seven the TPU runs as
//          its 128 x 128 group matmul (_apply_intra_group, :77-78):
//          stages [0, 7);
//   rolls  the stages of span 128 and more (_run_roll_stages, :88-110):
//          stages [7, log2 H).
// Rows [r0, r1) of the result go out.
//
// Design: the body kernel 6 runs (csrc/phase_col_ifft.cu), which is kernel
// 2's launch 2 (csrc/colspec_chunk.cu) at pow-2 heights, with its pieces as
// template arguments, so that the probe measures the code that runs.  A
// block of 512 threads owns a strip of S columns of one frame (grid: W / S
// strips x B frames, S from spectral/fused.py::phase_col_strip, the strip
// kernel 6 takes on the same planes: 16 up to H = 1024, 8 to 2048, 4 to
// 4096, 2 to 8192).  phase_inv.cuh's pbmm_phase_strip brings cur and prev
// into the swizzled strip (2 H S floats; the ring of prev words, and of
// the host planes with the phase piece on the main branch, past it:
// pbmm_ps_smem; the general pass element by element), through the phase
// pass or as cur + prev; the inverse runs
// col_pass.cuh's in-block register passes over the stage range of the
// pieces: gm [0, 7), rolls [7, log2 H), both the whole transform in kernel
// 6's plan, and the last pass writes the rows.  With neither, the strip's rows go out as they are.
// Every stage is pbmm_radix2's, bit for bit, so the full variant is
// kernel 6 bit for bit (chip_smoke.py) and a partial one is the
// stage-by-stage transform restricted to its stages.  IIR taps are not
// taken (kdecomp times the two-frame pass).
//
// Above 8192 rows the kernel runs on every 8192-row block of the column
// (one launch a block, the block's planes and frequencies at the column's
// frame stride) into a scratch, then col_pass.cuh's inverse bracket (its
// stages of span >= 8192 are rolls'): kernel 6's split, so the full
// variant still equals kernel 6.  Without rolls the blocks write their
// rows of [r0, r1) straight out.
//
// What bounds it on an H100: the same bytes as kernel 6: 4 planes of
// H x W f32 in, 2 x (r1 - r0) x W out; at H = 2048, W = 1152, rows
// (384, 1600): 37.7 MB in, 11.2 MB out, 0.0146 ms at 3.35 TB/s, against
// 5 H log2(H) flops a column and the phase chain: bytes bound.  The probe
// adds nothing to kernel 6's design; its full variant is kernel 6's launch.

#include "col_pass.cuh"
#include "common.cuh"
#include "phase_inv.cuh"

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
  const float* tw_re;  // compact_twiddles(H, inverse)
  const float* tw_im;
  float* out_re;
  float* out_im;
  int h, w, r0, r1;
  size_t fs;  // frame stride of the spectra (floats; H W)
  size_t os;  // frame stride of the output ((r1 - r0) W)
};

// The block's strip of one frame: the phase pass, or cur + prev.
template <int S, bool PHASE, bool GENERAL>
__device__ __forceinline__ void kd_fill(const KdecompIO& io,
                                        const PhaseArgs& pa, float* sre,
                                        float* sim) {
  const size_t fo = (size_t)blockIdx.y * io.fs;
  pbmm_phase_strip<S, true, GENERAL, false, PHASE>(
      io.cur_re + fo, io.cur_im + fo, io.prev_re + fo, io.prev_im + fo,
      nullptr, nullptr, nullptr, nullptr, io.plane0, io.plane1, io.fy, io.fx,
      pa, io.h, io.w, blockIdx.x * S, sre, sim);
}

// Stages [SB, SE) of the inverse at H = 2^NLOG, rows [r0, r1) out.
template <int NLOG, int S, bool PHASE, bool GENERAL, int SB, int SE>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    kdecomp_kernel(KdecompIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + (S << NLOG);
  kd_fill<S, PHASE, GENERAL>(io, pa, sre, sim);
  const size_t ob = (size_t)blockIdx.y * io.os + blockIdx.x * S;
  pbmm_inv_rows_pow2<NLOG, S, SB, SE>(sre, sim, io.tw_re, io.tw_im,
                                      io.out_re + ob, io.out_im + ob, io.w,
                                      io.r0, io.r1 - io.r0);
}

// No stage: the strip's rows [r0, r1) out as they are.
template <int S, bool PHASE, bool GENERAL>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    kdecomp_rows_kernel(KdecompIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + (size_t)io.h * S;
  kd_fill<S, PHASE, GENERAL>(io, pa, sre, sim);
  // From the aligned run of 32 / S rows that holds r0: a warp's rows are
  // one run, on 32 distinct banks.
  constexpr int LS = pbmm_log2(S);
  const int ra = io.r0 & ~((32 >> LS) - 1);
  const size_t ob = (size_t)blockIdx.y * io.os + blockIdx.x * S;
  for (int e = threadIdx.x; e < (io.r1 - ra) * S; e += blockDim.x) {
    const int p = ra + (e >> LS), c = e & (S - 1);
    if (p < io.r0) continue;
    const int i = pbmm_cb_idx<S>(p, c);
    const size_t o = ob + (size_t)(p - io.r0) * io.w + c;
    io.out_re[o] = sre[i];
    io.out_im[o] = sim[i];
  }
}

// words: a thread's words a slot of the phase strip's ring
// (pbmm_ps_words).
template <class K>
static cudaError_t kd_run(K kernel, const KdecompIO& io, const PhaseArgs& pa,
                          int b, int s, int words, cudaStream_t stream) {
  const size_t smem = pbmm_ps_smem(io.h, s, PBMM_CB_THREADS, words);
  const cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(io.w / s, b), PBMM_CB_THREADS, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

// The stage range of the pieces gm and rolls at H = 2^NLOG: both, or gm
// where rolls has no stage, the whole inverse in kernel 6's plan.
template <int NLOG, int S, bool PHASE, bool GENERAL>
static cudaError_t kd_stages(const KdecompIO& io, const PhaseArgs& pa,
                             int b, bool gm, bool rolls, cudaStream_t st) {
  constexpr int G = NLOG < KD_GROUP_STAGES ? NLOG : KD_GROUP_STAGES;
  constexpr int WORDS = pbmm_ps_words(PHASE, GENERAL);
  if (gm && (rolls || G == NLOG))
    return kd_run(kdecomp_kernel<NLOG, S, PHASE, GENERAL, 0, NLOG>, io, pa,
                  b, S, WORDS, st);
  if constexpr (G < NLOG) {
    if (gm)
      return kd_run(kdecomp_kernel<NLOG, S, PHASE, GENERAL, 0, G>, io, pa, b,
                    S, WORDS, st);
    if (rolls)
      return kd_run(kdecomp_kernel<NLOG, S, PHASE, GENERAL, G, NLOG>, io, pa,
                    b, S, WORDS, st);
  }
  return kd_run(kdecomp_rows_kernel<S, PHASE, GENERAL>, io, pa, b, S, WORDS,
                st);
}

template <int NLOG, int S>
static cudaError_t kd_branch(const KdecompIO& io, const PhaseArgs& pa,
                             bool phase, bool general, int b, bool gm,
                             bool rolls, cudaStream_t st) {
  return !phase    ? kd_stages<NLOG, S, false, false>(io, pa, b, gm, rolls, st)
         : general ? kd_stages<NLOG, S, true, true>(io, pa, b, gm, rolls, st)
                   : kd_stages<NLOG, S, true, false>(io, pa, b, gm, rolls,
                                                     st);
}

// The strips kernel 6 takes at H = 2^NLOG (phase_col_ifft.cu's pc_strip):
// kernel 2's strip S2, S2 / 2 and pbmm_col_strip.
template <int NLOG, int S2>
static cudaError_t kd_strip(const KdecompIO& io, const PhaseArgs& pa,
                            bool phase, bool general, int b, bool gm,
                            bool rolls, int s, cudaStream_t st) {
  constexpr int S4 = pbmm_col_strip(1 << NLOG);
  if (s == S2)
    return kd_branch<NLOG, S2>(io, pa, phase, general, b, gm, rolls, st);
  if (s == S2 / 2)
    return kd_branch<NLOG, S2 / 2>(io, pa, phase, general, b, gm, rolls, st);
  if (s == S4 && S4 < S2 / 2)
    return kd_branch<NLOG, (S4 < S2 / 2 ? S4 : S2)>(io, pa, phase, general, b,
                                                    gm, rolls, st);
  return cudaErrorInvalidValue;
}

static cudaError_t kd_height(const KdecompIO& io, const PhaseArgs& pa,
                             bool phase, bool general, int b, bool gm,
                             bool rolls, int s, cudaStream_t st) {
  switch (io.h) {
#define KD_H(NLOG, S2) \
  case 1 << NLOG:      \
    return kd_strip<NLOG, S2>(io, pa, phase, general, b, gm, rolls, s, st);
    KD_H(1, 16) KD_H(2, 16) KD_H(3, 16) KD_H(4, 16) KD_H(5, 16) KD_H(6, 16)
    KD_H(7, 16) KD_H(8, 16) KD_H(9, 16) KD_H(10, 16) KD_H(11, 8)
    KD_H(12, 4) KD_H(13, 2)
#undef KD_H
    default: return cudaErrorInvalidValue;
  }
}

// pieces: bit 0 phase, bit 1 the span < 128 stages ("gm"), bit 2 the span
// >= 128 stages ("rolls").  iargs/fargs as for pbmm_phase_col_ifft (read
// only with the phase piece); the IIR branch is refused.  tw_re / tw_im:
// compact_twiddles(h, inverse=True); s: the strip (phase_col_strip, of the
// 8192-row block above 8192 rows); above 8192 rows with the "rolls" piece,
// sp_re / sp_im a (b, h, w) scratch (else unread).  Off the general pass,
// on strips of 4 and more, cur and prev (and the host planes with the
// phase piece) start on 16 bytes.
extern "C" int pbmm_kdecomp(const float* cur_re, const float* cur_im,
                            const float* prev_re, const float* prev_im,
                            const float* plane0, const float* plane1,
                            const float* fy, const float* fx,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im, float* sp_re,
                            float* sp_im, const int* iargs,
                            const float* fargs, int pieces, int b, int h,
                            int w, int r0, int r1, int s, void* stream) {
  const bool phase = pieces & 1, gm = pieces & 2, rolls = pieces & 4;
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
  const bool bracket = h > PBMM_BK_N;
  if (pieces < 0 || pieces > 7 || b < 1 || b > 65535 || h < 2 ||
      (h & (h - 1)) != 0 || s < 1 || w < s || w % s != 0 || r0 < 0 ||
      (s >= 4 && !general &&
       ((size_t)cur_re | (size_t)cur_im | (size_t)prev_re |
        (size_t)prev_im) % 16) ||
      (s >= 4 && phase && !general &&
       ((size_t)plane0 | (size_t)plane1) % 16) ||
      r1 <= r0 || r1 > h ||
      (bracket && rolls && (sp_re == nullptr || sp_im == nullptr)))
    return (int)cudaErrorInvalidValue;
  const KdecompIO io = {cur_re, cur_im, prev_re, prev_im, plane0, plane1,
                        fy,     fx,     tw_re,   tw_im,   out_re, out_im,
                        h,      w,      r0,      r1,      (size_t)h * w,
                        (size_t)(r1 - r0) * w};
  cudaStream_t st = (cudaStream_t)stream;
  if (!bracket)
    return (int)kd_height(io, pa, phase, general, b, gm, rolls, s, st);
  // Every 8192-row block of every frame, then the inverse bracket (or,
  // without it, each block's rows of [r0, r1) out).
  const size_t bw = (size_t)PBMM_BK_N * w;
  for (int k = 0; k < h / PBMM_BK_N; ++k) {
    const int y0 = k * PBMM_BK_N;
    const int b0 = rolls ? 0 : (r0 > y0 ? r0 - y0 : 0);
    const int b1 = rolls ? PBMM_BK_N
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
    if (rolls) {
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
    const cudaError_t err =
        kd_height(v, pa, phase, general, b, gm, rolls, s, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (!rolls) return (int)cudaSuccess;
  const PbmmColPass inv = {sp_re, sp_im, out_re, out_im, tw_re, tw_im,
                           h,     w,     r1 - r0, r0,   0,     0,
                           1.0f,  0,     io.fs,  io.os};
  return (int)pbmm_bracket_cols(inv, b, true, st);
}
