// Kernel 6: each frame's band/phase pass against its own previous frame,
// then the radix-2 column IFFT, rows [r0, r1) out.
//
// Replaces pbmm_tpu/spectral/fused.py:1022 phase_col_ifft (the Pallas
// kernel launched at :1168): the per-frame scan engine's fused
// phase + column-IFFT (engine/pipeline.py::amplify_reconstruct_fused) and
// the stateless frame pair's.  Inputs are whole spectra in the working
// layout (bit-reversed rows at a pow-2 height H, bit-reversed kept lanes),
// as kernels 1 and 5 give them; each of the B frames has its own prev
// (and, with the IIR band-pass, its own taps, written back full height).
// Every branch of _phase_block runs: host planes or per-bin masks,
// standard mode, steerable sectors, integer power or atan2 + sin/cos, IIR
// taps.  With the sharded engines' fx_values (a shard's lane frequencies,
// parallel/spatial.py) the wrapper passes them as the fx table and no host
// plane: the masks, the sector windows and the standard mode's weight are
// evaluated per bin (phase_pass.cuh::cs_standard_weight).  The
// benchmark-only pair_offset is not ported.
//
// Design: kernel 2's launch 2 at pow-2 heights, frame-parallel.  A block
// owns a strip of S columns of one frame (grid: W / S strips x B frames)
// and runs phase_inv.cuh's pbmm_phase_strip (the phase pass into the
// swizzled strip, cur, prev and the main branch's host planes by
// asynchronous 16-byte copies a few words ahead of the arithmetic on strips
// of 4 and more, element by element on narrower ones; with IIR the bin's
// taps read, updated in registers and written back) and
// pbmm_inv_rows_pow2 (col_pass.cuh's in-block register passes, the last
// one writing the output rows), the very body of kernel 2's launch 2: on
// the spectra kernel 5 gives, the rows are kernel 2's bit for bit.  Nothing
// recurs inside a launch, so there is no frame loop and no tap plane in
// shared memory (2 H S floats a block, and the phase pass's ring of prev
// and host-plane words where the block has room,
// phase_inv.cuh::pbmm_ps_smem).  The launch is kernel 2's too: 512
// threads, one block an SM, the strip of colspec_chunk.cu::cs_strip
// (16 columns to H = 1024, 8 to 2048, 4 to 4096, 2 to 8192), or the
// widest half of it that divides the width, down to 4 (2 above H = 2048, 1
// above 4096) (spectral/fused.py::phase_col_strip).  Narrower strips and smaller
// blocks that fill the SMs in one wave at B = 1 (4 columns, 256 threads,
// 3 blocks an SM: 288 blocks at 1080p's H = 2048) measured no faster, and
// slower at H = 4096 and B = 16 (PERF.md).
// Above 8192 rows (16384 at 16K) it runs the same launch on every
// 8192-row block of the column (one launch a block: the block's planes,
// frequencies and taps at the column's frame stride) into a scratch the
// wrapper allocates, then col_pass.cuh's inverse bracket writes rows [r0,
// r1), as kernel 2 does: kernel 6's rows stay kernel 2's bit for bit.
//
// What bounds it on an H100: it reads 4 (IIR 6) planes of B x H x W f32
// (and the two host planes of H x W) once and writes 2 x B x (r1 - r0) x W
// (+ 2 tap planes); at 1080p square_pow2 (H = 2048, W = 1152 kept lanes,
// rows 1152) 67 MB a frame, 0.020 ms at 3.35 TB/s, against 5 H log2(H)
// flops a column plus the phase chain: bytes bound.  On an NVIDIA H100
// 80GB HBM3 at its 700 W limit (chip_smoke.py) one such frame takes
// 0.090 ms warm (0.105 on strips of 4), one frame at H = 4096 0.258 (the
// stage-by-stage design before it: 0.239 and 0.933).

#include "col_pass.cuh"
#include "common.cuh"
#include "phase_inv.cuh"

struct PhaseColIO {
  const float* cur_re;
  const float* cur_im;
  const float* prev_re;
  const float* prev_im;
  const float* lpf_in;
  const float* lps_in;
  const float* plane0;  // total (pyramid) or w (standard), (H, W)
  const float* plane1;  // m_amp (pyramid)
  const float* fy;      // row frequency, (H,)
  const float* fx;      // lane frequency, (W,)
  const float* tw_re;   // compact_twiddles(H, inverse)
  const float* tw_im;
  float* out_re;
  float* out_im;
  float* lpf_out;
  float* lps_out;
  int w, r0, r1;
  size_t fs;  // frame stride of the spectra and taps (floats; H W)
  size_t os;  // frame stride of the output ((r1 - r0) W)
};

template <int NLOG, int S, bool GENERAL, bool IIR>
__global__ void __launch_bounds__(PBMM_CB_THREADS, 1)
    phase_col_ifft_kernel(PhaseColIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  constexpr int N = 1 << NLOG;
  float* sre = smem;
  float* sim = smem + N * S;
  const size_t wk = io.w;
  const int col0 = blockIdx.x * S;
  const size_t fo = (size_t)blockIdx.y * io.fs;  // this frame's planes
  pbmm_phase_strip<S, true, GENERAL, IIR>(
      io.cur_re + fo, io.cur_im + fo, io.prev_re + fo, io.prev_im + fo,
      IIR ? io.lpf_in + fo : nullptr, IIR ? io.lps_in + fo : nullptr,
      IIR ? io.lpf_out + fo : nullptr, IIR ? io.lps_out + fo : nullptr,
      io.plane0, io.plane1, io.fy, io.fx, pa, N, wk, col0, sre, sim);
  const int hr = io.r1 - io.r0;
  const size_t ob = (size_t)blockIdx.y * io.os + col0;
  pbmm_inv_rows_pow2<NLOG, S>(sre, sim, io.tw_re, io.tw_im, io.out_re + ob,
                              io.out_im + ob, wk, io.r0, hr);
}

template <int NLOG, int S, bool GENERAL, bool IIR>
static cudaError_t pc_launch(const PhaseColIO& io, const PhaseArgs& pa,
                             int b, cudaStream_t stream) {
  const size_t smem = pbmm_ps_smem(1 << NLOG, S, PBMM_CB_THREADS,
                                   pbmm_ps_words(true, GENERAL));
  cudaError_t err =
      pbmm_smem_opt_in(phase_col_ifft_kernel<NLOG, S, GENERAL, IIR>, smem);
  if (err != cudaSuccess) return err;
  phase_col_ifft_kernel<NLOG, S, GENERAL, IIR>
      <<<dim3(io.w / S, b), PBMM_CB_THREADS, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

template <int NLOG, int S>
static cudaError_t pc_branch(const PhaseColIO& io, const PhaseArgs& pa,
                             bool general, int b, cudaStream_t stream) {
  return pa.iir   ? pc_launch<NLOG, S, true, true>(io, pa, b, stream)
         : general ? pc_launch<NLOG, S, true, false>(io, pa, b, stream)
                   : pc_launch<NLOG, S, false, false>(io, pa, b, stream);
}

// The strips a height takes (phase_col_strip's candidates): kernel 2's
// strip S2, S2 / 2 and pbmm_col_strip (4 to H = 2048, 2 to 4096, 1 above).
template <int NLOG, int S2>
static cudaError_t pc_strip(const PhaseColIO& io, const PhaseArgs& pa,
                            bool general, int b, int s, cudaStream_t st) {
  constexpr int S4 = pbmm_col_strip(1 << NLOG);
  if (s == S2) return pc_branch<NLOG, S2>(io, pa, general, b, st);
  if (s == S2 / 2) return pc_branch<NLOG, S2 / 2>(io, pa, general, b, st);
  if (s == S4 && S4 < S2 / 2)
    return pc_branch<NLOG, (S4 < S2 / 2 ? S4 : S2)>(io, pa, general, b, st);
  return cudaErrorInvalidValue;
}

// iargs, fargs: the phase pass's branch and constants (host arrays, as
// for pbmm_colspec_chunk).  lpf/lps pointers are null without IIR,
// plane0/plane1 without host planes, fy/fx on the main branch; tw_re /
// tw_im: compact_twiddles(h, inverse=True); s: the strip
// (spectral/fused.py::phase_col_strip; of the 8192-row block above 8192
// rows); sp_re / sp_im: a (b, h, w) scratch above 8192 rows, else null.
// On the main branch on strips of 4 and more, cur, prev and the host
// planes start on 16 bytes (the phase pass's asynchronous copies).
extern "C" int pbmm_phase_col_ifft(
    const float* cur_re, const float* cur_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* tw_re, const float* tw_im, float* out_re,
    float* out_im, float* lpf_out, float* lps_out, float* sp_re,
    float* sp_im, const int* iargs, const float* fargs, int b, int h, int w,
    int r0, int r1, int s, void* stream) {
  PhaseArgs pa;
  const bool args_ok = pbmm_phase_unpack(iargs, fargs, pa);
  const bool general = pbmm_phase_general(pa);
  const bool bracket = h > PBMM_BK_N;
  if (!args_ok || b < 1 || b > 65535 || h < 2 || (h & (h - 1)) != 0 ||
      (bracket && (sp_re == nullptr || sp_im == nullptr)) || s < 1 ||
      w < s || w % s != 0 || r0 < 0 ||
      (s >= 4 && !general &&
       ((size_t)cur_re | (size_t)cur_im | (size_t)prev_re |
        (size_t)prev_im | (size_t)plane0 | (size_t)plane1) % 16) ||
      r1 <= r0 || r1 > h || (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (!general && (plane0 == nullptr || plane1 == nullptr)) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      (general && (fy == nullptr || fx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const PhaseColIO io = {cur_re, cur_im, prev_re, prev_im, lpf_in, lps_in,
                         plane0, plane1, fy,      fx,      tw_re,  tw_im,
                         out_re, out_im, lpf_out, lps_out, w,      r0,
                         r1,     (size_t)h * w, (size_t)(r1 - r0) * w};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bracket) {
    // Every 8192-row block of every frame, then the inverse bracket.
    const size_t bw = (size_t)PBMM_BK_N * w;
    err = cudaSuccess;
    for (int k = 0; k < h / PBMM_BK_N && err == cudaSuccess; ++k) {
      const size_t o = k * bw;
      PhaseColIO v = io;
      v.cur_re += o;
      v.cur_im += o;
      v.prev_re += o;
      v.prev_im += o;
      if (pa.iir) {
        v.lpf_in += o;
        v.lps_in += o;
        v.lpf_out += o;
        v.lps_out += o;
      }
      if (plane0) v.plane0 += o;
      if (plane1) v.plane1 += o;
      if (fy) v.fy += (size_t)k * PBMM_BK_N;
      v.out_re = sp_re + o;
      v.out_im = sp_im + o;
      v.r0 = 0;
      v.r1 = PBMM_BK_N;
      v.os = io.fs;
      err = pc_strip<PBMM_BK_LOG, 2>(v, pa, general, b, s, st);
    }
    if (err != cudaSuccess) return (int)err;
    const PbmmColPass inv = {sp_re,   sp_im, out_re, out_im, tw_re,
                             tw_im,   h,     w,      r1 - r0, r0,
                             0,       0,     1.0f,   0,       io.fs,
                             io.os};
    return (int)pbmm_bracket_cols(inv, b, true, st);
  }
  switch (h) {
#define PC_H(NLOG, S2) \
  case 1 << NLOG: err = pc_strip<NLOG, S2>(io, pa, general, b, s, st); break;
    PC_H(1, 16) PC_H(2, 16) PC_H(3, 16) PC_H(4, 16) PC_H(5, 16) PC_H(6, 16)
    PC_H(7, 16) PC_H(8, 16) PC_H(9, 16) PC_H(10, 16) PC_H(11, 8)
    PC_H(12, 4) PC_H(13, 2)
#undef PC_H
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
